"""Each cell end to end on an NVIDIA card, in a short window: the result
line to the contract and `correct` true.  Skipped without a card; on one:
`python -m pytest dabench/tests/test_dabench_card.py -m cuda`."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells run the program's CUDA kernels")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell, trace):
    out = subprocess.run([sys.executable, "-m", "dabench.run", "--workload", cell, "--seed",
                          str(2**34 + 9), "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=360, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert "setup_s" in result["metrics"] or trace
    if trace:
        assert result["device"]["busy_s"] > 0 and result["device"]["window_s"] > 0
