"""Tests of the benchmark harness: CPU only, except those marked `cuda`,
which skip without an NVIDIA card.  Run from the repository's root:
`python -m pytest dabench/tests -q`."""

import shutil
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skipped without one")


@pytest.fixture
def tiny_bench(tmp_path):
    """A copy of the benchmark whose configurations hold k=4 squares and
    whose mixes are cut to match, for runs of the whole harness on the
    CPU."""
    from dabench.spec import Bench

    shutil.copytree(ROOT / "dabench", tmp_path / "dabench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in data["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(square_size=4, field_bits=8)
        (tmp_path / c["file"]).write_text(json.dumps(cfg))
    for path in (tmp_path / "dabench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        if mix["entry"] == "replay":
            mix.update(batch=min(mix["batch"], 4), pool=16, warm_squares=4, check_sample=64)
        path.write_text(json.dumps(mix))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    return Bench(tmp_path, tmp_path / "dabench")
