"""The comparison that decides `correct` has to fail what it exists to
catch: the control (the reference in bfloat16 in the program's place,
through the harness's own run) at mainnet's size, and whole runs of the
harness on the CPU with the timed path broken underneath, once per fault
a cell can have: a step that returns its state unchanged, half of a batch
left out, one position of a batch wrong, an answer altered where it is
produced.  (One chip per cell: no exchange between chips to leave out.)"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from dabench import control, harness

ROOT = Path(__file__).resolve().parents[2]


def _run(bench, cell, monkeypatch, seconds=1.5):
    for key, value in bench.config(bench.cell(cell)).get("env", {}).items():
        monkeypatch.setenv(key, value)
    return harness.run_cell(bench, cell, 2**35 + 3, seconds, False, "cpu", time.perf_counter())


def _batched(bench, cell="replay-k512", **mix):
    """`cell` with its mix at 4 squares a dispatch (and `mix` besides), so
    that faults within a batch have batches to hit."""
    path = bench.package / "traffic" / f"{bench.cell(cell)['traffic']}.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "batch": 4, **mix}))
    return cell


@pytest.fixture
def mainnet_bench(tmp_path):
    """The benchmark with every configuration at mainnet's k=128, where
    bfloat16 sums of up to 1024 bits lose their lowest bit, and the mixes
    cut to a few squares, for the control on the CPU."""
    from dabench.spec import Bench

    shutil.copytree(ROOT / "dabench", tmp_path / "dabench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in data["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(square_size=128, field_bits=8)
        (tmp_path / c["file"]).write_text(json.dumps(cfg))
    for path in (tmp_path / "dabench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        if mix["entry"] == "replay":
            mix.update(batch=1, pool=7, warm_squares=1, check_sample=1)
        else:
            mix.update(pool=1, warm_repairs=0, check_sample=1)
        path.write_text(json.dumps(mix))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    torch.set_num_threads(max(1, min(4, torch.get_num_threads())))
    return Bench(tmp_path, tmp_path / "dabench")


@pytest.mark.parametrize("cell", ["replay-k512", "repair-k512-q0"])
def test_control_is_not_correct_at_mainnet_size(mainnet_bench, monkeypatch, cell):
    """The reference in bfloat16 in the program's place, through the
    harness's own run and comparison, comes out not correct."""
    with control.substituted(mainnet_bench, cell, "cpu"):
        res = _run(mainnet_bench, cell, monkeypatch, seconds=1.0)
    assert not res["correct"]
    assert res["checks"]["squares_mismatched"]["value"] > 0
    if cell.startswith("replay"):
        assert res["checks"]["batch_squares_mismatched"]["value"] > 0
    else:
        assert res["checks"]["data_roots_mismatched"]["value"] > 0


def test_sound_runs_are_correct(tiny_bench, monkeypatch):
    for cell in ("replay-k512", "repair-k512-q0"):
        res = _run(tiny_bench, cell, monkeypatch)
        assert res["correct"], json.dumps(res)
        assert list(res)[-1] == "checks"  # the numbers compared come last
    res = _run(tiny_bench, _batched(tiny_bench), monkeypatch)
    assert res["correct"], json.dumps(res)


def test_state_returned_unchanged_is_caught(tiny_bench, monkeypatch):
    """The stream hands back its previous square again and again."""
    from celestia_app_tpu_torch.parallel import pipeline

    real = pipeline.stream_blocks

    def stale(*a, **kw):
        last = None
        for tag, eds in real(*a, **kw):
            last = eds if last is None or tag >= (1 << 62) else last
            yield tag, last

    monkeypatch.setattr("celestia_app_tpu_torch.parallel.stream_blocks", stale)
    res = _run(tiny_bench, "replay-k512", monkeypatch)
    assert not res["correct"]
    assert res["checks"]["data_roots_repeated"]["value"] > 0


def test_half_a_batch_left_out_is_caught(tiny_bench, monkeypatch):
    """Each batched dispatch computes the first half of its squares and
    hands their outputs out for the second half too."""
    from celestia_app_tpu_torch.parallel import pipeline

    real = pipeline.batched_pipeline_for_mode
    halved = []

    def half(mode, k, n, *a, **kw):
        fn = real(mode, k, n, *a, **kw)

        def run(x):
            out = fn(x)
            for t in out:
                for b in range(n - n // 2, n):
                    t[b] = t[b - (n - n // 2)]
            halved.append(n)
            return out

        return run

    monkeypatch.setattr(pipeline, "batched_pipeline_for_mode", half)
    res = _run(tiny_bench, _batched(tiny_bench), monkeypatch, seconds=3.0)
    assert any(n >= 2 for n in halved)
    assert not res["correct"]
    assert res["checks"]["squares_mismatched"]["value"] > 0


def test_a_fault_in_one_batch_position_is_caught(tiny_bench, monkeypatch):
    """Each batched dispatch gets the data root of its second square wrong;
    the reservoir sample is cut to one square, so the whole dispatch
    compared by its data roots has to catch it."""
    from celestia_app_tpu_torch.parallel import pipeline

    cell = _batched(tiny_bench, check_sample=1)
    real = pipeline.batched_pipeline_for_mode
    altered = []

    def second_wrong(mode, k, n, *a, **kw):
        fn = real(mode, k, n, *a, **kw)

        def run(x):
            out = fn(x)
            out[-1][1, 0] ^= 1  # the data root of position 1
            altered.append(n)
            return out

        return run

    monkeypatch.setattr(pipeline, "batched_pipeline_for_mode", second_wrong)
    res = _run(tiny_bench, cell, monkeypatch, seconds=3.0)
    assert altered
    assert not res["correct"]
    assert res["checks"]["batch_squares_mismatched"]["value"] > 0


def test_replay_answer_altered_is_caught(tiny_bench, monkeypatch):
    """One byte of every window square's data root flipped where the
    pipeline produces it."""
    from celestia_app_tpu_torch.parallel import pipeline

    real = pipeline.guarded_dispatch

    def altered(*a, **kw):
        mode, (eds, rr, cr, droot) = real(*a, **kw)
        droot = droot.clone()
        droot[0] ^= 1
        return mode, (eds, rr, cr, droot)

    monkeypatch.setattr(pipeline, "guarded_dispatch", altered)
    res = _run(tiny_bench, "replay-k512", monkeypatch)
    assert not res["correct"]
    assert res["checks"]["squares_mismatched"]["value"] > 0


def test_repair_answer_altered_is_caught(tiny_bench, monkeypatch):
    """One byte of a recovered share flipped in the EDS repair returns."""
    import importlib

    module = importlib.import_module("celestia_app_tpu_torch.da.repair")
    real = module.repair

    def altered(*a, **kw):
        out = real(*a, **kw)
        out._eds[0, 0, 100] ^= 1
        return out

    monkeypatch.setattr(module, "repair", altered)
    res = _run(tiny_bench, "repair-k512-q0", monkeypatch)
    assert not res["correct"]
    assert res["checks"]["squares_mismatched"]["value"] > 0


def test_repair_that_returns_a_stale_square_is_caught(tiny_bench, monkeypatch):
    """Repair returns its first result for every later call."""
    import importlib

    module = importlib.import_module("celestia_app_tpu_torch.da.repair")
    real = module.repair
    first = []

    def stale(*a, **kw):
        out = real(*a, **kw)
        first.append(out)
        return first[0]

    monkeypatch.setattr(module, "repair", stale)
    res = _run(tiny_bench, "repair-k512-q0", monkeypatch, seconds=3.0)
    assert not res["correct"]
    assert res["checks"]["data_roots_mismatched"]["value"] > 0


@pytest.mark.parametrize("cell", ["replay-k512", "repair-k512-q0"])
def test_a_program_that_raises_is_not_correct(tiny_bench, monkeypatch, cell):
    from celestia_app_tpu_torch.parallel import pipeline

    def broken(*a, **kw):
        raise RuntimeError("injected")

    if cell.startswith("replay"):
        real = pipeline.stream_blocks

        def dies(*a, **kw):
            it = real(*a, **kw)
            for n, item in enumerate(it):
                if n == 6:
                    broken()
                yield item

        monkeypatch.setattr("celestia_app_tpu_torch.parallel.stream_blocks", dies)
    else:
        import importlib

        module = importlib.import_module("celestia_app_tpu_torch.da.repair")
        real = module.repair
        calls = []

        def dies(*a, **kw):
            calls.append(1)
            if len(calls) > 2:
                broken()
            return real(*a, **kw)

        monkeypatch.setattr(module, "repair", dies)
    res = _run(tiny_bench, cell, monkeypatch)
    assert not res["correct"] and res["failed"] >= 1
