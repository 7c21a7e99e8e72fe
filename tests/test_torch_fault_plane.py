"""The device fault plane around the port's extend paths, held against the
JAX package on the same seeded squares and chaos specs (CPU, small k).

  * the stream (parallel/pipeline.py): a batched fault falls to unbatched
    guarded dispatches, a failed upload is retried as often as in the JAX
    stream under the same spec, a deferred fault at the drain's sync feeds
    the breaker, a dead dispatcher writes a worker_death bundle;
  * repair (da/repair.py): its sweeps and re-extension under the ladder,
    the same rung and bytes as the JAX repair under the same spec, and a
    rejection's root_mismatch bundle;
  * the panel and sharded-panel rungs at k=16 with 4-row panels on CPU
    shards: a mid-panel fault steps to the materializing base, as in the
    JAX package, and extend_shard_fail steps sharded_panel -> panel;
  * the C-bridge backend ($CELESTIA_SQUARE_BACKEND=bridge) with a CPU
    worker: roots equal to the JAX compute, a killed worker costs one call
    on the in-process path, the next call respawns it.
Bytes are compared exactly; there is no tolerance.
"""

from __future__ import annotations

import gc
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from celestia_app_tpu import chaos as jax_chaos
from celestia_app_tpu.chaos import degrade as jax_degrade
from celestia_app_tpu.da.eds import ExtendedDataSquare as JaxEDS
from celestia_app_tpu.da.repair import repair as jax_repair
from celestia_app_tpu.parallel import pipeline as jax_pipeline
from celestia_app_tpu.trace.metrics import registry as jax_registry
from celestia_app_tpu.trace.tracer import traced as jax_traced
from celestia_app_tpu_torch import chaos
from celestia_app_tpu_torch.chaos import degrade
from celestia_app_tpu_torch.constants import SHARE_SIZE
from celestia_app_tpu_torch.da import ExtendedDataSquare, RootMismatch, extend_shares, repair
from celestia_app_tpu_torch.da import eds as eds_mod
from celestia_app_tpu_torch.parallel import pipeline as port_pipeline
from celestia_app_tpu_torch.parallel.pipeline import BlockPipeline, stream_blocks
from celestia_app_tpu_torch.trace import device_ledger, flight_recorder, journal
from celestia_app_tpu_torch.trace.metrics import registry

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran (each loaded
    XLA:CPU executable holds many memory mappings)."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("CELESTIA_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("CELESTIA_FLIGHT_MIN_INTERVAL_S", "0")
    for c, d in ((chaos, degrade), (jax_chaos, jax_degrade)):
        c.uninstall()
        d.reset_for_tests()
    yield
    for c, d in ((chaos, degrade), (jax_chaos, jax_degrade)):
        c.uninstall()
        d.reset_for_tests()


def _ods(k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, (k, k, SHARE_SIZE), dtype=np.uint8)
    ods[..., :29] = 0
    ods[..., 28] = np.sort(rng.integers(0, 256, k * k)).reshape(k, k).astype(np.uint8)
    return ods


def _roots(eds) -> tuple:
    return (bytes(eds.data_root()), tuple(map(bytes, eds.row_roots())),
            tuple(map(bytes, eds.col_roots())))


def _count(reg, name: str, **labels) -> float:
    fam = reg().get(name)
    if fam is None:
        return 0.0
    return sum(v for key, v in fam.samples() if all(key.get(a) == b for a, b in labels.items()))


def _bundles(trigger: str) -> list[dict]:
    out_dir = flight_recorder.flight_dir()
    if out_dir is None or not os.path.isdir(out_dir):
        return []
    return [json.loads(Path(out_dir, name).read_text()) for name in sorted(os.listdir(out_dir))
            if name.startswith(f"flight-{trigger}-")]


@pytest.fixture(scope="module")
def squares():
    """Six k=4 squares and their JAX roots."""
    blocks = [(i, _ods(4, seed=300 + i)) for i in range(6)]
    return blocks, [_roots(JaxEDS.compute(ods)) for _, ods in blocks]


# --- the stream ------------------------------------------------------------------


def test_batched_fault_falls_to_unbatched_dispatches(squares, monkeypatch):
    blocks, want = squares
    real_start = threading.Thread.start
    monkeypatch.setattr(threading.Thread, "start", lambda self: None)
    pipe = BlockPipeline(4, depth=2, batch=3, device="cpu")
    monkeypatch.setattr(threading.Thread, "start", real_start)
    inner, failed = port_pipeline.batched_pipeline_for_mode, []

    def faulty(mode, k, n, *args, **kwargs):
        run = inner(mode, k, n, *args, **kwargs)

        def fail(x):
            failed.append(n)
            raise RuntimeError("injected batched fault")
        return fail if not failed else run

    monkeypatch.setattr(port_pipeline, "batched_pipeline_for_mode", faulty)
    before = _count(registry, "celestia_recoveries_total", outcome="unbatched")
    rows0 = len(journal.rows("stream"))
    try:
        for tag, ods in blocks[:3]:  # queued before the stages start: one batch
            pipe.submit(ods, tag)
        pipe._uploader.start()
        pipe._dispatcher.start()
        got = [(t, _roots(e)) for t, e in pipe.drain()]
    finally:
        pipe.close()
    assert got == list(zip(range(3), want[:3])) and failed == [3]
    assert _count(registry, "celestia_recoveries_total", outcome="unbatched") == before + 1
    rows = journal.rows("stream")[rows0:]
    assert [(r["batch_size"], r["mode"]) for r in rows] == [(3, "fused")] * 3
    assert degrade.degraded_state() is None


def test_upload_retries_equal_jax(squares):
    """batch 1: one device.upload draw per square and attempt, so the same
    spec gives the JAX stream's retries exactly."""
    blocks, want = squares
    spec = "seed=6,upload_fail=0.3"
    retries = {}
    for name, c, reg, run in (
            ("jax", jax_chaos, jax_registry,
             lambda: [(t, _roots(e)) for t, e in jax_pipeline.stream_blocks(
                 iter(blocks), 4, depth=2, batch=1)]),
            ("port", chaos, registry,
             lambda: [(t, _roots(e)) for t, e in stream_blocks(
                 iter(blocks), 4, depth=2, batch=1, device="cpu")])):
        before = _count(reg, "celestia_recoveries_total", seam="device.upload")
        c.install(spec)
        try:
            assert run() == list(zip(range(6), want))
        finally:
            c.uninstall()
        retries[name] = _count(reg, "celestia_recoveries_total", seam="device.upload") - before
    assert retries["port"] == retries["jax"] >= 1


def test_upload_exhaustion_raises_from_the_drain(squares):
    chaos.install("seed=1,upload_fail=1.0")
    pipe = BlockPipeline(4, depth=2, device="cpu")
    try:
        pipe.submit(squares[0][0][1], 0)
        with pytest.raises(RuntimeError, match="feeder failed") as info:
            list(pipe.drain())
    finally:
        pipe.close()
    pipe._uploader.join(10)  # the bundle is written after the death sentinel
    assert "upload_fail" in repr(info.value.__cause__)
    assert _bundles("worker_death")[-1]["context"]["stage"] == "uploader"


def test_deferred_faults_feed_the_breaker(squares):
    """Every dispatch done before the drain (a success in between would
    reset the breaker's streak), then a fault at each of `threshold`
    drains' syncs steps the ladder."""
    blocks, want = squares
    pipe = BlockPipeline(4, depth=4, batch=1, device="cpu")
    threshold, seen = degrade.DEVICE_BREAKER.threshold, []

    def deferred(inflight):
        if len(seen) < threshold:
            seen.append(inflight.tag)
            raise RuntimeError("deferred device fault")

    pipe._await = deferred
    try:
        for tag, ods in blocks[:threshold + 1]:
            pipe.submit(ods, tag)
        deadline = time.monotonic() + 60
        while pipe._done.qsize() < threshold + 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        for _ in range(threshold):
            with pytest.raises(RuntimeError, match="deferred"):
                pipe._drain_one()
        tag, eds = pipe._drain_one()
    finally:
        pipe.close()
    assert degrade.degraded_state() == {"device": "staged"}
    assert _roots(eds) == want[tag] and seen == list(range(threshold))


def test_dead_dispatcher_writes_its_bundle(squares):
    pipe = BlockPipeline(4, depth=1, batch=1, device="cpu")

    def dead(mode):
        def fail(_x):
            raise ValueError(f"dispatcher fault on {mode}")
        return fail

    pipe._resolve_pipe = dead
    try:
        pipe.submit(squares[0][0][1], 0)
        deadline = time.monotonic() + 30
        while pipe._error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(RuntimeError) as err:
            list(pipe.drain())
    finally:
        pipe.close()
    pipe._dispatcher.join(10)  # the bundle is written after the death sentinel
    assert isinstance(err.value.__cause__, ValueError)
    assert "on host" in str(err.value.__cause__)  # the fault outlasted the ladder
    bundle = _bundles("worker_death")[-1]
    assert bundle["context"]["stage"] == "dispatcher"
    assert bundle["degraded"] == {"device": "host"}
    assert {"programs", "ownership"} <= set(bundle["device"])


def test_auto_batch_follows_the_occupancy_signal(monkeypatch):
    from celestia_app_tpu.trace import square_journal as jax_sq
    from celestia_app_tpu_torch.trace import square_journal as port_sq

    monkeypatch.setenv("CELESTIA_PIPE_BATCH", "auto")
    for last in (None, {"occupancy": 0.1}, {"occupancy": 0.9}, {"occupancy": None}):
        monkeypatch.setattr(jax_sq, "_LAST", last)
        monkeypatch.setattr(port_sq, "_LAST", last)
        assert port_pipeline.env_batch() == jax_pipeline.env_batch()
    assert port_pipeline.env_batch_cap() == jax_pipeline.env_batch_cap() == 4


# --- repair ----------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["seed=4,dispatch_fail=1.0", "seed=8,dispatch_fail=0.5"])
def test_repair_under_the_ladder_equals_jax(spec):
    k = 4
    full = JaxEDS.compute(_ods(k, seed=410))
    shares = np.asarray(full.squared())
    present = np.ones((2 * k, 2 * k), dtype=bool)
    present[:k, :k] = False
    present[k:, 0] = False
    outcomes = {}
    for name, c, d, run in (("jax", jax_chaos, jax_degrade, lambda: jax_repair(shares, present)),
                            ("port", chaos, degrade,
                             lambda: repair(shares, present, device="cpu"))):
        c.install(spec)
        try:
            out = run()
        finally:
            c.uninstall()
        outcomes[name] = (np.asarray(out.squared()).tobytes(), _roots(out), d.degraded_state())
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][1] == _roots(full)


def test_repair_rejection_writes_its_bundle():
    k = 4
    full = ExtendedDataSquare.compute(_ods(k, seed=411), device="cpu")
    bad = full.squared().copy()
    bad[k + 1, 2, 90] ^= 1
    present = np.ones((2 * k, 2 * k), dtype=bool)
    present[:k, :k] = False
    before = _count(registry, "celestia_da_detections_total", kind="root_mismatch")
    with pytest.raises(RootMismatch):
        repair(bad, present, height=7, device="cpu")
    assert _count(registry, "celestia_da_detections_total", kind="root_mismatch") == before + 1
    bundle = _bundles("root_mismatch")[-1]
    assert bundle["context"] == {"reason": "inconsistent_survivors", "height": 7, "k": k}


def test_recover_cache_is_a_ledger_owner():
    device_ledger.register_owner("repair_recover_cache",
                                 importlib_repair()._recover_cache_bytes)
    k = 4
    full = ExtendedDataSquare.compute(_ods(k, seed=412), device="cpu")
    present = np.ones((2 * k, 2 * k), dtype=bool)
    present[:k, 1] = False
    repair(full.squared(), present, device="cpu")
    assert device_ledger.reconcile()["owners"]["repair_recover_cache"] > 0


def importlib_repair():
    import importlib

    return importlib.import_module("celestia_app_tpu_torch.da.repair")


# --- the panel and sharded-panel rungs ---------------------------------------------


def _mid_panel_seed(attempts: int, p: float = 0.5) -> int:
    """A seed whose device.dispatch draws are, per panel attempt, pass
    (guarded_dispatch's seam), pass (panel 0), fail (panel 1), then a pass
    for the rung below."""
    import random

    want = [False, False, True] * attempts + [False]
    for seed in range(100_000):
        rng = random.Random(f"celestia-chaos:{seed}:device.dispatch")
        if all((rng.random() < p) == w for w in want):
            return seed
    raise AssertionError("no seed")


@pytest.fixture(scope="module")
def square16():
    ods = _ods(16, seed=160)
    return ods, _roots(JaxEDS.compute(ods))


def test_mid_panel_fault_steps_to_the_materializing_base_like_jax(square16, monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "4")
    ods, want = square16
    spec = f"seed={_mid_panel_seed(degrade.DEVICE_BREAKER.threshold)},dispatch_fail=0.5"
    got = {}
    for name, c, d, run, mode_of in (
            ("jax", jax_chaos, jax_degrade, lambda: JaxEDS.compute(ods),
             lambda: jax_traced().table("block_journal")[-1]["mode"]),
            ("port", chaos, degrade, lambda: ExtendedDataSquare.compute(ods, device="cpu"),
             lambda: journal.rows("compute")[-1]["mode"])):
        c.install(spec)
        try:
            eds = run()
        finally:
            c.uninstall()
        got[name] = (_roots(eds), mode_of(), d.degraded_state())
    assert got["port"] == got["jax"] == (want, "fused", {"device": "fused"})


def test_extend_shard_fail_steps_to_the_panel_rung(square16, monkeypatch):
    from celestia_app_tpu_torch.kernels import fused

    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "4")
    monkeypatch.setenv("CELESTIA_EXTEND_SHARDS", "4")
    ods, want = square16
    assert fused.pipeline_mode_for_k(16, "cpu") == "sharded_panel"
    eds = ExtendedDataSquare.compute(ods, device="cpu")
    row = journal.rows("compute")[-1]
    assert (row["mode"], row["shards"], _roots(eds)) == ("sharded_panel", 4, want)
    chaos.install("seed=1,extend_shard_fail=1.0")
    eds = ExtendedDataSquare.compute(ods, device="cpu")
    row = journal.rows("compute")[-1]
    assert (row["mode"], row["panels"], _roots(eds)) == ("panel", 4, want)
    assert degrade.degraded_state() == {"device": "panel"}
    injected = _count(registry, "celestia_chaos_injections_total", seam="device.extend_shard")
    assert injected >= degrade.DEVICE_BREAKER.threshold


def test_panel_warm_state_is_the_compile_column(monkeypatch):
    from celestia_app_tpu_torch.kernels import panel, panel_sharded

    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "3")
    ods = _ods(8, seed=162)
    construction = "leopard"
    panel._PANEL_WARM.clear()
    assert not panel.is_warm(8, construction, "cpu")
    assert eds_mod.pipeline_cache_state(8, construction, "cpu") == "miss"
    ExtendedDataSquare.compute(ods, construction, device="cpu")
    assert panel.is_warm(8, construction, "cpu")
    assert eds_mod.pipeline_cache_state(8, construction, "cpu") == "hit"
    monkeypatch.setenv("CELESTIA_EXTEND_SHARDS", "2")
    panel_sharded._SHARDED_WARM.clear()
    assert not panel_sharded.is_sharded_warm(8, construction, "cpu")
    ExtendedDataSquare.compute(ods, construction, device="cpu")
    assert panel_sharded.is_sharded_warm(8, construction, "cpu")


# --- the bridge backend ----------------------------------------------------------


@pytest.fixture(scope="module")
def bridge_lib(tmp_path_factory) -> str:
    build = tmp_path_factory.mktemp("bridge")
    for cmd in (["cmake", "-S", str(ROOT / "bridge"), "-B", str(build)],
                ["cmake", "--build", str(build)]):
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    return str(build / "libcelestia_square_bridge.so")


def _workers() -> list[int]:
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            stat = Path(f"/proc/{entry}/stat").read_text()
            cmd = Path(f"/proc/{entry}/cmdline").read_bytes()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == os.getpid() and \
                b"celestia_app_tpu_torch.bridge.worker" in cmd:
            out.append(int(entry))
    return out


def test_bridge_backend_falls_back_and_respawns(bridge_lib, monkeypatch, capfd):
    monkeypatch.setenv("CELESTIA_SQUARE_BACKEND", "bridge")
    monkeypatch.setenv("CELESTIA_BRIDGE_LIB", bridge_lib)
    monkeypatch.setenv("CELESTIA_BRIDGE_DEVICE", "cpu")
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.chdir(ROOT)
    ods = _ods(4, seed=180)
    shares = [row.tobytes() for row in ods.reshape(16, SHARE_SIZE)]
    want = _roots(JaxEDS.compute(ods))
    try:
        rows0 = len(journal.rows("compute"))
        assert _roots(extend_shares(shares, device="cpu")) == want
        assert len(journal.rows("compute")) == rows0  # computed by the worker
        pids = _workers()
        assert len(pids) == 1
        os.kill(pids[0], signal.SIGKILL)
        deadline = time.monotonic() + 10
        while pids[0] in _workers() and time.monotonic() < deadline:
            time.sleep(0.05)
        capfd.readouterr()
        assert _roots(extend_shares(shares, device="cpu")) == want
        assert "falling back to device pipeline" in capfd.readouterr().err
        assert len(journal.rows("compute")) == rows0 + 1 and eds_mod._BRIDGE_CLIENT is None
        assert _roots(extend_shares(shares, device="cpu")) == want
        respawned = _workers()
        assert len(respawned) == 1 and respawned != pids
        # A pinned construction other than the active one stays in process.
        rows1 = len(journal.rows("compute"))
        other = "leopard" if eds_mod.active_construction() != "leopard" else "vandermonde"
        extend_shares(shares, other, device="cpu")
        assert len(journal.rows("compute")) == rows1 + 1
    finally:
        eds_mod._reset_bridge()


def test_bridge_init_failure_takes_the_in_process_path(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("CELESTIA_SQUARE_BACKEND", "bridge")
    monkeypatch.setenv("CELESTIA_BRIDGE_LIB", str(tmp_path / "missing.so"))
    ods = _ods(4, seed=181)
    eds = extend_shares([row.tobytes() for row in ods.reshape(16, SHARE_SIZE)], device="cpu")
    assert _roots(eds) == _roots(JaxEDS.compute(ods))
    assert "square bridge fault" in capsys.readouterr().err
    assert eds_mod.square_backend() == "bridge" and eds_mod._BRIDGE_CLIENT is None
    assert eds_mod._bridge_lib_path() == str(tmp_path / "missing.so")
    monkeypatch.delenv("CELESTIA_BRIDGE_LIB")
    assert eds_mod._bridge_lib_path().endswith("build/bridge/libcelestia_square_bridge.so")
    assert sys.modules["celestia_app_tpu_torch.da.eds"] is eds_mod
