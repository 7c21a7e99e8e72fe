"""The port's device ledger, journal, profiler, flight-recorder sections, SLO
trigger and mempool chaos seam, held against the JAX package (CPU).

  * trace/device_ledger.py: `track` bills a pipeline's first call as build
    seconds and every later call as dispatch seconds — on the same stepped
    clock in both packages, so the program rows are equal, with no
    dependence on the clock's resolution; `reconcile` on the CPU measures
    the RSS high-water, attributes owners and publishes the residual;
    residual growth for $CELESTIA_DEVICE_LEAK_TICKS reconciliations fires
    the device_residual_growth bundle on the same tick as in the JAX ledger;
  * trace/journal.py: a row's table entry, trace-context stamps, compile
    counter and `celestia_block_<stage>_seconds` histograms equal the JAX
    journal's for the same row; the profiler window writes a Chrome trace;
  * trace/flight_recorder.py: the bundle's `degraded` and `device` sections
    and `peer_bundle_index`, equal to the JAX recorder's;
  * trace/slo.py: a fast-burn page writes the slo_fast_burn bundle;
  * da/eds.py: the parity sentinel's match and mismatch (its counter, row
    and bundle), warm-up's journal rows and ledger notes;
  * mempool.py: the chaos seam mempool_insert drops the same admissions as
    the JAX pool's under the same spec, per shard and on the global pool.
Figures are compared exactly (the stepped clock makes seconds exact too).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import pytest

from celestia_app_tpu import chaos as jax_chaos
from celestia_app_tpu import mempool as jax_mempool
from celestia_app_tpu.chaos import degrade as jax_degrade
from celestia_app_tpu.trace import device_ledger as jax_ledger
from celestia_app_tpu.trace import flight_recorder as jax_flight
from celestia_app_tpu.trace import journal as jax_journal
from celestia_app_tpu.trace import slo as jax_slo
from celestia_app_tpu.trace.context import new_context as jax_new_context
from celestia_app_tpu.trace.context import use_context as jax_use_context
from celestia_app_tpu.trace.metrics import registry as jax_registry
from celestia_app_tpu.trace.tracer import traced as jax_traced
from celestia_app_tpu.da.eds import extra_warmup_sizes as jax_extra_warmup_sizes
from celestia_app_tpu.da.eds import warmup_sizes as jax_warmup_sizes
from celestia_app_tpu_torch import chaos, mempool
from celestia_app_tpu_torch.da import ExtendedDataSquare
from celestia_app_tpu_torch.da import eds as eds_mod
from celestia_app_tpu_torch.chaos import degrade
from celestia_app_tpu_torch.trace import device_ledger, flight_recorder, journal, profiler, slo
from celestia_app_tpu_torch.trace.context import new_context, node_id, use_context
from celestia_app_tpu_torch.trace.metrics import registry
from celestia_app_tpu_torch.trace.tracer import traced

LEDGERS = (jax_ledger, device_ledger)
_STATE = ("_PROGRAMS", "_OWNER_CALLBACKS", "_OWNED_KEYED", "_PUBLISHED_OWNERS", "_WARMED")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """Each test on empty ledgers, restored afterwards (the owners that
    modules register at import stay registered for the other test files),
    a flight dir of its own, healthy ladders and no chaos."""
    saved = [{name: dict(getattr(m, name)) if isinstance(getattr(m, name), dict)
              else set(getattr(m, name)) for name in _STATE} for m in LEDGERS]
    for m in LEDGERS:
        m._reset_for_tests()
    monkeypatch.setenv("CELESTIA_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("CELESTIA_FLIGHT_MIN_INTERVAL_S", "0")
    for c, d in ((chaos, degrade), (jax_chaos, jax_degrade)):
        c.uninstall()
        d.reset_for_tests()
    yield
    for c, d in ((chaos, degrade), (jax_chaos, jax_degrade)):
        c.uninstall()
        d.reset_for_tests()
    for m, state in zip(LEDGERS, saved):
        m._reset_for_tests()
        for name, value in state.items():
            getattr(m, name).update(value)


class SteppedClock:
    """perf_counter in whole steps: each reading advances by `step`."""

    def __init__(self, step: float = 0.25):
        self.t, self.step = 1000.0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def _bundles(trigger: str) -> list[dict]:
    out = Path(os.environ["CELESTIA_FLIGHT_DIR"])
    if not out.is_dir():
        return []
    return [json.loads((out / n).read_text()) for n in sorted(os.listdir(out))
            if n.startswith(f"flight-{trigger}-")]


def _rows(ledger) -> list[dict]:
    return [{k: v for k, v in row.items() if k != "last_dispatch_age_s"}
            for row in ledger.snapshot()["programs"]]


def test_track_bills_first_call_then_dispatches_like_jax(monkeypatch):
    """Three pipelines, called 1, 2 and 4 times, on one stepped clock per
    package: compile_s is the first call's whole step, dispatch_s the
    later calls', exactly; eviction flips `resident`, a rebuild revives
    the record."""
    monkeypatch.setattr(device_ledger, "_CLOCK", SteppedClock())
    monkeypatch.setattr(jax_ledger.time, "perf_counter", SteppedClock())
    held = {}
    for m in LEDGERS:
        fns = [m.track(lambda x: x + 1, "extend_and_dah", k=4, construction="leopard",
                       mode="fused"),
               m.track(lambda x: x * 2, "repair_sweep", k=8, mode="staged"),
               m.track(lambda x: x, "extend_and_dah_batched", k=4, mode="fused", batch=3)]
        for fn, calls in zip(fns, (1, 2, 4)):
            for i in range(calls):
                fn(i)
        held[m] = fns
    want = _rows(jax_ledger)
    assert _rows(device_ledger) == want
    by_family = {r["family"]: r for r in want}
    assert by_family["extend_and_dah_batched"]["compile_s"] == 0.25
    assert by_family["extend_and_dah_batched"]["dispatch_s"] == 0.75
    assert by_family["repair_sweep"]["dispatches"] == 2
    for m in LEDGERS:
        held[m].pop(1)  # the builder cache evicts one
    assert _rows(device_ledger) == _rows(jax_ledger)
    assert [r["resident"] for r in _rows(device_ledger)] == [True, True, False]
    fam = registry().get("celestia_jit_compile_seconds_total")
    assert dict((tuple(k.items()), v) for k, v in fam.samples())[
        (("family", "extend_and_dah"),)] >= 0.25


def test_tracked_pipelines_of_the_extend_path(monkeypatch):
    """compute's pipeline, warm-up and the forest register themselves."""
    import numpy as np

    from celestia_app_tpu_torch.da import ExtendedDataSquare
    from celestia_app_tpu_torch.da import eds as eds_mod
    from celestia_app_tpu_torch.kernels.fused import forest

    eds_mod._cached_pipeline.cache_clear()
    forest.cache_clear()
    ods = np.zeros((2, 2, 512), dtype=np.uint8)
    for _ in range(3):
        eds = ExtendedDataSquare.compute(ods, "leopard", device="cpu")
    forest(2, "cpu")(eds._eds)
    rows = {(r["family"], r["mode"]): r for r in _rows(device_ledger)}
    assert rows[("extend_and_dah", "fused")]["dispatches"] == 3
    assert rows[("extend_and_dah", "fused")]["builds"] == 1
    assert rows[("forest", "")]["dispatches"] == 1
    builds = registry().get("celestia_jit_builds_total")
    assert any(k.get("program") == "extend_and_dah" for k, _ in builds.samples())


def test_reconcile_on_the_cpu_equals_jax():
    for m in LEDGERS:
        m.note_owned_bytes("probe", "a", 1000)
        m.note_owned_bytes("probe", "b", 24)
        m.register_owner("cb", lambda: 76)
        m.register_owner("bad", lambda: 1 // 0)
    port, ref = device_ledger.reconcile("cpu"), jax_ledger.reconcile()
    assert port["measured_source"] == ref["measured_source"] == "rss_high_water"
    assert port["owners"] == ref["owners"] == {"bad": 0, "cb": 76, "probe": 1024}
    assert port["owned_bytes"] == 1100
    assert port["unattributed_residual"] == max(0, port["measured_bytes"] - 1100)
    assert set(port) == set(ref)
    gauge = {tuple(k.items()): v for k, v in registry().get("celestia_device_bytes").samples()}
    assert gauge[(("owner", "probe"),)] == 1024
    assert gauge[(("owner", "unattributed_residual"),)] == port["unattributed_residual"]
    device_ledger.forget_owned_bytes("probe")
    device_ledger.reconcile("cpu")
    gauge = {tuple(k.items()): v for k, v in registry().get("celestia_device_bytes").samples()}
    assert gauge[(("owner", "probe"),)] == 0  # a vanished owner re-zeros


def test_leak_trigger_fires_on_the_same_tick_as_jax(monkeypatch):
    """An owner whose claimed bytes shrink every tick makes the residual
    grow: the trigger fires after $CELESTIA_DEVICE_LEAK_TICKS growths, once
    per episode, in both ledgers."""
    monkeypatch.setenv("CELESTIA_DEVICE_LEAK_TICKS", "2")
    fired = {}
    for m, flight in ((jax_ledger, jax_flight), (device_ledger, flight_recorder)):
        owned = [1 << 20]  # below the process's RSS: the residual is positive
        m.register_owner("shrinking", lambda owned=owned: owned[0])
        before = len(flight.recent_dumps(trigger="device_residual_growth"))
        streaks = []
        for _ in range(5):
            owned[0] //= 2
            streaks.append(m.reconcile()["residual_growth_streak"])
        fired[m.__name__.split(".")[0]] = (
            streaks, len(flight.recent_dumps(trigger="device_residual_growth")) - before)
    assert fired["celestia_app_tpu_torch"] == fired["celestia_app_tpu"] == ([0, 1, 2, 1, 2], 2)
    bundle = _bundles("device_residual_growth")[-1]
    assert bundle["context"]["source"] == "rss_high_water"


def test_snapshot_payload_and_warmup_notes(monkeypatch):
    monkeypatch.setenv("CELESTIA_DEVICE_TICK_S", "3600")
    monkeypatch.setenv("CELESTIA_PIPE_FUSED", "epi")
    for m in LEDGERS:
        m.note_warmup(4, "leopard", "fused")
        m.note_warmup(2, "vandermonde", "panel")
    snap = device_ledger.snapshot("cpu")
    ref = jax_ledger.snapshot()
    assert snap["warmup"] == ref["warmup"]
    assert snap["autotuner_seats"] == ref["autotuner_seats"]
    assert set(snap) == set(ref)
    body = device_ledger.device_payload()
    assert device_ledger.device_payload() == body  # frozen inside one tick
    assert json.loads(body)["warmup"] == snap["warmup"]


# --- the journal and the profiler -------------------------------------------------


def test_journal_row_equals_jax(monkeypatch):
    monkeypatch.setenv("CELESTIA_SLO_TICK_S", "3600")
    fields = {"upload_ms": 1.5, "dispatch_ms": 0.2, "panels": 4, "speculation": "discard"}
    reg_before = {}
    for name, reg in (("jax", jax_registry), ("port", registry)):
        fam = reg().get("celestia_block_dispatch_seconds")
        reg_before[name] = fam.snapshot() if fam is not None else None
    with jax_use_context(jax_new_context(height=12)) as ctx:
        jax_journal.record("compute", 8, mode="panel", compile="miss", **fields)
        jax_row = dict(jax_traced().table(jax_journal.TABLE)[-1])
    with use_context(new_context(height=12)) as port_ctx:
        journal.record("compute", 8, mode="panel", compile="miss", **fields)
        port_row = dict(traced().table(journal.TABLE)[-1])
    assert jax_row.pop("trace_id") == ctx.trace_id
    assert port_row.pop("trace_id") == port_ctx.trace_id
    for row in (jax_row, port_row):
        row.pop("ts_ns", None)
        row.pop("ts", None)
    assert port_row == jax_row
    assert {k: v for k, v in journal.rows("compute")[-1].items() if k != "ts_ns"} == {
        "source": "compute", "k": 8, "mode": "panel", "compile": "miss", **fields}
    for name, reg in (("jax", jax_registry), ("port", registry)):
        hist = reg().get("celestia_block_upload_seconds").snapshot()
        assert hist.quantile(0.5, source="compute", k="8") is not None
    compiles = {tuple(sorted(k.items())): v
                for k, v in registry().get("celestia_pipeline_compile_total").samples()}
    assert compiles[(("result", "miss"), ("source", "compute"))] >= 1
    peaks = registry().get("celestia_hbm_peak_bytes").samples()
    assert any(k == {"point": "compute", "source": "rss", "k": "8"} for k, _ in peaks)


def test_muted_tracing_keeps_the_ring(monkeypatch):
    monkeypatch.setenv("CELESTIA_TRACE", "off")
    rows = len(traced().table(journal.TABLE))
    journal.record("stream", 4, mode="fused", compile="hit", drain_ms=0.1)
    assert len(traced().table(journal.TABLE)) == rows
    assert journal.rows("stream")[-1]["drain_ms"] == 0.1


def test_profiler_window_writes_a_chrome_trace(monkeypatch, tmp_path):
    monkeypatch.setenv("CELESTIA_PROFILE_BLOCKS", "2")
    monkeypatch.setenv("CELESTIA_PROFILE_DIR", str(tmp_path / "prof"))
    prof = profiler.BlockProfiler()
    prof.note_block()
    import torch

    torch.ones(64).sum()
    prof.note_block()
    prof.note_block()  # one window per process: nothing more
    path = Path(prof.trace_path)
    assert path.parent == tmp_path / "prof" and "traceEvents" in json.loads(path.read_text())
    events = [r["event"] for r in traced().table("profiler")[-2:]]
    assert events == ["started", "stopped"]
    assert profiler.hbm_high_water() is None  # no card in this process
    # The process's peak RSS only rises, and may rise between two reads
    # (torch.profiler's teardown allocates): the port's read lies between
    # the JAX read before it and the JAX read after it.
    before = jax_profiler_rss()
    port = profiler.rss_high_water()
    assert before <= port <= jax_profiler_rss()


def jax_profiler_rss():
    from celestia_app_tpu.trace.profiler import rss_high_water

    return rss_high_water()


# --- the flight recorder and the SLO trigger --------------------------------------


def test_bundle_sections_equal_jax():
    from celestia_app_tpu.serve import api as jax_api
    from celestia_app_tpu_torch.serve import api

    degrade.DEVICE_DEGRADATION.degrade("fused")
    jax_degrade.DEVICE_DEGRADATION.degrade("fused")
    for mod in (api, jax_api):
        mod._reset_coverage_for_tests()
        mod.coverage_tick(3, 4, [(0, 0), (5, 6)], "withheld")
    port, ref = flight_recorder.capture("probe"), jax_flight.capture("probe")
    assert port["degraded"] == ref["degraded"] == {"device": "staged"}
    assert set(port["device"]) == set(ref["device"])
    assert port["device"]["ownership"]["measured_source"] == "rss_high_water"
    assert port["coverage"] == ref["coverage"]
    assert set(port["timeline"]) == set(ref["timeline"])
    # The probe's view (trace/exposition.health_payload), the bundle's last
    # section to be ported.
    assert set(port) == set(ref)
    assert port["healthz"]["status"] == ref["healthz"]["status"] == "DEGRADED"
    assert port["healthz"]["degraded"] == ref["healthz"]["degraded"] == {"device": "staged"}


def test_a_breaker_trip_writes_its_bundle():
    degrade.DEVICE_DEGRADATION.degrade("fused_epi", observed="fused_epi")
    bundle = _bundles("breaker_trip")[-1]
    assert bundle["context"] == {"layer": "device", "mode": "fused", "observed": "fused_epi",
                                 "base": "fused_epi"}
    assert bundle["degraded"] == {"device": "fused"}


def test_peer_bundle_index_equals_jax(monkeypatch, tmp_path):
    out = tmp_path / "shared"
    out.mkdir()
    monkeypatch.setenv("CELESTIA_FLIGHT_DIR", str(out))
    names = ["flight-breaker_trip-node-a-100-1.json", "flight-slo_fast_burn-node-a-300-2.json",
             "flight-wal_salvage-node-b-7-1.json", "flight-old-200.json", "notes.txt",
             f"flight-worker_death-{node_id()}-5-9.json"]  # this node's own: left out
    for i in range(10):
        names.append(f"flight-parity_mismatch-node-c-{1000 + i}-{i}.json")
    for name in names:
        (out / name).write_text("{}")
    got = flight_recorder.peer_bundle_index(limit_per_node=4)
    assert got == jax_flight.peer_bundle_index(limit_per_node=4)
    assert [d["ts_ns"] for d in got["node-c"]] == [1006, 1007, 1008, 1009]
    monkeypatch.setenv("CELESTIA_FLIGHT_DIR", str(tmp_path / "absent"))
    assert flight_recorder.peer_bundle_index() == {}


def test_slo_fast_burn_page_writes_its_bundle():
    page = {"slo": "degraded", "state": "fast_burn", "burn": {"fast": 100.0, "slow": 10.0},
            "objective": 0.99}
    slo.SLOEngine()._page(page)
    jax_slo.SLOEngine()._page(page)
    bundle = _bundles("slo_fast_burn")[-1]
    assert bundle["context"] == {"slo": "degraded", "burn_fast": 100.0, "burn_slow": 10.0,
                                 "objective": 0.99}
    before = len(_bundles("slo_fast_burn"))
    slo.SLOEngine()._page({**page, "state": "slow_burn"})
    assert len(_bundles("slo_fast_burn")) == before


# --- the mempool's chaos seam ---------------------------------------------------


LABELS = ("a1", "b2", "c3", "d4", "tx")


def _tx(ns: str, i: int) -> bytes:
    return f"{ns}:{i}:".encode().ljust(60 + 7 * i, b".")


@pytest.mark.parametrize("shards", [8, 0])
def test_mempool_insert_seam_drops_like_jax(shards):
    from celestia_app_tpu.trace import square_journal as jax_square_journal
    from celestia_app_tpu_torch.trace import square_journal

    # The per-process namespace label cap decides a tx's shard, and with it
    # the shard's injection stream: both packages start from an empty cap.
    jax_square_journal._reset_for_tests()
    square_journal._reset_for_tests()
    spec = "seed=4,mempool_drop=0.5"
    verdicts = {}
    for name, mod, c in (("jax", jax_mempool, jax_chaos), ("port", mempool, chaos)):
        pool = mod.PriorityMempool(shards=shards)
        c.install(spec)
        try:
            verdicts[name] = [pool.insert(_tx(LABELS[i % 5], i), 1, 0, ns=LABELS[i % 5])
                              for i in range(30)]
        finally:
            c.uninstall()
        verdicts[name + "_resident"] = sorted(pool.resident_txs())
    assert verdicts["port"] == verdicts["jax"]
    assert verdicts["port_resident"] == verdicts["jax_resident"]
    assert 0 < sum(verdicts["port"]) < 30
    injected = {tuple(k.items()): v
                for k, v in registry().get("celestia_chaos_injections_total").samples()}
    assert injected[(("seam", "mempool.insert"),)] >= 30 - sum(verdicts["port"])


def _ods(k: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, (k, k, 512), dtype=np.uint8)
    ods[..., :29] = 0
    return ods


def _count(reg, name: str, **labels) -> float:
    fam = reg().get(name)
    if fam is None:
        return 0.0
    return sum(v for key, v in fam.samples() if all(key.get(a) == b for a, b in labels.items()))


# --- the parity sentinel and warm-up (da/eds.py) ----------------------------------------------


def _checks(result: str) -> float:
    return _count(registry, "celestia_parity_checks_total", result=result)


@pytest.mark.parametrize("base", ["on", "epi"])
def test_sentinel_matches_then_reports_a_mismatch(base, monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_FUSED", base)
    monkeypatch.setenv("CELESTIA_PARITY_SENTINEL", "1")
    matches = _checks("match")
    for seed in (170, 171):
        ExtendedDataSquare.compute(_ods(4, seed=seed), device="cpu")
    eds_mod.drain_parity_checks()
    assert _checks("match") == matches + 2
    mismatches, rows = _checks("mismatch"), len(traced().table("parity_mismatch"))
    monkeypatch.setattr(eds_mod, "_staged_root", lambda *a: bytes(32))
    ExtendedDataSquare.compute(_ods(4, seed=172), device="cpu")
    eds_mod.drain_parity_checks()
    assert _checks("mismatch") == mismatches + 1
    row = traced().table("parity_mismatch")[-1]
    assert len(traced().table("parity_mismatch")) == rows + 1 and row["staged"] == "00" * 32
    assert _bundles("parity_mismatch")[-1]["context"]["k"] == 4


def test_sentinel_skips_the_reference_rung(monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_FUSED", "off")
    monkeypatch.setenv("CELESTIA_PARITY_SENTINEL", "1")
    before = sum(_checks(r) for r in ("match", "mismatch", "error"))
    ExtendedDataSquare.compute(_ods(4, seed=173), device="cpu")
    eds_mod.drain_parity_checks()
    assert sum(_checks(r) for r in ("match", "mismatch", "error")) == before
    monkeypatch.setenv("CELESTIA_PARITY_SENTINEL", "zap")
    assert eds_mod.parity_sentinel_every() == 0


def test_warmup_journals_each_size_and_the_next_compute_hits(monkeypatch):
    monkeypatch.setenv("CELESTIA_RS_CONSTRUCTION", "leopard")
    rows0 = len(journal.rows("warmup"))
    assert eds_mod.warmup([2, 4], batches=(1, 2), device="cpu") == [2, 4]
    rows = journal.rows("warmup")[rows0:]
    assert [(r["k"], r["mode"], r.get("batch_size")) for r in rows] == \
        [(2, "fused", None), (2, "fused", 2), (4, "fused", None), (4, "fused", 2)]
    assert all(r["warm_ms"] > 0 and r["construction"] == "leopard" for r in rows)
    warmed = device_ledger.snapshot()["warmup"]
    assert {"k": 4, "construction": "leopard", "mode": "fused"} in warmed
    eds_mod.warmup([4], device="cpu")
    assert journal.rows("warmup")[-1]["compile"] == "hit"
    ExtendedDataSquare.compute(_ods(4, seed=174), device="cpu")
    assert journal.rows("compute")[-1]["compile"] == "hit"
    assert eds_mod.warmup(upto=5, device="cpu") == jax_warmup_sizes(5) == [1, 2, 4]


def test_extra_warmup_sizes_equal_jax(monkeypatch, capsys):
    monkeypatch.setenv("CELESTIA_WARMUP_K", "4, 8,zap,3,1024 0")
    assert eds_mod.extra_warmup_sizes() == jax_extra_warmup_sizes() == [4, 8, 1024]
    err = capsys.readouterr().err
    assert "malformed CELESTIA_WARMUP_K entry 'zap'" in err and "out-of-range" in err
