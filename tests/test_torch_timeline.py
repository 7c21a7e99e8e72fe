"""The port's height timeline (trace/timeline.py) and the tracer's row
observers, held against the JAX package: the same row stream, written
through each package's tracer with pinned timestamps, gives the same
`timeline_response` bytes for every query, the same bundle and fleet
blocks and the same critical paths.  Host code only; no JAX program is
compiled.
"""

from __future__ import annotations

import random
import time

import pytest

from celestia_app_tpu.trace import timeline as jax_tl
from celestia_app_tpu.trace.tracer import Tracer as JaxTracer
from celestia_app_tpu.trace.tracer import traced as jax_traced
from celestia_app_tpu_torch.trace import flight_recorder
from celestia_app_tpu_torch.trace import timeline as tl
from celestia_app_tpu_torch.trace.tracer import Tracer, traced

MS = 1_000_000
BASE = 1_700_000_000_000_000_000


@pytest.fixture(autouse=True)
def _fresh_timelines():
    tl._reset_for_tests()
    jax_tl._reset_for_tests()
    yield
    tl._reset_for_tests()
    jax_tl._reset_for_tests()


def stream(h0: int) -> list[tuple[str, float, dict]]:
    """One row stream touching every table the timeline folds: a traced
    submit parked until its proposal binds it, a streamed block's journal
    row, the square and round journals (with a round bump), a compile bill,
    admissions and evictions of the serve cache, a heal, and serve rows."""
    rows = []
    for i in range(3):
        h = h0 + i
        t = 100.0 * i
        trace = f"T-{h}"
        rows += [
            ("tx_submit", t + 2, {"duration_ms": 2.0, "trace_id": trace}),
            ("mempool_reap", t + 6, {"duration_ms": 1.0, "trace_id": trace}),
            ("block_propose", t + 12, {"duration_ms": 5.0, "trace_id": trace, "height": h}),
            ("square_journal", t + 13, {"height": h, "phase": "build", "k": 16,
                                        "occupancy": 0.5, "used_shares": 128,
                                        "n_blobs": 3, "n_namespaces": 2}),
            ("compile_bill", t + 30, {"compile_ms": 14.5, "height": h,
                                      "family": "square_pipeline"}),
            ("block_journal", t + 40, {"height": h, "trace_id": trace, "source": "stream",
                                       "k": 16, "mode": "fused", "compile": "hit",
                                       "intake_wait_ms": 1.5, "upload_ms": 2.25,
                                       "upload_stall_ms": 0.5, "dispatch_starve_ms": 0.25,
                                       "dispatch_ms": 3.0, "drain_ms": 1.0}),
            ("round_journal", t + 50, {"height": h, "round": i % 2,
                                       "result": "round_bump" if i == 1 else "decided",
                                       "prevote_ms": 3.5, "precommit_ms": 2.5,
                                       "propose_ms": 9.0, "wal_fsync_ms": 0.75}),
            ("block_commit", t + 55, {"duration_ms": 4.0, "height": h}),
            ("forest_cache", t + 58, {"event": "admit", "height": h, "forest_build_ms": 2.125}),
            ("forest_cache", t + 58, {"event": "spill", "height": h0}),
            ("heal", t + 70, {"node": "n", "height": h, "kind": "withheld",
                              "outcome": "healed", "attempts": 1, "total_ms": 9.5,
                              "phases_ms": {"repair": 6.0}, "trace_id": None}),
        ]
        if i != 1:  # height h0 + 1 is never served: it stays open
            rows.append(("proof_serve", t + 80, {"height": h, "batch": 4, "heights": 1,
                                                 "mode": "batched", "shards": 0,
                                                 "share_shards": 0}))
    # A trace that never binds parks and stays out of every record.
    rows.append(("tx_submit", 400.0, {"duration_ms": 1.0, "trace_id": "T-orphan"}))
    return rows


def write_both(rows) -> None:
    for table, at_ms, fields in rows:
        ts = BASE + int(at_ms * MS)
        traced().write(table, ts_ns=ts, **fields)
        jax_traced().write(table, ts_ns=ts, **fields)


QUERIES = ({}, {"height": "latest"}, {"height": "5001"}, {"height": "5002"},
           {"height": "5003"}, {"height": "99"}, {"height": "x"}, {"tail": "2"},
           {"tail": "0"}, {"tail": "y"})


def test_responses_equal_jax_on_the_same_rows(monkeypatch):
    write_both(stream(5001))
    # note_first_serve stamps the wall clock: the same clock on both.
    clock = iter(range(BASE + 500 * MS, BASE + 600 * MS, MS))
    pinned = {}

    def fake_time_ns():
        return pinned.setdefault("now", next(clock))

    monkeypatch.setattr(time, "time_ns", fake_time_ns)
    tl.timeline().note_first_serve(5002, "jsonrpc", "share_proof")
    jax_tl.timeline().note_first_serve(5002, "jsonrpc", "share_proof")
    monkeypatch.undo()
    for q in QUERIES:
        got, want = tl.timeline_response(dict(q)), jax_tl.timeline_response(dict(q))
        assert got == want, q
    assert tl.timeline_response({"height": "5002"})[0] == 200
    assert tl.timeline().bundle_block(tail=2) == jax_tl.timeline().bundle_block(tail=2)
    payload = tl.timeline().index_payload()
    assert tl.fleet_block(payload) == jax_tl.fleet_block(payload)
    assert tl.fleet_block(None) is None
    rec = tl.timeline().record_payload(5001)
    assert rec["finalized"] and rec["meta"]["heal"]["outcome"] == "healed"
    assert "T-orphan" not in rec["trace_ids"]


def test_ring_eviction_and_capacity_zero_match_jax():
    tl._reset_for_tests(capacity=2)
    jax_tl._reset_for_tests(capacity=2)
    write_both(stream(6001))
    assert tl.timeline_response({}) == jax_tl.timeline_response({})
    # The last height's spill row of the first re-opens its record.
    assert tl.timeline().index_payload()["heights"] == [6003, 6001]
    tl._reset_for_tests(capacity=0)
    jax_tl._reset_for_tests(capacity=0)
    write_both(stream(7001))
    assert tl.timeline_response({}) == jax_tl.timeline_response({})
    assert tl.timeline().index_payload()["heights"] == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_critical_path_matches_jax(seed):
    rng = random.Random(seed)
    phases = ("propose", "mempool_reap", "dispatch", "drain", "heal", "upload_stall")
    intervals = []
    for _ in range(40):
        start = rng.randrange(0, 10_000) * 1000
        intervals.append((start, start + rng.randrange(0, 3000) * 1000, rng.choice(phases),
                          rng.choice(("phase", "gap"))))
    assert tl.critical_path(intervals) == jax_tl.critical_path(intervals)


def test_tracer_observers_run_after_each_write_and_never_fail_it():
    for cls in (Tracer, JaxTracer):
        tracer = cls()
        seen = []

        def good(table, row):
            seen.append((table, row["x"]))

        def bad(table, row):
            raise RuntimeError("observer fault")

        tracer.add_observer(good)
        tracer.add_observer(good)  # idempotent
        tracer.add_observer(bad)
        tracer.write("t", x=1)
        tracer.write("t", x=2)
        assert seen == [("t", 1), ("t", 2)]
        assert [r["x"] for r in tracer.table("t")] == [1, 2]


def test_traced_installs_the_timeline_and_the_bundle_carries_it():
    traced().write("block_propose", ts_ns=BASE, duration_ms=1.0, height=8001)
    assert tl.timeline().record_payload(8001)["phases"] == {"propose": 1.0}
    bundle = flight_recorder.capture("heal_completed")
    assert bundle["timeline"]["latest"]["height"] == 8001
    assert "coverage" in bundle
