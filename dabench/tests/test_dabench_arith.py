"""The reductions from spans and counters to metrics, on fixed inputs, and
the end-to-end metrics taken over all of a window's work, a stall
included."""

from __future__ import annotations

import json
import time

import pytest

from dabench import devicetrace, harness, readers, roofline
from dabench.spec import Layer

RS = Layer("RS encode", (r"\brs_dense_kernel\b", r"\brs_xor_kernel\b"), ("rs_dense", "rs_xor"))
NMT = Layer("NMT", (r"\bsha256_batch_kernel\b",), ("sha256",))
COPY = Layer("staging", ("^Memcpy HtoD",), ())

# Device events in microseconds: two RS kernels overlapping a copy, a gap,
# a hash kernel.  Busy: [0, 40) and [60, 70) -> 50 us.
EVENTS = [
    (0.0, 30.0, "void (anonymous namespace)::rs_dense_kernel(CUtensorMap_st, int)"),
    (10.0, 40.0, "Memcpy HtoD (Pinned -> Device)"),
    (60.0, 70.0, "void sha256_batch_kernel(unsigned char const*, long long, int)"),
]


def test_busy_idle_and_breakdown():
    assert devicetrace.merged(EVENTS) == [(0.0, 40.0), (60.0, 70.0)]
    assert devicetrace.busy_s(EVENTS) == pytest.approx(50e-6)
    assert devicetrace.idle_pct(EVENTS, 100e-6) == pytest.approx(50.0)
    assert devicetrace.idle_pct([], 1.0) is None
    ops = dict(devicetrace.device_ops(EVENTS))
    assert ops == pytest.approx({"rs_dense_kernel": 30e-6, "Memcpy HtoD (Pinned -> Device)": 30e-6,
                                 "sha256_batch_kernel": 10e-6})
    gaps = devicetrace.idle_gaps(EVENTS)
    assert gaps == [["after Memcpy HtoD (Pinned -> Device) / before sha256_batch_kernel",
                     pytest.approx(20e-6)]]


def test_short_names():
    assert devicetrace.short_name("void at::native::(anonymous namespace)::reduce_kernel<512, 1>"
                                  "(int)") == "at::native::reduce_kernel"
    assert devicetrace.short_name("void rs_dense_leaf_kernel<16>(CUtensorMap_st)") == \
        "rs_dense_leaf_kernel"


def test_cross_check_takes_no_shortfall():
    act = devicetrace.Activity(events=EVENTS, window_s=1e-4, launches={"rs_dense": 1,
                                                                       "sha256": 1}, traced=True)
    assert devicetrace.cross_check(act, [RS, NMT, COPY], 0.0)[0]
    act.launches["sha256"] = 2  # the profiler missed one hash kernel
    ok, said = devicetrace.cross_check(act, [RS, NMT, COPY], 0.5)
    assert not ok and "NMT: profiler 1, counters 2 (disagree)" in said
    act.launches["sha256"] = 0  # one kernel more than counted: within slack only
    assert not devicetrace.cross_check(act, [RS, NMT], 0.0)[0]


class _Run:
    def __init__(self, ops, journal=(), k=512, m=16):
        self.traced_ops, self.journal, self.k, self.m = ops, list(journal), k, m


def _view(ops, journal=(), ok=True, k=512, m=16):
    run = _Run(ops, journal, k, m)
    run.activity = devicetrace.Activity(events=EVENTS, window_s=100e-6,
                                        launches={"rs_dense": 3, "sha256": 1}, traced=True)
    return harness.LayerView(run, {"RS encode": RS, "NMT": NMT, "staging": COPY}, ok)


def test_roofline_shares():
    # k=512, m=16: one extension is 2.64e13 bit-products, 3.3335 ms at 7.916e15/s.
    assert roofline.rs_bit_products(512, 16) == 3 * 512 ** 3 * 16 * 4096
    assert roofline.rs_least_s(512, 16) == pytest.approx(3.3335e-3, rel=1e-4)
    assert roofline.nmt_least_s(512) == pytest.approx(1.2991e-3, rel=1e-4)
    view = _view(ops=2, k=1, m=8)
    least = roofline.rs_least_s(1, 8)
    assert readers.roofline_pct(view, "RS encode", least) == pytest.approx(100 * 2 * least / 30e-6)
    assert readers.roofline_pct(_view(2, ok=False), "RS encode", least) is None
    assert readers.idle_pct(_view(2)) == pytest.approx(50.0)
    assert readers.idle_pct(_view(2, ok=False)) is None
    assert readers.launches_per_op(_view(3), "RS encode") == 1.0


def test_journal_stage_counts_each_batch_once():
    rows = [{"dispatch_ms": 8.0, "batch_size": 4}] * 4 + [{"dispatch_ms": 3.0, "batch_size": 1}]
    view = _view(5, journal=rows)
    assert readers.journal_ms_per_square(view, "dispatch_ms") == pytest.approx((8.0 + 3.0) / 5)
    assert readers.journal_ms_per_square(_view(5), "upload_ms") is None


def test_percentile_is_nearest_rank():
    values = list(range(1, 201))  # 1..200
    assert harness.percentile(values, 95) == 190
    assert harness.percentile([5.0], 95) == 5.0
    assert harness.percentile(values, 100) == 200


def _env(monkeypatch, bench, cell):
    for key, value in bench.config(bench.cell(cell)).get("env", {}).items():
        monkeypatch.setenv(key, value)


def test_replay_rate_counts_all_the_window_with_a_stall(tiny_bench, monkeypatch):
    """A stall inside the window costs throughput: the rate is the squares
    whose root reached the host in the window over the whole window."""
    from celestia_app_tpu_torch.parallel import pipeline

    _env(monkeypatch, tiny_bench, "replay-k512")
    real = pipeline.stream_blocks
    stalled = []

    def stalling(*a, **kw):
        for n, item in enumerate(real(*a, **kw)):
            if n == 5 and not stalled:  # the second square of the window
                stalled.append(time.perf_counter())
                time.sleep(0.6)
            yield item

    monkeypatch.setattr("celestia_app_tpu_torch.parallel.stream_blocks", stalling)
    res = harness.run_cell(tiny_bench, "replay-k512", 11, 1.5, False, "cpu",
                           time.perf_counter())
    assert stalled and res["correct"], json.dumps(res)
    square = 4 * 4 * 512
    rate = res["metrics"]["replay_MBps"]["value"]
    completed = rate * 1e6 * 1.5 / square
    assert completed == pytest.approx(round(completed))
    assert 0 < completed < res["attempted"]


def test_repair_tail_holds_a_stalled_repair(tiny_bench, monkeypatch):
    import importlib

    _env(monkeypatch, tiny_bench, "repair-k512-q0")
    module = importlib.import_module("celestia_app_tpu_torch.da.repair")
    real = module.repair
    calls = []

    def slow_once(*a, **kw):
        calls.append(1)
        if len(calls) == 4:  # the second repair of the window
            time.sleep(0.8)
        return real(*a, **kw)

    monkeypatch.setattr(module, "repair", slow_once)
    res = harness.run_cell(tiny_bench, "repair-k512-q0", 12, 1.5, False, "cpu",
                           time.perf_counter())
    assert res["correct"], json.dumps(res)
    assert res["attempted"] < 20  # nearest-rank p95 of so few repairs is their maximum
    assert res["metrics"]["repair_p95_ms"]["value"] >= 800
