"""The port's mempool, QoS, square journal, SLO engine and owner registry
against the JAX package's, decision for decision, on the CPU.

The same scripted insert / reap / update (commit and TTL) / evict / recheck
sequences go through a JAX `PriorityMempool` and the port's, under the
global pool (shards 0) and the sharded one (8), with reap budgets that bind
(DRR on the sharded pool) and that do not: every return value, the resident
set in reap order, the byte and per-namespace accounting, the gauges and
the eviction counters are held equal after every step.  The QoS enforcers
of both packages take the same admissions on one fake clock; the square
journals the same squares; the SLO engines the same observations on fake
clocks.  The JAX modules under test are host code; the file still clears
JAX's caches when it ends, as every port test file that imports JAX does.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import threading

import jax
import numpy as np
import pytest

from celestia_app_tpu import mempool as jax_mempool
from celestia_app_tpu import qos as jax_qos
from celestia_app_tpu.square import builder as jax_builder
from celestia_app_tpu.trace import device_ledger as jax_ledger
from celestia_app_tpu.trace import slo as jax_slo
from celestia_app_tpu.trace import spans as jax_spans
from celestia_app_tpu.trace import square_journal as jax_journal
from celestia_app_tpu.trace.metrics import registry as jax_registry
from celestia_app_tpu.trace.tracer import traced as jax_traced
from celestia_app_tpu_torch import mempool, qos
from celestia_app_tpu_torch.square import builder
from celestia_app_tpu_torch.testutil import deterministic_genesis, funded_keys
from celestia_app_tpu_torch.testutil.blocks import block_txs
from celestia_app_tpu_torch.trace import device_ledger, slo, spans, square_journal
from celestia_app_tpu_torch.trace.metrics import registry
from celestia_app_tpu_torch.trace.tracer import traced

LABELS = ("a1", "b2", "c3", "d4", "tx")


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free whatever JAX compiled while this module ran, when it ends (the
    per-process map limit; see tests/test_torch_app.py)."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _clean():
    """A fresh top-N admission set and no QoS policy in both packages, as
    the JAX package's own tests start (earlier tests of the worker may have
    filled the process-level label cap)."""
    for journal, q in ((jax_journal, jax_qos), (square_journal, qos)):
        journal._reset_for_tests()
        q.uninstall()
    yield
    for q, s in ((jax_qos, jax_slo), (qos, slo)):
        q.uninstall()
        s.set_tenant_specs(())


def tx_for(ns: str, i: int, size: int) -> bytes:
    return f"{ns}:{i}:".encode().ljust(size, b".")


class Clock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def outcome(fn, *args, **kwargs):
    """A call's result, or its exception's type name and message."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 — the comparison is the point
        return ("raised", type(e).__name__, str(e))


def gauge_values(reg, labels) -> dict:
    out = {}
    for name in ("celestia_mempool_txs", "celestia_mempool_size_bytes"):
        out[name] = dict((tuple(sorted(k.items())), v) for k, v in reg.get(name).samples())
    for name in ("celestia_mempool_namespace_txs", "celestia_mempool_namespace_size_bytes"):
        out[name] = {k["namespace"]: v for k, v in reg.get(name).samples()
                     if k.get("namespace") in labels}
    return out


def zero_namespace_gauges(labels) -> None:
    """Start both registries' per-namespace gauges at 0 for `labels`: the
    registries are process-wide, and an earlier test's pool may have left
    a value on a label this test's pools publish only later."""
    for reg in (jax_registry, registry):
        for name in ("celestia_mempool_namespace_txs", "celestia_mempool_namespace_size_bytes"):
            for lbl in labels:
                reg().gauge(name).set(0, namespace=lbl)


def counter_values(reg, name: str, labels) -> dict:
    fam = reg.get(name)
    if fam is None:
        return {}
    return {tuple(sorted(k.items())): v for k, v in fam.samples()
            if k.get("namespace") in labels}


def counter_delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def pool_state(pool, labels) -> dict:
    return {
        "resident": pool.resident_txs(),
        "len": len(pool),
        "bytes": pool.size_bytes(),
        "ns_bytes": {lbl: pool.namespace_bytes(lbl) for lbl in labels},
        "shard_txs": [len(s.entries) for s in pool._shards],
    }


def script(seed: int, blob_txs: list[bytes]) -> list[tuple]:
    """Insert waves (duplicates, oversize, pool pressure, real BlobTxs
    parsed for their namespace), reaps with binding and free budgets,
    commits, TTL expiries and recheck evictions."""
    rng = np.random.default_rng(seed)
    ops: list[tuple] = []
    resident: list[bytes] = []
    blobs = iter(blob_txs)
    for i in range(90):
        height = i // 15
        if i % 11 == 5 and (raw := next(blobs, None)) is not None:
            ops.append(("insert", raw, int(rng.integers(0, 6)), height, None))
            resident.append(raw)
            continue
        ns = LABELS[int(rng.integers(len(LABELS)))]
        tx = tx_for(ns, i, int(rng.integers(40, 1000)))
        ops.append(("insert", tx, int(rng.integers(0, 6)), height, ns))
        resident.append(tx)
        if i % 9 == 4:
            ops.append(("insert", tx, int(rng.integers(0, 6)), height, ns))  # duplicate
        if i % 10 == 9:
            ops.append(("reap", int(rng.integers(1500, 6000))))
            ops.append(("reap", None))
        if i % 15 == 14:
            pick = rng.choice(len(resident), size=min(6, len(resident)), replace=False)
            ops.append(("update", height + 1, [resident[int(j)] for j in pick]))
        if i % 13 == 12:
            ops.append(("remove_tx", resident[int(rng.integers(len(resident)))]))
    for h in (8, 12):  # past the TTL of every wave
        ops.append(("update", h, []))
    return ops


def blob_txs(n: int) -> list[bytes]:
    keys = funded_keys(4)
    return block_txs(keys, deterministic_genesis(keys).chain_id, seed=3, sends=0, pfbs=n,
                     blob_shares=(1, 2))


def apply(pool, op):
    name, *args = op
    if name == "insert":
        tx, prio, height, ns = args
        return pool.insert(tx, prio, height, ns=ns)
    if name == "reap":
        return pool.reap(args[0])
    if name == "update":
        return pool.update(*args)
    return pool.remove_tx(*args)


@pytest.mark.parametrize("quantum", [None, "700"])
@pytest.mark.parametrize("shards", [0, 8])
def test_pool_sequences_equal_jax(shards, quantum, monkeypatch):
    if quantum is None:
        monkeypatch.delenv("CELESTIA_MEMPOOL_QUANTUM", raising=False)
    else:
        monkeypatch.setenv("CELESTIA_MEMPOOL_QUANTUM", quantum)
    blobs = blob_txs(6)
    labels = set(LABELS) | {jax_journal.tx_namespace_label(t) for t in blobs}
    zero_namespace_gauges(labels)
    kw = dict(max_tx_bytes=950, max_pool_bytes=14_000, shards=shards)
    ref, port = jax_mempool.PriorityMempool(**kw), mempool.PriorityMempool(**kw)
    counters = ("celestia_mempool_evictions_total",)
    before = [{c: counter_values(reg(), c, labels) for c in counters}
              for reg in (jax_registry, registry)]
    waits = [reg().histogram("celestia_e2e_seconds", "", buckets=spans.E2E_SECONDS_BUCKETS)
             .snapshot() for reg in (jax_registry, registry)]
    reaps = drr = 0
    for step, op in enumerate(script(shards + 17, blobs)):
        got = [outcome(apply, pool, op) for pool in (ref, port)]
        assert got[0] == got[1], (step, op[0])
        assert pool_state(ref, labels) == pool_state(port, labels), (step, op[0])
        assert gauge_values(jax_registry(), labels) == gauge_values(registry(), labels), step
        if op[0] == "reap":
            reaps += 1
            drr += op[1] is not None and shards > 0 and sum(map(len, ref.resident_txs())) > op[1]
    after = [{c: counter_values(reg(), c, labels) for c in counters}
             for reg in (jax_registry, registry)]
    deltas = [{c: counter_delta(b[c], a[c]) for c in counters} for b, a in zip(before, after)]
    assert deltas[0] == deltas[1]
    reasons = {dict(k)["reason"] for k in deltas[1]["celestia_mempool_evictions_total"]}
    assert reasons == {"priority", "ttl", "recheck"}
    assert len(port) == 0 and reaps >= 16 and (drr > 0) == (shards > 0)
    for lbl in labels:  # one mempool_wait observation per first reap, per tenant
        ns = None if lbl == "tx" else lbl
        counts = []
        for reg, base in zip((jax_registry, registry), waits):
            snap = reg().get("celestia_e2e_seconds").snapshot().delta(base)
            counts.append(snap.count(phase="mempool_wait", **({"namespace": ns} if ns else {})))
        assert counts[0] == counts[1], lbl


def test_key_paths_and_env_parsing_equal(monkeypatch, capsys):
    for pool in (jax_mempool.PriorityMempool(shards=8), mempool.PriorityMempool(shards=8)):
        tx = tx_for("a1", 1, 100)
        assert pool.insert(tx, 3, 0, ns="a1") and pool.has_tx(tx) and pool.ctx_for(tx) is None
        pool.remove_tx(tx)
        assert not pool.has_tx(tx)
    for raw in ("", "auto", "0", "global", "GLOBAL", "4", "-2", "banana"):
        monkeypatch.setenv("CELESTIA_MEMPOOL_SHARDS", raw)
        jax_mempool._WARNED.discard("shards")
        mempool._WARNED.discard("shards")
        assert jax_mempool.mempool_shards() == mempool.mempool_shards(), raw
    assert "CELESTIA_MEMPOOL_SHARDS='banana'" in capsys.readouterr().err
    for raw in ("", "1024", "0", "x"):
        monkeypatch.setenv("CELESTIA_MEMPOOL_QUANTUM", raw)
        assert jax_mempool.reap_quantum() == mempool.reap_quantum(), raw


def test_concurrent_admission_equals_the_global_pool():
    """8 threads insert disjoint slices into the sharded port pool with a
    short switch interval; the resident set and accounting equal a JAX
    global pool fed serially."""
    rng = np.random.default_rng(5)
    rows = [(tx_for(LABELS[int(rng.integers(5))] + f"-{i % 3}", i, int(rng.integers(40, 400))),
             int(rng.integers(0, 4))) for i in range(800)]
    labels = {t.split(b":")[0].decode() for t, _ in rows}
    zero_namespace_gauges(labels)
    ref = jax_mempool.PriorityMempool(shards=0)
    for tx, prio in rows:
        assert ref.insert(tx, prio, 0, ns=tx.split(b":")[0].decode())
    port = mempool.PriorityMempool(shards=8)
    errors: list[BaseException] = []

    def admit(part):
        try:
            for tx, prio in part:
                assert port.insert(tx, prio, 0, ns=tx.split(b":")[0].decode())
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=admit, args=(rows[i::8],)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    a, b = pool_state(ref, labels), pool_state(port, labels)
    assert sorted(a.pop("resident")) == sorted(b.pop("resident"))
    assert (a["len"], a["bytes"], a["ns_bytes"]) == (b["len"], b["bytes"], b["ns_bytes"])
    port._refresh_gauges()
    ref._refresh_gauges()
    assert gauge_values(jax_registry(), labels) == gauge_values(registry(), labels)


QOS_SPEC = ("tx_rate=2,tx_burst=3,bytes_rate=900,pool_bytes=2500,a1.tx_rate=1,"
            "a1.slo_p99_ms=250,b2.proof_rate=0.5,b2.proof_burst=2,tx.tx_rate=5,"
            "c3.bytes_rate=0,d4.slo_p99_ms=40")


def test_qos_decisions_equal_on_one_fake_clock():
    clock = Clock()
    enfs = [m.QosEnforcer(m.parse_spec(QOS_SPEC), raw=QOS_SPEC, clock=clock)
            for m in (jax_qos, qos)]
    throttled = 0
    for step, (dt, tenant, proof, nbytes, resident) in enumerate(_draws(9, 300)):
        clock.t += dt
        got = []
        for m, enf in zip((jax_qos, qos), enfs):
            try:
                if proof:
                    enf.admit_proof(tenant)
                else:
                    enf.admit_tx(tenant, nbytes, resident)
                got.append(None)
            except m.QosThrottled as e:
                got.append((e.namespace, e.kind, e.limit, e.retry_after_s,
                            m.throttle_body(e), m.retry_after_header(e)))
        assert got[0] == got[1], step
        throttled += got[0] is not None
    assert throttled > 20
    assert json.dumps(enfs[0].health_block(), sort_keys=True) == \
        json.dumps(enfs[1].health_block(), sort_keys=True)
    assert [dataclasses.astuple(s) for s in enfs[0].slo_specs()] == \
        [dataclasses.astuple(s) for s in enfs[1].slo_specs()]
    for bad in ("tx_rate", "zap=1", ".tx_rate=1", "tx_rate=fast", "a.b.tx_rate=1"):
        assert outcome(jax_qos.parse_spec, bad) == outcome(qos.parse_spec, bad), bad


def _draws(rng_seed: int, n: int):
    rng = np.random.default_rng(rng_seed)
    return [(float(rng.choice([0.0, 0.05, 0.3, 1.7])), LABELS[int(rng.integers(len(LABELS)))],
             bool(rng.integers(4) == 0), int(rng.integers(10, 700)), int(rng.integers(0, 2500)))
            for _ in range(n)]


def test_qos_enforcement_through_both_pools():
    """install() on both packages, the enforcers on one fake clock: the
    same inserts are admitted or throttled with the same payload, and the
    tenant SLO specs land on both SLO engines."""
    clock = Clock()
    pools = []
    for m, mp in ((jax_qos, jax_mempool), (qos, mempool)):
        m.install(QOS_SPEC)._clock = clock
        pools.append(mp.PriorityMempool(shards=8))
    assert [s.name for s in jax_slo.engine().specs] == [s.name for s in slo.engine().specs]
    assert "qos_a1_e2e_p99" in [s.name for s in slo.engine().specs]
    for i, (dt, tenant, _, nbytes, _) in enumerate(_draws(4, 200)):
        clock.t += dt
        tx = tx_for(tenant, i, nbytes)
        got = []
        for m, pool in zip((jax_qos, qos), pools):
            try:
                got.append(pool.insert(tx, 1, 0, ns=tenant))
            except m.QosThrottled as e:
                got.append(m.throttle_body(e))
        assert got[0] == got[1], i
        assert pool_state(pools[0], LABELS) == pool_state(pools[1], LABELS)
    assert jax_qos.health_block() == qos.health_block()
    assert jax_journal.namespaces_payload()["qos"] == square_journal.namespaces_payload()["qos"]


def test_qos_env_cache_and_uninstall(monkeypatch):
    monkeypatch.setenv("CELESTIA_QOS", "tx_rate=3,zz.slo_p99_ms=100")
    a, b = jax_qos.enforcer(), qos.enforcer()
    assert (a.raw, a.params) == (b.raw, b.params) and qos.enforcer() is b
    assert [s.name for s in slo.engine().specs] == [s.name for s in jax_slo.engine().specs]
    monkeypatch.setenv("CELESTIA_QOS", "")
    assert jax_qos.enforcer() is None and qos.enforcer() is None
    assert qos.health_block() is None


def test_square_journal_labels_and_rows_equal(monkeypatch):
    keys = funded_keys(4)
    chain = deterministic_genesis(keys).chain_id
    txs = block_txs(keys, chain, seed=21, sends=3, pfbs=9, blob_shares=(1, 5))
    for raw in txs:
        assert jax_journal.tx_namespace_label(raw) == square_journal.tx_namespace_label(raw)
    assert square_journal.tx_namespace_label(b"\x00junk") is None
    for ns in (bytes(29), bytes(28) + b"\x01", b"\xff" * 29):
        assert jax_journal.namespace_label(ns) == square_journal.namespace_label(ns)
    monkeypatch.setenv("CELESTIA_NAMESPACE_TOP_N", "3")
    seq = ["f1", "tx", "f2", "other", "f3", "f4", "f1", "f5", "f2"]
    assert [jax_journal.capped_namespace_label(x) for x in seq] == \
        [square_journal.capped_namespace_label(x) for x in seq]
    jax_journal._reset_for_tests()
    square_journal._reset_for_tests()
    monkeypatch.setenv("CELESTIA_NAMESPACE_TOP_N", "20")

    def rows(tracer, name, n):
        drop = ("ts_ns", "node_id", "trace_id", "span_id", "parent_span_id", "duration_ms")
        return [{k: v for k, v in r.items() if k not in drop} for r in tracer.table(name)[-n:]]

    for step, max_size in enumerate((64, 8)):  # everything fits, then a square overflows
        got = [mod.build(txs, max_size) for mod in (jax_builder, builder)]
        assert [len(g[1]) for g in got][0] == len(got[1][1]) and got[0][1] == got[1][1]
        assert got[0][0].share_bytes() == got[1][0].share_bytes()
        sq = got[1][0]
        for mod in (jax_builder, builder):
            mod.construct(list(got[1][1]), max_size)
        assert rows(jax_traced(), "square_journal", 2) == rows(traced(), "square_journal", 2)
        for name in ("square_build", "square_construct"):
            assert rows(jax_traced(), name, 1) == rows(traced(), name, 1), name
        assert jax_journal.last_square() == square_journal.last_square()
        assert jax_journal.namespaces_payload() == square_journal.namespaces_payload()
        assert square_journal.last_square()["k"] == sq.size
    assert square_journal.namespaces_payload()["admitted"] >= 1


def test_e2e_namespace_label_on_tenant_phases_only():
    for observe, reg in ((jax_spans.observe_e2e, jax_registry), (spans.observe_e2e, registry)):
        hist = reg().histogram("celestia_e2e_seconds", "", buckets=spans.E2E_SECONDS_BUCKETS)
        base = hist.snapshot()
        for phase in ("submit", "mempool_wait", "total", "reap", "commit", "dispatch"):
            observe(phase, 0.01, namespace="e2e0")
        observe("submit", 0.02)
        delta = hist.snapshot().delta(base)
        keys = sorted(k for k, (counts, _) in delta.children.items() if sum(counts))
        assert keys == [
            (("namespace", "e2e0"), ("phase", "mempool_wait")),
            (("namespace", "e2e0"), ("phase", "submit")),
            (("namespace", "e2e0"), ("phase", "total")),
            (("phase", "commit"),), (("phase", "dispatch"),), (("phase", "reap"),),
            (("phase", "submit"),),
        ]


def test_slo_engine_state_equal(monkeypatch):
    monkeypatch.setenv("CELESTIA_SLO_FAST_S", "10")
    monkeypatch.setenv("CELESTIA_SLO_SLOW_S", "60")
    monkeypatch.setenv("CELESTIA_SLO_TICK_S", "2")
    fam, gauge = "celestia_parity_probe_seconds", "celestia_parity_probe_ratio"
    assert [dataclasses.astuple(s) for s in jax_slo.default_slos()] == \
        [dataclasses.astuple(s) for s in slo.default_slos()]
    engines, clocks = [], []
    for m in (jax_slo, slo):
        specs = (
            m.SLOSpec(name="probe_p90", metric=fam, labels=(("op", "x"),), quantile=0.9,
                      threshold=0.1, fast_burn=3.0, slow_burn=2.0),
            m.SLOSpec(name="probe_floor", metric=gauge, kind="gauge", op=">=", threshold=0.5,
                      budget=0.2, fast_burn=3.0, slow_burn=2.0),
            m.SLOSpec(name="missing", metric="celestia_parity_absent_seconds"),
        )
        clock, wall = Clock(50.0), Clock(1_700_000_000.0)
        engines.append(m.SLOEngine(specs, clock=clock, wall=wall))
        clocks.append((clock, wall))
    rng = np.random.default_rng(13)
    states = set()
    for step in range(40):
        dt = float(rng.choice([0.5, 1.0, 3.0, 7.0]))
        values = rng.exponential(0.05 if step < 20 else 0.4, size=int(rng.integers(0, 12)))
        level = float(rng.choice([0.2, 0.7, 0.9]))
        for reg in (jax_registry, registry):
            h = reg().histogram(fam, "probe", buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0))
            for v in values:
                h.observe(float(v), op="x")
            reg().gauge(gauge, "probe").set(level)
        for clock, wall in clocks:
            clock.t += dt
            wall.t += dt
        ran = [e.maybe_tick() for e in engines]
        assert ran[0] == ran[1]
        assert engines[0].payload() == engines[1].payload(), step
        assert engines[0].health_block() == engines[1].health_block()
        states.update(r["state"] for r in engines[1].payload()["slos"].values())
    assert {"ok", "fast_burn"} <= states
    assert engines[0].paged("probe_p90") == engines[1].paged("probe_p90")


def test_owner_registry_equal():
    # The pools' owners are registered when the mempool modules are imported;
    # a ledger reset by an earlier test file in this worker drops them.
    for ledger, mod in ((jax_ledger, jax_mempool), (device_ledger, mempool)):
        ledger.register_owner("mempool_shards", mod._pools_owned_bytes)
    before = [m.reconcile()["owners"].get("mempool_shards", 0) for m in (jax_ledger, device_ledger)]
    pools = [mod.PriorityMempool(shards=8) for mod in (jax_mempool, mempool)]
    for i in range(20):
        for pool in pools:
            pool.insert(tx_for(LABELS[i % 5], i, 50 + 13 * i), 1, 0, ns=LABELS[i % 5])
    after = [m.reconcile()["owners"]["mempool_shards"] for m in (jax_ledger, device_ledger)]
    assert after[0] - before[0] == after[1] - before[1] == pools[1].size_bytes()
    for m in (jax_ledger, device_ledger):
        m.note_owned_bytes("parity_probe", "a", 100)
        m.note_owned_bytes("parity_probe", "b", 40)
        m.note_owned_bytes("parity_probe", "a", 7)
        m.register_owner("parity_cb", lambda: 5)
        m.register_owner("parity_bad", lambda: 1 // 0)
    got = [m.reconcile()["owners"] for m in (jax_ledger, device_ledger)]
    for name in ("parity_probe", "parity_cb", "parity_bad"):
        assert got[0][name] == got[1][name]
    assert got[1]["parity_probe"] == 47 and got[1]["parity_bad"] == 0
    rec = device_ledger.reconcile()
    assert rec["owned_bytes"] == sum(rec["owners"].values())
    for m in (jax_ledger, device_ledger):
        m.forget_owned_bytes("parity_probe", "a")
        assert m.reconcile()["owners"]["parity_probe"] == 40
        m.forget_owned_bytes("parity_probe")
        m.unregister_owner("parity_cb")
        m.unregister_owner("parity_bad")
        owners = m.reconcile()["owners"]
        assert "parity_probe" not in owners and "parity_cb" not in owners
