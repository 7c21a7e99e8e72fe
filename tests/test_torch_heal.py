"""The port's healing loop (serve/heal.py), held against the JAX package: a
JAX and a port HealingEngine over the same k=4 square under the same
adversary give the same outcomes, attempts, `state()` (times masked), heal
trace rows, flight triggers and counters: healed (withheld and malformed),
irrecoverable, and quarantined by a committed DAH that cannot match.  Also
the survivor gather on the port's device path against the JAX one, the
retryable mid-heal status, `readmit` coalescing, and the port's own rule: a
device fault past the ladder's floor is not a quarantine.
"""

from __future__ import annotations

import gc
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from celestia_app_tpu import chaos as jax_chaos
from celestia_app_tpu.chaos import degrade as jax_degrade
from celestia_app_tpu.da.dah import DataAvailabilityHeader as JaxDAH
from celestia_app_tpu.da.eds import ExtendedDataSquare as JaxEDS
from celestia_app_tpu.serve import api as jax_api
from celestia_app_tpu.serve import heal as jax_heal
from celestia_app_tpu.serve.cache import ForestCache as JaxForestCache
from celestia_app_tpu.serve.sampler import BadProofDetected as JaxBadProof
from celestia_app_tpu.serve.sampler import ShareWithheld as JaxWithheld
from celestia_app_tpu.trace import flight_recorder as jax_flight
from celestia_app_tpu.trace.metrics import registry as jax_registry
from celestia_app_tpu.trace.tracer import traced as jax_traced
from celestia_app_tpu_torch import chaos
from celestia_app_tpu_torch.chaos import degrade
from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, SHARE_SIZE
from celestia_app_tpu_torch.da import extend_shares
from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader
from celestia_app_tpu_torch.device import DeviceFault
from celestia_app_tpu_torch.kernels.fused import pipeline_mode
from celestia_app_tpu_torch.serve import api, heal
from celestia_app_tpu_torch.serve.cache import ForestCache
from celestia_app_tpu_torch.serve.heal import HealingEngine, HealingInProgress
from celestia_app_tpu_torch.serve.sampler import BadProofDetected, ShareWithheld
from celestia_app_tpu_torch.trace import flight_recorder
from celestia_app_tpu_torch.trace.metrics import registry
from celestia_app_tpu_torch.trace.tracer import traced

K = 4


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran, when it ends
    (each loaded XLA:CPU executable holds many memory mappings)."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _clean_state():
    for mod in (heal, jax_heal):
        mod._reset_for_tests()
    for mod in (api, jax_api):
        mod._reset_coverage_for_tests()
    yield
    for c in (chaos, jax_chaos):
        c.uninstall()
    for d in (degrade, jax_degrade):
        d.reset_for_tests()
    for mod in (heal, jax_heal):
        mod._reset_for_tests()


def det_ods(k: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ns = np.sort(rng.integers(0, 128, k * k).astype(np.uint8))
    ods = rng.integers(0, 256, (k * k, SHARE_SIZE), dtype=np.uint8)
    ods[:, :NAMESPACE_SIZE] = 0
    ods[:, NAMESPACE_SIZE - 1] = ns
    return ods


_EDS: dict = {}


def squares(seed: int = 1):
    """(port EDS, JAX EDS) of the same square, cached."""
    if seed not in _EDS:
        eds = extend_shares([s.tobytes() for s in det_ods(K, seed)], device="cpu")
        _EDS[seed] = (eds, JaxEDS(jnp.asarray(eds.squared()), eds.row_roots(), eds.col_roots(),
                                  eds.data_root(), K))
    return _EDS[seed]


def providers(height: int = 1, seed: int = 1):
    """Fresh (port, JAX) DasProviders holding the same square at `height`."""
    eds, jax_eds = squares(seed)
    port = api.DasProvider(cache=ForestCache(heights=2, spill=2, device="cpu"))
    theirs = jax_api.DasProvider(cache=JaxForestCache(heights=2, spill=2))
    port.cache.put(height, eds)
    theirs.cache.put(height, jax_eds)
    return port, theirs


def install(spec: str) -> None:
    chaos.install(spec)
    jax_chaos.install(spec)


TIMES = ("ts_ns", "node_id", "total_ms", "t0", "t0_ns")


def masked(obj):
    """`obj` with every time field's value (and each phase's ms) masked."""
    if isinstance(obj, dict):
        return {k: ("<t>" if k in TIMES else
                    {p: "<t>" for p in v} if k == "phases_ms" and isinstance(v, dict)
                    else masked(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [masked(v) for v in obj]
    return obj


def _counter(reg, name: str, **labels) -> float:
    fam = reg().get(name)
    if fam is None:
        return 0.0
    return sum(v for key, v in fam.samples() if all(key.get(a) == b for a, b in labels.items()))


class Triggers:
    """Records each package's heal / detection flight triggers."""

    def __init__(self, monkeypatch):
        self.seen = {"port": [], "jax": []}
        for name, mod in (("port", flight_recorder), ("jax", jax_flight)):
            monkeypatch.setattr(mod, "note_trigger",
                                lambda trigger, _n=name, **ctx: self.seen[_n].append(
                                    (trigger, masked(ctx))))


def detect(port, theirs, coord, withheld: bool):
    """Sample `coord` on both providers; each must refuse it."""
    for p, exc in ((port, ShareWithheld if withheld else BadProofDetected),
                   (theirs, JaxWithheld if withheld else JaxBadProof)):
        with pytest.raises(exc):
            p.share_proof_payload(1, *coord)


def run_both(port, theirs, engines, monkeypatch):
    """Drain both engines; returns what each package recorded."""
    out = {}
    for name, eng, tracer, reg in (("port", engines[0], traced, registry),
                                   ("jax", engines[1], jax_traced, jax_registry)):
        before = {o: _counter(reg, "celestia_heal_total", outcome=o) for o in heal.HEAL_OUTCOMES}
        result = eng.process_pending()
        after = {o: _counter(reg, "celestia_heal_total", outcome=o) - before[o]
                 for o in heal.HEAL_OUTCOMES}
        out[name] = (result, masked(eng.state()), masked(tracer().tail("heal", 1)), after)
    assert out["port"] == out["jax"]
    return out["port"]


@pytest.mark.parametrize("spec,withheld", [("seed=31,withhold_frac=0.25", True),
                                           ("seed=13,malform_shares=2", False),
                                           ("seed=13,wrong_root=1", False)])
def test_healed_equals_jax(spec, withheld, monkeypatch):
    port, theirs = providers()
    engines = (HealingEngine(port, name="h"), jax_heal.HealingEngine(theirs, name="h"))
    triggers = Triggers(monkeypatch)
    install(spec)
    adv = chaos.active_adversary()
    coord = (sorted(adv.withheld_set(1, 2 * K))[0] if withheld
             else (adv.malformed_coords(1, 2 * K) or [(0, 0)])[0])
    detect(port, theirs, coord, withheld)
    for p, exc in ((port, HealingInProgress), (theirs, jax_heal.HealingInProgress)):
        with pytest.raises(exc):
            p.entry(1)
    result, state, rows, counts = run_both(port, theirs, engines, monkeypatch)
    assert result == [(1, "healed")] and counts["healed"] == 1
    assert state["healed"] == 1 and rows[0]["outcome"] == "healed"
    assert triggers.seen["port"] == triggers.seen["jax"]
    assert any(t == "heal_completed" for t, _ in triggers.seen["port"])
    # The refused coordinate now serves from the healed entry, equal to the
    # JAX bytes and to the honest square's proof.
    got = api.render(port.share_proof_payload(1, *coord))
    assert got == jax_api.render(theirs.share_proof_payload(1, *coord))
    assert port.entry(1).healed and port.entry(1).data_root == squares()[0].data_root()
    chaos.uninstall()
    clean = api.DasProvider(cache=ForestCache(heights=1, spill=1, device="cpu"))
    clean.cache.put(1, squares()[0])
    assert got == api.render(clean.share_proof_payload(1, *coord))
    for eng in engines:
        eng.close()
    assert heal.engines() == () and port.healer is None


def test_irrecoverable_is_terminal_like_jax(monkeypatch):
    port, theirs = providers()
    engines = (HealingEngine(port, name="i"), jax_heal.HealingEngine(theirs, name="i"))
    triggers = Triggers(monkeypatch)
    install("seed=7,withhold_frac=0.95")
    detect(port, theirs, (0, 0), True)
    result, state, _rows, counts = run_both(port, theirs, engines, monkeypatch)
    assert result == [(1, "irrecoverable")] and counts["irrecoverable"] == 1
    assert state["quarantined"]["1"]["outcome"] == "irrecoverable"
    assert triggers.seen["port"] == triggers.seen["jax"]
    # Terminal: the next detection enqueues nothing.
    detect(port, theirs, (0, 0), True)
    assert engines[0].process_pending() == engines[1].process_pending() == []
    assert masked(heal.heal_payload()) == masked(jax_heal.heal_payload())
    assert masked(heal.heal_health_block()) == masked(jax_heal.heal_health_block())


def test_unmatchable_committed_dah_quarantines_like_jax(monkeypatch):
    port, theirs = providers()
    eds = squares(seed=2)[0]  # another square's DAH: no heal can reproduce it
    engines = (
        HealingEngine(port, name="q", backoff_s=0.0,
                      committed_dah=lambda h: DataAvailabilityHeader.from_eds(eds)),
        jax_heal.HealingEngine(theirs, name="q", backoff_s=0.0,
                               committed_dah=lambda h: JaxDAH(row_roots=eds.row_roots(),
                                                              column_roots=eds.col_roots())),
    )
    triggers = Triggers(monkeypatch)
    install("seed=31,withhold_frac=0.25")
    detect(port, theirs, sorted(chaos.active_adversary().withheld_set(1, 2 * K))[0], True)
    result, state, rows, counts = run_both(port, theirs, engines, monkeypatch)
    assert result == [(1, "quarantined")] and counts["quarantined"] == 1
    assert state["quarantined"]["1"]["attempts"] == 3
    assert "RootMismatch" in state["quarantined"]["1"]["detail"]
    assert triggers.seen["port"] == triggers.seen["jax"]


def test_survivor_gather_equals_jax():
    port, theirs = providers()
    install("seed=13,malform_shares=3,withhold_frac=0.1")
    got_shares, got_present = heal.default_survivors(1, port.serve_view(1),
                                                     port._honest_entry(1))
    want_shares, want_present = jax_heal.default_survivors(1, theirs.serve_view(1),
                                                           theirs._honest_entry(1))
    assert np.array_equal(got_present, want_present)
    assert np.array_equal(got_shares.numpy()[got_present], want_shares[want_present])
    adv = chaos.active_adversary()
    for coord in list(adv.malformed_coords(1, 2 * K)) + list(adv.withheld_set(1, 2 * K)):
        assert not got_present[coord]


def test_readmit_coalesces_and_drops_the_tamper_view():
    port, _ = providers()
    eds = squares()[0]
    install("seed=13,malform_shares=2")
    tampered = port.entry(1)
    assert port.entry(1) is tampered
    entry = port._honest_entry(1)
    builds = []
    real = port.cache._build
    port.cache._build = lambda h, e: builds.append(h) or real(h, e)
    again = port.cache.readmit(1, eds, healed=True)
    assert again is entry and again.healed and builds == []  # same root: kept
    assert port.entry(1) is entry  # healed: served without the adversary
    other = squares(seed=2)[0]
    replaced = port.cache.readmit(1, other, healed=True)
    assert replaced is not entry and builds == [1]
    rows = [r for r in traced().tail("forest_cache", 2) if r["event"] == "readmit"]
    assert rows and rows[-1]["height"] == 1


def test_a_device_fault_is_not_a_quarantine(capsys):
    port, _ = providers()
    engine = HealingEngine(port, name="d")
    before = {o: _counter(registry, "celestia_heal_total", outcome=o) for o in heal.HEAL_OUTCOMES}
    chaos.install("seed=31,withhold_frac=0.25,dispatch_fail=1.0,dispatch_fail_all=1")
    coord = sorted(chaos.active_adversary().withheld_set(1, 2 * K))[0]
    with pytest.raises(ShareWithheld):
        port.share_proof_payload(1, *coord)
    with pytest.raises(DeviceFault):
        engine.process_pending()
    state = engine.state()
    assert state["healing"] == [] and state["quarantined_total"] == 0
    assert state["healed"] == 0 and state["last"] is None
    assert {o: _counter(registry, "celestia_heal_total", outcome=o)
            for o in heal.HEAL_OUTCOMES} == before
    assert pipeline_mode() == "host"  # the repair walked the whole ladder
    # A later detection enqueues the height again; the worker thread prints
    # the fault and carries on.
    engine.start()
    with pytest.raises(ShareWithheld):
        port.share_proof_payload(1, *coord)
    deadline = time.perf_counter() + 60
    while engine.healing(1) and time.perf_counter() < deadline:
        time.sleep(0.01)
    assert not engine.healing(1) and not engine.is_quarantined(1)
    assert "heal of height 1 on d" in capsys.readouterr().err
    # The card back: the next detection heals the height.
    degrade.reset_for_tests()
    chaos.install("seed=31,withhold_frac=0.25")
    with pytest.raises(ShareWithheld):
        port.share_proof_payload(1, *coord)
    deadline = time.perf_counter() + 60
    while engine.healing(1) and time.perf_counter() < deadline:
        time.sleep(0.01)
    assert engine.state()["healed"] == 1
    engine.close()


def test_dispatch_fail_mid_repair_walks_the_ladder_and_heals():
    port, _ = providers()
    engine = HealingEngine(port, name="l")
    chaos.install("seed=31,withhold_frac=0.25,dispatch_fail=1.0")
    coord = sorted(chaos.active_adversary().withheld_set(1, 2 * K))[0]
    with pytest.raises(ShareWithheld):
        port.share_proof_payload(1, *coord)
    assert engine.process_pending() == [(1, "healed")]
    assert pipeline_mode() in ("staged", "host")
    assert port.share_proof_payload(1, *coord)["data_root"] == squares()[0].data_root().hex()
    engine.close()


def test_note_detection_routes_to_the_owner_only():
    port, _ = providers()
    other, _ = providers(height=2)
    engine = HealingEngine(port, name="o")
    heal.note_detection("root_mismatch", 1)
    assert engine.healing(1)
    heal.note_detection("root_mismatch", 1)  # already mid-heal
    assert list(engine._queue) == [1]
    heal.note_detection("root_mismatch", 2)  # another cache's height
    assert not engine.healing(2)
    assert not engine.note("withheld", 1, entry=other.entry(2))
    heal.note_detection("withheld", None)
    engine.close()
