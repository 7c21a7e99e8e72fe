"""The port's degradation ladder (celestia_app_tpu_torch/chaos/degrade.py)
held against the JAX package's, decision by decision, and the extend path
under it.

Each scenario runs once against each package's breaker, ladder and
`guarded_dispatch` on the same scripted failures or the same chaos spec and
seed: the modes tried, the `celestia_recoveries_total` deltas, the final
`degraded_state` and the error raised must agree exactly.  Then
`ExtendedDataSquare.compute` at k=4 on every rung of the ladder (forced
through the ladder itself) and under `dispatch_fail` specs gives data roots,
row and column roots byte-equal to the JAX `compute`, and the journal names
the same rung.  Bytes are compared exactly; there is no tolerance.
"""

from __future__ import annotations

import gc

import jax
import numpy as np
import pytest

from celestia_app_tpu import chaos as jax_chaos
from celestia_app_tpu.chaos import degrade as jax_degrade
from celestia_app_tpu.da.eds import ExtendedDataSquare as JaxEDS
from celestia_app_tpu.trace.metrics import registry as jax_registry
from celestia_app_tpu.trace.tracer import traced as jax_traced
from celestia_app_tpu_torch import chaos as port_chaos
from celestia_app_tpu_torch.chaos import degrade as port_degrade
from celestia_app_tpu_torch.constants import SHARE_SIZE
from celestia_app_tpu_torch.da import ExtendedDataSquare
from celestia_app_tpu_torch.trace import journal
from celestia_app_tpu_torch.trace.metrics import registry as port_registry

PACKAGES = {
    "jax": (jax_chaos, jax_degrade, jax_registry),
    "port": (port_chaos, port_degrade, port_registry),
}


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran (each loaded
    XLA:CPU executable holds many memory mappings)."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _clean_ladders():
    for chaos, degrade, _ in PACKAGES.values():
        chaos.uninstall()
        degrade.reset_for_tests()
    yield
    for chaos, degrade, _ in PACKAGES.values():
        chaos.uninstall()
        degrade.reset_for_tests()


def _recoveries(registry) -> dict:
    fam = registry().get("celestia_recoveries_total")
    if fam is None:
        return {}
    return {(k["seam"], k["outcome"]): v for k, v in fam.samples()}


def _run(pkg: str, scenario):
    """(scenario's own result, recoveries delta, degraded_state) of running
    `scenario(chaos, degrade)` against one package."""
    chaos, degrade, registry = PACKAGES[pkg]
    before = _recoveries(registry)
    result = scenario(chaos, degrade)
    after = _recoveries(registry)
    delta = {key: after[key] - before.get(key, 0.0) for key in after
             if after[key] != before.get(key, 0.0)}
    return result, delta, degrade.degraded_state()


def _both(scenario):
    got = {pkg: _run(pkg, scenario) for pkg in PACKAGES}
    assert got["port"] == got["jax"]
    return got["port"]


def _no_sleep(_s):
    return None


def _scripted(failures: int | None):
    """A guarded_dispatch scenario: resolve records each mode it is asked
    for, and the dispatch fails its first `failures` calls (None: always)."""

    def scenario(chaos, degrade):
        tried, calls = [], [0]

        def resolve(mode):
            tried.append(mode)

            def run(x):
                calls[0] += 1
                if failures is None or calls[0] <= failures:
                    raise RuntimeError(f"scripted fault {calls[0]}")
                return x + 1
            return run

        try:
            mode, out = degrade.guarded_dispatch(resolve, 41, sleep=_no_sleep)
            return tried, ("ok", mode, out)
        except RuntimeError as e:
            return tried, ("raised", str(e))

    return scenario


@pytest.mark.parametrize("failures", [0, 1, 2, 3, 5, 8, None])
def test_guarded_dispatch_decisions_equal_jax(failures, monkeypatch):
    """Retries within a rung, breaker trips down fused -> staged -> host,
    the raise past the floor: the same modes tried, counts and state."""
    monkeypatch.delenv("CELESTIA_PIPE_FUSED", raising=False)
    (tried, outcome), delta, state = _both(_scripted(failures))
    if failures is None:
        assert tried == ["fused"] * 3 + ["staged"] * 3 + ["host"] * 3
        assert outcome == ("raised", "scripted fault 9") and state == {"device": "host"}
        assert delta == {("device.dispatch", "degraded"): 2.0}
    elif failures == 0:
        assert outcome == ("ok", "fused", 42) and delta == {} and state is None
    elif failures == 2:
        assert outcome == ("ok", "fused", 42) and state is None
        assert delta == {("device.dispatch", "retried"): 1.0}


@pytest.mark.parametrize("base", ["epi", "off", "on"])
def test_floor_exhaustion_then_prompt_raise_equals_jax(base, monkeypatch):
    """A dead device walks the ladder from the env base; the next call
    raises after one attempt (the breaker stays at its threshold)."""
    monkeypatch.setenv("CELESTIA_PIPE_FUSED", base)

    def scenario(chaos, degrade):
        breaker = degrade.CircuitBreaker(threshold=2)
        seen = []
        for _ in range(2):
            calls = [0]

            def resolve(mode):
                def run(_x):
                    calls[0] += 1
                    raise RuntimeError("dead device")
                return run
            try:
                degrade.guarded_dispatch(resolve, None, breaker=breaker, sleep=_no_sleep)
            except RuntimeError:
                seen.append(calls[0])
        return seen

    seen, delta, state = _both(scenario)
    assert state == {"device": "host"} and seen[1] == 1


def test_attempt_cap_ends_a_call_whose_streak_others_reset():
    """Each failure of this call is followed by another caller's success
    (which zeroes the shared streak), so the breaker never trips: the call
    still ends, after threshold * 2 * len(LADDER) attempts."""

    def scenario(chaos, degrade):
        breaker = degrade.CircuitBreaker(threshold=3)
        calls = [0]

        def resolve(mode):
            def run(_x):
                calls[0] += 1
                breaker.record_success()  # a concurrent caller succeeded
                raise RuntimeError("this caller's dispatch")
            return run
        try:
            degrade.guarded_dispatch(resolve, None, breaker=breaker, sleep=_no_sleep)
        except RuntimeError:
            return calls[0]

    attempts, delta, state = _both(scenario)
    assert attempts == 3 * 2 * len(port_degrade.LADDER) and state is None


@pytest.mark.parametrize("spec", ["seed=5,dispatch_fail=0.5", "seed=9,dispatch_fail=0.7",
                                  "seed=2,dispatch_fail=0.3,dispatch_fail_all=1"])
def test_chaos_spec_decisions_equal_jax(spec, monkeypatch):
    """The same spec and seed: the same rung for each of 24 dispatches."""
    monkeypatch.setenv("CELESTIA_PIPE_FUSED", "epi")

    def scenario(chaos, degrade):
        chaos.install(spec)
        modes = []
        for _ in range(24):
            try:
                modes.append(degrade.guarded_dispatch(lambda m: (lambda x: x), 0,
                                                      sleep=_no_sleep)[0])
            except Exception as e:  # the floor exhausted under dispatch_fail_all
                modes.append(type(e).__name__)
        return modes

    modes, delta, state = _both(scenario)
    assert len(set(modes)) > 1  # the spec moved the ladder


@pytest.mark.parametrize("env", [{"CELESTIA_PIPE_PANEL": "2"},
                                 {"CELESTIA_PIPE_PANEL": "2", "CELESTIA_EXTEND_SHARDS": "2"},
                                 {"CELESTIA_PIPE_PANEL": "2", "CELESTIA_PIPE_FUSED": "epi"}])
def test_per_k_seat_and_panel_landing_equal_jax(env, monkeypatch):
    """Routed per square size (k=4): a faulting panel or sharded step steps
    to the panel rung and from panel to the materializing base, never to a
    colder in-between rung; k=1 (below the mesh) takes the single-card panel."""
    for key, val in env.items():
        monkeypatch.setenv(key, val)

    def scenario(chaos, degrade):
        out = []
        for k in (4, 1, 4, 4):
            tried = []

            def resolve(mode):
                tried.append(mode)

                def run(x):
                    if mode in ("sharded_panel", "panel"):
                        raise RuntimeError(f"{mode} fault")
                    return x
                return run
            kwargs = {"k": k}
            if degrade is port_degrade:
                kwargs["device"] = "cpu"  # the CPU shards stand in for the cards
            out.append((tried, degrade.guarded_dispatch(resolve, 0, sleep=_no_sleep, **kwargs)[0]))
        return out

    got, delta, state = _both(scenario)
    assert got[0][1] == ("fused_epi" if env.get("CELESTIA_PIPE_FUSED") == "epi" else "fused")


def test_ladder_steps_and_concurrent_trips_equal_jax():
    def scenario(chaos, degrade):
        ladder = degrade.DeviceDegradation()
        steps = [ladder.effective_mode("fused_epi"),
                 ladder.degrade("fused_epi", observed="fused_epi"),
                 ladder.degrade("fused_epi", observed="fused_epi"),  # a concurrent trip
                 ladder.degrade("fused_epi", observed="fused"),
                 ladder.effective_mode("fused"), ladder.state(),
                 ladder.degrade("staged"), ladder.degrade("staged")]
        ladder.reset()
        steps += [ladder.effective_mode("fused"), ladder.state(), ladder.degrade("panel"),
                  ladder.degrade("panel")]
        return steps

    steps, delta, state = _both(scenario)
    assert steps[:4] == ["fused_epi", "fused", "fused", "staged"]
    assert steps[-2:] == ["fused", "staged"]  # panel lands on the materializing base


def test_deferred_failures_and_gauge_equal_jax():
    def scenario(chaos, degrade):
        out = []
        for _ in range(degrade.DEVICE_BREAKER.threshold):  # a stale rung: one step only
            degrade.note_async_device_failure("fused")
        out.append(degrade.degraded_state())
        for _ in range(3 * degrade.DEVICE_BREAKER.threshold + 1):
            degrade.note_async_device_failure(degrade.effective_device_mode("fused"))
            out.append(degrade.degraded_state())
        return out

    states, delta, state = _both(scenario)
    assert state == {"device": "host"}
    gauge = {tuple(sorted(k.items())): v
             for k, v in port_registry().get("celestia_degraded").samples()}
    assert gauge[(("layer", "device"), ("mode", "host"))] == 1.0
    assert sum(gauge.values()) == 1.0


def test_breaker_threshold_env_equals_jax(monkeypatch):
    monkeypatch.setenv("CELESTIA_BREAKER_THRESHOLD", "5")
    assert port_degrade.CircuitBreaker().threshold == jax_degrade.CircuitBreaker().threshold == 5
    monkeypatch.setenv("CELESTIA_BREAKER_THRESHOLD", "zap")
    assert port_degrade.CircuitBreaker().threshold == port_degrade.DEFAULT_THRESHOLD == 3
    assert port_degrade.LADDER == jax_degrade.LADDER
    assert (port_degrade.BACKOFF_BASE_S, port_degrade.BACKOFF_CAP_S) == \
        (jax_degrade.BACKOFF_BASE_S, jax_degrade.BACKOFF_CAP_S)


# --- the extend path on every rung ------------------------------------------------


def _ods(k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, (k, k, SHARE_SIZE), dtype=np.uint8)
    ods[..., :29] = 0
    ods[..., 28] = np.sort(rng.integers(0, 256, k * k)).reshape(k, k).astype(np.uint8)
    return ods


def _roots(eds) -> tuple:
    return (bytes(eds.data_root()), tuple(map(bytes, eds.row_roots())),
            tuple(map(bytes, eds.col_roots())))


def _jax_mode() -> str:
    return jax_traced().table("block_journal")[-1]["mode"]


@pytest.fixture(scope="module")
def square():
    ods = _ods(4, seed=140)
    return ods, _roots(JaxEDS.compute(ods))


@pytest.mark.parametrize("steps", [0, 1, 2, 3])
def test_compute_on_each_rung_equals_jax(square, steps, monkeypatch):
    """Seated on fused_epi and stepped down the ladder `steps` times: the
    port and the JAX compute run the same rung and give the same bytes."""
    monkeypatch.setenv("CELESTIA_PIPE_FUSED", "epi")
    ods, want = square
    for degrade in (jax_degrade, port_degrade):
        for _ in range(steps):
            degrade.DEVICE_DEGRADATION.degrade(degrade._env_base_mode())
    rung = port_degrade.LADDER[2 + steps]
    got = ExtendedDataSquare.compute(ods, device="cpu")
    assert journal.rows("compute")[-1]["mode"] == rung
    assert _roots(got) == want
    assert _roots(JaxEDS.compute(ods)) == want and _jax_mode() == rung
    assert port_degrade.degraded_state() == jax_degrade.degraded_state()


@pytest.mark.parametrize("spec", ["seed=3,dispatch_fail=1.0",
                                  "seed=7,dispatch_fail=0.6,dispatch_fail_all=1"])
def test_compute_under_dispatch_fail_equals_jax(square, spec, monkeypatch):
    """Under the same chaos spec each compute of a run of six lands on the
    same rung in both packages, with the same bytes, or both raise past
    the floor."""
    monkeypatch.setenv("CELESTIA_PIPE_FUSED", "epi")
    ods, want = square
    outcomes = {}
    for pkg, run, mode_of in (
            ("jax", lambda: JaxEDS.compute(ods), _jax_mode),
            ("port", lambda: ExtendedDataSquare.compute(ods, device="cpu"),
             lambda: journal.rows("compute")[-1]["mode"])):
        chaos, degrade, _ = PACKAGES[pkg]
        chaos.install(spec)
        seq = []
        for _ in range(6):
            try:
                eds = run()
            except chaos.ChaosInjected:
                seq.append(("raised", degrade.degraded_state()))
            else:
                assert _roots(eds) == want
                seq.append((mode_of(), degrade.degraded_state()))
        chaos.uninstall()
        outcomes[pkg] = seq
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][-1][1] is not None  # the ladder moved


def test_pipeline_mode_consults_the_ladder(monkeypatch):
    from celestia_app_tpu.kernels import fused as jax_fused
    from celestia_app_tpu_torch.kernels import fused

    monkeypatch.setenv("CELESTIA_PIPE_FUSED", "epi")
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "2")
    for degrade in (jax_degrade, port_degrade):
        degrade.DEVICE_DEGRADATION.degrade("fused_epi")
    assert fused.pipeline_mode() == jax_fused.pipeline_mode() == "fused"
    # The floor sits below the panel rung, so a panel seat degrades too.
    assert fused.pipeline_mode_for_k(4, "cpu") == jax_fused.pipeline_mode_for_k(4) == "fused"
    assert fused.env_base_mode() == "fused_epi"
    assert fused.env_base_mode_for_k(4, "cpu") == jax_fused.env_base_mode_for_k(4) == "panel"
