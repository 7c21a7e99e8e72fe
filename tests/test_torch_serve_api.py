"""The port's DAS serving plane (serve/api.py over serve/{cache,sampler,
verify}.py), held against the JAX package: one square at k=4, 8, 16 in a
JAX DasProvider and in a port one (device="cpu") gives the same `render()`
bytes for share proofs on both axes, namespace shares (found and not
found) and attestations; each attestation reconstructs through the port's
codec to the sampler's proofs; the coverage maps, the QoS refusals,
UnknownHeight and the withheld / tampered refusals are the JAX package's;
under `proof_fail` / `verify_fail` the port retries on the card (here the
CPU) and gives the same bytes, or raises DeviceFault past the threshold.
"""

from __future__ import annotations

import gc
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from celestia_app_tpu import chaos as jax_chaos
from celestia_app_tpu import qos as jax_qos
from celestia_app_tpu.chaos import degrade as jax_degrade
from celestia_app_tpu.da.eds import ExtendedDataSquare as JaxEDS
from celestia_app_tpu.serve import api as jax_api
from celestia_app_tpu.serve import heal as jax_heal
from celestia_app_tpu.serve.cache import ForestCache as JaxForestCache
from celestia_app_tpu.serve.sampler import BadProofDetected as JaxBadProof
from celestia_app_tpu.serve.sampler import ShareWithheld as JaxWithheld
from celestia_app_tpu.trace import square_journal as jax_square_journal
from celestia_app_tpu_torch import chaos, qos
from celestia_app_tpu_torch.chaos import degrade
from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, SHARE_SIZE
from celestia_app_tpu_torch.da import extend_shares
from celestia_app_tpu_torch.device import DeviceFault
from celestia_app_tpu_torch.rpc.codec import share_proofs_from_attestation
from celestia_app_tpu_torch.serve import api, heal
from celestia_app_tpu_torch.serve.cache import ForestCache
from celestia_app_tpu_torch.serve.sampler import BadProofDetected, ShareWithheld
from celestia_app_tpu_torch.trace import square_journal
from celestia_app_tpu_torch.trace.metrics import registry

KS = (4, 8, 16)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran, when it ends
    (each loaded XLA:CPU executable holds many memory mappings)."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _clean_state():
    """The coverage maps, the heal registry, QoS, chaos, the ladder and the
    namespace label cap are process-wide, in both packages."""
    for mod in (api, jax_api):
        mod._reset_coverage_for_tests()
    for mod in (heal, jax_heal, square_journal, jax_square_journal):
        mod._reset_for_tests()
    yield
    for c in (chaos, jax_chaos):
        c.uninstall()
    for q in (qos, jax_qos):
        q.uninstall()
    for d in (degrade, jax_degrade):
        d.reset_for_tests()
    for mod in (heal, jax_heal, square_journal, jax_square_journal):
        mod._reset_for_tests()


def det_ods(k: int, seed: int) -> np.ndarray:
    """An ODS whose namespaces come in runs across row boundaries."""
    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, (k * k, SHARE_SIZE), dtype=np.uint8)
    ods[:, :NAMESPACE_SIZE] = 0
    ods[:, NAMESPACE_SIZE - 1] = 1 + (np.arange(k * k) + k // 2) // max(k // 2, 1)
    return ods


_PROVIDERS: dict = {}


def providers(k: int):
    """(port DasProvider, JAX DasProvider) holding the same square at
    height 1, cached per k (the JAX forest compiles once per k)."""
    if k not in _PROVIDERS:
        eds = extend_shares([s.tobytes() for s in det_ods(k, seed=k)], device="cpu")
        jax_eds = JaxEDS(jnp.asarray(eds.squared()), eds.row_roots(), eds.col_roots(),
                         eds.data_root(), k)
        port = api.DasProvider(cache=ForestCache(heights=2, spill=2, device="cpu"))
        theirs = jax_api.DasProvider(cache=JaxForestCache(heights=2, spill=2))
        port.cache.put(1, eds)
        theirs.cache.put(1, jax_eds)
        _PROVIDERS[k] = (port, theirs)
    return _PROVIDERS[k]


def coords(k: int) -> list[tuple[int, int]]:
    n = 2 * k
    return sorted({(0, 0), (k - 1, k - 1), (0, n - 1), (k - 1, k), (n - 1, 0), (k, k - 1),
                   (n - 1, n - 1), (k, k), (k // 2, n - 2), (n - 2, k // 2)})


def both(call):
    """call(provider) on both packages: (port render, JAX render)."""
    port, theirs = providers(call.k)
    return api.render(call(port)), jax_api.render(call(theirs))


def _call(k, fn):
    fn.k = k
    return fn


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("axis", ["row", "col"])
def test_share_proof_payloads_equal_jax(k, axis):
    for r, c in coords(k):
        got, want = both(_call(k, lambda p: p.share_proof_payload(1, r, c, axis=axis)))
        assert got == want, (r, c, axis)
    assert api.coverage_snapshot() == jax_api.coverage_snapshot()
    assert api.coverage_response({"height": "1"}) == jax_api.coverage_response({"height": "1"})


@pytest.mark.parametrize("k", KS)
def test_shares_payloads_equal_jax(k):
    values = sorted(set(det_ods(k, seed=k)[:, NAMESPACE_SIZE - 1].tolist()))
    for v in values[:3] + [0, 250]:  # found, and absent below / above
        namespace = (bytes(NAMESPACE_SIZE - 1) + bytes([v])).hex()
        got, want = both(_call(k, lambda p: p.shares_payload(1, namespace)))
        assert got == want, v
    for bad in ("zz", "00" * 3):
        with pytest.raises(ValueError):
            providers(k)[0].shares_payload(1, bad)
    for q in ({}, {"height": "1"}, {"height": "2"}, {"height": "x"}):
        assert api.coverage_response(q) == jax_api.coverage_response(q)


@pytest.mark.parametrize("k", KS)
def test_attestation_payloads_equal_jax_and_reconstruct(k):
    n = 2 * k
    rng = random.Random(k)
    samples = {(rng.randrange(n), rng.randrange(n), rng.choice(("row", "col")))
               for _ in range(12)}
    spec = ",".join(f"{r}:{c}:{a}" if a == "col" or rng.random() < 0.5 else f"{r}:{c}"
                    for r, c, a in sorted(samples))
    got, want = both(_call(k, lambda p: p.attestation_payload(1, spec)))
    assert got == want
    port = providers(k)[0]
    payload = port.attestation_payload(1, spec)
    rebuilt = share_proofs_from_attestation(payload)
    entry = port.entry(1)
    for s, proof in zip(payload["samples"], rebuilt):
        direct = port.sampler.sample_batch(entry, [(s["row"], s["col"])], axis=s["axis"])[0]
        assert proof == direct
        assert proof.verify(entry.data_root)
    assert api.parse_attestation_samples(spec) == jax_api.parse_attestation_samples(spec)
    for bad in ("", "1", "1:2:diag", "-1:0", "a:b"):
        with pytest.raises(ValueError):
            api.parse_attestation_samples(bad)
    with pytest.raises(ValueError):
        port.attestation_payload(1, f"{n}:0")
    assert api.coverage_snapshot() == jax_api.coverage_snapshot()


def test_unknown_height_and_the_coverage_map_render():
    port, theirs = providers(4)
    for p, exc in ((port, api.UnknownHeight), (theirs, jax_api.UnknownHeight)):
        with pytest.raises(exc):
            p.share_proof_payload(99, 0, 0)
    for h, cells in ((3, [(0, 0), (1, 1)]), (3, [(1, 1)]), (4, [(7, 7)])):
        for state in ("sampled", "verified", "withheld", "tampered"):
            api.coverage_tick(h, 4, cells, state)
            jax_api.coverage_tick(h, 4, cells, state)
    api.coverage_tick(5, 64, [(0, 0)], "sampled")  # above the inline map edge
    jax_api.coverage_tick(5, 64, [(0, 0)], "sampled")
    for q in ({}, {"height": "3"}, {"height": "5"}):
        assert api.coverage_response(q) == jax_api.coverage_response(q)


def _qos_outcomes(provider, throttled_exc, body, requests):
    out = []
    for kind, args in requests:
        try:
            if kind == "proof":
                provider.share_proof_payload(1, *args)
            else:
                provider.shares_payload(1, args)
            out.append("ok")
        except throttled_exc as e:
            out.append(body(e))
    return out


def test_qos_refusals_equal_jax():
    for q in (qos, jax_qos):  # one fixed clock: the refusals carry retry_after_s
        q.install("proof_rate=0.001,proof_burst=2")._clock = lambda: 100.0
    k = 8
    ns_a = (bytes(NAMESPACE_SIZE - 1) + bytes([1])).hex()
    # Three data-quadrant samples of one tenant, a parity sample (never
    # throttled), then a namespace query of the same tenant.
    requests = [("proof", (0, 0)), ("proof", (0, 1)), ("proof", (0, 2)),
                ("proof", (2 * k - 1, 2 * k - 1)), ("shares", ns_a)]
    port, theirs = providers(k)
    got = _qos_outcomes(port, qos.QosThrottled, qos.throttle_body, requests)
    want = _qos_outcomes(theirs, jax_qos.QosThrottled, jax_qos.throttle_body, requests)
    assert got == want
    assert got[:2] == ["ok", "ok"] and got[2] != "ok" and got[3] == "ok"


ADVERSARY_SPECS = ("seed=31,withhold_frac=0.25", "seed=13,malform_shares=2",
                   "seed=13,wrong_root=1")


@pytest.mark.parametrize("spec", ADVERSARY_SPECS)
def test_withheld_and_tampered_refusals_equal_jax(spec):
    k = 4
    chaos.install(spec)
    jax_chaos.install(spec)
    adv = chaos.active_adversary()
    port, theirs = providers(k)
    if adv.withhold_frac:
        targets = sorted(adv.withheld_set(1, 2 * k))[:3]
    else:
        targets = list(adv.malformed_coords(1, 2 * k)) or [(0, 0)]
    refusals = []
    for r, c in targets:
        got = []
        for p, exc in ((port, (ShareWithheld, BadProofDetected)),
                       (theirs, (JaxWithheld, JaxBadProof))):
            with pytest.raises(exc) as info:
                p.share_proof_payload(1, r, c)
            got.append((type(info.value).__name__, str(info.value)))
        assert got[0] == got[1]
        refusals.append(got[0][0])
    assert set(refusals) == {"ShareWithheld" if adv.withhold_frac else "BadProofDetected"}
    attest = ",".join(f"{r}:{c}" for r, c in targets)
    for p, exc in ((port, (ShareWithheld, BadProofDetected)),
                   (theirs, (JaxWithheld, JaxBadProof))):
        with pytest.raises(exc):
            p.attestation_payload(1, attest)
    assert api.coverage_response({"height": "1"}) == jax_api.coverage_response({"height": "1"})
    # The served view differs from the honest entry only under tampering.
    assert (port.serve_view(1) is port._honest_entry(1)) == (not adv.tampers())


def _first_fail_then_pass_seed(seam: str, fails: int) -> int:
    """The least chaos seed whose draws at `seam` with p=0.5 fail `fails`
    times, then pass (chaos/spec.py: one draw per seam call)."""
    for seed in range(100_000):
        rng = random.Random(f"celestia-chaos:{seed}:{seam}")
        if all((rng.random() < 0.5) == (i < fails) for i in range(fails + 1)):
            return seed
    raise AssertionError(seam)


def _counter(name: str, **labels) -> float:
    fam = registry().get(name)
    if fam is None:
        return 0.0
    return sum(v for key, v in fam.samples() if all(key.get(a) == b for a, b in labels.items()))


@pytest.mark.parametrize("seam,key", [("proof.serve", "proof_fail"),
                                      ("proof.verify", "verify_fail")])
def test_proof_seams_retry_on_the_card_then_raise(seam, key, monkeypatch):
    monkeypatch.setenv("CELESTIA_SERVE_VERIFY", "1")  # the verify seam runs in the gate
    k = 4
    port, theirs = providers(k)
    honest = [both(_call(k, lambda p: p.share_proof_payload(1, r, c)))[1] for r, c in coords(k)]
    seed = _first_fail_then_pass_seed(seam, 2)
    chaos.install(f"seed={seed},{key}=0.5")
    jax_chaos.install(f"seed={seed},{key}=0.5")
    before = _counter("celestia_recoveries_total", seam=seam, outcome="retried")
    r, c = coords(k)[0]
    got = api.render(port.share_proof_payload(1, r, c))
    assert got == honest[0] == api.render(theirs.share_proof_payload(1, r, c))
    assert _counter("celestia_recoveries_total", seam=seam, outcome="retried") == before + 2
    chaos.install(f"seed=1,{key}=1.0")
    with pytest.raises(DeviceFault):
        port.share_proof_payload(1, r, c)
    assert _counter("celestia_recoveries_total", seam=seam,
                    outcome="retried") == before + 2 + degrade.DEFAULT_THRESHOLD
    # The queued path hands the fault to the caller too.
    with pytest.raises(DeviceFault):
        port.sampler.share_proof(port.entry(1), r, c)
