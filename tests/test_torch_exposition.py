"""The port's HTTP GET surface (trace/exposition.py), held against the JAX
package: one square at k=4, 8 and 16 in a JAX DasProvider and in a port one
(device="cpu"), each registered with its package's exposition, and every
route through `handle_observability_get` on both gives the same status,
content type, headers and body bytes, with the clocks injected.  Also: the
400, 404, 410, 502, 503 (no provider, and mid-heal with Retry-After) and
429 answers; the adopted `x-celestia-trace` header; /metrics family by
family; the flight bundle's `healthz` section; and, under a persistent
`proof_fail` spec, the port's 500 naming DeviceFault (never 410 or 502).

Each test runs on fresh metrics registries, tracers and SLO engines in both
packages (swapped in and restored), so the bodies depend on what the test
drives and not on what ran earlier in the process.
"""

from __future__ import annotations

import gc
import json
import time
import types

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
from celestia_app_tpu.trace import device_ledger as jax_ledger
from celestia_app_tpu.trace import exposition as jax_exposition
from celestia_app_tpu.trace import fleet as jax_fleet
from celestia_app_tpu.trace import flight_recorder as jax_flight
from celestia_app_tpu.trace import metrics as jax_metrics
from celestia_app_tpu.trace import slo as jax_slo
from celestia_app_tpu.trace import spans as jax_spans
from celestia_app_tpu.trace import square_journal as jax_square_journal
from celestia_app_tpu.trace import timeline as jax_timeline
from celestia_app_tpu.trace import tracer as jax_tracer
from celestia_app_tpu_torch import chaos, qos
from celestia_app_tpu_torch.chaos import degrade
from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, SHARE_SIZE
from celestia_app_tpu_torch.da import extend_shares
from celestia_app_tpu_torch.serve import api, heal
from celestia_app_tpu_torch.serve.cache import ForestCache
from celestia_app_tpu_torch.trace import device_ledger, exposition, fleet, flight_recorder
from celestia_app_tpu_torch.trace import metrics, slo, spans, square_journal, timeline, tracer
from celestia_app_tpu_torch.trace.context import TRACE_HEADER, new_context, serialize_context

KS = (4, 8, 16)
NOW = 1_700_000_000.0

PORT = types.SimpleNamespace(
    api=api, chaos=chaos, qos=qos, degrade=degrade, heal=heal, exposition=exposition,
    fleet=fleet, ledger=device_ledger, flight=flight_recorder, metrics=metrics, slo=slo,
    spans=spans, square_journal=square_journal, timeline=timeline, tracer=tracer)
JAX = types.SimpleNamespace(
    api=jax_api, chaos=jax_chaos, qos=jax_qos, degrade=jax_degrade, heal=jax_heal,
    exposition=jax_exposition, fleet=jax_fleet, ledger=jax_ledger, flight=jax_flight,
    metrics=jax_metrics, slo=jax_slo, spans=jax_spans, square_journal=jax_square_journal,
    timeline=jax_timeline, tracer=jax_tracer)
PACKAGES = (PORT, JAX)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran, when it ends
    (each loaded XLA:CPU executable holds many memory mappings)."""
    yield
    jax.clear_caches()
    gc.collect()


def det_ods(k: int, seed: int) -> np.ndarray:
    """An ODS whose namespaces come in runs across row boundaries."""
    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, (k * k, SHARE_SIZE), dtype=np.uint8)
    ods[:, :NAMESPACE_SIZE] = 0
    ods[:, NAMESPACE_SIZE - 1] = 1 + (np.arange(k * k) + k // 2) // max(k // 2, 1)
    return ods


@pytest.fixture(scope="module")
def providers():
    """(port DasProvider, JAX DasProvider), each holding the square of size
    k at height k for every k in KS."""
    port = api.DasProvider(cache=ForestCache(heights=len(KS), spill=len(KS), device="cpu"))
    theirs = jax_api.DasProvider(cache=JaxForestCache(heights=len(KS), spill=len(KS)))
    for k in KS:
        eds = extend_shares([s.tobytes() for s in det_ods(k, seed=k)], device="cpu")
        port.cache.put(k, eds)
        theirs.cache.put(k, JaxEDS(jnp.asarray(eds.squared()), eds.row_roots(), eds.col_roots(),
                                   eds.data_root(), k))
    return port, theirs


class _Clock:
    """A stepped clock: every call advances by 1 ms."""

    def __init__(self, start: float):
        self.t = start

    def __call__(self) -> float:
        self.t += 0.001
        return self.t


def _reset(pkg) -> None:
    pkg.api._reset_coverage_for_tests()
    for mod in (pkg.heal, pkg.square_journal, pkg.fleet):
        mod._reset_for_tests()
    pkg.chaos.uninstall()
    pkg.qos.uninstall()
    pkg.degrade.reset_for_tests()


@pytest.fixture(autouse=True)
def mounted(providers, monkeypatch):
    """Both providers mounted on fresh process state: a new metrics registry,
    a new default tracer and height timeline, an SLO engine on stepped
    clocks, a pinned scrape
    timestamp, the flight recorder off, no residual-growth streak in the
    device ledgers, and the coverage, heal, namespace, fleet, chaos, QoS
    and ladder state reset.  Everything swapped is restored afterwards."""
    monkeypatch.setenv("CELESTIA_SCRAPE_TS_S", "0")
    monkeypatch.delenv("CELESTIA_FLEET_PEERS", raising=False)
    monkeypatch.delenv("CELESTIA_FLIGHT_DIR", raising=False)
    monkeypatch.setenv("CELESTIA_SLO_TICK_S", "0")
    monkeypatch.setattr(time, "time", lambda: NOW)
    for pkg, provider in zip(PACKAGES, providers):
        monkeypatch.setattr(pkg.metrics, "_REGISTRY", pkg.metrics.Registry())
        monkeypatch.setattr(pkg.exposition, "_LAST_SCRAPE_TS", None)
        monkeypatch.setattr(pkg.ledger, "_RESIDUAL_STREAK", 0)
        monkeypatch.setattr(pkg.ledger, "_LAST_RESIDUAL", None)
        fresh = pkg.tracer.Tracer()
        monkeypatch.setattr(pkg.tracer, "_default", fresh)
        monkeypatch.setattr(pkg.tracer, "_TIMELINE_INSTALLED", True)
        monkeypatch.setattr(pkg.timeline, "_TIMELINE", pkg.timeline.HeightTimeline())
        pkg.timeline.install(fresh)
        _reset(pkg)
        eng = pkg.slo._reset_for_tests()
        eng._clock, eng._wall = _Clock(100.0), (lambda: NOW)
        pkg.exposition.register_das_provider(provider)
    yield providers
    for pkg, provider in zip(PACKAGES, providers):
        pkg.exposition.unregister_das_provider(provider)
        _reset(pkg)
        pkg.slo._reset_for_tests()


def get_both(path: str):
    """handle_observability_get(path) on (port, JAX)."""
    return tuple(pkg.exposition.handle_observability_get(path, plane="jsonrpc")
                 for pkg in PACKAGES)


def assert_same(path: str, status: int | None = None):
    got, want = get_both(path)
    assert got == want, path
    if status is not None:
        assert got is not None and got[0] == status, (path, got)
    return got


def coords(k: int) -> list[tuple[int, int]]:
    n = 2 * k
    return sorted({(0, 0), (k - 1, k - 1), (0, n - 1), (k - 1, k), (n - 1, 0), (k, k - 1),
                   (n - 1, n - 1), (k // 2, n - 2)})


def namespace_hex(v: int) -> str:
    return (bytes(NAMESPACE_SIZE - 1) + bytes([v])).hex()


# Families left out of the comparison, each for its reason:
#   celestia_recoveries_total — in one package only, by design: the port's
#     proof seams count their retries on the card (chaos/degrade.
#     retry_on_card); the JAX seams answer on the host and count nothing.
#   celestia_jit_compile_seconds_total, celestia_dispatch_seconds_total —
#     the program ledger bills each package's own builder caches, which are
#     process-wide: a program's first call is billed once per process, and
#     the JAX tamper seam rebuilds a jitted forest where the port's does not.
ONE_PACKAGE_FAMILIES = {"celestia_recoveries_total", "celestia_jit_compile_seconds_total",
                        "celestia_dispatch_seconds_total"}
# Histograms of wall time: label sets and observation counts must agree, the
# bucket placement and sums are the two packages' own timings.
TIMING_HISTOGRAMS_SUFFIX = "_seconds"


def assert_metrics_equal() -> None:
    """/metrics on both packages, family by family (parsed with the port's
    fleet.parse_prometheus_text)."""
    got, want = get_both("/metrics")
    assert got[:2] == want[:2] == (200, exposition.METRICS_CONTENT_TYPE)
    ours = fleet.parse_prometheus_text(got[2].decode())
    theirs = fleet.parse_prometheus_text(want[2].decode())
    kinds = {n: k for n, k in ours[0].items() if n not in ONE_PACKAGE_FAMILIES}
    assert kinds == {n: k for n, k in theirs[0].items() if n not in ONE_PACKAGE_FAMILIES}
    assert {n: v for n, v in ours[1].items() if n not in ONE_PACKAGE_FAMILIES} == \
        {n: v for n, v in theirs[1].items() if n not in ONE_PACKAGE_FAMILIES}
    assert ours[1]["celestia_scrape_timestamp_seconds"] == {(): NOW}
    assert set(ours[2]) == set(theirs[2])
    for name, snap in ours[2].items():
        other = theirs[2][name]
        assert snap.buckets == other.buckets, name
        assert set(snap.children) == set(other.children), name
        for key, (counts, total) in snap.children.items():
            o_counts, o_total = other.children[key]
            assert sum(counts) == sum(o_counts), (name, key)
            if not name.endswith(TIMING_HISTOGRAMS_SUFFIX):
                assert (counts, total) == (o_counts, o_total), (name, key)


@pytest.mark.parametrize("k", KS)
def test_das_routes_equal_jax(k):
    n = 2 * k
    for r, c in coords(k):
        for axis in ("row", "col"):
            assert_same(f"/das/share_proof?height={k}&row={r}&col={c}&axis={axis}", 200)
    assert_same(f"/das/share_proof?height={k}&row=1&col=2", 200)  # axis defaults to row
    values = sorted(set(det_ods(k, seed=k)[:, NAMESPACE_SIZE - 1].tolist()))
    for v in values[:2] + [0, 250]:  # found, and absent below / above
        assert_same(f"/das/shares?height={k}&namespace={namespace_hex(v)}", 200)
    spec = ",".join(f"{r}:{c}:{'col' if (r + c) % 2 else 'row'}" for r, c in coords(k))
    assert_same(f"/das/attestation?height={k}&samples={spec}", 200)
    assert_same(f"/das/attestation?height={k}&samples={n - 1}:0,0:{n - 1}", 200)
    for q in ("", f"?height={k}", "?height=999", "?height=x"):
        assert_same(f"/das/coverage{q}")
    body = json.loads(get_both(f"/das/coverage?height={k}")[0][2])
    assert body["square_size"] == k and body["counts"]["sampled"] > 0
    assert_metrics_equal()


def test_bad_requests_and_unknown_heights_equal_jax():
    for path in ("/das/share_proof?height=x&row=0&col=0", "/das/share_proof?height=4&row=0",
                 "/das/share_proof?height=4&row=0&col=0&axis=diag",
                 "/das/share_proof?height=4&row=99&col=0",
                 "/das/shares?height=4&namespace=zz", "/das/shares?height=4",
                 "/das/attestation?height=4&samples=", "/das/attestation?height=4&samples=1:2:diag",
                 "/trace_tables/spans?tail=0", "/trace_tables/spans?tail=x"):
        assert_same(path, 400)
    for path in ("/das/share_proof?height=99&row=0&col=0", "/das/shares?height=5&namespace="
                 + namespace_hex(1), "/das/attestation?height=7&samples=0:0",
                 "/trace_tables/no_such_table"):
        assert_same(path, 404)
    for path in ("/", "/nope", "/das", "/das/unknown", "/metricsx"):
        assert get_both(path) == (None, None)


def test_no_provider_is_503_like_jax(providers):
    for pkg, provider in zip(PACKAGES, providers):
        pkg.exposition.unregister_das_provider(provider)
    try:
        for path in ("/das/share_proof?height=4&row=0&col=0", "/das/shares?height=4&namespace=00",
                     "/das/attestation?height=4&samples=0:0"):
            assert_same(path, 503)
    finally:
        for pkg, provider in zip(PACKAGES, providers):
            pkg.exposition.register_das_provider(provider)


@pytest.mark.parametrize("spec,status", [("seed=31,withhold_frac=0.25", 410),
                                         ("seed=13,malform_shares=2", 502),
                                         ("seed=13,wrong_root=1", 502)])
def test_withheld_and_tampered_answers_equal_jax(spec, status):
    k = 4
    for pkg in PACKAGES:
        pkg.chaos.install(spec)
    adv = chaos.active_adversary()
    targets = (sorted(adv.withheld_set(k, 2 * k))[:3] if adv.withhold_frac
               else list(adv.malformed_coords(k, 2 * k)) or [(0, 0)])
    for r, c in targets:
        got = assert_same(f"/das/share_proof?height={k}&row={r}&col={c}", status)
        detected = "withholding" if status == 410 else "root_mismatch"
        assert json.loads(got[2])["detected"] == detected
    assert_same(f"/das/attestation?height={k}&samples=" + ",".join(
        f"{r}:{c}" for r, c in targets), status)
    assert_same(f"/das/coverage?height={k}", 200)
    assert_metrics_equal()


def test_mid_heal_is_503_with_retry_after_like_jax(providers):
    k = 4
    engines = [pkg.heal.HealingEngine(p, name="exposition") for pkg, p in zip(PACKAGES, providers)]
    try:
        for pkg in PACKAGES:
            pkg.chaos.install("seed=31,withhold_frac=0.25")
        r, c = sorted(chaos.active_adversary().withheld_set(k, 2 * k))[0]
        assert_same(f"/das/share_proof?height={k}&row={r}&col={c}", 410)  # detected: heal pending
        got = assert_same(f"/das/share_proof?height={k}&row={r}&col={c}", 503)
        assert len(got) == 4 and int(got[3]["Retry-After"]) >= 1
        assert json.loads(got[2])["healing"] is True
        assert_same(f"/das/shares?height={k}&namespace={namespace_hex(1)}", 503)
        assert_same("/heal", 200)
        assert_same("/healthz", 200)
    finally:
        for eng in engines:
            eng.close()


def test_qos_refusal_is_429_like_jax():
    k = 8
    for pkg in PACKAGES:  # one fixed clock: the refusals carry retry_after_s
        pkg.qos.install("proof_rate=0.001,proof_burst=2")._clock = lambda: 100.0
    paths = [f"/das/share_proof?height={k}&row=0&col={c}" for c in range(3)]
    paths += [f"/das/share_proof?height={k}&row={2 * k - 1}&col={2 * k - 1}",  # parity: free
              f"/das/shares?height={k}&namespace={namespace_hex(1)}"]
    statuses = [assert_same(p)[0] for p in paths]
    assert statuses[:2] == [200, 200] and statuses[2] == 429 and statuses[3] == 200
    refused = get_both(paths[2])[0]
    assert int(refused[3]["Retry-After"]) >= 1
    assert_same("/healthz", 200)


def test_state_routes_equal_jax(monkeypatch):
    def layer():
        return {"height": 3, "peers": 2}

    def broken():
        raise RuntimeError("probe provider down")

    for pkg in PACKAGES:
        pkg.exposition.register_health_provider("node:1", layer)
        pkg.exposition.register_health_provider("node:2", broken)
    try:
        for path in ("/healthz", "/healthz/", "/heal", "/namespaces", "/slo", "/slo",
                     "/timeline", "/timeline?height=3", "/timeline?tail=2", "/timeline?tail=x",
                     "/fleet"):
            assert_same(path)
        health = json.loads(get_both("/healthz")[0][2])
        assert health["layers"]["node:1"] == layer()
        assert health["layers"]["node:2"] == {"error": "RuntimeError: probe provider down"}
    finally:
        for pkg in PACKAGES:
            pkg.exposition.unregister_health_provider("node:1")
            pkg.exposition.unregister_health_provider("node:2")
    assert "layers" not in json.loads(get_both("/healthz")[0][2])
    # A stepped-down ladder makes the probe DEGRADED in both packages.
    for pkg in PACKAGES:
        pkg.degrade.DEVICE_DEGRADATION.degrade("fused")
    got = assert_same("/healthz", 200)
    assert json.loads(got[2])["status"] == "DEGRADED"


def test_trace_tables_equal_jax(monkeypatch):
    monkeypatch.setattr(time, "time_ns", lambda: 42)
    for pkg in PACKAGES:
        for i in range(3):
            pkg.tracer.traced().write("exposition_probe", i=i, label="x")
    for path in ("/trace_tables", "/trace_tables/exposition_probe",
                 "/trace_tables/exposition_probe?tail=2", "/trace_tables/exposition_probe/"):
        assert_same(path, 200)
    got = get_both("/trace_tables/exposition_probe?tail=2")[0]
    assert got[1] == "application/x-ndjson"
    assert [json.loads(line)["i"] for line in got[2].decode().splitlines()] == [1, 2]


def test_device_route_equal_jax(monkeypatch):
    """/device after both ledgers are reset to the same owners and warm-up,
    with the measured high-water injected (each package measures its own
    process the same way, but not at the same instant)."""
    saved = [(dict(pkg.ledger._OWNER_CALLBACKS), {o: dict(v) for o, v in
                                                   pkg.ledger._OWNED_KEYED.items()})
             for pkg in PACKAGES]
    try:
        for pkg in PACKAGES:
            pkg.ledger._reset_for_tests()
            monkeypatch.setattr(pkg.ledger, "_measured_bytes",
                                lambda *a, **kw: (1 << 30, "device_memory_stats"))
            pkg.ledger.register_owner("serve_forest_cache", lambda: 4096)
            pkg.ledger.note_owned_bytes("rs_generators", (16, "leopard"), 1 << 20)
            pkg.ledger.note_warmup(4, "leopard", "fused")
        got = assert_same("/device", 200)
        body = json.loads(got[2])
        assert body["ownership"]["measured_source"] == "device_memory_stats"
        assert body["ownership"]["owners"]["serve_forest_cache"] == 4096
        assert_same("/device", 200)  # a second tick: the same bytes
        assert_metrics_equal()
    finally:
        for pkg, (callbacks, keyed) in zip(PACKAGES, saved):
            pkg.ledger._reset_for_tests()
            pkg.ledger._OWNER_CALLBACKS.update(callbacks)
            pkg.ledger._OWNED_KEYED.update(keyed)


def test_fleet_route_equal_jax(monkeypatch):
    """/fleet with both aggregators over the same stub scrapes (the fetch
    seam), the monotonic clock injected."""
    texts = {}
    reg = metrics.Registry()
    reg.counter("celestia_proofs_served_total", "served").inc(7.0, plane="jsonrpc",
                                                               kind="share_proof")
    hist = reg.histogram("celestia_proof_latency_seconds", "latency",
                         buckets=(0.01, 0.05, 0.1, 0.5, 1.0))
    for v in (0.02, 0.3):
        hist.observe(v, phase="total")
    texts["/metrics"] = reg.render()
    texts["/healthz"] = json.dumps({"status": "SERVING", "degraded": {}})
    texts["/slo"] = json.dumps({"slos": {}})
    texts["/heal"] = json.dumps({"engines": {}})

    def fetch(url, path):
        if url.endswith("down"):
            raise ConnectionError("connection refused")
        return texts[path]

    for pkg in PACKAGES:
        monkeypatch.setattr(pkg.fleet.time, "monotonic", _Clock(500.0))
        pkg.fleet.configure(["http://a", "http://down"], interval_s=3600, fetch=fetch)
    got = assert_same("/fleet", 200)
    merged = json.loads(got[2])
    assert merged["fleet"]["hosts_reachable"] == 1 and merged["hosts"]["http://down"]["error"]
    assert_same("/fleet", 200)  # inside the interval: the same round


def test_adopted_trace_header_equal_jax():
    ctx = new_context(layer="test")
    wire = serialize_context(ctx)

    class Handler:
        def __init__(self, path, headers):
            self.path, self.headers = path, headers

    paths = ("/healthz", "/das/share_proof?height=4&row=1&col=1", "/nope")
    for headers in ({TRACE_HEADER: wire}, {}, {TRACE_HEADER: "not-a-trace-context"}):
        for path in paths:
            got, want = (pkg.exposition.handle_observability_get_adopted(
                Handler(path, headers), plane="jsonrpc", node_id="node-a") for pkg in PACKAGES)
            assert got == want, (path, headers)
    rows = []
    for pkg in PACKAGES:
        spans = [r for r in pkg.tracer.traced().tail("spans", 100)
                 if r.get("traceId") == ctx.trace_id and r.get("name") == "rpc_get"]
        rows.append(sorted((pkg.spans.span_attributes(r)["path"],
                            pkg.spans.span_attributes(r)["node_id"],
                            pkg.spans.span_attributes(r)["status"]) for r in spans))
    assert rows[0] == rows[1]
    assert rows[0] == sorted((p.partition("?")[0], "node-a", s)
                             for p, s in zip(paths, ("200", "200", "404")))


def test_flight_bundle_healthz_section_equal_jax():
    for pkg in PACKAGES:
        pkg.degrade.DEVICE_DEGRADATION.degrade("fused")
    got, want = (pkg.flight.capture("probe")["healthz"] for pkg in PACKAGES)
    assert got == want == exposition.health_payload()
    assert got["status"] == "DEGRADED"


def test_device_fault_is_500_never_410_or_502():
    """A fault of the card under a /das GET: the proof seam retries on the
    card, then the route answers 500 naming DeviceFault — never 410 or 502,
    and never an answer computed elsewhere."""
    k = 4
    chaos.install("seed=1,proof_fail=1.0")

    def retried() -> float:
        fam = metrics.registry().get("celestia_recoveries_total")
        return 0.0 if fam is None else sum(
            v for key, v in fam.samples() if key.get("outcome") == "retried")

    for path in (f"/das/share_proof?height={k}&row=1&col=2",
                 f"/das/share_proof?height={k}&row=5&col=7&axis=col"):
        before = retried()
        status, ctype, body = exposition.handle_observability_get(path, plane="jsonrpc")[:3]
        assert status == 500 and ctype == "application/json", (path, status, body)
        assert json.loads(body)["error"].startswith("DeviceFault: ")
        assert retried() == before + degrade.DEFAULT_THRESHOLD
    chaos.uninstall()
    assert exposition.handle_observability_get(
        f"/das/share_proof?height={k}&row=1&col=2")[0] == 200
