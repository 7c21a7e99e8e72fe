"""Shared observability HTTP surface for every serving plane.

The reference exposes Tendermint's Prometheus endpoint from the node and
lets the e2e harness pull pkg/trace's columnar tables off it
(test/e2e/testnet/setup.go:24, node.go:52-74).  Here one handler serves
both, and all three planes mount it — the JSON-RPC server, the REST
api_gateway, and the gRPC plane's debug port — so the exposition is
byte-identical for the same registry state no matter which port a scraper
hits:

    GET /metrics                 Prometheus text exposition (version 0.0.4)
    GET /trace_tables            {"tables": {name: row_count}}
    GET /trace_tables/<name>     the table as JSONL (application/x-ndjson);
                                 ?tail=N serves only the last N rows
    GET /healthz                 liveness + per-layer staleness + SLO block
    GET /namespaces              per-tenant data-plane summary (cumulative
                                 blob/share/byte totals + last square)
    GET /slo                     SLO burn-rate evaluation (trace/slo.py)
    GET /das/share_proof         one DAS sample: ?height=&row=&col= ->
                                 ShareProof vs the committed DAH data root
                                 (serve/, the batched proof plane)
    GET /das/shares              namespace-ranged query: ?height=&namespace=
                                 (29-byte hex) -> shares + multi-row proof
    GET /das/attestation         deduped multiproof for a SET of samples:
                                 ?height=&samples=r:c[:axis],... -> shared
                                 NMT/root node tables + per-tree ranges
                                 (serve/api.attestation_payload)
    GET /heal                    the self-healing loop's state: heights
                                 mid-heal, quarantined heights, last heal
                                 outcome per engine (serve/heal.py)
    GET /das/coverage            the DAS coverage map: ?height= -> the
                                 per-coordinate sampled/verified/refused
                                 bitmap; no args -> per-height summary
                                 (serve/api.py coverage registry)
    GET /fleet                   merged cluster telemetry over the
                                 configured peers (trace/fleet.py):
                                 per-host rates + cross-host quantiles
    GET /device                  the device-attribution ledger
                                 (trace/device_ledger.py): per-program
                                 compile/dispatch stats, memory
                                 ownership + unattributed residual,
                                 applied autotuner seats, warmup state

/healthz is the SLO face: beyond {"status": "SERVING"}, any registered
health providers (a ServingNode registers its own snapshot: last block
height and age, mempool depth, peer count, consensus round state) report
under "layers" — the first place to look when blocks stop, before
touching the trace tables.  A provider that throws reports its error
instead of taking the probe down.

The port's copy of celestia_app_tpu/trace/exposition.py, whole.  Two
planes mount it today: the JSON-RPC server (rpc/server.py `_Handler.do_GET`)
and `serve_observability`; the gRPC plane's debug port and the REST gateway
come with their planes (ROADMAP, queue 1).  A device fault under a /das GET
keeps the JAX mapping: the proof seams underneath retry the batched dispatch
on the card (chaos/degrade.retry_on_card) and raise device.DeviceFault past
the last try, which the catch-all answers 500 with a body naming
`DeviceFault` — never 410 or 502, which accuse the proposer, and never an
answer computed on the CPU.
"""

from __future__ import annotations

import json
import threading

METRICS_CONTENT_TYPE = "text/plain; version=0.0.4"

_HEALTH_LOCK = threading.Lock()
_HEALTH_PROVIDERS: dict[str, object] = {}

_DAS_LOCK = threading.Lock()
_DAS_PROVIDER = None  # serve/api.DasProvider; last registration wins


def register_das_provider(provider) -> None:
    """Mount a serve/api.DasProvider behind GET /das/* on every plane.
    Last registration wins (one serving node per process answers DAS;
    multi-node test processes register explicitly per scenario)."""
    global _DAS_PROVIDER
    with _DAS_LOCK:
        _DAS_PROVIDER = provider


def unregister_das_provider(provider=None) -> None:
    """Remove the provider; with `provider` given, only if still the
    registered one (a stopped node must not unhook its replacement)."""
    global _DAS_PROVIDER
    with _DAS_LOCK:
        if provider is None or _DAS_PROVIDER is provider:
            _DAS_PROVIDER = None


def das_provider():
    with _DAS_LOCK:
        return _DAS_PROVIDER


def register_health_provider(name: str, provider) -> None:
    """Mount `provider()` (-> JSON-safe dict) under /healthz "layers".
    Last registration per name wins (one live node per name)."""
    with _HEALTH_LOCK:
        _HEALTH_PROVIDERS[name] = provider


def unregister_health_provider(name: str, provider=None) -> None:
    """Remove a provider; with `provider` given, only if it is still the
    registered one (a stopped node must not unhook its replacement)."""
    with _HEALTH_LOCK:
        if provider is None or _HEALTH_PROVIDERS.get(name) is provider:
            _HEALTH_PROVIDERS.pop(name, None)


def health_payload() -> dict:
    with _HEALTH_LOCK:
        providers = dict(_HEALTH_PROVIDERS)
    payload: dict = {"status": "SERVING"}
    # Degradation ladder state (chaos/degrade.py): a process whose device
    # path has been stepped down keeps serving — correctness is intact,
    # latency is not — so the probe stays green but SAYS SO, and an
    # orchestrator can schedule a restart to re-arm the fast path.
    from celestia_app_tpu_torch.chaos.degrade import degraded_state

    degraded = degraded_state()
    if degraded:
        payload["status"] = "DEGRADED"
        payload["degraded"] = degraded
    # The SLO face: DEGRADED answers "is the device path stepped down",
    # the slo block answers "is the error budget burning" — one probe
    # distinguishes the two.  Read-only: the probe reports the LAST
    # evaluation, it never forces one.
    from celestia_app_tpu_torch.trace.slo import engine

    payload["slo"] = engine().health_block()
    # The self-healing face (serve/heal.py): which heights are mid-heal,
    # which are quarantined, and the last heal's outcome — absent when no
    # HealingEngine is registered (detection without reaction).
    from celestia_app_tpu_torch.serve.heal import heal_health_block

    heal = heal_health_block()
    if heal is not None:
        payload["heal"] = heal
    # The enforcement face (qos.py): configured per-tenant limits, tokens
    # remaining, throttle counts — absent when no $CELESTIA_QOS policy is
    # installed (presence means enforcement, like the heal block).
    from celestia_app_tpu_torch import qos

    qos_block = qos.health_block()
    if qos_block is not None:
        payload["qos"] = qos_block
    if providers:
        layers = {}
        for name, provider in sorted(providers.items()):
            try:
                layers[name] = provider()
            except Exception as e:  # noqa: BLE001 — probe must stay up
                layers[name] = {"error": f"{type(e).__name__}: {e}"}
        payload["layers"] = layers
    return payload


_SCRAPE_TS_LOCK = threading.Lock()
_LAST_SCRAPE_TS: float | None = None


def _refresh_scrape_timestamp() -> None:
    """Refresh `celestia_scrape_timestamp_seconds` — the render-time
    wall clock a fleet aggregator uses to judge staleness of a cached or
    proxied exposition.  $CELESTIA_SCRAPE_TS_S rate-limits the refresh
    (default 0 = every render); byte-identity tests freeze it the same
    way they freeze $CELESTIA_SLO_TICK_S, since a wall-clock gauge is
    exactly the kind of state two sequential scrapes may disagree on."""
    import os
    import time

    from celestia_app_tpu_torch.trace.metrics import registry

    global _LAST_SCRAPE_TS
    try:
        min_s = max(0.0, float(
            os.environ.get("CELESTIA_SCRAPE_TS_S", "") or 0.0
        ))
    except ValueError:
        min_s = 0.0
    now = time.time()
    with _SCRAPE_TS_LOCK:
        if _LAST_SCRAPE_TS is not None and now - _LAST_SCRAPE_TS < min_s:
            return
        _LAST_SCRAPE_TS = now
    registry().gauge(
        "celestia_scrape_timestamp_seconds",
        "unix time this exposition was rendered (scrape staleness "
        "marker for fleet aggregation)",
    ).set(now)


def metrics_payload() -> bytes:
    """The Prometheus exposition bytes — THE single renderer every plane
    serves, which is what makes cross-plane byte-identity structural
    rather than a test invariant."""
    from celestia_app_tpu_torch.trace.metrics import registry

    _refresh_scrape_timestamp()
    return registry().render().encode()


#: Ceiling on /trace_tables/<name>?tail=N — matches the tracer's default
#: ring size; a larger ask is a whole-table pull, which the uncapped
#: endpoint already serves.
MAX_TAIL = 10_000


def _parse_tail(query: str):
    """The `tail` parameter of a /trace_tables/<name> query: (ok, value)
    where value is None when absent, else the capped int; ok=False means
    the parameter was present but not a positive integer (a 400)."""
    for pair in query.split("&"):
        if not pair.startswith("tail="):
            continue
        raw = pair[len("tail="):]
        if not raw.isdigit() or int(raw) < 1:
            return False, raw
        return True, min(int(raw), MAX_TAIL)
    return True, None


def _query_params(query: str) -> dict[str, str]:
    from urllib.parse import parse_qs

    return {k: v[0] for k, v in parse_qs(query).items() if v}


def _das_response(kind: str, query: str, plane: str):
    """GET /das/* -> the registered DasProvider's canonical payload bytes
    (serve/api.render — the SAME bytes the gRPC Das service carries), with
    gateway-shaped errors: 503 no provider, 400 bad params, 404 unknown
    height."""
    provider = das_provider()
    if provider is None:
        return 503, "application/json", json.dumps(
            {"error": "no DAS provider registered (serve/ plane not wired)"}
        ).encode()
    from celestia_app_tpu_torch.serve.api import UnknownHeight, count_served, render
    from celestia_app_tpu_torch.serve.heal import HealingInProgress
    from celestia_app_tpu_torch.serve.sampler import BadProofDetected, ShareWithheld

    params = _query_params(query)
    try:
        if kind == "share_proof":
            payload = provider.share_proof_payload(
                int(params.get("height", "")),
                int(params.get("row", "")),
                int(params.get("col", "")),
                axis=params.get("axis", "row"),
            )
        elif kind == "attestation":
            payload = provider.attestation_payload(
                int(params.get("height", "")),
                params.get("samples", ""),
            )
        else:
            payload = provider.shares_payload(
                int(params.get("height", "")),
                params.get("namespace", ""),
            )
    except UnknownHeight as e:
        return 404, "application/json", json.dumps({"error": str(e)}).encode()
    except HealingInProgress as e:
        # 503 + Retry-After: the height is mid-heal (serve/heal.py) — a
        # RETRYABLE gap, never the terminal 410/502.  The body is a pure
        # function of the exception, so the JSON-RPC and REST twins stay
        # byte-identical; the gRPC Das service maps the same condition
        # to UNAVAILABLE.
        return (
            503,
            "application/json",
            json.dumps({
                "error": str(e),
                "healing": True,
                "retry_after_s": e.retry_after_s,
            }).encode(),
            {"Retry-After": str(max(1, int(-(-e.retry_after_s // 1))))},
        )
    except ShareWithheld as e:
        # 410 Gone: the share exists in the commitment but is being
        # withheld — the light client's detection signal, distinct from
        # 404 (height unknown) and 400 (bad request).
        return 410, "application/json", json.dumps(
            {"error": str(e), "detected": "withholding"}
        ).encode()
    except BadProofDetected as e:
        # 502: the committed root and the served square disagree — a
        # malformed-square / wrong-root attack caught at the
        # verification gate, never served as a valid proof.
        return 502, "application/json", json.dumps(
            {"error": str(e), "detected": "root_mismatch"}
        ).encode()
    except (TypeError, ValueError) as e:
        return 400, "application/json", json.dumps({"error": str(e)}).encode()
    except Exception as e:  # noqa: BLE001 — a proof fault must not kill the probe port
        from celestia_app_tpu_torch.qos import (
            QosThrottled,
            retry_after_header,
            throttle_body,
        )

        if isinstance(e, QosThrottled):
            # 429 + Retry-After: a per-tenant proof-rate limit (qos.py)
            # refused this read.  The body is qos.py's ONE canonical
            # payload, so the JSON-RPC and REST GET /das twins stay
            # byte-identical; the gRPC Das service maps the same
            # condition to RESOURCE_EXHAUSTED carrying the same string.
            return (
                429,
                "application/json",
                throttle_body(e),
                {"Retry-After": retry_after_header(e)},
            )
        return 500, "application/json", json.dumps(
            {"error": f"{type(e).__name__}: {e}"}
        ).encode()
    count_served(plane, kind, payload)
    return 200, "application/json", render(payload)


def handle_observability_get(path: str, plane: str = "shared"):
    """Route an HTTP GET path; returns (status, content_type, body-bytes)
    or None when the path is not an observability endpoint (the caller
    falls through to its own routes / 404).  `plane` names the mounting
    plane for per-plane serving counters (the BODY never depends on it —
    byte-identity across planes is the contract)."""
    from celestia_app_tpu_torch.trace.tracer import traced

    p, _, query = path.partition("?")
    if p != "/":
        p = p.rstrip("/")
    if p == "/das/share_proof":
        return _das_response("share_proof", query, plane)
    if p == "/das/shares":
        return _das_response("shares", query, plane)
    if p == "/das/attestation":
        return _das_response("attestation", query, plane)
    if p == "/das/coverage":
        from celestia_app_tpu_torch.serve.api import coverage_response

        # A pure function of the coverage-map state (serve/api.py) —
        # byte-identical on every plane, like /heal.
        return coverage_response(_query_params(query))
    if p == "/fleet":
        from celestia_app_tpu_torch.trace.fleet import fleet_response

        # The merged cluster view (trace/fleet.py); scrapes are
        # rate-limited by the aggregator interval, so planes asked
        # inside one round serve identical bytes.
        return fleet_response()
    if p == "/device":
        from celestia_app_tpu_torch.trace.device_ledger import device_response

        # The device-attribution ledger (trace/device_ledger.py): a
        # snapshot refreshed at most once per $CELESTIA_DEVICE_TICK_S,
        # so planes asked inside one tick serve identical bytes.
        return device_response()
    if p == "/timeline":
        from celestia_app_tpu_torch.trace.timeline import timeline_response

        # The per-height anatomy index (trace/timeline.py): a pure
        # function of retained row state — no ticks, no clocks at
        # render time — so every plane serves identical bytes.
        return timeline_response(_query_params(query))
    if p == "/metrics":
        return 200, METRICS_CONTENT_TYPE, metrics_payload()
    if p == "/healthz":
        return 200, "application/json", json.dumps(health_payload()).encode()
    if p == "/heal":
        from celestia_app_tpu_torch.serve.heal import heal_payload

        # A pure function of registered-engine state: all planes serve
        # identical bytes (the /metrics pattern).
        return 200, "application/json", json.dumps(heal_payload()).encode()
    if p == "/namespaces":
        from celestia_app_tpu_torch.trace import square_journal

        return 200, "application/json", json.dumps(
            square_journal.namespaces_payload()
        ).encode()
    if p == "/slo":
        from celestia_app_tpu_torch.trace.slo import engine

        # One rate-limited evaluation per scrape window: the payload is a
        # pure function of the retained evaluation state, so planes
        # scraped inside one tick interval serve identical bytes.
        eng = engine()
        eng.maybe_tick()
        return 200, "application/json", json.dumps(eng.payload()).encode()
    if p == "/trace_tables":
        return 200, "application/json", json.dumps(
            {"tables": traced().row_counts()}
        ).encode()
    if p.startswith("/trace_tables/"):
        name = p[len("/trace_tables/"):]
        ok, tail = _parse_tail(query)
        if not ok:
            return 400, "application/json", json.dumps(
                {"error": f"tail must be a positive integer, got {tail!r}"}
            ).encode()
        tracer = traced()
        if name not in tracer.tables():
            return 404, "application/json", json.dumps(
                {"error": f"no trace table {name!r}"}
            ).encode()
        body = tracer.export_jsonl(name, tail=tail)
        return 200, "application/x-ndjson", (body + "\n").encode()
    return None


def handle_observability_get_adopted(handler, plane: str,
                                     node_id: str | None = None):
    """Route `handler`'s GET with cross-node trace adoption: when the
    request carries an `x-celestia-trace` header the serving process
    JOINS that trace (same trace_id, fresh span_id) and answers inside
    an `rpc_get` span — so a das_loadgen --url fetch or a peer's probe
    leaves spans rows HERE that stitch to the caller's own under one
    trace_id.  `node_id` overrides the process identity for multi-server
    test processes.  Headerless requests route exactly as before (no
    span minted for plain scrapes)."""
    from celestia_app_tpu_torch.trace.context import (
        TRACE_HEADER,
        adopt_context,
        trace_span,
        use_context,
    )

    ctx = adopt_context(
        handler.headers.get(TRACE_HEADER),
        **({"node_id": node_id} if node_id else {}),
    )
    if ctx is None:
        return handle_observability_get(handler.path, plane=plane)
    with use_context(ctx):
        with trace_span(
            "rpc_get", ctx=ctx,
            path=handler.path.partition("?")[0], plane=plane,
        ) as attrs:
            resp = handle_observability_get(handler.path, plane=plane)
            attrs["status"] = resp[0] if resp is not None else 404
    return resp


def send_observability_response(handler, resp) -> None:
    """Write a handle_observability_get result through a
    BaseHTTPRequestHandler (the shape all three planes' handlers share).
    A result may carry an optional 4th element of extra headers (the
    healing-in-progress 503's Retry-After)."""
    status, content_type, body = resp[0], resp[1], resp[2]
    extra = resp[3] if len(resp) > 3 else {}
    handler.send_response(status)
    handler.send_header("Content-Type", content_type)
    handler.send_header("Content-Length", str(len(body)))
    for name, value in extra.items():
        handler.send_header(name, value)
    handler.end_headers()
    handler.wfile.write(body)


def send_observability_404(handler) -> None:
    """The shared not-found response for paths neither the observability
    surface nor the mounting plane routes.  Always carries
    Content-Length: a keep-alive scraper must never block on a
    length-less response waiting for a close that ThreadingHTTPServer
    does not send."""
    body = b'{"error":"not found"}'
    handler.send_response(404)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def serve_observability(host: str = "127.0.0.1", port: int = 0,
                        node_id: str | None = None, plane: str = "rest"):
    """A standalone HTTP mount of the shared observability surface —
    the das_loadgen --serve mini-node and the fleet tests' stub peers.
    GET-only; adoption-aware (handle_observability_get_adopted), with an
    optional per-SERVER `node_id` so several in-process servers emit
    distinguishable spans.  Returns an object with .url and .stop()."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _ObsHandler(BaseHTTPRequestHandler):
        _node_id = node_id
        _plane = plane

        def log_message(self, fmt, *args):  # quiet
            pass

        def do_GET(self):  # noqa: N802 — http.server API
            resp = handle_observability_get_adopted(
                self, plane=self._plane, node_id=self._node_id
            )
            if resp is None:
                send_observability_404(self)
                return
            send_observability_response(self, resp)

    httpd = ThreadingHTTPServer((host, port), _ObsHandler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    class _Server:
        def __init__(self):
            self.httpd = httpd
            self.port = httpd.server_address[1]
            self.url = f"http://{host}:{self.port}"

        def stop(self):
            httpd.shutdown()
            httpd.server_close()

    return _Server()
