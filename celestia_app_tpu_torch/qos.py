"""$CELESTIA_QOS: per-tenant admission control — the observe -> enforce
layer of the multi-tenant data plane.

PR 4 made every namespace's blobs/shares/bytes visible, PR 10 labeled the
read path, PR 7 gave the telemetry plane burn-rate judgment — and nothing
ACTED on any of it: a whale tenant could flood BroadcastTx and crowd the
square, a proof spammer could saturate the serve plane, and the only
recourse was an operator eyeballing /metrics.  This module closes the
loop the way serve/heal.py closed detect -> act on the read path:
declarative per-tenant limits, enforced at the two admission seams the
repo already has (mempool insert on the write path, proof assembly on the
read path), with ONE canonical throttle payload every plane renders.

Spec grammar — comma-separated `key=value` pairs (the $CELESTIA_CHAOS
shape; unknown keys raise, a typo'd limit silently enforcing nothing is
worse than no limit at all):

    CELESTIA_QOS="tx_rate=50,tx_burst=100,pool_bytes=1048576,\
deadbeef.tx_rate=5,deadbeef.slo_p99_ms=500"

    tx_rate=<r>        default per-tenant tx admissions/sec (token bucket)
    tx_burst=<n>       default bucket depth (default: max(2*rate, 1))
    bytes_rate=<r>     default per-tenant admitted bytes/sec
    bytes_burst=<n>    default byte-bucket depth (default: 2*rate)
    pool_bytes=<n>     default per-tenant RESIDENT byte quota in the
                       mempool (admission refuses while the tenant's
                       resident bytes would exceed it)
    proof_rate=<r>     default per-tenant served DAS proofs/sec (read
                       path; parity/`other` reads are protocol traffic
                       and are never tenant-throttled)
    proof_burst=<n>    default proof-bucket depth
    slo_p99_ms=<ms>    register a per-tenant e2e p99 SLOSpec on the PR 7
                       burn-rate engine (celestia_e2e_seconds
                       {phase=total, namespace=<tenant>})
    <tenant>.<key>=<v> per-tenant override of any key above, where
                       <tenant> is the namespace label (hex, the PR 4
                       label space) or the reserved `tx` bucket

Absent keys mean UNLIMITED (the default node enforces nothing and pays
one cached env read per admission); an explicit 0 means fully blocked.
Token buckets refill continuously (monotonic clock, injectable for
tests) and are keyed by the CAPPED namespace label, so the enforcement
state is bounded by the PR 4 top-N cardinality cap by construction.

Every throttle raises `QosThrottled`, whose payload is rendered by ONE
canonical encoder (`throttle_body`, sorted-keys compact JSON — the
serve/api.render discipline), so the HTTP 429 bodies on the JSON-RPC and
REST planes and the gRPC RESOURCE_EXHAUSTED detail string are
byte-identical; throttles tick `celestia_qos_throttled_total
{namespace,kind}` and the per-tenant remaining tokens land on
`celestia_qos_tokens{namespace,bucket}`.  /healthz gains a `qos` block
and GET /namespaces an enforcement section (limits, tokens remaining,
throttle counts) — see trace/exposition.py and trace/square_journal.py.

The port's copy of celestia_app_tpu/qos.py, whole: the same parsing,
buckets, refusals and payloads on the same clock.  The port enforces the
write-path gate (`admit_tx`, from mempool.py); its read-path gate
(`admit_proof`) has no caller until the sampler's `proof_rate` seam and
the HTTP planes come over (ROADMAP, queue 1 items 3 and 4).
"""

from __future__ import annotations

import json
import os
import threading
import time

#: Spec keys a tenant limit can be set for (bare = the default tier).
_LIMIT_KEYS = (
    "tx_rate", "tx_burst", "bytes_rate", "bytes_burst",
    "pool_bytes", "proof_rate", "proof_burst", "slo_p99_ms",
)


class QosThrottled(Exception):
    """A per-tenant limit refused this request.

    `kind` names the exhausted resource (tx_rate | bytes_rate |
    pool_bytes | proof_rate); the payload/`detail` rendering is the ONE
    byte sequence all three planes carry (429 bodies on the HTTP planes,
    the RESOURCE_EXHAUSTED detail string on gRPC)."""

    def __init__(self, namespace: str, kind: str, limit: float,
                 retry_after_s: float = 1.0):
        self.namespace = namespace
        self.kind = kind
        self.limit = limit
        self.retry_after_s = max(round(float(retry_after_s), 3), 0.001)
        super().__init__(
            f"namespace {namespace!r} over {kind} limit ({limit:g})"
        )

    def payload(self) -> dict:
        return {
            "code": "RESOURCE_EXHAUSTED",
            "error": str(self),
            "namespace": self.namespace,
            "kind": self.kind,
            "limit": self.limit,
            "retry_after_s": self.retry_after_s,
        }


def throttle_body(e: QosThrottled) -> bytes:
    """THE canonical throttle bytes (sorted keys, compact separators —
    serve/api.render's discipline): what makes cross-plane byte-identity
    structural rather than a test invariant."""
    return json.dumps(
        e.payload(), sort_keys=True, separators=(",", ":")
    ).encode()


def retry_after_header(e: QosThrottled) -> str:
    """The Retry-After header value every HTTP plane sends for a
    throttle: the bucket's refill estimate, ceiled, floored at 1 s —
    one definition so the planes cannot round apart."""
    return str(max(1, int(-(-e.retry_after_s // 1))))


def parse_spec(raw: str) -> dict:
    """`"k=v,tenant.k=v"` -> {(tenant|None, key): float}.  Unknown keys
    and malformed pairs raise ValueError (the chaos/spec.py contract)."""
    out: dict = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        key, eq, val = part.partition("=")
        key = key.strip()
        tenant = None
        if "." in key:
            tenant, _, key = key.rpartition(".")
            tenant = tenant.strip()
            if not tenant:
                raise ValueError(f"qos spec: empty tenant in {part!r}")
        if not eq or key not in _LIMIT_KEYS:
            raise ValueError(
                f"qos spec: unknown entry {part!r} "
                f"(known keys: {sorted(_LIMIT_KEYS)!r})"
            )
        try:
            out[(tenant, key)] = float(val.strip())
        except ValueError:
            raise ValueError(f"qos spec: bad value in {part!r}") from None
    return out


class _TokenBucket:
    """Continuous-refill token bucket (classic leaky-bucket dual): up to
    `burst` tokens, refilled at `rate`/sec.  NOT self-locking — the
    enforcer serializes access per tenant."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = max(float(burst), 0.0)
        self.tokens = self.burst
        self.t_last = now

    def _refill(self, now: float) -> None:
        if now > self.t_last:
            self.tokens = min(
                self.burst, self.tokens + (now - self.t_last) * self.rate
            )
            self.t_last = now

    def take(self, n: float, now: float) -> bool:
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def retry_after(self, n: float) -> float:
        """Seconds until `n` tokens will exist (1s floor when blocked)."""
        if self.rate <= 0:
            return 1.0
        return max((n - self.tokens) / self.rate, 0.001)


class QosEnforcer:
    """The live enforcement state for one parsed spec.

    Buckets are keyed by CAPPED namespace label (the PR 4 cardinality
    cap bounds the state), created lazily from the tenant's explicit
    limits or the default tier.  Thread-safe behind one lock — the
    guarded work is a couple of float ops, never I/O, so contention is
    noise next to the admission paths it protects (and orders of
    magnitude below the sharded mempool locks it rides behind)."""

    def __init__(self, params: dict, raw: str = "", clock=time.monotonic):
        self.params = dict(params)
        self.raw = raw
        self._clock = clock
        self._lock = threading.Lock()
        # (tenant, bucket-kind) -> _TokenBucket, built on first touch.
        self._buckets: dict[tuple[str, str], _TokenBucket] = {}
        # tenant -> {kind: throttle count} (the /namespaces + /healthz
        # enforcement story; bounded like the buckets).
        self._throttled: dict[str, dict[str, int]] = {}

    # --- limit resolution ---------------------------------------------------
    def _limit(self, tenant: str, key: str) -> float | None:
        """Tenant override first, then the default tier; None = unlimited."""
        v = self.params.get((tenant, key))
        if v is None:
            v = self.params.get((None, key))
        return v

    def tenants_with_limits(self) -> list[str]:
        """Every tenant the spec names explicitly (plus nothing else —
        default-tier limits apply lazily to whoever shows up)."""
        return sorted({t for (t, _k) in self.params if t is not None})

    def slo_specs(self):
        """Per-tenant SLOSpecs for the PR 7 burn-rate engine: one e2e
        p99 objective per `<tenant>.slo_p99_ms` (or every explicitly
        named tenant under a default `slo_p99_ms`)."""
        from celestia_app_tpu_torch.trace.slo import SLOSpec

        out = []
        for tenant in self.tenants_with_limits():
            ms = self._limit(tenant, "slo_p99_ms")
            if ms is None or tenant == "tx":
                continue
            out.append(SLOSpec(
                name=f"qos_{tenant}_e2e_p99",
                metric="celestia_e2e_seconds",
                labels=(("phase", "total"), ("namespace", tenant)),
                quantile=0.99,
                threshold=ms / 1e3,
            ))
        return tuple(out)

    # --- enforcement --------------------------------------------------------
    def _bucket(self, tenant: str, kind: str, rate: float,
                now: float) -> _TokenBucket:
        b = self._buckets.get((tenant, kind))
        if b is None or b.rate != rate:
            burst = self._limit(tenant, f"{kind.split('_')[0]}_burst")
            if burst is None:
                # rate 0 means BLOCKED (no free burst token); a positive
                # rate defaults to a 2x-rate bucket depth, 1 minimum.
                burst = max(2.0 * rate, 1.0) if rate > 0 else 0.0
            b = _TokenBucket(rate, burst, now)
            self._buckets[(tenant, kind)] = b
        return b

    def _throttle(self, tenant: str, kind: str, limit: float,
                  retry_after_s: float):
        from celestia_app_tpu_torch.trace.metrics import registry
        from celestia_app_tpu_torch.trace.square_journal import (
            capped_namespace_label,
        )

        per = self._throttled.setdefault(tenant, {})
        per[kind] = per.get(kind, 0) + 1
        registry().counter(
            "celestia_qos_throttled_total",
            "per-tenant QoS refusals by exhausted resource "
            "(429 / RESOURCE_EXHAUSTED on every plane)",
        ).inc(namespace=capped_namespace_label(tenant), kind=kind)
        raise QosThrottled(tenant, kind, limit, retry_after_s)

    def admit_tx(self, tenant: str, nbytes: int,
                 resident_bytes: int = 0) -> None:
        """The write-path gate (one call per mempool admission): resident
        byte quota, then the tx-rate bucket, then the bytes-rate bucket.
        Raises QosThrottled; charges nothing on a refusal (a throttled
        spammer must not drain its own future budget)."""
        quota = self._limit(tenant, "pool_bytes")
        now = self._clock()
        with self._lock:
            if quota is not None and resident_bytes + nbytes > quota:
                self._throttle(tenant, "pool_bytes", quota, 1.0)
            tx_rate = self._limit(tenant, "tx_rate")
            if tx_rate is not None:
                b = self._bucket(tenant, "tx_rate", tx_rate, now)
                if not b.take(1.0, now):
                    self._throttle(tenant, "tx_rate", tx_rate,
                                   b.retry_after(1.0))
            bytes_rate = self._limit(tenant, "bytes_rate")
            if bytes_rate is not None:
                b = self._bucket(tenant, "bytes_rate", bytes_rate, now)
                if not b.take(float(nbytes), now):
                    # Un-charge the tx-rate token the refused admission
                    # took above: one refusal must cost zero budget.
                    if tx_rate is not None:
                        tb = self._buckets[(tenant, "tx_rate")]
                        tb.tokens = min(tb.burst, tb.tokens + 1.0)
                    self._throttle(tenant, "bytes_rate", bytes_rate,
                                   b.retry_after(float(nbytes)))
            self._refresh_token_gauges(tenant)

    def admit_proof(self, tenant: str) -> None:
        """The read-path gate (one call per served proof, labeled by the
        PR 10 capped namespace): parity/`other`/`tx` reads are protocol
        traffic, never tenant-throttled."""
        from celestia_app_tpu_torch.trace.square_journal import OTHER_LABEL, TX_LABEL

        if tenant in (OTHER_LABEL, TX_LABEL):
            return
        rate = self._limit(tenant, "proof_rate")
        if rate is None:
            return
        now = self._clock()
        with self._lock:
            b = self._bucket(tenant, "proof_rate", rate, now)
            if not b.take(1.0, now):
                self._throttle(tenant, "proof_rate", rate,
                               b.retry_after(1.0))
            self._refresh_token_gauges(tenant)

    # --- read side ----------------------------------------------------------
    def _refresh_token_gauges(self, tenant: str) -> None:
        from celestia_app_tpu_torch.trace.metrics import registry
        from celestia_app_tpu_torch.trace.square_journal import (
            capped_namespace_label,
        )

        gauge = registry().gauge(
            "celestia_qos_tokens",
            "remaining per-tenant QoS tokens by bucket",
        )
        for (t, kind), b in self._buckets.items():
            if t == tenant:
                gauge.set(round(b.tokens, 3),
                          namespace=capped_namespace_label(t), bucket=kind)

    def tenant_block(self, tenant: str) -> dict:
        """One tenant's enforcement view (limits / tokens / throttles) —
        the /namespaces + /healthz row."""
        limits = {
            key: self._limit(tenant, key)
            for key in _LIMIT_KEYS
            if self._limit(tenant, key) is not None
        }
        with self._lock:
            tokens = {
                kind: round(b.tokens, 3)
                for (t, kind), b in sorted(self._buckets.items())
                if t == tenant
            }
            throttled = dict(self._throttled.get(tenant, {}))
        return {"limits": limits, "tokens": tokens, "throttled": throttled}

    def health_block(self) -> dict:
        """The /healthz `qos` face: the configured default tier, every
        tenant with explicit limits or live state, total throttles."""
        with self._lock:
            seen = sorted(
                {t for (t, _k) in self._buckets} | set(self._throttled)
            )
            total = sum(
                n for per in self._throttled.values() for n in per.values()
            )
        tenants = sorted(set(self.tenants_with_limits()) | set(seen))
        return {
            "spec": self.raw,
            "defaults": {
                key: self.params[(None, key)]
                for key in _LIMIT_KEYS if (None, key) in self.params
            },
            "tenants": {t: self.tenant_block(t) for t in tenants},
            "throttled_total": total,
        }


# --- process-level activation (the chaos/__init__ pattern) -------------------

_INSTALLED: QosEnforcer | None = None
_ENV_CACHE: tuple[str, QosEnforcer | None] = ("", None)
_LOCK = threading.Lock()


def _wire_slos(enf: QosEnforcer | None) -> None:
    """Per-tenant SLOSpecs ride the PR 7 burn-rate engine: swap the
    engine's tenant tier whenever the enforcer changes."""
    from celestia_app_tpu_torch.trace import slo

    slo.set_tenant_specs(enf.slo_specs() if enf is not None else ())


def install(spec: str | dict) -> QosEnforcer:
    """Install a QoS spec for this process (overrides $CELESTIA_QOS)."""
    global _INSTALLED
    params = parse_spec(spec) if isinstance(spec, str) else dict(spec)
    with _LOCK:
        _INSTALLED = QosEnforcer(
            params, raw=spec if isinstance(spec, str) else ""
        )
    _wire_slos(_INSTALLED)
    return _INSTALLED


def uninstall() -> None:
    global _INSTALLED
    with _LOCK:
        _INSTALLED = None
    _wire_slos(None)


def enforcer() -> QosEnforcer | None:
    """The active enforcer, or None when no QoS is configured (the
    default node: one cached env-string compare per admission)."""
    global _ENV_CACHE
    if _INSTALLED is not None:
        return _INSTALLED
    raw = os.environ.get("CELESTIA_QOS", "")
    cached_raw, cached = _ENV_CACHE
    if raw == cached_raw:
        return cached
    enf = QosEnforcer(parse_spec(raw), raw=raw) if raw.strip() else None
    with _LOCK:
        _ENV_CACHE = (raw, enf)
    _wire_slos(enf)
    return enf


def health_block() -> dict | None:
    """The /healthz `qos` block, or None when enforcement is off (the
    block is absent, like the heal block — presence means policy)."""
    enf = enforcer()
    return enf.health_block() if enf is not None else None
