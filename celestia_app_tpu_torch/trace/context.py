"""Request/block-scoped trace context: one trace_id from RPC submission
to DAH root.

PR 2 made the device pipeline legible; this layer makes everything above
it attributable: a `TraceContext` is issued at request entry (the three
serving planes' BroadcastTx handlers, or locally by `TestNode.broadcast`)
and threaded EXPLICITLY through the layers — mempool entries store the
submitting request's context, the block built from a reap adopts the
first reaped tx's trace_id, and every span below (square build, device
dispatch, consensus round, commit) joins that trace.  The contextvar here
is an in-thread convenience so deep call stacks (square.build inside
App.prepare_proposal) pick up the active context without threading a
parameter through every signature; across threads the context object
itself is passed (mempool entry -> proposer thread), never the
thread-local.

`trace_span` is the measurement primitive: it opens a child context,
makes it current for the body, and on exit exports the span THREE ways —

  * a row in the per-name event table (same shape tracer.span wrote, plus
    trace_id/span_id/parent_span_id columns), keeping the existing
    `celestia_<name>_seconds` histogram families alive;
  * an OTLP-shaped row in the `spans` table (trace/spans.py), pulled via
    GET /trace_tables/spans or mirrored to $CELESTIA_SPANS_OUT JSONL —
    the whole-block lifecycle tree reconstructs from this one table;
  * optionally one observation on the end-to-end phase histogram
    `celestia_e2e_seconds{phase=...}` (the `e2e=` argument).

$CELESTIA_TRACE=off mutes every export; context PROPAGATION still runs so
explicit threading (mempool-entry contexts, block adoption) never breaks
when tracing is muted.  No device syncs anywhere: spans time host calls
the layers already make.

Cross-NODE propagation (the fleet era): `serialize_context` renders the
active identity as the `x-celestia-trace` header value
(`<32-hex trace_id>-<16-hex span_id>`), and `adopt_context` /
`adopt_or_new` rebuild it on the receiving process — SAME trace_id, fresh
span_id, the sender's span as parent — so a request crossing the wire
stays one trace.  Every root/adopted context stamps a `node_id` baggage
entry (a stable per-process identity, `$CELESTIA_NODE_ID` override) so
merged spans tables attribute each row to its emitting process.
"""

from __future__ import annotations

import os
import re
import socket
import time
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field

#: The one header name every inter-node hop uses (HTTP header, gRPC
#: metadata key, and the gossip envelope's "trace" field all carry the
#: same serialized value).
TRACE_HEADER = "x-celestia-trace"

_NODE_ID: str | None = None
_HEADER_RE = re.compile(r"^([0-9a-f]{32})-([0-9a-f]{16})$")


def node_id() -> str:
    """Stable per-process node identity: `$CELESTIA_NODE_ID` when set,
    else `<hostname>-<pid>` — computed once so every span, flight bundle,
    and fleet row a process emits carries the same value.  Sanitized to
    `[A-Za-z0-9._-]` (it lands in filenames and header values)."""
    global _NODE_ID
    if _NODE_ID is None:
        raw = os.environ.get("CELESTIA_NODE_ID") or (
            f"{socket.gethostname()}-{os.getpid()}"
        )
        _NODE_ID = re.sub(r"[^A-Za-z0-9._-]", "_", raw) or "node"
    return _NODE_ID


def _reset_node_id_for_tests() -> None:
    global _NODE_ID
    _NODE_ID = None


@dataclass(frozen=True)
class TraceContext:
    """Identity + baggage of one request or block trace.

    `trace_id` is stable for the whole tree; each span gets its own
    `span_id` with `parent_id` linking it to its creator.  `baggage`
    carries low-volume attribution (height, round, k, source) copied onto
    every descendant span's attributes.  `start_unix_ns` is the wall
    clock at trace issue — the anchor the e2e `total` phase measures
    from.
    """

    trace_id: str
    span_id: str
    parent_id: str | None = None
    baggage: dict = field(default_factory=dict)
    start_unix_ns: int = 0

    def child(self, **baggage) -> "TraceContext":
        """A child context: same trace, fresh span id, merged baggage."""
        return TraceContext(
            trace_id=self.trace_id,
            span_id=_new_span_id(),
            parent_id=self.span_id,
            baggage={**self.baggage, **baggage},
            start_unix_ns=self.start_unix_ns,
        )


def _new_span_id() -> str:
    return os.urandom(8).hex()


def new_context(**baggage) -> TraceContext:
    """Issue a fresh root context (a new trace_id) — request entry.  The
    issuing process's `node_id` rides the baggage (explicit baggage wins,
    so a per-server identity can override the process default)."""
    return TraceContext(
        trace_id=os.urandom(16).hex(),
        span_id=_new_span_id(),
        baggage={"node_id": node_id(), **baggage},
        start_unix_ns=time.time_ns(),
    )


def serialize_context(ctx: TraceContext | None = None) -> str | None:
    """The wire form of `ctx` (default: the current context) for the
    `x-celestia-trace` header / gRPC metadata / gossip `trace` field:
    `<trace_id>-<span_id>`, or None outside a trace (the hop then carries
    no header and the receiver mints its own root)."""
    ctx = ctx if ctx is not None else current_context()
    if ctx is None:
        return None
    return f"{ctx.trace_id}-{ctx.span_id}"


def adopt_context(header: str | None, **baggage) -> TraceContext | None:
    """Rebuild an incoming wire context: SAME trace_id, fresh span_id,
    the sender's span as parent — the receiving process JOINS the trace
    instead of re-minting it, which is what stitches a multi-node drill
    under one trace_id.  Returns None on an absent or malformed header
    (a bad header must never fail the request — the caller falls back to
    `new_context`).  This process's `node_id` is stamped into baggage
    (explicit baggage wins, for per-server identities in one process)."""
    if not header:
        return None
    m = _HEADER_RE.match(header.strip().lower())
    if m is None:
        return None
    trace_id, parent_span = m.group(1), m.group(2)
    return TraceContext(
        trace_id=trace_id,
        span_id=_new_span_id(),
        parent_id=parent_span,
        baggage={"node_id": node_id(), **baggage},
        start_unix_ns=time.time_ns(),
    )


def adopt_or_new(header: str | None, **baggage) -> TraceContext:
    """Request entry on a serving plane: adopt the peer's context when the
    hop carried one, else issue a fresh root — the ONE pattern every rpc/
    ingress threads (trace_lint rule 7 pins this)."""
    return adopt_context(header, **baggage) or new_context(**baggage)


_CURRENT: ContextVar[TraceContext | None] = ContextVar(
    "celestia_trace_context", default=None
)


def current_context() -> TraceContext | None:
    """The context active on THIS thread/task, or None outside a trace."""
    return _CURRENT.get()


@contextmanager
def use_context(ctx: TraceContext | None):
    """Make `ctx` current for the body — the explicit hand-off point when
    a context crosses a thread boundary (block production adopting a
    mempool entry's context)."""
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


@contextmanager
def trace_span(
    name: str,
    ctx: TraceContext | None = None,
    e2e: str | None = None,
    buckets: tuple[float, ...] | None = None,
    **attrs,
):
    """Measure one span of trace `ctx` (explicit, else the current one,
    else a fresh root).  Yields a mutable attr dict so results discovered
    inside the body (square size, vote power) land on the span.  `e2e`
    names the celestia_e2e_seconds phase this span feeds, if any.
    """
    from celestia_app_tpu_torch.trace.tracer import trace_enabled

    parent = ctx if ctx is not None else current_context()
    child = parent.child() if parent is not None else new_context()
    token = _CURRENT.set(child)
    if not trace_enabled():
        try:
            yield dict(attrs)
        finally:
            _CURRENT.reset(token)
        return
    mutable = dict(attrs)
    start_unix_ns = time.time_ns()
    t0 = time.perf_counter_ns()
    try:
        yield mutable
    finally:
        elapsed_ns = time.perf_counter_ns() - t0
        _CURRENT.reset(token)
        export_span(name, child, start_unix_ns, elapsed_ns, mutable,
                    buckets=buckets, e2e=e2e)


def export_span(name, ctx, start_unix_ns, elapsed_ns, attrs,
                buckets=None, e2e=None) -> None:
    """The span's three exports (event table + histogram + OTLP row) plus
    the optional e2e phase — all off the timed region.  Public for call
    sites that must pick the span's context AFTER the measured work (the
    mempool reap learns which trace it belongs to by doing the reap)."""
    from celestia_app_tpu_torch.trace import spans
    from celestia_app_tpu_torch.trace.metrics import registry
    from celestia_app_tpu_torch.trace.tracer import SPAN_LABEL_ATTRS, traced

    traced().write(
        name,
        duration_ms=elapsed_ns / 1e6,
        trace_id=ctx.trace_id,
        span_id=ctx.span_id,
        parent_span_id=ctx.parent_id,
        **attrs,
    )
    labels = {a: str(attrs[a]) for a in SPAN_LABEL_ATTRS if a in attrs}
    registry().histogram(
        f"celestia_{name}_seconds", f"wall time of {name}",
        **({"buckets": buckets} if buckets else {}),
    ).observe(elapsed_ns / 1e9, **labels)
    spans.record_span(
        name, ctx, start_unix_ns, start_unix_ns + elapsed_ns,
        {**ctx.baggage, **attrs},
    )
    if e2e is not None:
        spans.observe_e2e(
            e2e, elapsed_ns / 1e9, namespace=ctx.baggage.get("namespace")
        )
