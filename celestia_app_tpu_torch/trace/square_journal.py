"""Square journal: one row per built square — the data-plane spine.

PR 2 lit the device plane (block_journal) and PR 3 the request plane
(spans); this table answers the remaining multi-tenant questions: who is
filling the square, how much of k*k is padding waste, and which
namespace's blobs are paying the latency.  `square/builder.py` computes
the exact share breakdown during export (`Square.accounting`) and both
entry points (square.build on the proposer, square.construct on every
validator) journal it here, stamped with the block's trace_id so the row
joins the PR 3 span tree.  A proposer therefore records TWO rows per
block (phase=build then phase=construct); counters count exported
squares, not blocks.

Prometheus reflections per row:

    celestia_square_occupancy_ratio{k}            used / k*k of the last square
    celestia_square_padding_shares_total{kind}    reserved | namespace | tail
    celestia_namespace_blobs_total{namespace}     per-tenant blob count
    celestia_namespace_shares_total{namespace}    per-tenant share count
    celestia_namespace_bytes_total{namespace}     per-tenant payload bytes

Namespace label cardinality is BOUNDED by construction: every namespace
label on a metric goes through `capped_namespace_label`, which admits at
most $CELESTIA_NAMESPACE_TOP_N distinct labels per process (biggest
share-count first within a square) and folds everything else into the
reserved `other` bucket.  scripts/trace_lint.py enforces that no other
module puts a namespace label on a metric without routing through this
helper.  The full, uncapped per-namespace breakdown still lands in the
journal ROW (tables tolerate unbounded cardinality; label sets don't).

GET /namespaces (trace/exposition.py, all three planes) serves the
cumulative per-tenant summary + the last square snapshot as JSON, and
`last_square()` feeds /healthz so a stuck-at-empty-blocks node is
distinguishable from a healthy idle one.  Both are process-level views
(a multi-node test process shares them), like the rest of the registry.

The port's copy of celestia_app_tpu/trace/square_journal.py, whole: the
same labels, rows, counters and payloads on the same squares.  The port has
no exposition or lint script yet (ROADMAP, queue 1 item 4), so nothing
serves `namespaces_payload` or `last_square` over HTTP; callers read them
directly.
"""

from __future__ import annotations

import os
import threading

TABLE = "square_journal"

# Always-allowed labels that can never collide with a real namespace
# label (namespace labels are pure hex): the overflow bucket and the
# bucket normal (non-blob) txs account under in the mempool gauges.
OTHER_LABEL = "other"
TX_LABEL = "tx"

_LOCK = threading.Lock()
_ADMITTED: set[str] = set()
_TOTALS: dict[str, list[int]] = {}  # capped label -> [blobs, shares, bytes]
_LAST: dict | None = None  # last recorded square snapshot (for /healthz)


def namespace_top_n() -> int:
    """$CELESTIA_NAMESPACE_TOP_N: max distinct namespace label values per
    process (default 20); everything past the cap folds into `other`."""
    try:
        return max(1, int(os.environ.get("CELESTIA_NAMESPACE_TOP_N", "20")))
    except ValueError:
        return 20


def namespace_label(ns_bytes: bytes) -> str:
    """Deterministic short label for a 29-byte namespace: the full hex
    with leading zeros stripped (injective for fixed-width input)."""
    return ns_bytes.hex().lstrip("0") or "0"


def capped_namespace_label(label: str) -> str:
    """THE cardinality gate: admit up to top-N distinct labels per
    process (first come, first admitted), fold the rest into `other`.
    Reserved buckets pass through without consuming a slot."""
    if label in (OTHER_LABEL, TX_LABEL):
        return label
    with _LOCK:
        if label in _ADMITTED:
            return label
        if len(_ADMITTED) < namespace_top_n():
            _ADMITTED.add(label)
            return label
    return OTHER_LABEL


def tx_namespace_label(raw_tx: bytes) -> str | None:
    """The submitting namespace of a tx: first blob's namespace label for
    a BlobTx, None for a normal tx (or anything unparseable) — what
    BroadcastTx drops into TraceContext baggage."""
    from celestia_app_tpu_torch.tx.envelopes import unmarshal_blob_tx

    try:
        btx = unmarshal_blob_tx(raw_tx)
    except Exception:
        return None
    if btx is None or not btx.blobs:
        return None
    return namespace_label(btx.blobs[0].namespace.to_bytes())


def record(sq, *, phase: str, layout_solves: int | None = None) -> None:
    """Journal one exported square (square/builder.py build/construct).

    Writes the `square_journal` row (share counts summing exactly to
    k*k), refreshes the occupancy gauge, ticks the padding + per-tenant
    counters (capped labels), and updates the /namespaces + /healthz
    snapshots.  `phase` is build (proposer) or construct (validator).
    """
    global _LAST

    acct = sq.accounting
    if acct is None:  # a Square assembled without the builder's export
        return
    from celestia_app_tpu_torch.trace.context import current_context
    from celestia_app_tpu_torch.trace.metrics import registry
    from celestia_app_tpu_torch.trace.tracer import traced

    ctx = current_context()
    height = ctx.baggage.get("height") if ctx is not None else None
    occupancy = round(acct.occupancy, 6)
    # Biggest tenants first: when the admission cap has slots left, they
    # go to the namespaces paying for the most shares in this square.
    by_shares = sorted(acct.namespaces, key=lambda u: -u.shares)
    snapshot = {
        "height": height,
        "k": acct.size,
        "phase": phase,
        "occupancy": occupancy,
        "used_shares": acct.used_shares,
        "padding_shares": acct.padding_shares,
    }

    # The /healthz + /namespaces snapshots sit OUTSIDE the $CELESTIA_TRACE
    # gate (like the profiler hooks): liveness probing must keep working
    # with tracing muted.
    with _LOCK:
        _LAST = snapshot
    labeled: list[tuple[str, object]] = [
        (capped_namespace_label(namespace_label(u.namespace)), u)
        for u in by_shares
    ]
    with _LOCK:
        for lbl, u in labeled:
            agg = _TOTALS.setdefault(lbl, [0, 0, 0])
            agg[0] += u.blobs
            agg[1] += u.shares
            agg[2] += u.data_bytes

    tracer = traced()
    if not tracer._on():
        return
    tracer.write(
        TABLE,
        phase=phase,
        k=acct.size,
        total_shares=acct.total_shares,
        used_shares=acct.used_shares,
        tx_shares=acct.tx_shares,
        pfb_shares=acct.pfb_shares,
        blob_shares=acct.blob_shares,
        reserved_padding=acct.reserved_padding,
        namespace_padding=acct.namespace_padding,
        tail_padding=acct.tail_padding,
        occupancy=occupancy,
        layout_solves=layout_solves,
        n_blobs=sum(u.blobs for u in acct.namespaces),
        n_namespaces=len(acct.namespaces),
        # Full (uncapped) per-tenant breakdown: rows tolerate unbounded
        # cardinality, the label space does not.
        namespaces={
            namespace_label(u.namespace): {
                "blobs": u.blobs, "shares": u.shares, "bytes": u.data_bytes,
            }
            for u in acct.namespaces
        },
        height=height,
        trace_id=ctx.trace_id if ctx is not None else None,
    )

    reg = registry()
    reg.gauge(
        "celestia_square_occupancy_ratio",
        "used/total share ratio of the last built square, by k",
    ).set(occupancy, k=str(acct.size))
    # The UNLABELED twin always holds the latest square regardless of k:
    # the SLO engine judges this one, because a per-k child for a size
    # no longer being built would otherwise pin its stale ratio forever
    # (one near-empty k=2 square during idle must not read as a
    # permanently burning occupancy floor after traffic resumes at k=32).
    reg.gauge(
        "celestia_square_last_occupancy_ratio",
        "used/total share ratio of the most recent exported square "
        "(unlabeled: always the latest, never a stale per-k child)",
    ).set(occupancy)
    pad = reg.counter(
        "celestia_square_padding_shares_total",
        "padding shares in exported squares by kind",
    )
    pad.inc(acct.reserved_padding, kind="reserved")
    pad.inc(acct.namespace_padding, kind="namespace")
    pad.inc(acct.tail_padding, kind="tail")
    blobs_c = reg.counter(
        "celestia_namespace_blobs_total",
        "blobs placed in exported squares per namespace (top-N capped)",
    )
    shares_c = reg.counter(
        "celestia_namespace_shares_total",
        "shares occupied in exported squares per namespace (top-N capped)",
    )
    bytes_c = reg.counter(
        "celestia_namespace_bytes_total",
        "blob payload bytes in exported squares per namespace (top-N capped)",
    )
    for lbl, u in labeled:
        blobs_c.inc(u.blobs, namespace=lbl)
        shares_c.inc(u.shares, namespace=lbl)
        bytes_c.inc(u.data_bytes, namespace=lbl)


def last_square() -> dict | None:
    """The last recorded square's snapshot (height, k, phase, occupancy)
    — the /healthz "is this node building empty blocks?" probe input."""
    with _LOCK:
        return dict(_LAST) if _LAST is not None else None


def namespaces_payload() -> dict:
    """The GET /namespaces JSON: cumulative per-tenant totals (capped
    label space, so the payload is bounded) + the last square snapshot."""
    with _LOCK:
        totals = {
            lbl: {"blobs": b, "shares": s, "bytes": by}
            for lbl, (b, s, by) in sorted(_TOTALS.items())
        }
        last = dict(_LAST) if _LAST is not None else None
        admitted = len(_ADMITTED)
    payload = {
        "top_n": namespace_top_n(),
        "admitted": admitted,
        "namespaces": totals,
        "last_square": last,
    }
    # Enforcement fields (qos.py): per-tenant limits / tokens remaining /
    # throttle counts, present only when a $CELESTIA_QOS policy is
    # installed — the /namespaces page then answers both "who is using
    # the square" AND "who is being held to what".
    from celestia_app_tpu_torch import qos

    enf = qos.enforcer()
    if enf is not None:
        payload["qos"] = enf.health_block()
    return payload


def _reset_for_tests() -> None:
    """Drop the process-level admission set + summaries (test isolation)."""
    global _LAST
    with _LOCK:
        _ADMITTED.clear()
        _TOTALS.clear()
        _LAST = None
