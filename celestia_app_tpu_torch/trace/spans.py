"""OTLP-shaped span export + the end-to-end phase histogram.

Every finished `trace_span` (trace/context.py) lands here as one row in
the `spans` tracer table, shaped like an OTLP JSON span (camelCase ids,
stringified unix-nano timestamps, attributes as {key, value} pairs) so
standard trace tooling can ingest the JSONL verbatim:

    GET /trace_tables/spans          the live ring buffer, JSONL
    $CELESTIA_SPANS_OUT=<dir>        mirror every span to
                                     <dir>/spans-<pid>.jsonl as it closes

Filtering the table on `traceId` reconstructs one request/block tree:
submit -> mempool insert -> (wait) -> reap -> square build -> fused
dispatch -> DAH -> propose -> prevotes -> precommits -> commit.

`celestia_e2e_seconds{phase=...}` is the SLO face of the same data: each
lifecycle phase (submit, mempool_wait, reap, square_build, dispatch,
propose, prevote, precommit, commit, total) observes once per event onto
a single histogram family with request-scale buckets.

The file mirror never throws into a serving plane: the first write
failure disarms it for the process (the in-memory table keeps working).
"""

from __future__ import annotations

import json
import os
import threading

SPANS_TABLE = "spans"

# Request-scale buckets: sub-ms device spans up through multi-second
# consensus rounds and a mempool wait that spans several blocks.
E2E_SECONDS_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 15.0, 60.0,
)

# Phases that measure ONE request's own lifecycle and may therefore carry
# its namespace label.  Block-scoped phases (reap, square_build, dispatch,
# propose, ..., commit) run under the adopting block's context, whose
# baggage still holds the FIRST reaped tx's namespace — labeling them
# would bill whole-block time to whichever tenant reaped first and
# fragment the phase series by reap order, so the label is dropped here,
# at the single emission point, regardless of what baggage says.
E2E_TENANT_PHASES = frozenset({"submit", "mempool_wait", "total"})

_FILE_LOCK = threading.Lock()
_FILE_HANDLE = None
_FILE_DIR = None
_FILE_BROKEN = False


def spans_out_dir() -> str | None:
    """$CELESTIA_SPANS_OUT: directory for the JSONL span mirror (None =
    in-memory table only)."""
    return os.environ.get("CELESTIA_SPANS_OUT") or None


def record_span(
    name: str,
    ctx,
    start_unix_ns: int,
    end_unix_ns: int,
    attributes: dict,
) -> None:
    """Export one finished span: OTLP-shaped row into the spans table,
    plus the env-gated JSONL mirror."""
    from celestia_app_tpu_torch.trace.tracer import traced

    row = {
        "name": name,
        "traceId": ctx.trace_id,
        "spanId": ctx.span_id,
        "parentSpanId": ctx.parent_id or "",
        "startTimeUnixNano": str(start_unix_ns),
        "endTimeUnixNano": str(end_unix_ns),
        "attributes": [
            {"key": k, "value": {"stringValue": str(v)}}
            for k, v in sorted(attributes.items())
            if v is not None
        ],
    }
    traced().write(SPANS_TABLE, **row)
    _mirror_to_file(row)


def observe_e2e(phase: str, seconds: float, namespace: str | None = None) -> None:
    """One observation on the end-to-end lifecycle histogram.  `namespace`
    (the submitting namespace from TraceContext baggage, when the request
    carried a blob) adds the per-tenant view on the request-scoped phases
    (E2E_TENANT_PHASES) — routed through the top-N cardinality cap
    (trace/square_journal.py) before it becomes a label."""
    from celestia_app_tpu_torch.trace.metrics import registry
    from celestia_app_tpu_torch.trace.tracer import trace_enabled

    if not trace_enabled():
        return
    labels = {"phase": phase}
    if namespace is not None and phase in E2E_TENANT_PHASES:
        from celestia_app_tpu_torch.trace.square_journal import capped_namespace_label

        labels["namespace"] = capped_namespace_label(namespace)
    registry().histogram(
        "celestia_e2e_seconds",
        "end-to-end block/request lifecycle time by phase",
        buckets=E2E_SECONDS_BUCKETS,
    ).observe(seconds, **labels)


def _mirror_to_file(row: dict) -> None:
    global _FILE_HANDLE, _FILE_DIR, _FILE_BROKEN

    out_dir = spans_out_dir()
    if out_dir is None or _FILE_BROKEN:
        return
    try:
        line = json.dumps(row) + "\n"
        with _FILE_LOCK:
            if _FILE_HANDLE is None or _FILE_DIR != out_dir:
                os.makedirs(out_dir, exist_ok=True)
                if _FILE_HANDLE is not None:
                    _FILE_HANDLE.close()
                _FILE_HANDLE = open(
                    os.path.join(out_dir, f"spans-{os.getpid()}.jsonl"), "a"
                )
                _FILE_DIR = out_dir
            _FILE_HANDLE.write(line)
            _FILE_HANDLE.flush()
    except OSError:
        # Disk faults must never reach a serving plane; the in-memory
        # table is the durable-enough copy.
        _FILE_BROKEN = True


def span_attributes(row: dict) -> dict:
    """{key: stringValue} view of an OTLP-shaped span row (the test /
    analysis convenience for the attributes list)."""
    return {
        a["key"]: a["value"]["stringValue"]
        for a in row.get("attributes", [])
    }
