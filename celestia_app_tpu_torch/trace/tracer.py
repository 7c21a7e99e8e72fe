"""Columnar event tracing (the pkg/trace + telemetry analog).

Parity with the reference's two tracing mechanisms (SURVEY §5): sdk
telemetry.MeasureSince around the ABCI hot methods
(app/prepare_proposal.go:23, app/process_proposal.go:25) and celestia-core
pkg/trace's columnar event tables written node-side and pulled for analysis.

Here both collapse into one in-process Tracer: named event tables holding
homogeneous dict rows, with a `span` context manager for wall-time
measurements (device kernel timings from jax block_until_ready land in the
same tables).  Export is JSONL per table, the same shape the reference's
table puller consumes (test/e2e/testnet/node.go:52-74); the serving planes
expose it live on GET /trace_tables (trace/exposition.py).

The tracer is written to from the block pipeline's uploader/dispatcher
threads concurrently with serving-plane readers, so every table mutation
holds `_lock`; buffer eviction is counted in the Prometheus counter
`celestia_trace_rows_dropped` instead of disappearing silently.

$CELESTIA_TRACE=off gates the whole layer: writes and span observations
become no-ops (span still times nothing into the registry), so a latency
bisection can rule tracing out without a rebuild.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

from celestia_app_tpu_torch.trace.metrics import registry

# Span attrs in this set also become Prometheus labels on the span's
# histogram (bounded cardinality by construction: square sizes, pipeline
# modes, phases).  Everything else — heights, tags, counts — lands only in
# the event table, where unbounded cardinality is just another column.
SPAN_LABEL_ATTRS = ("k", "mode", "phase", "result", "construction", "source")


def trace_enabled() -> bool:
    """The $CELESTIA_TRACE gate (default on; "off"/"0" disables)."""
    return os.environ.get("CELESTIA_TRACE", "on") not in ("off", "0")


class Tracer:
    def __init__(self, buffer_size: int = 10_000, env_gated: bool = True):
        self.buffer_size = buffer_size
        self._tables: dict[str, list[dict]] = {}
        self._lock = threading.Lock()
        self.enabled = True
        # env_gated=False opts a PRIVATE tracer out of $CELESTIA_TRACE:
        # an explicitly requested artifact (bench --metrics-out) must not
        # come back empty because the operator muted the global layer.
        self.env_gated = env_gated

    def _on(self) -> bool:
        return self.enabled and (not self.env_gated or trace_enabled())

    def write(self, table: str, **row) -> None:
        if not self._on():
            return
        # Every row says WHICH node wrote it: in a shared-artifact
        # multi-node drill (one $CELESTIA_FLIGHT_DIR, merged table pulls)
        # provenance must ride the row, not the transport.  Lazy import:
        # context.py imports from this module.
        from celestia_app_tpu_torch.trace.context import node_id

        dropped = 0
        with self._lock:
            rows = self._tables.setdefault(table, [])
            rows.append({"ts_ns": time.time_ns(), "node_id": node_id(), **row})
            if len(rows) > self.buffer_size:
                dropped = len(rows) - self.buffer_size
                del rows[:dropped]
        if dropped:
            registry().counter(
                "celestia_trace_rows_dropped",
                "trace table rows evicted by the ring buffer",
            ).inc(dropped, table=table)

    @contextmanager
    def span(self, table: str, *, buckets: tuple[float, ...] | None = None,
             **attrs):
        """Measure a wall-time span into `table` (MeasureSince analog); the
        same measurement lands on the Prometheus histogram
        celestia_<table>_seconds, with the low-cardinality attrs
        (SPAN_LABEL_ATTRS, e.g. k=...) as labels.  Device-scale call sites
        pass an explicit `buckets` tuple (metrics.DEVICE_SECONDS_BUCKETS);
        the histogram lookup happens on entry, off the timed region and out
        of the finally block.
        """
        if not self._on():
            yield
            return
        hist = registry().histogram(
            f"celestia_{table}_seconds", f"wall time of {table}",
            **({"buckets": buckets} if buckets else {}),
        )
        labels = {a: str(attrs[a]) for a in SPAN_LABEL_ATTRS if a in attrs}
        start = time.perf_counter_ns()
        try:
            yield
        finally:
            elapsed_ns = time.perf_counter_ns() - start
            self.write(table, duration_ms=elapsed_ns / 1e6, **attrs)
            hist.observe(elapsed_ns / 1e9, **labels)

    def table(self, name: str) -> list[dict]:
        with self._lock:
            return list(self._tables.get(name, []))

    def tables(self) -> list[str]:
        with self._lock:
            return sorted(self._tables)

    def row_counts(self) -> dict[str, int]:
        """{table: row count} in one lock acquisition, no row copies (the
        /trace_tables listing's accessor)."""
        with self._lock:
            return {name: len(rows) for name, rows in sorted(self._tables.items())}

    def tail(self, name: str, n: int) -> list[dict]:
        """The last `n` rows of a table (row copies) — what the flight
        recorder bundles and /trace_tables/<name>?tail=N serves."""
        if n <= 0:
            return []
        with self._lock:
            rows = self._tables.get(name, [])
            return list(rows[-n:])

    def export_jsonl(self, name: str, tail: int | None = None) -> str:
        # Delegate the tail slice so the two accessors cannot diverge
        # (tail=0 means zero rows, never the whole ring).
        if tail is None:
            with self._lock:
                rows = list(self._tables.get(name, []))
        else:
            rows = self.tail(name, tail)
        return "\n".join(json.dumps(r) for r in rows)

    def clear(self) -> None:
        with self._lock:
            self._tables.clear()


# Process-wide default tracer (the node wires its own when needed).
_default = Tracer()


def traced() -> Tracer:
    return _default
