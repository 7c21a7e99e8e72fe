"""Height-anatomy timeline: every journal plane stitched per height.

The repo's telemetry planes — the span tree (tx_submit / block_propose /
block_commit / mempool_reap rows from trace/context.export_span), the
block journal (trace/journal.py: upload / stall / dispatch / starve /
drain stage ms), the square journal (occupancy, per-tenant shares), the
round journal (prevote/precommit deltas, WAL fsync, round bumps), the
device ledger's compile bills (`compile_bill` rows, trace/device_ledger),
ForestCache admissions and evictions (`forest_cache` rows, serve/cache),
heal completions, and the serve plane's first-answer events
(serve/api.count_served / `proof_serve` rows) — are individually useful
but siloed: none answers "for height H, where did the time go?".

This module is the stitcher.  A HeightTimeline subscribes to the default
Tracer (Tracer.add_observer, installed lazily the first time traced() is
called) and folds every row carrying a `height=` — or a `trace_id=`
that some other row has already bound to a height — into ONE ordered
per-height record:

  * phase intervals, anchored in wall time: span rows cover
    [ts_ns - duration_ms, ts_ns]; a block-journal stream row is unrolled
    BACKWARDS from its drain-time write into
    intake_wait | upload | upload_stall | dispatch_starve | dispatch |
    drain; round rows contribute prevote/precommit/wal_fsync (their
    propose delta is skipped — the block_propose span already covers
    it); compile bills, forest builds, and heals anchor on their own
    durations.
  * inter-phase GAPS: the explicitly measured queue waits
    (intake_wait / upload_stall / dispatch_starve) plus every implicit
    hole the critical-path walk finds between intervals — a hole
    directly before the propose span is the mempool wait and is named
    `mempool_wait`.
  * the computed critical path: a cursor walk over the sorted intervals
    credits each phase only the wall time it alone covered, so
    overlapping phases (wal_fsync under precommit, serve-plane work
    under drain) never double-bill the height.

A record FINALIZES when the serving plane first answers for its height
(serve/api.count_served -> note_first_serve, or a height-stamped
proof_serve row) or when the ring evicts it; finalization observes the
Prometheus reflections exactly once:

  celestia_height_critical_seconds{phase}   histogram
  celestia_height_gap_seconds{phase}        histogram
  celestia_height_critical_phase{phase}     one-hot gauge (last height)

The ring keeps the last $CELESTIA_TIMELINE_HEIGHTS heights (default 64;
0 disables the observer entirely).  Rows with only a trace_id buffer in
a bounded pending map until some row binds that trace to a height (the
tx_submit -> block_propose adoption), so the submit leg of a block's
trace lands on the height record even though the submit predates the
height assignment.

Surfaces: `timeline_response` (the body of `GET /timeline`: the full
latest record, `?height=` one record, `?tail=N` summaries), the
flight-recorder bundle's `timeline` block, and `fleet_block` (one peer's
block of the fleet view).

Everything here is a pure function of retained row state: no ticks, no
clocks at render time, so two planes asked in any order serve identical
bytes (the /heal pattern).

The port's copy of celestia_app_tpu/trace/timeline.py, whole;
`timeline_response` answers the port's `GET /timeline` (trace/exposition.py)
and `fleet_block` gives each host's block of its /fleet.  The port's
`compile_bill` rows bill a tracked program's first call (the kernel
libraries' load, a first build), which keeps the JAX phase name
`jit_compile`.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict

#: Ring capacity env knob; 0 disables timeline assembly.
HEIGHTS_ENV = "CELESTIA_TIMELINE_HEIGHTS"
DEFAULT_HEIGHTS = 64

#: Bounded stitching state: how many distinct unbound trace_ids may hold
#: pending rows, and how many rows each may hold (a runaway writer must
#: never grow the index unboundedly).
MAX_PENDING_TRACES = 256
MAX_PENDING_ROWS = 64
MAX_BINDINGS = 1024

#: Span-table rows (trace/context.export_span writes one event table per
#: span name) that become phases, and the phase each maps to.
SPAN_PHASES = {
    "tx_submit": "tx_submit",
    "mempool_reap": "mempool_reap",
    "block_propose": "propose",
    "block_commit": "commit",
}

#: An implicit hole found directly before one of these phases is the
#: named wait, not an anonymous gap (the hole between the submit span
#: and the reap/propose span IS the mempool wait).
GAP_ALIASES = {"propose": "mempool_wait", "mempool_reap": "mempool_wait"}

#: block_journal stage fields unrolled backwards from the row's write
#: time (drain end), innermost first: (field, phase, kind).
_STREAM_CHAIN = (
    ("drain_ms", "drain", "phase"),
    ("dispatch_ms", "dispatch", "phase"),
    ("dispatch_starve_ms", "dispatch_starve", "gap"),
    ("upload_stall_ms", "upload_stall", "gap"),
    ("upload_ms", "upload", "phase"),
    ("intake_wait_ms", "intake_wait", "gap"),
)

#: block_journal meta fields copied onto the record (facts, not time).
_JOURNAL_META = ("source", "k", "mode", "compile", "batch_size", "panels",
                 "shards")


def timeline_heights() -> int:
    try:
        return int(os.environ.get(HEIGHTS_ENV, str(DEFAULT_HEIGHTS))
                   or DEFAULT_HEIGHTS)
    except ValueError:
        return DEFAULT_HEIGHTS


def _round3(v: float) -> float:
    return round(float(v), 3)


def _as_height(v) -> int | None:
    """Row/baggage height -> int (baggage adopted off the wire arrives
    stringified; bools are not heights)."""
    if isinstance(v, bool):
        return None
    if isinstance(v, int):
        return v
    if isinstance(v, str) and v.isdigit():
        return int(v)
    return None


class _Record:
    """Mutable per-height assembly state (rendered lazily)."""

    __slots__ = ("height", "intervals", "meta", "trace_ids",
                 "first_serve_ts_ns", "finalized")

    def __init__(self, height: int):
        self.height = height
        # (start_ns, end_ns, phase, kind) with kind phase|gap.
        self.intervals: list[tuple[int, int, str, str]] = []
        self.meta: dict = {}
        self.trace_ids: set[str] = set()
        self.first_serve_ts_ns: int | None = None
        self.finalized = False


def critical_path(intervals) -> tuple[dict[str, float], dict[str, float]]:
    """Cursor walk over (start_ns, end_ns, phase, kind) intervals ->
    ({phase: critical_ms}, {gap: gap_ms}).

    Each interval is credited only the wall time past the cursor, so
    overlapping phases never double-bill; an implicit hole between the
    cursor and the next interval is charged as a gap to the FOLLOWING
    phase (aliased via GAP_ALIASES), unless that interval is itself an
    explicitly measured gap (which already covers the hole)."""
    crit: dict[str, float] = {}
    gaps: dict[str, float] = {}
    cursor: int | None = None
    for start, end, phase, kind in sorted(intervals):
        if cursor is None:
            cursor = start
        if start > cursor:
            name = GAP_ALIASES.get(phase, phase)
            gaps[name] = gaps.get(name, 0.0) + (start - cursor) / 1e6
            cursor = start
        contrib_ns = end - max(start, cursor)
        if contrib_ns > 0:
            bucket = gaps if kind == "gap" else crit
            bucket[phase] = bucket.get(phase, 0.0) + contrib_ns / 1e6
        if end > cursor:
            cursor = end
    return crit, gaps


class HeightTimeline:
    """Bounded ring of per-height records stitched from trace rows."""

    def __init__(self, capacity: int | None = None):
        self.capacity = (
            capacity if capacity is not None else timeline_heights()
        )
        self._lock = threading.Lock()
        self._records: OrderedDict[int, _Record] = OrderedDict()
        # trace_id -> height, learned from any row carrying both.
        self._bindings: OrderedDict[str, int] = OrderedDict()
        # trace_id -> [(table, row)] parked until the trace binds.
        self._pending: OrderedDict[str, list] = OrderedDict()
        # Every phase/gap name ever finalized (the one-hot gauge's span).
        self._phases_seen: set[str] = set()

    # --- ingest -------------------------------------------------------------

    def observe(self, table: str, row: dict) -> None:
        """Tracer observer entry point: fold one written row in.  Cheap
        for rows the timeline does not consume (one dict probe)."""
        if self.capacity <= 0:
            return
        if table not in _EXTRACTORS and table not in SPAN_PHASES:
            return
        height = _as_height(row.get("height"))
        trace_id = row.get("trace_id")
        finalize = None
        with self._lock:
            if height is None:
                height = self._bindings.get(trace_id) if trace_id else None
                if height is None:
                    if isinstance(trace_id, str):
                        self._park(table, row, trace_id)
                    return
            elif isinstance(trace_id, str):
                self._bind(trace_id, height)
            rec, evicted = self._record(height)
            self._fold(rec, table, row)
            if isinstance(trace_id, str):
                flushed = self._pending.pop(trace_id, None)
                if flushed:
                    for ptable, prow in flushed:
                        self._fold(rec, ptable, prow)
            if rec.first_serve_ts_ns is not None and not rec.finalized:
                rec.finalized = True
                finalize = rec
        # Metric observation happens OUTSIDE the lock (registry locks
        # internally; never nest).
        for old in evicted:
            self._observe_metrics(old)
        if finalize is not None:
            self._observe_metrics(finalize)

    def note_first_serve(self, height, plane: str | None = None,
                         kind: str | None = None) -> None:
        """The serve plane answered for `height` (serve/api.count_served).
        First call per retained height stamps the first-serve point and
        finalizes the record; later calls only bump the serve counter."""
        height = _as_height(height)
        if self.capacity <= 0 or height is None:
            return
        import time

        finalize = None
        with self._lock:
            rec = self._records.get(height)
            if rec is None:
                return
            rec.meta["serves"] = rec.meta.get("serves", 0) + 1
            if rec.first_serve_ts_ns is None:
                rec.first_serve_ts_ns = time.time_ns()
                if kind:
                    rec.meta["first_serve_kind"] = kind
                if not rec.finalized:
                    rec.finalized = True
                    finalize = rec
        if finalize is not None:
            self._observe_metrics(finalize)

    # --- internals (caller holds the lock) ----------------------------------

    def _park(self, table: str, row: dict, trace_id: str) -> None:
        rows = self._pending.get(trace_id)
        if rows is None:
            rows = self._pending[trace_id] = []
            while len(self._pending) > MAX_PENDING_TRACES:
                self._pending.popitem(last=False)
        if len(rows) < MAX_PENDING_ROWS:
            rows.append((table, row))

    def _bind(self, trace_id: str, height: int) -> None:
        self._bindings[trace_id] = height
        self._bindings.move_to_end(trace_id)
        while len(self._bindings) > MAX_BINDINGS:
            self._bindings.popitem(last=False)

    def _record(self, height: int) -> tuple[_Record, list]:
        rec = self._records.get(height)
        evicted = []
        if rec is None:
            rec = self._records[height] = _Record(height)
            while len(self._records) > self.capacity:
                _, old = self._records.popitem(last=False)
                if not old.finalized:
                    old.finalized = True
                    evicted.append(old)
        return rec, evicted

    def _fold(self, rec: _Record, table: str, row: dict) -> None:
        trace_id = row.get("trace_id")
        if isinstance(trace_id, str):
            rec.trace_ids.add(trace_id)
        phase = SPAN_PHASES.get(table)
        if phase is not None:
            self._fold_span(rec, phase, row)
            return
        _EXTRACTORS[table](self, rec, row)

    @staticmethod
    def _anchor(rec: _Record, row: dict, duration_ms, phase: str,
                kind: str = "phase") -> None:
        """One interval ending at the row's write time, `duration_ms`
        long (the span / bill / heal shape)."""
        if not isinstance(duration_ms, (int, float)) or duration_ms < 0:
            return
        end = row.get("ts_ns")
        if not isinstance(end, int):
            return
        rec.intervals.append(
            (end - int(duration_ms * 1e6), end, phase, kind)
        )

    def _fold_span(self, rec: _Record, phase: str, row: dict) -> None:
        self._anchor(rec, row, row.get("duration_ms"), phase)

    def _fold_block_journal(self, rec: _Record, row: dict) -> None:
        end = row.get("ts_ns")
        if not isinstance(end, int):
            return
        for field, phase, kind in _STREAM_CHAIN:
            ms = row.get(field)
            if not isinstance(ms, (int, float)) or ms <= 0:
                continue
            start = end - int(ms * 1e6)
            rec.intervals.append((start, end, phase, kind))
            end = start
        for field in _JOURNAL_META:
            if row.get(field) is not None:
                rec.meta[field] = row[field]

    def _fold_square_journal(self, rec: _Record, row: dict) -> None:
        sq = {}
        for field in ("phase", "k", "occupancy", "used_shares",
                      "n_blobs", "n_namespaces"):
            if row.get(field) is not None:
                sq[field] = row[field]
        if sq:
            rec.meta["square"] = sq

    def _fold_round_journal(self, rec: _Record, row: dict) -> None:
        if row.get("result") == "round_bump":
            rec.meta["round_bumps"] = rec.meta.get("round_bumps", 0) + 1
        end = row.get("ts_ns")
        if not isinstance(end, int):
            return
        # propose_ms is skipped: the block_propose span already covers
        # that wall time; double-entering it would double-bill the walk.
        for field, phase in (("precommit_ms", "precommit"),
                             ("prevote_ms", "prevote")):
            ms = row.get(field)
            if not isinstance(ms, (int, float)) or ms <= 0:
                continue
            start = end - int(ms * 1e6)
            rec.intervals.append((start, end, phase, "phase"))
            end = start
        self._anchor(rec, row, row.get("wal_fsync_ms"), "wal_fsync")

    def _fold_compile_bill(self, rec: _Record, row: dict) -> None:
        self._anchor(rec, row, row.get("compile_ms"), "jit_compile")
        bills = rec.meta.setdefault("compile_bills", [])
        if len(bills) < 16:
            bills.append({
                "family": row.get("family"),
                "compile_ms": _round3(row.get("compile_ms") or 0.0),
            })

    def _fold_forest_cache(self, rec: _Record, row: dict) -> None:
        event = row.get("event")
        if event in ("admit", "readmit"):
            self._anchor(rec, row, row.get("forest_build_ms"),
                         "forest_build")
        if isinstance(event, str):
            cache = rec.meta.setdefault("cache", {})
            cache[event] = cache.get(event, 0) + 1

    def _fold_heal(self, rec: _Record, row: dict) -> None:
        self._anchor(rec, row, row.get("total_ms"), "heal")
        rec.meta["heal"] = {
            "kind": row.get("kind"),
            "outcome": row.get("outcome"),
            "attempts": row.get("attempts"),
        }

    def _fold_proof_serve(self, rec: _Record, row: dict) -> None:
        batch = row.get("batch")
        rec.meta["serves"] = rec.meta.get("serves", 0) + (
            batch if isinstance(batch, int) else 1
        )
        # A height-stamped serve row is the serve plane answering: it
        # stamps first-serve even on paths that bypass count_served
        # (direct sampler drives).
        if rec.first_serve_ts_ns is None and isinstance(
                row.get("ts_ns"), int):
            rec.first_serve_ts_ns = row["ts_ns"]

    # --- rendering ----------------------------------------------------------

    def _render(self, rec: _Record, full: bool) -> dict:
        crit, gaps = critical_path(rec.intervals)
        critical_phase = (
            max(sorted(crit), key=lambda p: crit[p]) if crit else None
        )
        first = min((s for s, _e, _p, _k in rec.intervals), default=None)
        last_candidates = [e for _s, e, _p, _k in rec.intervals]
        if rec.first_serve_ts_ns is not None:
            last_candidates.append(rec.first_serve_ts_ns)
        last = max(last_candidates, default=None)
        out = {
            "height": rec.height,
            "critical_phase": critical_phase,
            "critical_ms": _round3(crit.get(critical_phase, 0.0))
            if critical_phase else 0.0,
            "phases": {p: _round3(v) for p, v in sorted(crit.items())},
            "gaps": {p: _round3(v) for p, v in sorted(gaps.items())},
            "span_ms": _round3((last - first) / 1e6)
            if first is not None and last is not None else 0.0,
            "finalized": rec.finalized,
        }
        if not full:
            return out
        out["trace_ids"] = sorted(rec.trace_ids)
        out["meta"] = rec.meta
        out["first_serve_ms"] = (
            _round3((rec.first_serve_ts_ns - first) / 1e6)
            if rec.first_serve_ts_ns is not None and first is not None
            else None
        )
        out["intervals"] = [
            {
                "phase": p,
                "kind": k,
                "start_ms": _round3((s - first) / 1e6),
                "end_ms": _round3((e - first) / 1e6),
            }
            for s, e, p, k in sorted(rec.intervals)
        ] if first is not None else []
        return out

    def record_payload(self, height: int) -> dict | None:
        with self._lock:
            rec = self._records.get(height)
            return self._render(rec, full=True) if rec is not None else None

    def summaries(self, tail: int | None = None) -> list[dict]:
        with self._lock:
            recs = list(self._records.values())
        if tail is not None:
            recs = recs[-tail:] if tail > 0 else []
        return [self._render(r, full=False) for r in recs]

    def index_payload(self) -> dict:
        with self._lock:
            recs = list(self._records.values())
        return {
            "capacity": self.capacity,
            "heights": [r.height for r in recs],
            "latest": self._render(recs[-1], full=True) if recs else None,
        }

    def bundle_block(self, tail: int = 8) -> dict:
        """The flight-recorder / slo_report block: last-`tail` summaries
        plus the latest full record (what phase was critical when the
        page fired)."""
        with self._lock:
            recs = list(self._records.values())
        return {
            "capacity": self.capacity,
            "records": [self._render(r, full=False) for r in recs[-tail:]],
            "latest": self._render(recs[-1], full=True) if recs else None,
        }

    # --- metrics ------------------------------------------------------------

    def _observe_metrics(self, rec: _Record) -> None:
        from celestia_app_tpu_torch.trace.metrics import (
            DEVICE_SECONDS_BUCKETS,
            registry,
        )

        crit, gaps = critical_path(rec.intervals)
        reg = registry()
        crit_hist = reg.histogram(
            "celestia_height_critical_seconds",
            "per-height critical-path wall time, by phase",
            buckets=DEVICE_SECONDS_BUCKETS,
        )
        for phase, ms in sorted(crit.items()):
            crit_hist.observe(ms / 1e3, phase=phase)
        gap_hist = reg.histogram(
            "celestia_height_gap_seconds",
            "per-height inter-phase queue-wait time, by gap",
            buckets=DEVICE_SECONDS_BUCKETS,
        )
        for phase, ms in sorted(gaps.items()):
            gap_hist.observe(ms / 1e3, phase=phase)
        critical_phase = (
            max(sorted(crit), key=lambda p: crit[p]) if crit else None
        )
        with self._lock:
            self._phases_seen.update(crit)
            self._phases_seen.update(gaps)
            phases = sorted(self._phases_seen)
        gauge = reg.gauge(
            "celestia_height_critical_phase",
            "one-hot: which phase was critical for the last finalized "
            "height",
        )
        for phase in phases:
            gauge.set(1.0 if phase == critical_phase else 0.0, phase=phase)


#: table -> fold method (unknown tables cost one failed dict probe).
_EXTRACTORS = {
    "block_journal": HeightTimeline._fold_block_journal,
    "square_journal": HeightTimeline._fold_square_journal,
    "round_journal": HeightTimeline._fold_round_journal,
    "compile_bill": HeightTimeline._fold_compile_bill,
    "forest_cache": HeightTimeline._fold_forest_cache,
    "heal": HeightTimeline._fold_heal,
    "proof_serve": HeightTimeline._fold_proof_serve,
}


# --- process-wide instance ----------------------------------------------------

_TIMELINE: HeightTimeline | None = None
_TL_LOCK = threading.Lock()


def timeline() -> HeightTimeline:
    global _TIMELINE
    tl = _TIMELINE
    if tl is None:
        with _TL_LOCK:
            tl = _TIMELINE
            if tl is None:
                tl = _TIMELINE = HeightTimeline()
    return tl


def install(tracer) -> None:
    """Subscribe the process timeline to `tracer` (idempotent; called
    lazily from trace/tracer.traced())."""
    tracer.add_observer(_observer)


def _observer(table: str, row: dict) -> None:
    timeline().observe(table, row)


def _reset_for_tests(capacity: int | None = None) -> None:
    global _TIMELINE
    with _TL_LOCK:
        _TIMELINE = HeightTimeline(capacity)


# --- exposition -----------------------------------------------------------

def timeline_response(query_params: dict):
    """GET /timeline -> (status, content_type, bytes): the full latest
    record + retained heights without params, one full record with
    ?height=, last-N summaries with ?tail=N — a pure function of
    retained timeline state, byte-identical on every plane."""
    tl = timeline()
    raw_height = query_params.get("height")
    raw_tail = query_params.get("tail")
    if raw_height is not None:
        if raw_height == "latest":
            with tl._lock:
                height = next(reversed(tl._records), None)
            if height is None:
                return 404, "application/json", json.dumps(
                    {"error": "no heights retained yet"}
                ).encode()
        else:
            try:
                height = int(raw_height)
            except ValueError:
                return 400, "application/json", json.dumps(
                    {"error": "height must be an integer or 'latest', "
                              f"got {raw_height!r}"}
                ).encode()
        payload = tl.record_payload(height)
        if payload is None:
            return 404, "application/json", json.dumps(
                {"error": f"no timeline record at height {height}"}
            ).encode()
        return 200, "application/json", _render(payload)
    if raw_tail is not None:
        try:
            tail = int(raw_tail)
        except ValueError:
            tail = -1
        if tail <= 0:
            return 400, "application/json", json.dumps(
                {"error": f"tail must be a positive integer, got {raw_tail!r}"}
            ).encode()
        return 200, "application/json", _render(
            {"timelines": tl.summaries(tail)}
        )
    return 200, "application/json", _render(tl.index_payload())


def _render(payload: dict) -> bytes:
    """Canonical bytes (sorted keys, compact separators) — sorted so the
    per-height meta dict, whose insertion order follows event arrival,
    can never leak arrival order into the byte-identity contract."""
    return json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()


def fleet_block(payload: dict | None) -> dict | None:
    """Fold one peer's GET /timeline payload into the per-host block
    trace/fleet.py merges (None when the peer predates the surface)."""
    if not isinstance(payload, dict):
        return None
    latest = payload.get("latest")
    block = {
        "retained": len(payload.get("heights") or []),
        "latest_height": None,
        "critical_phase": None,
        "span_ms": None,
    }
    if isinstance(latest, dict):
        block["latest_height"] = latest.get("height")
        block["critical_phase"] = latest.get("critical_phase")
        block["span_ms"] = latest.get("span_ms")
    return block
