"""Anomaly flight recorder: black-box capture at the moment of failure.

The trace tables are ring buffers: by the time an operator asks "what
happened around the breaker trip three hours ago", the journal rows that
explain it have been evicted.  This module is the aircraft-style black
box: when an anomaly TRIGGER fires —

    breaker_trip      chaos/degrade.py: the device ladder stepped down
    parity_mismatch   da/eds.py: the fused-vs-staged sentinel diverged
    worker_death      parallel/pipeline.py: an uploader/dispatcher died
    wal_salvage       consensus/wal.py: replay dropped a torn tail
    slo_fast_burn     trace/slo.py: an SLO entered fast-burn (a page)
    root_mismatch     da/repair.py: repair rejected an inconsistent
                      survivor set or a square that contradicts its DAH
                      (the wrong-root / malformed-square attack face)
    withholding_detected  serve/sampler.py: a DAS sample hit a withheld
                      share (the data-withholding attack face)
    heal_completed    serve/heal.py: the detect->repair->re-serve loop
                      recovered a height (context carries the per-phase
                      latencies — the moment the node healed itself)
    heal_quarantined  serve/heal.py: a heal exhausted its retry budget
                      or the height is below the k-survivor threshold —
                      the height is quarantined, operator input needed
    fleet_fast_burn   trace/fleet.py: the MERGED cross-host burn rate of
                      an SLO crossed the paging threshold (context
                      carries peers' recent bundle indexes so the fleet
                      bundle points at the per-node black boxes)
    device_residual_growth  trace/device_ledger.py: the unattributed
                      memory residual (measured high-water minus every
                      claimed owner) grew for N consecutive
                      reconciliations — the leak signature

— `note_trigger` atomically dumps one JSON bundle under
$CELESTIA_FLIGHT_DIR: the last-N rows of EVERY trace table, the
degradation/chaos/SLO state, and the /healthz payload, all stamped with
the trigger and its context.  Atomic = write to a dot-tmp file then
os.replace, so a reader (scripts/slo_report.py) never sees a torn
bundle.

Rate-limited per trigger ($CELESTIA_FLIGHT_MIN_INTERVAL_S, default 30s):
a flapping fault produces `celestia_flight_dumps_suppressed_total`
ticks, not unbounded disk writes.  Unset $CELESTIA_FLIGHT_DIR disables
the recorder entirely (the default — tests and embedded uses opt in).

`note_trigger` NEVER raises: it is called from the device dispatch
path, worker-death handlers, and WAL replay — a diagnostic layer that
can take down the thing it is diagnosing is worse than no layer at all.

The port of celestia_app_tpu/trace/flight_recorder.py.  The bundle holds
the sections whose planes the port has: the trace tables, the SLO payload,
the degradation state (`degraded`: chaos.degrade.degraded_state), the chaos
spec, the namespace labels and the device ledger's fresh snapshot
(`device`: trace/device_ledger.snapshot).  Three sections of the JAX bundle
wait for the serving plane (ROADMAP, queue 1 item 4): `healthz`
(trace/exposition.health_payload), `coverage` (serve/api.coverage_snapshot)
and `timeline` (trace/timeline).  `peer_bundle_index` is whole.
"""

from __future__ import annotations

import json
import os
import threading
import time

TRIGGERS = (
    "breaker_trip",
    "parity_mismatch",
    "worker_death",
    "wal_salvage",
    "slo_fast_burn",
    "root_mismatch",
    "withholding_detected",
    "heal_completed",
    "heal_quarantined",
    "fleet_fast_burn",
    "device_residual_growth",
)

#: Hard ceiling on per-table tail rows in a bundle.
MAX_TAIL_ROWS = 2000

_LOCK = threading.Lock()
_LAST_DUMP: dict[str, float] = {}  # trigger -> monotonic time of last dump
_SEQ = 0  # per-process bundle sequence (uniqueness within one ns tick)
#: Recent successful dumps, NOT $CELESTIA_TRACE-gated (the gated
#: flight_dump trace row vanishes when tracing is muted, but a dump that
#: happened must stay observable — drills measure time-to-detection from
#: this log).  Bounded; oldest evicted.
_RECENT: list[dict] = []
_RECENT_MAX = 256


def flight_dir() -> str | None:
    """$CELESTIA_FLIGHT_DIR: bundle directory (unset = recorder off)."""
    return os.environ.get("CELESTIA_FLIGHT_DIR") or None


def min_interval_s() -> float:
    """$CELESTIA_FLIGHT_MIN_INTERVAL_S: per-trigger dump rate limit
    (default 30s; 0 disables suppression — test/drill setting)."""
    try:
        return max(0.0, float(
            os.environ.get("CELESTIA_FLIGHT_MIN_INTERVAL_S", "") or 30.0
        ))
    except ValueError:
        return 30.0


def tail_rows() -> int:
    """$CELESTIA_FLIGHT_TAIL: rows captured per trace table (default
    200, capped at MAX_TAIL_ROWS)."""
    try:
        n = int(os.environ.get("CELESTIA_FLIGHT_TAIL", "") or 200)
    except ValueError:
        return 200
    return max(1, min(n, MAX_TAIL_ROWS))


def _dumps_counter():
    from celestia_app_tpu_torch.trace.metrics import registry

    return registry().counter(
        "celestia_flight_dumps_total",
        "flight-recorder bundles written, by trigger",
    )


def _suppressed_counter():
    from celestia_app_tpu_torch.trace.metrics import registry

    return registry().counter(
        "celestia_flight_dumps_suppressed_total",
        "flight dumps suppressed by the per-trigger rate limit "
        "(a flapping fault must not fill the disk)",
    )


def _failed_counter():
    from celestia_app_tpu_torch.trace.metrics import registry

    return registry().counter(
        "celestia_flight_dumps_failed_total",
        "flight dump attempts that failed to capture or write",
    )


def note_trigger(trigger: str, **context) -> str | None:
    """Capture one bundle for `trigger`; returns the bundle path, or
    None when the recorder is disabled, the trigger is rate-limited, or
    the capture failed.  Never raises (see module docstring)."""
    try:
        return _note_trigger(trigger, context)
    except Exception:
        # A diagnostic layer must never take down the layer it watches.
        try:
            _failed_counter().inc(trigger=trigger)
        except Exception:
            pass
        return None


def _note_trigger(trigger: str, context: dict) -> str | None:
    global _SEQ

    out_dir = flight_dir()
    if out_dir is None:
        return None
    now = time.monotonic()
    with _LOCK:
        last = _LAST_DUMP.get(trigger)
        interval = min_interval_s()
        if last is not None and interval > 0 and now - last < interval:
            _SEQ += 1  # keep filenames unique even across suppression
            suppressed = True
        else:
            # Claim the slot now (concurrent callers of the same trigger
            # suppress against it) ...
            _LAST_DUMP[trigger] = now
            _SEQ += 1
            seq = _SEQ
            suppressed = False
    if suppressed:
        _suppressed_counter().inc(trigger=trigger)
        return None
    try:
        bundle = capture(trigger, context)
        os.makedirs(out_dir, exist_ok=True)
        ts_ns = bundle["captured_unix_ns"]
        # node_id in the name: N nodes of one drill share a
        # $CELESTIA_FLIGHT_DIR without colliding, and peer_bundle_index
        # attributes bundles by filename alone.  ts_ns and seq stay the
        # LAST two fields (slo_report sorts on split("-")[-2]).
        name = f"flight-{trigger}-{bundle['node_id']}-{ts_ns}-{seq}.json"
        tmp = os.path.join(out_dir, f".tmp-{name}")
        path = os.path.join(out_dir, name)
        with open(tmp, "w", encoding="utf-8") as f:
            # default=repr: one exotic value in a trace row must not
            # cost the whole bundle.
            json.dump(bundle, f, sort_keys=True, default=repr)
            f.write("\n")
        os.replace(tmp, path)  # atomic: readers never see a torn bundle
    except Exception:
        # ... but release it on failure: a transient disk fault must not
        # silently consume the trigger's budget with no bundle on disk —
        # the NEXT firing should retry, not be suppressed.
        with _LOCK:
            if _LAST_DUMP.get(trigger) == now:
                if last is None:
                    _LAST_DUMP.pop(trigger, None)
                else:
                    _LAST_DUMP[trigger] = last
        raise
    _dumps_counter().inc(trigger=trigger)
    with _LOCK:
        _RECENT.append(
            {"trigger": trigger, "path": path, "ts_ns": ts_ns}
        )
        del _RECENT[:-_RECENT_MAX]
    from celestia_app_tpu_torch.trace.tracer import traced

    traced().write("flight_dump", trigger=trigger, path=path, **{
        k: v for k, v in context.items() if isinstance(v, (str, int, float))
    })
    return path


def recent_dumps(since_ns: int = 0, trigger: str | None = None) -> list[dict]:
    """Successful dumps at/after `since_ns` (unix ns), oldest first,
    optionally filtered by trigger.  Unlike the `flight_dump` trace row
    this log ignores $CELESTIA_TRACE — a bundle that was written is a
    fact about the disk, not about tracing."""
    with _LOCK:
        return [
            dict(d) for d in _RECENT
            if d["ts_ns"] >= since_ns
            and (trigger is None or d["trigger"] == trigger)
        ]


def capture(trigger: str, context: dict | None = None) -> dict:
    """Assemble the bundle dict (separated from the write so tests can
    inspect the capture shape without touching disk)."""
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.chaos.degrade import degraded_state
    from celestia_app_tpu_torch.trace import slo, square_journal
    from celestia_app_tpu_torch.trace.context import node_id
    from celestia_app_tpu_torch.trace.device_ledger import snapshot as device_snapshot
    from celestia_app_tpu_torch.trace.tracer import traced

    tracer = traced()
    n = tail_rows()
    tables = {name: tracer.tail(name, n) for name in tracer.tables()}
    inj = chaos.injector()
    return {
        "trigger": trigger,
        "context": _jsonable(context or {}),
        "captured_unix_ns": time.time_ns(),
        "pid": os.getpid(),
        "node_id": node_id(),
        "slo": slo.engine().payload(),
        "degraded": degraded_state(),
        "chaos_spec": getattr(inj, "raw", "") if inj is not None else "",
        "namespaces": square_journal.namespaces_payload(),
        # The device-attribution ledger: what was built and resident and
        # who owned the bytes at the moment of failure — a FRESH snapshot.
        "device": device_snapshot(),
        "tail_rows": n,
        "tables": tables,
    }


def _jsonable(obj):
    """Best-effort JSON-safe view of trigger context (exception reprs,
    numpy scalars, arbitrary tags)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def peer_bundle_index(limit_per_node: int = 8) -> dict:
    """Recent bundles OTHER nodes dropped in this process's
    $CELESTIA_FLIGHT_DIR, grouped by the node_id parsed from the
    filename (`flight-<trigger>-<node_id>-<ts_ns>-<seq>.json`) — in a
    local multi-node drill all nodes share one dir, so a fleet
    fast-burn bundle can point at every peer's own black box without a
    network fetch.  Newest `limit_per_node` per node; never raises
    (unreadable dir -> empty index)."""
    from celestia_app_tpu_torch.trace.context import node_id as own_node_id

    out_dir = flight_dir()
    if out_dir is None:
        return {}
    own = own_node_id()
    by_node: dict[str, list] = {}
    try:
        names = sorted(os.listdir(out_dir))
    except OSError:
        return {}
    for name in names:
        if not (name.startswith("flight-") and name.endswith(".json")):
            continue
        parts = name[:-len(".json")].split("-")
        # flight / trigger / node_id (may itself contain dashes) / ts / seq
        if len(parts) < 5:
            continue  # pre-node_id bundle name: no node to attribute
        node, ts_raw = "-".join(parts[2:-2]), parts[-2]
        if not ts_raw.isdigit() or node == own:
            continue
        by_node.setdefault(node, []).append(
            {"name": name, "trigger": parts[1], "ts_ns": int(ts_raw)}
        )
    return {
        node: sorted(dumps, key=lambda d: d["ts_ns"])[-limit_per_node:]
        for node, dumps in sorted(by_node.items())
    }


def _reset_for_tests() -> None:
    """Drop the per-trigger rate-limit clocks + the recent-dump log
    (test isolation)."""
    with _LOCK:
        _LAST_DUMP.clear()
        _RECENT.clear()
