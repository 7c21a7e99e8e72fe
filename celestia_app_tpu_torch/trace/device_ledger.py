"""Device-attribution ledger: who owns the card, pipeline by pipeline.

The port of celestia_app_tpu/trace/device_ledger.py, in its two halves:

PROGRAM LEDGER — every pipeline cache of the block path (da/eds, da/repair,
kernels/fused, kernels/panel, kernels/panel_sharded) wraps its freshly
built callable with `track(fn, family, **key)`.  Per program key (family,
k, construction, mode, batch, shards) the ledger records:

    compile_s          host seconds of the FIRST call.  The port compiles
                       nothing ahead: a first call pays the pipeline's
                       first launches, which load (and, on a fresh
                       checkout, nvcc-build: kernels/_build.py) every
                       kernel library they reach, carry the generator to
                       the card, and run once; the JAX field name is kept
    dispatches         total calls through the wrapper
    dispatch_s         cumulative host seconds of every later call (the
                       launches are asynchronous: this is enqueue time)
    last_dispatch_age  seconds since the program last ran (at snapshot)
    resident           whether the builder cache still holds the callable
                       (a weakref: an evicted entry keeps its counters)

The clock is `_CLOCK` (time.perf_counter), a module attribute so a test
can step it instead of depending on its resolution.

OWNERSHIP LEDGER — the big resident-bytes holders report the bytes they
own, either through a live `register_owner(name, callback)` (the mempool's
shards, the stream's buffer rings, the parked speculation, repair's
recover matrices) or by `note_owned_bytes(owner, key, nbytes)` at
allocation time (the generator tensors of kernels/rs, the panel and
sharded-panel generator slices).  `reconcile()` sums them and sets the sum
against the measured high-water: on the card the caching allocator's peak,
`torch.cuda.memory_stats(device)["allocated_bytes.all.peak"]` (source
"device_memory_stats", the JAX name); for device="cpu" the process peak
RSS (source "rss_high_water").  The slack nobody claims is the
unattributed residual; a residual that GROWS for
`$CELESTIA_DEVICE_LEAK_TICKS` consecutive reconciliations is the leak
signature and fires the `device_residual_growth` flight trigger.

Exposition:

    celestia_jit_programs_resident{family}        gauge
    celestia_jit_compile_seconds_total{family}    counter
    celestia_dispatch_seconds_total{family,k,mode} counter
    celestia_device_bytes{owner}                  gauge (+ the
                                                  unattributed_residual
                                                  pseudo-owner)

    GET /device                                   ledger table + ownership
                                                  + applied seats + warmup
                                                  state (`device_response`,
                                                  trace/exposition.py),
                                                  merged into /fleet

`device_payload()` is the canonical JSON of `snapshot()`, refreshed at
most once per `$CELESTIA_DEVICE_TICK_S` (default 0 = every call), and
`$CELESTIA_DEVICE_SNAPSHOT=<path>` dumps one snapshot at process exit.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
import weakref

__all__ = [
    "track",
    "register_owner",
    "unregister_owner",
    "note_owned_bytes",
    "forget_owned_bytes",
    "note_warmup",
    "reconcile",
    "snapshot",
    "device_payload",
    "device_response",
    "_reset_for_tests",
]

#: The ledger's clock: first-call and dispatch seconds are differences of
#: it.  A module attribute, so tests can replace it with a stepped clock.
_CLOCK = time.perf_counter

_LOCK = threading.Lock()

#: program key -> mutable stats record (see _program_row for the shape).
_PROGRAMS: dict[tuple, dict] = {}

#: owner name -> zero-arg callable returning currently owned bytes.
_OWNER_CALLBACKS: dict[str, object] = {}

#: owner name -> {key: nbytes} for allocation-time accounting
#: (note_owned_bytes) where no live object can answer a callback.
_OWNED_KEYED: dict[str, dict] = {}

#: owners ever published, so an evicted owner's gauge re-zeros instead
#: of serving its last value forever.
_PUBLISHED_OWNERS: set[str] = set()

#: warmup notes: (k, construction, mode) -> unix seconds of the warmup.
_WARMED: dict[tuple, float] = {}

#: consecutive reconciliations where the unattributed residual grew.
_RESIDUAL_STREAK = 0
_LAST_RESIDUAL: int | None = None

_TICK_LOCK = threading.Lock()
_LAST_TICK: float | None = None
_CACHED_BODY: bytes | None = None


class _TriggerGuard(threading.local):
    busy = False


_IN_TRIGGER = _TriggerGuard()

_SNAPSHOT_HOOKED = False


def _dispatch_seconds_counter():
    from celestia_app_tpu_torch.trace.metrics import registry

    return registry().counter(
        "celestia_dispatch_seconds_total",
        "cumulative host wall-seconds spent dispatching jitted programs, "
        "by family/k/mode (first dispatch excluded: that is the compile)",
    )


def _compile_seconds_counter():
    from celestia_app_tpu_torch.trace.metrics import registry

    return registry().counter(
        "celestia_jit_compile_seconds_total",
        "wall-seconds of first dispatches (trace+compile bill), by family",
    )


def _resident_gauge():
    from celestia_app_tpu_torch.trace.metrics import registry

    return registry().gauge(
        "celestia_jit_programs_resident",
        "jit programs still held by their builder caches, by family "
        "(bounded caches evict; evicted programs keep their counters "
        "but stop counting here)",
    )


def _device_bytes_gauge():
    from celestia_app_tpu_torch.trace.metrics import registry

    return registry().gauge(
        "celestia_device_bytes",
        "resident bytes by owner, reconciled against the measured "
        "high-water (owner=unattributed_residual is the slack nobody "
        "claims — its sustained growth is the leak trigger)",
    )


def leak_ticks() -> int:
    """$CELESTIA_DEVICE_LEAK_TICKS: consecutive residual-growth
    reconciliations before the flight trigger fires (default 3)."""
    try:
        return max(2, int(os.environ.get("CELESTIA_DEVICE_LEAK_TICKS", "") or 3))
    except ValueError:
        return 3


def _key(family: str, k, construction, mode, batch, shards) -> tuple:
    return (
        str(family),
        int(k) if k is not None else 0,
        str(construction or ""),
        str(mode or ""),
        int(batch) if batch is not None else 0,
        int(shards) if shards is not None else 0,
    )


class _Tracked:
    """The wrapper a builder cache holds instead of the bare pipeline.

    The first call bills compile_s; every later call accumulates
    dispatches/dispatch_s.  Attribute access falls through to the wrapped
    callable, so callers cannot tell they hold the wrapper — except that
    the ledger can weakref THIS object to observe builder-cache eviction."""

    __slots__ = ("_fn", "_rec", "__weakref__")

    def __init__(self, fn, rec: dict):
        self._fn = fn
        self._rec = rec

    def __call__(self, *args, **kwargs):
        rec = self._rec
        t0 = _CLOCK()
        out = self._fn(*args, **kwargs)
        dt = _CLOCK() - t0
        with _LOCK:
            first = rec["dispatches"] == 0 and rec["compile_s"] == 0.0
            if first:
                rec["compile_s"] = dt
            else:
                rec["dispatch_s"] += dt
            rec["dispatches"] += 1
            rec["last_dispatch_unix"] = time.time()
        if first:
            _compile_seconds_counter().inc(dt, family=rec["family"])
            # The first-call bill as a TRACE ROW, stamped with whatever
            # block or request context paid it.
            from celestia_app_tpu_torch.trace.context import current_context
            from celestia_app_tpu_torch.trace.tracer import traced

            ctx = current_context()
            traced().write(
                "compile_bill", family=rec["family"], k=rec["k"],
                mode=rec["mode"], compile_ms=dt * 1e3,
                trace_id=ctx.trace_id if ctx is not None else None,
                height=ctx.baggage.get("height") if ctx is not None else None,
            )
        else:
            _dispatch_seconds_counter().inc(
                dt, family=rec["family"], k=str(rec["k"]), mode=rec["mode"]
            )
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)


def track(fn, family: str, *, k=None, construction=None, mode=None,
          batch=None, shards=None):
    """Register a freshly built pipeline under (family, k, construction,
    mode, batch, shards) and return the tracked wrapper the builder cache
    should hold.  Called from cache-MISSED builder bodies (beside
    trace/journal.note_jit_build), so cache hits cost nothing.  Rebuilding
    an evicted key revives the same stats record."""
    key = _key(family, k, construction, mode, batch, shards)
    with _LOCK:
        rec = _PROGRAMS.get(key)
        if rec is None:
            rec = _PROGRAMS[key] = {
                "family": key[0],
                "k": key[1],
                "construction": key[2],
                "mode": key[3],
                "batch": key[4],
                "shards": key[5],
                "compile_s": 0.0,
                "dispatches": 0,
                "dispatch_s": 0.0,
                "last_dispatch_unix": None,
                "builds": 0,
                "ref": None,
            }
        rec["builds"] += 1
    wrapper = _Tracked(fn, rec)
    with _LOCK:
        rec["ref"] = weakref.ref(wrapper)
    _hook_snapshot_dump()
    return wrapper


def register_owner(name: str, callback) -> None:
    """Mount `callback()` -> currently-owned bytes under `name` in the
    ownership ledger.  Last registration per name wins; a callback that
    raises reports 0 for that reconciliation."""
    with _LOCK:
        _OWNER_CALLBACKS[str(name)] = callback
    _hook_snapshot_dump()


def unregister_owner(name: str) -> None:
    with _LOCK:
        _OWNER_CALLBACKS.pop(str(name), None)


def note_owned_bytes(owner: str, key, nbytes: int) -> None:
    """Allocation-time accounting for caches with no natural callback
    object: record that `owner` holds `nbytes` under `key`; re-noting a key
    replaces its figure.  Unbounded caches never call forget_owned_bytes:
    their bytes really are resident for good."""
    with _LOCK:
        _OWNED_KEYED.setdefault(str(owner), {})[key] = max(0, int(nbytes))
    _hook_snapshot_dump()


def forget_owned_bytes(owner: str, key=None) -> None:
    """Drop one key's figure (or the whole owner with key=None) — the
    eviction half of note_owned_bytes."""
    with _LOCK:
        if key is None:
            _OWNED_KEYED.pop(str(owner), None)
        else:
            _OWNED_KEYED.get(str(owner), {}).pop(key, None)


def note_warmup(k: int, construction: str, mode: str) -> None:
    """Record that da/eds.warmup pre-built (k, construction, mode): which
    pipeline shapes were paid for up front."""
    with _LOCK:
        _WARMED[(int(k), str(construction), str(mode))] = time.time()


def _measured_bytes(device=None) -> tuple[int, str]:
    """(high-water bytes, source) of `device`: on a CUDA device the
    caching allocator's peak from torch.cuda.memory_stats (source
    "device_memory_stats"), on "cpu" the process peak RSS (source
    "rss_high_water").  None is the card when the process has one and has
    used it, else the CPU: the ledger measures what the process holds and
    never creates a CUDA context to do so."""
    import torch

    if device is None:
        device = ("cuda" if torch.cuda.is_available() and torch.cuda.is_initialized()
                  else "cpu")
    dev = torch.device(device)
    if dev.type == "cuda":
        try:
            stats = torch.cuda.memory_stats(dev)
        except Exception:  # noqa: BLE001 — no card behind the name
            return 0, "unavailable"
        return int(stats.get("allocated_bytes.all.peak", 0)), "device_memory_stats"
    from celestia_app_tpu_torch.trace.profiler import rss_high_water

    rss = rss_high_water()
    if rss is not None:
        return int(rss), "rss_high_water"
    return 0, "unavailable"


def reconcile(device=None) -> dict:
    """One ownership-ledger tick: collect every owner's bytes, measure
    `device`'s high-water (_measured_bytes), publish
    `celestia_device_bytes{owner}` (re-zeroing owners that vanished),
    compute the unattributed residual, and track its growth streak —
    firing the `device_residual_growth` flight trigger when the streak
    reaches leak_ticks()."""
    global _RESIDUAL_STREAK, _LAST_RESIDUAL
    with _LOCK:
        callbacks = dict(_OWNER_CALLBACKS)
        keyed = {o: sum(d.values()) for o, d in _OWNED_KEYED.items()}
    owners: dict[str, int] = {}
    for name, cb in callbacks.items():
        try:
            owners[name] = max(0, int(cb()))
        except Exception:  # noqa: BLE001 — one bad owner must not hide the rest
            owners[name] = 0
    for name, total in keyed.items():
        owners[name] = owners.get(name, 0) + total
    owned_total = sum(owners.values())
    measured, source = _measured_bytes(device)
    residual = max(0, measured - owned_total)

    gauge = _device_bytes_gauge()
    with _LOCK:
        stale = _PUBLISHED_OWNERS - set(owners)
        _PUBLISHED_OWNERS.update(owners)
        _PUBLISHED_OWNERS.add("unattributed_residual")
    for name in stale:
        if name != "unattributed_residual":
            gauge.set(0, owner=name)
    for name, val in owners.items():
        gauge.set(val, owner=name)
    gauge.set(residual, owner="unattributed_residual")

    with _LOCK:
        if _IN_TRIGGER.busy:
            # The bundle's own embedded snapshot reconciles for the
            # numbers, not the accounting: advancing the streak here would
            # let the capture re-prime the episode it is documenting.
            streak = _RESIDUAL_STREAK
            fire = False
        else:
            grew = _LAST_RESIDUAL is not None and residual > _LAST_RESIDUAL
            _RESIDUAL_STREAK = _RESIDUAL_STREAK + 1 if grew else 0
            _LAST_RESIDUAL = residual
            streak = _RESIDUAL_STREAK
            fire = streak >= leak_ticks()
            if fire:
                # Re-arm only after the residual stops growing: one
                # bundle per sustained-growth episode, not one per tick.
                _RESIDUAL_STREAK = 0
    if fire:
        from celestia_app_tpu_torch.trace.flight_recorder import note_trigger

        # The guard breaks the capture -> snapshot -> reconcile cycle.
        _IN_TRIGGER.busy = True
        try:
            note_trigger(
                "device_residual_growth",
                residual_bytes=residual,
                owned_bytes=owned_total,
                measured_bytes=measured,
                streak=streak,
                source=source,
            )
        finally:
            _IN_TRIGGER.busy = False
    return {
        "owners": {k: owners[k] for k in sorted(owners)},
        "owned_bytes": owned_total,
        "measured_bytes": measured,
        "measured_source": source,
        "unattributed_residual": residual,
        "residual_growth_streak": streak,
    }


def _applied_seats() -> dict:
    """The lowering knobs currently set in the environment, read back so
    the snapshot shows what the library will actually run."""
    seats = {}
    for var in (
        "CELESTIA_RS_FFT", "CELESTIA_RS_FFT_MD", "CELESTIA_RS_PALLAS",
        "CELESTIA_RS_XOR", "CELESTIA_SHA_PALLAS", "CELESTIA_SHA_FUSED",
        "CELESTIA_PIPE_FUSED", "CELESTIA_PIPE_PANEL",
        "CELESTIA_EXTEND_SHARDS", "CELESTIA_SERVE_SHARDS",
        "CELESTIA_MEMPOOL_SHARDS", "CELESTIA_SPECULATE",
    ):
        val = os.environ.get(var)
        if val is not None:
            seats[var] = val
    return seats


def _program_row(rec: dict, now: float) -> dict:
    ref = rec.get("ref")
    alive = ref is not None and ref() is not None
    last = rec["last_dispatch_unix"]
    return {
        "family": rec["family"],
        "k": rec["k"],
        "construction": rec["construction"],
        "mode": rec["mode"],
        "batch": rec["batch"],
        "shards": rec["shards"],
        "builds": rec["builds"],
        "compile_s": round(rec["compile_s"], 6),
        "dispatches": rec["dispatches"],
        "dispatch_s": round(rec["dispatch_s"], 6),
        "last_dispatch_age_s": (
            round(max(0.0, now - last), 3) if last is not None else None
        ),
        "resident": alive,
    }


def snapshot(device=None) -> dict:
    """A FRESH ledger view (programs + ownership reconciliation of
    `device` + seats + warmup) — what flight bundles and
    $CELESTIA_DEVICE_SNAPSHOT dumps embed."""
    now = time.time()
    with _LOCK:
        recs = [dict(r) for r in _PROGRAMS.values()]
        warmed = dict(_WARMED)
    rows = sorted(
        (_program_row(r, now) for r in recs),
        key=lambda r: (r["family"], r["k"], r["construction"], r["mode"],
                       r["batch"], r["shards"]),
    )
    resident = _resident_gauge()
    by_family: dict[str, int] = {}
    for row in rows:
        by_family.setdefault(row["family"], 0)
        if row["resident"]:
            by_family[row["family"]] += 1
    for family, count in sorted(by_family.items()):
        resident.set(count, family=family)
    return {
        "programs": rows,
        "programs_resident": {k: by_family[k] for k in sorted(by_family)},
        "ownership": reconcile(device),
        "autotuner_seats": _applied_seats(),
        "warmup": [
            {"k": k, "construction": c, "mode": m}
            for (k, c, m) in sorted(warmed)
        ],
    }


def _tick_interval_s() -> float:
    try:
        return max(0.0, float(
            os.environ.get("CELESTIA_DEVICE_TICK_S", "") or 0.0
        ))
    except ValueError:
        return 0.0


def device_payload() -> bytes:
    """The canonical ledger bytes: a snapshot refreshed at most once per
    $CELESTIA_DEVICE_TICK_S, rendered with sorted keys and tight
    separators, so fetches inside one tick are byte-identical."""
    global _LAST_TICK, _CACHED_BODY
    now = time.monotonic()
    min_s = _tick_interval_s()
    with _TICK_LOCK:
        if (
            _CACHED_BODY is not None
            and _LAST_TICK is not None
            and now - _LAST_TICK < min_s
        ):
            return _CACHED_BODY
    body = json.dumps(
        snapshot(), sort_keys=True, separators=(",", ":")
    ).encode()
    with _TICK_LOCK:
        _LAST_TICK = now
        _CACHED_BODY = body
    return body


def device_response():
    """GET /device for trace/exposition.handle_observability_get."""
    return 200, "application/json", device_payload()


def _hook_snapshot_dump() -> None:
    """Arm the $CELESTIA_DEVICE_SNAPSHOT atexit dump once, lazily — only
    processes that actually touch the ledger pay the hook."""
    global _SNAPSHOT_HOOKED
    if _SNAPSHOT_HOOKED or not os.environ.get("CELESTIA_DEVICE_SNAPSHOT"):
        return
    with _LOCK:
        if _SNAPSHOT_HOOKED:
            return
        _SNAPSHOT_HOOKED = True
    atexit.register(_dump_snapshot)


def _dump_snapshot() -> None:
    path = os.environ.get("CELESTIA_DEVICE_SNAPSHOT")
    if not path:
        return
    try:
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(snapshot(), f, sort_keys=True, default=repr)
            f.write("\n")
        os.replace(tmp, path)
    except Exception:  # noqa: BLE001 — an exit hook must never raise
        pass


def _reset_for_tests() -> None:
    """Drop ledger state + the tick cache (test isolation).  Registered
    owner callbacks survive only if re-registered by the module under
    test — module-import-time registrations (the mempool's, the stream's,
    the speculation's, repair's) must be re-registered by the test that
    needs them."""
    global _RESIDUAL_STREAK, _LAST_RESIDUAL, _LAST_TICK, _CACHED_BODY
    with _LOCK:
        _PROGRAMS.clear()
        _OWNER_CALLBACKS.clear()
        _OWNED_KEYED.clear()
        _PUBLISHED_OWNERS.clear()
        _WARMED.clear()
        _RESIDUAL_STREAK = 0
        _LAST_RESIDUAL = None
    with _TICK_LOCK:
        _LAST_TICK = None
        _CACHED_BODY = None
