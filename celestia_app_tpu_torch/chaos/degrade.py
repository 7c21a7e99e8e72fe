"""Graceful degradation: the device-path circuit breaker and mode ladder.

The port of celestia_app_tpu/chaos/degrade.py.  The device pipeline sits on
the consensus hot path, so a dispatch failure must degrade LATENCY, never
correctness.  All six lowerings of the extend+DAH pipeline give the same
bytes, so stepping down the ladder

    sharded_panel  ->  panel  ->  fused_epi  ->  fused  ->  staged  ->  host

changes how a block's roots are computed, never what they are — a
degraded validator keeps signing the same DAH roots as its healthy peers.

  * sharded_panel: the panel partition over the extend mesh
    (kernels/panel_sharded.py, $CELESTIA_EXTEND_SHARDS on top of the
    panel seam) — the most infrastructure under it (every shard's stream,
    the copy collectives), so it is the very first rung distrusted; a
    faulting step (the chaos seam device.extend_shard, or any real fault)
    falls to the single-device panel runner below, roots unchanged;
  * panel:  the panel-streamed lowering for giant squares
    (kernels/panel.py, $CELESTIA_PIPE_PANEL, selected PER square size
    via kernels/fused.pipeline_mode_for_k) — a host-driven loop of
    launches per panel, the rung with the most moving parts; a faulting
    mid-panel dispatch falls to the materializing lowerings below;
  * fused_epi: the column phase and the bottom half's leaf digests in
    one launch of the epilogue kernel (csrc/rs_dense_leaf.cu) — seated
    by $CELESTIA_PIPE_FUSED=epi; its kernel is the most exotic, so it is
    the first materializing rung distrusted;
  * fused:  kernels/fused.extend_and_dah_fn (the default);
  * staged: the extend-then-hash pair (da/eds._pipeline);
  * host:   the floor.  The JAX package runs the staged composition
    eagerly there, with no compiled program; the port compiles nothing
    ahead and launches every kernel eagerly on every rung, so its floor
    is the staged pipeline on the same card (da/eds.pipeline_for_mode).
    No rung runs on the CPU or on the plain PyTorch versions: a kernel
    wrapper handed a CUDA tensor launches its kernel or raises.

A process based below the top rung enters the ladder where its env put
it (base "fused" never climbs to "fused_epi"): degradation only ever
steps DOWN from the seated mode.

`guarded_dispatch` wraps every extend+DAH dispatch: bounded exponential
backoff retries within a rung, and a consecutive-failure circuit breaker
that steps the per-process ladder down one rung when a rung keeps
failing.  The ladder rides the existing `pipeline_mode()` seam
(kernels/fused.py consults `effective_device_mode`), so EVERY caller —
ExtendedDataSquare.compute, the speculative extend, the BlockPipeline
dispatcher, repair's sweeps and re-extension — degrades together and none
can diverge.  Past the floor the original error raises; callers that run
under device.on_device (the App, the node, the gossip driver) see it as
a DeviceFault.

CUDA reports many faults asynchronously, at a later sync rather than at
the launch: `note_async_device_failure` feeds such a deferred fault into
the breaker (the stream's drain does).  A fault that poisons the context
(an illegal address) fails every rung, and the ladder walks to the floor
and raises, as it should: nothing here tries to recover a context.

State surfaces: `celestia_degraded{layer,mode}` (1 on the active
degraded mode), `celestia_recoveries_total{seam,outcome}` (retried /
degraded counts), `degraded_state()` ({"device": "<mode>"} when
degraded, the flight recorder's `degraded` section) and a
`breaker_trip` flight-recorder bundle per step.

Degradation is one-way per process (like a tripped breaker, it wants a
human or an orchestrator restart to re-arm): a device that flapped once
is not trusted back onto the hot path by timer.  `reset_for_tests()`
re-arms everything in-process.
"""

from __future__ import annotations

import threading
import time

LADDER = ("sharded_panel", "panel", "fused_epi", "fused", "staged", "host")

#: Consecutive same-rung dispatch failures before the breaker trips and
#: the ladder steps down ($CELESTIA_BREAKER_THRESHOLD).
DEFAULT_THRESHOLD = 3
#: Backoff between same-rung retries: base * 2^attempt, capped.
BACKOFF_BASE_S = 0.002
BACKOFF_CAP_S = 0.25


def _breaker_threshold() -> int:
    import os

    try:
        n = int(os.environ.get("CELESTIA_BREAKER_THRESHOLD", "") or 0)
    except ValueError:
        n = 0
    return n if n > 0 else DEFAULT_THRESHOLD


def recoveries():
    """The shared fault-survival counter — the ONE registration every
    seam's recovery accounting (ladder, WAL salvage, gossip resend) goes
    through, so the name and help text cannot fork."""
    from celestia_app_tpu_torch.trace.metrics import registry

    return registry().counter(
        "celestia_recoveries_total",
        "faults survived, by seam and how (retried / degraded / salvaged "
        "/ resent / gave_up)",
    )


_recoveries = recoveries  # internal alias (module-local call sites)


class CircuitBreaker:
    """Consecutive-failure breaker: `record_failure` returns True once
    the failure streak reaches the threshold.  `>=`, not `==`: the
    floor-of-the-ladder raise path leaves the streak AT the threshold,
    and an exact-equality check would let the count sail past it on the
    next caller — which would then retry forever instead of tripping."""

    def __init__(self, threshold: int | None = None):
        self._threshold = threshold
        self._failures = 0
        self._lock = threading.Lock()

    @property
    def threshold(self) -> int:
        return self._threshold or _breaker_threshold()

    def record_failure(self) -> bool:
        with self._lock:
            self._failures += 1
            return self._failures >= self.threshold

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0

    def reset(self) -> None:
        self.record_success()


class DeviceDegradation:
    """Per-process floor on the pipeline mode ladder."""

    def __init__(self):
        self._lock = threading.Lock()
        self._floor = 0  # index into LADDER; 0 = nothing degraded

    def effective_mode(self, base: str) -> str:
        """The mode callers should run: the env-selected base, unless the
        ladder has degraded past it."""
        with self._lock:
            floor = self._floor
        if floor == 0:
            return base
        return LADDER[max(LADDER.index(base), floor)]

    def degrade(self, base: str, observed: str | None = None) -> str | None:
        """Step one rung down from the current effective mode; returns the
        new (or already-stepped-to) mode, or None when already at the
        floor of the ladder.

        `observed` is the rung the CALLER saw fail: when another thread's
        concurrent breaker trip already stepped past it, this call
        returns the current mode WITHOUT stepping again — otherwise one
        burst of failures on two threads would double-step the one-way
        ladder and park the process on the host floor without the staged
        rung (possibly perfectly healthy) ever being tried."""
        with self._lock:
            cur = max(LADDER.index(base), self._floor)
            if observed is not None and LADDER.index(observed) < cur:
                return LADDER[cur]  # a concurrent trip already stepped
            if cur >= len(LADDER) - 1:
                return None
            nxt = cur + 1
            if LADDER[cur] == "panel":
                # Stepping off the panel rung lands on the process's
                # MATERIALIZING base — the rung the environment seated
                # (usually "fused") — never on a colder in-between
                # variant nothing warmed.
                nxt = max(LADDER.index(_env_base_mode()), nxt)
            self._floor = nxt
            new = LADDER[self._floor]
        self._publish(new)
        _recoveries().inc(seam="device.dispatch", outcome="degraded")
        import sys

        print(f"device pipeline degraded to {new!r} "
              f"(breaker tripped on repeated dispatch failure)",
              file=sys.stderr)
        # Black-box the moment of the trip: the journal rows explaining
        # WHY are still in the ring buffers right now; in an hour they
        # won't be.  note_trigger never raises and rate-limits itself.
        from celestia_app_tpu_torch.trace.flight_recorder import note_trigger

        note_trigger("breaker_trip", layer="device", mode=new,
                     observed=observed, base=base)
        return new

    def state(self) -> dict | None:
        """{"device": mode} when degraded, else None (the /healthz face)."""
        with self._lock:
            floor = self._floor
        return {"device": LADDER[floor]} if floor else None

    def reset(self) -> None:
        with self._lock:
            self._floor = 0
        self._publish(None)

    def _publish(self, active: str | None) -> None:
        from celestia_app_tpu_torch.trace.metrics import registry

        gauge = registry().gauge(
            "celestia_degraded",
            "1 on the active degraded mode per layer (all 0 when healthy)",
        )
        for mode in LADDER[1:]:
            gauge.set(1.0 if mode == active else 0.0,
                      layer="device", mode=mode)


DEVICE_DEGRADATION = DeviceDegradation()
DEVICE_BREAKER = CircuitBreaker()


def effective_device_mode(base: str) -> str:
    return DEVICE_DEGRADATION.effective_mode(base)


def degraded_state() -> dict | None:
    return DEVICE_DEGRADATION.state()


def reset_for_tests() -> None:
    DEVICE_DEGRADATION.reset()
    DEVICE_BREAKER.reset()


def note_async_device_failure(observed: str, base: str | None = None) -> None:
    """Feed a DEFERRED device-execution failure into the breaker.

    Kernel launches are asynchronous: a real execution fault often
    surfaces at a later sync (the stream drain's event synchronize, a
    host read) where guarded_dispatch cannot catch it.  The block that
    hit the fault is lost either way — its caller sees the error — but
    routing the failure through the breaker here means a PERSISTENT
    deferred fault still steps the ladder, so future blocks move off the
    failing rung instead of dying one by one.

    `base` is the caller's base rung when it runs a per-k seat above the
    env base (the panel lowering): degrade() steps relative to it, so a
    persistent panel fault moves future giant blocks off the panel rung
    instead of being mistaken for an already-handled concurrent trip."""
    if DEVICE_BREAKER.record_failure():
        if DEVICE_DEGRADATION.degrade(
            base or _env_base_mode(), observed=observed
        ) is not None:
            DEVICE_BREAKER.reset()
        else:
            # Already on the ladder floor: degrade() (which black-boxes
            # the step) did nothing, but a PERSISTENT deferred fault at
            # the floor is exactly a flight-recorder moment — capture it
            # here (rate-limited) since no step will.
            from celestia_app_tpu_torch.trace.flight_recorder import note_trigger

            note_trigger("breaker_trip", layer="device", mode="host",
                         observed=observed, at_floor=True)


def guarded_dispatch(resolve, x, *, refresh=None,
                     breaker: CircuitBreaker | None = None,
                     sleep=time.sleep, k: int | None = None, device=None):
    """One extend+DAH dispatch with chaos injection, bounded retry, and
    ladder fallback.

    `resolve(mode)` returns the pipeline callable for that lowering (the
    caller owns cache policy and input staging).  Returns (mode, outputs)
    so the caller can journal the mode that actually ran.

    `k` routes the dispatch through the PER-SQUARE-SIZE mode seam
    (kernels/fused.pipeline_mode_for_k, on `device`, whose cards the
    sharded seam counts): the panel-streamed lowering only engages for the
    square sizes $CELESTIA_PIPE_PANEL names, so the active rung — and the
    base the ladder degrades from — depends on k.  Callers without a per-k
    seat (repair, which wants the materializing full-EDS path anyway) omit
    it and ride the process mode.

    Each rung gets `threshold` attempts with exponential backoff; when a
    rung's streak trips the breaker the ladder steps down and the next
    rung starts with a fresh streak.  Only when the host rung also
    exhausts its streak does the failure propagate — at that point the
    process genuinely cannot compute roots.

    Retry safety: the chaos seam raises BEFORE the real dispatch, so the
    input is intact on an injected fault.  A caller whose lowering may
    consume its input on a real mid-dispatch failure passes `refresh`
    (rebuilds the input from a host copy); it runs before any retry that
    follows a non-injected failure of the fused-family rungs.  None of
    the port's lowerings writes its input, so no port caller passes it.
    """
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.chaos.spec import ChaosInjected
    from celestia_app_tpu_torch.kernels.fused import (
        env_base_mode_for_k,
        pipeline_mode,
        pipeline_mode_for_k,
    )

    if k is None:
        mode_of, base_of = pipeline_mode, _env_base_mode
    else:
        def mode_of(): return pipeline_mode_for_k(k, device)
        def base_of(): return env_base_mode_for_k(k, device)
    breaker = breaker or DEVICE_BREAKER
    attempt = 0
    # Per-CALL termination backstop, independent of the shared breaker:
    # the breaker counts CONSECUTIVE process-wide failures, so a caller
    # whose dispatches persistently fail while a concurrent caller keeps
    # succeeding (each success zeroes the shared streak) would otherwise
    # retry forever without ever tripping it.  Enough budget to walk the
    # whole ladder twice over before giving up.
    total_attempts = 0
    attempt_cap = max(breaker.threshold, 1) * 2 * len(LADDER)
    while True:
        mode = mode_of()  # re-read: a degrade below moves it
        try:
            chaos.device_dispatch(mode)
            out = resolve(mode)(x)
            breaker.record_success()
            if attempt:
                _recoveries().inc(seam="device.dispatch", outcome="retried")
            return mode, out
        except Exception as e:  # chaos-ok: every rung retries, the floor re-raises
            if (refresh is not None and mode in ("fused", "fused_epi")
                    and not isinstance(e, ChaosInjected)):
                # A real failure of a rung that may consume its input;
                # refresh is itself guarded — an upload blip during
                # recovery must feed the normal retry/degrade
                # accounting, not abort it.
                try:
                    x = refresh()
                except Exception:  # chaos-ok: next attempt re-lands here
                    pass
            total_attempts += 1
            if total_attempts >= attempt_cap:
                raise  # this call alone has failed across the whole budget
            if breaker.record_failure():
                if DEVICE_DEGRADATION.degrade(
                    base_of(), observed=mode
                ) is not None:
                    breaker.reset()
                    attempt = 0
                    continue  # fresh streak on the new rung
                raise  # host rung exhausted: nothing left to degrade to
            sleep(min(BACKOFF_BASE_S * (2 ** attempt), BACKOFF_CAP_S))
            attempt += 1


def retry_on_card(seam: str, fn, *, sleep=time.sleep):
    """`fn()` retried on the card: up to DEFAULT_THRESHOLD retries after a
    failure, with the ladder's backoff, each ticking
    `celestia_recoveries_total{seam, outcome="retried"}`; past the last
    retry the failure raises as device.DeviceFault.  The proof seams'
    rule (serve/sampler `proof.serve`, serve/verify `proof.verify`),
    where the JAX package answers the whole queue on the host instead:
    in the port no fault of the card is answered from the CPU."""
    from celestia_app_tpu_torch.device import DeviceFault

    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:  # chaos-ok: retried, then a DeviceFault
            if attempt >= DEFAULT_THRESHOLD:
                raise DeviceFault(f"{seam} failed on the device after {attempt} retries: "
                                  f"{e!r}") from e
            _recoveries().inc(seam=seam, outcome="retried")
            sleep(min(BACKOFF_BASE_S * (2 ** attempt), BACKOFF_CAP_S))
            attempt += 1


def _env_base_mode() -> str:
    """The env-selected base mode, WITHOUT the ladder applied (degrade()
    must step relative to it, not to its own output).  One parse lives in
    kernels/fused.py; both imports are lazy, so no cycle."""
    from celestia_app_tpu_torch.kernels.fused import env_base_mode

    return env_base_mode()
