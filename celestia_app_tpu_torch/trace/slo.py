"""Declarative SLOs with multi-window burn-rate evaluation — the layer
that makes the telemetry plane judge itself.

PRs 2-4 built a passive telemetry plane (`celestia_e2e_seconds{phase}`,
block/square journals, per-tenant accounting); nothing in-process
evaluated it — an operator had to eyeball /metrics to notice a burning
p99.  This module closes that loop: a small set of declarative `SLOSpec`s
(histogram-quantile objectives and gauge predicates) is evaluated over
rolling windows built from in-process histogram snapshots
(metrics.HistogramSnapshot delta-diffing, never cumulative counts), in
the multi-window burn-rate shape of SRE alerting: the FAST window catches
pages (sustained BAD OBSERVATIONS show up within a tick or two), the SLOW
window catches slow burns that would quietly eat the error budget.

Scope boundary: burn rates judge observations that HAPPENED.  A pipeline
that stalls outright produces no observations and no ticks — that
liveness failure is /healthz's job (the "layers" staleness report: last
block age, mempool depth), not this engine's; an empty window reads as
burn 0, deliberately, so an idle-but-healthy node never pages.

Burn rate is budget-normalized: `bad_fraction / error_budget`, so 1.0
means "exactly consuming budget", and the page threshold (default 14.4,
the classic 1h/30d number) is meaningful across SLOs with different
objectives.  Gauge predicates burn on the fraction of evaluation ticks
the predicate was violated inside the window — a tripped breaker
(`celestia_degraded` != 0) burns at 1/budget immediately.

Surfaces:

    celestia_slo_burn_rate{slo,window}    gauge, refreshed per tick
    celestia_slo_violations_total{slo}    counter, ticked on the ok ->
                                          burning transition (a page)
    GET /slo                              the full evaluation payload on
                                          the shared exposition handler
                                          (byte-identical across planes)
    /healthz "slo" block                  BURNING vs OK in one probe,
                                          next to DEGRADED

A page transition also writes an `slo_page` trace row and fires the
flight recorder (trigger `slo_fast_burn`), so the forensic state around
the moment of anomaly is captured before the ring buffers evict it.

Ticking: `maybe_tick()` is called from the block-journal funnel
(trace/journal.record — every block through the device pipeline) and
from GET /slo; it re-evaluates at most every $CELESTIA_SLO_TICK_S
(default 1.0s), so the hot path pays one clock read + compare when not
due.  Windows come from $CELESTIA_SLO_FAST_S / $CELESTIA_SLO_SLOW_S
(default 60s / 600s).  Everything is injectable (clock, specs) for
deterministic tests.

The port's copy of celestia_app_tpu/trace/slo.py: the same specs, windows,
burn rates, states and payloads on the same registry.  A fast-burn page
captures a `slo_fast_burn` flight-recorder bundle, and the block journal
(trace/journal.record) calls `maybe_tick` on every row, as in the JAX
package.  The /slo and /healthz HTTP faces come with the serving plane.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass

#: Page when the FAST window burns this many times faster than budget
#: (the SRE 1h-window page threshold; a gauge predicate fully violated
#: burns at 1/budget = 100x, so pages fire on the first bad tick).
DEFAULT_FAST_BURN = 14.4
#: Ticket-severity threshold on the SLOW window (slow burns).
DEFAULT_SLOW_BURN = 6.0


def _env_float(name: str, default: float) -> float:
    try:
        v = float(os.environ.get(name, "") or default)
    except ValueError:
        return default
    return v if v >= 0 else default


def fast_window_s() -> float:
    """$CELESTIA_SLO_FAST_S: the paging window (default 60s)."""
    return _env_float("CELESTIA_SLO_FAST_S", 60.0)


def slow_window_s() -> float:
    """$CELESTIA_SLO_SLOW_S: the slow-burn window (default 600s)."""
    return _env_float("CELESTIA_SLO_SLOW_S", 600.0)


def tick_interval_s() -> float:
    """$CELESTIA_SLO_TICK_S: minimum seconds between evaluations (0 =
    evaluate on every maybe_tick, the drill/test setting)."""
    return _env_float("CELESTIA_SLO_TICK_S", 1.0)


@dataclass(frozen=True)
class SLOSpec:
    """One declarative objective.

    kind="quantile": `metric` names a histogram family; the objective is
    "the `quantile` of observations (matching `labels`) stays <=
    `threshold`" and the error budget is `1 - quantile` unless `budget`
    overrides it (bad events = observations over the threshold).

    kind="gauge": `metric` names a gauge; the objective is "every child
    sample (matching `labels`) satisfies `value <op> threshold`"; the
    budget is the tolerated fraction of violated evaluation ticks.
    """

    name: str
    metric: str
    kind: str = "quantile"  # "quantile" | "gauge"
    labels: tuple[tuple[str, str], ...] = ()
    quantile: float = 0.99
    threshold: float = 1.0
    op: str = "<="  # gauge predicate operator: <= >= == < >
    budget: float | None = None
    fast_burn: float = DEFAULT_FAST_BURN
    slow_burn: float = DEFAULT_SLOW_BURN

    def effective_budget(self) -> float:
        if self.budget is not None:
            return max(self.budget, 1e-9)
        if self.kind == "quantile":
            return max(1.0 - self.quantile, 1e-9)
        return 0.01

    def objective_text(self) -> str:
        sel = ",".join(f'{k}="{v}"' for k, v in self.labels)
        target = f"{self.metric}{{{sel}}}" if sel else self.metric
        if self.kind == "quantile":
            return f"p{self.quantile * 100:g} of {target} <= {self.threshold:g}"
        return f"{target} {self.op} {self.threshold:g}"


_OPS = {
    "<=": lambda v, t: v <= t,
    ">=": lambda v, t: v >= t,
    "==": lambda v, t: v == t,
    "<": lambda v, t: v < t,
    ">": lambda v, t: v > t,
}


def default_slos() -> tuple[SLOSpec, ...]:
    """The shipped objectives: the e2e lifecycle p99s the ROADMAP calls
    the SLO family, the square-occupancy floor (a proposer quietly
    shipping near-empty squares is an incident, not idle traffic), and
    degraded==0 (a tripped breaker IS budget burn, even though the node
    keeps serving bit-identical roots)."""
    return (
        SLOSpec(
            name="e2e_total_p99", metric="celestia_e2e_seconds",
            labels=(("phase", "total"),), quantile=0.99, threshold=5.0,
        ),
        SLOSpec(
            name="dispatch_p99", metric="celestia_e2e_seconds",
            labels=(("phase", "dispatch"),), quantile=0.99, threshold=1.0,
        ),
        SLOSpec(
            name="mempool_wait_p99", metric="celestia_e2e_seconds",
            labels=(("phase", "mempool_wait"),), quantile=0.99, threshold=2.5,
        ),
        SLOSpec(
            name="square_occupancy",
            metric="celestia_square_last_occupancy_ratio",
            kind="gauge", op=">=", threshold=0.05, budget=0.1,
        ),
        # The read side: a DAS sample must come back fast at p99 — light
        # clients time out and resample, so a slow proof plane IS an
        # availability incident even while blocks commit on schedule.
        # Judged per served sample (serve/sampler's {phase="total"}
        # child); a node serving no proofs observes nothing and burns 0.
        SLOSpec(
            name="proof_p99", metric="celestia_proof_latency_seconds",
            labels=(("phase", "total"),), quantile=0.99, threshold=0.5,
        ),
        SLOSpec(
            name="degraded", metric="celestia_degraded",
            kind="gauge", op="==", threshold=0.0, budget=0.01,
        ),
    )


class SLOEngine:
    """Rolling-window evaluator over the in-process registry.

    Keeps a ring of timestamped histogram snapshots (one per family any
    quantile spec references) and a per-gauge-SLO ring of predicate
    verdicts; each tick() diffs the newest snapshot against the one just
    outside each window, turns bad-event fractions into budget-normalized
    burn rates, publishes the burn gauges, and detects page transitions.
    """

    def __init__(self, specs: tuple[SLOSpec, ...] | None = None,
                 clock=time.monotonic, wall=time.time):
        self.specs = tuple(specs) if specs is not None else default_slos()
        self._clock = clock
        self._wall = wall
        self._lock = threading.Lock()
        # (monotonic t, {family: HistogramSnapshot}) ring, oldest first.
        self._snaps: deque = deque()
        # gauge SLO name -> deque[(monotonic t, violated 0/1)]
        self._gauge_ticks: dict[str, deque] = {
            s.name: deque() for s in self.specs if s.kind == "gauge"
        }
        # slo name -> last evaluation dict (the /slo payload rows).
        self._results: dict[str, dict] = {}
        self._last_tick: float | None = None
        self._last_wall_ms: int | None = None
        self._paging: set[str] = set()  # SLOs currently in a burning state

    # -- evaluation ---------------------------------------------------------

    def maybe_tick(self) -> bool:
        """tick() if the rate limit allows; the hot-path entry (one clock
        read + compare when not due).  Returns whether a tick ran."""
        interval = tick_interval_s()
        now = self._clock()
        with self._lock:
            due = self._last_tick is None or now - self._last_tick >= interval
        if not due:
            return False
        self.tick()
        return True

    def tick(self) -> dict:
        """One full evaluation; returns {slo: result} (also retained for
        payload()).  Never raises into a caller: evaluation failures for
        one SLO mark that SLO errored and the rest proceed."""
        from celestia_app_tpu_torch.trace.metrics import registry

        now = self._clock()
        fast_s, slow_s = fast_window_s(), slow_window_s()
        families = sorted({
            s.metric for s in self.specs if s.kind == "quantile"
        })
        snaps = {}
        for fam in families:
            hist = registry().get(fam)
            if hist is not None and hasattr(hist, "snapshot"):
                snaps[fam] = hist.snapshot()
        pages: list[dict] = []
        with self._lock:
            self._snaps.append((now, snaps))
            # Retain one snapshot older than the slow window so the
            # window diff always has a baseline to subtract.
            while len(self._snaps) > 2 and self._snaps[1][0] <= now - slow_s:
                self._snaps.popleft()
            for spec in self.specs:
                try:
                    result = self._evaluate_locked(spec, now, fast_s, slow_s)
                except Exception as e:
                    result = {"state": "error",
                              "error": f"{type(e).__name__}: {e}"}
                result["objective"] = spec.objective_text()
                prev_burning = spec.name in self._paging
                burning = result.get("state") in ("fast_burn", "slow_burn")
                if burning:
                    self._paging.add(spec.name)
                elif result.get("state") == "ok":
                    self._paging.discard(spec.name)
                if burning and not prev_burning:
                    pages.append({"slo": spec.name, **result})
                self._results[spec.name] = result
            self._last_tick = now
            self._last_wall_ms = int(self._wall() * 1000)
            results = dict(self._results)
        self._publish(results)
        for page in pages:
            self._page(page)
        return results

    def _window_snapshot(self, fam: str, now: float, window_s: float):
        """The delta snapshot covering [now - window_s, now], or None
        when the family has no snapshots yet.  Baseline: the newest
        snapshot at least `window_s` old, else the oldest retained one —
        so a fresh engine's first tick diffs against itself (zero delta)
        instead of counting the process's whole cumulative history as
        one window."""
        newest = self._snaps[-1][1].get(fam)
        if newest is None:
            return None
        baseline_snaps = self._snaps[0][1]
        for t, snaps in self._snaps:
            if t <= now - window_s:
                baseline_snaps = snaps
            else:
                break
        base = baseline_snaps.get(fam)
        if base is None:
            # The family first appeared after the baseline was taken:
            # everything it holds landed inside the window.
            return newest
        return newest.delta(base)

    def _evaluate_locked(self, spec: SLOSpec, now: float,
                         fast_s: float, slow_s: float) -> dict:
        budget = spec.effective_budget()
        if spec.kind == "quantile":
            labels = dict(spec.labels)
            out: dict = {"kind": "quantile", "threshold": spec.threshold,
                         "quantile": spec.quantile, "budget": budget}
            burns = {}
            for window, span in (("fast", fast_s), ("slow", slow_s)):
                delta = self._window_snapshot(spec.metric, now, span)
                if delta is None:
                    burns[window] = 0.0
                    continue
                frac = delta.fraction_over(spec.threshold, **labels)
                burns[window] = 0.0 if frac is None else frac / budget
                if window == "fast":
                    out["window_count"] = delta.count(**labels)
                    q = delta.quantile(spec.quantile, **labels)
                    if q is not None:
                        out["current"] = round(q, 9)
            out["burn"] = {w: round(b, 6) for w, b in burns.items()}
        else:
            from celestia_app_tpu_torch.trace.metrics import registry

            gauge = registry().get(spec.metric)
            want = dict(spec.labels)
            violated = 0
            worst = None
            if gauge is not None and hasattr(gauge, "samples"):
                op = _OPS[spec.op]
                for labels, value in gauge.samples():
                    if all(labels.get(k) == v for k, v in want.items()):
                        if not op(value, spec.threshold):
                            violated = 1
                            worst = value
            ticks = self._gauge_ticks[spec.name]
            ticks.append((now, violated))
            while ticks and ticks[0][0] < now - slow_s:
                ticks.popleft()
            burns = {}
            for window, span in (("fast", fast_s), ("slow", slow_s)):
                inside = [v for t, v in ticks if t >= now - span]
                frac = sum(inside) / len(inside) if inside else 0.0
                burns[window] = frac / budget
            out = {"kind": "gauge", "threshold": spec.threshold,
                   "op": spec.op, "budget": budget, "violated_now": violated,
                   "burn": {w: round(b, 6) for w, b in burns.items()}}
            if worst is not None:
                out["current"] = worst
        if out["burn"]["fast"] >= spec.fast_burn:
            out["state"] = "fast_burn"
        elif out["burn"]["slow"] >= spec.slow_burn:
            out["state"] = "slow_burn"
        else:
            out["state"] = "ok"
        return out

    # -- side effects -------------------------------------------------------

    def _publish(self, results: dict) -> None:
        from celestia_app_tpu_torch.trace.metrics import registry

        burn = registry().gauge(
            "celestia_slo_burn_rate",
            "budget-normalized SLO burn rate per evaluation window "
            "(1.0 = consuming budget exactly; pages fire on the fast window)",
        )
        for name, result in results.items():
            for window, value in result.get("burn", {}).items():
                burn.set(value, slo=name, window=window)

    def _page(self, page: dict) -> None:
        """The ok -> burning transition: violation counter, trace row,
        flight-recorder capture.  Must never raise into tick()'s caller
        (the block journal funnel)."""
        from celestia_app_tpu_torch.trace.metrics import registry
        from celestia_app_tpu_torch.trace.tracer import traced

        registry().counter(
            "celestia_slo_violations_total",
            "SLO page transitions (entering a fast/slow burning state)",
        ).inc(slo=page["slo"])
        traced().write(
            "slo_page", slo=page["slo"], state=page.get("state"),
            burn_fast=page.get("burn", {}).get("fast"),
            burn_slow=page.get("burn", {}).get("slow"),
            objective=page.get("objective"),
        )
        if page.get("state") == "fast_burn":
            from celestia_app_tpu_torch.trace.flight_recorder import note_trigger

            note_trigger(
                "slo_fast_burn", slo=page["slo"],
                burn_fast=page.get("burn", {}).get("fast"),
                burn_slow=page.get("burn", {}).get("slow"),
                objective=page.get("objective"),
            )

    # -- read side ----------------------------------------------------------

    def payload(self) -> dict:
        """The GET /slo JSON: a pure function of the last tick's retained
        state, so concurrent scrapes on different planes see identical
        bytes until the next evaluation."""
        with self._lock:
            slos = {name: dict(r) for name, r in sorted(self._results.items())}
            evaluated_ms = self._last_wall_ms
        return {
            "windows": {"fast_s": fast_window_s(), "slow_s": slow_window_s()},
            "evaluated_unix_ms": evaluated_ms,
            "slos": slos,
        }

    def health_block(self) -> dict:
        """The /healthz "slo" face: BURNING when any SLO is in a burning
        state, with the offenders listed — so DEGRADED-vs-BURNING is one
        probe.  Read-only: the probe never forces an evaluation."""
        with self._lock:
            burning = sorted(
                name for name, r in self._results.items()
                if r.get("state") in ("fast_burn", "slow_burn")
            )
        return {"status": "BURNING" if burning else "OK", "burning": burning}

    def paged(self, name: str) -> bool:
        """Whether `name` is currently in a burning state (the chaos
        drill's detection probe)."""
        with self._lock:
            return name in self._paging


_ENGINE = SLOEngine()
_ENGINE_LOCK = threading.Lock()
#: Per-tenant SLOSpecs installed by the QoS layer (qos.py
#: `<tenant>.slo_p99_ms`): evaluated NEXT TO the shipped defaults.
_TENANT_SPECS: tuple[SLOSpec, ...] = ()


def engine() -> SLOEngine:
    return _ENGINE


def tenant_specs() -> tuple[SLOSpec, ...]:
    return _TENANT_SPECS


def set_tenant_specs(specs: tuple[SLOSpec, ...]) -> SLOEngine:
    """Swap the per-tenant SLO tier (the observe -> enforce wire from
    qos.py): rebuilds the engine over default_slos() + the tenant specs.
    Config changes drop the rolling windows — a tenant objective
    evaluated over windows collected under a different spec set would
    page on stale arithmetic."""
    global _ENGINE, _TENANT_SPECS
    specs = tuple(specs)
    with _ENGINE_LOCK:
        if specs == _TENANT_SPECS:
            return _ENGINE
        _TENANT_SPECS = specs
        _ENGINE = SLOEngine(default_slos() + specs)
    return _ENGINE


def _reset_for_tests(specs: tuple[SLOSpec, ...] | None = None) -> SLOEngine:
    """Swap in a fresh engine (drops windows, page state, results)."""
    global _ENGINE, _TENANT_SPECS
    with _ENGINE_LOCK:
        _TENANT_SPECS = ()
        _ENGINE = SLOEngine(specs)
    return _ENGINE
