"""Prometheus-style metrics: registry + text exposition.

The reference exposes node metrics through Tendermint's Prometheus
instrumentation (test/e2e/testnet/setup.go:24, node.go:125) and counts
app-level events via sdk telemetry (rejected txs/panics,
app/validate_txs.go:61,91, process_proposal.go:32).  This module carries
the same role: counters/gauges/histograms incremented at those points,
rendered in the Prometheus text exposition format on the serving plane's
GET /metrics.
"""

from __future__ import annotations

import threading
from collections import defaultdict

# Explicit bucket tuple for DEVICE timings: the default request-scale
# buckets (5 ms floor) collapse every sub-millisecond kernel dispatch into
# one bucket.  Spans/journal rows measuring device work pass these
# explicitly at the call site; the floor is 100 µs — below the cheapest
# observed dispatch — and the ceiling covers a cold k=512 transfer.
DEVICE_SECONDS_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0,
)


def _fmt_value(v: float) -> str:
    """Full-precision exposition (prometheus_client style): integers stay
    integral; %g would round counters past ~1e6."""
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._values: dict[tuple, float] = defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            self._values[tuple(sorted(labels.items()))] += amount

    def samples(self) -> list[tuple[dict, float]]:
        """[(labels dict, value)] for every child series — the read-side
        accessor gauge predicates (trace/slo.py) evaluate over."""
        with self._lock:
            return [(dict(key), val) for key, val in sorted(self._values.items())]

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            # Sorted by label set: the exposition is a stable function of
            # the registry STATE, never of sample arrival order.
            items = sorted(self._values.items()) or [((), 0.0)]
        for key, val in items:
            out.append(f"{self.name}{_fmt_labels(dict(key))} {_fmt_value(val)}")
        return out


class Gauge(Counter):
    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[tuple(sorted(labels.items()))] = value

    def render(self) -> list[str]:
        return [
            line.replace(" counter", " gauge", 1) if line.startswith("# TYPE") else line
            for line in super().render()
        ]


class HistogramSnapshot:
    """Point-in-time copy of a Histogram's children, the unit of windowed
    evaluation: `delta(earlier)` subtracts an older snapshot child-wise
    (what arrived IN the window, not since process start — Prometheus
    counters are cumulative, SLO windows are not), and `quantile` /
    `fraction_over` estimate from bucket counts with linear interpolation
    inside the bounding bucket.  `**labels` on the estimators is a subset
    selector: children whose label sets contain every given pair are
    merged before estimating (so `phase="total"` covers the per-tenant
    `{phase="total",namespace=...}` children too)."""

    def __init__(self, buckets: tuple[float, ...], children: dict):
        self.buckets = buckets
        # label key tuple -> (per-bucket counts incl. +Inf tail, sum)
        self.children = children

    def delta(self, earlier: "HistogramSnapshot") -> "HistogramSnapshot":
        """This snapshot minus `earlier`: the observations of the window
        between them.  Children absent earlier keep their full counts; a
        reset (counts going backwards, e.g. a test registry swap) clamps
        at zero rather than going negative."""
        out = {}
        for key, (counts, total) in self.children.items():
            old = earlier.children.get(key)
            if old is None:
                out[key] = (list(counts), total)
                continue
            out[key] = (
                [max(0, c - o) for c, o in zip(counts, old[0])],
                max(0.0, total - old[1]),
            )
        return HistogramSnapshot(self.buckets, out)

    def _merged(self, labels: dict) -> list[int]:
        """Summed per-bucket counts over children matching the subset
        selector (stringified values, like observe())."""
        want = {(k, str(v)) for k, v in labels.items()}
        merged = [0] * (len(self.buckets) + 1)
        for key, (counts, _) in self.children.items():
            if want <= set(key):
                for i, c in enumerate(counts):
                    merged[i] += c
        return merged

    def count(self, **labels) -> int:
        return sum(self._merged(labels))

    def quantile(self, q: float, **labels) -> float | None:
        """Bucket-interpolated quantile estimate in [0, 1] -> value, or
        None with no observations.  Ranks landing in the +Inf tail clamp
        to the largest finite bound (the estimate cannot exceed what the
        buckets resolve)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        counts = self._merged(labels)
        total = sum(counts)
        if total == 0:
            return None
        rank = q * total
        cumulative = 0
        for i, bound in enumerate(self.buckets):
            prev_cum, cumulative = cumulative, cumulative + counts[i]
            if cumulative >= rank:
                lower = self.buckets[i - 1] if i else 0.0
                if counts[i] == 0:
                    return bound
                frac = (rank - prev_cum) / counts[i]
                return lower + (bound - lower) * frac
        return self.buckets[-1] if self.buckets else None

    def fraction_over(self, threshold: float, **labels) -> float | None:
        """Estimated fraction of observations strictly above `threshold`
        (the SLO bad-event rate), interpolating inside the bucket that
        contains it; the +Inf tail always counts as over.  None with no
        observations."""
        counts = self._merged(labels)
        total = sum(counts)
        if total == 0:
            return None
        under = 0.0
        for i, bound in enumerate(self.buckets):
            if bound <= threshold:
                under += counts[i]
                continue
            lower = self.buckets[i - 1] if i else 0.0
            if threshold > lower:
                under += counts[i] * (threshold - lower) / (bound - lower)
            break
        return max(0.0, min(1.0, (total - under) / total))


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics), labeled: each
    distinct label set is its own child series with its own bucket counts,
    `le` merged into the labels on _bucket lines."""

    def __init__(self, name: str, help_text: str, buckets: tuple[float, ...]):
        self.name = name
        self.help = help_text
        self.buckets = tuple(sorted(buckets))
        # label key tuple -> [per-bucket counts (+Inf tail), sum]
        self._children: dict[tuple, list] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels) -> None:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = [
                    [0] * (len(self.buckets) + 1), 0.0
                ]
            child[1] += value
            counts = child[0]
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1

    def snapshot(self) -> HistogramSnapshot:
        """Copy the current child counts for windowed evaluation: two
        snapshots bracket a window, `later.delta(earlier)` is what landed
        inside it (trace/slo.py's rolling-window input)."""
        with self._lock:
            children = {
                key: (list(child[0]), child[1])
                for key, child in self._children.items()
            }
        return HistogramSnapshot(self.buckets, children)

    def quantile(self, q: float, **labels) -> float | None:
        """Bucket-interpolated quantile over the CUMULATIVE counts (all
        observations since process start); window-scoped quantiles go
        through snapshot()/delta() instead."""
        return self.snapshot().quantile(q, **labels)

    @staticmethod
    def merge(snapshots) -> HistogramSnapshot:
        """Bucket-wise merge of per-host snapshots into ONE fleet
        snapshot: children with the same label set sum count-for-count,
        disjoint label sets union — so a cross-host quantile off the
        result is EXACT at bucket resolution (bucket counts are additive
        across processes; no resampling, no quantile-of-quantiles bias).
        Empty snapshots are identity elements; the +Inf tail sums like
        any other bucket (quantile() still clamps tail ranks to the
        largest finite bound).  All non-empty snapshots must share one
        bucket layout — merging counts across different layouts would
        silently misbucket, so that raises ValueError."""
        buckets: tuple[float, ...] | None = None
        merged: dict[tuple, list] = {}
        for snap in snapshots:
            if not snap.children:
                continue
            if buckets is None:
                buckets = snap.buckets
            elif snap.buckets != buckets:
                raise ValueError(
                    f"cannot merge histograms with bucket layouts "
                    f"{buckets} and {snap.buckets}"
                )
            for key, (counts, total) in snap.children.items():
                child = merged.get(key)
                if child is None:
                    merged[key] = [list(counts), total]
                    continue
                for i, c in enumerate(counts):
                    child[0][i] += c
                child[1] += total
        return HistogramSnapshot(
            buckets or (),
            {key: (child[0], child[1]) for key, child in merged.items()},
        )

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            children = [
                (key, (list(child[0]), child[1]))
                for key, child in sorted(self._children.items())
            ] or [((), ([0] * (len(self.buckets) + 1), 0.0))]
        for key, (counts, total) in children:
            labels = dict(key)
            cumulative = 0
            for b, c in zip(self.buckets, counts):
                cumulative += c
                out.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels({**labels, 'le': f'{b:g}'})} {cumulative}"
                )
            cumulative += counts[-1]
            out.append(
                f"{self.name}_bucket"
                f"{_fmt_labels({**labels, 'le': '+Inf'})} {cumulative}"
            )
            out.append(
                f"{self.name}_sum{_fmt_labels(labels)} {_fmt_value(total)}"
            )
            out.append(f"{self.name}_count{_fmt_labels(labels)} {cumulative}")
        return out


class Registry:
    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get_or_make(name, lambda: Counter(name, help_text), Counter)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get_or_make(name, lambda: Gauge(name, help_text), Gauge)

    def histogram(
        self, name: str, help_text: str = "",
        buckets: tuple[float, ...] = (0.005, 0.025, 0.1, 0.5, 2.5, 10.0),
    ) -> Histogram:
        return self._get_or_make(
            name, lambda: Histogram(name, help_text, buckets), Histogram
        )

    def get(self, name: str) -> "Counter | Gauge | Histogram | None":
        """The registered metric by name, or None — the read-side lookup
        (SLO evaluation) that must never create a family as a side
        effect of observing it."""
        with self._lock:
            return self._metrics.get(name)

    def _get_or_make(self, name, factory, kind):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif type(m) is not kind:
                raise TypeError(f"metric {name} already registered as {type(m).__name__}")
            return m

    def render(self) -> str:
        lines: list[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            lines += m.render()
        return "\n".join(lines) + "\n"


_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY
