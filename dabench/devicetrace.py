"""The traced window: device activity from torch.profiler and the program's
launch counters over one interval, and the reductions of that activity to
busy time, idle gaps and per-layer device time.

The profiler records device activity alone (no host operators, so it adds
as little as it can to the host's work) and writes no trace file.  Times
of device events are microseconds on the profiler's clock; only their
differences are used.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

#: Entries of each list in a result's `breakdown`.
TOP = 10


@dataclass
class Activity:
    """What one traced interval saw."""

    events: list[tuple[float, float, str]] = field(default_factory=list)  # (start us, end us, name)
    window_s: float = 0.0  # host seconds from the profiler's start to its stop
    launches: dict[str, int] = field(default_factory=dict)  # counter deltas
    traced: bool = False


class Window:
    """Context manager around a measured interval: with `trace`, a
    torch.profiler of the device's activity; always, the deltas of
    `counters()` (a dict of launch counts).  The device is synchronized on
    entry and exit, so the interval starts and ends with nothing of it
    outside."""

    def __init__(self, torch, counters, trace: bool):
        self.torch, self.counters, self.trace = torch, counters, trace
        self.activity = Activity(traced=trace)
        self._prof = None

    def __enter__(self) -> "Window":
        torch = self.torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self._before = dict(self.counters())
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        torch = self.torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.activity.window_s = time.perf_counter() - self._t0
        after = self.counters()
        self.activity.launches = {n: after[n] - self._before.get(n, 0) for n in after}
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                cuda = torch.autograd.DeviceType.CUDA
                self.activity.events = [(e.time_range.start, e.time_range.end, e.name)
                                        for e in self._prof.events() if e.device_type == cuda]


def merged(spans) -> list[tuple[float, float]]:
    """The union of [start, end) intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for start, end, *_ in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def busy_s(events) -> float:
    return sum(b - a for a, b in merged(events)) / 1e6


def idle_pct(events, window_s: float) -> float | None:
    """100 - the share of the window in which any device operation ran."""
    if not events or window_s <= 0:
        return None
    return 100.0 - 100.0 * busy_s(events) / window_s


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' anonymity,
    template and arguments."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    if not name.startswith(("Memcpy", "Memset")):
        name = re.split(r"[(<]", name, maxsplit=1)[0]
    return name.strip()[:120] or "?"


def device_ops(events) -> list[list]:
    """[[name, seconds], ...] of the device operations that took most time."""
    total: dict[str, float] = {}
    for start, end, name in events:
        key = short_name(name)
        total[key] = total.get(key, 0.0) + (end - start) / 1e6
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def idle_gaps(events) -> list[list]:
    """[[label, seconds], ...]: idle time between device operations, summed
    by the operations on either side of each gap (what the device finished
    and what it waited for), the largest first."""
    ordered = sorted(events)
    spans = merged(ordered)
    ends = {}  # the operation that ends each merged span
    for start, end, name in ordered:
        ends[end] = name
    starts = {}
    for start, end, name in reversed(ordered):
        starts[start] = name
    total: dict[str, float] = {}
    for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
        label = f"after {short_name(ends.get(a1, '?'))} / before {short_name(starts.get(b0, '?'))}"
        total[label] = total.get(label, 0.0) + (b0 - a1) / 1e6
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def layer_events(events, layer) -> list[tuple[float, float, str]]:
    return [e for e in events if layer.owns(e[2])]


def cross_check(activity: Activity, layers, slack: float) -> tuple[bool, str]:
    """Whether the profiler saw every launch the program counted: for each
    layer with launch counters, the profiler's count of its kernels may
    exceed the counters' delta only by `slack` times that delta (launches
    counted before the window whose kernels ran inside it), never fall
    short.  Returns (agrees, what was compared)."""
    said = []
    ok = True
    for layer in layers:
        if not layer.counters:
            continue
        counted = sum(activity.launches.get(c, 0) for c in layer.counters)
        seen = len(layer_events(activity.events, layer))
        fine = counted <= seen <= counted + int(slack * counted + 0.999999)
        ok &= fine
        said.append(f"{layer.name}: profiler {seen}, counters {counted}"
                    f"{'' if fine else ' (disagree)'}")
    return ok, "; ".join(said)
