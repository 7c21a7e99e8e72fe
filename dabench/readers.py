"""Reductions the per-layer metrics' readers share (dabench/layer_metrics/).

A reader returns None where its run has nothing to read: no traced
activity, no event of its layer, or, for an idle share or a roofline, a
profiler that disagreed with the program's launch counters."""

from __future__ import annotations

from dabench import devicetrace


def idle_pct(view) -> float | None:
    act = view.activity
    if act is None or not act.traced or not view.cross_check_ok:
        return None
    return devicetrace.idle_pct(act.events, act.window_s)


def roofline_pct(view, layer: str, least_s_per_op: float) -> float | None:
    """100 x the least time of the operations the traced interval ran over
    the device time of the layer's kernels."""
    act = view.activity
    if act is None or not act.traced or not view.cross_check_ok or view.traced_ops <= 0:
        return None
    spent = view.device_time_s(layer)
    if spent <= 0:
        return None
    return 100.0 * least_s_per_op * view.traced_ops / spent


def journal_ms_per_square(view, stage: str) -> float | None:
    """A stream stage's time per square from the window's journal rows: a
    batch's row repeats the batch's time on each of its squares, so each
    row carries its share, time / batch_size."""
    rows = [r for r in view.run.journal if r.get(stage) is not None]
    if not rows:
        return None
    return sum(r[stage] / r.get("batch_size", 1) for r in rows) / len(rows)


def launches_per_op(view, layer: str) -> float | None:
    act = view.activity
    if act is None or view.traced_ops <= 0:
        return None
    counters = view.layers[layer].counters
    return sum(act.launches.get(c, 0) for c in counters) / view.traced_ops
