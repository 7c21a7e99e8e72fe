"""blocktime: block interval statistics (reference tools/blocktime).

Computes the interval distribution over a window of block timestamps
(tools/blocktime/main.go:14 pulls them over RPC; here they come from the
node's recorded times or any list of nanosecond timestamps).

The port's copy of celestia_app_tpu/tools/blocktime.py.
"""

from __future__ import annotations


def interval_stats(block_times_ns: list[int]) -> dict:
    if len(block_times_ns) < 2:
        return {"blocks": len(block_times_ns), "intervals": 0}
    intervals = [
        (b - a) / 1e9 for a, b in zip(block_times_ns, block_times_ns[1:])
    ]
    intervals_sorted = sorted(intervals)
    n = len(intervals)
    return {
        "blocks": len(block_times_ns),
        "intervals": n,
        "mean_s": sum(intervals) / n,
        "min_s": intervals_sorted[0],
        "max_s": intervals_sorted[-1],
        "p50_s": intervals_sorted[n // 2],
        "p95_s": intervals_sorted[min(n - 1, int(n * 0.95))],
    }
