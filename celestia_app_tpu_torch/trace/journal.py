"""Block journal: one row per block through the port's block path.

The port of celestia_app_tpu/trace/journal.py.  `ExtendedDataSquare.compute`
writes a "compute" row per call, `parallel/pipeline.BlockPipeline` a
"stream" row per drained block and `da.eds.warmup` a "warmup" row per
warmed size, with the field names of the JAX package's journal: square
size `k`, the lowering `mode` (the rung that actually ran, after any
degradation), `compile` ("miss" when the call built its pipeline: the
generator carried to the device and, on a first launch, the kernels
compiled), the stage timings the path measured (`upload_ms`,
`dispatch_ms`; on stream rows also `intake_wait_ms`, `upload_stall_ms`,
`dispatch_starve_ms`, `drain_ms`; `warm_ms` on warmup rows), `batch_size`
(squares coalesced into the row's launches) on stream rows, `panels` (row
panels streamed, kernels/panel.py) on rows of the panel lowerings, and the
`speculation` outcome ("hit" / "discard") on compute rows.

Each row lands in three places:
  * an in-process ring of the last ROWS_KEPT rows, written from any
    thread and read with `rows()` (ungated: drills read it);
  * the `block_journal` trace table (trace/tracer.py), stamped with the
    current trace context's trace_id and height, under $CELESTIA_TRACE;
  * the Prometheus registry: every `*_ms` field on a
    `celestia_block_<stage>_seconds` histogram with device-scale buckets
    and {source, k} labels, and `compile` on
    `celestia_pipeline_compile_total{result,source}`.
Every row also advances the $CELESTIA_PROFILE_BLOCKS profiler window,
refreshes the memory high-water gauge (trace/profiler.py) and ticks the SLO
engine (`engine().maybe_tick()`, rate-limited), outside the trace gate.

All timings are host perf_counter deltas around calls the path makes
anyway; nothing here synchronizes the device.
"""

from __future__ import annotations

import threading
import time
from collections import deque

TABLE = "block_journal"
ROWS_KEPT = 10_000

_LOCK = threading.Lock()
_ROWS: deque[dict] = deque(maxlen=ROWS_KEPT)


def note_jit_build(program: str) -> None:
    """Count a pipeline build (the counter the JAX package exposes as
    celestia_jit_builds_total{program=...}).  Called from the cache-missed
    builder bodies, so hits cost nothing."""
    from celestia_app_tpu_torch.trace.metrics import registry

    registry().counter(
        "celestia_jit_builds_total",
        "jit pipeline wrapper builds (a miss traces + compiles on first dispatch)",
    ).inc(program=program)


def record(source: str, k: int, *, mode: str | None = None,
           compile: str | None = None, **fields) -> None:
    """Write one block-journal row and its Prometheus reflections.

    `source` names the path (compute | stream | warmup); `compile` is
    "hit"/"miss" against the pipeline cache.  Extra `fields` ending in
    `_ms` are stage timings, each observed on
    `celestia_block_<stage>_seconds`; other fields (tags, depth, counts)
    land only in the rows."""
    from celestia_app_tpu_torch.trace import profiler
    from celestia_app_tpu_torch.trace.metrics import DEVICE_SECONDS_BUCKETS, registry
    from celestia_app_tpu_torch.trace.slo import engine
    from celestia_app_tpu_torch.trace.tracer import traced

    # The profiler window and the memory gauge carry their own gates and
    # keep firing when $CELESTIA_TRACE=off mutes the table and metric
    # layer; so does the SLO tick (the gauges it judges keep updating).
    profiler.block_profiler().note_block()
    profiler.record_hbm_high_water(point=source, k=k)
    engine().maybe_tick()

    row = {"ts_ns": time.time_ns(), "source": source, "k": k, "mode": mode,
           "compile": compile, **fields}
    with _LOCK:
        _ROWS.append(row)

    tracer = traced()
    if not tracer._on():
        return
    # A dispatch running under a request or block trace stamps its row
    # with the trace_id and the height riding the context's baggage.
    if "trace_id" not in fields or "height" not in fields:
        from celestia_app_tpu_torch.trace.context import current_context

        ctx = current_context()
        if ctx is not None:
            fields.setdefault("trace_id", ctx.trace_id)
            height = ctx.baggage.get("height")
            if height is not None:
                fields.setdefault("height", height)
    tracer.write(TABLE, source=source, k=k, mode=mode, compile=compile, **fields)
    reg = registry()
    if compile is not None:
        reg.counter(
            "celestia_pipeline_compile_total",
            "block dispatches by jit wrapper cache outcome",
        ).inc(result=compile, source=source)
    for name, value in fields.items():
        if not name.endswith("_ms") or value is None:
            continue
        reg.histogram(
            f"celestia_block_{name[:-3]}_seconds",
            f"per-block {name[:-3].replace('_', ' ')} time",
            buckets=DEVICE_SECONDS_BUCKETS,
        ).observe(value / 1e3, source=source, k=str(k))


def rows(source: str | None = None) -> list[dict]:
    """The retained rows, oldest first (of one `source` when given)."""
    with _LOCK:
        return [dict(r) for r in _ROWS if source is None or r["source"] == source]
