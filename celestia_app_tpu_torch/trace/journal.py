"""Block journal: one row per block through the port's block path.

`ExtendedDataSquare.compute` writes a "compute" row per call and
`parallel/pipeline.BlockPipeline` a "stream" row per drained block, with
the field names of the JAX package's journal
(celestia_app_tpu/trace/journal.py): square size `k`, the lowering `mode`,
`compile` ("miss" when the call built its pipeline: the generator carried
to the device and, on a first launch, the kernels compiled), the stage
timings the path measured (`upload_ms`, `dispatch_ms`; on stream rows also
`intake_wait_ms`, `upload_stall_ms`, `dispatch_starve_ms`, `drain_ms`),
`batch_size` (squares coalesced into the row's launches) on stream rows,
`panels` (row panels streamed, kernels/panel.py) on rows of the "panel"
lowering, and the `speculation` outcome ("hit" / "discard") on compute
rows.  All
timings are host perf_counter deltas around calls the path makes anyway;
nothing here synchronizes the device.

Only the table is ported: an in-process ring of the last ROWS_KEPT rows,
written from any thread, read with `rows()`.  The JAX journal's Prometheus
histograms, profiler window, HBM gauge, SLO tick and trace-context stamps
wait for the node integration (ROADMAP, queue 1).
"""

from __future__ import annotations

import threading
import time
from collections import deque

TABLE = "block_journal"
ROWS_KEPT = 10_000

_LOCK = threading.Lock()
_ROWS: deque[dict] = deque(maxlen=ROWS_KEPT)


def record(source: str, k: int, *, mode: str | None = None,
           compile: str | None = None, **fields) -> None:
    """Append one row: `source` names the path ("compute" or "stream")."""
    row = {"ts_ns": time.time_ns(), "source": source, "k": k, "mode": mode,
           "compile": compile, **fields}
    with _LOCK:
        _ROWS.append(row)


def rows(source: str | None = None) -> list[dict]:
    """The retained rows, oldest first (of one `source` when given)."""
    with _LOCK:
        return [dict(r) for r in _ROWS if source is None or r["source"] == source]
