"""Observability of the port.

  journal.py    the block journal: one row per extend or streamed block.
  context.py    trace contexts and `trace_span` (event row + histogram +
                OTLP-shaped span row per finished span).
  tracer.py     the columnar event tables (`traced()`).
  metrics.py    the Prometheus-style registry (`registry()`).
  spans.py      the OTLP span table and the end-to-end phase histogram.
  square_journal.py  one row per built square, the namespace label cap.
  slo.py        declarative SLOs and their burn-rate engine.
  device_ledger.py   the program ledger and the owners of resident bytes.
  profiler.py   the N-block torch.profiler window and the memory gauge.
  round_journal.py   one row per consensus (height, round).
  flight_recorder.py the anomaly black box (`note_trigger`, bundles).

The JAX package's trace layer (celestia_app_tpu/trace/) also has the
height timeline, the exposition and the fleet plane; they come over with
the serving plane (ROADMAP, queue 1).
"""

from celestia_app_tpu_torch.trace.context import (
    TraceContext,
    current_context,
    new_context,
    trace_span,
    use_context,
)
from celestia_app_tpu_torch.trace.tracer import Tracer, trace_enabled, traced

__all__ = [
    "TraceContext",
    "Tracer",
    "current_context",
    "new_context",
    "trace_enabled",
    "trace_span",
    "traced",
    "use_context",
]
