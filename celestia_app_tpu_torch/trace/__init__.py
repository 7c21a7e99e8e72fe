"""Observability of the port: for now only the block journal (journal.py).

The JAX package's trace layer (celestia_app_tpu/trace/) also has the
Prometheus registry, the profiler window, the SLO engine, spans and the
trace context; they come over with the node integration (ROADMAP, queue 1).
"""
