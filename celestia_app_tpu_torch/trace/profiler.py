"""Profiler window and memory high-water hooks (env-gated, off the hot path).

The port of celestia_app_tpu/trace/profiler.py.  Two device-side
instruments the block journal (trace/journal.py) drives per block:

  * an N-block `torch.profiler` window: $CELESTIA_PROFILE_BLOCKS=N arms it;
    the trace starts on the first journaled block and stops after N,
    writing a Chrome trace (`trace-<pid>.json`, loadable in Perfetto or
    chrome://tracing) under $CELESTIA_PROFILE_DIR (default
    `celestia_torch_trace` in the temporary directory).  It records the
    host's operators and, on a card, its kernels and copies.  One window
    per process — profiling is a measurement run, not a steady-state cost;
  * a memory high-water gauge:
    celestia_hbm_peak_bytes{point=...,k=...,source=...}, refreshed per
    journaled dispatch.  `source="device"` is the caching allocator's
    peak (`torch.cuda.max_memory_allocated`) on the card; a process that
    has not touched a card falls back to `source="rss"` — the process
    peak RSS from resource.getrusage.  The label keeps the two sources
    from ever being compared as one series: RSS is a process-lifetime peak
    that includes the host heap, the allocator's figure is its own.

Nothing here synchronizes the device: the allocator statistics are host
counters.
"""

from __future__ import annotations

import os
import tempfile
import threading


def profile_blocks_target() -> int:
    """$CELESTIA_PROFILE_BLOCKS: how many journaled blocks the profiler
    window spans (0 = disabled)."""
    try:
        return int(os.environ.get("CELESTIA_PROFILE_BLOCKS", "0") or "0")
    except ValueError:
        return 0


def profile_dir() -> str:
    return os.environ.get("CELESTIA_PROFILE_DIR") or os.path.join(
        tempfile.gettempdir(), "celestia_torch_trace")


class BlockProfiler:
    """One env-gated profiler window per process, advanced per block."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active = False
        self._remaining = 0
        self._done = False
        self._prof = None
        self.trace_path: str | None = None

    def note_block(self) -> None:
        target = profile_blocks_target()
        if target <= 0 or self._done:
            return
        with self._lock:
            if self._done:
                return
            if not self._active:
                if not self._start(target):
                    return
            self._remaining -= 1
            if self._remaining <= 0:
                self._stop()

    def _start(self, target: int) -> bool:
        from celestia_app_tpu_torch.trace.tracer import traced

        logdir = profile_dir()
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(logdir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        except Exception as e:  # noqa: BLE001 — profiling must never take
            # down the block path; record the failure once and disarm.
            self._done = True
            self._prof = None
            traced().write("profiler", event="start_failed",
                           error=f"{type(e).__name__}: {e}"[:200])
            return False
        self._active = True
        self._remaining = target
        traced().write("profiler", event="started", blocks=target,
                       logdir=logdir)
        return True

    def _stop(self) -> None:
        from celestia_app_tpu_torch.trace.tracer import traced

        try:
            self._prof.__exit__(None, None, None)
            path = os.path.join(profile_dir(), f"trace-{os.getpid()}.json")
            self._prof.export_chrome_trace(path)
            self.trace_path = path
            traced().write("profiler", event="stopped", logdir=profile_dir(),
                           path=path)
        except Exception as e:  # noqa: BLE001
            traced().write("profiler", event="stop_failed",
                           error=f"{type(e).__name__}: {e}"[:200])
        self._prof = None
        self._active = False
        self._done = True  # one window per process


_PROFILER = BlockProfiler()


def block_profiler() -> BlockProfiler:
    return _PROFILER


def hbm_high_water(device=None) -> int | None:
    """Peak bytes the caching allocator has held on `device` (default: the
    current card), or None when the process has no card or has not used
    it (a CUDA context is never created for the reading).  A counter read,
    never a device sync."""
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        peak = torch.cuda.max_memory_allocated(device)
    except Exception:  # noqa: BLE001 — absent API / odd build
        return None
    return int(peak) if peak else None


def rss_high_water() -> int | None:
    """Process peak RSS in bytes (resource.getrusage ru_maxrss) — the
    memory high-water of a process without a card.  A lifetime peak, never
    a per-phase one: comparing two configurations needs one process each."""
    try:
        import resource

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    except Exception:  # noqa: BLE001 — absent module/odd platform: no sample
        return None
    if not peak:
        return None
    import sys

    # Linux reports KiB; macOS bytes.
    return int(peak) * (1 if sys.platform == "darwin" else 1024)


def record_hbm_high_water(point: str = "dispatch",
                          k: int | None = None) -> int | None:
    """Refresh celestia_hbm_peak_bytes{point,k,source} and journal the
    sample; returns the peak bytes.  The card's allocator peak when the
    process uses a card (source="device"), else the process peak RSS
    (source="rss"); None only when neither source can answer."""
    peak, source = hbm_high_water(), "device"
    if peak is None:
        peak, source = rss_high_water(), "rss"
    if peak is None:
        return None
    from celestia_app_tpu_torch.trace.metrics import registry
    from celestia_app_tpu_torch.trace.tracer import traced

    labels = {"point": point, "source": source}
    if k is not None:
        labels["k"] = str(k)
    registry().gauge(
        "celestia_hbm_peak_bytes",
        "memory high-water mark (device allocator peak, or process peak "
        "RSS without a card — see the source label)",
    ).set(peak, **labels)
    traced().write("hbm_high_water", point=point, k=k, peak_bytes=peak,
                   source=source)
    return peak
