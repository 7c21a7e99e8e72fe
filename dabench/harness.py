"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

The cell's entry (dabench/entries/<entry>.py, named by its traffic mix)
supplies four steps, each given the `Run`:

  setup(run)    make the inputs from the seed, warm the program's shapes
  measure(run)  drive the program for run.seconds inside `run.window()`;
                set run.ops, run.traced_ops, run.attempted, run.failed
                and run.e2e
  release(run)  free the program's device state, keeping what check reads
  check(run)    compare the window's outputs with the reference: a list of
                (name, value, limit, sense) with sense "at_most" or
                "at_least"

The harness reads the device's peak memory between measure and release,
so the reference, which runs in check, never sets it.
"""

from __future__ import annotations

import gc
import math
import sys
import time
import traceback
from dataclasses import dataclass, field

from dabench import devicetrace
from dabench.spec import Bench

#: Longest window of a traced run: the profiler's device activity is read
#: over at most this many seconds (fewer events to drop and to reduce).
TRACED_SECONDS = 10.0

#: Extra kernels the profiler may see over the launch counters' delta, as a
#: share of it: launches counted just before the window whose kernels ran
#: inside it.  Fewer than counted is never accepted.
CROSS_CHECK_SLACK = 0.02


@dataclass
class Run:
    bench: Bench
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    torch: object
    ops: int = 0  # operations completed inside the window
    traced_ops: int = 0  # operations whose device work the window's interval holds
    attempted: int = 0
    failed: int = 0
    e2e: dict = field(default_factory=dict)
    journal: list = field(default_factory=list)  # the window's journal rows
    activity: devicetrace.Activity | None = None
    state: dict = field(default_factory=dict)  # the entry's own

    @property
    def k(self) -> int:
        return self.config["square_size"]

    @property
    def m(self) -> int:
        return self.config["field_bits"]

    def window(self) -> devicetrace.Window:
        win = devicetrace.Window(self.torch, launch_counters, self.trace)
        self.activity = win.activity
        return win

    def reference(self):
        """The configuration's plain reference (dabench/reference/<name>)."""
        return reference_module(self.config).Reference(self.k, self.config["construction"],
                                                       self.device)


def reference_module(config: dict):
    import importlib

    return importlib.import_module(f"dabench.reference.{config['reference']}")


def launch_counters() -> dict[str, int]:
    from celestia_app_tpu_torch.kernels import _build

    return dict(_build.LAUNCHES)


@dataclass
class LayerView:
    """What a per-layer metric's reader gets: read(view) -> number or None."""

    run: Run
    layers: dict  # layer name -> spec.Layer
    cross_check_ok: bool

    @property
    def k(self) -> int:
        return self.run.k

    @property
    def m(self) -> int:
        return self.run.m

    @property
    def traced_ops(self) -> int:
        return self.run.traced_ops

    @property
    def activity(self) -> devicetrace.Activity:
        return self.run.activity

    def device_time_s(self, layer: str) -> float:
        return sum(e - s for s, e, _ in devicetrace.layer_events(self.activity.events,
                                                                 self.layers[layer])) / 1e6


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with q % of all at or below."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Run cell `name` on `device`; returns the result line as a dict."""
    import torch

    cell = bench.cell(name)
    traffic = bench.traffic(cell)
    entry = bench.entry(traffic)
    run = Run(bench, cell, bench.config(cell), traffic, seed,
              min(seconds, TRACED_SECONDS) if trace else seconds, trace, torch.device(device),
              torch)
    cuda = run.device.type == "cuda"
    entry.setup(run)
    setup_s = time.perf_counter() - t_start
    error = None
    t0 = time.perf_counter()
    try:
        entry.measure(run)
    except Exception as e:  # the program failed inside the window: reported, not hidden
        traceback.print_exc()
        error = e
        run.failed = max(run.failed, 1)
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    entry.release(run)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    checks = [] if error is not None else entry.check(run)
    print(f"seconds: set-up {setup_s:.3f}, window and drain {t1 - t0:.3f}, release and "
          f"check {time.perf_counter() - t1:.3f}", file=sys.stderr)
    passed = [value <= limit if sense == "at_most" else value >= limit
              for _name, value, limit, sense in checks]
    correct = error is None and run.failed == 0 and run.ops > 0 and bool(checks) and all(passed)

    metrics = {}
    result_device = {"platform": "gpu" if cuda else "cpu",
                     "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
                     "count": cell["chips"], "memory_peak_bytes": peak}
    breakdown = None
    if not trace:
        for m in bench.end_to_end(cell):
            value = setup_s if m["name"] == "setup_s" else run.e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    elif run.activity is not None:
        act = run.activity
        ok, said = devicetrace.cross_check(act, bench.layers.values(), CROSS_CHECK_SLACK)
        print(f"launch cross-check ({'agree' if ok else 'disagree'}): {said}", file=sys.stderr)
        if not ok:
            print("the profiler's device activity disagrees with the program's launch "
                  "counters: no idle share or roofline from this run", file=sys.stderr)
        view = LayerView(run, bench.layers, ok)
        for m in bench.per_layer(cell):
            value = None if error is not None else bench.reader(m).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result_device["busy_s"] = devicetrace.busy_s(act.events)
        result_device["window_s"] = act.window_s
        breakdown = {"device_ops": devicetrace.device_ops(act.events),
                     "idle_gaps": devicetrace.idle_gaps(act.events)}

    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, sense: limit} for n, v, limit, sense in checks}
    for n, v, limit, sense in checks:
        print(f"check {n}: {v} ({sense.replace('_', ' ')} {limit})", file=sys.stderr)
    return result
