"""The benchmark's data, found by name: `BENCHMARK.json` at the checkout's
root names each cell's configuration and traffic mix, and every one of
them, every layer's kernel map and every per-layer metric's reader is a
file of its own under `dabench/`:

  configs/<config>.json        sizes, environment, guarantees, the reference
  traffic/<traffic>.json       parameters of one mix; its `entry` names
  entries/<entry>.py           the driver of that kind of traffic
  layers/<file>.json           a layer's name and its profiler kernel patterns
  layer_metrics/<metric>.py    one per-layer metric's reader: read(window)

Nothing here lists a cell, a mix, a layer or a metric: adding one is
adding its file (and its entry in BENCHMARK.json).
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from functools import cached_property
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Layer:
    name: str  # as BENCHMARK.json and PERF.md name it
    kernels: tuple[str, ...]  # regular expressions searched in profiler names
    counters: tuple[str, ...]  # the program's launch counters of those kernels

    def owns(self, op_name: str) -> bool:
        return any(re.search(p, op_name) for p in self.kernels)


class Bench:
    """BENCHMARK.json of a checkout and the files under `package`."""

    def __init__(self, root: Path | str, package: Path | str | None = None):
        self.root = Path(root)
        self.package = Path(package) if package is not None else PACKAGE
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        entry = next(c for c in self.data["configs"] if c["name"] == cell["config"])
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        return json.loads((self.package / "traffic" / f"{cell['traffic']}.json").read_text())

    def entry(self, traffic: dict):
        return load_module(self.package / "entries" / f"{traffic['entry']}.py")

    def end_to_end(self, cell: dict) -> list[dict]:
        return [m for m in self.data["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict) -> list[dict]:
        return [m for m in self.data["per_layer"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, metric: dict):
        return load_module(self.package / "layer_metrics" / f"{metric['name']}.py")

    @cached_property
    def layers(self) -> dict[str, Layer]:
        out = {}
        for path in sorted((self.package / "layers").glob("*.json")):
            d = json.loads(path.read_text())
            out[d["layer"]] = Layer(d["layer"], tuple(d.get("kernels", ())),
                                    tuple(d.get("counters", ())))
        return out


def load_module(path: Path):
    """Import one file by path (a metric's name has dots, so it is no
    module name)."""
    name = "dabench_" + re.sub(r"\W", "_", str(path.relative_to(path.parents[1])))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
