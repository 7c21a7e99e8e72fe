"""The control of the comparison that decides `correct`: the plain reference
put in the program's place with its GF(2) products in bfloat16, the
precision below the reference's float32, so that sums above 256 lose
their lowest bit.  It has to come out as not correct.

    python3 -m dabench.control --workload <name> --seeds <n>[,<n>...] --seconds <s>

runs the cell once per seed through the harness's own `run_cell`, at the
cell's own size and traffic, with the program's timed entry replaced by
the control: for a replay cell the block stream (each batch's squares
extended and their roots taken by the control), for a repair cell the
repair (Q0 interpolated back from Q1, the square re-extended and its roots
taken by the control).  It prints each run's `correct` and the numbers
compared.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


class Square:
    """What the harness reads of an EDS, from the control's outputs."""

    def __init__(self, eds, rr, cr, dr):
        self._eds, self._rr, self._cr, self._dr = eds, rr, cr, dr

    def squared(self) -> np.ndarray:
        return self._eds.cpu().numpy()

    def row_roots(self) -> list[bytes]:
        return [r.tobytes() for r in self._rr]

    def col_roots(self) -> list[bytes]:
        return [c.tobytes() for c in self._cr]

    def data_root(self) -> bytes:
        return self._dr.tobytes()


def stream_blocks_of(control):
    """A stand-in for the program's stream_blocks: each batch of the feed
    extended and its roots taken by `control`, in submission order."""

    def flush(group):
        if group:
            rr, cr, dr = control.roots([ods for _, ods in group])
            for i, (tag, _) in enumerate(group):
                yield tag, Square(None, rr[i], cr[i], dr[i])

    def stream_blocks(ods_iter, k, depth=2, batch=None, device=None):
        group = []
        for tag, ods in ods_iter:
            group.append((tag, np.array(ods)))  # a copy: the feed restamps its pool
            if len(group) == (batch or 1):
                yield from flush(group)
                group = []
        yield from flush(group)

    return stream_blocks


def repair_of(control):
    """A stand-in for the program's repair of a square whose Q0 is withheld:
    Q0 interpolated back from Q1, re-extended and its roots taken by
    `control`.  It checks no DAH: the harness's comparison has to catch
    what it gets wrong."""
    from dabench.reference import nmt

    def repair(shares, present, dah=None, *, height=None, device=None):
        k = control.k
        q0 = np.zeros((2 * k, 2 * k), dtype=bool)
        q0[:k, :k] = True
        if not np.array_equal(~np.asarray(present, dtype=bool), q0):
            raise ValueError("the control repairs a withheld Q0 only")
        eds = control.eds(control.recover_ods(shares))
        rr, cr, dr = nmt.roots(nmt.leaf_digests(eds, k)[None])
        return Square(eds, rr[0].cpu().numpy(), cr[0].cpu().numpy(), dr[0].cpu().numpy())

    return repair


@contextlib.contextmanager
def substituted(bench, name: str, device):
    """The program's timed entry of cell `name` replaced by the control
    while the block runs."""
    import torch

    from dabench.harness import reference_module

    cell = bench.cell(name)
    config, traffic = bench.config(cell), bench.traffic(cell)
    control = reference_module(config).Reference(config["square_size"], config["construction"],
                                                 device, dtype=torch.bfloat16)
    if traffic["entry"] == "replay":
        target, attr = importlib.import_module("celestia_app_tpu_torch.parallel"), "stream_blocks"
        stand_in = stream_blocks_of(control)
    elif traffic["entry"] == "repair":
        # da/__init__ re-exports the function under the module's name.
        target, attr = importlib.import_module("celestia_app_tpu_torch.da.repair"), "repair"
        stand_in = repair_of(control)
    else:
        raise ValueError(f"no control for entry {traffic['entry']!r}")
    saved = getattr(target, attr)
    setattr(target, attr, stand_in)
    try:
        yield
    finally:
        setattr(target, attr, saved)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from dabench.harness import run_cell
    from dabench.run import prepare_environment
    from dabench.spec import Bench

    bench = Bench(ROOT)
    prepare_environment(bench.config(bench.cell(args.workload)))
    for seed in (int(s) for s in args.seeds.split(",")):
        with substituted(bench, args.workload, args.device):
            result = run_cell(bench, args.workload, seed, args.seconds, False, args.device,
                              time.perf_counter())
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"], "checks": result["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
