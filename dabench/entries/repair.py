"""Repair: a full node reconstructs blocks whose shares were withheld,
calling the program's `da.repair.repair(shares, present, dah)` one at a
time in a closed loop, each call given its square's DAH as a node calls
it.

The traffic mix gives the `pool` of distinct squares, the quadrant
`withhold`n ("q0": the ODS itself, rows and columns below k), the
`warm_repairs` made in set-up and the `check_sample` of repaired squares
compared byte for byte with the reference.  Set-up extends each pool
square with the program, as the node that published it did, and keeps
its EDS with the quadrant zeroed on the card, where a node's serving
cache holds the shares it gathered (serve/heal hands repair the same), with
the availability mask and the DAH.

Each repair is timed from the call until it returns the EDS, its roots
checked against the DAH, and its data root is on the host.  Every repair
issued inside the window counts, the last one waited for;
`repair_p95_ms` is the nearest-rank 95th percentile of their times.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from dabench import squares
from dabench.harness import percentile
from dabench.sample import Reservoir

QUADRANTS = {"q0": (0, 0), "q1": (0, 1), "q2": (1, 0), "q3": (1, 1)}


def _repair():
    import importlib

    # da/__init__ re-exports the function under the module's name.
    return importlib.import_module("celestia_app_tpu_torch.da.repair").repair


def _attempt(run, j: int):
    st = run.state
    t0 = time.perf_counter()
    out = _repair()(st["damaged"][j], st["present"], st["dah"][j], device=run.device)
    droot = out.data_root()
    return out, droot, time.perf_counter() - t0


def setup(run) -> None:
    from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader
    from celestia_app_tpu_torch.da.eds import ExtendedDataSquare

    torch = run.torch
    t, k = run.traffic, run.k
    pool, _ = squares.pool(k, t["pool"], run.seed, t["layout"], run.device)
    qr, qc = QUADRANTS[t["withhold"]]
    present = np.ones((2 * k, 2 * k), dtype=bool)
    present[qr * k:(qr + 1) * k, qc * k:(qc + 1) * k] = False
    damaged, dah = [], []
    for ods in pool:
        eds = ExtendedDataSquare.compute(ods, device=run.device)
        dah.append(DataAvailabilityHeader.from_eds(eds))
        host = eds.squared()
        host[~present] = 0
        damaged.append(torch.from_numpy(host).to(run.device))
        del eds, host
    run.state.update(pool=pool, present=present, damaged=damaged, dah=dah, roots=[],
                     times=[], reservoir=Reservoir(t["check_sample"], run.seed, 2))
    for i in range(t["warm_repairs"]):
        _attempt(run, i % len(pool))


def measure(run) -> None:
    st = run.state
    res = st["reservoir"]
    n = len(st["pool"])
    with run.window():
        t_end = time.perf_counter() + run.seconds
        i = 0
        while time.perf_counter() < t_end:
            run.attempted = i + 1
            out, droot, seconds = _attempt(run, i % n)
            st["roots"].append((i % n, droot))
            st["times"].append(seconds)
            slot = res.slot()
            if slot is not None:
                res.keep(slot, i, (i % n, out))
            del out
            i += 1
    run.ops = run.traced_ops = len(st["times"])
    run.e2e["repair_p95_ms"] = percentile(st["times"], 95) * 1e3
    print("repair ms: " + ", ".join(f"p{q} {percentile(st['times'], q) * 1e3:.3f}"
                                     for q in (5, 50, 90, 95, 99, 100))
          + f" over {run.ops} repairs", file=sys.stderr)


def release(run) -> None:
    from celestia_app_tpu_torch.trace.device_ledger import release_device_caches

    release_device_caches()


def check(run) -> list[tuple]:
    """Every repair's data root, and the sampled repairs' EDS bytes and
    row and column roots, against the reference's of the same square."""
    st = run.state
    ref = run.reference()
    rr, cr, dr = ref.roots(st["pool"])
    roots_mismatched = sum(droot != dr[j].tobytes() for j, droot in st["roots"])
    sampled = st["reservoir"].items()
    eds_mismatched = 0
    for _i, (j, out) in sampled:
        want = ref.eds(st["pool"][j]).cpu().numpy()
        same = (np.array_equal(out.squared(), want)
                and b"".join(out.row_roots()) == rr[j].tobytes()
                and b"".join(out.col_roots()) == cr[j].tobytes())
        eds_mismatched += not same
    return [("data_roots_mismatched", roots_mismatched, 0, "at_most"),
            ("squares_mismatched", eds_mismatched, 0, "at_most"),
            ("squares_compared", len(sampled), min(run.traffic["check_sample"], run.attempted),
             "at_least")]
