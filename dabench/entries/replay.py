"""Replay: a node syncing blocks streams squares through the program's
block pipeline (celestia_app_tpu_torch.parallel.stream_blocks) in a closed
loop and waits for each square's data root.

The traffic mix gives the pipeline's `depth` and `batch`, the `pool` of
distinct squares made in set-up, the `warm_squares` streamed before the
window, the `check_sample` of window squares whose roots are compared with
the reference, and the squares' `layout` (dabench/squares.py).  Besides
that sample, every square of one whole dispatch of the widest batch is
compared by its data root, so that each position in a batch is checked.  Each square submitted is
a pool square stamped with its own height, so no two are alike.

One stream runs from set-up to the end: the warm squares go first, and
the window opens when the last of them has drained, with the pipeline
primed.  The feed stops at the window's end; squares whose data root
reached the host by then count.  The mix's `rate_metric` (`replay_MBps`)
is their ODS bytes (10^6 per MB) over the window's seconds.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from dabench import squares
from dabench.sample import Reservoir

WARM_BASE = 1 << 62  # heights of the warm squares, far above the window's


def _feed(st: dict, warm: int):
    pool, at = st["pool"], st["at"]
    for i in range(warm):
        j = i % len(pool)
        yield WARM_BASE + i, squares.stamp(pool[j], at[j], WARM_BASE + i)
    h = 0
    while st["t_end"] is None or time.perf_counter() < st["t_end"]:
        j = h % len(pool)
        yield h, squares.stamp(pool[j], at[j], h)
        h += 1
        st["submitted"] = h


def setup(run) -> None:
    from celestia_app_tpu_torch.da.eds import warmup
    from celestia_app_tpu_torch.parallel import stream_blocks

    t, k = run.traffic, run.k
    if t["pool"] <= 2 * (max(t["depth"], t["batch"]) + 1):
        raise ValueError("the pool must hold more squares than twice the pipeline's "
                         "outstanding ones, so a pool square is never restamped in flight")
    pool, at = squares.pool(k, t["pool"], run.seed, t["layout"], run.device)
    warmup([k], batches=tuple(range(2, t["batch"] + 1)), device=run.device)
    st = run.state
    st.update(pool=pool, at=at, t_end=None, submitted=0, roots={},
              reservoir=Reservoir(t["check_sample"], run.seed, 1))
    st["it"] = stream_blocks(_feed(st, t["warm_squares"]), k, depth=t["depth"],
                             batch=t["batch"], device=run.device)
    last = WARM_BASE + t["warm_squares"] - 1
    for tag, eds in st["it"]:
        eds.data_root()
        if tag == last:
            break


def measure(run) -> None:
    from celestia_app_tpu_torch.trace import journal

    st, k = run.state, run.k
    roots, res = st["roots"], st["reservoir"]
    done = []  # when each window square's root reached the host
    with run.window():
        t_start = time.perf_counter()
        st["t_end"] = t_start + run.seconds
        for tag, eds in st["it"]:
            droot = eds.data_root()
            now = time.perf_counter()
            if now <= st["t_end"]:
                done.append(now)
            roots[tag] = droot
            slot = res.slot()
            if slot is not None:
                res.keep(slot, tag, (eds.row_roots(), eds.col_roots(), droot))
    in_window = run.ops = len(done)
    # Every window square ran on the device inside the traced interval but
    # those the stream took in before it opened: at most max(depth, batch).
    run.traced_ops = st["submitted"]
    run.attempted = st["submitted"]
    run.failed = run.attempted - len(roots)
    odsb = k * k * squares.SHARE_SIZE
    run.e2e[run.traffic["rate_metric"]] = in_window * odsb / 1e6 / run.seconds
    run.journal = [r for r in journal.rows("stream") if int(r["tag"]) < WARM_BASE]
    fifths = np.histogram(done, bins=5, range=(t_start, st["t_end"]))[0]
    print(f"replay: {in_window} squares in the window of {run.attempted} submitted; "
          f"per fifth of the window {fifths.tolist()}", file=sys.stderr)


def release(run) -> None:
    from celestia_app_tpu_torch.trace.device_ledger import release_device_caches

    run.state.pop("it", None)
    release_device_caches()


def whole_batches(rows) -> list[list[int]]:
    """The window's complete dispatches, each the heights of its squares in
    order: consecutive stream rows that carry one dispatch's figures (the
    program writes a dispatch's row once for each of its squares), as many
    as its batch size."""
    groups = []
    for r in rows:
        key = (r.get("batch_size", 1), r.get("dispatch_ms"), r.get("upload_ms"))
        if groups and groups[-1][0] == key:
            groups[-1][1].append(int(r["tag"]))
        else:
            groups.append((key, [int(r["tag"])]))
    return [tags for key, tags in groups if len(tags) == key[0]]


def _one_batch(run) -> list[int]:
    """Heights of one dispatch of the widest batch, drawn from the seed; a
    run of 2 x batch consecutive heights (which holds whole dispatches)
    where the journal shows none."""
    st = run.state
    rng = np.random.default_rng([run.seed, 4])
    batches = [b for b in whole_batches(run.journal) if all(h in st["roots"] for h in b)]
    if batches:
        widest = max(map(len, batches))
        batches = [b for b in batches if len(b) == widest]
        return batches[int(rng.integers(len(batches)))]
    heights = sorted(h for h in st["roots"] if h < WARM_BASE)
    n = min(2 * run.traffic["batch"], len(heights))
    start = int(rng.integers(len(heights) - n + 1)) if heights else 0
    return heights[start:start + n]


def check(run) -> list[tuple]:
    """The sampled squares' row, column and data roots, and the data roots
    of every square of one whole dispatch, against the reference's; and
    every window square's data root distinct (each square differs, so a
    repeated root is a stale output)."""
    st = run.state
    pool, at = st["pool"], st["at"]
    sampled = st["reservoir"].items()
    batch = _one_batch(run)
    heights = [h for h, _ in sampled] + batch
    odss = [squares.stamp(pool[h % len(pool)].copy(), at[h % len(pool)], h) for h in heights]
    t0 = time.perf_counter()
    rr, cr, dr = run.reference().roots(odss)
    print(f"reference: {len(odss)} squares in {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    mismatched = 0
    for i, (_h, (g_rr, g_cr, g_dr)) in enumerate(sampled):
        same = (g_dr == dr[i].tobytes()
                and np.array_equal(np.frombuffer(b"".join(g_rr), np.uint8), rr[i].ravel())
                and np.array_equal(np.frombuffer(b"".join(g_cr), np.uint8), cr[i].ravel()))
        mismatched += not same
    batch_mismatched = sum(st["roots"][h] != dr[len(sampled) + i].tobytes()
                           for i, h in enumerate(batch))
    repeated = len(st["roots"]) - len(set(st["roots"].values()))
    return [("squares_mismatched", mismatched, 0, "at_most"),
            ("squares_compared", len(sampled), min(run.traffic["check_sample"], run.attempted),
             "at_least"),
            ("batch_squares_mismatched", batch_mismatched, 0, "at_most"),
            ("batch_squares_compared", len(batch), 1, "at_least"),
            ("data_roots_repeated", repeated, 0, "at_most")]
