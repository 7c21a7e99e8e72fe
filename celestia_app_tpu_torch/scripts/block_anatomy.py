#!/usr/bin/env python
"""Render a height-anatomy timeline: waterfall + phase-budget table.

The reader for celestia_app_tpu_torch/trace/timeline.py — three sources
(`python -m celestia_app_tpu_torch.scripts.block_anatomy`, below `ba`):

  ba [--device cpu]                       local N-block run
  ba --url http://n1:26657                a live node's GET /timeline
  ba --bundle flight.json                 a flight bundle's embedded block

The default (no --url/--bundle) drives a REAL streamed run through the
repo's own machinery: deterministic squares through BlockPipeline under
per-height trace contexts (so the block journal's stage rows stitch),
retention through ForestCache (forest-build rows), and one DAS proof per
height through the batching sampler (the first-serve event that closes
each record) — then renders what the timeline observed.

Output: per-height waterfall (`--height H` for one; latest otherwise),
then the run's phase-budget table — mean / p95 / share-of-height-time
per phase and per gap, critical-phase counts.

`--round-out TL_rNN.json` additionally records the distribution as a
trend round (schema tl-v1) for scripts/bench_trend.py, which gates every
`tl.<phase>.share` series against prior rounds: a phase quietly growing
its share of height time fails `--check` like any mode regression.  The
`platform` field labels CPU runs honestly.

The port's copy of scripts/block_anatomy.py: the local run streams on
`--device` (default CUDA, which raises without a card; `cpu` runs the plain
PyTorch versions of the kernels), the record's `platform` names the card
and its power limit (or "cpu") where JAX names its backend, and the
defaults the JAX script sets at import ($CELESTIA_TRACE=on, the timeline's
ring) are set by `main` for its run and restored after it: importing the
module sets nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from celestia_app_tpu_torch.device import resolve_device
from celestia_app_tpu_torch.scripts.common import (
    add_device_argument,
    deterministic_square,
    platform_label,
    restored_env,
)

BAR_WIDTH = 48


# --- the local streamed run ---------------------------------------------------

def run_stream(blocks: int, k: int, seed: int, depth: int = 2,
               device=None) -> dict:
    """Stream `blocks` squares end to end — pipeline, retention, one
    served sample per height — and return the local timeline's
    full-record payloads keyed by height."""
    from celestia_app_tpu_torch.parallel.pipeline import BlockPipeline
    from celestia_app_tpu_torch.serve.cache import ForestCache
    from celestia_app_tpu_torch.trace.context import new_context, use_context
    from celestia_app_tpu_torch.trace.timeline import timeline

    dev = resolve_device(device)
    heights = list(range(1, blocks + 1))
    ctxs = {h: new_context().child(height=h) for h in heights}
    cache = ForestCache(heights=blocks, spill=blocks, device=dev)
    pipe = BlockPipeline(k, depth, device=dev)
    results = {}
    try:
        # The stream_blocks windowed interleave, with one twist: every
        # submit AND its matching drain run under that height's trace
        # context, so the journal row written at drain time carries the
        # right height even though one thread drains all of them
        # (drains yield in submission order).
        from celestia_app_tpu_torch.serve.sampler import ProofSampler

        sampler = ProofSampler(device=dev)
        submitted = drained = 0
        window = max(depth, pipe.batch)

        def drain_next(one):
            nonlocal drained
            dh = heights[drained]
            with use_context(ctxs[dh]):
                tag, eds = one()
                assert tag == dh, (tag, dh)
                # Retain and serve IN the stream, like a real node: the
                # forest build anchors right after the drain, and the
                # served sample writes the height-stamped proof_serve
                # row that closes (finalizes) the record.
                entry = cache.put(dh, eds)
                sampler.share_proof(entry, 0, 0)
            results[dh] = eds
            drained += 1

        for h in heights:
            while submitted - drained > window:
                drain_next(pipe._drain_one)
            with use_context(ctxs[h]):
                pipe.submit(deterministic_square(k, seed + h), tag=h)
            submitted += 1
        gen = pipe.drain()
        while drained < len(heights):
            drain_next(lambda: next(gen))
    finally:
        pipe.close()
    tl = timeline()
    return {
        h: payload
        for h in heights
        if (payload := tl.record_payload(h)) is not None
    }


# --- remote / bundle sources --------------------------------------------------

def fetch_url(url: str) -> dict:
    """Pull GET /timeline and every retained full record off a live node."""
    from urllib.request import urlopen

    def get(path: str) -> dict:
        with urlopen(url.rstrip("/") + path, timeout=10) as resp:
            return json.loads(resp.read())

    index = get("/timeline")
    records = {}
    for h in index.get("heights") or []:
        try:
            records[h] = get(f"/timeline?height={h}")
        except Exception:  # noqa: BLE001 — ring may advance mid-pull
            continue
    return records


def from_bundle(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        bundle = json.load(f)
    block = bundle.get("timeline") or {}
    records = {}
    latest = block.get("latest")
    if isinstance(latest, dict):
        records[latest.get("height")] = latest
    for rec in block.get("records") or []:
        records.setdefault(rec.get("height"), rec)
    return records


# --- rendering ----------------------------------------------------------------

def waterfall(record: dict) -> list[str]:
    """ASCII waterfall of one height's intervals ('#' phases, '.' gaps)."""
    out = [
        f"height {record.get('height')}  span {record.get('span_ms')} ms  "
        f"critical={record.get('critical_phase')} "
        f"({record.get('critical_ms')} ms)"
        + ("" if record.get("finalized") else "  [open]")
    ]
    intervals = record.get("intervals") or []
    if not intervals:
        # Summaries carry no intervals: fall back to the phase budget.
        for name, ms in sorted((record.get("phases") or {}).items(),
                               key=lambda kv: -kv[1]):
            out.append(f"  {name:<18} {ms:>10.3f} ms")
        return out
    span = max((iv["end_ms"] for iv in intervals), default=0.0) or 1.0
    for iv in intervals:
        lo = int(iv["start_ms"] / span * BAR_WIDTH)
        hi = max(lo + 1, int(iv["end_ms"] / span * BAR_WIDTH))
        mark = "." if iv["kind"] == "gap" else "#"
        bar = " " * lo + mark * (hi - lo)
        out.append(
            f"  {iv['phase']:<18} |{bar:<{BAR_WIDTH}}| "
            f"{iv['end_ms'] - iv['start_ms']:>9.3f} ms"
        )
    return out


def _p95(values: list[float]) -> float:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(0.95 * len(ordered)))]


def phase_budget(records: dict) -> dict:
    """Aggregate {phases, gaps, critical_counts, total_ms} over full or
    summary records: per-name mean/p95/share, where share is the name's
    fraction of ALL accounted height time in the run."""
    per_phase: dict[str, list[float]] = {}
    per_gap: dict[str, list[float]] = {}
    critical: dict[str, int] = {}
    total = 0.0
    for rec in records.values():
        for name, ms in (rec.get("phases") or {}).items():
            per_phase.setdefault(name, []).append(ms)
            total += ms
        for name, ms in (rec.get("gaps") or {}).items():
            per_gap.setdefault(name, []).append(ms)
            total += ms
        cp = rec.get("critical_phase")
        if cp:
            critical[cp] = critical.get(cp, 0) + 1

    def dist(samples: dict[str, list[float]]) -> dict:
        return {
            name: {
                "mean_ms": round(sum(v) / len(v), 3),
                "p95_ms": round(_p95(v), 3),
                "share": round(sum(v) / total, 4) if total else 0.0,
            }
            for name, v in sorted(samples.items())
        }

    return {
        "phases": dist(per_phase),
        "gaps": dist(per_gap),
        "critical_counts": dict(sorted(critical.items())),
        "total_ms": round(total, 3),
    }


def budget_table(budget: dict) -> list[str]:
    out = [f"  {'phase':<20} {'mean ms':>10} {'p95 ms':>10} {'share':>8}  "
           f"critical"]
    rows = [("phase", n, d) for n, d in budget["phases"].items()]
    rows += [("gap", n, d) for n, d in budget["gaps"].items()]
    rows.sort(key=lambda r: -r[2]["share"])
    for kind, name, d in rows:
        label = name if kind == "phase" else f"{name} (gap)"
        crit = budget["critical_counts"].get(name, 0)
        out.append(
            f"  {label:<20} {d['mean_ms']:>10.3f} {d['p95_ms']:>10.3f} "
            f"{d['share'] * 100:>7.1f}%  {crit or ''}"
        )
    return out


def round_payload(budget: dict, blocks: int, k: int, n: int,
                  platform: str) -> dict:
    return {
        "schema": "tl-v1",
        "n": n,
        "platform": platform,
        "k": k,
        "blocks": blocks,
        "phases": budget["phases"],
        "gaps": budget["gaps"],
        "critical_counts": budget["critical_counts"],
        "total_ms": budget["total_ms"],
    }


def _round_n(path: str) -> int:
    import re

    m = re.search(r"_r(\d+)\.json$", os.path.basename(path))
    return int(m.group(1)) if m else 1


def main(argv=None) -> int:
    with restored_env("CELESTIA_TRACE", "CELESTIA_TIMELINE_HEIGHTS"):
        os.environ.setdefault("CELESTIA_TRACE", "on")
        return _main(argv)


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url", help="live node base URL (GET /timeline)")
    ap.add_argument("--bundle", help="flight bundle with a timeline block")
    ap.add_argument("--blocks", type=int, default=16,
                    help="local run length in blocks (default 16)")
    ap.add_argument("--k", type=int, default=16,
                    help="local run square size (default 16)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--height", type=int,
                    help="waterfall this height (default: latest)")
    ap.add_argument("--round-out", metavar="TL_rNN.json",
                    help="write the phase-budget distribution as a "
                         "bench_trend round (schema tl-v1)")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.url:
        records = fetch_url(args.url)
        source = args.url
    elif args.bundle:
        records = from_bundle(args.bundle)
        source = args.bundle
    else:
        os.environ.setdefault(
            "CELESTIA_TIMELINE_HEIGHTS", str(max(64, args.blocks))
        )
        records = run_stream(args.blocks, args.k, args.seed, device=device)
        source = f"local run ({args.blocks} blocks, k={args.k})"
    records = {h: r for h, r in records.items() if h is not None}
    if not records:
        print(f"block_anatomy: no timeline records from {source}",
              file=sys.stderr)
        return 2

    print(f"# height anatomy — {source}")
    pick = args.height if args.height is not None else max(records)
    if pick not in records:
        print(f"block_anatomy: no record at height {pick} "
              f"(have {sorted(records)})", file=sys.stderr)
        return 2
    for line in waterfall(records[pick]):
        print(line)
    budget = phase_budget(records)
    print()
    print(f"phase budget over {len(records)} heights "
          f"(accounted {budget['total_ms']} ms):")
    for line in budget_table(budget):
        print(line)

    if args.round_out:
        platform = platform_label(device)
        payload = round_payload(
            budget, blocks=len(records),
            k=args.k if not (args.url or args.bundle) else 0,
            n=_round_n(args.round_out), platform=platform,
        )
        with open(args.round_out, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"\nwrote {args.round_out} (platform={platform}"
              + (", CPU — not a hardware number"
                 if platform == "cpu" else "") + ")")
    return 0


if __name__ == "__main__":
    sys.exit(main())
