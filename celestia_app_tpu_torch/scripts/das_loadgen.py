#!/usr/bin/env python
"""DAS sampling load generator: thousands of queued share samples, p50/p99.

The txsim of the read side.  Where txsim floods BroadcastTx, this floods
the proof plane: N worker threads draw seeded-random (height, row, col)
coordinates over M cached squares and push them through the batched
ProofSampler queue (serve/sampler.py) — exactly the path the three RPC
planes serve — measuring per-sample wall latency and aggregate
proofs/sec.  A seeded subset of proofs is verified against the committed
DAH data root, so a loadgen run that "performs well" while serving
garbage fails loudly.

Runs crypto-free (no signing stack): squares are deterministic synthetic
blocks admitted straight into a ForestCache, so the tool measures the
serve plane, not block production.  `--mode host` drives the pure-host
fallback for an A/B number; `--url` instead samples a LIVE node's
GET /das/share_proof endpoint over HTTP.

  python -m celestia_app_tpu_torch.scripts.das_loadgen [--device cpu] \
      --heights 4 --k 16 --samples 2000 --threads 8 \
      --metrics-out /tmp/das --round-out DAS_r01.json

SWARM mode (`--clients N`, N >= 1): instead of a few closed-loop
threads, the run simulates a light-client SWARM — 10^4..10^6 clients,
each bound to a tenant namespace by zipf popularity (`--zipf-a`),
arriving OPEN-LOOP as a Poisson process at `--rate` samples/sec (an
arrival is enqueued at its scheduled instant whether or not the plane
has caught up, so latency includes queue delay — the honest saturation
measurement a closed loop cannot make).  Heights skew hot
(`--hot-frac` on the newest height) with a cache-busting historical
tail (`--historical-frac` hits heights beyond retention, forcing the
rebuild path), and coordinates mix tenant-targeted reads with uniform
DAS sampling.  `--shard-sweep 1,8` re-runs the identical plan per
$CELESTIA_SERVE_SHARDS setting (serve/shard.py) so the proofs/sec
scaling curve lands in one DAS_rNN round, per shard count, next to
per-tenant p50/p99/SLO-burn columns (`--slo-ms`, 99% objective):

  python -m celestia_app_tpu_torch.scripts.das_loadgen [--device cpu] \
      --clients 20000 --tenants 8 --rate 300 --samples 2400 --k 16 \
      --shard-sweep 1,8 --round-out DAS_r02.json

QOS mode (`--qos-out QOS_rNN.json`, needs --clients): two swarm legs
under one $CELESTIA_QOS policy over the IDENTICAL honest plan —
`baseline` (no spammer) then `spam` (a spammer tenant firing
tenant-targeted reads at `--spam-mult` x its `--proof-rate-limit`).
Throttled samples are POLICY, not failures: they land in their own
per-tenant column and burn no SLO budget.  scripts/bench_trend.py
validates the round shape (malformed exits 2) and gates the
enforcement invariants: spammer throttled, honest tenants' p99 and
SLO burn no worse than the no-spammer leg.

Prints a one-line JSON summary; --metrics-out writes das_loadgen.prom
(the celestia_proof_* / celestia_serve_* families) + das_loadgen.jsonl;
--round-out writes the DAS_rNN.json record scripts/bench_trend.py reads
into its proofs/sec + proof-p99 trend series and regression gate (swarm
rounds carry schema "das-v2": workload, sweep rows, tenant columns).

The port's copy of scripts/das_loadgen.py.  Every mode takes `--device`
(default CUDA, which raises without a card; `cpu` runs the plain PyTorch
versions of the kernels) and passes it to the squares, forests, sampler
and verifier; a `--serve` child serves from it; importing the module sets
no environment variable and no `sys.path` entry.  The deliberate
differences from the JAX script:

  * the warm-up before a timed pass builds the kernels
    (kernels/_build.build() on a card) and runs one sampled and verified
    batch, where JAX warms its jit compiles: no first sample's latency
    holds nvcc;
  * the shard sweep clamps to the devices of `--device`'s type
    (parallel/mesh.device_count: the cards, or the 8 CPU shards);
  * `platform` in a record names the card and its power limit (or "cpu"),
    where JAX names its backend;
  * a proof fault of the card is retried there and raises
    device.DeviceFault past the last retry (chaos/degrade.retry_on_card),
    which a pass counts as a failure, never as a host answer.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

from celestia_app_tpu_torch.device import resolve_device
from celestia_app_tpu_torch.scripts.common import (
    add_device_argument,
    deterministic_square,
    platform_label,
    tenant_square,
)


def build_cache(heights: int, k: int, seed: int, device=None):
    from celestia_app_tpu_torch.da.eds import ExtendedDataSquare
    from celestia_app_tpu_torch.serve.cache import ForestCache

    dev = resolve_device(device)
    cache = ForestCache(heights=heights, spill=heights, device=dev)
    roots = {}
    for h in range(1, heights + 1):
        eds = ExtendedDataSquare.compute(deterministic_square(k, seed + h),
                                         device=dev)
        cache.put(h, eds)
        roots[h] = eds.data_root()
    return cache, roots


def warm_kernels(device) -> None:
    """Build every kernel before a timed pass (on a card; the CPU runs the
    plain versions), so that no sample's latency holds nvcc."""
    if resolve_device(device).type == "cuda":
        from celestia_app_tpu_torch.kernels import _build

        _build.build()


def _run_plan(sampler, cache, plan, threads, verify_every, roots,
              device=None):
    """One threaded pass over the sampling plan; returns
    (lat_ms sorted, failures, withheld [(height, row, col)], wall_s).
    A ShareWithheld is NOT a failure — it is the adversarial 410 path
    the run exists to exercise — and it never kills a worker."""
    from celestia_app_tpu_torch.serve.sampler import ShareWithheld
    from celestia_app_tpu_torch.serve.verify import verify_share_proof

    latencies: list[float] = []
    failures: list[str] = []
    withheld: list[tuple[int, int, int]] = []
    lock = threading.Lock()
    cursor = iter(range(len(plan)))

    def worker():
        while True:
            with lock:
                i = next(cursor, None)
            if i is None:
                return
            h, r, c, axis = plan[i]
            entry, _ = cache.get(h)
            t0 = time.perf_counter()
            try:
                proof = sampler.share_proof(entry, r, c, axis=axis)
            except ShareWithheld:
                with lock:
                    withheld.append((h, r, c))
                continue
            except Exception as e:  # noqa: BLE001 — a drop IS the measurement
                with lock:
                    failures.append(f"({h},{r},{c}): {type(e).__name__}: {e}")
                return
            dt = time.perf_counter() - t0
            ok = True
            if i % verify_every == 0:
                # The client-side check rides the batched verifier
                # (serve/verify.py), the same program a light-client
                # fleet amortizes queues through.
                ok = verify_share_proof(proof, roots[h], device=device)
            with lock:
                latencies.append(dt)
                if not ok:
                    failures.append(f"({h},{r},{c}): proof failed verify")

    t_start = time.perf_counter()
    workers = [
        threading.Thread(target=worker, daemon=True) for _ in range(threads)
    ]
    for t in workers:
        t.start()
    for t in workers:
        t.join()
    wall_s = time.perf_counter() - t_start
    return sorted(v * 1e3 for v in latencies), failures, withheld, wall_s


def _percentile(sorted_ms, p):
    """Nearest-rank percentile over an ascending ms list — the ONE
    formula every round record (closed-loop and swarm) feeds into
    bench_trend, so the two workloads can never drift apart."""
    if not sorted_ms:
        return None
    return round(sorted_ms[min(len(sorted_ms) - 1, int(p * len(sorted_ms)))], 3)


def _pass_stats(lat_ms, wall_s) -> dict:
    return {
        "samples": len(lat_ms),
        "wall_s": round(wall_s, 3),
        "proofs_per_s": round(len(lat_ms) / wall_s, 2) if wall_s else None,
        "proof_p50_ms": _percentile(lat_ms, 0.50),
        "proof_p99_ms": _percentile(lat_ms, 0.99),
    }


def run_local(args) -> dict:
    """Drive the in-process sampler queue with `threads` workers.

    With `--withhold-frac` the run becomes ADVERSARIAL: a withholding
    proposer (chaos/adversary.py, seeded by `--adv-seed`) hides that
    fraction of every height's shares, so workers exercise the 410
    detection path under load.  With `--heal` on top, every detected
    height is healed (serve/heal.py: gather survivors -> batched repair
    -> root-verify -> re-admit) and the SAME plan re-runs post-heal —
    the summary then reports pre-heal vs post-heal proofs/sec and the
    time from heal trigger to the first healed proof served."""
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.serve.sampler import ProofSampler

    dev = resolve_device(args.device)
    adversarial = args.withhold_frac > 0
    if adversarial:
        chaos.install(
            f"seed={args.adv_seed},withhold_frac={args.withhold_frac}"
        )
    try:
        cache, roots = build_cache(args.heights, args.k, args.seed, device=dev)
        sampler = ProofSampler(device=dev)
        n = 2 * args.k
        rng = np.random.default_rng(args.seed)
        axes = (
            ("row", "col") if args.axes == "both" else (args.axes,)
        )
        plan = [
            (int(rng.integers(1, args.heights + 1)),
             int(rng.integers(0, n)), int(rng.integers(0, n)),
             axes[int(rng.integers(0, len(axes)))])
            for _ in range(args.samples)
        ]
        verify_every = max(1, args.samples // max(args.verify, 1))
        # Warm the kernels and one sampled, verified batch off the clock:
        # the first launch of a process builds the kernels (nvcc), which
        # must not land inside the measured pass.
        warm_kernels(dev)
        try:
            from celestia_app_tpu_torch.serve.verify import verify_share_proof

            entry, _ = cache.get(1)
            warm = sampler.sample_batch(entry, [(0, 0)])
            verify_share_proof(warm[0], roots[1], device=dev)
        except Exception:  # noqa: BLE001 — warmup only (withheld (0,0) etc.)
            pass
        lat_ms, failures, withheld, wall_s = _run_plan(
            sampler, cache, plan, args.threads, verify_every, roots, dev
        )

        heal_block = None
        if args.heal and withheld:
            from celestia_app_tpu_torch.serve.api import DasProvider
            from celestia_app_tpu_torch.serve.heal import HealingEngine

            provider = DasProvider(cache=cache, sampler=sampler)
            engine = HealingEngine(provider, name="loadgen")
            t_heal0 = time.perf_counter()
            hit_heights = sorted({h for h, _, _ in withheld})
            for h in hit_heights:
                engine.note("withheld", h)
            outcomes = dict(engine.process_pending())
            # Time to FIRST healed proof: the earliest previously-
            # withheld coordinate that now serves a verifying proof.
            first_healed_ms = None
            for h, r, c in withheld:
                if outcomes.get(h) != "healed":
                    continue
                proof = sampler.share_proof(provider.entry(h), r, c)
                if proof.verify(roots[h]):
                    first_healed_ms = round(
                        (time.perf_counter() - t_heal0) * 1e3, 3
                    )
                break
            post_lat, post_fail, post_withheld, post_wall = _run_plan(
                sampler, cache, plan, args.threads, verify_every, roots, dev
            )
            failures.extend(post_fail)
            engine.close()
            heal_block = {
                "heights_healed": [
                    h for h in hit_heights if outcomes.get(h) == "healed"
                ],
                "outcomes": {str(h): o for h, o in outcomes.items()},
                "time_to_first_healed_proof_ms": first_healed_ms,
                "post_heal": _pass_stats(post_lat, post_wall),
                "post_heal_withheld_hits": len(post_withheld),
            }
    finally:
        if adversarial:
            chaos.uninstall()

    summary = {
        "metric": "das_loadgen",
        "mode": os.environ.get("CELESTIA_SERVE_MODE", "") or "batched",
        "requested": args.samples,
        "heights": args.heights,
        "k": args.k,
        "threads": args.threads,
        "axes": args.axes,
        **_pass_stats(lat_ms, wall_s),
        "verified": (len(lat_ms) + verify_every - 1) // verify_every,
        "failures": failures[:5],
        "platform": platform_label(dev),
        "cache": cache.stats(),
    }
    if adversarial:
        summary["withhold_frac"] = args.withhold_frac
        summary["adv_seed"] = args.adv_seed
        summary["withheld_hits"] = len(withheld)
    if heal_block is not None:
        summary["heal"] = heal_block
    return summary


# --- the swarm harness (open-loop light-client fleet) ------------------------

def build_swarm_plan(args, squares, client_tenant):
    """The deterministic arrival schedule every sweep leg replays:
    [(t_arrival_s, client, tenant, height, row, col, axis), ...].

    Poisson arrivals at --rate; height mix: --hot-frac on the newest
    retained height, --historical-frac on beyond-retention heights (the
    cache-busting rebuild path), the rest uniform over the retained
    tail; coordinates: 3/4 inside the client's tenant namespace range
    (the tenant-targeted read), 1/4 uniform over the full EDS (the DAS
    mix, parity quadrants included)."""
    rng = np.random.default_rng(args.seed + 7)
    k, n = args.k, 2 * args.k
    hot_h = args.heights
    plan = []
    t = 0.0
    for _ in range(args.samples):
        t += float(rng.exponential(1.0 / args.rate))
        client = int(rng.integers(0, args.clients))
        tenant = int(client_tenant[client])
        u = rng.random()
        if u < args.hot_frac:
            height = hot_h
        elif u < args.hot_frac + args.historical_frac and args.historical:
            height = hot_h + 1 + int(rng.integers(0, args.historical))
        else:
            height = 1 + int(rng.integers(0, hot_h))
        ranges = squares[height][1]
        if rng.random() < 0.75 and tenant in ranges:
            start, end = ranges[tenant]
            share = start + int(rng.integers(0, end - start))
            row, col = share // k, share % k
        else:
            row, col = int(rng.integers(0, n)), int(rng.integers(0, n))
        axis = "col" if rng.random() < 0.5 else "row"
        plan.append((t, client, tenant, height, row, col, axis))
    return plan


_THROTTLED = "__throttled__"  # the worker's QosThrottled sentinel


def _tenant_stats(results, slo_ms: float) -> dict:
    """Per-tenant p50/p99 + SLO burn (99% of samples under --slo-ms;
    burn = violation fraction / the 1% error budget, so burn > 1 means
    the tenant is eating budget faster than the objective allows).
    A FAILED sample is a violation too — a tenant whose requests mostly
    error must burn budget, not report a rosy number built from its few
    fast successes (percentiles still cover served samples only; the
    `failed` column carries the drop count).  A THROTTLED sample
    ($CELESTIA_QOS proof-rate refusal) is POLICY, not failure: it lands
    in its own column and burns no SLO budget — the spammer being over
    its limit is the enforcement working, and honest tenants are never
    throttled in a correctly-sized policy."""
    served: dict[int, list[float]] = {}
    failed: dict[int, int] = {}
    throttled: dict[int, int] = {}
    for tenant, lat_s, err in results:
        if err is None:
            served.setdefault(tenant, []).append(lat_s * 1e3)
        elif err == _THROTTLED:
            throttled[tenant] = throttled.get(tenant, 0) + 1
        else:
            failed[tenant] = failed.get(tenant, 0) + 1
    out = {}
    for tenant in sorted(set(served) | set(failed) | set(throttled)):
        lats = sorted(served.get(tenant, []))
        drops = failed.get(tenant, 0)
        total = len(lats) + drops
        over = sum(1 for v in lats if v > slo_ms) + drops
        out[f"t{tenant:02d}"] = {
            "samples": len(lats),
            "served": len(lats),
            "failed": drops,
            "throttled": throttled.get(tenant, 0),
            "p50_ms": _percentile(lats, 0.50),
            "p99_ms": _percentile(lats, 0.99),
            "slo_burn": (
                round((over / total) / 0.01, 3) if total else 0.0
            ),
        }
    return out


def _run_swarm_leg(args, shards: int, squares, plan, eds_by_height
                   ) -> tuple[dict, list]:
    """One shard-count leg: identical plan, fresh cache admitted under
    $CELESTIA_SERVE_SHARDS=<shards>, open-loop replay.  Returns the leg
    summary (whose "shards" is the count the plane ACTUALLY ran with —
    serve_shards clamps to the device count) + raw results."""
    import queue

    from celestia_app_tpu_torch.da.eds import ExtendedDataSquare
    from celestia_app_tpu_torch.serve.api import DasProvider
    from celestia_app_tpu_torch.serve.cache import ForestCache

    dev = resolve_device(args.device)
    roots = {h: eds.data_root() for h, eds in eds_by_height.items()}

    def leg_handle(h: int) -> ExtendedDataSquare:
        """A fresh per-leg handle over the shared device buffer: legs
        must not share the MUTABLE handle, because an earlier leg's
        spill converts eds._eds to numpy IN PLACE and a later leg would
        then serve that height's shares from host memory — biasing the
        very scaling curve the sweep measures.  The device buffer
        itself is read-only and shared; only the handle state (spill
        tier, forest attachment, tree memo) is per leg."""
        base = eds_by_height[h]
        return ExtendedDataSquare(
            base._eds, base._row_roots, base._col_roots, base._data_root,
            base.k,
        )

    saved = os.environ.get("CELESTIA_SERVE_SHARDS")
    os.environ["CELESTIA_SERVE_SHARDS"] = str(shards)
    try:
        cache = ForestCache(heights=args.heights, spill=args.heights,
                            device=dev)
        rebuild = lambda h: (  # noqa: E731 — the cache-busting path
            ExtendedDataSquare.compute(squares[h][0], device=dev)
            if h in squares else None
        )
        provider = DasProvider(cache=cache, rebuild=rebuild)
        sampler = provider.sampler
        for h in range(1, args.heights + 1):
            # One extension per height for the whole sweep; historical
            # rebuilds still pay the full recompute — that cost is the
            # point of the tail.
            cache.put(h, leg_handle(h))
        # Warm the kernels and the gathers (sharded or not) off the clock,
        # every pow-2 slot bucket a realistic micro-batch can land on.
        warm_kernels(dev)
        entry, _ = cache.get(args.heights)
        warm_proofs = sampler.sample_batch(entry, [(0, 0), (1, 1)])
        # The verifier's warm-up rides the same off-the-clock window: the
        # workers' batched client-side check must never pay it inside the
        # open-loop pass.
        try:
            from celestia_app_tpu_torch.serve.verify import verify_share_proof

            verify_share_proof(warm_proofs[0], roots[args.heights], device=dev)
        except Exception:  # noqa: BLE001 — warmup only
            pass
        # The shard count the plane ACTUALLY admitted under (serve_shards
        # clamps to the device count): sweep rows must record the mesh
        # that ran, or bench_trend gates the wrong scaling-curve series.
        shards = getattr(entry, "shards", 0) or 1
        if shards > 1:
            for b in (1, 2, 4, 8, 16, 32, 64, 128):
                entry.gather("row", list(range(min(b, entry.forest_rows))))

        q: queue.Queue = queue.Queue()
        results: list[tuple[int, float, str | None]] = []
        lock = threading.Lock()
        verify_every = max(1, args.samples // max(args.verify, 1))
        t0 = time.perf_counter()

        def producer():
            for i, item in enumerate(plan):
                delay = item[0] - (time.perf_counter() - t0)
                if delay > 0:
                    time.sleep(delay)
                q.put((i, item))
            for _ in range(args.threads):
                q.put(None)

        from celestia_app_tpu_torch.qos import QosThrottled
        from celestia_app_tpu_torch.serve.verify import verify_share_proof

        def worker():
            while True:
                got = q.get()
                if got is None:
                    return
                i, (t_sched, _client, tenant, h, r, c, axis) = got
                err = None
                try:
                    entry = provider.entry(h)
                    proof = sampler.share_proof(entry, r, c, axis=axis)
                    if (i % verify_every == 0
                            and not verify_share_proof(proof, roots[h],
                                                       device=dev)):
                        err = "proof failed verify"
                except QosThrottled:
                    # The 429 path: a refusal is the ENFORCEMENT being
                    # measured, never a drop (and never a dead worker).
                    err = _THROTTLED
                except Exception as e:  # noqa: BLE001 — a drop IS the measurement
                    err = f"({h},{r},{c}): {type(e).__name__}: {e}"
                lat = (time.perf_counter() - t0) - t_sched
                with lock:
                    results.append((tenant, lat, err))

        threads = [threading.Thread(target=producer, daemon=True)] + [
            threading.Thread(target=worker, daemon=True)
            for _ in range(args.threads)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall_s = time.perf_counter() - t0
        served = sorted(
            lat * 1e3 for _, lat, err in results if err is None
        )
        failures = [
            err for _, _, err in results
            if err is not None and err != _THROTTLED
        ]
        throttled = sum(1 for _, _, err in results if err == _THROTTLED)
        leg = {
            "shards": shards,
            "throttled": throttled,
            "samples": len(served),
            "wall_s": round(wall_s, 3),
            "offered_rate": args.rate,
            "proofs_per_s": (
                round(len(served) / wall_s, 2) if wall_s else None
            ),
            "proof_p50_ms": _percentile(served, 0.50),
            "proof_p99_ms": _percentile(served, 0.99),
            "failures": failures[:5],
            "cache": cache.stats(),
        }
        return leg, results
    finally:
        if saved is None:
            os.environ.pop("CELESTIA_SERVE_SHARDS", None)
        else:
            os.environ["CELESTIA_SERVE_SHARDS"] = saved


def run_swarm(args) -> dict:
    """The light-client swarm: one deterministic open-loop plan replayed
    per --shard-sweep leg, so the shard-count scaling curve is measured
    on an identical workload."""
    from celestia_app_tpu_torch.da.eds import ExtendedDataSquare
    from celestia_app_tpu_torch.serve import shard

    dev = resolve_device(args.device)
    # Dedup the sweep on the counts the plane will ACTUALLY run with
    # (serve_shards clamps to the device count): `--shard-sweep 1,8,16`
    # on an 8-device host must not spend a whole open-loop leg on a
    # second 8-shard run only for its rows to overwrite the first's.
    have = shard.device_count(dev)
    sweep = sorted({
        min(int(s), have) if int(s) > 1 else 1
        for s in str(args.shard_sweep).split(",") if s.strip()
    }) or [1]
    total_heights = args.heights + args.historical
    squares = {
        h: tenant_square(args.k, args.seed + h, args.tenants)
        for h in range(1, total_heights + 1)
    }
    # One extension per height, shared by every leg (bit-identical
    # squares; only the historical rebuild path recomputes, on purpose).
    eds_by_height = {
        h: ExtendedDataSquare.compute(squares[h][0], device=dev)
        for h in range(1, total_heights + 1)
    }
    crng = np.random.default_rng(args.seed)
    # Zipf over exactly the tenant set (p(rank) ~ rank^-a, tenant 0 the
    # most popular): clipping an unbounded zipf draw would pile the
    # whole tail onto the LAST tenant and invert the skew.
    ranks = np.arange(1, args.tenants + 1, dtype=np.float64)
    popularity = ranks ** -args.zipf_a
    popularity /= popularity.sum()
    client_tenant = crng.choice(args.tenants, size=args.clients, p=popularity)
    plan = build_swarm_plan(args, squares, client_tenant)

    legs, tenant_blocks = [], {}
    for shards in sweep:
        leg, results = _run_swarm_leg(
            args, shards, squares, plan, eds_by_height
        )
        legs.append(leg)
        # Keyed by the ACTUAL shard count the leg ran with (clamping
        # may fold a requested count onto a narrower mesh) — the
        # primary lookup below uses the same key.
        tenant_blocks[leg["shards"]] = _tenant_stats(results, args.slo_ms)

    primary = legs[-1]  # the widest mesh is the round's headline leg
    return {
        "metric": "das_swarm",
        "workload": "swarm",
        "mode": os.environ.get("CELESTIA_SERVE_MODE", "") or "batched",
        "clients": args.clients,
        "tenants": args.tenants,
        "zipf_a": args.zipf_a,
        "arrival": "poisson",
        "rate": args.rate,
        "hot_frac": args.hot_frac,
        "historical_frac": args.historical_frac,
        "requested": args.samples,
        "heights": args.heights,
        "historical": args.historical,
        "k": args.k,
        "threads": args.threads,
        "slo_ms": args.slo_ms,
        "samples": primary["samples"],
        "wall_s": primary["wall_s"],
        "proofs_per_s": primary["proofs_per_s"],
        "proof_p50_ms": primary["proof_p50_ms"],
        "proof_p99_ms": primary["proof_p99_ms"],
        "headline_shards": primary["shards"],
        "sweep": legs,
        "tenant_stats": tenant_blocks[primary["shards"]],
        "failures": [f for leg in legs for f in leg["failures"]][:5],
        "platform": platform_label(dev),
    }


# --- the QoS enforcement run (whale + small tenants + spammer) ---------------

def run_qos(args) -> dict:
    """Two swarm legs under one $CELESTIA_QOS policy, identical honest
    plan: `baseline` (no spammer) then `spam` (a spammer tenant firing
    tenant-targeted reads at --spam-mult x its per-tenant proof-rate
    limit).  The record (schema qos-v1, QOS_rNN.json via --qos-out) is
    what bench_trend gates: spammer throttled, every honest tenant's
    p99/SLO burn no worse than its no-spammer leg."""
    from celestia_app_tpu_torch import qos
    from celestia_app_tpu_torch.da.eds import ExtendedDataSquare

    dev = resolve_device(args.device)
    if args.clients <= 0:
        raise SystemExit("--qos-out needs swarm mode (--clients N)")
    if args.tenants < 3:
        raise SystemExit("--qos-out needs >= 3 tenants (whale+small+spam)")
    spam_t = (
        args.tenants - 1 if args.spam_tenant is None else args.spam_tenant
    )
    # tenant_square writes tenant t as namespace byte t+1; the serve
    # plane's capped label is the hex with leading zeros stripped —
    # the SAME label the sampler charges, so the policy binds exactly
    # the spammer's reads.
    spam_label = format(spam_t + 1, "x")
    limit = args.proof_rate_limit
    total_heights = args.heights + args.historical
    squares = {
        h: tenant_square(args.k, args.seed + h, args.tenants)
        for h in range(1, total_heights + 1)
    }
    eds_by_height = {
        h: ExtendedDataSquare.compute(squares[h][0], device=dev)
        for h in range(1, total_heights + 1)
    }
    crng = np.random.default_rng(args.seed)
    honest_ids = [t for t in range(args.tenants) if t != spam_t]
    honest = len(honest_ids)
    ranks = np.arange(1, len(honest_ids) + 1, dtype=np.float64)
    popularity = ranks ** -args.zipf_a
    popularity /= popularity.sum()
    client_tenant = crng.choice(
        np.array(honest_ids), size=args.clients, p=popularity
    )
    plan = build_swarm_plan(args, squares, client_tenant)
    # The spammer: open-loop Poisson at spam_mult x its limit, every
    # arrival a tenant-targeted read inside its own namespace range on
    # the hot height (the read the proof-rate bucket charges).
    srng = np.random.default_rng(args.seed + 99)
    spam_rate = args.spam_mult * limit
    duration = plan[-1][0] if plan else 1.0
    k, hot_h = args.k, args.heights
    spam_plan = []
    t = float(srng.exponential(1.0 / spam_rate))
    while t < duration:
        ranges = squares[hot_h][1]
        start, end = ranges.get(spam_t, (0, 1))
        share = start + int(srng.integers(0, max(end - start, 1)))
        spam_plan.append((
            t, -1, spam_t, hot_h, share // k, share % k,
            "col" if srng.random() < 0.5 else "row",
        ))
        t += float(srng.exponential(1.0 / spam_rate))
    merged = sorted(plan + spam_plan)

    qos.install(
        f"{spam_label}.proof_rate={limit},{spam_label}.proof_burst={limit}"
    )
    try:
        # A discarded warm leg pays the first calls: the baseline-vs-spam
        # comparison must measure the POLICY, not which leg ran first.
        _run_swarm_leg(
            args, 1, squares, plan[:min(60, len(plan))], eds_by_height
        )
        base_leg, base_results = _run_swarm_leg(
            args, 1, squares, plan, eds_by_height
        )
        spam_leg, spam_results = _run_swarm_leg(
            args, 1, squares, merged, eds_by_height
        )
    finally:
        qos.uninstall()
    tenants_base = _tenant_stats(base_results, args.slo_ms)
    tenants_spam = _tenant_stats(spam_results, args.slo_ms)
    spam_key = f"t{spam_t:02d}"
    return {
        "metric": "das_qos",
        "schema": "qos-v1",
        "workload": "qos",
        "clients": args.clients,
        "tenants": args.tenants,
        "honest_tenants": honest,
        "spam_tenant": spam_key,
        "spam_namespace": spam_label,
        "proof_rate_limit": limit,
        "spam_mult": args.spam_mult,
        "rate": args.rate,
        "slo_ms": args.slo_ms,
        "k": args.k,
        "heights": args.heights,
        "samples": base_leg["samples"],
        "spam_arrivals": len(spam_plan),
        "legs": {
            "baseline": {**{k_: base_leg[k_] for k_ in (
                "samples", "wall_s", "proofs_per_s", "proof_p50_ms",
                "proof_p99_ms", "throttled")}, "tenants": tenants_base},
            "spam": {**{k_: spam_leg[k_] for k_ in (
                "samples", "wall_s", "proofs_per_s", "proof_p50_ms",
                "proof_p99_ms", "throttled")}, "tenants": tenants_spam},
        },
        "failures": (base_leg["failures"] + spam_leg["failures"])[:5],
        "platform": platform_label(dev),
    }


def attest_verify_block(args) -> dict:
    """The --attest A/B legs: verified-samples/sec of the BATCHED device
    verifier vs the per-proof host path on an identical reconstructed
    proof queue, plus bytes-per-verified-sample of the deduped multiproof
    attestation vs fetching the same samples as independent share_proof
    responses.  Both paths must agree on every verdict (and every verdict
    must be True — the squares are honest), or the block reports the
    mismatch as a failure instead of a number."""
    from celestia_app_tpu_torch.rpc.codec import share_proofs_from_attestation
    from celestia_app_tpu_torch.serve.api import DasProvider, render
    from celestia_app_tpu_torch.serve.verify import verify_proofs

    dev = resolve_device(args.device)
    cache, roots = build_cache(args.heights, args.k, args.seed, device=dev)
    provider = DasProvider(cache=cache)
    n = 2 * args.k
    s = args.attest
    rng = np.random.default_rng(args.seed + 7)
    axes = ("row", "col") if args.axes == "both" else (args.axes,)
    rounds = max(1, args.samples // s)

    proofs, proof_roots = [], []
    attest_bytes = independent_bytes = 0
    failures: list[str] = []
    for i in range(rounds):
        h = 1 + i % args.heights
        seen: set = set()
        while len(seen) < s:
            seen.add((
                int(rng.integers(0, n)), int(rng.integers(0, n)),
                axes[int(rng.integers(0, len(axes)))],
            ))
        spec = ",".join(f"{r}:{c}:{a}" for r, c, a in sorted(seen))
        payload = provider.attestation_payload(h, spec)
        attest_bytes += len(render(payload))
        for sample in payload["samples"]:
            independent_bytes += len(render(provider.share_proof_payload(
                h, sample["row"], sample["col"], sample["axis"]
            )))
        for proof in share_proofs_from_attestation(payload):
            proofs.append(proof)
            proof_roots.append(roots[h])

    total = len(proofs)
    walls: dict[str, float] = {}
    saved = os.environ.get("CELESTIA_VERIFY_MODE")
    try:
        for mode in ("batched", "host"):
            os.environ["CELESTIA_VERIFY_MODE"] = mode
            warm = min(64, total)
            verify_proofs(proofs[:warm], proof_roots[:warm], device=dev)
            best = None
            verdicts = None
            for _ in range(3):
                t0 = time.perf_counter()
                verdicts = verify_proofs(proofs, proof_roots, device=dev)
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            walls[mode] = best
            if not all(verdicts):
                failures.append(
                    f"{mode} verify rejected "
                    f"{sum(1 for v in verdicts if not v)}/{total} honest "
                    "proofs"
                )
    finally:
        if saved is None:
            os.environ.pop("CELESTIA_VERIFY_MODE", None)
        else:
            os.environ["CELESTIA_VERIFY_MODE"] = saved

    return {
        "attest_samples": s,
        "rounds": rounds,
        "queue": total,
        "verified_per_s_batched": round(total / walls["batched"], 2),
        "verified_per_s_host": round(total / walls["host"], 2),
        "verify_speedup": round(walls["host"] / walls["batched"], 3),
        "attest_bytes_per_sample": round(attest_bytes / total, 2),
        "independent_bytes_per_sample": round(
            independent_bytes / total, 2
        ),
        "bytes_ratio": round(attest_bytes / independent_bytes, 4),
        "failures": failures,
    }


def run_url(args) -> dict:
    """Sample a live node's GET /das/share_proof over HTTP, verifying
    every --verify-th fetched proof client-side through the BATCHED
    verifier (serve/verify.py — the light-client contract, decided by
    the same program the serve side trusts).  A proof that fails to
    verify is a failure AND an SLO violation: the run reports `slo_burn`
    against --slo-ms with verify failures burning budget like drops.

    Every fetch carries the run's x-celestia-trace header, so the served
    node ADOPTS the loadgen's trace (trace/context.py) and its span rows
    stitch under one trace_id across both processes."""
    import urllib.request

    from celestia_app_tpu_torch.rpc.codec import share_proof_from_json
    from celestia_app_tpu_torch.serve.verify import verify_share_proof
    from celestia_app_tpu_torch.trace.context import new_context, serialize_context

    dev = resolve_device(args.device)
    warm_kernels(dev)
    wire = serialize_context(new_context(layer="loadgen", plane="url"))

    # Probe the square size from a first sample at (0, 0).
    def get(h, r, c):
        req = urllib.request.Request(
            f"{args.url}/das/share_proof?height={h}&row={r}&col={c}",
            headers={"x-celestia-trace": wire},
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())

    first = get(args.height, 0, 0)
    n = 2 * first["square_size"]
    rng = np.random.default_rng(args.seed)
    lat_ms: list[float] = []
    failures: list[str] = []
    verified = 0
    verify_every = max(1, args.samples // max(args.verify, 1))
    t_start = time.perf_counter()
    for i in range(args.samples):
        r, c = int(rng.integers(0, n)), int(rng.integers(0, n))
        t0 = time.perf_counter()
        try:
            payload = get(args.height, r, c)
            if i % verify_every == 0:
                proof = share_proof_from_json(payload["proof"])
                root = bytes.fromhex(payload["data_root"])
                verified += 1
                if not verify_share_proof(proof, root, device=dev):
                    failures.append(f"({r},{c}): proof failed verify")
                    continue
            lat_ms.append((time.perf_counter() - t0) * 1e3)
        except Exception as e:  # noqa: BLE001
            failures.append(f"({r},{c}): {type(e).__name__}: {e}")
    wall_s = time.perf_counter() - t_start
    lat_ms.sort()
    over = sum(1 for v in lat_ms if v > args.slo_ms) + len(failures)
    return {
        "metric": "das_loadgen",
        "mode": "url",
        "url": args.url,
        **_pass_stats(lat_ms, wall_s),
        "verified": verified,
        "slo_ms": args.slo_ms,
        "slo_burn": (
            round((over / args.samples) / 0.01, 3) if args.samples else 0.0
        ),
        "failures": failures[:5],
        "platform": None,
    }


def run_serve(args) -> int:
    """`--serve`: stand up one mini DAS node — deterministic synthetic
    squares admitted into a ForestCache behind a DasProvider, served on
    the standalone observability HTTP server (trace/exposition.py:
    /das/*, /metrics, /healthz, /das/coverage, /fleet) — and block until
    killed.  The first stdout line is a JSON ready record carrying the
    bound URL, so a parent process (the --urls fleet leg, tests) can
    spawn N of these with distinct $CELESTIA_NODE_ID and drive them as a
    local cluster."""
    from celestia_app_tpu_torch.serve.api import DasProvider
    from celestia_app_tpu_torch.trace.context import node_id
    from celestia_app_tpu_torch.trace.exposition import (
        register_das_provider,
        serve_observability,
    )

    dev = resolve_device(args.device)
    warm_kernels(dev)
    cache, _roots = build_cache(args.heights, args.k, args.seed, device=dev)
    provider = DasProvider(cache=cache)
    register_das_provider(provider)
    # Warm one sampled batch off the clock so the first remote sample
    # does not pay a first call inside its measured latency.
    entry, _ = cache.get(1)
    provider.sampler.sample_batch(entry, [(0, 0)])
    srv = serve_observability("127.0.0.1", args.port)
    print(json.dumps({
        "serving": srv.url,
        "node_id": node_id(),
        "heights": args.heights,
        "k": args.k,
        "device": str(dev),
    }), flush=True)
    try:
        threading.Event().wait()  # parent kills the process when done
    except KeyboardInterrupt:
        pass
    srv.stop()
    return 0


def run_fleet(args) -> dict:
    """`--urls a,b,c`: replay ONE open-loop Poisson plan against every
    host of a multi-node cluster — each host receives the identical
    (arrival, row, col) schedule, so per-host proofs/sec are measured on
    identical work.  Cross-host latency quantiles come from the hosts'
    OWN /metrics: per-host celestia_proof_latency_seconds snapshots are
    scraped before and after the pass, deltaed, and bucket-merged
    (Histogram.merge — the same math GET /fleet serves), so the fleet
    numbers in DAS_rNN.json and the live /fleet endpoint can never
    drift apart.  Coverage at end of run is each host's
    /das/coverage?height= ratio (the sampled/verified bitmap the run
    itself ticked)."""
    import queue
    import urllib.request

    from celestia_app_tpu_torch.trace.context import new_context, serialize_context
    from celestia_app_tpu_torch.trace.fleet import parse_prometheus_text
    from celestia_app_tpu_torch.trace.metrics import Histogram

    dev = resolve_device(args.device)
    urls = [u.strip().rstrip("/") for u in args.urls.split(",") if u.strip()]
    if len(urls) < 2:
        raise SystemExit("--urls needs at least 2 comma-separated hosts")
    wire = serialize_context(new_context(layer="loadgen", plane="fleet"))

    def fetch(url: str, path: str) -> bytes:
        req = urllib.request.Request(
            url + path, headers={"x-celestia-trace": wire}
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.read()

    probe = json.loads(fetch(
        urls[0], f"/das/share_proof?height={args.height}&row=0&col=0"
    ))
    n = 2 * probe["square_size"]

    def proof_snapshot(url: str):
        _, _, hists = parse_prometheus_text(
            fetch(url, "/metrics").decode()
        )
        return hists.get("celestia_proof_latency_seconds")

    before = {u: proof_snapshot(u) for u in urls}

    # ONE deterministic plan, replayed per host: Poisson arrivals at
    # --rate (open-loop — latency includes queue delay), uniform DAS
    # coordinates over the full EDS.
    rng = np.random.default_rng(args.seed)
    plan = []
    t = 0.0
    for _ in range(args.samples):
        t += float(rng.exponential(1.0 / args.rate))
        plan.append((t, int(rng.integers(0, n)), int(rng.integers(0, n))))

    per_host: dict[str, list[float]] = {u: [] for u in urls}
    failures: list[str] = []
    walls: dict[str, float] = {}
    lock = threading.Lock()

    def drive(url: str):
        q: queue.Queue = queue.Queue()
        workers = max(1, min(args.threads, 8))
        t0 = time.perf_counter()

        def producer():
            for item in plan:
                delay = item[0] - (time.perf_counter() - t0)
                if delay > 0:
                    time.sleep(delay)
                q.put(item)
            for _ in range(workers):
                q.put(None)

        def worker():
            while True:
                got = q.get()
                if got is None:
                    return
                t_sched, r, c = got
                try:
                    fetch(
                        url,
                        f"/das/share_proof?height={args.height}"
                        f"&row={r}&col={c}",
                    )
                except Exception as e:  # noqa: BLE001 — a drop IS the measurement
                    with lock:
                        failures.append(
                            f"{url} ({r},{c}): {type(e).__name__}: {e}"
                        )
                    continue
                lat = (time.perf_counter() - t0) - t_sched
                with lock:
                    per_host[url].append(lat * 1e3)

        threads = [threading.Thread(target=producer, daemon=True)] + [
            threading.Thread(target=worker, daemon=True)
            for _ in range(workers)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        with lock:
            walls[url] = time.perf_counter() - t0

    drivers = [
        threading.Thread(target=drive, args=(u,), daemon=True) for u in urls
    ]
    for d in drivers:
        d.start()
    for d in drivers:
        d.join()

    # Server-side truth: delta each host's proof-latency histogram over
    # the pass, then bucket-merge — the cross-host quantile IS the merge
    # of the per-host snapshots (the /fleet invariant, pinned in
    # tests/test_fleet.py).
    deltas = []
    host_rows = []
    coverage_ratios = []
    for u in urls:
        after = proof_snapshot(u)
        delta = None
        if after is not None and before.get(u) is not None:
            delta = after.delta(before[u])
        elif after is not None:
            delta = after
        if delta is not None:
            deltas.append(delta)
        lats = sorted(per_host[u])
        try:
            cov = json.loads(fetch(
                u, f"/das/coverage?height={args.height}"
            ))["ratio"]
        except Exception:  # noqa: BLE001 — a host without the map still reports
            cov = None
        if cov is not None:
            coverage_ratios.append(cov)
        host_rows.append({
            "url": u,
            "samples": len(lats),
            "proofs_per_s": (
                round(len(lats) / walls[u], 2) if walls.get(u) else None
            ),
            "p50_ms": _percentile(lats, 0.50),
            "p99_ms": _percentile(lats, 0.99),
            "coverage_ratio": cov,
        })
    merged = Histogram.merge(deltas) if deltas else None

    def merged_ms(q):
        if merged is None or not merged.count():
            return None
        v = merged.quantile(q, phase="total")
        return round(v * 1e3, 3) if v is not None else None

    all_lats = sorted(v for lats in per_host.values() for v in lats)
    wall_s = max(walls.values()) if walls else 0.0
    return {
        "metric": "das_loadgen",
        "mode": "fleet",
        "urls": urls,
        "requested": args.samples,
        "k": probe["square_size"],
        "samples": len(all_lats),
        "wall_s": round(wall_s, 3),
        "proofs_per_s": (
            round(len(all_lats) / wall_s, 2) if wall_s else None
        ),
        "proof_p50_ms": _percentile(all_lats, 0.50),
        "proof_p99_ms": _percentile(all_lats, 0.99),
        "fleet": {
            "hosts": host_rows,
            "cross_host_p50_ms": merged_ms(0.50),
            "cross_host_p99_ms": merged_ms(0.99),
            "coverage_ratio": (
                round(sum(coverage_ratios) / len(coverage_ratios), 6)
                if coverage_ratios else None
            ),
        },
        "failures": failures[:5],
        "platform": platform_label(dev),
    }


def write_metrics_out(out_dir: str) -> None:
    """das_loadgen.prom + das_loadgen.jsonl: the serve-plane families off
    the live registry (the loadgen drove the REAL sampler metrics, so the
    artifact is exactly what a /metrics scrape would have seen)."""
    from celestia_app_tpu_torch.trace.metrics import registry
    from celestia_app_tpu_torch.trace.tracer import traced

    os.makedirs(out_dir, exist_ok=True)
    keep = ("celestia_proof_", "celestia_serve_", "celestia_recoveries_",
            "celestia_chaos_")
    lines, emit = [], False
    for line in registry().render().splitlines():
        if line.startswith("# HELP") or line.startswith("# TYPE"):
            emit = line.split()[2].startswith(keep)
        if emit:
            lines.append(line)
    with open(os.path.join(out_dir, "das_loadgen.prom"), "w") as f:
        f.write("\n".join(lines) + "\n")
    rows = traced().export_jsonl("proof_serve")
    with open(os.path.join(out_dir, "das_loadgen.jsonl"), "w") as f:
        f.write(rows + "\n" if rows else "")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heights", type=int, default=4)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--samples", type=int, default=2000)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--verify", type=int, default=64,
                    help="how many sampled proofs to verify against the root")
    ap.add_argument("--mode", choices=("batched", "host"), default=None,
                    help="pin $CELESTIA_SERVE_MODE for the run")
    ap.add_argument("--withhold-frac", type=float, default=0.0,
                    help="adversarial mix: a withholding proposer hides "
                         "this fraction of every height's shares "
                         "(exercises the 410 detection path under load)")
    ap.add_argument("--adv-seed", type=int, default=21,
                    help="seed for the adversary's withheld coordinate "
                         "sets (deterministic per height)")
    ap.add_argument("--heal", action="store_true",
                    help="with --withhold-frac: heal every detected "
                         "height (serve/heal.py) and re-run the plan, "
                         "reporting pre- vs post-heal proofs/sec and "
                         "time-to-first-healed-proof")
    ap.add_argument("--axes", choices=("row", "col", "both"), default="both",
                    help="sampling axis mix (light clients draw both)")
    ap.add_argument("--clients", type=int, default=0,
                    help="SWARM mode: simulate this many light clients "
                         "(10^4..10^6) with zipf tenant popularity and "
                         "open-loop Poisson arrivals")
    ap.add_argument("--tenants", type=int, default=8,
                    help="swarm: number of tenant namespaces per square")
    ap.add_argument("--zipf-a", type=float, default=1.2,
                    help="swarm: zipf exponent of client->tenant "
                         "popularity (bigger = more skew)")
    ap.add_argument("--rate", type=float, default=300.0,
                    help="swarm: offered load, samples/sec (open-loop "
                         "Poisson arrivals; latency includes queue delay)")
    ap.add_argument("--hot-frac", type=float, default=0.7,
                    help="swarm: fraction of arrivals on the newest "
                         "retained height")
    ap.add_argument("--historical-frac", type=float, default=0.02,
                    help="swarm: fraction hitting beyond-retention "
                         "heights (cache-busting rebuild path)")
    ap.add_argument("--historical", type=int, default=2,
                    help="swarm: how many beyond-retention heights exist")
    ap.add_argument("--slo-ms", type=float, default=250.0,
                    help="swarm: per-tenant latency SLO target (99%% "
                         "objective; burn = violations / the 1%% budget)")
    ap.add_argument("--shard-sweep", default="1",
                    help="swarm: comma list of $CELESTIA_SERVE_SHARDS "
                         "settings to replay the identical plan under "
                         "(e.g. 1,8 — the scaling-curve sweep)")
    ap.add_argument("--spam-tenant", type=int, default=None,
                    help="qos: the spammer tenant id (default: the last "
                         "tenant — the least zipf-popular)")
    ap.add_argument("--proof-rate-limit", type=float, default=50.0,
                    help="qos: the spammer's per-tenant proof-rate limit "
                         "(proofs/sec; $CELESTIA_QOS <ns>.proof_rate)")
    ap.add_argument("--spam-mult", type=float, default=10.0,
                    help="qos: the spammer's offered rate as a multiple "
                         "of its limit")
    ap.add_argument("--qos-out", metavar="QOS_rNN.json",
                    help="run the QoS enforcement legs (baseline vs "
                         "spam under one $CELESTIA_QOS policy) and "
                         "write the bench_trend round record here")
    ap.add_argument("--attest", type=int, default=0, metavar="S",
                    help="run the attestation verify legs on top of the "
                         "closed-loop pass: S samples per GET "
                         "/das/attestation multiproof; records batched- "
                         "vs host-verified samples/sec and bytes-per-"
                         "verified-sample vs S independent share_proofs")
    ap.add_argument("--url", default=None,
                    help="sample a live node's /das/share_proof instead")
    ap.add_argument("--urls", default=None,
                    help="FLEET mode: comma list of >= 2 node URLs; the "
                         "identical open-loop plan replays against every "
                         "host, and the round record gains a `fleet` "
                         "block (per-host proofs/sec, cross-host p50/p99 "
                         "from bucket-merged /metrics histograms, "
                         "end-of-run /das/coverage ratio)")
    ap.add_argument("--serve", action="store_true",
                    help="stand up one mini DAS node (synthetic squares "
                         "behind the standalone observability server) "
                         "and block; first stdout line is the JSON "
                         "ready record with the bound URL")
    ap.add_argument("--port", type=int, default=0,
                    help="--serve: port to bind (default ephemeral)")
    ap.add_argument("--height", type=int, default=1,
                    help="height to sample in --url/--urls mode")
    ap.add_argument("--metrics-out", metavar="DIR")
    ap.add_argument("--round-out", metavar="DAS_rNN.json",
                    help="write the bench_trend round record here")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    resolve_device(args.device)

    if args.serve:
        return run_serve(args)

    saved = os.environ.get("CELESTIA_SERVE_MODE")
    if args.mode:
        os.environ["CELESTIA_SERVE_MODE"] = args.mode
    try:
        if args.qos_out:
            summary = run_qos(args)
        elif args.urls:
            summary = run_fleet(args)
        elif args.url:
            summary = run_url(args)
        elif args.clients:
            summary = run_swarm(args)
        else:
            summary = run_local(args)
            if args.attest:
                summary["verify"] = attest_verify_block(args)
                summary["failures"] = (
                    summary["failures"] + summary["verify"]["failures"]
                )
    finally:
        if args.mode:
            if saved is None:
                os.environ.pop("CELESTIA_SERVE_MODE", None)
            else:
                os.environ["CELESTIA_SERVE_MODE"] = saved

    print(json.dumps(summary), flush=True)
    if args.metrics_out:
        write_metrics_out(args.metrics_out)
    if args.qos_out:
        import re

        m = re.search(r"QOS_r(\d+)\.json$", os.path.basename(args.qos_out))
        record = {
            "n": int(m.group(1)) if m else 0,
            "schema": "qos-v1",
            "k": summary["k"],
            "clients": summary["clients"],
            "tenants": summary["tenants"],
            "rate": summary["rate"],
            "slo_ms": summary["slo_ms"],
            "spam_tenant": summary["spam_tenant"],
            "spam_namespace": summary["spam_namespace"],
            "proof_rate_limit": summary["proof_rate_limit"],
            "spam_mult": summary["spam_mult"],
            "spam_arrivals": summary["spam_arrivals"],
            "legs": summary["legs"],
            "platform": summary["platform"],
        }
        with open(args.qos_out, "w") as f:
            json.dump(record, f, indent=1)
        if summary["failures"]:
            for fail in summary["failures"]:
                print(f"FAIL: {fail}", file=sys.stderr)
            return 1
        spam_cols = summary["legs"]["spam"]["tenants"][
            summary["spam_tenant"]
        ]
        if not spam_cols["throttled"]:
            print("FAIL: the spammer was never throttled — the policy "
                  "enforced nothing", file=sys.stderr)
            return 1
        return 0
    if args.round_out:
        import re

        m = re.search(r"DAS_r(\d+)\.json$", os.path.basename(args.round_out))
        record = {
            "n": int(m.group(1)) if m else 0,
            "proofs_per_s": summary["proofs_per_s"],
            "proof_p50_ms": summary["proof_p50_ms"],
            "proof_p99_ms": summary["proof_p99_ms"],
            "samples": summary["samples"],
            "k": summary.get("k"),
            "mode": summary["mode"],
            "platform": summary.get("platform"),
        }
        if summary.get("verify") is not None:
            # The verify-plane A/B (--attest): batched vs host verified-
            # samples/sec + attestation vs independent bytes-per-sample
            # — the two series bench_trend rate-gates for this plane.
            record["verify"] = {
                k: v for k, v in summary["verify"].items()
                if k != "failures"
            }
        if summary.get("fleet") is not None:
            # The multi-node leg (--urls): per-host proofs/sec, the
            # bucket-merged cross-host tail, end-of-run coverage —
            # bench_trend's fleet series (same-platform rule; absence
            # from older rounds is a plan gap, not STALE).  The fleet
            # workload tag keeps the open-loop rate-capped headline from
            # gating against closed-loop saturation rounds.
            record["workload"] = "fleet"
            record["fleet"] = summary["fleet"]
        if summary.get("workload") == "swarm":
            # das-v2: the swarm round shape bench_trend learns — sweep
            # rows are the scaling curve, tenant columns the SLO story.
            record.update({
                "schema": "das-v2",
                "workload": "swarm",
                "clients": summary["clients"],
                "arrival": summary["arrival"],
                "rate": summary["rate"],
                "slo_ms": summary["slo_ms"],
                "headline_shards": summary["headline_shards"],
                "sweep": [
                    {
                        "shards": leg["shards"],
                        "proofs_per_s": leg["proofs_per_s"],
                        "proof_p50_ms": leg["proof_p50_ms"],
                        "proof_p99_ms": leg["proof_p99_ms"],
                        "samples": leg["samples"],
                    }
                    for leg in summary["sweep"]
                ],
                "tenants": summary["tenant_stats"],
            })
        with open(args.round_out, "w") as f:
            json.dump(record, f, indent=1)
    if summary.get("failures"):
        for fail in summary["failures"]:
            print(f"FAIL: {fail}", file=sys.stderr)
        return 1
    expected = args.samples - summary.get("withheld_hits", 0)
    if summary["samples"] < expected:
        print("FAIL: not every serveable sample was served", file=sys.stderr)
        return 1
    if summary.get("heal") is not None:
        post = summary["heal"]
        # With healing on, the post-heal pass must serve the FULL plan:
        # a previously-withheld coordinate that still 410s means the
        # heal did not restore service.
        if (post["post_heal"]["samples"] < args.samples
                or post["post_heal_withheld_hits"] > 0):
            print("FAIL: post-heal pass still hit withheld shares",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
