#!/usr/bin/env python
"""Chaos soak: N blocks under a seeded fault spec, bit-identical roots.

The claim under test is the paper's production premise: the device
pipeline sits on the consensus hot path, so injected faults may cost
LATENCY but never CORRECTNESS.  Four drills, one process:

  1. device soak     — N deterministic blocks streamed through the
                       BlockPipeline under dispatch/upload chaos; every
                       committed DAH root must be bit-identical to the
                       chaos-off run (retry, backoff, and even a
                       mid-soak degradation to staged/host are all
                       invisible in the roots).
  2. WAL tear drill  — votes journaled with `wal_torn_tail` injection;
                       a crash+restart replay must salvage every
                       complete record, refuse the conflicting re-sign,
                       and allow the idempotent one (double-sign safety
                       survives the torn tail).
  2b. sampling drill — DAS samples under injected proof.serve faults
                       (failed/slow batched proof dispatches): the
                       sampler must absorb every injection on the
                       pure-host fallback with proof bytes BIT-IDENTICAL
                       to the chaos-off batched run, all verifying
                       against the committed DAH data root.
  2c. speculation drill — speculative extends ($CELESTIA_PIPE_SPECULATE)
                       under injected dispatch faults and forced round
                       changes (the adopted square differs from the
                       speculated one): every mismatched claim must
                       DISCARD and recompute, with committed roots
                       bit-identical to the speculation-off run.
  2d. batched-fault drill — a persistent fault in the vmapped
                       multi-square dispatch ($CELESTIA_PIPE_BATCH) must
                       fall down the ladder (batched -> unbatched fused
                       -> staged), roots bit-identical throughout.
  2e. healing drill  — the detect -> repair -> re-serve loop
                       (serve/heal.py): a ShareWithheld / BadProofDetected
                       detection must TRIGGER batched repair, the
                       recovered square must root-verify against the
                       committed DAH before re-admission, the previously
                       withheld coordinate must serve a verifying proof,
                       mid-heal samples get the retryable 503-face, and
                       an irrecoverable height lands in quarantine.
  2g. shard-fault drill — the SHARDED serve plane's rung ladder
                       ($CELESTIA_SERVE_SHARDS, serve/shard.py): under
                       `shard_fail=1.0` every sharded gather degrades to
                       the single-device batched path, and compounded
                       with `proof_fail=1.0` on down to the host rung —
                       proof bytes bit-identical at every rung.
  2h. extend-shard drill — the SHARDED extend+DAH plane's rung ladder
                       ($CELESTIA_EXTEND_SHARDS, kernels/
                       panel_sharded.py): the committed-sharding
                       multi-chip pipeline must produce bit-identical
                       roots and a row-sharded EDS, and under
                       `extend_shard_fail=1.0` every collective dispatch
                       faults MID-schedule and the ladder walks
                       sharded_panel -> panel (the single-device
                       runner), roots unchanged.
  2f. quorum heal    — N serve-nodes with partial local share sets under
                       one withholding proposer: each detects through its
                       own sampling plane, repairs from the quorum's
                       UNION of surviving shares, and re-serves — with
                       per-node flight bundles proving who detected what
                       when (the ACeD oracle-committee story).
  3. gossip drill    — a redundant flood over a lossy, duplicating,
                       transiently-failing link; the receiver-side
                       msg-id dedup must converge on exactly the unique
                       message set (drops healed by redundancy+retry,
                       dups absorbed).
  4. breaker drill   — a persistent injected device failure must flip
                       `pipeline_mode()` down the ladder to staged
                       within the breaker window, with
                       `celestia_degraded` and /healthz reporting the
                       degraded state — AND the telemetry plane must
                       NOTICE on its own: the `degraded` SLO enters
                       fast-burn (a page) and the flight recorder writes
                       a bundle, all within the drill's block budget.
                       The drill reports DETECTION LATENCY — blocks and
                       wall-ms from the first injected failure to the
                       page — the ROADMAP's time-to-detection
                       measurement, now standing.  Runs twice: from the
                       default fused seat AND from the leaf-hash-
                       epilogue seat ($CELESTIA_PIPE_FUSED=epi), which
                       must walk the extra fused_epi -> fused rung first
                       — whichever mode the autotuner seats, the ladder
                       holds.

Every drill runs with the flight recorder armed ($CELESTIA_FLIGHT_DIR
defaults to a temp dir here); the summary prints a detection-latency
column per drill next to the per-seam injection/recovery counts.

Run:
  python -m celestia_app_tpu_torch.scripts.chaos_soak [--device cpu] \
      --blocks 20 --k 16 \
      --spec "seed=7,dispatch_fail=0.1,upload_stall_ms=20,gossip_drop=0.2,gossip_dup=0.1,wal_torn_tail=2"

Exits non-zero on any divergence; prints the per-seam
injection/recovery table either way.  tests/test_torch_chaos_soak.py runs
these same functions at small k on the CPU.

The port's copy of scripts/chaos_soak.py.  Every drill takes `device`
(default CUDA, which raises without a card; the CPU runs the plain
PyTorch versions of the kernels), `main` takes `--device`, and each drill
gives back the process state it touched (chaos spec, ladder,
`CELESTIA_*` variables, SLO engine, scrape stamp:
scripts/common.process_state); importing the module sets nothing.  The
deliberate differences from the JAX drills, each where the port's
serving plane differs from the JAX one (ROADMAP queue 3):

  * No fault of the card is answered on the host.  Where the JAX sampler
    and verifier answer a faulted batched dispatch on the pure-host path,
    the port retries it on the card (chaos/degrade.retry_on_card:
    `celestia_recoveries_total{outcome="retried"}`) and raises
    device.DeviceFault past the last retry.  So the sampling drill counts
    the retries beside the identical bytes, where JAX counts host
    answers; the shard-fault drill's compounded leg (`proof_fail=1.0`,
    JAX's host rung) must end every batch in a DeviceFault after its
    retries, never in bytes; the attestation drill holds the identical
    verdicts under `seed=6,verify_fail=0.5`, which the retries absorb, and
    requires a DeviceFault under the persistent `verify_fail=1.0`, where
    JAX's host answered.
  * A device fault during a heal is not a quarantine (serve/heal.py); the
    healing drills inject none, so their expectations are JAX's: an
    irrecoverable square still lands in quarantine.
  * Shards are counted from the port's RowSharded blocks (JAX reads
    `addressable_shards`) and clamped to the devices of `device`'s type
    (parallel/mesh.device_count: the cards, or the 8 CPU shards).  On one
    card `--logical-shards N` runs both sharded drills over N logical
    shards of it (`logical_shards`), as a one-card machine has no second
    card to shard over; without it they clamp to 1 and fail.
  * The breaker drill's "host" floor is the staged pipeline on the card
    (chaos/degrade.py); every rung the epi seat walks stays there.
  * Records name the card and its power limit where JAX names its
    backend (`platform`).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import re
import sys
import tempfile
import time

import numpy as np

from celestia_app_tpu_torch.device import DeviceFault, resolve_device
from celestia_app_tpu_torch.scripts.common import (
    add_device_argument,
    deterministic_blocks,
    platform_label,
    process_state,
)


def _drill(fn):
    """Run a drill inside scripts/common.process_state: whatever it
    installs, sets or degrades is given back when it returns or raises."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with process_state():
            return fn(*args, **kwargs)

    return run


DEFAULT_SPEC = (
    "seed=7,dispatch_fail=0.1,upload_stall_ms=5,gossip_drop=0.2,"
    "gossip_dup=0.1,wal_torn_tail=2"
)


def _arm_flight_recorder() -> str:
    """Ensure $CELESTIA_FLIGHT_DIR is set (temp dir when the operator
    didn't pick one) so every drill's anomalies produce bundles."""
    d = os.environ.get("CELESTIA_FLIGHT_DIR")
    if not d:
        d = tempfile.mkdtemp(prefix="chaos-flight-")
        os.environ["CELESTIA_FLIGHT_DIR"] = d
    return d


def _pin_flight_interval(seconds: float = 3600.0):
    """Pin the flight recorder's per-trigger rate limit to a
    drill-spanning window, returning a restore callable.

    The adversarial drills assert EXACTLY ONE bundle per trigger per
    drill; that must hold because the first detection black-boxed and
    the rest suppressed, not because the drill happened to finish inside
    the default 30 s window on a fast host (200-trial runs on the CPU
    fallback do not).  An operator-set interval is left alone."""
    key = "CELESTIA_FLIGHT_MIN_INTERVAL_S"
    prev = os.environ.get(key)
    if not prev:
        os.environ[key] = str(seconds)

    def restore() -> None:
        if not prev:
            os.environ.pop(key, None)
        else:
            os.environ[key] = prev

    return restore


def _first_dump_after(t0_ns: int, trigger: str | None = None) -> dict | None:
    """The first successful flight dump at/after `t0_ns` (optionally for
    one trigger) — how drills measure wall-clock time-to-detection.
    Reads the recorder's own ungated log, NOT the flight_dump trace row:
    with $CELESTIA_TRACE=off (the low-overhead measurement combo) the
    row vanishes but the bundle on disk is still the detection fact."""
    from celestia_app_tpu_torch.trace.flight_recorder import recent_dumps

    dumps = recent_dumps(since_ns=t0_ns, trigger=trigger)
    return dumps[0] if dumps else None


def _detection(t0_ns: int, trigger: str | None = None,
               blocks: int | None = None) -> dict | None:
    """Detection-latency record for the summary table, or None when no
    dump landed after `t0_ns`."""
    row = _first_dump_after(t0_ns, trigger)
    if row is None:
        return None
    return {
        "by": row.get("trigger"),
        "blocks": blocks,
        "wall_ms": round((row["ts_ns"] - t0_ns) / 1e6, 3),
    }


@_drill
def run_device_soak(n_blocks: int, k: int, spec: str, device=None,
                    roots_out: dict | None = None) -> dict:
    """Stream n_blocks through the BlockPipeline chaos-off then chaos-on;
    returns {"roots_identical": bool, "final_mode": str, ...}.  `roots_out`,
    when given, receives the chaos-on run's data root per block tag."""
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.chaos import degrade
    from celestia_app_tpu_torch.kernels.fused import pipeline_mode
    from celestia_app_tpu_torch.parallel.pipeline import stream_blocks

    dev = resolve_device(device)
    blocks = deterministic_blocks(n_blocks, k)

    # An EMPTY programmatic install, not uninstall(): uninstall falls
    # back to $CELESTIA_CHAOS, and the whole point of this leg is a
    # baseline with no injection even when the env spec is set.
    chaos.install("")
    degrade.reset_for_tests()
    baseline = {
        tag: eds.data_root()
        for tag, eds in stream_blocks(iter(blocks), k, depth=2, device=dev)
    }

    chaos.install(spec)
    t0_ns = time.time_ns()
    try:
        chaotic = {
            tag: eds.data_root()
            for tag, eds in stream_blocks(iter(blocks), k, depth=2,
                                          device=dev)
        }
        final_mode = pipeline_mode()
        degraded = degrade.degraded_state()
    finally:
        chaos.uninstall()
        degrade.reset_for_tests()
    if roots_out is not None:
        roots_out.update(chaotic)
    mismatches = [
        t for t in baseline
        if chaotic.get(t) != baseline[t]
    ]
    return {
        "blocks": n_blocks,
        "k": k,
        "roots_identical": not mismatches and len(chaotic) == len(baseline),
        "mismatched_tags": mismatches,
        "final_mode": final_mode,
        "degraded": degraded,
        # Recovery usually absorbs p=0.1 faults without an anomaly; when
        # one DOES surface (a breaker trip mid-soak), this records how
        # long the plane took to notice.
        "detection": _detection(t0_ns),
    }


@_drill
def run_wal_tear_drill(spec: str, wal_dir: str | None = None,
                       device=None) -> dict:
    """Journal votes under torn-tail injection, crash, restart, and check
    double-sign safety + salvage.  Host work: `device` is resolved only so
    that the drill, like every entry point, never runs where the caller
    did not ask."""
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.consensus.wal import VoteWAL

    resolve_device(device)
    PREVOTE, PRECOMMIT = 1, 2  # votes.py constants, sans its crypto import

    block_a, block_b = b"\xaa" * 32, b"\xbb" * 32
    tmp = wal_dir or tempfile.mkdtemp(prefix="chaos-wal-")
    path = os.path.join(tmp, "wal.jsonl")
    chaos.install(spec)
    t0_ns = time.time_ns()
    try:
        wal = VoteWAL(path)
        signed = []
        for h in range(1, 9):
            for vt in (PREVOTE, PRECOMMIT):
                if wal.may_sign(h, 0, vt, block_a):
                    signed.append((h, 0, vt))
        # The spec's torn tails self-healed as appends continued (the
        # live truncate path).  For the restart-salvage leg the LAST
        # append must tear: re-arm one torn tail, sign, and crash
        # WITHOUT close — the durably fsync'd partial record is exactly
        # what the restart sees.
        chaos.install("seed=1,wal_torn_tail=1")
        assert wal.may_sign(99_000, 0, PREVOTE, block_a)
        signed.append((99_000, 0, PREVOTE))
        torn_on_disk = wal._torn
        del wal
    finally:
        chaos.uninstall()

    wal2 = VoteWAL(path)
    # Every completed record survives: the conflicting vote is refused at
    # every signed coordinate; the identical re-sign stays allowed (how a
    # restarted node rejoins and re-broadcasts without equivocating).
    refused = all(
        not wal2.may_sign(h, r, t, block_b) for h, r, t in signed
    )
    idempotent = all(wal2.may_sign(h, r, t, block_a) for h, r, t in signed)
    fresh = wal2.may_sign(99, 0, PREVOTE, block_b)  # new coords: free
    wal2.close()
    return {
        "signed": len(signed),
        "torn_on_disk": torn_on_disk,
        "salvaged_bytes": wal2.salvaged_bytes,
        "conflicts_refused": refused,
        "idempotent_resign_ok": idempotent,
        "fresh_coords_ok": fresh,
        "ok": refused and idempotent and fresh,
        # The restart replay's salvage is the anomaly; the wal_salvage
        # flight dump is the plane noticing it.
        "detection": _detection(t0_ns, trigger="wal_salvage"),
    }


class _FlakyPeer:
    """Fails every `fail_every`-th consensus() call (transient link)."""

    url = "chaos://flaky-peer"

    def __init__(self, fail_every: int = 5):
        self.fail_every = fail_every
        self.calls = 0
        self.delivered: list[dict] = []

    def consensus(self, msg: dict) -> dict:
        self.calls += 1
        if self.fail_every and self.calls % self.fail_every == 0:
            raise ConnectionError("chaos: transient peer failure")
        self.delivered.append(msg)
        return {"ok": True}


@_drill
def run_gossip_drill(spec: str, n_msgs: int = 40, max_rounds: int = 12,
                     device=None) -> dict:
    """Flood unique messages over a chaotic link (rpc/transport.deliver —
    the same path ConsensusDriver._send_to rides) until the receiver's
    dedup set converges on exactly the unique set, as the real mesh does:
    losses are healed by RE-FLOODING (relays, round timeouts, catch-up
    all re-offer messages), never by the sender knowing a drop happened.
    Must converge within `max_rounds` despite drops, dups, and a
    transiently failing peer — and dedup must keep the unique set exact
    despite the duplicate deliveries.  Host work, like the WAL drill:
    `device` is only resolved."""
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.rpc import transport

    resolve_device(device)

    peer = _FlakyPeer(fail_every=5)
    streak: dict = {}
    msgs = [
        {"kind": "vote", "height": 1, "vote": f"{i:04x}"}
        for i in range(n_msgs)
    ]
    expected = {transport.msg_id(m) for m in msgs}
    rounds = 0
    chaos.install(spec)
    try:
        while rounds < max_rounds:
            rounds += 1
            for msg in msgs:
                transport.deliver(
                    peer.consensus, msg, streak=streak, key=peer.url
                )
            # Reorder-delayed deliveries land on timer threads: wait them
            # out so the convergence check sees settled state.
            transport.drain_delayed()
            # Receiver-side flood termination: the dedup key handle() uses.
            if {transport.msg_id(m) for m in peer.delivered} == expected:
                break
    finally:
        chaos.uninstall()
    transport.drain_delayed()
    unique = {transport.msg_id(m) for m in peer.delivered}
    return {
        "sent_unique": n_msgs,
        "rounds": rounds,
        "deliveries": len(peer.delivered),
        "unique_delivered": len(unique),
        "converged": unique == expected,
        "ok": unique == expected and rounds <= max_rounds,
    }


@_drill
def run_breaker_drill(k: int = 4, base_env: str | None = None,
                      blocks: int = 8, device=None) -> dict:
    """A persistent injected device failure must flip the ladder to
    staged within the breaker window, visible on /healthz — and the
    telemetry plane must DETECT it end-to-end: sustained
    `dispatch_fail=1.0` has to drive the `degraded` SLO into fast-burn
    (a page) and produce a flight bundle within `blocks` blocks, with
    every committed root still bit-identical to the chaos-off run.
    Reports detection latency (blocks + wall-ms from first injection to
    the page).

    `base_env` pins $CELESTIA_PIPE_FUSED for the drill (e.g. "epi" to
    start from the leaf-hash-epilogue seat the autotuner may install —
    dispatch_fail targets the whole fused family, so that seat walks the
    extra fused_epi -> fused rung before landing on staged).  None keeps
    the ambient env.  Every rung stays on `device`: the ladder's "host"
    floor is the staged pipeline there.
    """
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.chaos import degrade
    from celestia_app_tpu_torch.da.eds import ExtendedDataSquare
    from celestia_app_tpu_torch.constants import SHARE_SIZE
    from celestia_app_tpu_torch.kernels.fused import pipeline_mode
    from celestia_app_tpu_torch.trace import flight_recorder, slo
    from celestia_app_tpu_torch.trace.exposition import health_payload

    dev = resolve_device(device)
    saved = {
        name: os.environ.get(name)
        for name in ("CELESTIA_PIPE_FUSED", "CELESTIA_SLO_TICK_S",
                     "CELESTIA_FLIGHT_DIR")
    }
    if base_env is not None:
        os.environ["CELESTIA_PIPE_FUSED"] = base_env
    _arm_flight_recorder()
    # Evaluate SLOs on every block-journal row: the drill measures
    # DETECTION latency, not tick-rate-limit latency.
    os.environ["CELESTIA_SLO_TICK_S"] = "0"
    chaos.install("")  # chaos-free even when $CELESTIA_CHAOS is set
    degrade.reset_for_tests()
    engine = slo._reset_for_tests()
    flight_recorder._reset_for_tests()  # drills must not inherit limits
    ods = np.zeros((k, k, SHARE_SIZE), dtype=np.uint8)
    healthy_root = ExtendedDataSquare.compute(ods, device=dev).data_root()
    chaos.install("seed=11,dispatch_fail=1.0")
    t0_ns = time.time_ns()
    t0 = time.perf_counter()
    detect_blocks = None
    detect_wall_ms = None
    roots_identical = True
    blocks_run = 0
    try:
        for i in range(1, blocks + 1):
            blocks_run = i
            root = ExtendedDataSquare.compute(ods, device=dev).data_root()
            roots_identical = roots_identical and (root == healthy_root)
            if engine.paged("degraded") and _first_dump_after(
                t0_ns, trigger="slo_fast_burn"
            ):
                detect_blocks = i
                detect_wall_ms = round((time.perf_counter() - t0) * 1e3, 3)
                break
        mode = pipeline_mode()
        health = health_payload()
    finally:
        chaos.uninstall()
        for name, val in saved.items():
            if val is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = val
    page_dump = _first_dump_after(t0_ns, trigger="slo_fast_burn")
    trip_dump = _first_dump_after(t0_ns, trigger="breaker_trip")
    result = {
        "mode_after": mode,
        "health_status": health.get("status"),
        "health_degraded": health.get("degraded"),
        "slo_health": health.get("slo"),
        "roots_identical": roots_identical,
        "paged": detect_blocks is not None,
        "detection_blocks": detect_blocks,
        "detection_wall_ms": detect_wall_ms,
        "flight_bundle": page_dump.get("path") if page_dump else None,
        "breaker_bundle": trip_dump.get("path") if trip_dump else None,
        "blocks_run": blocks_run,
        "detection": (
            {"by": "slo_fast_burn", "blocks": detect_blocks,
             "wall_ms": detect_wall_ms}
            if detect_blocks is not None else None
        ),
        "ok": (
            mode == "staged"
            and health.get("status") == "DEGRADED"
            and health.get("degraded") == {"device": "staged"}
            and roots_identical
            and detect_blocks is not None
            and page_dump is not None
            and trip_dump is not None
            and "degraded" in (health.get("slo") or {}).get("burning", [])
        ),
    }
    degrade.reset_for_tests()
    return result


@_drill
def run_sampling_drill(k: int = 8, samples: int = 64,
                       spec: str = "seed=5,proof_fail=0.5,proof_slow_ms=2",
                       device=None, proofs_out: list | None = None) -> dict:
    """The serve plane's bit-exactness drill: under injected proof.serve
    faults (failed/slow batched dispatches), every DAS sample must still
    be answered and every proof must be BYTE-IDENTICAL to the chaos-off
    batched run and verify against the committed DAH data root.  The
    read-side mirror of the device soak's 'latency, never correctness'
    claim.

    Where the JAX sampler re-answers a failed batch on the pure-host path,
    the port's retries it on the card (chaos/degrade.retry_on_card), so
    the drill counts those retries (`celestia_recoveries_total{seam=
    "proof.serve", outcome="retried"}`) and requires at least one; a batch
    that fails past its last retry raises device.DeviceFault, which the
    drill counts as a failure, never as an answer.  `proofs_out`, when
    given, receives the chaos-on run's rendered proofs."""
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.da.eds import ExtendedDataSquare
    from celestia_app_tpu_torch.serve.api import render
    from celestia_app_tpu_torch.serve.cache import ForestCache
    from celestia_app_tpu_torch.serve.sampler import ProofSampler
    from celestia_app_tpu_torch.rpc.codec import to_jsonable
    from celestia_app_tpu_torch.trace.metrics import registry

    dev = resolve_device(device)
    _, ods = deterministic_blocks(1, k, seed=515)[0]
    chaos.install("")  # baseline leg: no injection even with env chaos set
    eds = ExtendedDataSquare.compute(ods, device=dev)
    root = eds.data_root()
    cache = ForestCache(heights=2, spill=2, device=dev)
    entry = cache.put(1, eds)
    sampler = ProofSampler(device=dev)
    rng = np.random.default_rng(99)
    n = 2 * k
    coords = [
        (int(rng.integers(0, n)), int(rng.integers(0, n)))
        for _ in range(samples)
    ]
    baseline = [
        render(to_jsonable(p)) for p in sampler.sample_batch(entry, coords)
    ]

    def _injections() -> float:
        for labels, val in registry().counter(
            "celestia_chaos_injections_total", ""
        ).samples():
            if labels.get("seam") == "proof.serve":
                return val
        return 0.0

    inj_before = _injections()
    retries_before = _recoveries("proof.serve", "retried")
    chaos.install(spec)
    t0_ns = time.time_ns()
    device_faults = 0
    try:
        # One batch per handful of coords so the fail probability gets
        # many dispatches to bite (one giant batch = one coin flip).
        chaotic = []
        for i in range(0, samples, 8):
            try:
                chaotic.extend(sampler.sample_batch(entry, coords[i:i + 8]))
            except DeviceFault:
                device_faults += 1
    finally:
        chaos.uninstall()
    chaotic_bytes = [render(to_jsonable(p)) for p in chaotic]
    if proofs_out is not None:
        proofs_out.extend(chaotic_bytes)
    identical = chaotic_bytes == baseline
    verified = all(p.verify(root) for p in chaotic)
    injected = _injections() - inj_before
    retries = _recoveries("proof.serve", "retried") - retries_before
    return {
        "samples": samples,
        "k": k,
        "bit_identical": identical,
        "all_verify": verified,
        "injections": injected,
        "retries": retries,
        "device_faults": device_faults,
        "ok": identical and verified and retries >= 1 and not device_faults,
        "detection": _detection(t0_ns),
    }


def _recoveries(seam: str, outcome: str | None = None) -> float:
    """celestia_recoveries_total summed over `seam` (and `outcome`)."""
    from celestia_app_tpu_torch.trace.metrics import registry

    total = 0.0
    for labels, val in registry().counter(
        "celestia_recoveries_total", ""
    ).samples():
        if labels.get("seam") == seam and (
            outcome is None or labels.get("outcome") == outcome
        ):
            total += val
    return total


@contextlib.contextmanager
def logical_shards(n: int, device=None):
    """Run the sharded serve and extend planes over `n` logical shards of
    `device` (one card repeated, each shard its own stream, as
    chip_smoke.py's phase_faults and phase_mesh do) for the block: the
    serve plane's and the extend plane's device counts read `n`, and
    their meshes repeat the card.  A machine with one card has no other
    way to engage the sharded seams; the bytes are those of real shards."""
    from celestia_app_tpu_torch.kernels import panel_sharded
    from celestia_app_tpu_torch.parallel.mesh import EXTEND_AXIS, SERVE_AXIS, Mesh
    from celestia_app_tpu_torch.serve import shard

    dev = resolve_device(device)
    meshes = {axis: Mesh([dev] * n, axis) for axis in (SERVE_AXIS, EXTEND_AXIS)}
    swaps = (
        (shard, "device_count", lambda device=None: n),
        (shard, "serve_mesh",
         lambda shards, device=None: meshes[SERVE_AXIS] if shards == n
         else Mesh([dev] * shards, SERVE_AXIS)),
        (panel_sharded, "device_count", lambda device=None: n),
        (panel_sharded, "extend_mesh",
         lambda shards, device=None: meshes[EXTEND_AXIS] if shards == n
         else Mesh([dev] * shards, EXTEND_AXIS)),
    )
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, value in swaps:
            setattr(mod, name, value)
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


@_drill
def run_shard_fault_drill(k: int = 8, samples: int = 48,
                          shards: int = 8, device=None) -> dict:
    """The SHARDED serve plane's rung-ladder drill (serve/shard.py).

    Baseline: the same DAS plan answered by a sharded cache
    ($CELESTIA_SERVE_SHARDS) with no chaos.  Leg 1: `shard_fail=1.0`
    fails every sharded gather dispatch — the gather must degrade to the
    single-device batched path (celestia_recoveries_total
    {seam="proof.shard"}) with BIT-IDENTICAL proof bytes.  Leg 2:
    `shard_fail=1.0,proof_fail=1.0` compounds a batched-path fault on
    top.  There the JAX sampler's host rung answers; the port's retries
    the batch on the card and, every retry failing too, raises
    device.DeviceFault: the leg requires that every batch ends in one
    after its retries (`celestia_recoveries_total{seam="proof.serve",
    outcome="retried"}`), with no byte served.

    Shards are clamped to the devices of `device`'s type
    (parallel/mesh.device_count, read through serve/shard so that
    `logical_shards` reaches it) and counted from the entry's RowSharded
    forest blocks.
    """
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.da.eds import ExtendedDataSquare
    from celestia_app_tpu_torch.rpc.codec import to_jsonable
    from celestia_app_tpu_torch.serve import shard as shard_mod
    from celestia_app_tpu_torch.serve.api import render
    from celestia_app_tpu_torch.serve.cache import ForestCache
    from celestia_app_tpu_torch.serve.sampler import ProofSampler

    dev = resolve_device(device)
    shards = min(shards, shard_mod.device_count(dev))
    _, ods = deterministic_blocks(1, k, seed=717)[0]
    saved = os.environ.get("CELESTIA_SERVE_SHARDS")
    os.environ["CELESTIA_SERVE_SHARDS"] = str(shards)

    try:
        chaos.install("")  # baseline leg: no injection even with env chaos
        eds = ExtendedDataSquare.compute(ods, device=dev)
        root = eds.data_root()
        cache = ForestCache(heights=2, spill=2, device=dev)
        entry = cache.put(1, eds)
        blocks = getattr(getattr(entry, "row_flat", None), "blocks", None)
        sharded = bool(getattr(entry, "shards", 0)) and (
            blocks is not None and len(blocks) == shards
        )
        sampler = ProofSampler(device=dev)
        rng = np.random.default_rng(727)
        n = 2 * k
        coords = [
            (int(rng.integers(0, n)), int(rng.integers(0, n)))
            for _ in range(samples)
        ]
        baseline = [
            render(to_jsonable(p))
            for p in sampler.sample_batch(entry, coords)
        ]
        legs = {}
        before = _recoveries("proof.shard")
        chaos.install("seed=11,shard_fail=1.0")
        try:
            got = []
            for i in range(0, samples, 8):
                got.extend(sampler.sample_batch(entry, coords[i:i + 8]))
        finally:
            chaos.install("")
        legs["single_device"] = {
            "bit_identical": [render(to_jsonable(p)) for p in got] == baseline,
            "all_verify": all(p.verify(root) for p in got),
            "recoveries": _recoveries("proof.shard") - before,
        }
        before = _recoveries("proof.serve", "retried")
        batches = faults = served = 0
        chaos.install("seed=11,shard_fail=1.0,proof_fail=1.0")
        try:
            for i in range(0, samples, 8):
                batches += 1
                try:
                    served += len(sampler.sample_batch(entry, coords[i:i + 8]))
                except DeviceFault:
                    faults += 1
        finally:
            chaos.install("")
        legs["device_fault"] = {
            "batches": batches,
            "device_faults": faults,
            "served": served,
            "recoveries": _recoveries("proof.serve", "retried") - before,
        }
        single = legs["single_device"]
        fault = legs["device_fault"]
        ok = (
            sharded
            and single["bit_identical"] and single["all_verify"]
            and single["recoveries"] > 0
            and fault["device_faults"] == batches and not fault["served"]
            and fault["recoveries"] > 0
        )
        return {
            "samples": samples,
            "k": k,
            "shards": shards,
            "sharded": sharded,
            "legs": legs,
            "ok": ok,
        }
    finally:
        chaos.uninstall()
        if saved is None:
            os.environ.pop("CELESTIA_SERVE_SHARDS", None)
        else:
            os.environ["CELESTIA_SERVE_SHARDS"] = saved


@_drill
def run_extend_shard_drill(k: int = 8, shards: int = 8,
                           panel_rows: int = 2, device=None) -> dict:
    """The SHARDED extend+DAH plane's rung-ladder drill
    (kernels/panel_sharded.py, $CELESTIA_EXTEND_SHARDS).

    Baseline: one square extended on the single-device materializing
    path (no chaos, no sharding), its DAH roots the reference.  Leg 1:
    the sharded-panel seam engaged with no chaos — the committed-
    sharding multi-chip pipeline must produce bit-identical roots AND a
    row-sharded EDS.  Leg 2: `extend_shard_fail=1.0` fails every
    sharded collective dispatch MID-schedule — guarded_dispatch must
    walk the ladder sharded_panel -> panel (the single-device runner),
    roots unchanged, ticking the dispatch-seam recoveries and leaving
    /healthz's degraded map on the panel rung.  The write-side ladder's
    top seam, drilled end-to-end.

    The shard count is clamped to the devices of `device`'s type, read
    through kernels/panel_sharded so that `logical_shards` reaches it, and
    the EDS's shards are counted from its RowSharded blocks.
    """
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.chaos import degrade
    from celestia_app_tpu_torch.da.eds import ExtendedDataSquare
    from celestia_app_tpu_torch.trace.metrics import registry

    # Clamp to the devices AND the square — then pow2-floor, exactly as
    # extend_shards() will (each device owns at least one ODS row; the
    # XOR butterfly needs a power of two): the drill's expectation must
    # match what the seam actually engages with, or a 6-device host
    # would fail the drill despite a healthy ladder.
    from celestia_app_tpu_torch.kernels import panel_sharded
    from celestia_app_tpu_torch.kernels.panel_sharded import _pow2_floor

    dev = resolve_device(device)
    shards = _pow2_floor(min(shards, panel_sharded.device_count(dev), k))
    _, ods = deterministic_blocks(1, k, seed=4242)[0]
    saved = {
        key: os.environ.get(key)
        for key in ("CELESTIA_EXTEND_SHARDS", "CELESTIA_PIPE_PANEL")
    }

    try:
        chaos.install("")  # baseline leg: no injection even with env chaos
        degrade.reset_for_tests()
        os.environ.pop("CELESTIA_EXTEND_SHARDS", None)
        os.environ.pop("CELESTIA_PIPE_PANEL", None)
        root = ExtendedDataSquare.compute(ods, device=dev).data_root()

        os.environ["CELESTIA_PIPE_PANEL"] = str(panel_rows)
        os.environ["CELESTIA_EXTEND_SHARDS"] = str(shards)
        from celestia_app_tpu_torch.kernels.fused import pipeline_mode_for_k
        from celestia_app_tpu_torch.kernels.panel_sharded import shards_for_k

        engaged = pipeline_mode_for_k(k, dev) == "sharded_panel"
        eds_sharded = ExtendedDataSquare.compute(ods, device=dev)
        sharded_identical = eds_sharded.data_root() == root
        n_shards = len(set(getattr(eds_sharded._eds, "owners", ()))) or 1

        before = _recoveries("device.dispatch")
        t0_ns = time.time_ns()
        chaos.install("seed=13,extend_shard_fail=1.0")
        try:
            eds_faulted = ExtendedDataSquare.compute(ods, device=dev)
        finally:
            chaos.install("")
        fault_identical = eds_faulted.data_root() == root
        state = degrade.degraded_state() or {}
        walked_to = state.get("device")
        recovered = _recoveries("device.dispatch") - before
        ok = (
            engaged
            and shards_for_k(k, dev) == shards
            and sharded_identical
            and n_shards == shards
            and fault_identical
            and walked_to == "panel"
            and recovered > 0
        )
        return {
            "k": k,
            "shards": shards,
            "engaged": engaged,
            "sharded_identical": sharded_identical,
            "eds_device_shards": n_shards,
            "fault_identical": fault_identical,
            "walked_to": walked_to,
            "recoveries": recovered,
            # Time-to-detection for the summary table: the breaker trip
            # black-boxes via the flight recorder when armed.
            "detection": _detection(t0_ns, trigger="breaker_trip"),
            "ok": ok,
        }
    finally:
        chaos.uninstall()
        degrade.reset_for_tests()
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


@_drill
def run_speculation_drill(k: int = 4, blocks: int = 6,
                          spec: str = "seed=3,dispatch_fail=0.3",
                          device=None) -> dict:
    """The speculative-extend leg of the 'latency, never correctness'
    claim: with $CELESTIA_PIPE_SPECULATE=on, every block speculates the
    NEXT block's square ahead of adoption, and every other adoption is a
    ROUND CHANGE (the adopted square differs from the speculated one, so
    the claim must discard and recompute) — all under injected dispatch
    faults so a speculative dispatch also walks the retry/ladder path.
    Every committed root must be bit-identical to the speculation-off
    chaos-off run, and the discards must actually have fired."""
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.chaos import degrade
    from celestia_app_tpu_torch.da.eds import ExtendedDataSquare, speculator
    from celestia_app_tpu_torch.trace.metrics import registry

    dev = resolve_device(device)
    pairs = deterministic_blocks(2 * blocks, k, seed=777)
    adopted = [ods for _tag, ods in pairs[:blocks]]
    reproposed = [ods for _tag, ods in pairs[blocks:]]

    chaos.install("")  # speculation-off, chaos-off baseline
    degrade.reset_for_tests()
    saved = os.environ.get("CELESTIA_PIPE_SPECULATE")
    os.environ.pop("CELESTIA_PIPE_SPECULATE", None)
    baseline = [ExtendedDataSquare.compute(o, device=dev).data_root()
                for o in adopted]

    def _outcomes() -> dict:
        out = {"hit": 0.0, "discard": 0.0}
        for labels, val in registry().counter(
            "celestia_speculation_total", ""
        ).samples():
            out[labels.get("outcome", "?")] = val
        return out

    before = _outcomes()
    os.environ["CELESTIA_PIPE_SPECULATE"] = "on"
    chaos.install(spec)
    t0_ns = time.time_ns()
    try:
        roots = []
        sp = speculator()
        for i, ods in enumerate(adopted):
            if i % 2:
                # Round change: what was speculated is NOT what adoption
                # brings — the claim must discard and compute fresh.
                sp.speculate(reproposed[i], height=i, round_=0, device=dev)
            else:
                sp.speculate(ods, height=i, round_=0, device=dev)
            roots.append(ExtendedDataSquare.compute(ods, device=dev).data_root())
    finally:
        chaos.uninstall()
        degrade.reset_for_tests()
        if saved is None:
            os.environ.pop("CELESTIA_PIPE_SPECULATE", None)
        else:
            os.environ["CELESTIA_PIPE_SPECULATE"] = saved
    after = _outcomes()
    hits = after["hit"] - before["hit"]
    discards = after["discard"] - before["discard"]
    identical = roots == baseline
    return {
        "blocks": blocks,
        "k": k,
        "roots_identical": identical,
        "hits": hits,
        "discards": discards,
        # Hits are best-effort under dispatch_fail (a failed speculative
        # dispatch simply never parks an entry); discards are the drill's
        # point and MUST have fired on every round change that resolved.
        "ok": identical and discards >= 1,
        "detection": _detection(t0_ns),
    }


#: DAS sample counts the withholding drill sweeps (the detection-
#: probability curve's x axis, after the Polar Coded Merkle Tree papers'
#: availability-attack benchmarks: P(detect | s samples) = 1 - (1-f)^s).
DAS_SAMPLE_COUNTS = (2, 4, 8, 16, 32, 64)


def _adv_square(k: int, seed: int = 515, device=None):
    """One committed square + its serve-plane state (cache entry,
    sampler, provider) — the fixture every adversary drill samples."""
    from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader
    from celestia_app_tpu_torch.da.eds import ExtendedDataSquare
    from celestia_app_tpu_torch.serve.api import DasProvider
    from celestia_app_tpu_torch.serve.cache import ForestCache
    from celestia_app_tpu_torch.serve.sampler import ProofSampler

    dev = resolve_device(device)
    _, ods = deterministic_blocks(1, k, seed=seed)[0]
    eds = ExtendedDataSquare.compute(ods, device=dev)
    dah = DataAvailabilityHeader.from_eds(eds)
    cache = ForestCache(heights=2, spill=2, device=dev)
    entry = cache.put(1, eds)
    provider = DasProvider(cache=cache, sampler=ProofSampler(device=dev))
    return eds, dah, entry, provider


@_drill
def run_withholding_drill(
    k: int = 8,
    fracs: tuple[float, ...] = (0.05, 0.10, 0.25),
    trials: int = 200,
    sample_counts: tuple[int, ...] = DAS_SAMPLE_COUNTS,
    device=None,
) -> dict:
    """The detection-probability-vs-sample-count measurement over the
    serve plane.

    A withholding proposer commits the honest DAH but hides a random
    `withhold_frac` of the EDS shares.  Light clients draw uniform DAS
    samples THROUGH ProofSampler — the same plane `GET /das/share_proof`
    serves — and a sample landing on a withheld share raises
    ShareWithheld: that failed sample IS detection.  For each fraction
    the drill runs `trials` independent clients, each drawing up to
    max(sample_counts) samples, and reports P(detect within s) for every
    s — NESTED sampling (s samples are the first s of the client's
    draw), so the measured curve is monotone in s by construction, as
    the analytic 1-(1-f)^s is.

    Then the repair-to-recovery leg: after detection, a full node
    gathers the surviving shares (everything the adversary did not
    withhold) and runs the BATCHED repair; recovery = repaired roots
    match the committed DAH.  The drill reports detect_ms (first
    detecting sample) + repair_ms separately.

    The honest leg pins the attack surface closed: a spec with every
    adversary key AT ZERO must serve proofs byte-identical to no chaos
    at all."""
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.da.repair import repair
    from celestia_app_tpu_torch.rpc.codec import to_jsonable
    from celestia_app_tpu_torch.serve.api import render
    from celestia_app_tpu_torch.serve.sampler import ShareWithheld
    from celestia_app_tpu_torch.trace import flight_recorder

    dev = resolve_device(device)
    _arm_flight_recorder()
    eds, dah, entry, provider = _adv_square(k, device=dev)
    honest_root = eds.data_root()
    n = 2 * k
    s_max = max(sample_counts)

    # Honest leg: adversary keys at 0 == no chaos, byte for byte.
    probe = [(r, c) for r in range(n) for c in range(min(n, 4))]
    chaos.install("")
    baseline = [
        render(to_jsonable(p))
        for p in provider.sampler.sample_batch(provider.entry(1), probe)
    ]
    chaos.install("seed=21,withhold_frac=0,malform_shares=0,wrong_root=0")
    keys_zero = [
        render(to_jsonable(p))
        for p in provider.sampler.sample_batch(provider.entry(1), probe)
    ]
    honest_identical = keys_zero == baseline

    flight_recorder._reset_for_tests()
    _restore_interval = _pin_flight_interval()
    try:
        t0_ns = time.time_ns()
        curves = []
        all_monotone = True
        for frac in fracs:
            chaos.install(f"seed=21,withhold_frac={frac}")
            ent = provider.entry(1)
            client = np.random.default_rng(4242)
            first_detect = []
            for _ in range(trials):
                idx = s_max  # not detected within the client's budget
                for i in range(s_max):
                    r = int(client.integers(0, n))
                    c = int(client.integers(0, n))
                    try:
                        proof = provider.sampler.share_proof(ent, r, c)
                    except ShareWithheld:
                        idx = i
                        break
                    # Served samples must still be honest, verifying proofs.
                    if not proof.verify(honest_root):
                        idx = -1  # invalid proof served: drill failure
                        break
                first_detect.append(idx)
            if any(i < 0 for i in first_detect):
                curves.append({"withhold_frac": frac, "p_detect": None,
                               "invalid_proof_served": True})
                all_monotone = False
                continue
            p_detect = {
                str(s): round(
                    sum(1 for i in first_detect if i < s) / trials, 4
                )
                for s in sample_counts
            }
            vals = [p_detect[str(s)] for s in sample_counts]
            monotone = all(b >= a for a, b in zip(vals, vals[1:]))
            all_monotone = all_monotone and monotone
            curves.append({
                "withhold_frac": frac,
                "p_detect": p_detect,
                "monotone": monotone,
                "expected_at_max": round(1 - (1 - frac) ** s_max, 4),
            })

        # Repair-to-recovery at the heaviest fraction: detect -> gather
        # survivors -> batched repair -> roots match the committed DAH.
        frac = max(fracs)
        chaos.install(f"seed=21,withhold_frac={frac}")
        adv = chaos.active_adversary()
        withheld = adv.withheld_set(1, n)
        ent = provider.entry(1)
        client = np.random.default_rng(777)
        t_detect0 = time.perf_counter()
        detect_ms = None
        for _ in range(64 * 64):
            r = int(client.integers(0, n))
            c = int(client.integers(0, n))
            try:
                provider.sampler.share_proof(ent, r, c)
            except ShareWithheld:
                detect_ms = (time.perf_counter() - t_detect0) * 1e3
                break
        recovered = False
        repair_ms = None
        if detect_ms is not None:
            present = np.ones((n, n), dtype=bool)
            for (r, c) in withheld:
                present[r, c] = False
            full = np.asarray(eds.squared())
            damaged = np.where(present[..., None], full, 0).astype(np.uint8)
            # Warm the sweep + pipeline for this erasure shape (the bench
            # convention: a serving node is warm; the latency recorded is
            # the repair, not the first-ever kernel build or recover-matrix
            # solve).
            try:
                repair(damaged.copy(), present, dah, device=dev)
            except Exception:  # noqa: BLE001 — the timed leg reports it
                pass
            t_rep0 = time.perf_counter()
            try:
                out = repair(damaged, present, dah, device=dev)
                repair_ms = (time.perf_counter() - t_rep0) * 1e3
                recovered = out.data_root() == honest_root
            except Exception as e:  # noqa: BLE001 — recorded as drill failure
                repair_ms = (time.perf_counter() - t_rep0) * 1e3
                recovered = False
                print(f"withholding drill: repair failed: {e}", file=sys.stderr)
        chaos.uninstall()
    finally:
        _restore_interval()
    wh_dumps = flight_recorder.recent_dumps(
        since_ns=t0_ns, trigger="withholding_detected"
    )
    return {
        "k": k,
        "trials": trials,
        "sample_counts": list(sample_counts),
        "detection": curves,
        "honest_identical": honest_identical,
        "all_monotone": all_monotone,
        "repair": {
            "withhold_frac": frac,
            "withheld_shares": len(withheld),
            "detect_ms": round(detect_ms, 3) if detect_ms else None,
            "repair_ms": round(repair_ms, 3) if repair_ms else None,
            "total_ms": (
                round(detect_ms + repair_ms, 3)
                if detect_ms and repair_ms else None
            ),
            "recovered": recovered,
        },
        # The rate limit makes a drill-long storm of detections ONE
        # bundle: the first detection black-boxes, the rest suppress.
        "flight_dumps": len(wh_dumps),
        "detection_signal": _detection(t0_ns, trigger="withholding_detected"),
        "ok": (
            honest_identical and all_monotone and recovered
            and len(wh_dumps) == 1
        ),
    }


@_drill
def run_adversary_detection_drill(k: int = 8, device=None) -> dict:
    """Malformed-square + wrong-root injections must ALWAYS be detected
    (sampler verification or repair RootMismatch) and never served as
    valid proofs — with each adversary event producing exactly ONE
    flight bundle per drill under the rate limit.

      malform leg   every coordinate of the tampered square is sampled;
                    proofs over corrupted shares raise BadProofDetected,
                    everything served must verify against the honest
                    root; a corrupted SURVIVOR fed to repair raises
                    RootMismatch (the full-node face of the detection).
      wrong-root leg  the served root is forged: NO sample can produce
                    a proof chaining to it (all raise), and a repair
                    against a wrong commitment raises RootMismatch.
    """
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader
    from celestia_app_tpu_torch.da.eds import ExtendedDataSquare
    from celestia_app_tpu_torch.da.repair import RootMismatch, repair
    from celestia_app_tpu_torch.serve.sampler import BadProofDetected
    from celestia_app_tpu_torch.trace import flight_recorder

    dev = resolve_device(device)
    _arm_flight_recorder()
    eds, dah, entry, provider = _adv_square(k, seed=616, device=dev)
    honest_root = eds.data_root()
    n = 2 * k
    full = np.asarray(eds.squared())
    flight_recorder._reset_for_tests()
    _restore_interval = _pin_flight_interval()
    try:
        t0_ns = time.time_ns()

        # --- malform leg -------------------------------------------------------
        chaos.install("seed=13,malform_shares=4")
        adv = chaos.active_adversary()
        mal_entry = provider.entry(1)
        corrupted = set(adv.malformed_coords(1, n))
        detected, served_valid, served_invalid = 0, 0, 0
        for r in range(n):
            for c in range(n):
                try:
                    proof = provider.sampler.share_proof(mal_entry, r, c)
                except BadProofDetected:
                    detected += 1
                    continue
                if proof.verify(honest_root):
                    served_valid += 1
                else:
                    served_invalid += 1
        malform_ok = (
            detected == len(corrupted)
            and served_invalid == 0
            and served_valid == n * n - len(corrupted)
        )

        # The full-node face: one corrupted SURVIVOR in a repair input must
        # reject the whole reconstruction (RootMismatch), never pass.
        present = np.ones((n, n), dtype=bool)
        present[k:, k:] = False
        damaged = np.where(present[..., None], full, 0).astype(np.uint8)
        damaged = adv.corrupt_square(1, damaged)
        try:
            repair(damaged, present, dah, device=dev)
            repair_detected = False
        except RootMismatch:
            repair_detected = True

        # --- wrong-root leg ----------------------------------------------------
        chaos.install("seed=13,wrong_root=1")
        wr_entry = provider.entry(1)
        root_forged = wr_entry.data_root != honest_root
        wr_detected = 0
        probe = [(0, 0), (k, k), (n - 1, n - 1), (0, n - 1)]
        for r, c in probe:
            try:
                provider.sampler.share_proof(wr_entry, r, c)
            except BadProofDetected:
                wr_detected += 1
        # A light node repairing against a wrong commitment must refuse it.
        other = deterministic_blocks(1, k, seed=617)[0][1]
        wrong_dah = DataAvailabilityHeader.from_eds(
            ExtendedDataSquare.compute(other, device=dev)
        )
        clean = np.where(present[..., None], full, 0).astype(np.uint8)
        try:
            repair(clean, present, wrong_dah, device=dev)
            wrong_root_repair_detected = False
        except RootMismatch:
            wrong_root_repair_detected = True
        chaos.uninstall()
    finally:
        _restore_interval()

    rm_dumps = flight_recorder.recent_dumps(
        since_ns=t0_ns, trigger="root_mismatch"
    )
    return {
        "k": k,
        "malform": {
            "corrupted_shares": len(corrupted),
            "detected": detected,
            "served_valid": served_valid,
            "served_invalid": served_invalid,
            "repair_detected": repair_detected,
            "ok": malform_ok and repair_detected,
        },
        "wrong_root": {
            "root_forged": root_forged,
            "samples_detected": wr_detected,
            "samples_probed": len(probe),
            "repair_detected": wrong_root_repair_detected,
            "ok": (
                root_forged
                and wr_detected == len(probe)
                and wrong_root_repair_detected
            ),
        },
        # One bundle per drill: every further root_mismatch suppresses
        # against the first under the default rate limit.
        "flight_dumps": len(rm_dumps),
        "detection": _detection(t0_ns, trigger="root_mismatch"),
        "ok": (
            malform_ok and repair_detected and root_forged
            and wr_detected == len(probe) and wrong_root_repair_detected
            and len(rm_dumps) == 1
        ),
    }


def _wait_until(predicate, timeout_s: float = 120.0,
                poll_s: float = 0.005) -> bool:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if predicate():
            return True
        time.sleep(poll_s)
    return False


@_drill
def run_healing_drill(k: int = 8, frac: float = 0.25,
                      quarantine_frac: float = 0.95, device=None) -> dict:
    """The detect -> repair -> re-serve loop, measured end to end through
    the real sampling plane (ACeD's oracle loop).

    Three legs on one node, healing on a live worker thread:

      withhold leg   a DAS client samples the adversarial serve view
                     until ShareWithheld fires; that detection TRIGGERS
                     the HealingEngine, samples arriving mid-heal get the
                     retryable HealingInProgress (the 503/UNAVAILABLE
                     face), and the drill measures detect-to-restored-
                     service: the previously-withheld coordinate must
                     serve a verifying proof from the healed height.
      wrong-root leg the tampered root is detected at the verification
                     gate, healed, and the recovered root must be
                     BIT-IDENTICAL to the committed DAH — with NOTHING
                     tampered served as valid at any point in the window.
      quarantine leg withholding beyond the k-survivor threshold: the
                     heal must land in quarantine (irrecoverable), stay
                     terminal (no heal storm, no retry of the impossible)
                     and black-box through `heal_quarantined`.

    Hard invariants (bench_trend gates these from the ADV round record):
    served_after_heal, root_identical, tampered_never_served, healed.
    The repair jit cache is warmed for the measured erasure shape first
    (the bench convention: a serving node's cache is warm; the number is
    the heal, not the first-ever compile).

    The port's heal leaves a device.DeviceFault unjudged (serve/heal.py:
    no quarantine, no healed record); the drill injects none, so its
    expectations are the JAX ones, and an irrecoverable square still lands
    in quarantine."""
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.da.repair import repair
    from celestia_app_tpu_torch.serve import heal as heal_mod
    from celestia_app_tpu_torch.serve.heal import HealingEngine, HealingInProgress
    from celestia_app_tpu_torch.serve.sampler import BadProofDetected, ShareWithheld
    from celestia_app_tpu_torch.trace import flight_recorder

    dev = resolve_device(device)
    _arm_flight_recorder()
    chaos.install("")
    eds, dah, entry, provider = _adv_square(k, seed=909, device=dev)
    honest_root = eds.data_root()
    # Second + third heights for the wrong-root and quarantine legs.
    extra = {}
    for h, seed in ((2, 910), (3, 911)):
        _, ods_h = deterministic_blocks(1, k, seed=seed)[0]
        from celestia_app_tpu_torch.da.eds import ExtendedDataSquare

        eds_h = ExtendedDataSquare.compute(ods_h, device=dev)
        provider.cache.put(h, eds_h)
        extra[h] = eds_h.data_root()
    n = 2 * k
    engine = HealingEngine(provider, name="drill", retry_after_s=0.2).start()
    flight_recorder._reset_for_tests()
    # Rate limit OPEN (not drill-spanning): every terminal heal
    # transition must black-box — this drill asserts one bundle per
    # healed height plus the quarantine bundle.
    _restore_interval = _pin_flight_interval(0.0)
    tampered_served = False
    try:
        t0_ns = time.time_ns()
        # --- withhold leg --------------------------------------------------
        chaos.install(f"seed=41,withhold_frac={frac}")
        adv = chaos.active_adversary()
        withheld = sorted(adv.withheld_set(1, n))
        # Warm the repair for this exact erasure shape so the measured
        # heal is the heal, not the first recover-matrix solve.
        view = provider.serve_view(1)
        honest = provider._honest_entry(1)
        w_shares, w_present = heal_mod.default_survivors(1, view, honest)
        try:
            repair(w_shares, w_present, device=dev)
        except Exception:  # noqa: BLE001 — warmup only; the heal re-runs it
            pass
        client = np.random.default_rng(4321)
        detect_samples, hit = 0, None
        t_attack = time.perf_counter()
        while hit is None and detect_samples < n * n * 4:
            r, c = int(client.integers(0, n)), int(client.integers(0, n))
            detect_samples += 1
            try:
                ent = provider.entry(1)
                proof = provider.sampler.share_proof(ent, r, c)
                if not proof.verify(honest_root):
                    tampered_served = True
            except ShareWithheld:
                hit = (r, c)
        detect_ms = (time.perf_counter() - t_attack) * 1e3
        # Mid-heal: the worker is repairing right now — a sample must see
        # the RETRYABLE status, not a terminal detection.
        midheal_retryable = None
        try:
            provider.entry(1)
            midheal_retryable = False  # heal already done: can't observe
        except HealingInProgress:
            midheal_retryable = True
        healed = _wait_until(lambda: not engine.healing(1))
        restored = False
        if healed and hit is not None:
            ent = provider.entry(1)
            proof = provider.sampler.share_proof(ent, *hit)
            restored = proof.verify(honest_root)
        restored_ms = (time.perf_counter() - t_attack) * 1e3
        # Every previously-withheld coordinate serves now (spot cap 32).
        served_after_heal = restored
        ent = provider.entry(1)
        for r, c in withheld[:32]:
            p = provider.sampler.share_proof(ent, r, c)
            served_after_heal = served_after_heal and p.verify(honest_root)
        root_identical = (
            ent.data_root == honest_root
            and ent.eds.data_root() == honest_root
        )
        with engine._cv:
            single_rec = dict(engine._healed.get(1) or {})

        # --- wrong-root leg ------------------------------------------------
        chaos.install("seed=41,wrong_root=1")
        wr_detected = False
        try:
            ent2 = provider.entry(2)
            proof = provider.sampler.share_proof(ent2, 0, 0)
            if not proof.verify(extra[2]):
                tampered_served = True
        except BadProofDetected:
            wr_detected = True
        wr_healed = _wait_until(lambda: not engine.healing(2))
        ent2 = provider.entry(2)
        wr_root_identical = ent2.data_root == extra[2]
        wr_serves = provider.sampler.share_proof(ent2, 0, 0).verify(extra[2])

        # --- quarantine leg ------------------------------------------------
        chaos.install(f"seed=41,withhold_frac={quarantine_frac}")
        q_detected = False
        try:
            ent3 = provider.entry(3)
            provider.sampler.share_proof(ent3, 0, 0)
        except ShareWithheld:
            q_detected = True
        except BadProofDetected:
            pass
        _wait_until(lambda: not engine.healing(3))
        quarantined = engine.is_quarantined(3)
        # Terminal: the next detection answers 410 again (no heal storm).
        q_terminal = False
        try:
            ent3 = provider.entry(3)
            provider.sampler.share_proof(ent3, 0, 0)
        except ShareWithheld:
            q_terminal = True
        q_state = engine.state()["quarantined"].get("3") or {}
    finally:
        chaos.uninstall()
        _restore_interval()
        engine.close()
    completed = flight_recorder.recent_dumps(
        since_ns=t0_ns, trigger="heal_completed"
    )
    quarantined_dumps = flight_recorder.recent_dumps(
        since_ns=t0_ns, trigger="heal_quarantined"
    )
    return {
        "k": k,
        "withhold_frac": frac,
        "detect": {"samples": detect_samples, "ms": round(detect_ms, 3)},
        "midheal_retryable": midheal_retryable,
        "heal": single_rec,
        "restored_ms": round(restored_ms, 3),
        "served_after_heal": served_after_heal,
        "root_identical": root_identical,
        "tampered_never_served": not tampered_served,
        "wrong_root": {
            "detected": wr_detected,
            "healed": wr_healed,
            "root_identical": wr_root_identical,
            "serves": wr_serves,
        },
        "quarantine": {
            "frac": quarantine_frac,
            "detected": q_detected,
            "quarantined": quarantined,
            "terminal_after": q_terminal,
            "outcome": q_state.get("outcome"),
            "bundle": len(quarantined_dumps) >= 1,
        },
        "heal_bundles": len(completed),
        "detection": _detection(t0_ns, trigger="heal_completed"),
        "ok": (
            hit is not None
            and single_rec.get("outcome") == "healed"
            and served_after_heal
            and root_identical
            and not tampered_served
            and wr_detected and wr_healed and wr_root_identical and wr_serves
            and q_detected and quarantined and q_terminal
            and q_state.get("outcome") == "irrecoverable"
            and len(quarantined_dumps) >= 1
            and len(completed) >= 2
        ),
    }


@_drill
def run_quorum_heal_drill(nodes: int = 3, k: int = 8,
                          frac: float = 0.25,
                          hold_p: float = 0.75, device=None) -> dict:
    """Scale the heal past one process: N honest serve-nodes, each
    retaining a PARTIAL local share set (every share held with
    probability `hold_p`, per-node seeded), under one withholding
    proposer.  Each node detects through its own sampling plane; each
    node's engine repairs from the UNION of the quorum's surviving
    shares (what peers can answer, minus what the adversary withholds,
    every gathered share leaf-digest-verified against the committed
    forest) and re-serves.  Per-node flight bundles (heal_completed
    carries node/height/phase latencies; the rate limit is opened so
    every node's detection black-boxes) prove who detected what when.

    Invariants: every node serves the previously-withheld coordinate
    with a proof verifying the committed root post-heal, and every
    node's recovered root is bit-identical to the committed DAH."""
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.da.eds import ExtendedDataSquare
    from celestia_app_tpu_torch.da.repair import repair
    from celestia_app_tpu_torch.serve import heal as heal_mod
    from celestia_app_tpu_torch.serve.api import DasProvider
    from celestia_app_tpu_torch.serve.cache import ForestCache
    from celestia_app_tpu_torch.serve.heal import HealingEngine
    from celestia_app_tpu_torch.serve.sampler import ProofSampler, ShareWithheld
    from celestia_app_tpu_torch.trace import flight_recorder

    dev = resolve_device(device)
    _arm_flight_recorder()
    chaos.install("")
    _, ods = deterministic_blocks(1, k, seed=515)[0]
    n = 2 * k
    # Per-node partial retention + the quorum union every healer gathers
    # from.  Seeded so the drill (and its ADV round record) reproduces.
    mask_rng = np.random.default_rng(2718)
    local = [mask_rng.random((n, n)) < hold_p for _ in range(nodes)]
    union = np.logical_or.reduce(local)

    def union_gather(height, view, honest):
        shares, present = heal_mod.default_survivors(height, view, honest)
        return shares, present & union

    providers, engines, roots = [], [], []
    for i in range(nodes):
        eds_i = ExtendedDataSquare.compute(ods, device=dev)  # own handle per node
        cache_i = ForestCache(heights=2, spill=2, device=dev)
        cache_i.put(1, eds_i)
        provider_i = DasProvider(cache=cache_i,
                                 sampler=ProofSampler(device=dev))
        providers.append(provider_i)
        roots.append(eds_i.data_root())
        engines.append(HealingEngine(
            provider_i, name=f"node{i}", survivors=union_gather,
            retry_after_s=0.2,
        ))
    honest_root = roots[0]
    flight_recorder._reset_for_tests()
    _restore_interval = _pin_flight_interval(0.0)  # one bundle per NODE
    try:
        t0_ns = time.time_ns()
        chaos.install(f"seed=51,withhold_frac={frac}")
        adv = chaos.active_adversary()
        withheld = sorted(adv.withheld_set(1, n))
        # Warm the union erasure shape once (its recover matrices).
        view = providers[0].serve_view(1)
        honest = providers[0]._honest_entry(1)
        w_shares, w_present = union_gather(1, view, honest)
        try:
            repair(w_shares, w_present, device=dev)
        except Exception:  # noqa: BLE001 — warmup only
            pass
        t_attack = time.perf_counter()
        detections_per_node = []
        for i, provider_i in enumerate(providers):
            client = np.random.default_rng(7000 + i)
            hit, samples = None, 0
            t_n0 = time.perf_counter()
            while hit is None and samples < n * n * 4:
                r, c = int(client.integers(0, n)), int(client.integers(0, n))
                samples += 1
                try:
                    ent = provider_i.entry(1)
                    provider_i.sampler.share_proof(ent, r, c)
                except ShareWithheld:
                    hit = (r, c)
            detections_per_node.append({
                "node": f"node{i}",
                "samples": samples,
                "ms": round((time.perf_counter() - t_n0) * 1e3, 3),
                "coord": list(hit) if hit else None,
            })
        # Collective recovery: every detecting node heals from the union.
        heal_records = []
        for i, engine in enumerate(engines):
            engine.process_pending()
            with engine._cv:
                heal_records.append(dict(engine._healed.get(1) or {}))
        # Restored service: the first detector's previously-withheld
        # coordinate serves on EVERY node, proofs verifying the
        # committed root.
        first_hit = tuple(detections_per_node[0]["coord"])
        served, roots_ok = True, True
        for provider_i in providers:
            ent = provider_i.entry(1)
            p = provider_i.sampler.share_proof(ent, *first_hit)
            served = served and p.verify(honest_root)
            roots_ok = roots_ok and (
                ent.data_root == honest_root
                and ent.eds.data_root() == honest_root
            )
        total_ms = (time.perf_counter() - t_attack) * 1e3
    finally:
        chaos.uninstall()
        _restore_interval()
        for engine in engines:
            engine.close()
    completed = flight_recorder.recent_dumps(
        since_ns=t0_ns, trigger="heal_completed"
    )
    healed_nodes = sum(
        1 for rec in heal_records if rec.get("outcome") == "healed"
    )
    return {
        "nodes": nodes,
        "k": k,
        "withhold_frac": frac,
        "hold_p": hold_p,
        "withheld_shares": len(withheld),
        "union_coverage": round(float(union.mean()), 4),
        "detections": detections_per_node,
        "heals": heal_records,
        "healed_nodes": healed_nodes,
        "served_after_heal": served,
        "root_identical": roots_ok,
        "total_ms": round(total_ms, 3),
        "heal_bundles": len(completed),
        "detection": _detection(t0_ns, trigger="heal_completed"),
        "ok": (
            healed_nodes == nodes
            and served and roots_ok
            and all(d["coord"] for d in detections_per_node)
            and len(completed) == nodes
        ),
    }


@_drill
def run_batched_fault_drill(k: int = 4, blocks: int = 6,
                            batch: int = 2, device=None) -> dict:
    """A persistent batched-dispatch fault must fall DOWN the ladder, not
    lose blocks: dispatch_fail=1.0 (the fused family, batched program
    included) forces every coalesced dispatch onto the per-square
    fallback (celestia_recoveries_total{outcome=unbatched}), whose own
    failures then walk fused -> staged via the breaker — with every root
    bit-identical to the chaos-off unbatched run."""
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.chaos import degrade
    from celestia_app_tpu_torch.kernels.fused import pipeline_mode
    from celestia_app_tpu_torch.parallel.pipeline import stream_blocks
    from celestia_app_tpu_torch.trace.metrics import registry

    dev = resolve_device(device)
    pairs = deterministic_blocks(blocks, k, seed=313)

    chaos.install("")
    degrade.reset_for_tests()
    baseline = {
        tag: eds.data_root()
        for tag, eds in stream_blocks(iter(pairs), k, depth=2, batch=1,
                                      device=dev)
    }

    def _unbatched_falls() -> float:
        for labels, val in registry().counter(
            "celestia_recoveries_total", ""
        ).samples():
            if (labels.get("seam") == "device.dispatch"
                    and labels.get("outcome") == "unbatched"):
                return val
        return 0.0

    before = _unbatched_falls()
    chaos.install("seed=17,dispatch_fail=1.0")
    t0_ns = time.time_ns()
    try:
        chaotic = {
            tag: eds.data_root()
            for tag, eds in stream_blocks(
                iter(pairs), k, depth=max(2, batch), batch=batch, device=dev
            )
        }
        final_mode = pipeline_mode()
    finally:
        chaos.uninstall()
        degrade.reset_for_tests()
    falls = _unbatched_falls() - before
    identical = chaotic == baseline
    return {
        "blocks": blocks,
        "k": k,
        "batch": batch,
        "roots_identical": identical,
        "unbatched_falls": falls,
        "final_mode": final_mode,
        # The fused family is fully failed, so the ladder must have
        # landed on staged AND the batched rung must have stepped down
        # through the unbatched fallback at least once on the way.
        "ok": identical and falls >= 1 and final_mode == "staged",
        "detection": _detection(t0_ns),
    }


@_drill
def run_attestation_drill(k: int = 4, samples: int = 12,
                          device=None) -> dict:
    """The verify plane's fault drill, attestation-shaped.

    Leg 1 (verify_fail identity): one deduped multiproof attestation is
    assembled, its proofs reconstructed, and ONE share tampered so the
    accept/reject vector is non-trivial.  The batched verdict must not
    tick celestia_recoveries_total{seam="proof.verify"} when healthy.
    Where the JAX verifier answers a failed batched dispatch on the host,
    the port's retries it on the card (chaos/degrade.retry_on_card) and
    raises device.DeviceFault past the last retry.  So the leg runs twice:
    under `seed=6,verify_fail=0.5` (two failed dispatches, then one that
    passes) the retries absorb the faults and the vector (and the
    attestation bytes) must be IDENTICAL while the `outcome="retried"`
    counter ticks; under the persistent
    `verify_fail=1.0`, where JAX's host path answered, the verifier must
    raise DeviceFault after its retries and answer nothing.

    Leg 2 (tampered 502): a malform adversary corrupts shares under
    honest forests — an attestation covering a corrupted coordinate
    must REFUSE (BadProofDetected, the refusal every plane renders
    502) rather than hand out bytes that cannot verify."""
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.chaos.degrade import DEFAULT_THRESHOLD
    from celestia_app_tpu_torch.rpc.codec import share_proofs_from_attestation
    from celestia_app_tpu_torch.serve.api import render
    from celestia_app_tpu_torch.serve.sampler import BadProofDetected
    from celestia_app_tpu_torch.serve.verify import verify_proofs

    def _tampered(payload: dict) -> list:
        forged = dict(payload)
        forged["shares"] = list(payload["shares"])
        raw = bytearray(bytes.fromhex(forged["shares"][0]))
        raw[100] ^= 0xFF  # past the namespace prefix: data corruption
        forged["shares"][0] = raw.hex()
        return share_proofs_from_attestation(forged)

    dev = resolve_device(device)
    eds, dah, entry, provider = _adv_square(k, seed=818, device=dev)
    root = eds.data_root()
    n = 2 * k
    rng = np.random.default_rng(828)
    coords = set()
    while len(coords) < min(samples, n * n):
        r, c = int(rng.integers(0, n)), int(rng.integers(0, n))
        axis = "row" if rng.integers(0, 2) else "col"
        coords.add((r, c, axis))
    spec = ",".join(f"{r}:{c}:{axis}" for r, c, axis in sorted(coords))

    chaos.install("")  # baseline leg: no injection even with env chaos
    t0_ns = time.time_ns()
    try:
        payload = provider.attestation_payload(1, spec)
        base_bytes = render(payload)
        before = _recoveries("proof.verify")
        base_verdicts = verify_proofs(_tampered(payload), root, device=dev)
        healthy_falls = _recoveries("proof.verify") - before

        chaos.install("seed=6,verify_fail=0.5")
        drilled = provider.attestation_payload(1, spec)
        drilled_bytes = render(drilled)
        before = _recoveries("proof.verify", "retried")
        try:
            drilled_verdicts = verify_proofs(_tampered(drilled), root,
                                             device=dev)
        except DeviceFault:
            drilled_verdicts = None
        retried = _recoveries("proof.verify", "retried") - before

        chaos.install("seed=17,verify_fail=1.0")
        before = _recoveries("proof.verify", "retried")
        try:
            verify_proofs(_tampered(drilled), root, device=dev)
            persistent_refused = False
        except DeviceFault:
            persistent_refused = True
        persistent_retries = _recoveries("proof.verify", "retried") - before

        chaos.install("seed=13,malform_shares=4")
        adv = chaos.active_adversary()
        bad_r, bad_c = sorted(adv.malformed_coords(1, n))[0]
        try:
            provider.attestation_payload(1, f"{bad_r}:{bad_c},0:0")
            tampered_refused = False
        except BadProofDetected:
            tampered_refused = True
    finally:
        chaos.uninstall()

    return {
        "k": k,
        "samples": len(base_verdicts),
        "attest_bytes": len(base_bytes),
        "bytes_identical": drilled_bytes == base_bytes,
        "verdicts_identical": drilled_verdicts == base_verdicts,
        "rejects": base_verdicts.count(False),
        "healthy_falls": healthy_falls,
        "retried": retried,
        "persistent_device_fault": persistent_refused,
        "persistent_retries": persistent_retries,
        "tampered_refused": tampered_refused,
        "ok": (
            drilled_bytes == base_bytes
            and drilled_verdicts == base_verdicts
            and base_verdicts.count(False) == 1
            and healthy_falls == 0
            and retried >= 1
            and persistent_refused
            and persistent_retries == DEFAULT_THRESHOLD
            and tampered_refused
        ),
        "detection": _detection(t0_ns),
    }


@_drill
def run_qos_drill(budget: int = 40_960, quantum: int = 1024,
                  shards: int = 8, device=None) -> dict:
    """QoS enforcement drill — the observe -> enforce loop's write path.

    One sharded mempool under a $CELESTIA_QOS policy: a spammer
    namespace fires admissions at 10x its rate limit while a whale and
    a small honest tenant submit under theirs (the swarm harness's
    whale + small-tenants + spammer mix, mempool-level).  Invariants:

      * the spammer is throttled (QosThrottled — the refusal every
        plane renders 429 / RESOURCE_EXHAUSTED), honest tenants never;
      * honest tenants' DRR reap share is unchanged by the spam leg:
        the small tenant's reaped set is IDENTICAL, the whale's count
        moves by no more than the spammer's admitted budget share;
      * the per-namespace mempool gauges reconcile EXACTLY across
        shards after every insert / reap / committed-drop / TTL path.

    Host work, like the WAL drill: `device` is only resolved.
    """
    from celestia_app_tpu_torch import qos
    from celestia_app_tpu_torch.mempool import PriorityMempool
    from celestia_app_tpu_torch.qos import QosThrottled
    from celestia_app_tpu_torch.trace.metrics import registry

    resolve_device(device)
    WHALE, SMALL, SPAM = "aa", "bb", "ee"
    # The drill's tenants must OWN their labels: in-suite (the tier-1
    # smoke) the process-level top-N admission set may already be full,
    # which would fold every tenant into `other` and collapse the very
    # fairness arbitration under drill.
    from celestia_app_tpu_torch.trace import square_journal

    square_journal._reset_for_tests()
    saved_q = os.environ.get("CELESTIA_MEMPOOL_QUANTUM")
    os.environ["CELESTIA_MEMPOOL_QUANTUM"] = str(quantum)
    qos.install(f"{SPAM}.tx_rate=5,{SPAM}.tx_burst=10")

    def gauges_reconcile(mp) -> bool:
        """Registry per-namespace gauges == the pool's cross-shard sums
        (drained tenants must read 0, never a stale positive)."""
        truth: dict[str, list[int]] = {}
        for s in mp._shards:
            for lbl, (n, b) in s.ns_depth.items():
                agg = truth.setdefault(lbl, [0, 0])
                agg[0] += n
                agg[1] += b
        for name, col in (("celestia_mempool_namespace_txs", 0),
                          ("celestia_mempool_namespace_size_bytes", 1)):
            fam = registry().get(name)
            if fam is None:
                return False
            for labels, value in fam.samples():
                lbl = labels.get("namespace")
                if lbl in (WHALE, SMALL, SPAM):
                    if value != truth.get(lbl, [0, 0])[col]:
                        return False
        return True

    def leg(spam: bool) -> dict:
        mp = PriorityMempool(ttl_num_blocks=1, shards=shards)
        throttled = {WHALE: 0, SMALL: 0, SPAM: 0}

        def ins(ns, i, size, prio):
            tx = f"{ns}:{i}".encode().ljust(size, b".")
            try:
                mp.insert(tx, prio, 0, ns=ns)
            except QosThrottled:
                throttled[ns] += 1

        # The whale outranks everyone on priority AND oversubscribes the
        # reap budget alone — exactly the mix pure-priority reaping
        # starves small tenants under.
        for i in range(30):
            ins(WHALE, i, 2048, 100)
        for i in range(10):
            ins(SMALL, i, 1024, 1)
        if spam:
            for i in range(100):  # 10x the spammer's burst, immediately
                ins(SPAM, i, 256, 50)
        ok_gauges = gauges_reconcile(mp)
        reaped = mp.reap(budget)
        by_ns = {WHALE: [], SMALL: [], SPAM: []}
        for tx in reaped:
            by_ns[tx.split(b":", 1)[0].decode()].append(tx)
        # Commit the reaped set, then age everything else out (TTL=1):
        # both removal paths must leave the gauges reconciled.
        mp.update(1, reaped)
        ok_gauges = ok_gauges and gauges_reconcile(mp)
        mp.update(2, [])
        ok_gauges = ok_gauges and len(mp) == 0 and gauges_reconcile(mp)
        return {"throttled": throttled, "by_ns": by_ns,
                "gauges_reconcile": ok_gauges}

    try:
        honest = leg(spam=False)
        spammed = leg(spam=True)
    finally:
        qos.uninstall()
        if saved_q is None:
            os.environ.pop("CELESTIA_MEMPOOL_QUANTUM", None)
        else:
            os.environ["CELESTIA_MEMPOOL_QUANTUM"] = saved_q

    spam_admitted_bytes = 100 * 256 - spammed["throttled"][SPAM] * 256
    whale_slack = -(-spam_admitted_bytes // 2048)  # ceil, in whale txs
    small_identical = (
        honest["by_ns"][SMALL] == spammed["by_ns"][SMALL]
    )
    whale_share_held = (
        len(spammed["by_ns"][WHALE])
        >= len(honest["by_ns"][WHALE]) - whale_slack
    )
    out = {
        "spam_throttled": spammed["throttled"][SPAM],
        "honest_throttled": (
            spammed["throttled"][WHALE] + spammed["throttled"][SMALL]
            + honest["throttled"][WHALE] + honest["throttled"][SMALL]
        ),
        "small_reaped": len(spammed["by_ns"][SMALL]),
        "whale_reaped_honest": len(honest["by_ns"][WHALE]),
        "whale_reaped_spam": len(spammed["by_ns"][WHALE]),
        "spam_reaped": len(spammed["by_ns"][SPAM]),
        "small_identical": small_identical,
        "whale_share_held": whale_share_held,
        "gauges_reconcile": (
            honest["gauges_reconcile"] and spammed["gauges_reconcile"]
        ),
    }
    out["ok"] = (
        out["spam_throttled"] >= 80  # ~10x over a 10-token burst
        and out["honest_throttled"] == 0
        and small_identical
        and whale_share_held
        and out["gauges_reconcile"]
        and out["small_reaped"] > 0
    )
    return out


def seam_table_lines(prefixes: tuple[str, ...]) -> list[str]:
    """Exposition lines for the given metric families, straight off the
    registry (the soak's summary-table reader)."""
    from celestia_app_tpu_torch.trace.metrics import registry

    return [
        line for line in registry().render().splitlines()
        if line.startswith(prefixes) and not line.startswith("#")
    ]


def seam_table() -> str:
    """The per-seam injection/recovery counts, straight off the registry."""
    lines = seam_table_lines(("celestia_chaos_injections_total",
                              "celestia_recoveries_total"))
    return "\n".join(lines) or "(no injections fired)"


def _detection_cell(det: dict | None) -> str:
    if det is None:
        return f"{'-':<16} {'-':>6} {'-':>10}"
    blocks = det.get("blocks")
    wall = det.get("wall_ms")
    return (f"{det.get('by') or '-':<16} "
            f"{blocks if blocks is not None else '-':>6} "
            f"{wall if wall is not None else '-':>10}")


def detection_table(rows: list[tuple[str, dict | None]]) -> str:
    """The per-drill time-to-detection summary: which signal noticed the
    injected fault first (SLO page / flight trigger), after how many
    blocks, and after how many wall-ms."""
    out = [f"{'drill':<22} {'detected by':<16} {'blocks':>6} {'wall_ms':>10}"]
    for name, det in rows:
        out.append(f"{name:<22} {_detection_cell(det)}")
    return "\n".join(out)


def write_adv_round(path: str, wd: dict, adv: dict, wall_s: float,
                    heal: dict | None = None,
                    quorum: dict | None = None, device=None) -> None:
    """The checked-in ADV_rNN.json shape (bench_trend gates it): the
    measured detection-probability table, the repair-to-recovery
    latency, the always-detected verdicts for the tampering adversaries,
    and — schema adv-v2 — the healing drill's detect-to-restored-service
    legs (single node + quorum), whose invariants bench_trend hard-fails
    and whose total_ms gates lower-better under the same-platform rule.
    `platform` names the card and its power limit (or "cpu")."""
    import json

    platform = platform_label(device)
    m = re.search(r"ADV_r(\d+)\.json$", os.path.basename(path))
    rec = {
        "n": int(m.group(1)) if m else 1,
        "schema": "adv-v2" if heal is not None else "adv-v1",
        "platform": platform,
        "k": wd["k"],
        "trials": wd["trials"],
        "sample_counts": wd["sample_counts"],
        "detection": wd["detection"],
        "repair": wd["repair"],
        "honest_identical": wd["honest_identical"],
        "all_monotone": wd["all_monotone"],
        "adversaries_detected": {
            "malform": adv["malform"]["ok"],
            "wrong_root": adv["wrong_root"]["ok"],
        },
        "wall_s": round(wall_s, 1),
    }
    if heal is not None:
        rec["heal"] = {
            "single": {
                "k": heal["k"],
                "withhold_frac": heal["withhold_frac"],
                "detect_ms": heal["detect"]["ms"],
                "detect_samples": heal["detect"]["samples"],
                "phases_ms": heal["heal"].get("phases_ms"),
                "heal_total_ms": heal["heal"].get("total_ms"),
                "restored_ms": heal["restored_ms"],
                "healed": heal["heal"].get("outcome") == "healed",
                "served_after_heal": heal["served_after_heal"],
                "root_identical": heal["root_identical"],
                "tampered_never_served": heal["tampered_never_served"],
                "quarantine_outcome": heal["quarantine"].get("outcome"),
            },
        }
        if quorum is not None:
            rec["heal"]["quorum"] = {
                "nodes": quorum["nodes"],
                "k": quorum["k"],
                "withhold_frac": quorum["withhold_frac"],
                "hold_p": quorum["hold_p"],
                "union_coverage": quorum["union_coverage"],
                "detect_ms": [d["ms"] for d in quorum["detections"]],
                "total_ms": quorum["total_ms"],
                "healed": quorum["healed_nodes"] == quorum["nodes"],
                "served_after_heal": quorum["served_after_heal"],
                "root_identical": quorum["root_identical"],
            }
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=20)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--spec", default=DEFAULT_SPEC)
    ap.add_argument("--adv-out", metavar="ADV_rNN.json",
                    help="write the withholding drill's detection-"
                         "probability round record here")
    ap.add_argument("--adv-trials", type=int, default=200,
                    help="withholding drill clients per fraction")
    add_device_argument(ap)
    ap.add_argument("--logical-shards", type=int, default=0, metavar="N",
                    help="run the shard-fault and extend-shard drills over N "
                         "logical shards of the one device (a machine with "
                         "one card); default: the real devices")
    ap.add_argument("--summary-out", metavar="PATH",
                    help="write every drill's result, and the device soak's "
                         "chaos-on roots, here as JSON")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with process_state():
        return _main(args, device)


def _main(args, device) -> int:
    import json

    flight_dir = _arm_flight_recorder()
    print(f"chaos_soak: spec={args.spec!r} flight_dir={flight_dir}",
          flush=True)
    failures = []
    results: dict = {}
    soak_roots: dict = {}
    def sharding():
        return (logical_shards(args.logical_shards, device)
                if args.logical_shards else contextlib.nullcontext())

    dev = run_device_soak(args.blocks, args.k, args.spec, device=device,
                          roots_out=soak_roots)
    results["device_soak"] = dev
    print(f"device soak: {dev['blocks']} blocks @ k={dev['k']} -> "
          f"roots_identical={dev['roots_identical']} "
          f"final_mode={dev['final_mode']} degraded={dev['degraded']}",
          flush=True)
    if not dev["roots_identical"]:
        failures.append(f"device soak diverged: {dev['mismatched_tags']}")

    wal = run_wal_tear_drill(args.spec, device=device)
    results["wal_tear"] = wal
    print(f"WAL tear drill: signed={wal['signed']} "
          f"torn_on_disk={wal['torn_on_disk']} "
          f"salvaged_bytes={wal['salvaged_bytes']} "
          f"conflicts_refused={wal['conflicts_refused']} "
          f"idempotent_resign_ok={wal['idempotent_resign_ok']}", flush=True)
    if not wal["ok"]:
        failures.append(f"WAL drill failed: {wal}")

    smp = run_sampling_drill(k=min(args.k, 8), device=device)
    results["sampling"] = smp
    print(f"sampling drill: {smp['samples']} DAS samples @ k={smp['k']} -> "
          f"bit_identical={smp['bit_identical']} "
          f"all_verify={smp['all_verify']} "
          f"injections={smp['injections']:.0f} "
          f"retried_on_device={smp['retries']:.0f} "
          f"device_faults={smp['device_faults']}", flush=True)
    if not smp["ok"]:
        failures.append(f"sampling drill failed: {smp}")

    with sharding():
        shd = run_shard_fault_drill(k=min(args.k, 8), device=device)
    results["shard_fault"] = shd
    single, fault = shd["legs"]["single_device"], shd["legs"]["device_fault"]
    print(f"shard-fault drill: {shd['samples']} DAS samples @ k={shd['k']} "
          f"shards={shd['shards']} -> single_device: "
          f"identical={single['bit_identical']} "
          f"recoveries={single['recoveries']:.0f}; device_fault: "
          f"{fault['device_faults']}/{fault['batches']} batches "
          f"retried={fault['recoveries']:.0f}", flush=True)
    if not shd["ok"]:
        failures.append(f"shard-fault drill failed: {shd}")

    with sharding():
        esd = run_extend_shard_drill(k=min(args.k, 8), device=device)
    results["extend_shard"] = esd
    print(f"extend-shard drill: k={esd['k']} shards={esd['shards']} -> "
          f"sharded_identical={esd['sharded_identical']} "
          f"eds_device_shards={esd['eds_device_shards']} "
          f"fault walked_to={esd['walked_to']} "
          f"identical={esd['fault_identical']} "
          f"recoveries={esd['recoveries']:.0f}", flush=True)
    if not esd["ok"]:
        failures.append(f"extend-shard drill failed: {esd}")

    spc = run_speculation_drill(k=min(args.k, 8),
                                blocks=min(args.blocks, 6), device=device)
    results["speculation"] = spc
    print(f"speculation drill: {spc['blocks']} blocks @ k={spc['k']} -> "
          f"roots_identical={spc['roots_identical']} hits={spc['hits']:.0f} "
          f"discards={spc['discards']:.0f}", flush=True)
    if not spc["ok"]:
        failures.append(f"speculation drill failed: {spc}")

    bat = run_batched_fault_drill(k=min(args.k, 8),
                                  blocks=min(args.blocks, 6), device=device)
    results["batched_fault"] = bat
    print(f"batched-fault drill: {bat['blocks']} blocks @ k={bat['k']} "
          f"batch={bat['batch']} -> roots_identical={bat['roots_identical']} "
          f"unbatched_falls={bat['unbatched_falls']:.0f} "
          f"final_mode={bat['final_mode']}", flush=True)
    if not bat["ok"]:
        failures.append(f"batched-fault drill failed: {bat}")

    att = run_attestation_drill(k=min(args.k, 8), device=device)
    results["attestation"] = att
    print(f"attestation drill: {att['samples']} samples @ k={att['k']} "
          f"({att['attest_bytes']} attest bytes) -> "
          f"bytes_identical={att['bytes_identical']} "
          f"verdicts_identical={att['verdicts_identical']} "
          f"rejects={att['rejects']} "
          f"retried={att['retried']:.0f} "
          f"persistent_device_fault={att['persistent_device_fault']} "
          f"tampered_refused={att['tampered_refused']}", flush=True)
    if not att["ok"]:
        failures.append(f"attestation drill failed: {att}")

    qd = run_qos_drill(device=device)
    results["qos"] = qd
    print(f"QoS drill: spam_throttled={qd['spam_throttled']} "
          f"honest_throttled={qd['honest_throttled']} "
          f"small_reaped={qd['small_reaped']} "
          f"(identical={qd['small_identical']}) "
          f"whale {qd['whale_reaped_honest']}->{qd['whale_reaped_spam']} "
          f"gauges_reconcile={qd['gauges_reconcile']}", flush=True)
    if not qd["ok"]:
        failures.append(f"QoS drill failed: {qd}")

    t_adv0 = time.monotonic()
    wd = run_withholding_drill(k=min(args.k, 8), trials=args.adv_trials,
                               device=device)
    results["withholding"] = wd
    print(f"withholding drill: {wd['trials']} clients x "
          f"{max(wd['sample_counts'])} samples @ k={wd['k']} -> "
          f"monotone={wd['all_monotone']} "
          f"honest_identical={wd['honest_identical']} "
          f"repair_recovered={wd['repair']['recovered']} "
          f"(detect {wd['repair']['detect_ms']} ms + repair "
          f"{wd['repair']['repair_ms']} ms)", flush=True)
    for curve in wd["detection"]:
        print(f"  withhold_frac={curve['withhold_frac']}: "
              f"{curve['p_detect']}", flush=True)
    if not wd["ok"]:
        failures.append(f"withholding drill failed: {wd}")

    adv = run_adversary_detection_drill(k=min(args.k, 8), device=device)
    results["adversary"] = adv
    print(f"adversary drill: malform detected={adv['malform']['detected']}/"
          f"{adv['malform']['corrupted_shares']} "
          f"served_invalid={adv['malform']['served_invalid']} "
          f"repair_detected={adv['malform']['repair_detected']}; "
          f"wrong_root detected={adv['wrong_root']['samples_detected']}/"
          f"{adv['wrong_root']['samples_probed']} "
          f"repair_detected={adv['wrong_root']['repair_detected']} "
          f"flight_dumps={adv['flight_dumps']}", flush=True)
    if not adv["ok"]:
        failures.append(f"adversary drill failed: {adv}")

    hd = run_healing_drill(k=min(args.k, 8), device=device)
    results["healing"] = hd
    print(f"healing drill: detect {hd['detect']['samples']} samples / "
          f"{hd['detect']['ms']} ms -> heal "
          f"{hd['heal'].get('total_ms')} ms "
          f"(phases {hd['heal'].get('phases_ms')}) -> restored "
          f"{hd['restored_ms']} ms; served_after_heal="
          f"{hd['served_after_heal']} root_identical={hd['root_identical']} "
          f"tampered_never_served={hd['tampered_never_served']} "
          f"quarantine={hd['quarantine']['outcome']}", flush=True)
    if not hd["ok"]:
        failures.append(f"healing drill failed: {hd}")

    qd = run_quorum_heal_drill(nodes=3, k=min(args.k, 8), device=device)
    results["quorum_heal"] = qd
    print(f"quorum heal drill: {qd['nodes']} nodes @ k={qd['k']} "
          f"union={qd['union_coverage']} -> healed_nodes="
          f"{qd['healed_nodes']}/{qd['nodes']} "
          f"detect_ms={[d['ms'] for d in qd['detections']]} "
          f"total={qd['total_ms']} ms served={qd['served_after_heal']} "
          f"roots_identical={qd['root_identical']} "
          f"bundles={qd['heal_bundles']}", flush=True)
    if not qd["ok"]:
        failures.append(f"quorum heal drill failed: {qd}")

    if args.adv_out:
        write_adv_round(args.adv_out, wd, adv, time.monotonic() - t_adv0,
                        heal=hd, quorum=qd, device=device)
        print(f"adversary round record -> {args.adv_out}", flush=True)

    gos = run_gossip_drill(args.spec, device=device)
    results["gossip"] = gos
    print(f"gossip drill: {gos['sent_unique']} unique msgs converged in "
          f"{gos['rounds']} flood rounds -> {gos['deliveries']} deliveries, "
          f"{gos['unique_delivered']} unique after dedup "
          f"(converged={gos['converged']})", flush=True)
    if not gos["ok"]:
        failures.append(f"gossip drill failed: {gos}")

    brk_epi = run_breaker_drill(k=min(args.k, 8), base_env="epi",
                                device=device)
    results["breaker_epi"] = brk_epi
    print(f"breaker drill (epi seat): mode_after={brk_epi['mode_after']} "
          f"health={brk_epi['health_status']} "
          f"roots_identical={brk_epi['roots_identical']} "
          f"paged={brk_epi['paged']} "
          f"detection={brk_epi['detection_blocks']} blocks / "
          f"{brk_epi['detection_wall_ms']} ms", flush=True)
    if not brk_epi["ok"]:
        failures.append(f"breaker drill (epi seat) failed: {brk_epi}")

    brk = run_breaker_drill(k=min(args.k, 8), device=device)
    results["breaker"] = brk
    print(f"breaker drill: mode_after={brk['mode_after']} "
          f"health={brk['health_status']} {brk['health_degraded']} "
          f"roots_identical={brk['roots_identical']} "
          f"paged={brk['paged']} "
          f"detection={brk['detection_blocks']} blocks / "
          f"{brk['detection_wall_ms']} ms flight={brk['flight_bundle']}",
          flush=True)
    if not brk["ok"]:
        failures.append(f"breaker drill failed: {brk}")

    print("\nper-seam injection/recovery counts:")
    print(seam_table(), flush=True)

    print("\ntime-to-detection per drill:")
    print(detection_table([
        ("device soak", dev.get("detection")),
        ("WAL tear", wal.get("detection")),
        ("sampling", smp.get("detection")),  # healed by retries on the card
        ("extend shard", esd.get("detection")),  # healed by the ladder
        ("speculation", spc.get("detection")),  # discards heal silently
        ("batched fault", bat.get("detection")),
        ("withholding", wd.get("detection_signal")),
        ("adversary", adv.get("detection")),
        ("healing", hd.get("detection")),
        ("quorum heal", qd.get("detection")),
        ("gossip", None),  # healed by redundancy: no anomaly to page on
        ("breaker (epi seat)", brk_epi.get("detection")),
        ("breaker (fused)", brk.get("detection")),
    ]), flush=True)
    flight_lines = seam_table_lines((
        "celestia_flight_dumps_total",
        "celestia_flight_dumps_suppressed_total",
        "celestia_slo_violations_total",
    ))
    if flight_lines:
        print("\npages + flight dumps:")
        print("\n".join(flight_lines), flush=True)

    if args.summary_out:
        with open(args.summary_out, "w") as f:
            json.dump({"device": str(device), "drills": results,
                       "soak_roots": {str(t): r.hex()
                                      for t, r in soak_roots.items()}},
                      f, indent=1, default=str)
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print("\nchaos_soak: OK — every drill held correctness under failure")
    return 0


if __name__ == "__main__":
    sys.exit(main())
