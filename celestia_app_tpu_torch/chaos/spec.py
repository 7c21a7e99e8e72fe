"""$CELESTIA_CHAOS: seeded, deterministic fault injection.

Data-availability systems are designed to survive adversarial and faulty
conditions (ACeD; Polar Coded Merkle Tree) — but a design survives only
what its code actually exercises.  This module turns a one-line spec into
an injection registry over NAMED SEAMS, the points where this node talks
to something that can fail:

    device.dispatch   the extend+DAH program dispatch (da/eds, BlockPipeline)
    device.upload     the host->device share transfer (BlockPipeline feeder)
    gossip.send       one consensus message to one peer (rpc/gossip)
    wal.append        one consensus WAL record append+fsync (consensus/wal)
    rpc.handle        one JSON-RPC request (rpc/server)
    mempool.insert    one tx admission (mempool; fires PER SHARD — each
                      namespace shard draws from its own seeded RNG
                      stream, so the injection set a shard sees depends
                      only on the spec and that shard's admission
                      ordinals, never on how admissions interleave
                      across shards/threads)
    proof.serve       one batched DAS proof dispatch (serve/sampler)
    proof.verify      one batched proof VERIFICATION dispatch
                      (serve/verify) — the read side's verify twin

Spec grammar — comma-separated `key=value` pairs, e.g.

    CELESTIA_CHAOS="seed=7,dispatch_fail=0.05,upload_stall_ms=200,\
gossip_drop=0.1,wal_torn_tail=1,rpc_slow_ms=100"

    seed=<int>            per-seam RNG seed (default 0)
    dispatch_fail=<p>     device.dispatch raises (panel/fused lowerings
                          only, so the degradation ladder has somewhere
                          to go; dispatch_fail_all=1 widens it to every
                          rung)
    dispatch_stall_ms=<ms> [dispatch_stall=<p>, default 1.0 when ms set]
    upload_fail=<p>       device.upload raises
    upload_stall_ms=<ms>  [upload_stall=<p>]
    gossip_drop=<p>       message silently lost after "send"
    gossip_dup=<p>        message delivered twice (dedup must absorb it)
    gossip_delay_ms=<ms>  [gossip_reorder=<p>] delayed delivery, so later
                          messages overtake it (reordering)
    wal_torn_tail=<n>     the first n WAL appends leave a torn partial
                          record at the tail (crash mid-write)
    rpc_slow_ms=<ms>      [rpc_slow=<p>] request handling stalls
    rpc_fail=<p>          request fails with an injected server error
    mempool_drop=<p>      admission transiently rejects
    mempool_slow_ms=<ms>  [mempool_slow=<p>]
    proof_fail=<p>        batched proof dispatch raises (host fallback
                          must answer bit-identically)
    proof_slow_ms=<ms>    [proof_slow=<p>] proof dispatch stalls
    verify_fail=<p>       batched proof VERIFICATION raises (serve/verify
                          must fall back to the per-proof host verify
                          with an identical accept/reject vector)
    shard_fail=<p>        SHARDED forest gather raises (serve/shard):
                          the gather degrades to the single-device
                          batched path, then — compounded with
                          proof_fail — to the host rung, every rung
                          bit-identical
    extend_shard_fail=<p> SHARDED extend+DAH dispatch raises mid-
                          collective (kernels/panel_sharded): the
                          ladder walks sharded_panel -> panel (the
                          single-device runner) with roots unchanged

Protocol ADVERSARIES (chaos/adversary.py — attack model, not fault
model; deterministic per (seed, height) rather than per call ordinal):

    withhold_frac=<f>     withholding proposer: hide a random fraction f
                          of each height's EDS shares from the serve path
                          (honest root committed; a DAS sample hitting a
                          withheld share is the detection signal)
    malform_shares=<n>    corrupt n served shares' bytes post-commit
                          (sampler verification must detect)
    wrong_root=1          served DAH data root does not match the square
                          (sampler verification / repair RootMismatch)

Determinism: every seam draws from its OWN `random.Random` seeded by
(seed, seam name), so the injection sequence a seam sees depends only on
the spec and that seam's call ordinals — never on how calls from
different seams interleave across threads.  The same spec over the same
workload injects the same faults; scripts/chaos_soak.py leans on this to
assert bit-identical DAH roots under failure.

Every fired fault ticks `celestia_chaos_injections_total{seam}` and
writes a `chaos_injection` trace row, so a soak can print per-seam
injection counts and a test can assert a seam actually fired.

The port's copy of celestia_app_tpu/chaos/spec.py, whole: the same spec
and seed give the same decisions at every seam.  One difference: the
protocol adversary (celestia_app_tpu/chaos/adversary.py) acts on the serve
API, which the port does not have yet, so `adversary()` raises
NotImplementedError for a spec that sets an adversary key instead of
running an honest serve path under it (ROADMAP, queue 1).
"""

from __future__ import annotations

import random
import threading
import time


class ChaosInjected(RuntimeError):
    """An injected fault (never raised unless chaos is configured)."""

    def __init__(self, seam: str, fault: str):
        super().__init__(f"chaos: injected {fault} at {seam}")
        self.seam = seam
        self.fault = fault


SEAMS = (
    "device.dispatch",
    "device.upload",
    "gossip.send",
    "wal.append",
    "rpc.handle",
    "mempool.insert",
    "proof.serve",
    "proof.verify",
    "proof.shard",
    "device.extend_shard",
)

_KNOWN_KEYS = {
    "seed",
    "dispatch_fail", "dispatch_fail_all", "dispatch_stall_ms",
    "dispatch_stall",
    "upload_fail", "upload_stall_ms", "upload_stall",
    "gossip_drop", "gossip_dup", "gossip_delay_ms", "gossip_reorder",
    "wal_torn_tail",
    "rpc_slow_ms", "rpc_slow", "rpc_fail",
    "mempool_drop", "mempool_slow_ms", "mempool_slow",
    "proof_fail", "proof_slow_ms", "proof_slow",
    "verify_fail",
    "shard_fail",
    "extend_shard_fail",
    "withhold_frac", "malform_shares", "wrong_root",
}


def validate_params(params: dict) -> dict[str, float]:
    """Reject unknown fault keys: a chaos run with a typo'd fault
    silently testing nothing is worse than no run at all.  Applied to
    BOTH activation paths (string spec and programmatic dict)."""
    unknown = set(params) - _KNOWN_KEYS
    if unknown:
        raise ValueError(
            f"chaos spec: unknown keys {sorted(unknown)!r} "
            f"(known: {sorted(_KNOWN_KEYS)!r})"
        )
    return {k: float(v) for k, v in params.items()}


def parse_spec(raw: str) -> dict[str, float]:
    """`"k=v,k=v"` -> {key: float}.  Unknown keys and malformed pairs
    raise ValueError (see validate_params)."""
    out: dict[str, float] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        key, eq, val = part.partition("=")
        key = key.strip()
        if not eq or key not in _KNOWN_KEYS:
            raise ValueError(f"chaos spec: unknown entry {part!r}")
        try:
            out[key] = float(val.strip())
        except ValueError:
            raise ValueError(f"chaos spec: bad value in {part!r}") from None
    return out


class ChaosInjector:
    """The live injection registry for one parsed spec.

    Thread-safe: each seam's RNG and ordinal counter sit behind one lock
    (seam decisions are a few float draws — contention is irrelevant next
    to the faults being injected)."""

    def __init__(self, params: dict[str, float], raw: str = ""):
        self.params = dict(params)
        self.raw = raw
        self.seed = int(self.params.get("seed", 0))
        self._lock = threading.Lock()
        self._rngs = {
            seam: random.Random(f"celestia-chaos:{self.seed}:{seam}")
            for seam in SEAMS
        }
        # Per-SHARD streams of the sharded seams (today: mempool.insert),
        # created lazily per shard index; keyed like the adversary's
        # per-height streams so each shard's injection sequence is a pure
        # function of (seed, seam, shard, ordinal).
        self._shard_rngs: dict[tuple[str, int], random.Random] = {}
        self._torn_remaining = int(self.params.get("wal_torn_tail", 0))
        # Lazily-built protocol adversary (chaos/adversary.py); None when
        # no adversary key is set, so honest paths pay one attr read.
        self._adversary = None
        self._adversary_built = False

    def adversary(self):
        """The spec's protocol adversary, or None when every adversary
        key is absent/zero (the honest fast path)."""
        with self._lock:
            if not self._adversary_built:
                if (self._p("withhold_frac") > 0 or int(self._p("malform_shares")) > 0
                        or self._p("wrong_root") > 0):
                    raise NotImplementedError(
                        "chaos: the protocol adversary (withhold_frac, malform_shares, "
                        "wrong_root) acts on the serve API, which the port does not have yet"
                    )
                self._adversary_built = True
            return self._adversary

    # --- plumbing -----------------------------------------------------------
    def _p(self, key: str) -> float:
        return float(self.params.get(key, 0.0))

    def _fire(self, seam: str, key: str, default: float = 0.0,
              shard: int | None = None) -> bool:
        p = float(self.params.get(key, default))
        if p <= 0.0:
            return False
        with self._lock:
            if shard is None:
                return p >= 1.0 or self._rngs[seam].random() < p
            rng = self._shard_rngs.get((seam, shard))
            if rng is None:
                rng = self._shard_rngs[(seam, shard)] = random.Random(
                    f"celestia-chaos:{self.seed}:{seam}#{shard}"
                )
            return p >= 1.0 or rng.random() < p

    def _count(self, seam: str, fault: str) -> None:
        from celestia_app_tpu_torch.trace.metrics import registry
        from celestia_app_tpu_torch.trace.tracer import traced

        registry().counter(
            "celestia_chaos_injections_total",
            "chaos faults injected, by seam",
        ).inc(seam=seam)
        traced().write("chaos_injection", seam=seam, fault=fault)

    def _stall(self, seam: str, ms_key: str, p_key: str) -> bool:
        ms = self._p(ms_key)
        if ms > 0 and self._fire(seam, p_key, default=1.0):
            self._count(seam, ms_key)
            time.sleep(ms / 1e3)
            return True
        return False

    # --- seams --------------------------------------------------------------
    def device_dispatch(self, mode: str) -> None:
        """Stall and/or fail one extend+DAH dispatch.  `dispatch_fail`
        targets the compiled-program family the ladder can step away
        from — "fused", the leaf-hash-epilogue "fused_epi" rung above
        it, and the panel-streamed "panel" rung above both (whose
        host-driven loop passes this seam once per panel dispatch, so an
        injection lands MID-panel) — unless `dispatch_fail_all` widens
        it to every rung."""
        self._stall("device.dispatch", "dispatch_stall_ms", "dispatch_stall")
        applies = (mode in ("sharded_panel", "panel", "fused", "fused_epi")
                   or self._p("dispatch_fail_all") > 0)
        if applies and self._fire("device.dispatch", "dispatch_fail"):
            self._count("device.dispatch", "dispatch_fail")
            raise ChaosInjected("device.dispatch", "dispatch_fail")

    def device_upload(self) -> None:
        self._stall("device.upload", "upload_stall_ms", "upload_stall")
        if self._fire("device.upload", "upload_fail"):
            self._count("device.upload", "upload_fail")
            raise ChaosInjected("device.upload", "upload_fail")

    def gossip_send(self) -> dict:
        """Per-message verdict for one peer send: {} on the happy path,
        else any of drop=True, dup=True, delay_s=<float>."""
        out: dict = {}
        if self._fire("gossip.send", "gossip_drop"):
            self._count("gossip.send", "gossip_drop")
            out["drop"] = True
            return out  # a dropped message is neither duplicated nor late
        if self._fire("gossip.send", "gossip_dup"):
            self._count("gossip.send", "gossip_dup")
            out["dup"] = True
        delay_ms = self._p("gossip_delay_ms")
        if delay_ms > 0 and self._fire("gossip.send", "gossip_reorder",
                                       default=1.0):
            self._count("gossip.send", "gossip_delay_ms")
            out["delay_s"] = delay_ms / 1e3
        return out

    def wal_torn_tail(self) -> bytes | None:
        """The partial record to leave at the WAL tail after this append
        (crash mid-write of the NEXT record), for the first
        `wal_torn_tail` appends; None afterwards."""
        with self._lock:
            if self._torn_remaining <= 0:
                return None
            self._torn_remaining -= 1
        self._count("wal.append", "wal_torn_tail")
        # A prefix of a plausible record, no terminating newline: exactly
        # the bytes a crash between write() and completion leaves behind.
        return b'{"k":"vote","h":9999999,"r":0,"t"'

    def rpc_handle(self) -> None:
        self._stall("rpc.handle", "rpc_slow_ms", "rpc_slow")
        if self._fire("rpc.handle", "rpc_fail"):
            self._count("rpc.handle", "rpc_fail")
            raise ChaosInjected("rpc.handle", "rpc_fail")

    def mempool_insert(self, shard: int | None = None) -> bool:
        """True when this admission should be transiently rejected.
        `shard` selects that namespace shard's OWN seeded RNG stream
        (None keeps the legacy per-seam stream), so a sharded pool's
        injection sets are interleaving-independent across shards."""
        self._stall("mempool.insert", "mempool_slow_ms", "mempool_slow")
        if self._fire("mempool.insert", "mempool_drop", shard=shard):
            self._count("mempool.insert", "mempool_drop")
            return True
        return False

    def proof_serve(self) -> None:
        """Stall and/or fail one BATCHED proof dispatch (serve/sampler):
        the sampler must absorb the failure by answering the batch on the
        pure-host path with bit-identical proof bytes — the serve plane's
        analog of the extend pipeline's fused->staged seam."""
        self._stall("proof.serve", "proof_slow_ms", "proof_slow")
        if self._fire("proof.serve", "proof_fail"):
            self._count("proof.serve", "proof_fail")
            raise ChaosInjected("proof.serve", "proof_fail")

    def proof_verify(self) -> None:
        """Fail one BATCHED proof-verification dispatch (serve/verify):
        the verifier must absorb the failure by re-deciding the whole
        queue on the per-proof host path with an IDENTICAL accept/reject
        vector — the read side's verify twin of the proof.serve seam."""
        if self._fire("proof.verify", "verify_fail"):
            self._count("proof.verify", "verify_fail")
            raise ChaosInjected("proof.verify", "verify_fail")

    def proof_shard(self) -> None:
        """Fail one SHARDED forest gather (serve/shard): the gather must
        degrade to the single-device batched path — and, when proof_fail
        compounds the injection, on down to the host rung — with
        bit-identical proof bytes at every rung (the read-side ladder's
        top seam)."""
        if self._fire("proof.shard", "shard_fail"):
            self._count("proof.shard", "shard_fail")
            raise ChaosInjected("proof.shard", "shard_fail")

    def extend_shard(self) -> None:
        """Fail one SHARDED extend+DAH dispatch (kernels/panel_sharded:
        the seam fires between the host-driven collective programs, so
        an injection lands MID-collective-schedule).  guarded_dispatch
        must walk the ladder sharded_panel -> panel — the single-device
        runner — with bit-identical roots (the write-side ladder's top
        seam)."""
        if self._fire("device.extend_shard", "extend_shard_fail"):
            self._count("device.extend_shard", "extend_shard_fail")
            raise ChaosInjected("device.extend_shard", "extend_shard_fail")
