"""Sharded prioritized mempool (celestia-core mempool v1 semantics,
namespace-sharded admission, weighted-fair reaping, per-tenant QoS).

Parity with the reference node defaults (app/default_overrides.go:258-284):
version "v1" prioritized mempool, TTL of 5 blocks, MaxTxBytes cap sized to
the biggest square (128^2 x 478).  Admission runs CheckTx first (the app
sets the priority = gas price x 1e6, app/ante/fee_checker.go:17); reaping
returns txs under a byte budget, the order PrepareProposal receives them.

SHARDING ($CELESTIA_MEMPOOL_SHARDS, default 8; `0`/`global` pins the
frozen single-lock baseline): entries live in per-namespace shards —
namespace -> shard by stable hash, normal txs under the reserved `tx`
bucket — each behind its own lock, and the expensive per-admission work
(the sha256 tx key, the BlobTx namespace parse) runs OUTSIDE any lock,
so concurrent BroadcastTx admission stops serializing the way the old
one-big-lock path did (the JAX package's BENCH_MODE=mempool measures
the A/B).  The cross-shard paths — pool-pressure priority eviction, reap,
update — take the shard locks in index order, so their DECISIONS are
identical to the global baseline's: only the locking is sharded, never the
semantics.

WEIGHTED-FAIR REAPING: when the byte budget BINDS (resident bytes exceed
the reap budget) and the pool is sharded, reap arbitrates the contended
budget by deficit round-robin across namespaces (quantum
$CELESTIA_MEMPOOL_QUANTUM bytes, default 64 KiB): each tenant's queue
stays in (priority desc, FIFO) order internally — priority is preserved
WITHIN a tenant — but tenants take turns filling the square, so one
whale namespace can no longer crowd a small tenant out of N consecutive
squares (the starvation test's invariant).  A tx larger than the quantum
accrues deficit over multiple rounds (classic DRR); empty tenants are
skipped without accruing; a tx that cannot fit the remaining budget is
skipped exactly like the baseline's skip-semantics.  When the budget
does NOT bind (every resident tx fits — the common case) the reap is
byte-identical to the frozen pure-priority baseline, as is every reap
under `$CELESTIA_MEMPOOL_SHARDS=0`.

QOS ADMISSION CONTROL ($CELESTIA_QOS, qos.py): per-tenant token-bucket
rate limits (txs/sec, bytes/sec) and resident byte quotas are enforced
at insert — the one admission seam all three RPC planes, the gossip
flood, and direct embedders share — raising QosThrottled (429 /
RESOURCE_EXHAUSTED, byte-identical payload on every plane).

Observability: every entry stores the submitting request's TraceContext
(trace/context.py), so the insert span, the reap row, and the block built
from the reap all share the submission's trace_id.  Pool health lives on
the `celestia_mempool_txs` / `celestia_mempool_size_bytes` gauges (plus
`celestia_mempool_shard_txs{shard}` on the sharded pool),
`celestia_mempool_evictions_total{reason=priority|ttl|recheck}`, and the
lifecycle histogram's `mempool_wait` / `total` phases.  The per-tenant
`celestia_mempool_namespace_{txs,size_bytes}` depth gauges SUM EXACTLY
across shards on every insert/reap/ttl/recheck/committed-drop path (the
PR 3 reconciliation invariant, re-pinned shard-aware); namespace labels
go through the top-N cardinality cap (trace/square_journal.py) once, at
admission.

The port's copy of celestia_app_tpu/mempool.py: the same admissions,
evictions, reaps (pure priority and DRR), gauges and chaos seam
(`chaos.mempool_insert`, which drops an admission per shard under
`$CELESTIA_CHAOS`, each shard on its own seeded stream) on the same input.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import sys
import threading
import time
import weakref
import zlib
from dataclasses import dataclass, field

DEFAULT_TTL_NUM_BLOCKS = 5
DEFAULT_MAX_TX_BYTES = 128 * 128 * 478  # ~7.8 MB
DEFAULT_MAX_POOL_BYTES = 4 * DEFAULT_MAX_TX_BYTES
#: Default lock-stripe count of the sharded pool.
DEFAULT_SHARDS = 8
#: Default DRR quantum (bytes added to each tenant's deficit per round).
DEFAULT_REAP_QUANTUM = 64 * 1024

_WARNED: set[str] = set()


def _warn_once(key: str, msg: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        print(msg, file=sys.stderr)


def mempool_shards() -> int:
    """$CELESTIA_MEMPOOL_SHARDS: lock-stripe count of the sharded pool;
    `0` or `global` pins the frozen single-lock baseline rung (the
    measurable pre-PR behavior).  Malformed values warn loudly and fall
    back to the default — silently serving the baseline would disable
    both the concurrency win and the fairness arbitration."""
    raw = (os.environ.get("CELESTIA_MEMPOOL_SHARDS") or "").strip().lower()
    if raw in ("", "auto"):
        return DEFAULT_SHARDS
    if raw in ("0", "global"):
        return 0
    try:
        return max(0, int(raw))
    except ValueError:
        _warn_once(
            "shards",
            f"CELESTIA_MEMPOOL_SHARDS={raw!r} is not an integer or "
            f"'global'; using the default {DEFAULT_SHARDS} shards",
        )
        return DEFAULT_SHARDS


def reap_quantum() -> int:
    """$CELESTIA_MEMPOOL_QUANTUM: DRR bytes-per-tenant-per-round (>= 1)."""
    try:
        return max(
            1, int(os.environ.get("CELESTIA_MEMPOOL_QUANTUM", "")
                   or DEFAULT_REAP_QUANTUM)
        )
    except ValueError:
        return DEFAULT_REAP_QUANTUM


@dataclass
class _Entry:
    tx: bytes
    priority: int
    height: int  # admission height (for TTL)
    seq: int  # FIFO tiebreak
    ctx: object | None = None  # submitting request's TraceContext
    t_ins: float = field(default=0.0)  # perf_counter at admission
    reaped: bool = False  # mempool_wait observed (first reap only)
    # Submitting namespace label, already CAPPED at admission ("tx" for
    # normal txs, "other" past the top-N admission cap): capping once
    # here keeps every later gauge/counter refresh a plain dict walk.
    ns: str = "tx"

    def e2e_namespace(self) -> str | None:
        """The namespace the entry's e2e observations are attributed to
        (None for normal txs — they keep the unlabeled phase series)."""
        return self.ns if self.ns != "tx" else None


def _pools_owned_bytes() -> int:
    """Tx bytes resident across every live pool's shards — the mempool's
    contribution to the /device memory-ownership ledger (host RAM on
    every backend, but it is this process's biggest non-array holder)."""
    return sum(
        s.nbytes for pool in list(_ALL_POOLS) for s in pool._shards
    )


_ALL_POOLS: "weakref.WeakSet[PriorityMempool]" = weakref.WeakSet()

from celestia_app_tpu_torch.trace.device_ledger import (  # noqa: E402
    register_owner as _register_owner,
)

_register_owner("mempool_shards", _pools_owned_bytes)


class _Shard:
    """One namespace shard: its own lock, entry map, byte + per-tenant
    depth accounting.  All mutation happens under `lock`; cross-shard
    operations acquire shard locks in index order (deadlock-free)."""

    __slots__ = ("lock", "entries", "nbytes", "ns_depth")

    def __init__(self):
        self.lock = threading.Lock()
        self.entries: dict[bytes, _Entry] = {}
        self.nbytes = 0
        # CAPPED namespace label -> [txs, bytes] for THIS shard; the
        # exposition gauges sum these across shards (zeroed tenants drop
        # after their aggregate lands on 0), so per-shard and per-process
        # accounting can never drift apart.
        self.ns_depth: dict[str, list[int]] = {}

    def add(self, key: bytes, e: _Entry) -> None:
        self.entries[key] = e
        self.nbytes += len(e.tx)
        agg = self.ns_depth.setdefault(e.ns, [0, 0])
        agg[0] += 1
        agg[1] += len(e.tx)

    def remove(self, key: bytes) -> _Entry | None:
        e = self.entries.pop(key, None)
        if e is not None:
            self.nbytes -= len(e.tx)
            agg = self.ns_depth.get(e.ns)
            if agg is not None:
                agg[0] -= 1
                agg[1] -= len(e.tx)
                if agg[0] <= 0 and agg[1] <= 0:
                    del self.ns_depth[e.ns]
        return e


class PriorityMempool:
    def __init__(
        self,
        ttl_num_blocks: int = DEFAULT_TTL_NUM_BLOCKS,
        max_tx_bytes: int = DEFAULT_MAX_TX_BYTES,
        max_pool_bytes: int = DEFAULT_MAX_POOL_BYTES,
        shards: int | None = None,
    ):
        self.ttl = ttl_num_blocks
        self.max_tx_bytes = max_tx_bytes
        self.max_pool_bytes = max_pool_bytes
        # Shard count pinned at construction (env read once): a live
        # pool's key->shard routing must never move under a mid-process
        # env flip.  0 = the frozen global-lock baseline, which runs the
        # same code over ONE shard whose lock covers the whole admission
        # (key hash + namespace parse included, exactly the old
        # serialization the sharded path exists to break).
        self.shards = mempool_shards() if shards is None else max(0, shards)
        self._shards = [_Shard() for _ in range(max(1, self.shards))]
        # tx key -> shard index (GIL-atomic single-op reads; mutated only
        # under the owning shard's lock): how the key-addressed paths
        # (has_tx / ctx_for / remove_tx / update) find an entry without
        # searching every shard.
        self._key_shard: dict[bytes, int] = {}
        self._seq = itertools.count()
        # Namespace labels currently published on the per-tenant gauges
        # (so a drained tenant lands on 0 exactly once, never a stale
        # positive); own lock — mutated from concurrent insert threads
        # while the full-refresh path iterates and replaces it.
        self._published_ns: set[str] = set()
        self._published_lock = threading.Lock()
        _ALL_POOLS.add(self)

    # --- shard routing -------------------------------------------------------
    def _shard_index(self, ns: str) -> int:
        if self.shards <= 0 or len(self._shards) == 1:
            return 0
        return zlib.crc32(ns.encode()) % len(self._shards)

    def _shard_of_key(self, key: bytes) -> _Shard | None:
        i = self._key_shard.get(key)
        return self._shards[i] if i is not None else None

    class _AllLocks:
        """Acquire every shard lock in index order (the cross-shard
        paths: pool-pressure eviction, reap snapshot, update)."""

        def __init__(self, shards):
            self._shards = shards

        def __enter__(self):
            for s in self._shards:
                s.lock.acquire()
            return self

        def __exit__(self, *exc):
            for s in reversed(self._shards):
                s.lock.release()

    def _all_locks(self) -> "PriorityMempool._AllLocks":
        return self._AllLocks(self._shards)

    def __len__(self) -> int:
        return sum(len(s.entries) for s in self._shards)

    def size_bytes(self) -> int:
        return sum(s.nbytes for s in self._shards)

    def namespace_bytes(self, ns: str) -> int:
        """Resident bytes of one (capped) namespace label across shards
        — the QoS byte-quota input."""
        total = 0
        for s in self._shards:
            agg = s.ns_depth.get(ns)
            if agg is not None:
                total += agg[1]
        return total

    @staticmethod
    def tx_key(tx: bytes) -> bytes:
        return hashlib.sha256(tx).digest()

    def has_tx(self, tx: bytes) -> bool:
        """Is this exact tx resident? (gossip relay dedup)."""
        return self.tx_key(tx) in self._key_shard

    def ctx_for(self, tx: bytes):
        """The TraceContext a resident tx was submitted under, if any —
        how a block adopts the trace of the request that fed it."""
        key = self.tx_key(tx)
        shard = self._shard_of_key(key)
        if shard is None:
            return None
        e = shard.entries.get(key)
        return e.ctx if e is not None else None

    # --- metrics plumbing ---------------------------------------------------
    def _gauges(self):
        """(txs, bytes, ns_txs, ns_bytes, shard_txs) gauge handles,
        cached per pool: the registry is process-global and never
        swapped, and handle lookup per admission is measurable next to a
        small tx's hash."""
        handles = self.__dict__.get("_gauge_handles")
        if handles is None:
            from celestia_app_tpu_torch.trace.metrics import registry

            reg = registry()
            handles = self._gauge_handles = (
                reg.gauge("celestia_mempool_txs", "resident mempool txs"),
                reg.gauge("celestia_mempool_size_bytes",
                          "resident mempool bytes"),
                reg.gauge(
                    "celestia_mempool_namespace_txs",
                    "resident mempool txs per namespace (top-N capped, "
                    "summed across shards)",
                ),
                reg.gauge(
                    "celestia_mempool_namespace_size_bytes",
                    "resident mempool bytes per namespace (top-N capped, "
                    "summed across shards)",
                ),
                reg.gauge(
                    "celestia_mempool_shard_txs",
                    "resident mempool txs per namespace shard "
                    "(bounded by $CELESTIA_MEMPOOL_SHARDS)",
                ),
            )
        return handles

    def _refresh_gauges_for(self, ns: str, shard_idx: int) -> None:
        """The insert fast path's targeted refresh: totals, the touched
        tenant's cross-shard sums, the touched shard — exact (the sums
        are recomputed, never incremented blind) without re-walking every
        tenant per admission."""
        txs_g, bytes_g, ns_txs, ns_bytes, shard_txs = self._gauges()
        txs_g.set(len(self))
        bytes_g.set(self.size_bytes())
        n = b = 0
        for s in self._shards:
            agg = s.ns_depth.get(ns)
            if agg is not None:
                n += agg[0]
                b += agg[1]
        ns_txs.set(n, namespace=ns)
        ns_bytes.set(b, namespace=ns)
        if n:
            with self._published_lock:
                self._published_ns.add(ns)
        if self.shards > 0:
            shard_txs.set(
                len(self._shards[shard_idx].entries), shard=str(shard_idx)
            )

    def _refresh_gauges(self) -> None:
        txs_g, bytes_g, ns_txs, ns_bytes, shard_txs = self._gauges()
        txs_g.set(len(self))
        bytes_g.set(self.size_bytes())
        if self.shards > 0:
            for i, s in enumerate(self._shards):
                shard_txs.set(len(s.entries), shard=str(i))
        # Per-tenant depth, summed EXACTLY across shards (the PR 3
        # reconciliation invariant): keys are capped at admission
        # (distinct raw labels past the cap already share the `other`
        # entry), so this is a plain walk; a tenant whose aggregate hit
        # zero is published once at 0 and then dropped.
        totals: dict[str, list[int]] = {}
        for s in self._shards:
            for lbl, (n, b) in s.ns_depth.items():
                agg = totals.setdefault(lbl, [0, 0])
                agg[0] += n
                agg[1] += b
        for lbl, (n, b) in totals.items():
            ns_txs.set(n, namespace=lbl)
            ns_bytes.set(b, namespace=lbl)
        # Tenants that drained since the last refresh land on 0 (never a
        # stale positive sample).  Under the published-set lock: insert
        # threads add concurrently, and an unsynchronized subtract-and-
        # replace could both blow up mid-iteration and lose a racing add
        # (a tenant that then drained would keep a stale positive).
        with self._published_lock:
            for lbl in self._published_ns - set(totals):
                ns_txs.set(0, namespace=lbl)
                ns_bytes.set(0, namespace=lbl)
            self._published_ns = set(totals)

    def _tick_eviction(self, reason: str, n: int = 1, *,
                       namespace: str = "tx") -> None:
        from celestia_app_tpu_torch.trace.metrics import registry
        from celestia_app_tpu_torch.trace.square_journal import capped_namespace_label

        registry().counter(
            "celestia_mempool_evictions_total",
            "mempool removals that were not block inclusion",
        ).inc(n, reason=reason, namespace=capped_namespace_label(namespace))

    # --- mutation -----------------------------------------------------------
    def insert(self, tx: bytes, priority: int, height: int, ctx=None,
               ns: str | None = None) -> bool:
        """Admit a checked tx; False if duplicate, oversized, or the pool
        is full of higher-priority txs; raises
        qos.QosThrottled when the tenant is over a $CELESTIA_QOS limit.
        `ctx` is the submitting request's TraceContext (defaults to the
        thread's current one); `ns` is the tx's already-resolved
        namespace label, when the caller (the broadcast path) parsed the
        tx anyway."""
        from celestia_app_tpu_torch.trace.context import current_context, trace_span
        from celestia_app_tpu_torch.trace.tracer import trace_enabled

        if ctx is None:
            ctx = current_context()
        if not trace_enabled():
            # Muted-tracing fast path: no span context (new_context draws
            # urandom per span — measurable next to a small tx's hash);
            # the admission semantics are identical.
            return self._insert_refreshing(tx, priority, height, ctx, ns, {})
        with trace_span(
            "mempool_insert", ctx=ctx, layer="mempool",
            tx_bytes=len(tx), height=height,
        ) as sp:
            ok = self._insert_refreshing(tx, priority, height, ctx, ns, sp)
            if "result" not in sp:
                sp["result"] = "inserted" if ok else "rejected"
        return ok

    def _insert_refreshing(self, tx, priority, height, ctx, ns, sp) -> bool:
        """Admission + the matching gauge refresh: targeted (touched
        tenant + shard only) on the fast path, FULL when the admission
        evicted other tenants' residents (their gauges must land on the
        new truth, not stay stale)."""
        try:
            verdict = (
                self._insert_global(tx, priority, height, ctx, ns, sp)
                if self.shards <= 0
                else self._insert_sharded(tx, priority, height, ctx, ns, sp)
            )
        except Exception:
            sp["result"] = "throttled"
            raise
        ok, touched = verdict
        if touched is not None:
            self._refresh_gauges_for(*touched)
        elif ok:
            self._refresh_gauges()
        return ok

    def _insert_global(self, tx, priority, height, ctx, ns, sp):
        """The frozen baseline rung: ONE lock held across the whole
        admission — key hash, namespace parse, QoS, map mutation — which
        is exactly the serialization the pre-shard node paid (and the
        rung the JAX package's BENCH_MODE=mempool measures the sharded path
        against)."""
        from celestia_app_tpu_torch import chaos

        if chaos.mempool_insert(shard=0):
            sp["result"] = "chaos_dropped"
            return False, None
        shard = self._shards[0]
        with shard.lock:
            key, label = self._resolve(tx, ctx, ns)
            # Duplicates and oversize reject BEFORE the QoS gate: a
            # gossip flood re-offering a resident tx is protocol
            # traffic and must not drain the tenant's token budget.
            if len(tx) > self.max_tx_bytes or key in shard.entries:
                return False, None
            self._qos_gate(label, len(tx))
            # An admission under pool pressure may evict OTHER tenants'
            # residents — that path takes the full gauge refresh.
            pressure = self.size_bytes() + len(tx) > self.max_pool_bytes
            ok = self._admit(shard, key, tx, priority, height, ctx, label)
        return ok, ((label, 0) if ok and not pressure else None)

    def _insert_sharded(self, tx, priority, height, ctx, ns, sp):
        """The sharded admission path: the per-tx sha256 + namespace
        parse run OUTSIDE any lock (that work dominates an admission and
        is what the old global lock serialized), then only the owning
        namespace shard's lock is taken.  Pool-pressure evictions — the
        rare cross-shard decision — fall to the all-locks path, where
        the decision logic is the same as the baseline's."""
        from celestia_app_tpu_torch import chaos

        key, label = self._resolve(tx, ctx, ns)
        idx = self._shard_index(label)
        # The chaos seam fires per-shard with its own seeded RNG stream
        # (chaos/spec.py): injection sets stay interleaving-independent
        # even when admissions race across shards.
        if chaos.mempool_insert(shard=idx):
            sp["result"] = "chaos_dropped"
            return False, None
        # Oversize and already-resident rejections BEFORE the QoS gate
        # (the key-map read is GIL-atomic): gossip re-offers of resident
        # txs are protocol traffic and must not drain the tenant's token
        # budget.  A same-tx race past this pre-check is decided by
        # _admit's authoritative under-lock check; the rare loser
        # charges one token — bounded by the race, not by the flood.
        if len(tx) > self.max_tx_bytes or key in self._key_shard:
            return False, None
        self._qos_gate(label, len(tx))
        shard = self._shards[idx]
        if self.size_bytes() + len(tx) > self.max_pool_bytes:
            # Pool pressure: the eviction decision needs the global
            # lowest-priority view, so this path locks every shard (in
            # index order) and decides exactly like the baseline; the
            # caller then refreshes EVERY tenant's gauges (evicted
            # residents belong to other namespaces).
            return self._admit_evicting(idx, key, tx, priority, height,
                                        ctx, label), None
        with shard.lock:
            admitted = self._admit(shard, key, tx, priority, height, ctx,
                                   label, evict=False)
        if admitted is None:
            # Lost a race against concurrent fills: decide under all locks.
            return self._admit_evicting(idx, key, tx, priority, height,
                                        ctx, label), None
        return admitted, ((label, idx) if admitted else None)

    def _resolve(self, tx, ctx, ns) -> tuple[bytes, str]:
        """(tx key, capped namespace label) — the per-admission work the
        sharded path hoists outside every lock."""
        key = self.tx_key(tx)
        if ns is not None:  # caller-resolved raw label still needs the cap
            from celestia_app_tpu_torch.trace.square_journal import (
                capped_namespace_label,
            )

            return key, capped_namespace_label(ns)
        return key, self._namespace_of(tx, ctx)

    def _qos_gate(self, label: str, nbytes: int) -> None:
        """Per-tenant admission control ($CELESTIA_QOS): one cached
        env-string compare when enforcement is off."""
        from celestia_app_tpu_torch import qos

        enf = qos.enforcer()
        if enf is not None:
            enf.admit_tx(label, nbytes, self.namespace_bytes(label))

    def _admit(self, shard: _Shard, key, tx, priority, height, ctx, label,
               evict: bool = True) -> bool | None:
        """Admission under the caller-held shard lock.  With evict=False
        returns None instead of evicting when the pool is over budget
        (the sharded fast path escalates to the all-locks decision)."""
        if len(tx) > self.max_tx_bytes:
            return False
        if key in shard.entries:
            return False
        need = self.size_bytes() + len(tx) - self.max_pool_bytes
        if need > 0:
            if not evict:
                return None
            if not self._evict_locked(need, priority):
                return False  # infeasible: nothing was evicted
        shard.add(key, _Entry(
            tx, priority, height, next(self._seq), ctx,
            time.perf_counter(), ns=label,
        ))
        self._key_shard[key] = self._shards.index(shard)
        return True

    def _admit_evicting(self, idx, key, tx, priority, height, ctx,
                        label) -> bool:
        with self._all_locks():
            return bool(self._admit(
                self._shards[idx], key, tx, priority, height, ctx, label,
                evict=True,
            ))

    def _evict_locked(self, need: int, priority: int) -> bool:
        """Priority eviction under ALL shard locks (single-shard pools
        hold their one lock — same thing).  Feasibility is decided
        BEFORE anything is removed: evicting one-at-a-time and then
        discovering the next victim outranks the newcomer would have
        destroyed valid residents for an insert that admits nothing.
        The victim order is global (priority asc, LIFO tiebreak), so the
        decision is identical at every shard count."""
        victims = sorted(
            (
                (key, e, i)
                for i, s in enumerate(self._shards)
                for key, e in s.entries.items()
                if e.priority < priority
            ),
            key=lambda kv: (kv[1].priority, -kv[1].seq),
        )
        chosen, freed = [], 0
        for kv in victims:
            if freed >= need:
                break
            chosen.append(kv)
            freed += len(kv[1].tx)
        if freed < need:
            return False
        for victim_key, victim, i in chosen:
            self._shards[i].remove(victim_key)
            self._key_shard.pop(victim_key, None)
            self._tick_eviction("priority", namespace=victim.ns)
        return True

    @staticmethod
    def _namespace_of(tx: bytes, ctx) -> str:
        """The entry's CAPPED namespace label: the submit path already
        resolved the raw label into the trace baggage; fall back to
        parsing the tx (gossip relays and direct inserts arrive without
        baggage).  Capped exactly once, here at admission."""
        from celestia_app_tpu_torch.trace.square_journal import (
            capped_namespace_label,
            tx_namespace_label,
        )

        baggage = getattr(ctx, "baggage", None)
        raw = (baggage or {}).get("namespace") or tx_namespace_label(tx)
        return capped_namespace_label(raw) if raw else "tx"

    def _remove_key(self, key: bytes) -> _Entry | None:
        """Remove under the owning shard's lock (key-addressed paths).
        The key->shard mapping is popped INSIDE the lock: popping after
        release could race a same-tx re-insert (gossip re-offer) and
        delete the mapping of the re-inserted LIVE entry, leaving it
        invisible to every key-addressed path until TTL."""
        shard = self._shard_of_key(key)
        if shard is None:
            return None
        with shard.lock:
            e = shard.remove(key)
            if e is not None:
                self._key_shard.pop(key, None)
        return e

    def _snapshot(self) -> list[_Entry]:
        """Every resident entry, snapshotted under the shard locks."""
        with self._all_locks():
            return [e for s in self._shards for e in s.entries.values()]

    def reap(self, max_bytes: int | None = None) -> list[bytes]:
        """Txs under a byte budget, the order PrepareProposal receives.

        Uncontended (everything fits, or the frozen global baseline):
        pure (priority desc, FIFO) order with skip-semantics — byte-
        identical to the pre-shard pool.  Contended AND sharded: deficit
        round-robin across namespaces (module docstring), priority order
        preserved within each tenant.

        Journaled: one `mempool_reap` span per call (count/bytes/skips/
        drr, joined to the first reaped tx's trace), plus one
        `mempool_wait` e2e observation per reaped tx (insert -> reap
        residency).
        """
        from celestia_app_tpu_torch.trace.context import export_span, new_context
        from celestia_app_tpu_torch.trace.spans import observe_e2e
        from celestia_app_tpu_torch.trace.tracer import trace_enabled

        start_unix_ns = time.time_ns()
        t0 = time.perf_counter_ns()
        ordered = sorted(
            self._snapshot(), key=lambda e: (-e.priority, e.seq)
        )
        resident_bytes = sum(len(e.tx) for e in ordered)
        use_drr = (
            self.shards > 0
            and max_bytes is not None
            and resident_bytes > max_bytes
        )
        if use_drr:
            out, reaped_entries, skipped, total = self._drr_reap(
                ordered, max_bytes
            )
        else:
            out, reaped_entries = [], []
            total = skipped = 0
            for e in ordered:
                if max_bytes is not None and total + len(e.tx) > max_bytes:
                    skipped += 1
                    continue
                out.append(e.tx)
                reaped_entries.append(e)
                total += len(e.tx)
        elapsed_ns = time.perf_counter_ns() - t0
        if trace_enabled():
            # The span joins the trace of the first REAPED tx — the same
            # trace the block built from this reap adopts
            # (_block_trace_context), so the reap leg is never orphaned
            # onto a budget-skipped tx's trace.
            first_ctx = next(
                (e.ctx for e in reaped_entries if e.ctx is not None), None
            )
            ctx = first_ctx.child() if first_ctx is not None else new_context()
            export_span(
                "mempool_reap", ctx, start_unix_ns, elapsed_ns,
                {"layer": "mempool", "n_txs": len(out), "reap_bytes": total,
                 "skipped": skipped, "resident": len(ordered),
                 "drr": use_drr,
                 "tenants": len({e.ns for e in ordered})},
                e2e="reap",
            )
        now = time.perf_counter()
        for e in reaped_entries:
            # First reap only: a tx the proposer reaps but drops (filter
            # rejection, square overflow) is reaped again every block
            # until TTL, and re-observing its growing residency would let
            # duplicates dominate the histogram's tail.
            if e.t_ins and not e.reaped:
                observe_e2e("mempool_wait", now - e.t_ins,
                            namespace=e.e2e_namespace())
            e.reaped = True
        return out

    def _drr_reap(self, ordered: list[_Entry], max_bytes: int):
        """Deficit round-robin over per-namespace queues.

        `ordered` is the global (priority desc, FIFO) list, so each
        tenant's queue inherits priority order internally.  Per round
        each non-empty tenant accrues one quantum of deficit and serves
        queue-head txs while the deficit and the remaining global budget
        both allow; a head too big for the remaining BUDGET is skipped
        (popped from this reap's view, like the baseline's skip-and-
        continue); a head too big for the DEFICIT ends the tenant's turn
        and is retried next round with more deficit (classic DRR — this
        is how a tx larger than the quantum still gets served).  Empty
        tenants are skipped and their deficit reset, so idle tenants
        never accrue a burst claim."""
        from collections import deque

        queues: dict[str, deque] = {}
        for e in ordered:
            queues.setdefault(e.ns, deque()).append(e)
        names = sorted(queues)  # deterministic round-robin order
        quantum = reap_quantum()
        deficit = dict.fromkeys(names, 0)
        out: list[bytes] = []
        reaped: list[_Entry] = []
        skipped = total = 0
        while any(queues[ns] for ns in names):
            progress = False
            for ns in names:
                q = queues[ns]
                if not q:
                    deficit[ns] = 0  # idle tenants accrue no burst claim
                    continue
                deficit[ns] += quantum
                while q:
                    e = q[0]
                    if total + len(e.tx) > max_bytes:
                        q.popleft()
                        skipped += 1
                        progress = True
                        continue
                    if len(e.tx) > deficit[ns]:
                        break  # accrues more deficit next round
                    q.popleft()
                    deficit[ns] -= len(e.tx)
                    out.append(e.tx)
                    reaped.append(e)
                    total += len(e.tx)
                    progress = True
            if not progress and not any(
                q and len(q[0].tx) <= max_bytes - total for q in queues.values()
            ):
                break  # nothing left that could ever fit the budget
        return out, reaped, skipped, total

    def update(self, height: int, committed_txs: list[bytes]) -> None:
        """Post-commit maintenance: drop included txs, expire TTLs.

        Journaled (`mempool_update` row): committed drops and TTL expiries
        were previously silent.  Each committed tx with a known submission
        context closes its lifecycle on the e2e `total` phase
        (submit wall-clock -> this commit)."""
        from celestia_app_tpu_torch.trace.spans import observe_e2e
        from celestia_app_tpu_torch.trace.tracer import traced

        now_ns = time.time_ns()
        committed = 0
        for tx in committed_txs:
            e = self._remove_key(self.tx_key(tx))
            if e is None:
                continue
            committed += 1
            if e.ctx is not None and getattr(e.ctx, "start_unix_ns", 0):
                observe_e2e("total", (now_ns - e.ctx.start_unix_ns) / 1e9,
                            namespace=e.e2e_namespace())
        expired_by_ns: dict[str, int] = {}
        n_expired = 0
        with self._all_locks():
            for s in self._shards:
                expired = [
                    k for k, e in s.entries.items()
                    if height - e.height >= self.ttl
                ]
                for k in expired:
                    e = s.remove(k)
                    self._key_shard.pop(k, None)
                    expired_by_ns[e.ns] = expired_by_ns.get(e.ns, 0) + 1
                    n_expired += 1
        for ns, n in sorted(expired_by_ns.items()):
            self._tick_eviction("ttl", n, namespace=ns)
        traced().write(
            "mempool_update", height=height, committed=committed,
            expired=n_expired, resident=len(self),
        )
        self._refresh_gauges()

    def resident_txs(self) -> list[bytes]:
        """All resident txs in (priority desc, FIFO) order — the order a
        proposer would take them (recheck runs in this order)."""
        return [
            e.tx for e in sorted(
                self._snapshot(), key=lambda e: (-e.priority, e.seq)
            )
        ]

    def remove_tx(self, tx: bytes) -> None:
        """Evict one tx (the post-commit recheck path): counted like every
        other non-commit removal so the gauges reconcile."""
        e = self._remove_key(self.tx_key(tx))
        if e is not None:
            self._tick_eviction("recheck", namespace=e.ns)
            self._refresh_gauges()
