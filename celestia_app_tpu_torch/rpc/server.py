"""The served node: HTTP JSON-RPC around the app + proposer/replication.

Parity surface (reference):
  * gRPC/API/RPC servers wrapping the app — app/app.go:712-735,
    test/util/testnode/network.go:38-43. Here one JSON-RPC-over-HTTP
    endpoint (Tendermint RPC's own transport) serves broadcast, account,
    tx-status, block, proof, and state-proof queries.
  * Block replication over sockets: a rotating proposer sends each
    finalized proposal to its peer validators (`apply_block`), who
    process_proposal + finalize + commit independently and must land on
    identical app hashes and data roots — the multi-process analog of the
    round-1 in-process Network, now with a real wire between validators.

Threading model: one RLock per node guards all app/mempool access; the
HTTP server is threading (one handler thread per request) and the proposer
loop is a daemon thread. All node methods take/return JSON-safe values at
the HTTP boundary (rpc/codec.py).

The port's copy of celestia_app_tpu/rpc/server.py on the port's TestNode:
`ServingNode(..., device=None)` runs its App, its serve cache and its proof
queries on `device` (None means CUDA and raises without a card; "cpu" runs
the plain kernel versions).  The DAS serving plane: `das_provider()` (a
serve/api.DasProvider over the node's serve cache, rebuilding an evicted
height from the block store), the RPCs `get_share_proof`,
`get_shares_by_namespace` and `get_attestation`, and in NodeServer the
provider and, under $CELESTIA_HEAL=1, a serve/heal.HealingEngine started
with the server and closed in `stop`.  A refusal is a JSON-RPC error -32000
naming it (`ShareWithheld: ...`, `BadProofDetected: ...`,
`HealingInProgress: ...`), as in JAX.  The GET face: `_Handler.do_GET`
serves the shared observability surface (trace/exposition.py: /metrics,
/healthz, /das/*, /device, /fleet, /timeline, ...), NodeServer registers the
node's `health_snapshot` under /healthz "layers" as `node:<port>` and its
DasProvider behind GET /das/*, and `stop` undoes both.  State sync: every
`snapshot_interval` heights the commit path takes a snapshot (keep 2), served
by `rpc_snapshots` / `rpc_snapshot_chunk`; `state_sync_from` restores a peer's
snapshot into a staging store, checks it against the next height's +2/3
Commit and swaps it in, then catches up the tail through `process_proposal`
on this node's device.  The swap resets what the JAX swap resets and the
operator-address cache, which is keyed by height.  One deliberate
difference in state sync, because the JAX one forks once the supply is
large: the App keeps its x/mint minter in memory, and its annual
provisions were fixed from the supply at the first block of the inflation
year, which a restored state cannot tell, so a JAX joiner mints a different
provision at its first block (from a supply of about 1.7e14 utia up).  The
port's snapshot metadata carries the minter (`"minter"`: inflation rate,
annual provisions, previous block time) and the swap restores it; a
snapshot without it (a JAX node's) restores as in JAX.  Since that
metadata, like the block times the JAX metadata carries, is outside the
state the Commit attests, the port also checks it before the swap: it
executes the next height on a throwaway copy of the restored App and holds
the app hash against the +2/3 Commit of the height after, so a forged
minter (or a JAX snapshot on a chain large enough to fork) is refused
instead of forking the joiner quietly.  A sync therefore needs the peer's
tip two heights past the snapshot, where JAX needs one.
Two deliberate differences, both because a device fault must stay visible:
the commit hook's serve retention lets a device.DeviceFault out, after the
block store and the Commit record are written, where the JAX node prints
every retention error and goes on; and NodeServer joins its in-flight
request threads on stop, so no handler outlives the server in the middle of
a call on the card.
"""

from __future__ import annotations

import copy
import json
import threading
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from celestia_app_tpu_torch.app import BlockData
from celestia_app_tpu_torch.device import DeviceFault
from celestia_app_tpu_torch.rpc.codec import to_jsonable
from celestia_app_tpu_torch.testutil.testnode import BLOCK_INTERVAL_NS, TestNode
from celestia_app_tpu_torch.trace.context import trace_span, use_context
from celestia_app_tpu_torch.tx import tx_hash


class ReplicationDivergence(RuntimeError):
    """A peer committed a different app hash / data root for the same block."""


class ServingNode(TestNode):
    """TestNode + locking + tx gossip + proposal replication to peers."""

    def __init__(
        self,
        genesis=None,
        keys=None,
        app=None,
        validator_index: int = 0,
        n_validators: int = 1,
        peers: list[str] | None = None,
        validator_key=None,
        snapshot_interval: int = 0,
        device=None,
    ):
        super().__init__(genesis, keys, app=app, device=device)
        # State-sync snapshots (reference: every 1500 blocks, keep 2,
        # app/default_overrides.go:293-297).  0 = serving disabled.
        self.snapshot_interval = snapshot_interval
        self._snapshots: dict[int, dict] = {}
        from celestia_app_tpu_torch.crypto.keys import PrivateKey

        # This node's consensus key (signs prevotes/precommits). Defaults
        # to the deterministic seed matching deterministic_genesis's
        # validator set; operators pass their own.
        self.validator_key = validator_key or PrivateKey.from_seed(
            f"validator-{validator_index}".encode()
        )
        # height -> Commit: the +2/3 precommit records light clients verify.
        self._commits: dict[int, "object"] = {}
        # height -> block hash this node prevoted (it precommits only what
        # it prevoted — the vote-consistency rule).
        self._prevoted: dict[int, bytes] = {}
        # The evidence pool: every signature-valid vote this node has
        # witnessed, keyed by height -> (validator, type, block_hash).
        # Conflicting entries are double-sign evidence (x/evidence;
        # Tendermint's evidence pool) shipped with the next proposal.
        self._witnessed: dict[int, dict[tuple[str, int, bytes], "object"]] = {}
        # (validator, height, vote_type) triples already submitted as
        # evidence — one equivocation per key is enough to tombstone.
        self._used_evidence: set[tuple[str, int, int]] = set()
        # (BlockData, time_ns, last_commit_signers, evidence_wire) by
        # height: survives serving a restarted chain (list index != height)
        # and feeds peer catch-up — signers/evidence MUST replicate with
        # the block or x/slashing state diverges across nodes.
        self._blocks_by_height: dict[int, tuple] = {}
        # height -> validator set (addr -> (PublicKey, power)) the height's
        # consensus ran under; kept alongside the block store so catch-up
        # can verify historic LastCommits across jailing boundaries.
        self._valsets_by_height: dict[int, dict] = {}
        # App version per height (the block header's Version.App in the
        # reference): clients reconstructing historical squares need the
        # hard cap in force then, not the current gov param.
        self._version_by_height: dict[int, int] = {}
        self.lock = threading.RLock()
        # The proof-serving plane's retention (serve/): every committed
        # non-empty height's EDS + NMT forests, LRU over
        # $CELESTIA_SERVE_HEIGHTS with host spill — the read side light
        # clients sample against.  Built lazily so a node that never
        # serves proofs pays nothing.
        self._serve_cache = None
        self._das_provider = None
        # Serializes whole produce+replicate rounds so replicated heights
        # reach peers in order even with concurrent produce callers.
        self._produce_lock = threading.Lock()
        self.validator_index = validator_index
        self.n_validators = max(1, n_validators)
        self.peer_urls = list(peers or [])
        self._peers: list = []  # RemoteNode handles, built lazily

    # --- peers --------------------------------------------------------------
    def peers(self):
        if len(self._peers) != len(self.peer_urls):
            from celestia_app_tpu_torch.rpc.client import RemoteNode

            # Peer handles keep the OLD 30 s cap: replication holds the
            # produce lock, and the long default (sized for a client
            # waiting out a cold jit in produce_block) would stall block
            # production 4x longer per blackholed peer.
            self._peers = [
                RemoteNode(u, timeout=30.0, defer_status=True)
                for u in self.peer_urls
            ]
        return self._peers

    def is_proposer(self, height: int) -> bool:
        return (height - 1) % self.n_validators == self.validator_index

    # --- tx admission + gossip ----------------------------------------------
    def broadcast(self, raw_tx: bytes, relay: bool = True, ctx=None):
        """Mempool gossip: multi-hop flood with mempool-insert dedup.

        A tx relays onward only when it was NEWLY admitted here, so the
        flood terminates (re-received txs are already resident) yet
        crosses partial topologies hop by hop — a tx submitted anywhere
        reaches the proposer without the submitter knowing who that is
        (reference: mempool v1 gossip, app/default_overrides.go:258-284).
        `ctx` is the request's TraceContext (threaded into the mempool
        entry; see trace/context.py).

        Locking: the node lock is held only around CheckTx (inside
        super().broadcast — app check state is the remaining serial
        section); the mempool admission runs under the pool's own
        per-shard locks, so concurrent broadcasts of DIFFERENT tenants
        no longer serialize end-to-end.  The newly-admitted probe is a
        before/after residency read: a same-tx race can at worst relay
        twice (the flood's dedup absorbs it) or skip one relay hop (the
        re-offer path recovers it) — both documented best-effort.
        """
        known = self.mempool.has_tx(raw_tx)
        res = super().broadcast(raw_tx, ctx=ctx)
        inserted = not known and res.code == 0 and self.mempool.has_tx(raw_tx)
        if inserted and relay:
            def _relay():
                for peer in self.peers():
                    try:
                        peer.broadcast(raw_tx, relay=True)
                    except Exception:
                        pass  # mempool gossip is best-effort; consensus is not

            self.gossip_pool.submit(_relay)
        return res

    @property
    def gossip_pool(self):
        """Shared executor for async gossip sends (tx relay + consensus
        flood).  A pool, not ad-hoc threads: NodeServer.stop drains it so
        no send outlives the server (stray daemon threads dying inside
        C-runtime calls abort the interpreter at exit).  Sized up under
        chaos latency injection — injected sleeps park workers, and an
        8-worker pool would serialize a block's worth of sends behind
        them."""
        pool = getattr(self, "_gossip_pool", None)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor

            driver = getattr(self, "consensus_driver", None)
            workers = 8
            if driver is not None and (driver.latency_s or driver.jitter_s):
                workers = 48
            pool = self._gossip_pool = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="gossip"
            )
        return pool

    def shutdown_gossip(self) -> None:
        pool = getattr(self, "_gossip_pool", None)
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
            self._gossip_pool = None

    # --- block production + replication --------------------------------------
    def produce_block(self, time_ns: int | None = None):
        with self._produce_lock:
            return self._produce_and_replicate(time_ns)

    def _validator_set(self):
        """address -> (PublicKey, power), the vote-accounting view.

        Built from the BONDED set: a jailed or tombstoned validator's votes
        stop counting toward quorum the moment the jailing block commits
        (Tendermint rebuilds the consensus valset from bonded validators
        the same way)."""
        from celestia_app_tpu_torch.crypto.keys import PublicKey
        from celestia_app_tpu_torch.state.staking import StakingKeeper

        out = {}
        for v in StakingKeeper(self.app.cms.working).bonded_validators():
            if v.pubkey:
                out[v.address] = (PublicKey(v.pubkey), v.power)
        return out

    def _witness_vote(self, vote, validators) -> None:
        """Feed the evidence pool: record any signature-valid vote by a
        known validator, INCLUDING votes for a block id this node disagrees
        with — a conflicting pair per (validator, height, type) is exactly
        what x/evidence punishes."""
        entry = validators.get(vote.validator)
        if entry is None or not vote.verify(entry[0], self.chain_id):
            return
        self._witnessed.setdefault(vote.height, {})[
            (vote.validator, vote.vote_type, vote.block_hash)
        ] = vote

    def _pending_evidence(self) -> list:
        """Equivocations in the pool not yet submitted (proposer side)."""
        from celestia_app_tpu_torch.consensus.votes import find_equivocations

        votes = [
            v for by_key in self._witnessed.values() for v in by_key.values()
        ]
        return [
            ev
            for ev in find_equivocations(votes)
            if ev.key() not in self._used_evidence
        ]

    def _sign_vote(self, height: int, vote_type: int, block_hash: bytes):
        from celestia_app_tpu_torch.consensus import Vote

        return Vote.sign(
            self.validator_key, self.chain_id, height, vote_type, block_hash,
            validator=self._operator_address(),
        )

    def _operator_address(self) -> str:
        """The bonded validator this node's consensus key speaks for.
        Genesis validators' operator address IS the key's address; a
        validator created via MsgCreateValidator registers the consensus
        pubkey under the operator's account address instead.  Cached per
        committed height — votes are signed twice per round and the
        valset only moves when a block commits."""
        cached = getattr(self, "_operator_cache", None)
        if cached is not None and cached[0] == self.app.height:
            return cached[1]
        from celestia_app_tpu_torch.state.staking import StakingKeeper

        own = self.validator_key.public_key()
        addr = own.address()  # not (yet) a validator: vote as itself
        for v in StakingKeeper(self.app.cms.working).bonded_validators():
            if v.pubkey == own.bytes:
                addr = v.address
                break
        self._operator_cache = (self.app.height, addr)
        return addr

    def _commit_block_data(
        self,
        data: BlockData,
        time_ns: int,
        last_commit_signers: set[str] | None = None,
        evidence: tuple = (),
    ):
        """The shared commit sequence + the serving plane's per-height
        bookkeeping (block store for catch-up, app version for clients).
        Signers/evidence are stored with the block so catch-up replays the
        exact x/slashing inputs every live node executed."""
        proposal_version = self.app.app_version  # pre-end-block upgrades
        # The set THIS height's consensus ran under (bonded set after H-1),
        # captured before the block applies: gossip catch-up restores it to
        # verify height-H LastCommits — the post-H set has already dropped
        # anyone block H jailed, whose legitimate precommit must still count.
        vals_pre_apply = self._validator_set()
        before = self.app.height
        try:
            # A DeviceFault of the recheck (testutil/testnode.py) comes out
            # of here after the block is committed: the bookkeeping below
            # runs before it goes on.
            results = super()._commit_block_data(
                data, time_ns,
                last_commit_signers=last_commit_signers, evidence=evidence,
            )
        finally:
            if self.app.height > before:
                height = self.app.height
                self._valsets_by_height[height] = vals_pre_apply
                evidence_wire = self._evidence_to_wire(evidence)
                self._blocks_by_height[height] = (
                    data, time_ns,
                    sorted(last_commit_signers) if last_commit_signers is not None else None,
                    evidence_wire,
                )
                self._version_by_height[height] = proposal_version
                self._prevoted.pop(height, None)  # round done
                try:
                    self._retain_for_serving(height, data)
                finally:
                    for ev in evidence:
                        self._used_evidence.add(ev.key())
                    # Bound the evidence pool (Tendermint prunes expired evidence).
                    for h in [h for h in self._witnessed if h < height - 100]:
                        del self._witnessed[h]
                    if self.snapshot_interval and height % self.snapshot_interval == 0:
                        self._take_snapshot(height)
        return results

    # --- the proof-serving plane (serve/) ------------------------------------
    @property
    def serve_cache(self):
        if self._serve_cache is None:
            from celestia_app_tpu_torch.serve.cache import ForestCache

            self._serve_cache = ForestCache(device=self.app.device)
        return self._serve_cache

    def das_provider(self):
        """This node's DasProvider (serve/api.py): the cache-backed payload
        builder every plane serves; a miss rebuilds from the block store,
        so an evicted height is slower, never unservable."""
        if self._das_provider is None:
            from celestia_app_tpu_torch.serve.api import DasProvider

            self._das_provider = DasProvider(cache=self.serve_cache, rebuild=self._rebuild_eds)
        return self._das_provider

    def _retain_for_serving(self, height: int, data: BlockData) -> None:
        """Admit the committed height's EDS + forests to the serve cache.

        The normal path is free of square work: the app extended exactly
        this square during Prepare/Process and still holds the handle
        (App.last_eds_for_root, matched on the committed data hash), so
        retention costs one async forest dispatch — no second layout
        solve, no duplicate square-journal row, no re-extension.  A
        memo miss (e.g. the handle was displaced) falls back to a full
        rebuild.  Never raises into the commit path: the serve plane
        degrading must not stall consensus — except a DeviceFault, which
        is the card failing, not the serve plane, and goes to the caller.
        """
        from celestia_app_tpu_torch.serve.cache import serve_heights

        if serve_heights() <= 0 or not data.txs:
            return  # disabled, or an empty block (the min square)
        try:
            eds = self.app.last_eds_for_root(data.hash)
            if eds is None:
                eds = self._eds_for_block(data)
            if eds is not None:
                self.serve_cache.put(height, eds)
        except DeviceFault:
            raise
        except Exception as e:  # noqa: BLE001 — read plane must not stall commit
            import sys

            print(f"serve retention failed at height {height}: {e}",
                  file=sys.stderr)

    def _eds_for_block(self, data: BlockData):
        """Reconstruct the block's EDS, ROOT-VERIFIED against the
        committed data hash; None for empty blocks or an unreproducible
        square.

        The square is re-solved under the CURRENT effective cap first
        (the common case) and, when that fails to reproduce, under the
        committed square size as the ceiling — a governance cap change
        after this height would otherwise re-solve a DIFFERENT layout
        whose proofs can never verify against the committed header (the
        block store's own square_size_upper_bound caveat).  The DAH-hash
        check is the gate either way: this node never serves proofs
        against a root it did not commit."""
        import sys

        from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader
        from celestia_app_tpu_torch.square import builder as square

        if not data.txs:
            return None
        caps = [self.app.max_effective_square_size()]
        if data.square_size not in caps:
            caps.append(data.square_size)
        for cap in caps:
            sq = square.construct(list(data.txs), cap)
            if sq.is_empty() or sq.size != data.square_size:
                continue
            eds = self.app.square_eds(sq.size, sq.share_bytes())
            if DataAvailabilityHeader.from_eds(eds).hash() == data.hash:
                return eds
        print(
            f"serve rebuild cannot reproduce the committed square "
            f"(size {data.square_size}, root {data.hash.hex()[:16]}); "
            "refusing to serve unverifiable proofs",
            file=sys.stderr,
        )
        return None

    def _rebuild_eds(self, height: int):
        """Serve-cache miss path: rebuild from the block store's raw txs
        (the querier pattern) so proofs outlive every cache tier."""
        with self.lock:
            entry = self._blocks_by_height.get(height)
        if entry is None:
            return None
        return self._eds_for_block(entry[0])

    def rpc_get_share_proof(self, height: int, row: int, col: int, axis: str = "row") -> dict:
        """GetShareProof — one DAS sample of the EXTENDED square (parity
        quadrants included), proven to the height's committed DAH data
        root through the row tree or (axis="col") the column tree."""
        from celestia_app_tpu_torch.serve.api import count_served

        payload = self.das_provider().share_proof_payload(int(height), int(row), int(col),
                                                          axis=axis)
        count_served("jsonrpc", "share_proof", payload)
        return payload

    def rpc_get_shares_by_namespace(self, height: int, namespace: str) -> dict:
        """GetSharesByNamespace — every share of a namespace with its
        multi-row inclusion proof (namespace as 29-byte hex)."""
        from celestia_app_tpu_torch.serve.api import count_served

        payload = self.das_provider().shares_payload(int(height), namespace)
        count_served("jsonrpc", "shares", payload)
        return payload

    def rpc_get_attestation(self, height: int, samples: str) -> dict:
        """GetAttestation — a deduped multiproof for a SET of samples
        (`samples` = comma-joined row:col[:axis]): shared NMT and root
        nodes serialized once, per-sample proofs reconstructable by
        indexing (rpc/codec.share_proofs_from_attestation)."""
        from celestia_app_tpu_torch.serve.api import count_served

        payload = self.das_provider().attestation_payload(int(height), samples)
        count_served("jsonrpc", "attestation", payload)
        return payload

    # --- state-sync snapshots -------------------------------------------------
    SNAPSHOT_CHUNK_BYTES = 512 * 1024

    def _take_snapshot(self, height: int) -> None:
        import hashlib

        state = self.app.cms.export(height)
        blob = json.dumps(
            {k.hex(): v.hex() for k, v in sorted(state.items())},
            separators=(",", ":"),
        ).encode()
        chunks = [
            blob[i: i + self.SNAPSHOT_CHUNK_BYTES]
            for i in range(0, max(len(blob), 1), self.SNAPSHOT_CHUNK_BYTES)
        ]
        self._snapshots[height] = {
            "height": height,
            "app_hash": self.app.cms.last_app_hash.hex(),
            "app_version": self.app.app_version,  # post-commit (resume needs it)
            "chain_id": self.chain_id,
            # Mint provisions derive from (genesis time, last block time,
            # supply); both times must restore exactly or the synced node's
            # first minted block diverges from every other validator.
            "genesis_time_ns": self.app.genesis_time_ns,
            "block_time_ns": self.app.last_block_time_ns,
            # ... and so must the minter, which the App keeps in memory: its
            # annual provisions were fixed from the supply at the first block
            # of the inflation year, which the restored state cannot tell.
            "minter": {
                "inflation_rate": str(self.app.minter.inflation_rate.raw),
                "annual_provisions": str(self.app.minter.annual_provisions.raw),
                "previous_block_time_ns": self.app.minter.previous_block_time_ns,
            },
            "chunks": chunks,
            "chunk_hashes": [hashlib.sha256(c).hexdigest() for c in chunks],
        }
        for h in sorted(self._snapshots)[:-2]:  # keep 2
            del self._snapshots[h]

    def _produce_and_replicate(self, produce_time_ns: int | None = None):
        """One voting round per height (celestia-core's consensus shape,
        proposer-driven — scope note in consensus/votes.py):

          propose -> prevotes -> +2/3? -> precommits -> +2/3?
          -> commit everywhere with the Commit record

        Both quorum gates run BEFORE any node commits state: a failed round
        leaves every validator exactly where it was.  Every node that
        applies the block stores the Commit record (rpc_commit serves it).
        """
        from celestia_app_tpu_torch.consensus import (
            PRECOMMIT,
            PREVOTE,
            Commit,
            ConsensusError,
            Vote,
            VoteSet,
            block_id,
        )

        peers = self.peers()
        with self.lock:
            validators = self._validator_set()
            time_ns = (
                produce_time_ns
                if produce_time_ns is not None
                else self.app.last_block_time_ns + BLOCK_INTERVAL_NS
            )
            height = self.app.height + 1
            prev_app_hash = self.app.cms.last_app_hash
            # ABCI LastCommitInfo: who precommitted the previous height
            # (x/slashing liveness input); ByzantineValidators: double-sign
            # pairs from the evidence pool.  Both replicate with the block.
            prev_commit = self._commits.get(height - 1)
            last_signers = (
                {v.validator for v in prev_commit.precommits}
                if prev_commit is not None
                else None
            )
            evidence = tuple(self._pending_evidence())
            reaped = self.mempool.reap(self.block_max_bytes())
            # One trace from the submitting request down to the DAH root:
            # the block adopts the first reaped tx's trace (threaded
            # explicitly through the mempool entry, trace/context.py).
            block_ctx = self._block_trace_context(reaped, height)
            with use_context(block_ctx), trace_span(
                "block_propose", layer="consensus", e2e="propose",
                height=height, n_txs=len(reaped),
            ):
                data = self.app.prepare_proposal(reaped)
                if not self.app.process_proposal(data):
                    raise AssertionError("node rejected its own proposal")
            # Votes commit to block_id(data root, prev app hash, time): a
            # peer whose state diverged computes a DIFFERENT id, so its
            # prevote misses this vote set and divergence blocks quorum
            # BEFORE anyone commits.
            bid = block_id(data.hash, prev_app_hash, time_ns)
            # Phase 1: prevotes (peers validate, nobody commits yet).
            # The node's own vote is best-effort like any peer's: a genesis
            # whose consensus pubkey differs from this node's signing key
            # (custom valsets) must not wedge production — quorum gates
            # decide, and a solo node commits regardless.
            prevotes = VoteSet(self.chain_id, height, PREVOTE, bid, validators)
            try:
                prevotes.add(self._sign_vote(height, PREVOTE, bid))
            except ConsensusError:
                pass
        # Unreachable or refusing peers are tolerated — BFT advances as
        # long as +2/3 answers; they catch up from the block store later.
        with use_context(block_ctx), trace_span(
            "block_prevotes", layer="consensus", e2e="prevote", height=height,
        ) as sp:
            for peer in peers:
                try:
                    reply = peer.propose(height, time_ns, data)
                    vote = Vote.unmarshal(bytes.fromhex(reply["prevote"]))
                    self._witness_vote(vote, validators)
                    prevotes.add(vote)
                except Exception:
                    continue
            sp["power"] = prevotes.signed_power()
            sp["total_power"] = prevotes.total_power()
        # Quorum is enforced when replicating to peers; a solo dev node
        # (one process, however many genesis validators) commits alone.
        if peers and not prevotes.has_two_thirds():
            raise ConsensusError(
                f"no +2/3 prevotes at height {height}: "
                f"{prevotes.signed_power()}/{prevotes.total_power()}"
            )
        prevotes_wire = [v.marshal().hex() for v in prevotes.votes.values()]

        # Phase 2: precommits — still no state committed anywhere.
        precommits = VoteSet(self.chain_id, height, PRECOMMIT, bid, validators)
        with use_context(block_ctx), trace_span(
            "block_precommits", layer="consensus", e2e="precommit",
            height=height,
        ) as sp:
            try:
                precommits.add(self._sign_vote(height, PRECOMMIT, bid))
            except ConsensusError:
                pass
            for peer in peers:
                try:
                    reply = peer.precommit(height, bid, prevotes_wire)
                    vote = Vote.unmarshal(bytes.fromhex(reply["precommit"]))
                    self._witness_vote(vote, validators)
                    precommits.add(vote)
                except Exception:
                    continue
            sp["power"] = precommits.signed_power()
            sp["total_power"] = precommits.total_power()
        if peers and not precommits.has_two_thirds():
            raise ConsensusError(
                f"no +2/3 precommits at height {height}: "
                f"{precommits.signed_power()}/{precommits.total_power()}"
            )
        commit = Commit(
            height, bid, tuple(precommits.votes.values()), data.hash,
            prev_app_hash, time_ns=time_ns,
        )

        # Phase 3: the commit is decided — apply everywhere, carrying the
        # Commit record so every node serves it.
        signers_wire = sorted(last_signers) if last_signers is not None else None
        evidence_wire = self._evidence_to_wire(evidence)
        with self.lock, use_context(block_ctx), trace_span(
            "block_commit", layer="consensus", e2e="commit", height=height,
        ):
            with self._recording_commit(height, commit):
                results = self._commit_block_data(
                    data, time_ns, last_commit_signers=last_signers, evidence=evidence
                )
            own_app_hash = self.app.cms.last_app_hash
        commit_wire = commit.to_json()
        for peer in peers:
            try:
                reply = peer.finalize_commit(
                    height, time_ns, data, commit_wire,
                    last_commit_signers=signers_wire, evidence=evidence_wire,
                )
            except Exception:
                continue  # down peer: catch-up recovers it later
            if (
                bytes.fromhex(reply["app_hash"]) != own_app_hash
                or bytes.fromhex(reply["data_hash"]) != data.hash
            ):
                # Divergence is never tolerated: identical inputs MUST land
                # on identical state (the determinism contract).
                raise ReplicationDivergence(
                    f"peer {peer.url} diverged at height {height}: "
                    f"{reply['app_hash'][:16]} != {own_app_hash.hex()[:16]}"
                )
        return data, results

    def apply_block(
        self,
        height: int,
        time_ns: int,
        data: BlockData,
        last_commit_signers: set[str] | None = None,
        evidence: tuple = (),
    ) -> dict:
        """Peer endpoint: validate + execute a replicated proposal (with
        the proposer's LastCommitInfo/evidence so slashing state matches).

        A peer that missed blocks (e.g. it was still starting when the
        proposer advanced) first catches up from whoever serves them, so a
        transient replication failure cannot wedge the devnet permanently.
        """
        with self.lock:
            behind = height > self.app.height + 1
        if behind:
            self._catch_up(height - 1)
        with self.lock:
            if height != self.app.height + 1:
                raise ValueError(
                    f"out-of-order block {height}, at {self.app.height}"
                )
            if not self.app.process_proposal(data):
                raise ValueError(f"proposal rejected at height {height}")
            self._commit_block_data(
                data, time_ns,
                last_commit_signers=last_commit_signers, evidence=evidence,
            )
            return {
                "app_hash": self.app.cms.last_app_hash.hex(),
                "data_hash": data.hash.hex(),
            }

    @contextmanager
    def _recording_commit(self, height: int, record):
        """Store `record` (None: nothing) as the height's Commit once the
        body has applied the block — also when a DeviceFault of the work
        after the commit (the recheck, the serve retention) comes out of
        it, before the fault goes on."""
        try:
            yield
        except DeviceFault:
            if record is not None and self.app.height >= height:
                with self.lock:
                    self._commits[height] = record
            raise
        if record is not None:
            with self.lock:
                self._commits[height] = record

    @staticmethod
    def _parse_evidence(pairs: list) -> tuple:
        from celestia_app_tpu_torch.consensus.votes import Equivocation, Vote

        return tuple(
            Equivocation(
                Vote.unmarshal(bytes.fromhex(a)), Vote.unmarshal(bytes.fromhex(b))
            )
            for a, b in pairs
        )

    @staticmethod
    def _evidence_to_wire(evidence: tuple) -> list:
        """Inverse of _parse_evidence — the single definition of the
        evidence wire shape (shipped in finalize_commit AND served to
        catch-up peers; the two must never drift)."""
        return [
            [ev.vote_a.marshal().hex(), ev.vote_b.marshal().hex()]
            for ev in evidence
        ]

    def _catch_up(self, upto: int) -> None:
        """Fetch + apply committed blocks up to `upto` from any peer."""
        while True:
            with self.lock:
                h = self.app.height + 1
            if h > upto:
                return
            for peer in self.peers():
                # Fetch the block AND its Commit record from the same peer
                # BEFORE applying anything: if this node later PROPOSES, it
                # derives LastCommitInfo from records, and peers cross-check
                # the shipped signer set against their own verified records
                # — advancing without the record risks proposing with
                # LastCommitInfo=None while peers derive the real signer
                # set, a guaranteed app-hash divergence.  A transient fetch
                # failure moves on to the next peer like any other.
                try:
                    b = peer.block(h)
                    rec = peer.commit(h)  # parsed Commit, or None
                except Exception:
                    continue
                if rec is None:
                    # This peer applied the block but never held the round's
                    # record (it state-synced past it); ask the others.
                    for other in self.peers():
                        if other is peer:
                            continue
                        try:
                            rec = other.commit(h)
                        except Exception:
                            continue
                        if rec is not None:
                            break
                data = BlockData(
                    txs=tuple(bytes.fromhex(t) for t in b["txs"]),
                    square_size=b["square_size"],
                    hash=bytes.fromhex(b["data_hash"]),
                )
                signers = b.get("last_commit_signers")
                with self._recording_commit(h, rec):
                    self.apply_block(
                        h, b["time_ns"], data,
                        last_commit_signers=set(signers) if signers is not None else None,
                        evidence=self._parse_evidence(b.get("evidence") or []),
                    )
                break
            else:
                raise ValueError(f"cannot catch up: no peer serves block {h}")

    # --- /healthz layer snapshot ---------------------------------------------
    def health_snapshot(self) -> dict:
        """Per-layer staleness for /healthz (trace/exposition.py): last
        block height and wall-clock age, mempool depth, peer count, and
        (when gossip consensus runs) the live round coordinates.

        The probe must never hang behind block production — a first
        kernel build or a k=512 extend can hold the node lock for seconds,
        which is exactly when an orchestrator most needs the probe to
        answer — so the lock is taken with a short timeout and contention
        itself becomes the report (best-effort unlocked reads are safe:
        ints and container sizes, no invariants).

        `last_square` (height, k, occupancy of the most recent square
        build/construct, from trace/square_journal.py) distinguishes a
        node stuck producing empty blocks (height advances, occupancy
        pinned at 0) from a healthy idle one (no recent square at all, or
        mempool empty).  Process-level, like the metrics registry: in a
        multi-node test process it reflects the last square ANY node
        built."""
        import time

        from celestia_app_tpu_torch.trace import square_journal

        out: dict = {
            "height": self.app.height,
            "block_age_s": (
                round(time.time() - self.last_commit_walltime, 3)
                if self.last_commit_walltime is not None else None
            ),
            "mempool": {
                "txs": len(self.mempool),
                "bytes": self.mempool.size_bytes(),
            },
            "peers": len(self.peer_urls),
            "last_square": square_journal.last_square(),
            # The serve plane's cache: resident heights per tier, hit
            # ratio, last eviction — a proof plane stuck at cold (all
            # misses, nothing resident while heights commit) is one
            # probe away, byte-identical on every plane like the rest
            # of /healthz.  Always ForestCache.stats() — one source of
            # the block's shape; a never-touched cache is trivially
            # cheap to instantiate and reports its true empty state.
            "serve": self.serve_cache.stats(),
        }
        if not self.lock.acquire(timeout=0.25):
            out["lock_contended"] = True
            return out
        try:
            driver = getattr(self, "consensus_driver", None)
            if driver is not None and driver.machine is not None:
                m = driver.machine
                out["consensus"] = {
                    "height": m.height, "round": m.round, "step": m.step,
                }
        finally:
            self.lock.release()
        return out

    # --- JSON-safe RPC methods (the HTTP surface) -----------------------------
    def rpc_status(self) -> dict:
        with self.lock:
            return {
                "chain_id": self.chain_id,
                "height": self.app.height,
                "app_hash": self.app.cms.last_app_hash.hex(),
                "app_version": self.app.app_version,
                "validator_index": self.validator_index,
                "n_validators": self.n_validators,
                "max_square_size": self.app.max_effective_square_size(),
            }

    def rpc_broadcast_tx(self, tx: str, relay: bool = True) -> dict:
        """Tx submission — the trace root.  The issued trace_id is
        returned to the client and follows the tx through the mempool,
        the square build, the device dispatch, and consensus
        (GET /trace_tables/spans filters on it).  When the request
        arrived with an x-celestia-trace header the ingress has already
        ADOPTED it (do_POST) — child that context instead of re-minting,
        so a relayed submit stays one trace across nodes."""
        from celestia_app_tpu_torch.trace.context import (
            current_context,
            new_context,
            use_context,
        )

        raw = bytes.fromhex(tx)
        parent = current_context()
        if parent is not None:
            ctx = parent.child(layer="rpc", plane="jsonrpc")
        else:
            ctx = new_context(layer="rpc", plane="jsonrpc")
        with use_context(ctx):
            res = self.broadcast(raw, relay=relay, ctx=ctx)
        return {"code": res.code, "log": res.log,
                "hash": tx_hash(raw).hex(),
                "trace_id": ctx.trace_id}

    def rpc_tx_status(self, hash: str) -> dict | None:
        with self.lock:
            st = self.tx_status(bytes.fromhex(hash))
        if st is None:
            return None
        return {"height": st[0], "code": st[1], "log": st[2]}

    def rpc_subscribe_tx(self, hash: str, timeout_s: float = 25.0) -> dict | None:
        """Long-poll subscription: block until `hash` commits (or timeout).

        The Tendermint websocket `/subscribe tm.event='Tx'` analog over
        JSON-RPC: the server parks the request on the node's commit event
        — one wakeup per block, no client-side polling. Deliberately NOT
        under self.lock (the wait would deadlock the proposer loop);
        tx_index reads are safe against concurrent commit.
        """
        timeout_s = min(float(timeout_s), 110.0)  # stay under socket timeout
        st = self.wait_tx(bytes.fromhex(hash), timeout_s)
        if st is None:
            return None
        return {"height": st[0], "code": st[1], "log": st[2]}

    def rpc_account(self, address: str) -> dict | None:
        with self.lock:
            acc = self.query_account(address)
        if acc is None:
            return None
        return {"account_number": acc.account_number, "sequence": acc.sequence}

    def rpc_block(self, height: int) -> dict:
        with self.lock:
            entry = self._blocks_by_height.get(height)
            if entry is None:
                raise ValueError(f"no block at height {height}")
            data, time_ns, signers, evidence_wire = entry
        return {
            "height": height,
            "time_ns": time_ns,
            "data_hash": data.hash.hex(),
            "square_size": data.square_size,
            "app_version": self._version_by_height.get(height, self.app.app_version),
            "txs": [t.hex() for t in data.txs],
            # x/slashing inputs: a catch-up peer must replay these exactly
            # or its app hash diverges from the nodes that were live.
            "last_commit_signers": signers,
            "evidence": evidence_wire,
            # Clients reconstructing the square (blobstream verify) need
            # the hard cap the block was BUILT under — the versioned 128
            # default, or the benchmark-manifest override if one is set.
            "square_size_upper_bound": self.app.square_size_upper_bound,
        }

    def rpc_produce_block(self) -> dict:
        data, results = self.produce_block()
        return {
            "height": self.app.height,
            "data_hash": data.hash.hex(),
            "square_size": data.square_size,
            "results": [
                {"code": r.code, "log": r.log, "gas_wanted": r.gas_wanted,
                 "gas_used": r.gas_used}
                for r in results
            ],
        }

    def rpc_apply_block(
        self, height: int, time_ns: int, data_hash: str, square_size: int,
        txs: list[str],
    ) -> dict:
        data = BlockData(
            txs=tuple(bytes.fromhex(t) for t in txs),
            square_size=square_size,
            hash=bytes.fromhex(data_hash),
        )
        return self.apply_block(height, time_ns, data)

    # --- the voting round (consensus/votes.py; scope note there) -------------
    def rpc_propose(
        self, height: int, time_ns: int, data_hash: str, square_size: int,
        txs: list[str],
    ) -> dict:
        """Phase 1: validate the proposal, answer with a signed prevote.
        No state is committed here."""
        from celestia_app_tpu_torch.consensus import PREVOTE

        data = BlockData(
            txs=tuple(bytes.fromhex(t) for t in txs),
            square_size=square_size,
            hash=bytes.fromhex(data_hash),
        )
        with self.lock:
            behind = height > self.app.height + 1
        if behind:
            self._catch_up(height - 1)
        from celestia_app_tpu_torch.consensus import block_id

        with self.lock:
            if height != self.app.height + 1:
                raise ValueError(
                    f"cannot prevote height {height}, at {self.app.height}"
                )
            if not self.app.process_proposal(data):
                raise ValueError(f"proposal rejected at height {height}")
            # Computed over THIS node's app hash: divergence yields a
            # different block id, and the prevote simply won't count.
            bid = block_id(data.hash, self.app.cms.last_app_hash, time_ns)
            prevote = self._sign_vote(height, PREVOTE, bid)
            self._prevoted[height] = bid
        return {"prevote": prevote.marshal().hex()}

    def rpc_precommit(
        self, height: int, data_hash: str, prevotes: list[str]
    ) -> dict:
        """Phase 2: shown a +2/3 prevote set for the block this node
        prevoted, sign a precommit.  NO state is committed here — both
        quorum gates precede any application (Tendermint's ordering)."""
        from celestia_app_tpu_torch.consensus import (
            PRECOMMIT,
            PREVOTE,
            ConsensusError,
            Vote,
            VoteSet,
        )

        block_hash = bytes.fromhex(data_hash)
        with self.lock:
            if self._prevoted.get(height) != block_hash:
                raise ConsensusError(
                    f"will not precommit height {height}: not the block "
                    "this node prevoted"
                )
            vote_set = VoteSet(
                self.chain_id, height, PREVOTE, block_hash, self._validator_set()
            )
        for raw in prevotes:
            vote_set.add(Vote.unmarshal(bytes.fromhex(raw)))
        if not vote_set.has_two_thirds():
            raise ConsensusError(
                f"precommit without +2/3 prevotes at height {height}: "
                f"{vote_set.signed_power()}/{vote_set.total_power()}"
            )
        with self.lock:
            precommit = self._sign_vote(height, PRECOMMIT, block_hash)
        return {"precommit": precommit.marshal().hex()}

    def rpc_finalize_commit(
        self, height: int, time_ns: int, data_hash: str, square_size: int,
        txs: list[str], commit: dict,
        last_commit_signers: list[str] | None = None,
        evidence: list | None = None,
    ) -> dict:
        """Phase 3: the round is decided — verify the Commit record
        (+2/3 precommits), apply the block (with the proposer's
        LastCommitInfo + evidence), and keep the record so this node
        serves it too."""
        from celestia_app_tpu_torch.consensus import Commit, ConsensusError, verify_commit

        data = BlockData(
            txs=tuple(bytes.fromhex(t) for t in txs),
            square_size=square_size,
            hash=bytes.fromhex(data_hash),
        )
        record = Commit.from_json(commit)
        with self.lock:
            validators = self._validator_set()
            prev_record = self._commits.get(height - 1)
        if (
            record.height != height
            or record.data_root != data.hash
            or not verify_commit(validators, self.chain_id, record)
        ):
            raise ConsensusError(f"invalid commit record for height {height}")
        signers = set(last_commit_signers) if last_commit_signers is not None else None
        if prev_record is not None:
            # The slashing liveness input is NOT taken on the proposer's
            # word: this node verified height-1's Commit itself, so the
            # signer set must match it exactly — a proposer lying about who
            # signed could otherwise jail an honest validator everywhere.
            expected = {v.validator for v in prev_record.precommits}
            if signers is not None and signers != expected:
                raise ConsensusError(
                    f"last_commit_signers mismatch at height {height}: "
                    f"proposer says {sorted(signers)}, verified commit says "
                    f"{sorted(expected)}"
                )
            signers = expected
        with self._recording_commit(height, record):
            reply = self.apply_block(
                height, time_ns, data,
                last_commit_signers=signers,
                evidence=self._parse_evidence(evidence or []),
            )
        return reply

    def rpc_commit(self, height: int) -> dict | None:
        """The Commit record (+2/3 precommits) for a height, if this node
        drove or learned that round — what a light client verifies."""
        with self.lock:
            commit = self._commits.get(height)
        return None if commit is None else commit.to_json()

    # --- gossip consensus (rpc/gossip.py) ------------------------------------
    def enable_gossip_consensus(
        self, timeouts=None, interval_s: float = 0.2,
        latency_s: float = 0.0, jitter_s: float = 0.0,
        wal_path: str | None = None,
    ):
        """Attach a ConsensusDriver (multi-round Tendermint machine over
        p2p flood gossip).  Call driver.start() once peers are serving.
        latency_s/jitter_s inject per-send delay (chaos tier); wal_path
        enables the double-sign WAL (consensus/wal.py)."""
        from celestia_app_tpu_torch.rpc.gossip import ConsensusDriver

        self.consensus_driver = ConsensusDriver(
            self, timeouts=timeouts, interval_s=interval_s,
            latency_s=latency_s, jitter_s=jitter_s, wal_path=wal_path,
        )
        # The shared gossip pool may already exist (a broadcast before this
        # call) sized without knowledge of chaos latency; injected sleeps
        # would then serialize a block's worth of sends behind 8 parked
        # workers.  Drop it so the next access re-sizes for the driver.
        pool = getattr(self, "_gossip_pool", None)
        if pool is not None and (latency_s or jitter_s):
            pool.shutdown(wait=True, cancel_futures=False)
            self._gossip_pool = None
        return self.consensus_driver

    def rpc_consensus(self, msg: dict) -> dict:
        driver = getattr(self, "consensus_driver", None)
        if driver is None:
            raise ValueError("gossip consensus is not enabled on this node")
        return driver.handle(msg)

    def rpc_consensus_state(self) -> dict:
        """Round-machine introspection (the consensus reactor's dump_state
        analog): current height/round/step, tallies, backlog depth."""
        driver = getattr(self, "consensus_driver", None)
        if driver is None:
            return {"enabled": False}
        with self.lock:
            m = driver.machine
            out = {
                "enabled": True,
                "app_height": self.app.height,
                "backlog": len(driver.backlog),
                "machine": None,
            }
            if m is not None:
                out["machine"] = {
                    "height": m.height,
                    "round": m.round,
                    "step": m.step,
                    "locked_round": m.locked_round,
                    "proposer": m.proposer(m.round),
                    "my_address": m.my_address,
                    "proposals": sorted(m.proposals),
                    "prevote_power": {
                        r: t.power_any() for r, t in m.prevotes.items()
                    },
                    "precommit_power": {
                        r: t.power_any() for r, t in m.precommits.items()
                    },
                }
            return out

    # --- state-sync serving ---------------------------------------------------
    def rpc_snapshots(self) -> list[dict]:
        """Available snapshot metadata (newest last), chunks elided."""
        with self.lock:
            return [
                {k: v for k, v in snap.items() if k != "chunks"}
                for _, snap in sorted(self._snapshots.items())
            ]

    def rpc_snapshot_chunk(self, height: int, index: int) -> str:
        with self.lock:
            snap = self._snapshots.get(height)
            if snap is None:
                raise ValueError(f"no snapshot at height {height}")
            return snap["chunks"][index].hex()

    def state_sync_from(
        self, peer_url: str, trusted_validators: dict | None = None
    ) -> int:
        """Join the chain from a peer's snapshot instead of replaying every
        block (the reference's state sync): fetch + hash-verify chunks,
        restore into a STAGING store, recompute the app hash from the
        restored data, verify the NEXT height's Commit — its precommits
        sign block_id(data_root, prev_app_hash), so +2/3 of the validator
        power attests exactly the app hash we restored — and only then
        swap the state in and catch up the tail.  Returns the height
        joined at.

        Trust root: the commit is checked against `trusted_validators`
        (address -> (PublicKey, power)) or, by default, this node's OWN
        pre-sync validator set and chain id (its genesis) — never against
        anything the untrusted snapshot carries.  If the real valset has
        drifted past the joiner's genesis, the operator supplies the
        trusted set explicitly (Tendermint state sync's light-block trust
        assumption)."""
        import hashlib

        from celestia_app_tpu_torch.consensus import ConsensusError, verify_commit
        from celestia_app_tpu_torch.rpc.client import RemoteNode
        from celestia_app_tpu_torch.state.store import CommitStore

        with self.lock:
            trusted = trusted_validators or self._validator_set()
            trusted_chain_id = self.chain_id
        peer = RemoteNode(peer_url, timeout=30.0, defer_status=True)
        metas = peer.snapshots()
        if not metas:
            raise ValueError(f"peer {peer_url} serves no snapshots")
        meta = metas[-1]
        height = meta["height"]
        if meta["chain_id"] != trusted_chain_id:
            raise ConsensusError(
                f"snapshot is for chain {meta['chain_id']!r}, "
                f"this node trusts {trusted_chain_id!r}"
            )
        blob = b""
        for i, want in enumerate(meta["chunk_hashes"]):
            chunk = bytes.fromhex(peer.snapshot_chunk(height, i))
            if hashlib.sha256(chunk).hexdigest() != want:
                raise ValueError(f"snapshot chunk {i} hash mismatch")
            blob += chunk
        state = {
            bytes.fromhex(k): bytes.fromhex(v) for k, v in json.loads(blob).items()
        }
        # Staging: nothing touches self.app until every check passes.
        cms = CommitStore()
        cms._committed[height] = state
        cms.load_height(height)  # recomputes the root from the data
        if cms.last_app_hash.hex() != meta["app_hash"]:
            raise ValueError("restored state does not match snapshot app hash")
        # Trust link: the next height's commit must attest this app hash,
        # signed by the TRUSTED validator set.
        commit = peer.commit(height + 1)
        if commit is None or commit.prev_app_hash != cms.last_app_hash:
            raise ConsensusError(
                f"commit at height {height + 1} does not attest the restored "
                "app hash"
            )
        if not verify_commit(trusted, trusted_chain_id, commit):
            raise ConsensusError(f"invalid commit at height {height + 1}")
        # The metadata past the app hash (block times, app version, minter)
        # is outside the attested state: execute the next height on a
        # throwaway copy of the restored App, with its own store, and hold
        # the result against the +2/3 Commit of the height after.  The copy
        # shares only configuration and memos with this node's App, which
        # Finalize and Commit do not touch; its Finalize counts the height's
        # txs in this process's delivered-tx counter, as the catch-up will.
        after = peer.commit(height + 2)
        if after is None:
            raise ConsensusError(
                f"no commit at height {height + 2} yet to check the snapshot's "
                "metadata against"
            )
        if not verify_commit(trusted, trusted_chain_id, after):
            raise ConsensusError(f"invalid commit at height {height + 2}")
        b = peer.block(height + 1)
        probe_cms = CommitStore()
        probe_cms._committed[height] = dict(state)
        probe_cms.load_height(height)
        with self.lock:
            probe = copy.copy(self.app)
            self._restore_into(probe, probe_cms, height, meta)
        signers = b.get("last_commit_signers")
        probe.finalize_block(
            b["time_ns"], [bytes.fromhex(t) for t in b["txs"]],
            last_commit_signers=set(signers) if signers is not None else None,
            evidence=self._parse_evidence(b.get("evidence") or []),
        )
        if probe.commit() != after.prev_app_hash:
            raise ConsensusError(
                f"commit at height {height + 2} does not attest height "
                f"{height + 1} executed from the snapshot's metadata"
            )
        with self.lock:
            self._restore_into(self.app, cms, height, meta)
            self._operator_cache = None  # keyed by height
        if not self.peer_urls:
            self.peer_urls = [peer_url]
            self._peers = []
        self._catch_up(peer.status()["height"])
        return height

    def _restore_into(self, app, cms, height: int, meta: dict) -> None:
        """Set `app`'s state to the restored `cms` at `height` and the
        snapshot's metadata: what the JAX swap resets, and the minter where
        the metadata carries one (else a copy of this node's own)."""
        from celestia_app_tpu_torch.modules.mint.minter import Minter
        from celestia_app_tpu_torch.state.dec import Dec

        if "minter" in meta:  # a JAX node's snapshot carries none
            m = meta["minter"]
            minter = Minter(Dec(int(m["inflation_rate"])), Dec(int(m["annual_provisions"])),
                            previous_block_time_ns=m["previous_block_time_ns"])
        else:
            minter = copy.deepcopy(self.app.minter)
        app.cms = cms
        app.height = height
        app.app_version = meta["app_version"]
        app.chain_id = meta["chain_id"]
        app.genesis_time_ns = meta["genesis_time_ns"]
        app.last_block_time_ns = meta["block_time_ns"]
        app._check_state = None
        app.minter = minter

    def rpc_tx_inclusion_proof(self, height: int, tx_index: int) -> dict:
        from celestia_app_tpu_torch.proof.querier import query_tx_inclusion_proof

        with self.lock:
            block = self.rpc_block(height)
            max_k = self.app.max_effective_square_size()
        proof = query_tx_inclusion_proof(
            [bytes.fromhex(t) for t in block["txs"]], tx_index, max_k,
            device=self.app.device,
        )
        return {"proof": to_jsonable(proof), "data_root": block["data_hash"]}

    def rpc_share_inclusion_proof(self, height: int, start: int, end: int) -> dict:
        from celestia_app_tpu_torch.proof.querier import query_share_inclusion_proof

        with self.lock:
            block = self.rpc_block(height)
            max_k = self.app.max_effective_square_size()
        proof = query_share_inclusion_proof(
            [bytes.fromhex(t) for t in block["txs"]], start, end, max_k,
            device=self.app.device,
        )
        return {"proof": to_jsonable(proof), "data_root": block["data_hash"]}

    def rpc_state_proof(self, key: str) -> dict:
        with self.lock:
            proof = self.app.cms.proof(bytes.fromhex(key))
            app_hash = self.app.cms.last_app_hash
        return {"proof": to_jsonable(proof), "app_hash": app_hash.hex()}

    def rpc_validators(self) -> list[dict]:
        from celestia_app_tpu_torch.state.staking import StakingKeeper

        with self.lock:
            vals = StakingKeeper(self.app.cms.working).validators()
        return [{"address": v.address, "power": v.power} for v in vals]

    # --- blobstream relayer surface -----------------------------------------
    # The query endpoints a BlobstreamX relayer consumes (reference
    # x/blobstream/keeper/query_*.go served over gRPC, plus celestia-core's
    # DataCommitment / DataRootInclusionProof RPCs used by client/verify.go).
    def _blobstream_keeper(self):
        from celestia_app_tpu_torch.modules.blobstream.keeper import BlobstreamKeeper
        from celestia_app_tpu_torch.state.staking import StakingKeeper

        store = self.app.cms.working
        return BlobstreamKeeper(store, StakingKeeper(store))

    @staticmethod
    def _attestation_dict(att) -> dict:
        from celestia_app_tpu_torch.modules.blobstream.keeper import DataCommitment, Valset

        if isinstance(att, Valset):
            return {
                "kind": "valset",
                "nonce": att.nonce,
                "height": att.height,
                "time_ns": att.time_ns,
                "members": [
                    {"address": m.address, "power": m.power} for m in att.members
                ],
            }
        assert isinstance(att, DataCommitment)
        return {
            "kind": "data_commitment",
            "nonce": att.nonce,
            "begin_block": att.begin_block,
            "end_block": att.end_block,
            "height": att.height,
            "time_ns": att.time_ns,
        }

    def rpc_blobstream_attestation(self, nonce: int) -> dict | None:
        """QueryAttestationRequestByNonce."""
        with self.lock:
            att = self._blobstream_keeper().get_attestation(nonce)
        return None if att is None else self._attestation_dict(att)

    def rpc_blobstream_nonces(self) -> dict:
        """LatestAttestationNonce + EarliestAttestationNonce."""
        with self.lock:
            k = self._blobstream_keeper()
            latest = k.latest_nonce()
            try:
                earliest = k.earliest_available_nonce()
            except KeyError:
                earliest = 0
        return {"latest": latest, "earliest": earliest}

    def rpc_data_commitment_range(self, height: int) -> dict:
        """DataCommitmentRangeForHeight (query_data_commitment.go:10-19)."""
        with self.lock:
            att = self._blobstream_keeper().data_commitment_for_height(height)
        return self._attestation_dict(att)

    def rpc_latest_data_commitment(self) -> dict | None:
        """LatestDataCommitment (query_data_commitment.go:21-32)."""
        with self.lock:
            try:
                att = self._blobstream_keeper().latest_data_commitment()
            except KeyError:
                return None
        return self._attestation_dict(att)

    def rpc_latest_valset_before(self, nonce: int) -> dict:
        """LatestValsetRequestBeforeNonce (query_valset.go:12-22)."""
        with self.lock:
            vs = self._blobstream_keeper().latest_valset_before_nonce(nonce)
        return self._attestation_dict(vs)

    def _window_data_roots(self, begin: int, end: int) -> list[tuple[int, bytes]]:
        """(height, data_root) for each height in [begin, end)."""
        out = []
        for h in range(begin, end):
            entry = self._blocks_by_height.get(h)
            if entry is None:
                raise ValueError(f"no block at height {h} (window [{begin},{end}))")
            out.append((h, entry[0].hash))
        return out

    def rpc_data_commitment(self, begin: int, end: int) -> str:
        """Tuple root over [begin, end) — celestia-core's DataCommitment RPC,
        the root the relayer submits to the Blobstream contract."""
        from celestia_app_tpu_torch.modules.blobstream.keeper import data_commitment_root

        with self.lock:
            roots = self._window_data_roots(begin, end)
        return data_commitment_root(roots).hex()

    def rpc_data_root_inclusion_proof(self, height: int, begin: int, end: int) -> dict:
        """Binary-merkle proof of (height, dataRoot) inside the window's
        tuple root — celestia-core's DataRootInclusionProof RPC
        (consumed at client/verify.go:288)."""
        from celestia_app_tpu_torch.modules.blobstream.keeper import (
            data_root_inclusion_proof,
        )

        with self.lock:
            roots = self._window_data_roots(begin, end)
        index, total, path = data_root_inclusion_proof(roots, height)
        return {
            "index": index,
            "total": total,
            "path": [p.hex() for p in path],
        }


def _method_table(node: ServingNode) -> dict:
    return {
        name[len("rpc_"):]: getattr(node, name)
        for name in dir(node)
        if name.startswith("rpc_")
    }


class _Handler(BaseHTTPRequestHandler):
    methods: dict = {}
    node_id: str | None = None  # per-server identity (multi-node tests)

    def log_message(self, fmt, *args):  # quiet: tests parse stdout
        pass

    def do_GET(self):
        """GET /metrics + /trace_tables[/<name>] + /healthz + /das/* + ...:
        the shared observability surface (trace/exposition.py — the
        Tendermint instrumentation analog, test/e2e/testnet/setup.go:24,
        and the pkg/trace table puller, node.go:52-74).  Every serving
        plane mounts the same handler, so the exposition is byte-identical.
        An `x-celestia-trace` header is ADOPTED (same trace_id, fresh
        span_id, this node's node_id) so remote DAS fetches stitch."""
        from celestia_app_tpu_torch.trace.exposition import (
            handle_observability_get_adopted,
            send_observability_404,
            send_observability_response,
        )

        resp = handle_observability_get_adopted(
            self, plane="jsonrpc", node_id=self.node_id
        )
        if resp is None:
            send_observability_404(self)
            return
        send_observability_response(self, resp)

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(length))
            method = self.methods.get(req.get("method", ""))
            if method is None:
                raise ValueError(f"unknown method {req.get('method')!r}")
            # Chaos rpc.handle seam: an injected stall models a slow
            # ingress; an injected failure surfaces as a normal RPC error
            # (clients and the gossip retry paths must absorb both).
            from celestia_app_tpu_torch import chaos

            chaos.rpc_handle()
            # Cross-node propagation: a request carrying the peer's
            # x-celestia-trace header runs under an ADOPTED context —
            # same trace_id, fresh span_id, this node's node_id — so the
            # method's own spans (broadcast_tx's mempool submit, the
            # consensus hand-off) join the caller's trace instead of
            # starting a new one.
            from celestia_app_tpu_torch.trace.context import (
                TRACE_HEADER,
                adopt_context,
                use_context,
            )

            ctx = adopt_context(
                self.headers.get(TRACE_HEADER),
                **({"node_id": self.node_id} if self.node_id else {}),
            )
            if ctx is not None:
                with use_context(ctx):
                    result = method(**req.get("params", {}))
            else:
                result = method(**req.get("params", {}))
            body = {"jsonrpc": "2.0", "id": req.get("id"), "result": result}
            status = 200
        except Exception as e:  # noqa: BLE001 — every fault becomes an RPC error
            from celestia_app_tpu_torch.qos import (
                QosThrottled,
                retry_after_header,
                throttle_body,
            )

            if isinstance(e, QosThrottled):
                # Per-tenant QoS refusal: HTTP 429 carrying qos.py's ONE
                # canonical payload (the /das route discipline — the REST
                # twin serves the very same bytes, the gRPC plane the same
                # string as its RESOURCE_EXHAUSTED detail).
                payload = throttle_body(e)
                self.send_response(429)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.send_header("Retry-After", retry_after_header(e))
                self.end_headers()
                self.wfile.write(payload)
                return
            body = {
                "jsonrpc": "2.0",
                "id": None,
                "error": {"code": -32000, "message": f"{type(e).__name__}: {e}"},
            }
            status = 500
        payload = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)


class _JoiningHTTPServer(ThreadingHTTPServer):
    """A threading HTTP server whose server_close waits for the request
    threads still running (ThreadingHTTPServer's are daemons it forgets)."""

    daemon_threads = False
    block_on_close = True


class NodeServer:
    """Owns the HTTP server + optional proposer-loop thread."""

    def __init__(
        self,
        node: ServingNode,
        host: str = "127.0.0.1",
        port: int = 0,
        node_id: str | None = None,
    ):
        # node_id overrides the process-wide identity for this server's
        # adopted spans — N in-process NodeServers (the standard test
        # topology) then stitch as N distinct nodes under one trace_id.
        handler = type(
            "BoundHandler",
            (_Handler,),
            {"methods": _method_table(node), "node_id": node_id},
        )
        self.node = node
        self.node_id = node_id
        self.httpd = _JoiningHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        # One stable bound-method object: unregistration compares by
        # identity, and attribute access mints a fresh bound method.  The
        # name carries the port so a multi-node process reports every
        # node, not just the last one constructed.
        self._health_provider = getattr(node, "health_snapshot", None)
        self._health_name = f"node:{self.port}"
        if self._health_provider is not None:
            from celestia_app_tpu_torch.trace.exposition import register_health_provider

            register_health_provider(self._health_name, self._health_provider)
        # The node's DAS surface behind GET /das/* (the shared handler; the
        # last-registered node answers) and, under $CELESTIA_HEAL=1, the
        # detect -> repair -> re-serve loop (serve/heal.py): detections on
        # this node's sampler start a repair and a root-verified
        # re-admission on the healer's thread.
        self._das_provider = None
        self._healer = None
        if hasattr(node, "das_provider"):
            from celestia_app_tpu_torch.serve import heal
            from celestia_app_tpu_torch.trace.exposition import register_das_provider

            self._das_provider = node.das_provider()
            register_das_provider(self._das_provider)
            if heal.heal_enabled():
                self._healer = heal.HealingEngine(self._das_provider, name=f"node:{self.port}")

    def start(self, block_interval_s: float | None = None):
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)
        if self._healer is not None:
            self._healer.start()
        if block_interval_s is not None:
            p = threading.Thread(
                target=self._proposer_loop, args=(block_interval_s,), daemon=True
            )
            p.start()
            self._threads.append(p)
        return self

    def _proposer_loop(self, interval_s: float):
        while not self._stop.wait(interval_s):
            try:
                if self.node.is_proposer(self.node.app.height + 1):
                    self.node.produce_block()
            except Exception as e:  # noqa: BLE001
                import sys

                print(f"proposer loop error: {e}", file=sys.stderr)

    def stop(self):
        """Unmount the health and DAS providers, stop the healer, the
        driver's timers, the HTTP server (waiting for requests in flight),
        the proposer loop and the gossip pool, in that order: no thread of
        this server outlives it."""
        from celestia_app_tpu_torch.trace.exposition import (
            unregister_das_provider,
            unregister_health_provider,
        )

        self._stop.set()
        if self._health_provider is not None:
            unregister_health_provider(self._health_name, self._health_provider)
        if self._healer is not None:
            self._healer.close()
        if self._das_provider is not None:
            unregister_das_provider(self._das_provider)
        driver = getattr(self.node, "consensus_driver", None)
        if driver is not None:
            driver.stop()
        self.httpd.shutdown()
        self.httpd.server_close()
        for t in self._threads:
            t.join()
        self.node.shutdown_gossip()


def serve(
    node: ServingNode,
    host: str = "127.0.0.1",
    port: int = 0,
    block_interval_s: float | None = 0.2,
) -> NodeServer:
    """Start serving `node`; returns the running NodeServer (daemon threads)."""
    return NodeServer(node, host, port).start(block_interval_s)
