"""Gossip consensus: the round machine driven over a peer-to-peer flood.

Replaces the proposer-push replication for devnet
validators: proposals and votes are broadcast to peers and RELAYED with
dedup (a flood mesh), so votes reach quorum without routing through the
proposer, and a tx submitted to any node reaches the proposer by relay —
the reference's p2p gossip shape (celestia-core consensus reactor +
mempool v1 gossip, app/default_overrides.go:258-284) without per-peer TCP
streams.

Division of labor:
  * consensus/machine.py — WHAT to do (pure Tendermint rules);
  * this driver — WHEN and WHERE: locks, timers, catch-up, payload
    storage, and executing the machine's effects (network sends happen
    strictly OUTSIDE the node lock — a relay cycle back into a waiting
    handler must never deadlock);
  * rpc/server.py `rpc_consensus` — the HTTP ingress, one endpoint for
    both message kinds.

The proposal payload carries the full block (txs), the height-1 Commit
record (Tendermint's LastCommit: the canonical precommit set every node
uses for x/slashing liveness — nodes may have collected different
precommit subsets themselves), and the evidence list, so every validator
executes the block with identical inputs.

The port's copy of celestia_app_tpu/rpc/gossip.py, whole, with one
deliberate difference, because a device fault is not a vote.  The JAX
driver's App swallows a speculation fault and reads any exception of
process_proposal as a rejection, so a fault of the device becomes a nil
prevote.  The port's App.speculate_proposal and process_proposal raise
device.DeviceFault instead, and the driver:
  * lets it out of `handle` (the HTTP caller sees an error), with the
    proposal neither judged nor stored in `payloads`: the machine acts on
    its own propose timeout, as for a proposal it never received;
  * still sends what the event that raised had already put in the outbox
    (this validator's own votes reach its peers);
  * raised in the commit of a decided block (the mempool recheck, the
    serve retention), lets it out after the Commit record is written and
    the next height is scheduled;
  * raised by one backlogged message, replays the rest of the backlog and
    then raises the first fault.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

from celestia_app_tpu_torch.app import BlockData
from celestia_app_tpu_torch.consensus.machine import (
    BroadcastProposal,
    BroadcastVote,
    Decided,
    EvidenceFound,
    Locked,
    Proposal,
    RequestProposal,
    RoundJournal,
    RoundMachine,
    ScheduleTimeout,
)
from celestia_app_tpu_torch.consensus.votes import (
    NIL,
    Commit,
    ConsensusError,
    Vote,
    block_id,
    verify_commit,
)
from celestia_app_tpu_torch.device import DeviceFault

# Devnet-scale timeouts (seconds): (base, per-round delta).
FAST_TIMEOUTS = {
    "propose": (0.6, 0.3),
    "prevote": (0.4, 0.2),
    "precommit": (0.4, 0.2),
}


class ConsensusDriver:
    """Owns the RoundMachine lifecycle for a ServingNode.

    All machine access happens under node.lock; every network send is
    queued in an outbox and flushed after the lock is released.
    """

    def __init__(
        self, node, timeouts=None, interval_s: float = 0.2,
        latency_s: float = 0.0, jitter_s: float = 0.0,
        wal_path: str | None = None,
    ):
        self.node = node
        self.timeouts = timeouts or FAST_TIMEOUTS
        self.interval_s = interval_s
        # Double-sign protection across restarts (consensus/wal.py): own
        # votes journal durably before broadcast; locks are restored into
        # the next machine for the same height.
        self.wal = None
        if wal_path is not None:
            from celestia_app_tpu_torch.consensus.wal import VoteWAL

            self.wal = VoteWAL(wal_path)
        # Chaos injection (the BitTwister analog, reference
        # test/e2e/benchmark/benchmark.go:112-119): every peer send sleeps
        # latency_s plus a deterministic per-message jitter in
        # [0, jitter_s], modeling a slow link without containers.
        self.latency_s = latency_s
        self.jitter_s = jitter_s
        self.machine: RoundMachine | None = None
        # block_hash -> {"data": BlockData, "time_ns": int,
        #                "last_commit": dict|None, "evidence": list}
        self.payloads: dict[bytes, dict] = {}
        # msg dedup (flood termination): id -> height, pruned by height so
        # the bound never wholesale-forgets in-flight heights (a clear()
        # would let the current height's messages re-flood).
        self.seen: dict[tuple, int] = {}
        # Messages that arrived between heights (machine torn down) or for
        # a near-future height: replayed when the next machine starts —
        # dedup marks them seen on arrival, so without this they'd be lost.
        self.backlog: list[dict] = []
        self.evidence_pool: list = []  # Equivocations awaiting inclusion
        # height -> validator map that height's machine ran under.  A
        # LastCommit for height H-1 must verify against the set bonded AT
        # H-1 — the post-H-1 set has already dropped anyone jailed by
        # block H-1, and verify_commit treats their (legitimate) precommit
        # as foreign, which would make every height-H proposal invalid on
        # every node (chain-wide halt after any jailing event).
        self.valsets: dict[int, dict] = {}
        self._timers: list[threading.Timer] = []
        self._stopped = False
        # peer url -> consecutive failed sends (gates per-send retries:
        # a link mid-streak is not worth multiplying timeouts on).
        self._peer_fail_streak: dict = {}

    # --- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        outbox: list = []
        with self._sent_on_fault(outbox), self.node.lock:
            self._new_height_locked(outbox)
        self._send_all(outbox)
        # Gossip that arrived before start() sits in the backlog (dedup
        # marked it seen on arrival): replay it into the fresh machine.
        self._drain_backlog()

    def stop(self) -> None:
        self._stopped = True
        for t in self._timers:
            t.cancel()
        # A timer that was already firing may be mid-send: wait it out so
        # no thread outlives the node (interpreter-exit safety).
        for t in self._timers:
            if t.is_alive():
                t.join(timeout=5.0)
        if self.wal is not None:
            self.wal.close()

    def _new_height_locked(self, outbox: list) -> None:
        node = self.node
        height = node.app.height + 1
        validators = node._validator_set()
        order = sorted(validators)
        if order:
            # Rotate by height so the height-H round-0 proposer matches the
            # push plane's is_proposer rotation shape.
            shift = (height - 1) % len(order)
            order = order[shift:] + order[:shift]
        locked_round, locked_value = -1, None
        sign_guard = None
        if self.wal is not None:
            restored = self.wal.lock_for(height)
            if restored is not None:
                locked_round, locked_value = restored
            sign_guard = self.wal.may_sign
            # Prune in batches: prune() rewrites + fsyncs the whole
            # journal, which must not run on every height transition
            # under the node lock (appends stay cheap in between).
            if height % 128 == 0:
                self.wal.prune(height - 2)
        self.machine = RoundMachine(
            node.chain_id, height, validators, order or ["<none>"],
            my_address=node._operator_address(),
            my_key=node.validator_key,
            timeouts=self.timeouts,
            sign_guard=sign_guard,
            locked_value=locked_value,
            locked_round=locked_round,
            # One round_journal row per (height, round), fsync time from
            # the WAL's cumulative counter (trace/ pulls the table).
            journal=RoundJournal(
                fsync_ms_source=(
                    (lambda: self.wal.fsync_ms_total)
                    if self.wal is not None else None
                ),
            ),
        )
        self.valsets[height] = validators
        for h in [h for h in self.valsets if h < height - 128]:
            del self.valsets[h]
        self._execute_locked(self.machine.start(), outbox)

    # --- effect execution (under lock) -------------------------------------
    def _execute_locked(self, effects: list, outbox: list) -> None:
        for e in effects:
            if isinstance(e, BroadcastVote):
                outbox.append({
                    "kind": "vote",
                    "height": e.vote.height,
                    "vote": e.vote.marshal().hex(),
                })
            elif isinstance(e, BroadcastProposal):
                p = e.proposal
                payload = self.payloads[p.block_hash]
                outbox.append({
                    "kind": "proposal",
                    "height": p.height,
                    "round": p.round,
                    "pol_round": p.pol_round,
                    "proposer": p.proposer,
                    "signature": p.signature.hex(),
                    "block_hash": p.block_hash.hex(),
                    "block": {
                        "time_ns": payload["time_ns"],
                        "data_hash": payload["data"].hash.hex(),
                        "square_size": payload["data"].square_size,
                        "txs": [t.hex() for t in payload["data"].txs],
                    },
                    "last_commit": payload["last_commit"],
                    "evidence": payload["evidence"],
                })
            elif isinstance(e, ScheduleTimeout):
                self._schedule(e)
            elif isinstance(e, RequestProposal):
                self._propose_locked(e, outbox)
            elif isinstance(e, Decided):
                self._commit_decided_locked(e)
            elif isinstance(e, EvidenceFound):
                eq = e.equivocation
                if eq.key() not in self.node._used_evidence:
                    self.evidence_pool.append(eq)
            elif isinstance(e, Locked):
                if self.wal is not None:
                    self.wal.record_lock(
                        self.machine.height, e.round, e.block_hash
                    )

    def _schedule(self, t: ScheduleTimeout) -> None:
        if self._stopped or self.machine is None:
            return  # a Decided earlier in the same effect list ended the height
        height = self.machine.height
        timer = threading.Timer(
            t.delay, self._fire_timeout, args=(height, t.round, t.step)
        )
        timer.daemon = True
        timer.start()
        self._timers.append(timer)
        # Bound the list (fired timers linger otherwise).
        if len(self._timers) > 256:
            self._timers = [x for x in self._timers if x.is_alive()]

    def _fire_timeout(self, height: int, round: int, step: str) -> None:
        if self._stopped:
            return
        outbox: list = []
        with self._sent_on_fault(outbox), self.node.lock:
            m = self.machine
            if m is None or m.height != height or m.decided is not None:
                return  # stale: the height moved on
            self._execute_locked(m.on_timeout(round, step), outbox)
        self._send_all(outbox)

    def _propose_locked(self, req: RequestProposal, outbox: list) -> None:
        """Build (or reuse) the block for our proposer turn."""
        node = self.node
        height = self.machine.height
        if req.block_hash != NIL and req.block_hash in self.payloads:
            # Re-propose the valid value from an earlier polka, unchanged.
            bid = req.block_hash
        else:
            from celestia_app_tpu_torch.testutil.testnode import BLOCK_INTERVAL_NS
            from celestia_app_tpu_torch.trace.context import trace_span, use_context

            time_ns = node.app.last_block_time_ns + BLOCK_INTERVAL_NS
            reaped = node.mempool.reap(node.block_max_bytes())
            # The block adopts the first reaped tx's submission trace so
            # one trace_id spans submit -> ... -> DAH -> commit; the round
            # journal rows for this height carry it too.
            block_ctx = node._block_trace_context(reaped, height)
            if self.machine.journal is not None:
                self.machine.journal.trace_id = block_ctx.trace_id
            with use_context(block_ctx), trace_span(
                "block_propose", layer="consensus", e2e="propose",
                height=height, round=req.round, n_txs=len(reaped),
            ):
                data = node.app.prepare_proposal(reaped)
                if not node.app.process_proposal(data):
                    raise AssertionError("node rejected its own proposal")
            prev_commit = node._commits.get(height - 1)
            evidence = [
                eq for eq in self.evidence_pool
                if eq.key() not in node._used_evidence
            ]
            bid = block_id(data.hash, node.app.cms.last_app_hash, time_ns)
            self.payloads[bid] = {
                "data": data,
                "time_ns": time_ns,
                "last_commit": (
                    prev_commit.to_json() if prev_commit is not None else None
                ),
                "evidence": node._evidence_to_wire(tuple(evidence)),
            }
        self._execute_locked(self.machine.on_own_proposal(bid), outbox)

    def _commit_decided_locked(self, d: Decided) -> None:
        node = self.node
        m = self.machine
        payload = self.payloads[d.block_hash]
        data: BlockData = payload["data"]
        time_ns: int = payload["time_ns"]
        last_commit = payload["last_commit"]
        signers = (
            {
                Vote.unmarshal(bytes.fromhex(v)).validator
                for v in last_commit["precommits"]
            }
            if last_commit is not None
            else None
        )
        evidence = node._parse_evidence(payload["evidence"] or [])
        prev_app_hash = node.app.cms.last_app_hash
        fault = None
        try:
            node._commit_block_data(
                data, time_ns, last_commit_signers=signers, evidence=evidence
            )
        except DeviceFault as e:
            # The block is applied and committed (the fault came from the
            # recheck or the serve retention after them): record it and
            # move to the next height before the fault goes out.
            fault = e
        record = Commit(
            m.height, d.block_hash, d.precommits, data.hash, prev_app_hash,
            round=d.round, time_ns=time_ns,
        )
        node._commits[m.height] = record
        for eq in evidence:
            node._used_evidence.add(eq.key())
        self.evidence_pool = [
            eq for eq in self.evidence_pool
            if eq.key() not in node._used_evidence
        ]
        self.payloads.clear()
        self.machine = None
        if not self._stopped:
            timer = threading.Timer(self.interval_s, self._start_next_height)
            timer.daemon = True
            timer.start()
            self._timers.append(timer)
        if fault is not None:
            raise fault

    def _start_next_height(self) -> None:
        if self._stopped:
            return
        outbox: list = []
        with self._sent_on_fault(outbox), self.node.lock:
            if self.machine is None:
                self._new_height_locked(outbox)
        self._send_all(outbox)
        self._drain_backlog()

    def _drain_backlog(self) -> None:
        """Replay gap-buffered messages (already dedup-marked, so they
        bypass handle())."""
        with self.node.lock:
            backlog, self.backlog = self.backlog, []
            current = self.machine.height if self.machine else 0
        fault = None
        for msg in backlog:
            if int(msg.get("height", 0)) >= current:
                try:
                    self._process(msg)
                except ConsensusError:
                    pass
                except DeviceFault as e:
                    fault = fault or e
        if fault is not None:
            raise fault

    @contextmanager
    def _sent_on_fault(self, outbox: list):
        """Send `outbox` when the body raises a DeviceFault (entered before
        the node lock, so the send runs after its release): the effects
        decided before the fault, this validator's votes among them, still
        reach the peers."""
        try:
            yield
        except DeviceFault:
            self._send_all(outbox)
            raise

    #: Re-relay fan-out cap.  The ORIGINATOR of a message already sends it
    #: to every peer directly (full one-hop coverage on healthy links);
    #: receiver relays exist to route around dead/slow links, so a small
    #: deterministic subset suffices — without the cap the flood costs
    #: O(n^2) sends per message, which drowns large devnets (the
    #: reference's gossip also maintains a bounded peer set, not a clique).
    RELAY_FANOUT = 6

    # --- ingress -----------------------------------------------------------
    def handle(self, msg: dict) -> dict:
        """rpc_consensus: dedup, authenticate, relay, process."""
        from celestia_app_tpu_torch.trace.metrics import registry

        kind = str(msg.get("kind", "unknown"))
        registry().counter(
            "celestia_gossip_msgs_total", "consensus gossip messages"
        ).inc(kind=kind, direction="in")
        msg_id = self._msg_id(msg)
        with self.node.lock:
            if msg_id in self.seen:
                registry().counter(
                    "celestia_gossip_dedup_hits_total",
                    "gossip messages dropped as already-seen (flood termination)",
                ).inc(kind=kind)
                return {"ok": True, "dup": True}
            self.seen[msg_id] = int(msg.get("height", 0) or 0)
            if len(self.seen) > 100_000:
                cur = self.machine.height if self.machine else self.node.app.height
                # Normal case: drop long-committed heights.  The claimed
                # height is attacker-controlled, so this alone is not a
                # bound — if a flood pins heights inside the live window,
                # fall back to the hard clear() (dedup re-warms quickly);
                # without it every further message pays an O(n) rebuild
                # under the lock and memory grows without limit.
                pruned = {
                    i: h for i, h in self.seen.items() if cur - 2 <= h <= cur + 64
                }
                self.seen = pruned if len(pruned) <= 90_000 else {msg_id: 0}
        # Relay outside the lock (flood; dedup terminates it) — but only
        # AFTER wire-level authentication: dedup cannot bound an
        # unauthenticated sender (every mutated junk copy hashes to a
        # fresh id), so unverified bytes must never fan out mesh-wide.
        if self._wire_verify(msg):
            self.node.gossip_pool.submit(self._relay, msg)
        # Cross-node propagation: ADOPT the sender's trace stamped on the
        # envelope (rpc/transport.deliver) — same trace_id, fresh
        # span_id, this node's node_id — so consensus spans on every hop
        # of the flood stitch under the originator's trace.
        from celestia_app_tpu_torch.trace.context import adopt_context, use_context

        trace_ctx = adopt_context(msg.get("trace"))
        try:
            if trace_ctx is not None:
                with use_context(trace_ctx):
                    self._process(msg)
            else:
                self._process(msg)
        except ConsensusError:
            return {"ok": False}
        return {"ok": True}

    def _wire_verify(self, msg: dict) -> bool:
        """Authenticate a message against the best-known validator set
        WITHOUT applying it — the relay admission check.  A message that
        fails (malformed, unknown signer, bad signature) is still handed
        to _process (a backlogged future-height message may verify once
        the valset catches up) but is not re-relayed by THIS node; the
        originator already sent it to every peer directly."""
        try:
            with self.node.lock:
                m = self.machine
                vals = (
                    dict(m.validators)
                    if m is not None
                    else self.node._validator_set()
                )
            kind = msg.get("kind")
            if kind == "vote":
                vote = Vote.unmarshal(bytes.fromhex(msg["vote"]))
                entry = vals.get(vote.validator)
                return entry is not None and vote.verify(
                    entry[0], self.node.chain_id
                )
            if kind == "proposal":
                prop = Proposal(
                    int(msg["height"]), int(msg["round"]),
                    bytes.fromhex(msg["block_hash"]), int(msg["pol_round"]),
                    msg["proposer"], bytes.fromhex(msg["signature"]),
                )
                entry = vals.get(prop.proposer)
                if entry is None or not entry[0].verify(
                    prop.sign_bytes(self.node.chain_id), prop.signature
                ):
                    return False
                # The proposal signature does NOT cover the block payload
                # (only the signed block id binds it): without this check a
                # tampered-payload copy of one honest proposal hashes to a
                # fresh msg id yet still carries a valid signature — an
                # unbounded relay flood of full block bytes.  Conservative
                # on purpose: proposals for heights whose prev app hash we
                # don't hold locally are not re-relayed (the originator
                # already reached every peer one hop).
                block = msg.get("block") or {}
                try:
                    bid = block_id(
                        bytes.fromhex(block["data_hash"]),
                        self.node.app.cms.last_app_hash,
                        int(block["time_ns"]),
                    )
                except (KeyError, ValueError):
                    return False
                return bid == prop.block_hash
            return False
        except (KeyError, ValueError, TypeError):
            return False

    @staticmethod
    def _msg_id(msg: dict) -> tuple:
        # The PAYLOAD is part of a proposal's identity: the proposal
        # signature does not cover the block bytes (the signed block id
        # does, indirectly), so without this a tampered relay copy would
        # dedup-block the genuine message mesh-wide and censor an honest
        # proposal.  Shared with the chaos drills via rpc/transport.py.
        from celestia_app_tpu_torch.rpc import transport

        return transport.msg_id(msg)

    def _process(self, msg: dict) -> None:
        node = self.node
        height = int(msg.get("height", 0))
        # A node that discovers it is behind catches up from the block
        # store first (outside the machine), then restarts its machine.
        with node.lock:
            behind = self.machine is not None and height > self.machine.height
        if behind:
            try:
                node._catch_up(height - 1)
            except ValueError:
                pass  # peers can't serve yet; the message may still apply
        outbox: list = []
        with self._sent_on_fault(outbox), node.lock:
            m = self.machine
            if m is None:
                # Between heights: keep for replay at the next start.
                if height >= node.app.height + 1 and len(self.backlog) < 1000:
                    self.backlog.append(msg)
                return
            if m.height < node.app.height + 1:
                # Blocks were applied behind this machine's back (catch-up):
                # drop the stale machine and start at the new height.
                self._new_height_locked(outbox)
                m = self.machine
            if height != m.height:
                if height > m.height and len(self.backlog) < 1000:
                    self.backlog.append(msg)
                self._send_all_later(outbox)
                return
            if msg["kind"] == "vote":
                vote = Vote.unmarshal(bytes.fromhex(msg["vote"]))
                self._execute_locked(m.on_vote(vote), outbox)
            elif msg["kind"] == "proposal":
                prop = Proposal(
                    height, int(msg["round"]), bytes.fromhex(msg["block_hash"]),
                    int(msg["pol_round"]), msg["proposer"],
                    bytes.fromhex(msg["signature"]),
                )
                if not m.verify_proposal(prop):
                    # Unauthenticated garbage (forged signature, wrong
                    # proposer): DROP.  Feeding it to the machine as an
                    # invalid proposal would let any unauthenticated
                    # sender draw a nil prevote per round — a liveness
                    # DoS against an honest proposer.
                    return
                verdict = self._validate_payload(prop, msg)
                if verdict is None:
                    # Payload does not match the SIGNED block id (a
                    # tampered relay copy, or this node's state diverged):
                    # not the proposer's content — drop and let the
                    # propose timeout govern, never blame the proposer.
                    return
                self._execute_locked(m.on_proposal(prop, verdict), outbox)
        self._send_all(outbox)

    def _validate_payload(self, prop: Proposal, msg: dict) -> bool | None:
        """Block-level validation under the node lock.

        Returns True (prevote it), False (the proposer's own signed
        content is invalid: nil prevote), or None (the payload is NOT
        what the proposer signed — tampered relay copy or local state
        divergence — so drop without judging the proposer; the signed
        block id binds data root, prev app hash, and time, which is what
        separates the two cases).  A DeviceFault of the speculation or of
        process_proposal raises: no verdict, nothing stored."""
        node = self.node
        block = msg.get("block") or {}
        try:
            data = BlockData(
                txs=tuple(bytes.fromhex(t) for t in block["txs"]),
                square_size=int(block["square_size"]),
                hash=bytes.fromhex(block["data_hash"]),
            )
            time_ns = int(block["time_ns"])
        except (KeyError, ValueError):
            return None  # malformed relay copy, not the proposer's content
        if block_id(data.hash, node.app.cms.last_app_hash, time_ns) != prop.block_hash:
            return None
        if time_ns <= node.app.last_block_time_ns:
            return False  # block time must advance (BFT time monotonicity)
        # The prevote window's speculative extend (the speculation seam's
        # round-machine call site, $CELESTIA_PIPE_SPECULATE): the payload is the
        # proposer's signed content, so enqueue the square's extension NOW
        # — the device dispatch runs across the LastCommit signature batch
        # and ante validation below, and process_proposal's root check
        # claims the finished result.  A round change re-proposing
        # different bytes makes the next compute() DISCARD the claim
        # (da.eds.speculator().outcomes["discard"]).
        node.app.speculate_proposal(data, height=prop.height,
                                    round_=prop.round)
        # LastCommit: required after height 1; must attest the block id
        # this node itself committed at H-1 (its own stored record — NOT a
        # driver-local cache, which goes stale when heights apply via
        # block-store catch-up) and verify against the validator set that
        # height ran under.
        last_commit = msg.get("last_commit")
        if prop.height > 1:
            if last_commit is None:
                return False
            try:
                rec = Commit.from_json(last_commit)
            except (KeyError, ValueError):
                return False
            if rec.height != prop.height - 1:
                return False
            own = node._commits.get(prop.height - 1)
            if own is not None and rec.block_hash != own.block_hash:
                return False
            prev_vals = self.valsets.get(prop.height - 1)
            if prev_vals is None:
                # No machine ran at H-1 here (catch-up gap): the block
                # store keeps the set every committed height ran under, so
                # a freshly caught-up node verifies the H-1 precommits
                # against the right set even across a jailing boundary.
                prev_vals = getattr(node, "_valsets_by_height", {}).get(
                    prop.height - 1
                )
            if prev_vals is None:
                # Height H-1 predates this node entirely (state sync): the
                # current bonded set is the last-resort approximation.
                prev_vals = self.machine.validators
            if not verify_commit(prev_vals, node.chain_id, rec):
                return False
        elif last_commit is not None:
            return False
        if not node.app.process_proposal(data):
            return False
        self.payloads[prop.block_hash] = {
            "data": data,
            "time_ns": time_ns,
            "last_commit": last_commit,
            "evidence": msg.get("evidence") or [],
        }
        return True

    # --- egress ------------------------------------------------------------
    def _relay(self, msg: dict) -> None:
        """Re-relay a received message to a bounded peer subset.

        The subset is derived from the MESSAGE id, so each message takes
        a different window — a link missed by one message's window is
        covered by the next's, and a lost individual message is healed by
        the round machine (timeout -> next round) or height catch-up.
        Full coverage per message is only guaranteed one hop from the
        originator (which sends to every peer); partial topologies with
        node degree above the fan-out trade per-message delivery
        certainty for bounded flood cost, exactly like the reference's
        bounded peer set."""
        peers = self.node.peers()
        if len(peers) > self.RELAY_FANOUT:
            import hashlib as _hashlib

            start = _hashlib.sha256(repr(self._msg_id(msg)).encode()).digest()[0]
            start %= len(peers)
            peers = [
                peers[(start + i) % len(peers)]
                for i in range(self.RELAY_FANOUT)
            ]
        if self.latency_s or self.jitter_s:
            # One pool task per peer: a serial sleep-per-peer loop would
            # park a gossip worker for fanout x latency per message.
            for peer in peers:
                self.node.gossip_pool.submit(self._send_to, peer, [msg])
            return
        for peer in peers:
            self._send_to(peer, [msg])

    def _send_all(self, msgs: list) -> None:
        """Originator broadcast: every peer, full coverage."""
        if not msgs:
            return
        peers = self.node.peers()
        from celestia_app_tpu_torch.trace.metrics import registry

        registry().gauge(
            "celestia_gossip_peers", "configured gossip peer count"
        ).set(len(peers))
        if self.latency_s or self.jitter_s:
            # Per-peer fan-out so injected latency costs one delay, not
            # one per link (a real network delays links in parallel).
            for peer in peers:
                self.node.gossip_pool.submit(self._send_to, peer, list(msgs))
            return
        for peer in peers:
            self._send_to(peer, msgs)

    #: Bounded per-peer send retries: a blip on one link costs a short
    #: backoff instead of relying solely on the round machine's timeouts
    #: to route around it.  Final failure still falls back to the flood
    #: (the relay mesh + catch-up heal lost messages).  Delivery itself —
    #: chaos seam, retry gate, failure streaks — lives in rpc/transport.py
    #: (crypto-free, so the chaos drills exercise it without the signing
    #: stack).
    SEND_RETRIES = 2

    def _send_to(self, peer, msgs: list) -> None:
        import time as _time

        from celestia_app_tpu_torch.rpc import transport
        from celestia_app_tpu_torch.trace.metrics import registry

        sent = registry().counter(
            "celestia_gossip_msgs_total", "consensus gossip messages"
        )
        key = getattr(peer, "url", None) or id(peer)
        for msg in msgs:
            sent.inc(kind=str(msg.get("kind", "unknown")), direction="out")
            if self.latency_s or self.jitter_s:
                jitter = 0.0
                if self.jitter_s:
                    import hashlib as _hashlib

                    digest = _hashlib.sha256(repr(msg).encode()).digest()
                    jitter = self.jitter_s * digest[0] / 255.0
                _time.sleep(self.latency_s + jitter)
            transport.deliver(
                peer.consensus, msg, streak=self._peer_fail_streak,
                key=key, retries=self.SEND_RETRIES,
            )

    def _send_all_later(self, msgs: list) -> None:
        if msgs:
            self.node.gossip_pool.submit(self._send_all, msgs)
