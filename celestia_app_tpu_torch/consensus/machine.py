"""The Tendermint round state machine: round changes, nil votes, locking.

Parity target: celestia-core's consensus (Tendermint v0.34 — SURVEY §1 L1),
whose defining property a single-round plane lacks: a crashed or faulty
proposer must not halt the chain.  The algorithm
follows the Tendermint consensus paper (arXiv:1807.04938, Algorithm 1) —
the same pseudocode celestia-core implements:

  * proposer rotation per (height, round);
  * propose / prevote / precommit steps with per-step timeouts that grow
    with the round number;
  * nil prevotes when no acceptable proposal arrives in time;
  * polka locking: +2/3 prevotes for a block in round r lock this
    validator on that block (it refuses to prevote anything else in later
    rounds unless a NEWER polka justifies unlocking — the safety rule);
  * a commit happens in whichever round first gathers +2/3 precommits for
    a block; all later rounds for that height stop.

Design: the machine is PURE — no sockets, no threads, no clocks.  Inputs
are events (`start`, `on_proposal`, `on_vote`, `on_timeout`); the output
of every input is a list of Effects (votes/proposals to broadcast,
timeouts to schedule, a proposal request, evidence, a decision).  The
serving plane (rpc/server.py) owns IO: it feeds gossip into the machine
and executes the effects.  This splits consensus correctness
(deterministically testable, tests/test_round_machine.py) from transport.

Vote verification happens inside the machine via the validator map
(address -> (PublicKey, power)); equivocations surface as EvidenceFound
effects for the slashing pipeline (modules/slashing).

The port's copy of celestia_app_tpu/consensus/machine.py, whole: the same
keys and deliveries give the same effects, in type, fields, sign bytes and
signatures (tests/test_torch_consensus.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from celestia_app_tpu_torch.consensus.votes import (
    NIL,
    PRECOMMIT,
    PREVOTE,
    ConsensusError,
    Equivocation,
    Vote,
)

# Round observability (one round_journal trace row per (height, round)).
# Defined under trace/ so slim images load it without the signing stack;
# re-exported here because it is part of the machine's construction API.
from celestia_app_tpu_torch.trace.round_journal import RoundJournal

# Steps within a round.
PROPOSE, PREVOTE_STEP, PRECOMMIT_STEP = "propose", "prevote", "precommit"

# Default timeouts (seconds) and their per-round growth — celestia-core's
# config shape (TimeoutPropose + TimeoutProposeDelta etc.); devnets scale
# them down via RoundMachine(timeouts=...).
DEFAULT_TIMEOUTS = {
    PROPOSE: (3.0, 0.5),
    PREVOTE_STEP: (1.0, 0.5),
    PRECOMMIT_STEP: (1.0, 0.5),
}


@dataclass(frozen=True)
class Proposal:
    """A signed proposal for (height, round).

    `block_hash` is the block id votes target; `pol_round` (proof-of-lock
    round) is the round of the polka that justifies re-proposing a value
    from an earlier round, or -1 for a fresh proposal.  The block payload
    itself (BlockData) travels alongside in gossip, keyed by block_hash —
    the machine only reasons about ids.
    """

    height: int
    round: int
    block_hash: bytes
    pol_round: int
    proposer: str
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        from celestia_app_tpu_torch.encoding.proto import (
            encode_bytes_field,
            encode_varint_field,
        )

        return (
            encode_bytes_field(1, b"celestia-tpu/proposal")
            + encode_bytes_field(2, chain_id.encode())
            + encode_varint_field(3, self.height)
            + encode_varint_field(4, self.round)
            + encode_bytes_field(5, self.block_hash)
            + encode_varint_field(6, self.pol_round + 1)  # -1 -> 0
            + encode_bytes_field(7, self.proposer.encode())
        )


# --------------------------------------------------------------------------
# Effects: what the driver must do after feeding an event.
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class BroadcastVote:
    """Gossip this vote to the peers (the machine already counted it)."""

    vote: Vote


@dataclass(frozen=True)
class BroadcastProposal:
    """Gossip this (own) proposal + its block payload to the peers."""

    proposal: Proposal


@dataclass(frozen=True)
class ScheduleTimeout:
    """Arrange on_timeout(round, step) to fire after `delay` seconds
    unless the height moves on first."""

    round: int
    step: str
    delay: float


@dataclass(frozen=True)
class RequestProposal:
    """This node proposes for (round): build a block (or reuse
    `block_hash` if not NIL — the valid value from an earlier polka) and
    feed it back via on_own_proposal."""

    round: int
    block_hash: bytes  # NIL => build a fresh block
    pol_round: int


@dataclass(frozen=True)
class Decided:
    """+2/3 precommits for `block_hash` in `round`: commit it."""

    round: int
    block_hash: bytes
    precommits: tuple[Vote, ...]


@dataclass(frozen=True)
class EvidenceFound:
    equivocation: Equivocation


@dataclass(frozen=True)
class Locked:
    """This validator just locked on a value (drivers journal it to the
    WAL so a restart resumes with the lock — cross-round safety)."""

    round: int
    block_hash: bytes


class RoundTally:
    """All votes of one type for one (height, round): per-block-id power
    tally including nil, with equivocation capture.

    Unlike VoteSet (single target, used for commit verification), the
    tally accepts any target — Tendermint counts a validator once per
    (round, type); a second, conflicting vote is evidence and does not
    change the count (first vote wins, as in celestia-core's VoteSet).
    """

    def __init__(self, chain_id, height, round, vote_type, validators):
        self.chain_id = chain_id
        self.height = height
        self.round = round
        self.vote_type = vote_type
        self.validators = validators
        self.votes: dict[str, Vote] = {}  # validator -> first vote
        self.evidence: list[Equivocation] = []

    def add(self, vote: Vote) -> bool:
        """Count a verified vote; returns True if it was new.  Raises
        ConsensusError for votes that cannot be counted (unknown
        validator, bad signature, wrong coordinates)."""
        if (
            vote.height != self.height
            or vote.round != self.round
            or vote.vote_type != self.vote_type
        ):
            raise ConsensusError(
                f"vote for h{vote.height}/r{vote.round}/t{vote.vote_type} fed "
                f"to tally h{self.height}/r{self.round}/t{self.vote_type}"
            )
        entry = self.validators.get(vote.validator)
        if entry is None:
            raise ConsensusError(f"vote from non-validator {vote.validator}")
        if not vote.verify(entry[0], self.chain_id):
            raise ConsensusError(f"bad vote signature from {vote.validator}")
        prior = self.votes.get(vote.validator)
        if prior is not None:
            if prior.block_hash != vote.block_hash:
                self.evidence.append(Equivocation(prior, vote))
            return False
        self.votes[vote.validator] = vote
        return True

    def _power(self, pred) -> int:
        return sum(
            self.validators[v][1] for v, vote in self.votes.items() if pred(vote)
        )

    def total_power(self) -> int:
        return sum(p for _, p in self.validators.values())

    def power_for(self, block_hash: bytes) -> int:
        return self._power(lambda v: v.block_hash == block_hash)

    def power_any(self) -> int:
        return self._power(lambda v: True)

    def has_two_thirds_for(self, block_hash: bytes) -> bool:
        return 3 * self.power_for(block_hash) > 2 * self.total_power()

    def has_two_thirds_any(self) -> bool:
        """+2/3 voted in this round, not necessarily for one value."""
        return 3 * self.power_any() > 2 * self.total_power()

    def has_one_third_any(self) -> bool:
        """>1/3 voted in this round (at least one honest validator there)."""
        return 3 * self.power_any() > self.total_power()

    def two_thirds_value(self) -> bytes | None:
        """The block id (or NIL) holding +2/3, if any."""
        for bh in {v.block_hash for v in self.votes.values()}:
            if self.has_two_thirds_for(bh):
                return bh
        return None

    def votes_for(self, block_hash: bytes) -> tuple[Vote, ...]:
        return tuple(
            v for v in self.votes.values() if v.block_hash == block_hash
        )


class RoundMachine:
    """One height's consensus instance for one validator.

    Drivers construct it at each new height, call `start()`, feed
    `on_proposal` / `on_vote` / `on_timeout` / `on_own_proposal`, execute
    the returned effects, and tear it down once a `Decided` effect is
    handled.  A node without a bonded validator key participates as an
    observer: it tallies votes and decides, but never signs (my_key=None).

    The driver's contract per event:
      * on_proposal: the driver MUST first call verify_proposal (wire
        checks) and validate the block payload (ProcessProposal), passing
        the verdict as `valid`;
      * on_vote: feed any gossiped vote; ConsensusError means drop it;
      * on_timeout: fire ScheduleTimeout effects after their delay, at
        most once each, only while the machine is still at that height.
    """

    def __init__(
        self,
        chain_id: str,
        height: int,
        validators: dict,  # address -> (PublicKey, power)
        proposer_order: list[str],  # rotation: proposer for round r = order[r % n]
        my_address: str | None = None,
        my_key=None,
        timeouts: dict | None = None,
        sign_guard=None,  # f(height, round, type, block_hash) -> bool (WAL)
        locked_value: bytes | None = None,
        locked_round: int = -1,
        journal: RoundJournal | None = None,
    ):
        self.chain_id = chain_id
        self.height = height
        self.validators = validators
        self.proposer_order = proposer_order
        self.my_address = my_address
        self.my_key = my_key
        self.timeouts = timeouts or DEFAULT_TIMEOUTS
        # The double-sign gate (consensus/wal.py): consulted before every
        # own signature; False => this validator already signed something
        # conflicting for these coordinates (possibly before a restart).
        self.sign_guard = sign_guard
        # Round observability (one round_journal row per (height, round));
        # None keeps the machine journal-free for pure-logic tests.
        self.journal = journal

        self.round = 0
        self.step = PROPOSE
        # Lock state may be restored from the WAL on restart: safety
        # requires honoring a pre-crash lock in later rounds.
        self.locked_value = locked_value
        self.locked_round = locked_round
        self.valid_value: bytes | None = None
        self.valid_round = -1
        self.decided: Decided | None = None

        # round -> VALID Proposal (driver validated the block payload);
        # rounds whose proposal failed validation are tracked separately
        # (their only effect: an immediate nil prevote at entry).
        self.proposals: dict[int, Proposal] = {}
        self._invalid_rounds: set[int] = set()
        self.prevotes: dict[int, RoundTally] = {}
        self.precommits: dict[int, RoundTally] = {}
        # fire-once keys for the paper's "for the first time" rules
        self._fired: set = set()

    # --- plumbing ----------------------------------------------------------
    def proposer(self, round: int) -> str:
        return self.proposer_order[round % len(self.proposer_order)]

    def _tally(self, table: dict, round: int, vote_type: int) -> RoundTally:
        t = table.get(round)
        if t is None:
            t = table[round] = RoundTally(
                self.chain_id, self.height, round, vote_type, self.validators
            )
        return t

    def _timeout(self, step: str, round: int) -> ScheduleTimeout:
        base, delta = self.timeouts[step]
        return ScheduleTimeout(round, step, base + delta * round)

    def _set_step(self, step: str) -> None:
        self.step = step
        if self.journal is not None:
            self.journal.record_step(self, step)

    def _vote(self, vote_type: int, block_hash: bytes, effects: list) -> None:
        """Sign, self-count, and broadcast a vote (no-op for observers;
        refused by the sign guard if these coordinates were already
        signed differently — the WAL's double-sign protection)."""
        if self.my_key is None or self.my_address not in self.validators:
            return
        if self.sign_guard is not None and not self.sign_guard(
            self.height, self.round, vote_type, block_hash
        ):
            return
        vote = Vote.sign(
            self.my_key, self.chain_id, self.height, vote_type, block_hash,
            validator=self.my_address, round=self.round,
        )
        table = self.prevotes if vote_type == PREVOTE else self.precommits
        self._tally(table, self.round, vote_type).add(vote)
        effects.append(BroadcastVote(vote))

    # --- the algorithm -----------------------------------------------------
    def start(self) -> list:
        """StartRound(0)."""
        return self._start_round(0)

    def _start_round(self, round: int) -> list:
        if self.journal is not None and round > self.round:
            # The previous round failed to decide; journal it on the way out.
            self.journal.close_round(self, "round_bump")
        self.round = round
        self.step = PROPOSE
        if self.journal is not None:
            self.journal.open_round(self)
        effects: list = []
        if self.my_address == self.proposer(round) and self.my_key is not None:
            effects.append(
                RequestProposal(
                    round,
                    self.valid_value if self.valid_value is not None else NIL,
                    self.valid_round,
                )
            )
        else:
            effects.append(self._timeout(PROPOSE, round))
        # Re-apply anything that arrived early for this round.
        effects += self._check_rules()
        return effects

    def on_own_proposal(self, block_hash: bytes) -> list:
        """The driver built (or fetched, for a valid_value re-proposal)
        the block answering RequestProposal.  Emits the gossip effect and
        processes the proposal locally (the driver built it => valid)."""
        assert self.my_key is not None
        unsigned = Proposal(
            self.height, self.round, block_hash, self.valid_round,
            self.my_address,
        )
        prop = Proposal(
            unsigned.height, unsigned.round, unsigned.block_hash,
            unsigned.pol_round, unsigned.proposer,
            self.my_key.sign(unsigned.sign_bytes(self.chain_id)),
        )
        return [BroadcastProposal(prop)] + self.on_proposal(prop, valid=True)

    def verify_proposal(self, prop: Proposal) -> bool:
        """Wire-level checks the driver runs before block validation:
        right height, from the round's proposer, signature valid."""
        if prop.height != self.height or prop.proposer != self.proposer(prop.round):
            return False
        entry = self.validators.get(prop.proposer)
        if entry is None:
            return False
        return entry[0].verify(prop.sign_bytes(self.chain_id), prop.signature)

    def on_proposal(self, prop: Proposal, valid: bool) -> list:
        """A proposal for (height, round), wire-verified by the driver,
        with the driver's block-validation verdict.  An invalid proposal
        still advances the step — with a nil prevote (the paper's
        `valid(v)` guard)."""
        if self.decided is not None:
            return []
        if valid:
            self.proposals.setdefault(prop.round, prop)
        else:
            self._invalid_rounds.add(prop.round)
        return self._check_rules()

    def on_vote(self, vote: Vote) -> list:
        """A gossiped vote.  Returns effects; raises ConsensusError for
        uncountable votes (driver drops them)."""
        if self.decided is not None:
            return []
        if vote.height != self.height:
            raise ConsensusError(
                f"vote for height {vote.height}, machine at {self.height}"
            )
        table = self.prevotes if vote.vote_type == PREVOTE else self.precommits
        tally = self._tally(table, vote.round, vote.vote_type)
        n_evidence = len(tally.evidence)
        fresh = tally.add(vote)
        effects: list = [
            EvidenceFound(ev) for ev in tally.evidence[n_evidence:]
        ]
        if not fresh:
            return effects
        # Round catch-up (paper line 55): >1/3 voting in a later round
        # means at least one honest validator moved on — follow.
        if vote.round > self.round and tally.has_one_third_any():
            effects += self._start_round(vote.round)
            return effects
        effects += self._check_rules()
        return effects

    def on_timeout(self, round: int, step: str) -> list:
        """A ScheduleTimeout fired (driver filters stale heights)."""
        if self.decided is not None:
            return []
        effects: list = []
        if step == PROPOSE and round == self.round and self.step == PROPOSE:
            # No acceptable proposal in time: prevote nil (paper line 57).
            self._journal_timeout(round, step)
            self._vote(PREVOTE, NIL, effects)
            self._set_step(PREVOTE_STEP)
            effects += self._check_rules()
        elif step == PREVOTE_STEP and round == self.round and self.step == PREVOTE_STEP:
            # Prevotes diverged (no polka in time): precommit nil (line 61).
            self._journal_timeout(round, step)
            self._vote(PRECOMMIT, NIL, effects)
            self._set_step(PRECOMMIT_STEP)
            effects += self._check_rules()
        elif step == PRECOMMIT_STEP and round == self.round:
            # The round failed to commit: move on (line 65).
            self._journal_timeout(round, step)
            effects += self._start_round(round + 1)
        return effects

    def _journal_timeout(self, round: int, step: str) -> None:
        if self.journal is not None:
            self.journal.record_timeout(self, round, step)

    # --- standing rules ----------------------------------------------------
    def _enter_prevote(self, effects: list) -> None:
        """The propose-step entry rules (paper lines 22 + 28), applied
        when a proposal for the current round is actionable."""
        r = self.round
        prop = self.proposals.get(r)
        if prop is None:
            if r in self._invalid_rounds:
                # Proposal arrived but its block failed validation.
                self._vote(PREVOTE, NIL, effects)
                self._set_step(PREVOTE_STEP)
            return
        if prop.pol_round == -1:
            acceptable = (
                self.locked_round == -1 or self.locked_value == prop.block_hash
            )
        elif 0 <= prop.pol_round < r:
            # A re-proposal acts only once its claimed polka is visible
            # (it may arrive after the proposal; _check_rules re-runs).
            polka = self._tally(self.prevotes, prop.pol_round, PREVOTE)
            if not polka.has_two_thirds_for(prop.block_hash):
                return
            acceptable = (
                self.locked_round <= prop.pol_round
                or self.locked_value == prop.block_hash
            )
        else:
            return  # malformed pol_round (>= own round): let the timeout run
        self._vote(PREVOTE, prop.block_hash if acceptable else NIL, effects)
        self._set_step(PREVOTE_STEP)

    def _check_rules(self) -> list:
        """The paper's standing 'upon' clauses.  Idempotent: fire-once
        rules are keyed in _fired; step transitions guard the rest."""
        effects: list = []
        if self.decided is not None:
            return effects
        r = self.round
        if self.step == PROPOSE:
            self._enter_prevote(effects)
        prevotes = self._tally(self.prevotes, r, PREVOTE)
        precommits_r = self._tally(self.precommits, r, PRECOMMIT)

        # Line 34: +2/3 prevotes (any mix) while at prevote step =>
        # schedule the prevote timeout once per round.
        key = ("prevote-any", r)
        if (
            self.step == PREVOTE_STEP
            and prevotes.has_two_thirds_any()
            and key not in self._fired
        ):
            self._fired.add(key)
            effects.append(self._timeout(PREVOTE_STEP, r))

        # Line 36: polka for a valid proposed block while step >= prevote
        # => lock it, precommit it, remember it as the valid value.
        prop = self.proposals.get(r)
        if prop is not None and self.step != PROPOSE:
            key = ("polka", r)
            if (
                key not in self._fired
                and prevotes.has_two_thirds_for(prop.block_hash)
            ):
                self._fired.add(key)
                if self.step == PREVOTE_STEP:
                    self.locked_value = prop.block_hash
                    self.locked_round = r
                    effects.append(Locked(r, prop.block_hash))
                    self._vote(PRECOMMIT, prop.block_hash, effects)
                    self._set_step(PRECOMMIT_STEP)
                self.valid_value = prop.block_hash
                self.valid_round = r

        # Line 44: polka for nil while at prevote step => precommit nil.
        if self.step == PREVOTE_STEP and prevotes.has_two_thirds_for(NIL):
            self._vote(PRECOMMIT, NIL, effects)
            self._set_step(PRECOMMIT_STEP)

        # Line 47: +2/3 precommits (any mix) => schedule precommit timeout.
        key = ("precommit-any", r)
        if precommits_r.has_two_thirds_any() and key not in self._fired:
            self._fired.add(key)
            effects.append(self._timeout(PRECOMMIT_STEP, r))

        # Line 49: +2/3 precommits for a block in ANY round => decide
        # (gated on holding the round's valid proposal => the driver has
        # the block payload; it arrives via on_proposal otherwise).
        for round_r, tally in self.precommits.items():
            value = tally.two_thirds_value()
            if value is None or value == NIL:
                continue
            prop_r = self.proposals.get(round_r)
            if prop_r is not None and prop_r.block_hash == value:
                self.decided = Decided(round_r, value, tally.votes_for(value))
                effects.append(self.decided)
                if self.journal is not None:
                    self.journal.close_round(self, "decided", round=round_r)
                break
        return effects
