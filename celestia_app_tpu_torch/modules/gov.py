"""Governance: the proposal lifecycle with celestia's paramfilter gate.

The reference runs cosmos-sdk x/gov v1 with celestia's overrides
(app/default_overrides.go:192-199: MinDeposit 10,000 TIA, MaxDepositPeriod
and VotingPeriod one week) and the paramfilter wrapped around the
param-change handler (x/paramfilter/gov_handler.go:36, blocklist wired at
app/app.go:739-750).  This module implements that lifecycle:

  submit (escrow initial deposit) -> DEPOSIT_PERIOD
    -> min deposit reached -> VOTING_PERIOD (one-week clock)
    -> end blocker tallies at voting end: quorum 33.4%, threshold 50% of
       non-abstain, veto 33.4% (sdk v1 tally defaults); deposits burned on
       quorum failure / veto / deposit-period expiry, refunded otherwise
       (sdk gov keeper/tally.go + abci.go semantics)
    -> PASSED proposals execute their param changes through the registry,
       re-checking the paramfilter blocklist at execution.

Voting follows sdk tally.go: any address votes (MsgVote or weighted
MsgVoteWeighted); delegators vote their own staked tokens directly, and a
bonded validator votes its remaining tokens — self-bond plus delegations
whose delegators did not override it (inherit-unless-overridden).  The
tally is token-weighted against total bonded tokens.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from enum import IntEnum
from fractions import Fraction
from typing import Callable

from celestia_app_tpu_torch.encoding.proto import (
    WIRE_LEN,
    WIRE_VARINT,
    decode_fields,
    encode_bytes_field,
    encode_varint_field,
)
from celestia_app_tpu_torch.modules.paramfilter import validate_param_changes
from celestia_app_tpu_torch.state.accounts import BankKeeper
from celestia_app_tpu_torch.state.dec import Dec
from celestia_app_tpu_torch.state.staking import StakingKeeper
from celestia_app_tpu_torch.state.store import KVStore

# Celestia genesis overrides (default_overrides.go:197-199).
DEFAULT_MIN_DEPOSIT = 10_000_000_000  # 10,000 TIA in utia
WEEK_NS = 7 * 24 * 3600 * 10**9
DEFAULT_MAX_DEPOSIT_PERIOD_NS = WEEK_NS
DEFAULT_VOTING_PERIOD_NS = WEEK_NS

# sdk x/gov v1 tally defaults (unchanged by celestia).
QUORUM = Fraction(334, 1000)
THRESHOLD = Fraction(1, 2)
VETO_THRESHOLD = Fraction(334, 1000)

GOV_MODULE = "gov"  # escrow account for deposits


class ProposalStatus(IntEnum):
    DEPOSIT_PERIOD = 1
    VOTING_PERIOD = 2
    PASSED = 3
    REJECTED = 4
    FAILED = 5  # passed the vote but the handler errored


class VoteOption(IntEnum):
    YES = 1
    ABSTAIN = 2
    NO = 3
    NO_WITH_VETO = 4


@dataclass(frozen=True)
class ParamChange:
    subspace: str
    key: str
    value: str


@dataclass(frozen=True)
class Proposal:
    pid: int
    proposer: str
    changes: tuple[ParamChange, ...]
    status: ProposalStatus
    submit_time_ns: int
    deposit_end_ns: int
    voting_start_ns: int  # 0 until activated
    voting_end_ns: int  # 0 until activated
    total_deposit: int
    # CommunityPoolSpendProposal content (the distrclient.ProposalHandler
    # the reference registers in its gov router, default_overrides.go:207);
    # a proposal carries EITHER param changes OR a spend.
    spend_recipient: str = ""
    spend_amount: int = 0


class GovError(ValueError):
    pass


def default_param_setters(store: KVStore) -> dict[tuple[str, str], Callable[[str], None]]:
    """The governance-settable parameter registry."""
    from celestia_app_tpu_torch.modules.blob.params import BlobParamsKeeper
    from celestia_app_tpu_torch.modules.blobstream.keeper import set_data_commitment_window
    from celestia_app_tpu_torch.modules.minfee import MinFeeKeeper

    from celestia_app_tpu_torch.modules.consensus_params import ConsensusParamsKeeper

    blob = BlobParamsKeeper(store)
    minfee = MinFeeKeeper(store)
    consensus = ConsensusParamsKeeper(store)
    return {
        ("blob", "GasPerBlobByte"): lambda v: blob.set_gas_per_blob_byte(int(v)),
        ("blob", "GovMaxSquareSize"): lambda v: blob.set_gov_max_square_size(int(v)),
        ("minfee", "NetworkMinGasPrice"): lambda v: minfee.set_network_min_gas_price(
            Dec.from_str(v)
        ),
        ("blobstream", "DataCommitmentWindow"): lambda v: set_data_commitment_window(
            store, int(v)
        ),
        # baseapp BlockParams (gov-settable in the reference — the big-block
        # e2e raises MaxBytes through governance).
        ("baseapp", "BlockMaxBytes"): lambda v: consensus.set_block_max_bytes(int(v)),
        ("baseapp", "BlockMaxGas"): lambda v: consensus.set_block_max_gas(int(v)),
    }


class GovKeeper:
    def __init__(
        self,
        store: KVStore,
        staking: StakingKeeper,
        bank: BankKeeper | None = None,
        min_deposit: int = DEFAULT_MIN_DEPOSIT,
        max_deposit_period_ns: int = DEFAULT_MAX_DEPOSIT_PERIOD_NS,
        voting_period_ns: int = DEFAULT_VOTING_PERIOD_NS,
    ):
        self.store = store
        self.staking = staking
        self.bank = bank  # None = deposits tracked but not escrowed (unit tests)
        self.min_deposit = min_deposit
        self.max_deposit_period_ns = max_deposit_period_ns
        self.voting_period_ns = voting_period_ns
        self._setters = default_param_setters(store)

    # --- storage ------------------------------------------------------------
    def _next_id(self) -> int:
        raw = self.store.get(b"gov/next_id")
        n = int.from_bytes(raw, "big") if raw else 1
        self.store.set(b"gov/next_id", (n + 1).to_bytes(8, "big"))
        return n

    def _save(self, p: Proposal) -> None:
        """Binary-safe proto-style record: user strings (proposer, param
        values) are length-delimited, so no byte sequence in them can
        corrupt the record (a \\x1e in a value halted the chain under the
        earlier text format)."""
        out = (
            encode_varint_field(1, p.pid)
            + encode_bytes_field(2, p.proposer.encode())
            + encode_varint_field(3, int(p.status))
            + encode_varint_field(4, p.submit_time_ns)
            + encode_varint_field(5, p.deposit_end_ns)
            + encode_varint_field(6, p.voting_start_ns)
            + encode_varint_field(7, p.voting_end_ns)
            + encode_varint_field(8, p.total_deposit)
        )
        for c in p.changes:
            out += encode_bytes_field(
                9,
                encode_bytes_field(1, c.subspace.encode())
                + encode_bytes_field(2, c.key.encode())
                + encode_bytes_field(3, c.value.encode()),
            )
        if p.spend_recipient:
            out += encode_bytes_field(
                10,
                encode_bytes_field(1, p.spend_recipient.encode())
                + encode_varint_field(2, p.spend_amount),
            )
        self.store.set(f"gov/prop/{p.pid:016d}".encode(), out)
        # Active index: end_blocker scans only live proposals (the sdk's
        # Active/InactiveProposalQueue analog).
        active_key = f"gov/active/{p.pid:016d}".encode()
        if p.status in (ProposalStatus.DEPOSIT_PERIOD, ProposalStatus.VOTING_PERIOD):
            self.store.set(active_key, b"\x01")
        else:
            self.store.delete(active_key)

    def get_proposal(self, pid: int) -> Proposal:
        raw = self.store.get(f"gov/prop/{pid:016d}".encode())
        if raw is None:
            raise GovError(f"no proposal {pid}")
        ints = {num: val for num, wt, val in decode_fields(raw) if wt == WIRE_VARINT}
        proposer = ""
        changes: list[ParamChange] = []
        spend_recipient, spend_amount = "", 0
        for num, wt, val in decode_fields(raw):
            if num == 2 and wt == WIRE_LEN:
                proposer = val.decode()
            elif num == 9 and wt == WIRE_LEN:
                f = {cn: cv for cn, cwt, cv in decode_fields(val) if cwt == WIRE_LEN}
                changes.append(
                    ParamChange(
                        f.get(1, b"").decode(), f.get(2, b"").decode(),
                        f.get(3, b"").decode(),
                    )
                )
            elif num == 10 and wt == WIRE_LEN:
                for sn, swt, sv in decode_fields(val):
                    if sn == 1 and swt == WIRE_LEN:
                        spend_recipient = sv.decode()
                    elif sn == 2 and swt == WIRE_VARINT:
                        spend_amount = sv
        return Proposal(
            ints.get(1, 0), proposer, tuple(changes),
            ProposalStatus(ints.get(3, 1)), ints.get(4, 0), ints.get(5, 0),
            ints.get(6, 0), ints.get(7, 0), ints.get(8, 0),
            spend_recipient, spend_amount,
        )

    def proposals(self) -> list[Proposal]:
        out = []
        for key, _ in self.store.iterate(b"gov/prop/"):
            out.append(self.get_proposal(int(key.rsplit(b"/", 1)[-1])))
        return out

    def active_proposals(self) -> list[Proposal]:
        out = []
        for key, _ in self.store.iterate(b"gov/active/"):
            out.append(self.get_proposal(int(key.rsplit(b"/", 1)[-1])))
        return out

    def _delete_votes(self, pid: int) -> None:
        prefix = f"gov/vote/{pid}/".encode()
        for key, _ in self.store.iterate(prefix):
            self.store.delete(key)

    def _delete(self, pid: int) -> None:
        self.store.delete(f"gov/prop/{pid:016d}".encode())
        self.store.delete(f"gov/active/{pid:016d}".encode())
        self._delete_votes(pid)
        dep_prefix = f"gov/dep/{pid}/".encode()
        for key, _ in self.store.iterate(dep_prefix):
            self.store.delete(key)

    # --- lifecycle ----------------------------------------------------------
    def submit(
        self,
        proposer: str,
        changes: list[ParamChange],
        initial_deposit: int,
        time_ns: int,
        spend: tuple[str, int] | None = None,
    ) -> int:
        """MsgSubmitProposal: validates against the paramfilter + registry,
        escrows the initial deposit, and opens the deposit period (or goes
        straight to voting when the deposit already meets the minimum).
        Content is EITHER param changes OR a community-pool spend
        (recipient, amount)."""
        if bool(changes) == (spend is not None):
            raise GovError(
                "proposal must carry exactly one content: param changes or "
                "a community pool spend"
            )
        validate_param_changes([(c.subspace, c.key, c.value) for c in changes])
        for c in changes:
            if (c.subspace, c.key) not in self._setters:
                raise GovError(f"unknown parameter {c.subspace}/{c.key}")
        if spend is not None and (not spend[0] or spend[1] <= 0):
            raise GovError("community pool spend needs a recipient and a positive amount")
        if initial_deposit < 0:
            raise GovError("negative deposit")
        pid = self._next_id()
        p = Proposal(
            pid, proposer, tuple(changes), ProposalStatus.DEPOSIT_PERIOD,
            time_ns, time_ns + self.max_deposit_period_ns, 0, 0, 0,
            spend[0] if spend else "", spend[1] if spend else 0,
        )
        self._save(p)
        if initial_deposit:
            self._add_deposit(p, proposer, initial_deposit, time_ns)
        return pid

    def _add_deposit(self, p: Proposal, depositor: str, amount: int, time_ns: int) -> None:
        if self.bank is not None:
            try:
                self.bank.send(depositor, GOV_MODULE, amount)
            except ValueError as e:
                raise GovError(str(e)) from e
        key = f"gov/dep/{p.pid}/{depositor}".encode()
        prev = self.store.get(key)
        total = (int.from_bytes(prev, "big") if prev else 0) + amount
        self.store.set(key, total.to_bytes(16, "big"))
        p = replace(p, total_deposit=p.total_deposit + amount)
        if (
            p.status == ProposalStatus.DEPOSIT_PERIOD
            and p.total_deposit >= self.min_deposit
        ):
            p = replace(
                p,
                status=ProposalStatus.VOTING_PERIOD,
                voting_start_ns=time_ns,
                voting_end_ns=time_ns + self.voting_period_ns,
            )
        self._save(p)

    def deposit(self, pid: int, depositor: str, amount: int, time_ns: int) -> None:
        """MsgDeposit: only while the proposal is still collecting."""
        p = self.get_proposal(pid)
        if p.status not in (ProposalStatus.DEPOSIT_PERIOD, ProposalStatus.VOTING_PERIOD):
            raise GovError(f"proposal {pid} no longer accepts deposits")
        if amount <= 0:
            raise GovError("deposit must be positive")
        self._add_deposit(p, depositor, amount, time_ns)

    def vote(self, pid: int, voter: str, option, time_ns: int | None = None) -> None:
        """MsgVote: a single full-weight option (bool accepted for the
        round-1 expedited test path).  Any address may vote; tally weighs
        it by the voter's staked power (delegations + validator self-bond,
        sdk tally.go)."""
        if isinstance(option, bool):
            option = VoteOption.YES if option else VoteOption.NO
        self.vote_weighted(pid, voter, [(VoteOption(option), Dec.from_int(1))], time_ns)

    def vote_weighted(
        self,
        pid: int,
        voter: str,
        options: list[tuple[VoteOption, Dec]],
        time_ns: int | None = None,
    ) -> None:
        """MsgVoteWeighted: split one vote across options; weights must be
        positive and sum to exactly 1 (sdk ValidWeightedVoteOption)."""
        p = self.get_proposal(pid)
        if p.status != ProposalStatus.VOTING_PERIOD:
            raise GovError(f"proposal {pid} is not in its voting period")
        if time_ns is not None and time_ns >= p.voting_end_ns:
            raise GovError(f"voting period for proposal {pid} has ended")
        if not options:
            raise GovError("vote needs at least one option")
        total = Dec(0)
        seen: set[VoteOption] = set()
        for opt, weight in options:
            VoteOption(opt)  # raises on junk
            if weight <= Dec(0):
                raise GovError("vote weights must be positive")
            if opt in seen:
                raise GovError(f"duplicate vote option {opt}")
            seen.add(opt)
            total = total.add(weight)
        if total.raw != Dec.from_int(1).raw:
            raise GovError(f"vote weights must sum to 1, got {total}")
        from celestia_app_tpu_torch.tx.messages import encode_weighted_option

        out = b""
        for opt, weight in options:
            # Stored in the proto WeightedVoteOption shape (one codec for
            # the wire msg and the vote record).
            out += encode_bytes_field(
                1, encode_weighted_option(int(opt), str(weight))
            )
        self.store.set(f"gov/vote/{pid}/{voter}".encode(), out)

    @staticmethod
    def _parse_vote(raw: bytes) -> list[tuple[VoteOption, int]]:
        """[(option, weight_raw)] — weight_raw is a Dec raw (1e18 = 1)."""
        from celestia_app_tpu_torch.tx.messages import decode_weighted_option

        out = []
        for n, wt, v in decode_fields(raw):
            if n == 1 and wt == WIRE_LEN:
                opt, weight = decode_weighted_option(v)
                out.append((VoteOption(opt), Dec.from_str(weight).raw))
        return out

    def _tally(self, pid: int) -> tuple[bool, bool]:
        """(passes, burn_deposits) — sdk gov keeper/tally.go:

        every voter's DELEGATED stake votes directly; a validator votes
        its remaining tokens (self-bond + delegations whose delegators
        did not vote themselves — inherit-unless-overridden).  Votes are
        token-weighted against total bonded tokens.  Outcomes: no quorum
        -> fail+burn; veto > 1/3 of votes -> fail+burn; yes <= 1/2 of
        non-abstain -> fail+refund; else pass+refund."""
        from celestia_app_tpu_torch.state.staking import _DEL_PREFIX  # noqa: PLC2701

        votes: dict[str, list[tuple[VoteOption, int]]] = {}
        prefix = f"gov/vote/{pid}/".encode()
        for key, val in self.store.iterate(prefix):
            votes[key[len(prefix):].decode()] = self._parse_vote(val)

        bonded = {v.address for v in self.staking.bonded_validators()}
        # delegator -> [(validator, stake)] over bonded validators only.
        by_delegator: dict[str, list[tuple[str, int]]] = {}
        for key, val in self.store.iterate(_DEL_PREFIX):
            validator, delegator = key[len(_DEL_PREFIX):].split(b"/", 1)
            validator = validator.decode()
            if validator in bonded:
                by_delegator.setdefault(delegator.decode(), []).append(
                    (validator, int.from_bytes(val, "big"))
                )

        PREC = 10**18
        power_raw: dict[VoteOption, int] = {o: 0 for o in VoteOption}
        deductions: dict[str, int] = {}
        for voter, opts in votes.items():
            stake = 0
            for validator, amount in by_delegator.get(voter, ()):
                stake += amount
                deductions[validator] = deductions.get(validator, 0) + amount
            for opt, weight_raw in opts:
                power_raw[opt] += stake * weight_raw
        for validator in bonded:
            opts = votes.get(validator)
            if not opts:
                continue  # non-voting validators contribute nothing (sdk)
            vp = self.staking.tokens(validator) - deductions.get(validator, 0)
            if vp <= 0:
                continue
            for opt, weight_raw in opts:
                power_raw[opt] += vp * weight_raw

        total_bonded = sum(self.staking.tokens(v) for v in bonded)
        voted = sum(power_raw.values())  # token-units x 1e18
        if total_bonded == 0 or Fraction(voted, total_bonded * PREC) < QUORUM:
            return False, True
        if voted and Fraction(power_raw[VoteOption.NO_WITH_VETO], voted) > VETO_THRESHOLD:
            return False, True
        non_abstain = voted - power_raw[VoteOption.ABSTAIN]
        if non_abstain == 0 or Fraction(power_raw[VoteOption.YES], non_abstain) <= THRESHOLD:
            return False, False
        return True, False

    def _settle_deposits(self, pid: int, burn: bool) -> None:
        prefix = f"gov/dep/{pid}/".encode()
        for key, val in self.store.iterate(prefix):
            depositor = key[len(prefix):].decode()
            amount = int.from_bytes(val, "big")
            if self.bank is not None and amount:
                if burn:
                    self.bank.burn(GOV_MODULE, amount)
                else:
                    self.bank.send(GOV_MODULE, depositor, amount)
            self.store.delete(key)

    def _execute(self, p: Proposal) -> ProposalStatus:
        try:
            # Re-check the filter at execution (the blocklist is consensus law).
            validate_param_changes(
                [(c.subspace, c.key, c.value) for c in p.changes]
            )
            for c in p.changes:
                self._setters[(c.subspace, c.key)](c.value)
            if p.spend_recipient:
                from celestia_app_tpu_torch.modules.distribution import DistributionKeeper

                # Fails (not halts) when the pool shrank below the ask
                # between submission and execution.
                DistributionKeeper(self.store).community_pool_spend(
                    self.bank, p.spend_recipient, p.spend_amount
                )
        except (ValueError, OverflowError):
            # OverflowError included: a passed proposal with an absurd value
            # (e.g. BlockMaxBytes >= 2^64) must FAIL cleanly, not halt the
            # chain out of the end blocker.
            return ProposalStatus.FAILED
        return ProposalStatus.PASSED

    def end_blocker(self, time_ns: int) -> list[tuple]:
        """gov abci.go: expire deposit periods (burn), tally ended voting
        periods, execute passed proposals.  Returns lifecycle events."""
        events: list[tuple] = []
        for p in self.active_proposals():
            if (
                p.status == ProposalStatus.DEPOSIT_PERIOD
                and time_ns > p.deposit_end_ns
            ):
                self._settle_deposits(p.pid, burn=True)
                self._delete(p.pid)
                events.append(("gov.proposal_dropped", p.pid))
            elif (
                p.status == ProposalStatus.VOTING_PERIOD
                and time_ns >= p.voting_end_ns
            ):
                passes, burn = self._tally(p.pid)
                self._settle_deposits(p.pid, burn=burn)
                status = self._execute(p) if passes else ProposalStatus.REJECTED
                self._save(replace(p, status=status))  # drops the active key
                self._delete_votes(p.pid)
                events.append((f"gov.proposal_{status.name.lower()}", p.pid))
        return events

    # --- round-1 expedited API (kept: unit tests drive tallies directly) ----
    def submit_param_change(self, proposer: str, changes: list[ParamChange]) -> int:
        """Submit with the minimum deposit pre-met: voting opens at t=0."""
        pid = self.submit(proposer, changes, 0, 0)
        p = self.get_proposal(pid)
        self._save(
            replace(
                p,
                status=ProposalStatus.VOTING_PERIOD,
                voting_start_ns=0,
                voting_end_ns=self.voting_period_ns,
            )
        )
        return pid

    def tally_and_execute(self, pid: int) -> bool:
        """Force an immediate tally (test convenience; production goes
        through end_blocker's clocks)."""
        p = self.get_proposal(pid)
        if p.status != ProposalStatus.VOTING_PERIOD:
            raise GovError(f"proposal {pid} is not in its voting period")
        passes, burn = self._tally(p.pid)
        self._settle_deposits(p.pid, burn=burn)
        if not passes:
            self._save(replace(p, status=ProposalStatus.REJECTED))
            return False
        status = self._execute(p)
        if status == ProposalStatus.FAILED:
            raise GovError(f"proposal {pid} execution failed")
        self._delete(pid)
        return True
