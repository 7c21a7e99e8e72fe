"""BFT votes: signed prevotes/precommits with +2/3 power aggregation.

The reference's consensus (celestia-core, Tendermint v0.34) gossips votes
over p2p; a block commits only with >2/3 of validator power precommitting
its block id, and the resulting Commit is what light clients verify.  This
module carries that vote layer: votes are (height, round, type, block id)
with per-vote secp256k1 signatures over domain-separated sign bytes; a
nil vote is block_hash == b"" (Tendermint's nil prevote/precommit).  The
multi-round state machine (round changes, polka locking, proposer
rotation) lives in consensus/machine.py; VoteSet here is the
single-target tally the commit-verification path uses.
"""

from __future__ import annotations

from dataclasses import dataclass

from celestia_app_tpu_torch.crypto.keys import PrivateKey, PublicKey
from celestia_app_tpu_torch.encoding.proto import (
    WIRE_LEN,
    WIRE_VARINT,
    decode_fields,
    encode_bytes_field,
    encode_varint_field,
)

PREVOTE = 1
PRECOMMIT = 2
_TYPE_NAMES = {PREVOTE: "prevote", PRECOMMIT: "precommit"}


class ConsensusError(RuntimeError):
    pass


def block_id(data_root: bytes, prev_app_hash: bytes, time_ns: int = 0) -> bytes:
    """What votes commit to: the block's data root, the app hash the
    proposer executed from (Tendermint's header chains the previous app
    hash the same way), and the block time.  Three consequences: diverged
    state shows up as a different block id BEFORE anyone commits; a Commit
    at height H+1 attests height H's app hash — the trust anchor state
    sync verifies a restored snapshot against; and the block time is
    +2/3-attested, so IBC timestamp timeouts verify against a committed
    consensus timestamp instead of anyone's local clock (Tendermint
    headers carry Time inside the signed header for the same reason)."""
    import hashlib

    return hashlib.sha256(
        b"celestia-tpu/block" + data_root + prev_app_hash
        + time_ns.to_bytes(12, "big")
    ).digest()


#: A nil vote's block hash (Tendermint's nil prevote/precommit).
NIL = b""


def vote_sign_bytes(
    chain_id: str, height: int, vote_type: int, block_hash: bytes,
    round: int = 0,
) -> bytes:
    """Canonical vote sign bytes (the CanonicalVote analog): chain-id
    domain separation so votes can never be replayed across chains; the
    round is signed so a round-r vote can never be replayed as round-r'
    (CanonicalVote carries Round the same way)."""
    return (
        encode_bytes_field(1, b"celestia-tpu/vote")
        + encode_bytes_field(2, chain_id.encode())
        + encode_varint_field(3, height)
        + encode_varint_field(4, vote_type)
        + encode_bytes_field(5, block_hash)
        + encode_varint_field(6, round)
    )


@dataclass(frozen=True)
class Vote:
    height: int
    vote_type: int  # PREVOTE | PRECOMMIT
    block_hash: bytes  # NIL (b"") for a nil vote
    validator: str  # operator address
    signature: bytes
    round: int = 0

    @property
    def is_nil(self) -> bool:
        return self.block_hash == NIL

    @classmethod
    def sign(
        cls, key: PrivateKey, chain_id: str, height: int, vote_type: int,
        block_hash: bytes, validator: str | None = None, round: int = 0,
    ) -> "Vote":
        """`validator` is the OPERATOR address this vote speaks for; it
        defaults to the key's own derived address (genesis validators),
        but a validator created via MsgCreateValidator has an operator
        address distinct from its consensus key's — such nodes pass it
        explicitly.  Verification is by the registered pubkey either way."""
        return cls(
            height, vote_type, block_hash,
            validator if validator is not None else key.public_key().address(),
            key.sign(vote_sign_bytes(chain_id, height, vote_type, block_hash, round)),
            round,
        )

    def verify(self, pubkey: PublicKey, chain_id: str) -> bool:
        return pubkey.verify(
            vote_sign_bytes(
                chain_id, self.height, self.vote_type, self.block_hash, self.round
            ),
            self.signature,
        )

    def marshal(self) -> bytes:
        return (
            encode_varint_field(1, self.height)
            + encode_varint_field(2, self.vote_type)
            + encode_bytes_field(3, self.block_hash)
            + encode_bytes_field(4, self.validator.encode())
            + encode_bytes_field(5, self.signature)
            + encode_varint_field(6, self.round)
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Vote":
        ints = {n: v for n, wt, v in decode_fields(raw) if wt == WIRE_VARINT}
        b = {n: v for n, wt, v in decode_fields(raw) if wt == WIRE_LEN}
        return cls(
            ints.get(1, 0), ints.get(2, 0), b.get(3, b""),
            b.get(4, b"").decode(), b.get(5, b""), ints.get(6, 0),
        )


class VoteSet:
    """One (height, type, block hash) aggregation with power accounting.

    `validators` maps operator address -> (PublicKey, power); add() verifies
    membership, target, and signature before counting the power."""

    def __init__(
        self,
        chain_id: str,
        height: int,
        vote_type: int,
        block_hash: bytes,
        validators: dict[str, tuple[PublicKey, int]],
        round: int = 0,
    ):
        self.chain_id = chain_id
        self.height = height
        self.round = round
        self.vote_type = vote_type
        self.block_hash = block_hash
        self.validators = validators
        self.votes: dict[str, Vote] = {}

    def add(self, vote: Vote) -> None:
        kind = _TYPE_NAMES.get(self.vote_type, "?")
        if (
            vote.height != self.height
            or vote.vote_type != self.vote_type
            or vote.round != self.round
        ):
            raise ConsensusError(
                f"{kind} for wrong height/round/type: "
                f"{vote.height}/{vote.round}/{vote.vote_type}"
            )
        if vote.block_hash != self.block_hash:
            raise ConsensusError(
                f"{kind} from {vote.validator} for a different block"
            )
        entry = self.validators.get(vote.validator)
        if entry is None:
            raise ConsensusError(f"{kind} from non-validator {vote.validator}")
        if vote.validator in self.votes:
            return  # idempotent
        pubkey, _power = entry
        if not vote.verify(pubkey, self.chain_id):
            raise ConsensusError(f"bad {kind} signature from {vote.validator}")
        self.votes[vote.validator] = vote

    def signed_power(self) -> int:
        return sum(self.validators[v][1] for v in self.votes)

    def total_power(self) -> int:
        return sum(p for _, p in self.validators.values())

    def has_two_thirds(self) -> bool:
        """Tendermint's strict rule: 3 x signed > 2 x total."""
        return 3 * self.signed_power() > 2 * self.total_power()


@dataclass(frozen=True)
class Commit:
    """The queryable proof a height committed: +2/3 precommits over
    block_id(data_root, prev_app_hash), all from the same round."""

    height: int
    block_hash: bytes  # = block_id(data_root, prev_app_hash)
    precommits: tuple[Vote, ...]
    data_root: bytes = b""
    prev_app_hash: bytes = b""
    round: int = 0
    time_ns: int = 0  # block time (see commit timestamps, machine.py)

    def to_json(self) -> dict:
        return {
            "height": self.height,
            "round": self.round,
            "block_hash": self.block_hash.hex(),
            "precommits": [v.marshal().hex() for v in self.precommits],
            "data_root": self.data_root.hex(),
            "prev_app_hash": self.prev_app_hash.hex(),
            "time_ns": self.time_ns,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Commit":
        return cls(
            d["height"], bytes.fromhex(d["block_hash"]),
            tuple(Vote.unmarshal(bytes.fromhex(v)) for v in d["precommits"]),
            bytes.fromhex(d.get("data_root", "")),
            bytes.fromhex(d.get("prev_app_hash", "")),
            d.get("round", 0),
            d.get("time_ns", 0),
        )


@dataclass(frozen=True)
class Equivocation:
    """Double-sign evidence: one validator, two votes for the same height,
    ROUND, and vote type but different block ids — what Tendermint's
    evidence pool gossips as DuplicateVoteEvidence.  (Voting for different
    blocks in different rounds is the protocol working, not a fault.)
    Verification (signatures + pair validity) happens in the slashing
    keeper, which holds the validator set."""

    vote_a: Vote
    vote_b: Vote

    @property
    def validator(self) -> str:
        return self.vote_a.validator

    @property
    def height(self) -> int:
        return self.vote_a.height

    def key(self) -> tuple:
        """The dedup identity (one equivocation per coordinates is enough
        to tombstone) — the single definition every pool/used-set uses."""
        return (
            self.validator, self.height, self.vote_a.round,
            self.vote_a.vote_type,
        )


def find_equivocations(votes) -> list[Equivocation]:
    """Scan votes (any iterable) for conflicting pairs per
    (validator, height, round, vote type).  First conflicting pair per key
    wins — one equivocation is enough to tombstone."""
    seen: dict[tuple[str, int, int, int], Vote] = {}
    found: list[Equivocation] = []
    flagged: set[tuple[str, int, int, int]] = set()
    for v in votes:
        key = (v.validator, v.height, v.round, v.vote_type)
        prior = seen.get(key)
        if prior is None:
            seen[key] = v
        elif prior.block_hash != v.block_hash and key not in flagged:
            found.append(Equivocation(prior, v))
            flagged.add(key)
    return found


def verify_commit(
    validators: dict[str, tuple[PublicKey, int]],
    chain_id: str,
    commit: Commit,
) -> bool:
    """Light-client check: does this Commit carry >2/3 of the given
    validator set's power in valid precommit signatures, over a block id
    consistent with its claimed data root + previous app hash?

    The binding is unconditional: a commit whose (data_root,
    prev_app_hash, time_ns) parts don't hash to the signed block id is
    rejected — otherwise the unsigned part fields could be rewritten
    freely and a state-sync joiner shown a forged prev_app_hash (or an
    IBC light client a forged consensus timestamp)."""
    if commit.block_hash != block_id(
        commit.data_root, commit.prev_app_hash, commit.time_ns
    ):
        return False
    vs = VoteSet(
        chain_id, commit.height, PRECOMMIT, commit.block_hash, validators,
        round=commit.round,
    )
    for vote in commit.precommits:
        try:
            vs.add(vote)
        except ConsensusError:
            return False  # a forged/foreign vote poisons the commit
    return vs.has_two_thirds()
