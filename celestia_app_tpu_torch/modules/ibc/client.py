"""02-client: on-chain light clients of counterparty chains.

The reference chain delegates this to ibc-go's 02-client + the
07-tendermint light client (wired transitively via app/app.go:300-346).
This framework's chains commit with their OWN consensus plane
(consensus/votes.py): +2/3 secp256k1 precommits over
block_id(data_root_H, app_hash_{H-1}), state rooted in an SMT
(state/smt.py).  The native light client therefore verifies exactly that:

  * ClientState: counterparty chain id + trusted validator set + latest
    height + frozen flag;
  * UpdateClient(commit): `verify_commit` against the trusted set; a
    valid Commit at height H yields the counterparty's data root at H and
    its app hash at H-1 (Tendermint's header offset: the header at H
    carries the app hash of H-1) — stored as the consensus state;
  * VerifyMembership / VerifyNonMembership: SMT state proofs
    (state/smt.py::verify) against the proven app hash — the proof
    surface connection/channel handshakes and packet relay verify
    against;
  * Misbehaviour: two verified commits for the same height with different
    block ids freeze the client (07-tendermint's CheckMisbehaviour).

Valset rotation: sequential UpdateClient calls may carry a new validator
set (07-tendermint trusting-period semantics) — accepted when the commit
has +2/3 of the NEW set and >1/3 of the TRUSTED set's power in valid
precommits, so a chain can rotate 100% of its set across several hops
without the client being recreated (closes round-3 PARITY gap #2).
"""

from __future__ import annotations

from dataclasses import dataclass

from celestia_app_tpu_torch.crypto.keys import PublicKey
from celestia_app_tpu_torch.encoding.proto import (
    WIRE_LEN,
    WIRE_VARINT,
    decode_fields,
    encode_bytes_field,
    encode_varint_field,
)
from celestia_app_tpu_torch.modules.ibc.core import IBCError
from celestia_app_tpu_torch.state.store import KVStore

_CLIENT_PREFIX = b"ibc/client/"
_CONSENSUS_PREFIX = b"ibc/consensus/"
_NEXT_CLIENT_KEY = b"ibc/next_client_id"


@dataclass(frozen=True)
class ClientState:
    client_id: str
    chain_id: str
    # (operator address, consensus pubkey, power) triples — the trusted set.
    validators: tuple[tuple[str, bytes, int], ...]
    latest_height: int = 0
    frozen: bool = False

    def validator_map(self) -> dict[str, tuple[PublicKey, int]]:
        return {a: (PublicKey(pk), p) for a, pk, p in self.validators}

    def marshal(self) -> bytes:
        out = (
            encode_bytes_field(1, self.client_id.encode())
            + encode_bytes_field(2, self.chain_id.encode())
            + encode_varint_field(3, self.latest_height)
            + encode_varint_field(4, int(self.frozen))
        )
        for addr, pk, power in self.validators:
            out += encode_bytes_field(
                5,
                encode_bytes_field(1, addr.encode())
                + encode_bytes_field(2, pk)
                + encode_varint_field(3, power),
            )
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "ClientState":
        ints = {n: v for n, wt, v in decode_fields(raw) if wt == WIRE_VARINT}
        cid, chain = "", ""
        vals = []
        for n, wt, v in decode_fields(raw):
            if n == 1 and wt == WIRE_LEN:
                cid = v.decode()
            elif n == 2 and wt == WIRE_LEN:
                chain = v.decode()
            elif n == 5 and wt == WIRE_LEN:
                f = {fn: fv for fn, fwt, fv in decode_fields(v) if fwt == WIRE_LEN}
                fi = {fn: fv for fn, fwt, fv in decode_fields(v) if fwt == WIRE_VARINT}
                vals.append((f[1].decode(), f[2], fi.get(3, 0)))
        return cls(cid, chain, tuple(vals), ints.get(3, 0), bool(ints.get(4, 0)))


@dataclass(frozen=True)
class ConsensusState:
    """What a verified Commit at `height` pins: the counterparty's data
    root at `height`, its app hash at `height - 1`, and the block time —
    all inside the signed block id, so timestamp timeouts verify against
    a +2/3-attested clock, not anyone's local one (ibc-go's
    ConsensusState carries Timestamp from the Tendermint header the same
    way)."""

    height: int
    data_root: bytes
    prev_app_hash: bytes
    time_ns: int = 0

    def marshal(self) -> bytes:
        return (
            encode_varint_field(1, self.height)
            + encode_bytes_field(2, self.data_root)
            + encode_bytes_field(3, self.prev_app_hash)
            + encode_varint_field(4, self.time_ns)
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "ConsensusState":
        ints = {n: v for n, wt, v in decode_fields(raw) if wt == WIRE_VARINT}
        b = {n: v for n, wt, v in decode_fields(raw) if wt == WIRE_LEN}
        return cls(ints.get(1, 0), b.get(2, b""), b.get(3, b""), ints.get(4, 0))


class ClientKeeper:
    def __init__(self, store: KVStore):
        self.store = store

    # --- lifecycle -----------------------------------------------------------
    def create_client(
        self,
        chain_id: str,
        validators: dict[str, tuple[PublicKey, int]],
    ) -> str:
        """MsgCreateClient: pin the counterparty's chain id + validator
        set; returns the new client id (07-tendermint-style numbering)."""
        if not validators:
            raise IBCError("client needs a non-empty validator set")
        from celestia_app_tpu_torch.modules.ibc.core import next_counter

        client_id = f"07-tpu-{next_counter(self.store, _NEXT_CLIENT_KEY)}"
        cs = ClientState(
            client_id, chain_id,
            tuple(
                (addr, pk.bytes, power)
                for addr, (pk, power) in sorted(validators.items())
            ),
        )
        self.store.set(_CLIENT_PREFIX + client_id.encode(), cs.marshal())
        return client_id

    def client_state(self, client_id: str) -> ClientState:
        raw = self.store.get(_CLIENT_PREFIX + client_id.encode())
        if raw is None:
            raise IBCError(f"no client {client_id}")
        return ClientState.unmarshal(raw)

    def _save(self, cs: ClientState) -> None:
        self.store.set(_CLIENT_PREFIX + cs.client_id.encode(), cs.marshal())

    def update_client(
        self, client_id: str, commit, new_validators=None
    ) -> ConsensusState:
        """MsgUpdateClient: verify the Commit, store the consensus state it
        pins.  A conflicting verified commit for an already-known height is
        misbehaviour: the client freezes (07-tendermint CheckForMisbehaviour
        + frozen clients reject everything).

        Valset rotation (07-tendermint trusting-period semantics, the rule
        ibc-go's VerifyClientMessage applies through sequential headers):
        pass `new_validators` (addr -> (PublicKey, power)) to rotate trust.
        The commit must then carry +2/3 of the NEW set's power AND valid
        precommits from MORE THAN 1/3 of the currently TRUSTED set's power
        — forging a rotation requires corrupting >1/3 of the trusted
        validators, Tendermint's light-client security bound.  Chains can
        rotate 100% of their set across several such hops.
        """
        from celestia_app_tpu_torch.consensus import verify_commit
        from celestia_app_tpu_torch.consensus.votes import PRECOMMIT

        cs = self.client_state(client_id)
        if cs.frozen:
            raise IBCError(f"client {client_id} is frozen")
        if new_validators is None:
            if not verify_commit(cs.validator_map(), cs.chain_id, commit):
                raise IBCError(
                    f"commit at height {commit.height} fails verification "
                    f"against client {client_id}"
                )
        else:
            if commit.height <= cs.latest_height:
                raise IBCError(
                    "valset rotation must move the client forward "
                    f"(height {commit.height} <= {cs.latest_height})"
                )
            if not verify_commit(dict(new_validators), cs.chain_id, commit):
                raise IBCError(
                    f"rotation commit at height {commit.height} lacks +2/3 "
                    "of the proposed validator set"
                )
            trusted = cs.validator_map()
            total = sum(p for _, p in trusted.values())
            counted: set[str] = set()
            overlap = 0
            for vote in commit.precommits:
                entry = trusted.get(vote.validator)
                if entry is None or vote.validator in counted:
                    continue
                pub, power = entry
                if (
                    vote.height == commit.height
                    and vote.round == commit.round
                    and vote.vote_type == PRECOMMIT
                    and vote.block_hash == commit.block_hash
                    and vote.verify(pub, cs.chain_id)
                ):
                    counted.add(vote.validator)
                    overlap += power
            if 3 * overlap <= total:
                raise IBCError(
                    f"rotation commit at height {commit.height} carries only "
                    f"{overlap}/{total} trusted power; need > 1/3"
                )
            # No save here: rotation requires height > latest_height, so
            # the latest-height save below always persists this rebuilt
            # state (validators rotated, height advanced) in one write.
            cs = ClientState(
                cs.client_id, cs.chain_id,
                tuple(
                    (addr, pk.bytes, power)
                    for addr, (pk, power) in sorted(dict(new_validators).items())
                ),
                cs.latest_height, cs.frozen,
            )
        new = ConsensusState(
            commit.height, commit.data_root, commit.prev_app_hash,
            getattr(commit, "time_ns", 0),
        )
        key = (
            _CONSENSUS_PREFIX + client_id.encode() + b"/"
            + commit.height.to_bytes(8, "big")
        )
        existing = self.store.get(key)
        if existing is not None:
            prior = ConsensusState.unmarshal(existing)
            if (prior.data_root, prior.prev_app_hash, prior.time_ns) != (
                new.data_root, new.prev_app_hash, new.time_ns,
            ):
                # Two +2/3-signed commits for one height: equivocation at
                # chain scale.  Freeze; never serve this client again.
                self._save(
                    ClientState(
                        cs.client_id, cs.chain_id, cs.validators,
                        cs.latest_height, frozen=True,
                    )
                )
                raise IBCError(
                    f"misbehaviour on client {client_id} at height "
                    f"{commit.height}: conflicting commits — client frozen"
                )
            return prior
        self.store.set(key, new.marshal())
        if commit.height > cs.latest_height:
            self._save(
                ClientState(
                    cs.client_id, cs.chain_id, cs.validators, commit.height
                )
            )
        return new

    def consensus_state(self, client_id: str, height: int) -> ConsensusState:
        raw = self.store.get(
            _CONSENSUS_PREFIX + client_id.encode() + b"/" + height.to_bytes(8, "big")
        )
        if raw is None:
            raise IBCError(
                f"client {client_id} has no consensus state at height {height}"
            )
        return ConsensusState.unmarshal(raw)

    def app_hash_at(self, client_id: str, height: int) -> bytes:
        """The counterparty app hash state proofs at `height` verify
        against — pinned by the commit at height+1 (the header offset)."""
        return self.consensus_state(client_id, height + 1).prev_app_hash

    # --- proof verification (what handshakes + relay call) -------------------
    def verify_membership(
        self, client_id: str, height: int, key: bytes, value: bytes, proof
    ) -> None:
        """The counterparty's state at `height` contains key -> value."""
        from celestia_app_tpu_torch.state import smt

        cs = self.client_state(client_id)
        if cs.frozen:
            raise IBCError(f"client {client_id} is frozen")
        if proof.key != key or proof.value != value:
            raise IBCError(
                f"proof is for {proof.key!r}={proof.value!r}, "
                f"expected {key!r}={value!r}"
            )
        if not smt.verify(proof, self.app_hash_at(client_id, height)):
            raise IBCError(
                f"membership proof for {key!r} fails against client "
                f"{client_id} at height {height}"
            )

    def verify_non_membership(
        self, client_id: str, height: int, key: bytes, proof
    ) -> None:
        """The counterparty's state at `height` does NOT contain `key`."""
        from celestia_app_tpu_torch.state import smt

        cs = self.client_state(client_id)
        if cs.frozen:
            raise IBCError(f"client {client_id} is frozen")
        if proof.key != key or proof.value is not None:
            raise IBCError("proof is not a non-membership proof for the key")
        if not smt.verify(proof, self.app_hash_at(client_id, height)):
            raise IBCError(
                f"non-membership proof for {key!r} fails against client "
                f"{client_id} at height {height}"
            )
