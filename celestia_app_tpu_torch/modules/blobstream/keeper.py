"""x/blobstream: Ethereum-bridge attestations (v1 only; off in v2+).

Behavioral parity with reference x/blobstream (abci.go:28 EndBlocker,
keeper_valset.go, keeper_data_commitment.go): every block, (a) snapshot the
validator set when it first appears or when normalized power shifts by more
than 5%, (b) emit a DataCommitment attestation for every elapsed
DataCommitmentWindow of blocks (catching up in a loop), (c) prune
attestations older than the 3-week expiry.  Attestations carry a global
monotonically increasing nonce consumed by the BlobstreamX relayer.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from fractions import Fraction

from celestia_app_tpu_torch import merkle
from celestia_app_tpu_torch.encoding.proto import (
    WIRE_LEN,
    WIRE_VARINT,
    decode_fields,
    encode_bytes_field,
    encode_varint_field,
)
from celestia_app_tpu_torch.state.staking import StakingKeeper
from celestia_app_tpu_torch.state.store import KVStore

DEFAULT_DATA_COMMITMENT_WINDOW = 400  # types/genesis.go:29
SIGNIFICANT_POWER_DIFF = Fraction(5, 100)  # abci.go:26
ATTESTATION_EXPIRY_NS = 3 * 7 * 24 * 3600 * 10**9  # 3 weeks

_NONCE_KEY = b"blobstream/latest_nonce"
_ATT_PREFIX = b"blobstream/att/"
_EVM_PREFIX = b"blobstream/evm/"
_WINDOW_KEY = b"blobstream/params/data_commitment_window"


def set_data_commitment_window(store: KVStore, window: int) -> None:
    """On-chain DataCommitmentWindow param (genesis/gov-settable, as the
    reference keeper reads it via GetDataCommitmentWindowParam)."""
    if window <= 0:
        raise ValueError("data commitment window must be positive")
    store.set(_WINDOW_KEY, window.to_bytes(8, "big"))


def get_data_commitment_window(store: KVStore) -> int:
    raw = store.get(_WINDOW_KEY)
    return int.from_bytes(raw, "big") if raw else DEFAULT_DATA_COMMITMENT_WINDOW


@dataclass(frozen=True)
class BridgeValidator:
    address: str
    power: int
    # The EVM address the orchestrator signs with: a 0x-hex string when
    # registered via MsgRegisterEVMAddress, else None and the digest layer
    # falls back to DefaultEVMAddress (the operator's own 20 payload
    # bytes, reference types/types.go:13).  It MUST ride in the valset
    # snapshot: the contract's stored valset uses the registered address,
    # so a digest built from the default would diverge byte-for-byte.
    evm_address: str | None = None


@dataclass(frozen=True)
class Valset:
    nonce: int
    height: int
    time_ns: int
    members: tuple[BridgeValidator, ...]

    KIND = 1

    def marshal(self) -> bytes:
        out = (
            encode_varint_field(1, self.KIND)
            + encode_varint_field(2, self.nonce)
            + encode_varint_field(3, self.height)
            + encode_varint_field(4, self.time_ns)
        )
        for m in self.members:
            member = encode_bytes_field(1, m.address.encode())
            member += encode_varint_field(2, m.power)
            if m.evm_address:
                member += encode_bytes_field(3, m.evm_address.encode())
            out += encode_bytes_field(5, member)
        return out


@dataclass(frozen=True)
class DataCommitment:
    nonce: int
    begin_block: int  # inclusive
    end_block: int  # exclusive (matches reference window semantics)
    height: int
    time_ns: int

    KIND = 2

    def marshal(self) -> bytes:
        return (
            encode_varint_field(1, self.KIND)
            + encode_varint_field(2, self.nonce)
            + encode_varint_field(3, self.begin_block)
            + encode_varint_field(4, self.end_block)
            + encode_varint_field(5, self.height)
            + encode_varint_field(6, self.time_ns)
        )


def _unmarshal_attestation(raw: bytes):
    fields = {num: val for num, wt, val in decode_fields(raw) if wt == WIRE_VARINT}
    kind = fields.get(1)
    if kind == Valset.KIND:
        members = []
        for num, wt, val in decode_fields(raw):
            if num == 5 and wt == WIRE_LEN:
                addr, power, evm = "", 0, None
                for mn, mwt, mval in decode_fields(val):
                    if mn == 1 and mwt == WIRE_LEN:
                        addr = mval.decode()
                    elif mn == 2 and mwt == WIRE_VARINT:
                        power = mval
                    elif mn == 3 and mwt == WIRE_LEN:
                        evm = mval.decode()
                members.append(BridgeValidator(addr, power, evm))
        return Valset(
            fields.get(2, 0), fields.get(3, 0), fields.get(4, 0), tuple(members)
        )
    if kind == DataCommitment.KIND:
        return DataCommitment(
            fields.get(2, 0), fields.get(3, 0), fields.get(4, 0),
            fields.get(5, 0), fields.get(6, 0),
        )
    raise ValueError(f"unknown attestation kind {kind}")


def encode_data_root_tuple(height: int, data_root: bytes) -> bytes:
    """abi.encode(DataRootTuple{uint256 height, bytes32 dataRoot}) — 64 bytes.

    The exact leaf the Blobstream contract hashes when verifying a
    data-root inclusion proof (x/blobstream/client/verify.go:336-344
    builds this tuple; the solidity type is pinned in
    x/blobstream/types/abi_consts.go): 32-byte big-endian height followed
    by the 32-byte data root.
    """
    if len(data_root) != 32:
        raise ValueError(f"data root must be 32 bytes, got {len(data_root)}")
    return height.to_bytes(32, "big") + data_root


def data_commitment_root(data_roots: list[tuple[int, bytes]]) -> bytes:
    """Merkle root over (height, data_root) tuples for a commitment window.

    The relayer-facing commitment the reference obtains from celestia-core's
    DataCommitment RPC: an RFC-6962 binary merkle over 64-byte
    abi-encoded DataRootTuple leaves (encode_data_root_tuple)."""
    leaves = [encode_data_root_tuple(h, root) for h, root in data_roots]
    return merkle.hash_from_byte_slices(leaves)


def data_root_inclusion_proof(
    data_roots: list[tuple[int, bytes]], height: int
) -> tuple[int, int, list[bytes]]:
    """(index, total, audit_path) of `height`'s tuple within the window.

    The core-RPC DataRootInclusionProof the relayer feeds to the contract
    (x/blobstream/client/verify.go:288,310-344).
    """
    heights = [h for h, _ in data_roots]
    index = heights.index(height)
    leaves = [encode_data_root_tuple(h, root) for h, root in data_roots]
    return index, len(leaves), merkle.proof(leaves, index)


def _normalized_power_diff(
    curr: list[BridgeValidator], last: list[BridgeValidator]
) -> Fraction:
    """Sum of |Δ normalized power| (Gravity PowerDiff semantics)."""
    pc = sum(m.power for m in curr) or 1
    pl = sum(m.power for m in last) or 1
    addrs = {m.address for m in curr} | {m.address for m in last}
    cm = {m.address: m.power for m in curr}
    lm = {m.address: m.power for m in last}
    return sum(
        abs(Fraction(cm.get(a, 0), pc) - Fraction(lm.get(a, 0), pl)) for a in addrs
    )


class BlobstreamKeeper:
    def __init__(
        self,
        store: KVStore,
        staking: StakingKeeper,
        data_commitment_window: int | None = None,
    ):
        self.store = store
        self.staking = staking
        # None -> the on-chain param (keeper_data_commitment.go:44-50);
        # an explicit argument pins it (unit tests).
        self.window = (
            data_commitment_window
            if data_commitment_window is not None
            else get_data_commitment_window(store)
        )

    # --- nonces / storage --------------------------------------------------
    def latest_nonce(self) -> int:
        raw = self.store.get(_NONCE_KEY)
        return int.from_bytes(raw, "big") if raw else 0

    def _next_nonce(self) -> int:
        n = self.latest_nonce() + 1
        self.store.set(_NONCE_KEY, n.to_bytes(8, "big"))
        return n

    def _set_attestation(self, att) -> None:
        self.store.set(_ATT_PREFIX + att.nonce.to_bytes(8, "big"), att.marshal())

    def get_attestation(self, nonce: int):
        raw = self.store.get(_ATT_PREFIX + nonce.to_bytes(8, "big"))
        return _unmarshal_attestation(raw) if raw else None

    def attestations(self) -> list:
        return [_unmarshal_attestation(v) for _, v in self.store.iterate(_ATT_PREFIX)]

    # --- EVM address registration (keeper/msg_server.go) -------------------
    def register_evm_address(self, validator: str, evm_address: str) -> None:
        if not self.staking.has_validator(validator):
            raise ValueError(f"no validator {validator}")
        if not (evm_address.startswith("0x") and len(evm_address) == 42):
            raise ValueError(f"invalid EVM address {evm_address}")
        self.store.set(_EVM_PREFIX + validator.encode(), evm_address.encode())

    def evm_address(self, validator: str) -> str | None:
        raw = self.store.get(_EVM_PREFIX + validator.encode())
        return raw.decode() if raw else None

    # --- EndBlocker --------------------------------------------------------
    def end_blocker(self, height: int, time_ns: int) -> list:
        created: list = []
        created += self._handle_valset_request(height, time_ns)
        created += self._handle_data_commitments(height, time_ns)
        self._prune(time_ns)
        return created

    def _current_members(self) -> tuple[BridgeValidator, ...]:
        # Valsets snapshot the ACTIVE set: a jailed validator must drop out
        # (the sdk builds them from bonded validators, keeper_valset.go).
        return tuple(
            BridgeValidator(v.address, v.power, self.evm_address(v.address))
            for v in self.staking.bonded_validators()
        )

    def _latest_valset(self) -> Valset | None:
        for att in reversed(self.attestations()):
            if isinstance(att, Valset):
                return att
        return None

    def _handle_valset_request(self, height: int, time_ns: int) -> list:
        members = self._current_members()
        if not members:
            return []
        latest = self._latest_valset()
        need = latest is None or _normalized_power_diff(
            list(members), list(latest.members)
        ) > SIGNIFICANT_POWER_DIFF
        if not need:
            return []
        vs = Valset(self._next_nonce(), height, time_ns, members)
        self._set_attestation(vs)
        return [vs]

    def _latest_data_commitment(self) -> DataCommitment | None:
        for att in reversed(self.attestations()):
            if isinstance(att, DataCommitment):
                return att
        return None

    # --- query surface (what the BlobstreamX relayer consumes) -------------
    # keeper/query_data_commitment.go, query_valset.go, query_attestation.go
    def latest_data_commitment(self) -> DataCommitment:
        """GetLatestDataCommitment (keeper_data_commitment.go:98-123)."""
        dc = self._latest_data_commitment()
        if dc is None:
            raise KeyError("no data commitment yet")
        return dc

    def data_commitment_for_height(self, height: int) -> DataCommitment:
        """Attestation whose [begin, end) window contains `height`
        (keeper_data_commitment.go:54-96: begin <= h < end, newest first)."""
        latest = self.latest_data_commitment()
        # <= (not the reference's <): end_block is exclusive, so a height
        # equal to it belongs to the *next* window — the reference misreports
        # that boundary as "not found or pruned" instead of "not yet
        # generated"; this keeps the retry-later signal accurate.
        if latest.end_block <= height:
            raise KeyError(
                f"data commitment for height {height} not yet generated "
                f"(latest end {latest.end_block})"
            )
        for att in reversed(self.attestations()):
            if (
                isinstance(att, DataCommitment)
                and att.begin_block <= height < att.end_block
            ):
                return att
        raise KeyError(f"data commitment for height {height} not found or pruned")

    def earliest_available_nonce(self) -> int:
        """Earliest attestation nonce still in store (post-pruning)."""
        atts = self.attestations()
        if not atts:
            raise KeyError("no attestations yet")
        return atts[0].nonce

    def latest_valset_before_nonce(self, nonce: int) -> Valset:
        """Newest valset with nonce <= the given nonce
        (keeper_valset.go GetLatestValsetBeforeNonce via query_valset.go)."""
        for att in reversed(self.attestations()):
            if isinstance(att, Valset) and att.nonce <= nonce:
                return att
        raise KeyError(f"no valset at or before nonce {nonce}")

    def _handle_data_commitments(self, height: int, time_ns: int) -> list:
        """Catch-up loop (abci.go:37-81): for window 400 the ranges are
        [1,401), [401,801), … — the first commitment fires at height 400
        (`height >= window`, abci.go:73) and every later one at
        end_block + window (`height - end >= window`, abci.go:63): 400,
        801, 1201, … — the reference's own cadence, deliberately mirrored
        (the second window is complete at height 800 but the reference
        does not emit it until 801)."""
        created: list = []
        while True:
            latest = self._latest_data_commitment()
            if latest is None:
                if height < self.window:
                    return created
                begin = 1
            else:
                if height - latest.end_block < self.window:
                    return created
                begin = latest.end_block
            dc = DataCommitment(
                self._next_nonce(), begin, begin + self.window, height, time_ns
            )
            self._set_attestation(dc)
            created.append(dc)

    def _prune(self, time_ns: int) -> None:
        for key, raw in self.store.iterate(_ATT_PREFIX):
            att = _unmarshal_attestation(raw)
            if time_ns - att.time_ns > ATTESTATION_EXPIRY_NS:
                self.store.delete(key)
