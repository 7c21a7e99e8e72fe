"""EVM byte-parity digests for Blobstream attestations.

Reproduces the exact keccak256-over-ABI constructions the reference signs
and the Blobstream contract verifies (x/blobstream/types/valset.go:32-77,
abi_consts.go:113-116, overview.md "data commitment digest"):

  valset_hash      = keccak256(abi.encode(Validator[]{addr, power}))
                     — computeValidatorSetHash's arguments, selector
                     stripped (valset.go:70-76);
  valset_sign_bytes = keccak256(
        "checkpoint"||0.. (bytes32) || nonce (uint256)
        || powerThreshold (uint256) || valset_hash (bytes32))
                     — domainSeparateValidatorSetHash (valset.go:42-56);
  data_commitment_sign_bytes = keccak256(
        "transactionBatch"||0.. || nonce (uint256) || tupleRoot (bytes32))
                     — domainSeparateDataRootTupleRoot.

A validator's EVM address defaults to its operator address bytes
(types/types.go:13 DefaultEVMAddress = BytesToAddress(valAddress)), i.e.
the 20-byte bech32 payload, unless it registered one via
MsgRegisterEVMAddress.  powerThreshold = 2*(total/3 + 1)
(valset.go:80-88 TwoThirdsThreshold).

The port's copy of celestia_app_tpu/modules/blobstream/evm.py.
"""

from __future__ import annotations

from celestia_app_tpu_torch.crypto import bech32
from celestia_app_tpu_torch.crypto.keccak import keccak256

# Domain separator constants copied from the contracts
# (abi_consts.go:113-116).
VS_DOMAIN_SEPARATOR = b"checkpoint".ljust(32, b"\x00")
DC_DOMAIN_SEPARATOR = b"transactionBatch".ljust(32, b"\x00")


def _uint256(n: int) -> bytes:
    return n.to_bytes(32, "big")


def evm_address_bytes(evm_or_bech32: str) -> bytes:
    """20-byte EVM address from a 0x-hex string (registered via
    MsgRegisterEVMAddress) or a bech32 operator address (the
    DefaultEVMAddress rule: the operator's own 20 payload bytes).  Any
    other identifier falls back to geth BytesToAddress semantics over its
    raw utf-8 bytes (harness fixtures use plain labels)."""
    if evm_or_bech32.startswith("0x"):
        raw = bytes.fromhex(evm_or_bech32[2:])
    else:
        try:
            _, raw = bech32.decode(evm_or_bech32)
        except ValueError:
            raw = evm_or_bech32.encode()
    if len(raw) > 20:
        raw = raw[-20:]  # geth BytesToAddress keeps the last 20 bytes
    return raw.rjust(20, b"\x00")


def _abi_address(addr20: bytes) -> bytes:
    return addr20.rjust(32, b"\x00")


def valset_hash(members) -> bytes:
    """computeValidatorSetHash: keccak256 of the ABI encoding of
    Validator[] (a dynamic array of (address, uint256) tuples).

    ABI layout (selector already stripped, valset.go:76 `encodedVals[4:]`):
      word 0: 0x20 — offset of the array
      word 1: len(members)
      then per member: address (left-padded) || power (uint256).
    `members` entries need `.power` and either `.evm_address` (0x-hex or
    None) plus `.address` (bech32), or just `.address`.
    """
    out = _uint256(0x20) + _uint256(len(members))
    for m in members:
        evm = getattr(m, "evm_address", None) or m.address
        out += _abi_address(evm_address_bytes(evm)) + _uint256(m.power)
    return keccak256(out)


def two_thirds_threshold(members) -> int:
    """valset.go:80-88: 2 * (total/3 + 1), integer division."""
    total = sum(m.power for m in members)
    return 2 * (total // 3 + 1)


def valset_sign_bytes(nonce: int, members) -> bytes:
    """Valset.SignBytes (valset.go:32-56): the digest orchestrators sign
    and updateValidatorSet verifies."""
    return keccak256(
        VS_DOMAIN_SEPARATOR
        + _uint256(nonce)
        + _uint256(two_thirds_threshold(members))
        + valset_hash(members)
    )


def data_commitment_sign_bytes(nonce: int, tuple_root: bytes) -> bytes:
    """DataCommitment sign bytes (domainSeparateDataRootTupleRoot): the
    digest behind submitDataRootTupleRoot."""
    if len(tuple_root) != 32:
        raise ValueError("tuple root must be 32 bytes")
    return keccak256(DC_DOMAIN_SEPARATOR + _uint256(nonce) + tuple_root)
