"""Namespaces: 29-byte (1-byte version + 28-byte id) identifiers.

Behavioral parity with the reference namespace spec
(specs/src/specs/namespace.md; go-square/namespace).
"""

from __future__ import annotations

from dataclasses import dataclass

from celestia_app_tpu_torch.constants import (
    NAMESPACE_ID_SIZE,
    NAMESPACE_SIZE,
    NAMESPACE_VERSION_SIZE,
    PARITY_NAMESPACE_BYTES,
)

NAMESPACE_VERSION_ZERO = 0
NAMESPACE_VERSION_MAX = 255
# Version-0 namespace ids must have 18 leading zero bytes; 10 user bytes remain.
NAMESPACE_VERSION_ZERO_PREFIX_LEN = 18
NAMESPACE_VERSION_ZERO_ID_SIZE = NAMESPACE_ID_SIZE - NAMESPACE_VERSION_ZERO_PREFIX_LEN  # 10


@dataclass(frozen=True, order=False)
class Namespace:
    """An immutable 29-byte namespace (version byte + 28-byte id)."""

    version: int
    id: bytes

    def __post_init__(self) -> None:
        if not 0 <= self.version <= NAMESPACE_VERSION_MAX:
            raise ValueError(f"namespace version out of range: {self.version}")
        if len(self.id) != NAMESPACE_ID_SIZE:
            raise ValueError(
                f"namespace id must be {NAMESPACE_ID_SIZE} bytes, got {len(self.id)}"
            )

    # --- constructors -----------------------------------------------------
    @staticmethod
    def from_bytes(raw: bytes) -> "Namespace":
        if len(raw) != NAMESPACE_SIZE:
            raise ValueError(f"namespace must be {NAMESPACE_SIZE} bytes, got {len(raw)}")
        return Namespace(raw[0], bytes(raw[NAMESPACE_VERSION_SIZE:]))

    @staticmethod
    def v0(sub_id: bytes) -> "Namespace":
        """Build a user-specifiable version-0 namespace from <=10 user bytes."""
        if len(sub_id) > NAMESPACE_VERSION_ZERO_ID_SIZE:
            raise ValueError(
                f"version-0 sub-id too long: {len(sub_id)} > {NAMESPACE_VERSION_ZERO_ID_SIZE}"
            )
        padded = bytes(NAMESPACE_ID_SIZE - len(sub_id)) + sub_id
        return Namespace(NAMESPACE_VERSION_ZERO, padded)

    # --- encoding ---------------------------------------------------------
    def to_bytes(self) -> bytes:
        return bytes([self.version]) + self.id

    def __bytes__(self) -> bytes:  # pragma: no cover - convenience
        return self.to_bytes()

    # --- ordering (lexicographic over the 29 encoded bytes) ---------------
    def __lt__(self, other: "Namespace") -> bool:
        return self.to_bytes() < other.to_bytes()

    def __le__(self, other: "Namespace") -> bool:
        return self.to_bytes() <= other.to_bytes()

    def __gt__(self, other: "Namespace") -> bool:
        return self.to_bytes() > other.to_bytes()

    def __ge__(self, other: "Namespace") -> bool:
        return self.to_bytes() >= other.to_bytes()

    # --- classification ---------------------------------------------------
    def is_reserved(self) -> bool:
        return self.is_primary_reserved() or self.is_secondary_reserved()

    def is_primary_reserved(self) -> bool:
        return self <= MAX_PRIMARY_RESERVED_NAMESPACE

    def is_secondary_reserved(self) -> bool:
        return self >= MIN_SECONDARY_RESERVED_NAMESPACE

    def is_parity(self) -> bool:
        return self == PARITY_SHARE_NAMESPACE

    def is_tail_padding(self) -> bool:
        return self == TAIL_PADDING_NAMESPACE

    def is_pay_for_blob(self) -> bool:
        return self == PAY_FOR_BLOB_NAMESPACE

    def is_compact(self) -> bool:
        """Compact (tx/PFB) namespaces carry reserved bytes in their shares."""
        return self.is_tx() or self.is_pay_for_blob()

    def is_tx(self) -> bool:
        return self == TRANSACTION_NAMESPACE

    def is_supported_user_namespace(self) -> bool:
        """True iff a user may submit blobs under this namespace."""
        return (
            self.version == NAMESPACE_VERSION_ZERO
            and self.id[:NAMESPACE_VERSION_ZERO_PREFIX_LEN]
            == bytes(NAMESPACE_VERSION_ZERO_PREFIX_LEN)
            and not self.is_reserved()
        )

    def validate_for_blob(self) -> None:
        if not self.is_supported_user_namespace():
            raise ValueError(f"invalid user blob namespace: {self.to_bytes().hex()}")

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Namespace(0x{self.to_bytes().hex()})"


def _primary(last_byte: int) -> Namespace:
    return Namespace(0, bytes(NAMESPACE_ID_SIZE - 1) + bytes([last_byte]))


def _secondary(last_byte: int) -> Namespace:
    return Namespace(0xFF, bytes([0xFF] * (NAMESPACE_ID_SIZE - 1)) + bytes([last_byte]))


# Reserved namespaces (specs/src/specs/namespace.md "Reserved Namespaces").
TRANSACTION_NAMESPACE = _primary(0x01)
INTERMEDIATE_STATE_ROOT_NAMESPACE = _primary(0x02)
PAY_FOR_BLOB_NAMESPACE = _primary(0x04)
PRIMARY_RESERVED_PADDING_NAMESPACE = _primary(0xFF)
MAX_PRIMARY_RESERVED_NAMESPACE = _primary(0xFF)
MIN_SECONDARY_RESERVED_NAMESPACE = _secondary(0x00)
TAIL_PADDING_NAMESPACE = _secondary(0xFE)
PARITY_SHARE_NAMESPACE = _secondary(0xFF)

PARITY_NS_BYTES = PARITY_SHARE_NAMESPACE.to_bytes()
if PARITY_NS_BYTES != PARITY_NAMESPACE_BYTES:
    raise AssertionError("PARITY_SHARE_NAMESPACE diverged from constants.PARITY_NAMESPACE_BYTES")
