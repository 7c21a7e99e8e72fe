"""The 512-byte share: the atomic unit of the data square.

Byte layout (specs/src/specs/shares.md "Share Format"):

    namespace (29) | info byte (1) | [sequence len (4) if seq start]
    | [reserved bytes (4) if compact] | data ... zero-padded to 512

Info byte: 7-bit share version (big-endian high bits) | 1-bit sequence-start.
"""

from __future__ import annotations

from dataclasses import dataclass

from celestia_app_tpu_torch.constants import (
    COMPACT_SHARE_RESERVED_BYTES,
    MAX_SHARE_VERSION,
    NAMESPACE_SIZE,
    SEQUENCE_LEN_BYTES,
    SHARE_INFO_BYTES,
    SHARE_SIZE,
    SHARE_VERSION_ZERO,
)
from celestia_app_tpu_torch.shares.namespace import (
    Namespace,
    PRIMARY_RESERVED_PADDING_NAMESPACE,
    TAIL_PADDING_NAMESPACE,
)

SUPPORTED_SHARE_VERSIONS = (SHARE_VERSION_ZERO,)


def make_info_byte(share_version: int, is_sequence_start: bool) -> int:
    if not 0 <= share_version <= MAX_SHARE_VERSION:
        raise ValueError(f"share version out of range: {share_version}")
    return (share_version << 1) | int(bool(is_sequence_start))


def parse_info_byte(b: int) -> tuple[int, bool]:
    """Returns (share_version, is_sequence_start)."""
    return b >> 1, bool(b & 1)


@dataclass(frozen=True)
class Share:
    """An immutable 512-byte share."""

    raw: bytes

    def __post_init__(self) -> None:
        if len(self.raw) != SHARE_SIZE:
            raise ValueError(f"share must be {SHARE_SIZE} bytes, got {len(self.raw)}")

    # --- field accessors --------------------------------------------------
    def namespace(self) -> Namespace:
        return Namespace.from_bytes(self.raw[:NAMESPACE_SIZE])

    def info_byte(self) -> int:
        return self.raw[NAMESPACE_SIZE]

    def share_version(self) -> int:
        return parse_info_byte(self.info_byte())[0]

    def is_sequence_start(self) -> bool:
        return parse_info_byte(self.info_byte())[1]

    def sequence_len(self) -> int:
        """Big-endian uint32 sequence length; only present on sequence starts."""
        if not self.is_sequence_start():
            raise ValueError("sequence length only present in first share of a sequence")
        off = NAMESPACE_SIZE + SHARE_INFO_BYTES
        return int.from_bytes(self.raw[off : off + SEQUENCE_LEN_BYTES], "big")

    def is_compact(self) -> bool:
        ns = self.namespace()
        return ns.is_compact()

    def reserved_bytes(self) -> int:
        """Big-endian uint32 index of the first unit starting in this (compact) share."""
        if not self.is_compact():
            raise ValueError("reserved bytes only present in compact shares")
        off = NAMESPACE_SIZE + SHARE_INFO_BYTES
        if self.is_sequence_start():
            off += SEQUENCE_LEN_BYTES
        return int.from_bytes(self.raw[off : off + COMPACT_SHARE_RESERVED_BYTES], "big")

    def data(self) -> bytes:
        """The raw data region (everything after the prefix fields)."""
        off = NAMESPACE_SIZE + SHARE_INFO_BYTES
        if self.is_sequence_start():
            off += SEQUENCE_LEN_BYTES
        if self.is_compact():
            off += COMPACT_SHARE_RESERVED_BYTES
        return self.raw[off:]

    def is_padding(self) -> bool:
        ns = self.namespace()
        if ns == TAIL_PADDING_NAMESPACE or ns == PRIMARY_RESERVED_PADDING_NAMESPACE:
            return True
        return self.is_sequence_start() and not self.is_compact() and self.sequence_len() == 0

    def validate(self) -> None:
        if self.share_version() not in SUPPORTED_SHARE_VERSIONS:
            raise ValueError(f"unsupported share version {self.share_version()}")


def _build_prefix(
    namespace: Namespace,
    share_version: int,
    is_sequence_start: bool,
    sequence_len: int | None,
) -> bytearray:
    buf = bytearray()
    buf += namespace.to_bytes()
    buf.append(make_info_byte(share_version, is_sequence_start))
    if is_sequence_start:
        if sequence_len is None:
            raise ValueError("sequence start share requires a sequence length")
        buf += int(sequence_len).to_bytes(SEQUENCE_LEN_BYTES, "big")
    return buf


def shares_needed(total_bytes: int, first_content_size: int, cont_content_size: int) -> int:
    """Shares needed for a sequence of total_bytes of content."""
    if total_bytes == 0:
        return 0
    if total_bytes <= first_content_size:
        return 1
    rem = total_bytes - first_content_size
    return 1 + -(-rem // cont_content_size)


def padding_share(namespace: Namespace, share_version: int = SHARE_VERSION_ZERO) -> Share:
    """A padding share: sequence start, sequence length 0, zero data.

    Only sparse (non-compact) namespaces are valid: padding never occurs
    inside the compact tx/PFB runs, and a compact-namespace share without
    reserved bytes would be malformed.
    """
    if namespace.is_compact():
        raise ValueError(f"padding shares cannot use compact namespace {namespace}")
    buf = _build_prefix(namespace, share_version, True, 0)
    buf += bytes(SHARE_SIZE - len(buf))
    return Share(bytes(buf))


def namespace_padding_shares(namespace: Namespace, n: int) -> list[Share]:
    return [padding_share(namespace)] * n


def reserved_padding_shares(n: int) -> list[Share]:
    return [padding_share(PRIMARY_RESERVED_PADDING_NAMESPACE)] * n


def tail_padding_shares(n: int) -> list[Share]:
    return [padding_share(TAIL_PADDING_NAMESPACE)] * n


def shares_to_bytes(shares: list[Share]) -> list[bytes]:
    return [s.raw for s in shares]


def shares_from_bytes(raw: list[bytes]) -> list[Share]:
    return [Share(r) for r in raw]
