"""Compact (transaction) share splitting and merging.

Transactions in the TRANSACTION_NAMESPACE / PAY_FOR_BLOB_NAMESPACE are
varint-length-prefixed and written continuously across shares.  Every compact
share carries 4 "reserved bytes": the in-share byte index of the start of the
first unit that *starts* in the share, or 0 (specs/src/specs/shares.md
"Transaction Shares").
"""

from __future__ import annotations

from celestia_app_tpu_torch.constants import (
    COMPACT_SHARE_RESERVED_BYTES,
    CONTINUATION_COMPACT_SHARE_CONTENT_SIZE,
    FIRST_COMPACT_SHARE_CONTENT_SIZE,
    NAMESPACE_SIZE,
    SEQUENCE_LEN_BYTES,
    SHARE_INFO_BYTES,
    SHARE_SIZE,
    SHARE_VERSION_ZERO,
)
from celestia_app_tpu_torch.shares.namespace import Namespace
from celestia_app_tpu_torch.shares.share import Share, _build_prefix, shares_needed

_FIRST_DATA_OFFSET = (
    NAMESPACE_SIZE + SHARE_INFO_BYTES + SEQUENCE_LEN_BYTES + COMPACT_SHARE_RESERVED_BYTES
)  # 38
_CONT_DATA_OFFSET = NAMESPACE_SIZE + SHARE_INFO_BYTES + COMPACT_SHARE_RESERVED_BYTES  # 34


def write_uvarint(n: int) -> bytes:
    """Protobuf unsigned varint encoding."""
    if n < 0:
        raise ValueError("uvarint must be non-negative")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_uvarint(buf: bytes, pos: int) -> tuple[int, int]:
    """Returns (value, new_pos)."""
    shift = 0
    value = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated uvarint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7
        if shift > 63:
            raise ValueError("uvarint overflow")


def split_txs(txs: list[bytes], namespace: Namespace) -> list[Share]:
    """Split length-prefixed txs into one compact share sequence."""
    if not txs:
        return []
    # Sequence data = concat(uvarint(len(tx)) || tx); record unit start offsets.
    data = bytearray()
    unit_starts: list[int] = []
    for tx in txs:
        unit_starts.append(len(data))
        data += write_uvarint(len(tx))
        data += tx
    seq_len = len(data)

    # Chunk the sequence data into share content regions.
    chunks: list[bytes] = []
    chunk_ranges: list[tuple[int, int]] = []  # [start, end) in sequence coords
    pos = 0
    size = FIRST_COMPACT_SHARE_CONTENT_SIZE
    while pos < seq_len:
        chunks.append(bytes(data[pos : pos + size]))
        chunk_ranges.append((pos, min(pos + size, seq_len)))
        pos += size
        size = CONTINUATION_COMPACT_SHARE_CONTENT_SIZE

    shares: list[Share] = []
    starts_iter = iter(unit_starts)
    next_start = next(starts_iter, None)
    for i, (chunk, (lo, hi)) in enumerate(zip(chunks, chunk_ranges)):
        first = i == 0
        # Reserved bytes: in-share index of the first unit starting in [lo, hi).
        while next_start is not None and next_start < lo:
            next_start = next(starts_iter, None)
        data_off = _FIRST_DATA_OFFSET if first else _CONT_DATA_OFFSET
        if next_start is not None and lo <= next_start < hi:
            reserved = data_off + (next_start - lo)
        else:
            reserved = 0
        buf = _build_prefix(namespace, SHARE_VERSION_ZERO, first, seq_len if first else None)
        buf += int(reserved).to_bytes(COMPACT_SHARE_RESERVED_BYTES, "big")
        buf += chunk
        buf += bytes(SHARE_SIZE - len(buf))
        shares.append(Share(bytes(buf)))
    return shares


def parse_compact_shares(shares: list[Share]) -> list[bytes]:
    """Inverse of split_txs: recover the tx list from a compact share run."""
    if not shares:
        return []
    first = shares[0]
    if not first.is_sequence_start():
        raise ValueError("first compact share must be a sequence start")
    ns = first.namespace()
    seq_len = first.sequence_len()
    data = bytearray(first.data())
    for i, s in enumerate(shares[1:], start=1):
        if s.is_sequence_start():
            raise ValueError(f"unexpected sequence start in compact share {i}")
        if s.namespace() != ns:
            raise ValueError(f"namespace changed mid-sequence at compact share {i}")
        data += s.data()
    if len(data) < seq_len:
        raise ValueError(
            f"compact share run truncated: sequence length {seq_len}, got {len(data)} bytes"
        )
    buf = bytes(data[:seq_len])
    txs: list[bytes] = []
    pos = 0
    while pos < len(buf):
        ln, pos = read_uvarint(buf, pos)
        if pos + ln > len(buf):
            raise ValueError("truncated tx in compact shares")
        txs.append(buf[pos : pos + ln])
        pos += ln
    return txs


def compact_shares_needed(total_prefixed_bytes: int) -> int:
    """Shares needed for a sequence of total_prefixed_bytes (incl. varints)."""
    return shares_needed(
        total_prefixed_bytes,
        FIRST_COMPACT_SHARE_CONTENT_SIZE,
        CONTINUATION_COMPACT_SHARE_CONTENT_SIZE,
    )


def tx_sequence_len(txs: list[bytes]) -> int:
    return sum(len(write_uvarint(len(t))) + len(t) for t in txs)
