"""DataAvailabilityHeader: the row and column NMT roots and the data root.

Parity with reference pkg/da/data_availability_header.go:
NewDataAvailabilityHeader :44-63, Hash :92-108 (merkle over rowRoots ||
colRoots), ValidateBasic :134, MinDataAvailabilityHeader :179.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from celestia_app_tpu_torch import merkle
from celestia_app_tpu_torch.constants import (
    MAX_CODEC_SQUARE_SIZE,
    NAMESPACE_ID_SIZE,
    NMT_NODE_SIZE,
    SEQUENCE_LEN_BYTES,
    SHARE_SIZE,
)
from celestia_app_tpu_torch.da.eds import ExtendedDataSquare, extend_shares

_MIN_EDS_WIDTH = 2
_MAX_EDS_WIDTH = 2 * MAX_CODEC_SQUARE_SIZE


@dataclass
class DataAvailabilityHeader:
    row_roots: list[bytes] = field(default_factory=list)
    column_roots: list[bytes] = field(default_factory=list)

    @classmethod
    def from_eds(cls, eds: ExtendedDataSquare) -> "DataAvailabilityHeader":
        return cls(row_roots=eds.row_roots(), column_roots=eds.col_roots())

    def hash(self) -> bytes:
        """Data root: merkle root over row roots then column roots."""
        return merkle.hash_from_byte_slices(self.row_roots + self.column_roots)

    def marshal(self) -> bytes:
        """Proto wire form (proto/celestia/core/v1/da: row_roots=1,
        column_roots=2), byte-equal to the JAX package's."""
        from celestia_app_tpu_torch.encoding.proto import encode_bytes_field

        out = b""
        for r in self.row_roots:
            out += encode_bytes_field(1, r)
        for c in self.column_roots:
            out += encode_bytes_field(2, c)
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "DataAvailabilityHeader":
        from celestia_app_tpu_torch.encoding.proto import WIRE_LEN, decode_fields

        rows, cols = [], []
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                rows.append(val)
            elif num == 2 and wt == WIRE_LEN:
                cols.append(val)
        return cls(rows, cols)

    def validate_basic(self) -> None:
        nr, nc = len(self.row_roots), len(self.column_roots)
        if nr != nc:
            raise ValueError(f"row/col root count mismatch: {nr} vs {nc}")
        if nr < _MIN_EDS_WIDTH:
            raise ValueError(f"too few roots: {nr} < {_MIN_EDS_WIDTH}")
        if nr > _MAX_EDS_WIDTH:
            raise ValueError(f"too many roots: {nr} > {_MAX_EDS_WIDTH}")
        for r in self.row_roots + self.column_roots:
            if len(r) != NMT_NODE_SIZE:
                raise ValueError(f"malformed root length {len(r)}")

    def square_size(self) -> int:
        """ODS width implied by this header."""
        return len(self.row_roots) // 2

    def equals(self, other: "DataAvailabilityHeader") -> bool:
        return (
            self.row_roots == other.row_roots
            and self.column_roots == other.column_roots
        )


def tail_padding_share() -> bytes:
    """The tail-padding share: namespace version 0xFF with id 0xFF^27 || 0xFE
    (shares/namespace.py _secondary(0xFE)), info byte "version 0, sequence
    start", sequence length 0, zero data (shares/share.py padding_share)."""
    namespace = bytes([0xFF]) + bytes([0xFF]) * (NAMESPACE_ID_SIZE - 1) + bytes([0xFE])
    info = bytes([(0 << 1) | 1])
    share = namespace + info + bytes(SEQUENCE_LEN_BYTES)
    return share + bytes(SHARE_SIZE - len(share))


def min_data_availability_header(device=None) -> DataAvailabilityHeader:
    """DAH of the minimal (1x1 tail-padding) square — the empty block's
    root (reference pkg/da/data_availability_header.go:179)."""
    return DataAvailabilityHeader.from_eds(
        extend_shares([tail_padding_share()], device=device)
    )
