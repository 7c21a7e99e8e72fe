"""Consensus tx envelopes: BlobTx and IndexWrapper.

Wire layouts follow reference proto/celestia/core/v1/blob/blob.proto and the
IndexWrapper table in specs/src/specs/data_structures.md:

  Blob         { bytes namespace_id = 1; bytes data = 2;
                 uint32 share_version = 3; uint32 namespace_version = 4; }
  BlobTx       { bytes tx = 1; repeated Blob blobs = 2; string type_id = 3; }
  IndexWrapper { bytes tx = 1; repeated uint32 share_indexes = 2;
                 string type_id = 3; }

A BlobTx carries blobs alongside the signed sdk tx through the mempool and
the proposal; an IndexWrapper is what the block proposer writes into the
square's PAY_FOR_BLOB compact shares — the PFB tx plus the share index of
each blob it pays for.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from celestia_app_tpu_torch.encoding.proto import (
    WIRE_LEN,
    WIRE_VARINT,
    decode_fields,
    decode_packed_uint32,
    encode_bytes_field,
    encode_packed_uint32_field,
    encode_uvarint,
    encode_varint_field,
)
from celestia_app_tpu_torch.shares.namespace import Namespace
from celestia_app_tpu_torch.shares.sparse import Blob

BLOB_TX_TYPE_ID = b"BLOB"
INDEX_WRAPPER_TYPE_ID = b"INDX"


def marshal_blob(blob: Blob) -> bytes:
    return (
        encode_bytes_field(1, blob.namespace.id)
        + encode_bytes_field(2, blob.data)
        + encode_varint_field(3, blob.share_version)
        + encode_varint_field(4, blob.namespace.version)
    )


def unmarshal_blob(buf: bytes) -> Blob:
    ns_id = b""
    data = b""
    share_version = 0
    ns_version = 0
    for num, wt, val in decode_fields(buf):
        if num == 1 and wt == WIRE_LEN:
            ns_id = val
        elif num == 2 and wt == WIRE_LEN:
            data = val
        elif num == 3 and wt == WIRE_VARINT:
            share_version = val
        elif num == 4 and wt == WIRE_VARINT:
            ns_version = val
    return Blob(Namespace(ns_version, ns_id), data, share_version)


@dataclass(frozen=True)
class BlobTx:
    """A signed sdk tx (containing a MsgPayForBlobs) plus its blobs."""

    tx: bytes
    blobs: tuple[Blob, ...]

    def marshal(self) -> bytes:
        out = encode_bytes_field(1, self.tx)
        for b in self.blobs:
            out += encode_bytes_field(2, marshal_blob(b))
        out += encode_bytes_field(3, BLOB_TX_TYPE_ID)
        return out


def unmarshal_blob_tx(raw: bytes) -> BlobTx | None:
    """Returns the BlobTx, or None if `raw` is not a BlobTx envelope.

    Mirrors go-square blob.UnmarshalBlobTx as used at app/check_tx.go:19 and
    app/process_proposal.go:59: the type_id field must equal "BLOB".
    """
    try:
        fields = decode_fields(raw)
    except ValueError:
        return None
    tx = b""
    blobs: list[Blob] = []
    type_id = b""
    try:
        for num, wt, val in fields:
            if num == 1 and wt == WIRE_LEN:
                tx = val
            elif num == 2 and wt == WIRE_LEN:
                blobs.append(unmarshal_blob(val))
            elif num == 3 and wt == WIRE_LEN:
                type_id = val
    except ValueError:
        return None
    if type_id != BLOB_TX_TYPE_ID or not blobs:
        return None
    return BlobTx(tx, tuple(blobs))


@dataclass(frozen=True)
class IndexWrapper:
    """A PFB tx wrapped with the first-share index of each of its blobs."""

    tx: bytes
    share_indexes: tuple[int, ...]

    def marshal(self) -> bytes:
        return (
            encode_bytes_field(1, self.tx)
            + encode_packed_uint32_field(2, list(self.share_indexes))
            + encode_bytes_field(3, INDEX_WRAPPER_TYPE_ID)
        )

    def marshal_with_worst_case_indexes(self, upper_bound: int) -> bytes:
        """Envelope bytes with every index at `upper_bound` — the size cap
        used while the final blob positions are still unknown."""
        return IndexWrapper(
            self.tx, tuple(upper_bound for _ in self.share_indexes)
        ).marshal()


def unmarshal_index_wrapper(raw: bytes) -> IndexWrapper | None:
    """Returns the IndexWrapper, or None if `raw` is not one (type_id gate)."""
    try:
        fields = decode_fields(raw)
    except ValueError:
        return None
    tx = b""
    indexes: list[int] = []
    type_id = b""
    for num, wt, val in fields:
        if num == 1 and wt == WIRE_LEN:
            tx = val
        elif num == 2 and wt == WIRE_LEN:
            indexes.extend(decode_packed_uint32(val))
        elif num == 2 and wt == WIRE_VARINT:
            indexes.append(val)
        elif num == 3 and wt == WIRE_LEN:
            type_id = val
    if type_id != INDEX_WRAPPER_TYPE_ID:
        return None
    return IndexWrapper(tx, tuple(indexes))


def uvarint_size(n: int) -> int:
    return len(encode_uvarint(n))


def tx_hash(raw_tx: bytes) -> bytes:
    """Canonical tx hash: sha256 over the full broadcast bytes (BlobTx
    envelope included). The single join key between client confirmation
    polling, the node's tx index, and the RPC tx-status query."""
    return hashlib.sha256(raw_tx).digest()
