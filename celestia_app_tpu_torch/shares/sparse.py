"""Sparse (blob) share splitting and merging.

A blob is written to one share sequence: the first share carries the
sequence-start flag and the blob length; continuation shares carry only raw
data; the final share is zero-padded (specs/src/specs/shares.md "Share
Splitting").
"""

from __future__ import annotations

from dataclasses import dataclass, field

from celestia_app_tpu_torch.constants import (
    CONTINUATION_SPARSE_SHARE_CONTENT_SIZE,
    FIRST_SPARSE_SHARE_CONTENT_SIZE,
    SHARE_SIZE,
    SHARE_VERSION_ZERO,
)
from celestia_app_tpu_torch.shares.namespace import Namespace
from celestia_app_tpu_torch.shares.share import (
    Share,
    _build_prefix,
    namespace_padding_shares,
    shares_needed,
)


@dataclass(frozen=True)
class Blob:
    """User data bound to exactly one namespace."""

    namespace: Namespace
    data: bytes
    share_version: int = SHARE_VERSION_ZERO

    def __post_init__(self) -> None:
        if self.share_version != SHARE_VERSION_ZERO:
            raise ValueError(f"unsupported share version {self.share_version}")
        if len(self.data) == 0:
            raise ValueError("blob data must not be empty")

    def share_count(self) -> int:
        return sparse_shares_needed(len(self.data))

    def compare(self, other: "Blob") -> int:
        a, b = self.namespace.to_bytes(), other.namespace.to_bytes()
        return (a > b) - (a < b)


def sparse_shares_needed(blob_len: int) -> int:
    """Number of shares a blob of blob_len bytes occupies."""
    return shares_needed(
        blob_len, FIRST_SPARSE_SHARE_CONTENT_SIZE, CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
    )


def split_blob(blob: Blob) -> list[Share]:
    """Split one blob into its share sequence.

    Vectorized: all continuation shares are one numpy reshape over the
    blob bytes instead of a per-share Python loop — share splitting is
    the square builder's dominant host cost at big squares."""
    import numpy as np

    data = blob.data
    n = len(data)
    first_prefix = bytes(
        _build_prefix(blob.namespace, blob.share_version, True, n)
    )
    first_room = SHARE_SIZE - len(first_prefix)
    if n <= first_room:
        buf = first_prefix + data
        return [Share(buf + bytes(SHARE_SIZE - len(buf)))]

    cont_prefix = bytes(
        _build_prefix(blob.namespace, blob.share_version, False, None)
    )
    cont_room = SHARE_SIZE - len(cont_prefix)
    rest = np.frombuffer(data, dtype=np.uint8)[first_room:]
    n_cont = -(-rest.size // cont_room)
    arr = np.zeros((1 + n_cont, SHARE_SIZE), dtype=np.uint8)
    arr[0, : len(first_prefix)] = np.frombuffer(first_prefix, dtype=np.uint8)
    arr[0, len(first_prefix):] = np.frombuffer(
        data[:first_room], dtype=np.uint8
    )
    arr[1:, : len(cont_prefix)] = np.frombuffer(cont_prefix, dtype=np.uint8)
    pad = (-rest.size) % cont_room
    if pad:
        rest = np.concatenate([rest, np.zeros(pad, dtype=np.uint8)])
    arr[1:, len(cont_prefix):] = rest.reshape(n_cont, cont_room)
    share_bytes = arr.tobytes()
    return [
        Share(share_bytes[i * SHARE_SIZE : (i + 1) * SHARE_SIZE])
        for i in range(1 + n_cont)
    ]


class SparseShareSplitter:
    """Accumulates blobs (and namespace padding) into a share list."""

    def __init__(self) -> None:
        self._shares: list[Share] = []

    def write(self, blob: Blob) -> None:
        self._shares.extend(split_blob(blob))

    def write_namespace_padding(self, n: int) -> None:
        """Pad with the namespace of the last written blob (layout invariant)."""
        if n == 0:
            return
        if not self._shares:
            raise ValueError("cannot write namespace padding before any blob")
        self._shares.extend(namespace_padding_shares(self._shares[-1].namespace(), n))

    def export(self) -> list[Share]:
        return list(self._shares)

    def count(self) -> int:
        return len(self._shares)


def parse_sparse_shares(shares: list[Share]) -> list[Blob]:
    """Merge a sorted run of sparse shares back into blobs (inverse of split)."""
    blobs: list[Blob] = []
    i = 0
    while i < len(shares):
        s = shares[i]
        if not s.is_sequence_start():
            raise ValueError(f"share {i} is not a sequence start")
        seq_len = s.sequence_len()
        if seq_len == 0:  # padding share
            i += 1
            continue
        ns = s.namespace()
        version = s.share_version()
        data = bytearray(s.data())
        i += 1
        while len(data) < seq_len:
            if i >= len(shares):
                raise ValueError("share sequence truncated")
            cont = shares[i]
            if cont.is_sequence_start():
                raise ValueError("unexpected sequence start inside sequence")
            if cont.namespace() != ns:
                raise ValueError("namespace changed mid-sequence")
            data += cont.data()
            i += 1
        blobs.append(Blob(ns, bytes(data[:seq_len]), version))
    return blobs
