"""Blob share commitments: the ShareCommitment in MsgPayForBlobs (the
port's copy of celestia_app_tpu/inclusion/commitment.py).

Behavioral parity with the reference commitment scheme
(x/blob/types/payforblob.go:48-77 -> go-square inclusion.CreateCommitment;
spec data_square_layout.md "Blob Share Commitment Rules"):

  1. split the blob into shares;
  2. chop the share run into a Merkle-mountain-range of power-of-two chunks,
     the largest being the blob's SubtreeWidth;
  3. each chunk's root is an NMT over ns-prefixed shares — identical, by the
     alignment rules, to an inner node of the row NMTs of any square the
     blob lands in;
  4. the commitment is the binary merkle root over the chunk roots.

Because of (3) the commitment is independent of the square size, and can be
re-derived from a committed square by indexing the row trees' levels.
Everything here runs on the host (hashlib); inclusion/batched.py hashes
many blobs' chunks on the card.
"""

from __future__ import annotations

from celestia_app_tpu_torch.constants import SUBTREE_ROOT_THRESHOLD
from celestia_app_tpu_torch.merkle import hash_from_byte_slices
from celestia_app_tpu_torch.nmt.tree import NamespacedMerkleTree
from celestia_app_tpu_torch.shares.sparse import Blob, split_blob
from celestia_app_tpu_torch.square.layout import round_down_power_of_two, subtree_width


def merkle_mountain_range_sizes(total_size: int, max_tree_size: int) -> list[int]:
    """Chunk sizes: max_tree_size repeated, then descending powers of two."""
    sizes: list[int] = []
    while total_size:
        if total_size >= max_tree_size:
            sizes.append(max_tree_size)
            total_size -= max_tree_size
        else:
            s = round_down_power_of_two(total_size)
            sizes.append(s)
            total_size -= s
    return sizes


def create_commitment(
    blob: Blob, subtree_root_threshold: int = SUBTREE_ROOT_THRESHOLD
) -> bytes:
    """The 32-byte share commitment for one blob."""
    shares = split_blob(blob)
    width = subtree_width(len(shares), subtree_root_threshold)
    sizes = merkle_mountain_range_sizes(len(shares), width)
    ns = blob.namespace.to_bytes()
    roots: list[bytes] = []
    cursor = 0
    for size in sizes:
        tree = NamespacedMerkleTree()
        for s in shares[cursor : cursor + size]:
            tree.push(ns + s.raw)
        roots.append(tree.root())
        cursor += size
    return hash_from_byte_slices(roots)


def create_commitments(
    blobs: list[Blob], subtree_root_threshold: int = SUBTREE_ROOT_THRESHOLD
) -> list[bytes]:
    return [create_commitment(b, subtree_root_threshold) for b in blobs]


def subtree_root_coordinates(
    start: int, share_count: int, square_size: int, subtree_root_threshold: int
) -> list[tuple[int, int, int]]:
    """(row, height, index-in-level) of each commitment chunk root.

    `start` is the blob's first share index (row-major ODS coordinates).
    Mirrors pkg/inclusion/paths.go:16-47 calculateCommitmentPaths, but as
    array coordinates into retained tree levels instead of tree-walk paths.
    The layout rules guarantee each chunk lies within one row.
    """
    width = subtree_width(share_count, subtree_root_threshold)
    sizes = merkle_mountain_range_sizes(share_count, width)
    coords: list[tuple[int, int, int]] = []
    cursor = start
    for size in sizes:
        row, col = divmod(cursor, square_size)
        if col % size or col + size > square_size:
            raise ValueError(
                f"misaligned chunk: start {cursor} size {size} in square {square_size}"
            )
        coords.append((row, size.bit_length() - 1, col // size))
        cursor += size
    return coords


def commitment_from_row_trees(
    row_trees: dict[int, NamespacedMerkleTree],
    start: int,
    share_count: int,
    square_size: int,
    subtree_root_threshold: int = SUBTREE_ROOT_THRESHOLD,
) -> bytes:
    """Re-derive a blob's commitment from a square's row trees.

    `row_trees` maps ODS row index -> that row's NMT (over the full 2k
    extended row), e.g. `{r: eds.row_tree(r, host=True) for r in rows}`.  Parity with
    pkg/inclusion/get_commit.go:12-30 GetCommitment, with the cached-node
    walk replaced by level indexing.
    """
    roots: list[bytes] = []
    for row, height, idx in subtree_root_coordinates(
        start, share_count, square_size, subtree_root_threshold
    ):
        size = 1 << height
        roots.append(row_trees[row].subtree_root(idx * size, (idx + 1) * size))
    return hash_from_byte_slices(roots)
