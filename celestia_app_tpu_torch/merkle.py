"""Plain binary Merkle tree (RFC-6962 style), host side.

Parity with the reference's go-square/merkle, which hashes the DAH data root
(pkg/da/data_availability_header.go:100-107):

    empty root = sha256("")
    leaf       = sha256(0x00 || data)
    inner      = sha256(0x01 || left || right)
    split point = largest power of two strictly less than n

The device version for power-of-two leaf counts is kernels/merkle.py.
Audit paths (`proof`, `path_from_levels`) and their verification serve
the data-root leg of share proofs (proof/share_proof.py).
"""

from __future__ import annotations

import hashlib

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"


def leaf_hash(data: bytes) -> bytes:
    return hashlib.sha256(LEAF_PREFIX + data).digest()


def inner_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(INNER_PREFIX + left + right).digest()


def split_point(n: int) -> int:
    """Largest power of two strictly less than n (n >= 2)."""
    p = 1 << (n - 1).bit_length() - 1
    return p if p < n else p // 2


def hash_from_byte_slices(items: list[bytes]) -> bytes:
    """Merkle root of a list of byte slices."""
    n = len(items)
    if n == 0:
        return hashlib.sha256(b"").digest()
    if n == 1:
        return leaf_hash(items[0])
    k = split_point(n)
    return inner_hash(hash_from_byte_slices(items[:k]), hash_from_byte_slices(items[k:]))


def proof(items: list[bytes], index: int) -> list[bytes]:
    """Audit path (sibling hashes, leaf-to-root) for items[index]."""
    n = len(items)
    if not 0 <= index < n:
        raise IndexError(index)
    if n == 1:
        return []
    k = split_point(n)
    if index < k:
        return proof(items[:k], index) + [hash_from_byte_slices(items[k:])]
    return proof(items[k:], index - k) + [hash_from_byte_slices(items[:k])]


def levels_from_leaves(items: list[bytes]) -> list[list[bytes]]:
    """All tree levels (leaf hashes first, [root] last) of a power-of-two
    leaf count, so that every audit path is indexing (`path_from_levels`).
    split_point(n) is n/2 exactly then, so levels and `proof` agree."""
    n = len(items)
    if n & (n - 1) or n == 0:
        raise ValueError(f"levels_from_leaves needs a power of two, got {n}")
    level = [leaf_hash(i) for i in items]
    levels = [level]
    while len(level) > 1:
        level = [inner_hash(level[i], level[i + 1]) for i in range(0, len(level), 2)]
        levels.append(level)
    return levels


def path_from_levels(levels: list[list[bytes]], index: int) -> list[bytes]:
    """Audit path (leaf-to-root) from precomputed levels; byte-identical to
    `proof(items, index)` for power-of-two item counts."""
    n = len(levels[0])
    if not 0 <= index < n:
        raise IndexError(index)
    path = []
    for level in levels[:-1]:
        path.append(level[index ^ 1])
        index //= 2
    return path


def compute_root_from_path(index: int, total: int, leaf_h: bytes, path: list[bytes]) -> bytes:
    """Root implied by a leaf hash and its audit path (leaf-to-root order)."""
    if total <= 0 or not 0 <= index < total:
        raise ValueError(f"bad index {index} / total {total}")
    if total == 1:
        if path:
            raise ValueError("path too long")
        return leaf_h
    if not path:
        raise ValueError("path too short")
    k = split_point(total)
    if index < k:
        left = compute_root_from_path(index, k, leaf_h, path[:-1])
        return inner_hash(left, path[-1])
    right = compute_root_from_path(index - k, total - k, leaf_h, path[:-1])
    return inner_hash(path[-1], right)


def verify_proof(root: bytes, leaf: bytes, index: int, total: int, path: list[bytes]) -> bool:
    """Verify an audit path produced by `proof`."""
    try:
        return compute_root_from_path(index, total, leaf_hash(leaf), path) == root
    except ValueError:
        return False
