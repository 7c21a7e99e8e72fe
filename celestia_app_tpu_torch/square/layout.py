"""Blob placement math: the non-interactive default rules.

Behavioral parity with the reference's layout spec
(specs/src/specs/data_square_layout.md "Blob Share Commitment Rules";
go-square non_interactive_defaults semantics, ADR-013): a blob's first share
index must be a multiple of its SubtreeWidth, which is a function of the blob
size and SubtreeRootThreshold only — never of the square size — so share
commitments are square-size independent.
"""

from __future__ import annotations

import math


def round_up_power_of_two(n: int) -> int:
    """Smallest power of two >= n (n >= 1 -> >= 1)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def round_down_power_of_two(n: int) -> int:
    if n < 1:
        raise ValueError("n must be >= 1")
    return 1 << (n.bit_length() - 1)


def blob_min_square_size(share_count: int) -> int:
    """Smallest square size that could fit `share_count` shares."""
    sc = max(share_count, 1)
    return round_up_power_of_two(math.isqrt(sc - 1) + 1)  # ceil(sqrt(sc)), pow2


def subtree_width(share_count: int, subtree_root_threshold: int) -> int:
    """Width (in shares) of the largest subtree root mountain for a blob.

    ceil(share_count / threshold), rounded up to a power of two, capped at
    the blob's minimum square size.
    """
    s = -(-share_count // subtree_root_threshold)
    return min(round_up_power_of_two(s), blob_min_square_size(share_count))


def next_share_index(cursor: int, blob_share_len: int, subtree_root_threshold: int) -> int:
    """First valid start index >= cursor for a blob of blob_share_len shares."""
    width = subtree_width(blob_share_len, subtree_root_threshold)
    return -(-cursor // width) * width


def next_multiple_of_blob_min_square_size(cursor: int, share_count: int) -> int:
    """Alignment used by the v0 commitment scheme's first mountain."""
    w = blob_min_square_size(share_count)
    return -(-cursor // w) * w
