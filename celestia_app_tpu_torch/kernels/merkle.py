"""Binary RFC-6962 Merkle root for a power-of-two number of leaves, on the
device: the DAH data root over the 4k row and column roots.  For
power-of-two n the split rule halves exactly, so the tree is a level
reduction of batched SHA-256 calls (host version: celestia_app_tpu_torch.merkle).
"""

from __future__ import annotations

import torch

from celestia_app_tpu_torch.kernels.sha256 import sha256


def merkle_roots_pow2(leaves: torch.Tensor) -> torch.Tensor:
    """(B, N, L) uint8 leaves of B trees, N a power of two -> (B, 32) roots:
    one SHA-256 launch per level for all B trees."""
    b, n, length = leaves.shape
    if n < 1 or n & (n - 1):
        raise ValueError(f"leaf count must be a power of two, got {n}")
    prefix = torch.zeros((b, n, 1), dtype=torch.uint8, device=leaves.device)
    # leaves: 0x00 || root
    level = sha256(torch.cat([prefix, leaves], dim=2).reshape(b * n, length + 1)).view(b, n, 32)
    while level.shape[1] > 1:
        pairs = level.reshape(b, -1, 64)  # left || right
        ones = torch.ones((b, pairs.shape[1], 1), dtype=torch.uint8, device=leaves.device)
        level = sha256(torch.cat([ones, pairs], dim=2).reshape(-1, 65)).view(b, -1, 32)
    return level[:, 0]


def merkle_root_pow2(leaves: torch.Tensor) -> torch.Tensor:
    """(N, L) uint8 leaves, N a power of two -> (32,) uint8 root."""
    return merkle_roots_pow2(leaves[None])[0]
