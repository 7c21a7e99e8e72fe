"""Batched NMT construction: all row or column trees of a square at once.

Digest semantics match celestia_app_tpu/nmt/hasher.py (reference
test/util/malicious/hasher.go:186-310):

    leaf:  ns || ns || sha256(0x00 || ns || data)
    node:  min || max || sha256(0x01 || left || right)
    ignore-max rule: right.min == 0xFF^29  =>  parent.max = left.max

Each level is one batched SHA-256 call plus elementwise namespace
bookkeeping; trees have a power-of-two number of leaves, so every level
halves exactly.  Full-share leaves go through the fused-leaf kernel, every
node through the generic one (kernels/sha256.py).
"""

from __future__ import annotations

import torch

from celestia_app_tpu_torch.constants import (
    NAMESPACE_SIZE,
    PARITY_NAMESPACE_BYTES,
    SHARE_SIZE,
)
from celestia_app_tpu_torch.kernels.sha256 import sha256, sha256_leaves

_MAX_NS_BYTE = PARITY_NAMESPACE_BYTES[0]  # every byte of the parity namespace is 0xFF


def parity_namespaces(shape: tuple[int, ...], device) -> torch.Tensor:
    """(*shape, 29) copies of the parity namespace 0xFF^29 (a broadcast view)."""
    parity = torch.tensor(list(PARITY_NAMESPACE_BYTES), dtype=torch.uint8, device=device)
    return parity.expand(*shape, NAMESPACE_SIZE)


def leaf_digests(ns: torch.Tensor, data: torch.Tensor):
    """Hash T x L leaves: ns (T, L, 29), data (T, L, D) uint8 ->
    (mins, maxs, hashes) of shapes (T, L, 29), (T, L, 29), (T, L, 32)."""
    t, l, d = data.shape
    flat_ns = ns.reshape(t * l, NAMESPACE_SIZE)
    flat = data.reshape(t * l, d)
    if d == SHARE_SIZE:
        hashes = sha256_leaves(flat_ns, flat)
    else:
        prefix = torch.zeros((t * l, 1), dtype=torch.uint8, device=data.device)
        hashes = sha256(torch.cat([prefix, flat_ns, flat], dim=1))
    return ns, ns, hashes.reshape(t, l, 32)


def reduce_level(mins, maxs, hashes):
    """One tree level: (T, L, .) -> (T, L/2, .) for all trees at once."""
    t, l, _ = hashes.shape
    lm, ln, lh = mins[:, 0::2], maxs[:, 0::2], hashes[:, 0::2]
    rm, rn, rh = mins[:, 1::2], maxs[:, 1::2], hashes[:, 1::2]
    prefix = torch.ones((t, l // 2, 1), dtype=torch.uint8, device=hashes.device)
    msgs = torch.cat([prefix, lm, ln, lh, rm, rn, rh], dim=2)  # (T, L/2, 181)
    ph = sha256(msgs.reshape(-1, msgs.shape[2])).reshape(t, l // 2, 32)
    right_is_parity = (rm == _MAX_NS_BYTE).all(dim=2, keepdim=True)
    pmax = torch.where(right_is_parity, ln, rn)
    return lm, pmax, ph


def reduce_to_width(mins, maxs, hashes, width: int = 1):
    """Reduce T trees' levels (T, L, .) down to (T, width, .); L and width
    powers of two with width <= L."""
    while hashes.shape[1] > width:
        mins, maxs, hashes = reduce_level(mins, maxs, hashes)
    return mins, maxs, hashes


def tree_levels_from_digests(mins, maxs, hashes):
    """Every level of T trees from their leaf digests, leaf level first;
    the last entry has L=1 (the roots)."""
    levels = [(mins, maxs, hashes)]
    while levels[-1][2].shape[1] > 1:
        levels.append(reduce_level(*levels[-1]))
    return levels


def roots_from_levels(levels) -> torch.Tensor:
    """Last level (L=1) -> (T, 90) namespaced roots."""
    mins, maxs, hashes = levels[-1]
    return torch.cat([mins[:, 0], maxs[:, 0], hashes[:, 0]], dim=1)


def tree_roots_from_digests(mins, maxs, hashes) -> torch.Tensor:
    """(T, L, 29)^2 x (T, L, 32) leaf digests -> (T, 90) namespaced roots."""
    return roots_from_levels([reduce_to_width(mins, maxs, hashes)])
