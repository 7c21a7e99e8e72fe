"""Row and column roots and the data root of an EDS, as celestia-app defines
them (pkg/wrapper, nmt with IgnoreMaxNamespace, pkg/da), in plain PyTorch
over `sha256` here.

  * Leaf (row r, col c): namespace ns = the share's first 29 bytes inside
    Q0, the parity namespace 0xFF * 29 elsewhere; digest = ns || ns ||
    SHA-256(0x00 || ns || share).  A leaf serves its row's tree and its
    column's tree alike.
  * Node: SHA-256(0x01 || left || right) under min = the smaller of the two
    minimums, max = the parity namespace when the left minimum is it, the
    left maximum when the right minimum is it, else the larger maximum.
  * Data root: the RFC 6962 tree over the 2k row roots then the 2k column
    roots: leaf SHA-256(0x00 || root), node SHA-256(0x01 || l || r).
"""

from __future__ import annotations

import torch

from dabench.reference.sha256 import sha256

NS = 29
PARITY_NS = 0xFF


def _less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over the last axis of uint8 rows."""
    diff = a != b
    first = diff.to(torch.uint8).argmax(dim=-1, keepdim=True)
    return diff.any(dim=-1) & (a.gather(-1, first) < b.gather(-1, first)).squeeze(-1)


def leaf_digests(eds: torch.Tensor, k: int) -> torch.Tensor:
    """(2k, 2k, S) uint8 -> (2k, 2k, 90) leaf digests."""
    n = 2 * k
    ns = torch.full((n, n, NS), PARITY_NS, dtype=torch.uint8, device=eds.device)
    ns[:k, :k] = eds[:k, :k, :NS]
    msgs = torch.cat([torch.zeros((n, n, 1), dtype=torch.uint8, device=eds.device), ns, eds],
                     dim=-1)
    hashes = sha256(msgs.reshape(n * n, -1)).reshape(n, n, 32)
    return torch.cat([ns, ns, hashes], dim=-1)


def tree_roots(leaves: torch.Tensor) -> torch.Tensor:
    """(T, W, 90) digests of T trees of W (a power of two) leaves -> (T, 90)."""
    level = leaves
    while level.shape[1] > 1:
        left, right = level[:, 0::2], level[:, 1::2]
        lmin, lmax, rmin, rmax = left[..., :NS], left[..., NS:2 * NS], right[..., :NS], \
            right[..., NS:2 * NS]
        mn = torch.where(_less(rmin, lmin)[..., None], rmin, lmin)
        parity = torch.full_like(lmin, PARITY_NS)
        larger = torch.where(_less(lmax, rmax)[..., None], rmax, lmax)
        mx = torch.where((lmin == parity).all(-1, keepdim=True), parity,
                         torch.where((rmin == parity).all(-1, keepdim=True), lmax, larger))
        t, w = left.shape[:2]
        one = torch.ones((t, w, 1), dtype=torch.uint8, device=leaves.device)
        h = sha256(torch.cat([one, left, right], dim=-1).reshape(t * w, -1)).reshape(t, w, 32)
        level = torch.cat([mn, mx, h], dim=-1)
    return level[:, 0]


def merkle_root(items: torch.Tensor) -> torch.Tensor:
    """(B, N, L) items, N a power of two -> (B, 32) RFC 6962 roots."""
    b, n, _ = items.shape
    zero = torch.zeros((b, n, 1), dtype=torch.uint8, device=items.device)
    level = sha256(torch.cat([zero, items], dim=-1).reshape(b * n, -1)).reshape(b, n, 32)
    while level.shape[1] > 1:
        w = level.shape[1] // 2
        one = torch.ones((b, w, 1), dtype=torch.uint8, device=items.device)
        pairs = torch.cat([one, level[:, 0::2], level[:, 1::2]], dim=-1)
        level = sha256(pairs.reshape(b * w, -1)).reshape(b, w, 32)
    return level[:, 0]


def roots(digests: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, 2k, 2k, 90) leaf digests of B squares -> row roots (B, 2k, 90),
    column roots (B, 2k, 90), data roots (B, 32); the trees of all B
    squares reduce together."""
    b, n = digests.shape[:2]
    trees = torch.cat([digests, digests.transpose(1, 2)], dim=1)  # (B, 4k, 2k, 90)
    axis_roots = tree_roots(trees.reshape(b * 2 * n, n, -1)).reshape(b, 2 * n, -1)
    return axis_roots[:, :n], axis_roots[:, n:], merkle_root(axis_roots)
