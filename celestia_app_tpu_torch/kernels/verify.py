"""Batched DAS proof verification on the device.

A queue of single-share samples (coordinate, share, proof) is decided with
a fixed number of batched hash launches, independent of the queue length:

    one leaf-hash launch             (B, 29) + (B, 512) -> (B, 32)
    one node fold per NMT level      (B, 181)           -> (B, 32)
    one data-root fold per level     (U, 91), (U, 65)   -> (U, 32)

with the namespace min/max bookkeeping done elementwise, as in
kernels/nmt.py, on the same SHA-256 kernels (kernels/sha256.py).  The
accept/reject semantics are the host verifier's (nmt/proof._verify_digests
and merkle.compute_root_from_path) bit for bit:

    * sibling namespaces out of order (left.max > right.min at any level)
      reject: a violation mask is accumulated where the host raises;
    * the ignore-max rule (right.min == 0xFF^29 => parent.max = left.max);
    * the computed 90-byte NMT root must equal the proof's row root, and
      that row root's audit path must land on the data root.

The index plans (which proof node sits at which level, which side the
running digest folds from) are host integers prepared by serve/verify.py.
The port of celestia_app_tpu/kernels/verify.py.
"""

from __future__ import annotations

import torch

from celestia_app_tpu_torch.constants import NAMESPACE_SIZE
from celestia_app_tpu_torch.kernels.nmt import _MAX_NS_BYTE, leaf_digests
from celestia_app_tpu_torch.kernels.sha256 import sha256


def _lex_gt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bytewise-lexicographic a > b over (B, W) uint8 rows -> (B,) bool.

    The first differing byte decides; argmax over the inequality mask finds
    it (torch.argmax returns the first maximum and takes no bool, hence the
    uint8 cast; all-equal rows are gated by any_neq)."""
    neq = a != b
    first = neq.to(torch.uint8).argmax(dim=1, keepdim=True)
    return neq.any(dim=1) & (a.gather(1, first)[:, 0] > b.gather(1, first)[:, 0])


def _leaf_hashes(ns: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(N, 32) sha256(0x00 || ns || data): the fused-leaf kernel for full
    shares, the generic one otherwise (kernels/nmt.leaf_digests)."""
    return leaf_digests(ns[None], data[None])[2][0]


def nmt_leaf_digests(ns: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(N, 29) namespaces x (N, D) raw leaves -> (N, 90) NMT leaf digests
    ns || ns || sha256(0x00 || ns || data), in one launch."""
    return torch.cat([ns, ns, _leaf_hashes(ns, data)], dim=1)


def verify_nmt_samples(ns: torch.Tensor, shares: torch.Tensor, sibs: torch.Tensor,
                       sib_is_left: torch.Tensor, row_roots: torch.Tensor) -> torch.Tensor:
    """(B,) bool: each sample's NMT fold lands on its claimed row root with
    no namespace-order violation at any level.

    ns (B, 29) leaf namespaces, shares (B, D), sibs (B, Ln, 90) siblings
    leaf to root, sib_is_left (B, Ln) bool (the sibling folds from the
    left), row_roots (B, 90) the claimed row or column roots."""
    b = ns.shape[0]
    ones = torch.ones((b, 1), dtype=torch.uint8, device=ns.device)
    h = _leaf_hashes(ns, shares)
    mins, maxs = ns, ns
    violated = torch.zeros((b,), dtype=torch.bool, device=ns.device)
    for lvl in range(sibs.shape[1]):
        cur = torch.cat([mins, maxs, h], dim=1)
        sib = sibs[:, lvl]
        isl = sib_is_left[:, lvl, None]
        left = torch.where(isl, sib, cur)
        right = torch.where(isl, cur, sib)
        l_min, l_max = left[:, :NAMESPACE_SIZE], left[:, NAMESPACE_SIZE:2 * NAMESPACE_SIZE]
        r_min, r_max = right[:, :NAMESPACE_SIZE], right[:, NAMESPACE_SIZE:2 * NAMESPACE_SIZE]
        violated |= _lex_gt(l_max, r_min)
        h = sha256(torch.cat([ones, left, right], dim=1))
        right_is_parity = (r_min == _MAX_NS_BYTE).all(dim=1, keepdim=True)
        mins = l_min
        maxs = torch.where(right_is_parity, l_max, r_max)
    computed = torch.cat([mins, maxs, h], dim=1)
    return (computed == row_roots).all(dim=1) & ~violated


def fold_row_roots(row_roots: torch.Tensor, row_paths: torch.Tensor,
                   path_is_left: torch.Tensor, data_roots: torch.Tensor) -> torch.Tensor:
    """(U,) bool: each row root's audit path lands on its data root (the
    RFC-6962 fold by index bits).  row_roots (U, 90), row_paths (U, Lr,
    32), path_is_left (U, Lr) bool, data_roots (U, 32); run over a queue's
    unique (row root, path, data root) triples."""
    u = row_roots.shape[0]
    zeros = torch.zeros((u, 1), dtype=torch.uint8, device=row_roots.device)
    ones = torch.ones((u, 1), dtype=torch.uint8, device=row_roots.device)
    rh = sha256(torch.cat([zeros, row_roots], dim=1))
    for lvl in range(row_paths.shape[1]):
        p = row_paths[:, lvl]
        isl = path_is_left[:, lvl, None]
        left = torch.where(isl, p, rh)
        right = torch.where(isl, rh, p)
        rh = sha256(torch.cat([ones, left, right], dim=1))
    return (rh == data_roots).all(dim=1)
