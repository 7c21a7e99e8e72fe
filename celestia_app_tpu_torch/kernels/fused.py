"""The extend + DAH pipeline: ODS -> EDS -> NMT roots -> data root.

The same six stages as celestia_app_tpu/kernels/fused.extend_and_dah_fn:
RS row extend, transpose-free RS column extend, quadrant namespaces, one
leaf digest per EDS cell, row trees and column trees (the latter over the
transposed digest grid), and the RFC-6962 root over the 4k roots.  PyTorch
runs it eagerly; every hash and every RS product is a kernel launch on the
card.

Selection seam: $CELESTIA_PIPE_FUSED, read per call by `pipeline_mode`
(the variable the JAX package reads too): "off" -> "staged", "epi" ->
"fused_epi" (the column phase and the bottom half's leaf digests in one
launch of the epilogue kernel, kernels/rs_xor.extend_leaf_digests),
anything else -> "fused".  Every mode gives the same bytes.
"""

from __future__ import annotations

import os

import torch

from celestia_app_tpu_torch.constants import NAMESPACE_SIZE
from celestia_app_tpu_torch.kernels.merkle import merkle_root_pow2
from celestia_app_tpu_torch.kernels.nmt import (
    leaf_digests,
    parity_namespaces,
    tree_roots_from_digests,
)
from celestia_app_tpu_torch.kernels.rs import encode_fn
from celestia_app_tpu_torch.kernels.rs_xor import bottom_leaf_fn


def env_base_mode() -> str:
    """The lowering $CELESTIA_PIPE_FUSED selects: "off" -> "staged",
    "epi" -> "fused_epi", anything else (or unset) -> "fused"."""
    val = os.environ.get("CELESTIA_PIPE_FUSED", "auto")
    if val == "off":
        return "staged"
    if val == "epi":
        return "fused_epi"
    return "fused"


def pipeline_mode() -> str:
    """The active extend + DAH lowering.  The port has no degradation
    ladder yet, so this is the environment's choice as it stands."""
    return env_base_mode()


def leaf_namespaces(eds: torch.Tensor, k: int) -> torch.Tensor:
    """(2k, 2k, 29) row-major leaf namespaces: Q0 leaves carry the share's
    own namespace, every parity leaf (row >= k or col >= k) 0xFF^29
    (reference pkg/wrapper/nmt_wrapper.go:93-114)."""
    n = eds.shape[0]
    idx = torch.arange(n, device=eds.device)
    q0 = (idx[:, None] < k) & (idx[None, :] < k)
    return torch.where(q0[..., None], eds[..., :NAMESPACE_SIZE],
                       parity_namespaces((), eds.device))


def roots_from_digests(mins, maxs, hashes):
    """Leaf digests of the (2k, 2k) grid -> (row_roots (2k, 90), col_roots
    (2k, 90), droot (32,)); the column trees reduce the transpose."""
    row_roots = tree_roots_from_digests(mins, maxs, hashes)
    col_roots = tree_roots_from_digests(
        mins.transpose(0, 1).contiguous(),
        maxs.transpose(0, 1).contiguous(),
        hashes.transpose(0, 1).contiguous(),
    )
    droot = merkle_root_pow2(torch.cat([row_roots, col_roots], dim=0))
    return row_roots, col_roots, droot


def roots_from_eds(eds: torch.Tensor, k: int):
    """eds (2k, 2k, S) -> (row_roots (2k, 90), col_roots (2k, 90), droot (32,))."""
    # The digest at (i, j) serves the row-i and the column-j tree alike, so
    # each leaf is hashed once and the column trees reduce the transpose.
    return roots_from_digests(*leaf_digests(leaf_namespaces(eds, k), eds))


def extend_and_dah_fn(k: int, construction: str | None = None,
                      roots_only: bool = False, epilogue: bool = False, device=None):
    """f(ods) for ods (k, k, 512) uint8 on `device`:
      roots_only=False -> (eds, row_roots, col_roots, droot)
      roots_only=True  -> (row_roots, col_roots, droot)
    with eds (2k, 2k, 512), roots (2k, 90), droot (32,).  The construction
    and the RS core are fixed when f is built.

    epilogue=True is the "fused_epi" lowering: the column phase comes from
    kernels/rs_xor.bottom_leaf_fn together with the bottom half's leaf
    digests (every bottom leaf carries the parity namespace), and only the
    top half is hashed here (Q0 under its own namespaces, Q1 under the
    parity namespace)."""
    encode = encode_fn(k, construction, device)
    bottom_fn = None
    if epilogue:
        bottom_fn = bottom_leaf_fn(k, construction, fallback_encode=encode, device=device)

    def run(ods: torch.Tensor):
        top = torch.cat([ods, encode(ods, 1)], dim=1)  # (k, 2k, S)
        # Row and column encodes commute: the column phase contracts over
        # the row axis of the top half and yields Q2 and Q3 directly.
        if epilogue:
            bottom, bot_hashes = bottom_fn(top)  # (k, 2k, S), (k, 2k, 32)
            eds = torch.cat([top, bottom], dim=0)
            par_ns = parity_namespaces((k, 2 * k), top.device)
            col = torch.arange(2 * k, device=top.device)
            top_ns = torch.where((col < k)[None, :, None], top[..., :NAMESPACE_SIZE], par_ns)
            _, _, top_hashes = leaf_digests(top_ns, top)
            ns = torch.cat([top_ns, par_ns], dim=0)
            roots = roots_from_digests(ns, ns, torch.cat([top_hashes, bot_hashes], dim=0))
        else:
            eds = torch.cat([top, encode(top, 0)], dim=0)  # (2k, 2k, S)
            roots = roots_from_eds(eds, k)
        if roots_only:
            return roots
        return (eds, *roots)

    return run
