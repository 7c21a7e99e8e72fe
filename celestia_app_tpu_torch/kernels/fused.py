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
anything else -> "fused".  Per square size, $CELESTIA_PIPE_PANEL puts the
panel-streamed lowering (kernels/panel.py) above these, and
$CELESTIA_EXTEND_SHARDS its sharded twin (kernels/panel_sharded.py) above
that: `pipeline_mode_for_k`.  Both are floored by the degradation ladder
(chaos/degrade.py): a process whose dispatches keep failing is stepped
down it by the circuit breaker, and because every caller routes through
here, all of them move together.
Every mode gives the same bytes.
"""

from __future__ import annotations

import os
from functools import lru_cache

import torch

from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, SHARE_SIZE
from celestia_app_tpu_torch.kernels.merkle import merkle_root_pow2, merkle_roots_pow2
from celestia_app_tpu_torch.kernels.nmt import (
    leaf_digests,
    parity_namespaces,
    tree_levels_from_digests,
    tree_roots_from_digests,
)
from celestia_app_tpu_torch.device import resolve_device
from celestia_app_tpu_torch.kernels.rs import encode_fn, extend_square_fn
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
    """The active extend + DAH lowering: the environment's choice
    (env_base_mode) floored by the degradation ladder, so a process whose
    dispatches keep failing runs fused_epi -> fused -> staged -> host."""
    from celestia_app_tpu_torch.chaos.degrade import effective_device_mode

    return effective_device_mode(env_base_mode())


def env_base_mode_for_k(k: int, device=None) -> str:
    """The lowering the environment selects for square size k on `device`:
    "sharded_panel" where $CELESTIA_EXTEND_SHARDS engages on top of the
    panel seam (kernels/panel_sharded.shards_for_k; it counts `device`'s
    cards, default CUDA, only when the variable asks for shards), "panel"
    where only $CELESTIA_PIPE_PANEL engages at k (kernels/panel.panel_rows),
    else env_base_mode()."""
    from celestia_app_tpu_torch.kernels.panel import panel_rows

    if not panel_rows(k):
        return env_base_mode()
    from celestia_app_tpu_torch.kernels.panel_sharded import shards_for_k

    return "sharded_panel" if shards_for_k(k, device) else "panel"


def pipeline_mode_for_k(k: int, device=None) -> str:
    """The active extend + DAH lowering for square size k: pipeline_mode()
    with the per-k panel and sharded-panel seams above it, floored by the
    degradation ladder (a faulting sharded step walks sharded_panel ->
    panel -> the materializing base -> ... -> host)."""
    from celestia_app_tpu_torch.chaos.degrade import effective_device_mode

    return effective_device_mode(env_base_mode_for_k(k, device))


def leaf_namespaces(eds: torch.Tensor, k: int, row0: int = 0, col0: int = 0) -> torch.Tensor:
    """(..., R, C, 29) row-major leaf namespaces of (..., R, C, S) shares,
    the block of a square at rows row0.. and columns col0.. (default: whole
    (2k, 2k) squares): Q0 leaves carry the share's own namespace, every
    parity leaf (row >= k or col >= k) 0xFF^29 (reference
    pkg/wrapper/nmt_wrapper.go:93-114)."""
    rows = torch.arange(row0, row0 + eds.shape[-3], device=eds.device)
    cols = torch.arange(col0, col0 + eds.shape[-2], device=eds.device)
    q0 = (rows[:, None] < k) & (cols[None, :] < k)
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


# --- batched multi-square dispatch -------------------------------------------
#
# The streaming pipeline (parallel/pipeline.py) coalesces queued same-k
# squares and runs them as one batch.  Where the JAX package vmaps one
# program over the batch, the port widens each launch: B squares stacked as
# (B, k, k, S) are one rs_dense launch per phase, one sha256_leaves launch
# for all B*4k^2 leaves, one sha256_batch launch per tree level for all
# B*4k row and column trees, and one per level of the B data-root trees.
#
# fused_epi folds into this body, as in the JAX package
# (celestia_app_tpu/kernels/fused.py:306-310): the epilogue kernel's work
# items and its `int n2` column count (csrc/rs_dense_leaf.cu) are sized
# for one square, and widening them is a kernel change of its own.  Every
# lowering gives the same bytes, so the batch loses nothing but the
# epilogue's fusion.


def roots_from_eds_batched(eds: torch.Tensor, k: int):
    """eds (B, 2k, 2k, S) -> (row_roots (B, 2k, 90), col_roots (B, 2k, 90),
    droots (B, 32)), each square's roots those of roots_from_eds."""
    b, n = eds.shape[0], eds.shape[1]
    ns = leaf_namespaces(eds, k)
    _, _, hashes = leaf_digests(ns.reshape(b * n, n, NAMESPACE_SIZE),
                                eds.reshape(b * n, n, eds.shape[-1]))
    hashes = hashes.view(b, n, n, 32)
    # Per square its row trees, then its column trees over the transposed
    # grid: one set of B*4k trees, reduced together level by level.
    tree_ns = torch.stack([ns, ns.transpose(1, 2)], dim=1).reshape(b * 2 * n, n, NAMESPACE_SIZE)
    tree_hashes = torch.stack([hashes, hashes.transpose(1, 2)], dim=1).reshape(b * 2 * n, n, 32)
    roots = tree_roots_from_digests(tree_ns, tree_ns, tree_hashes).view(b, 2 * n, 90)
    return roots[:, :n], roots[:, n:], merkle_roots_pow2(roots)


def extend_and_dah_batched_fn(k: int, batch: int, construction: str | None = None,
                              device=None):
    """f(odss) for odss (batch, k, k, 512) uint8 on `device` ->
    (eds (batch, 2k, 2k, 512), row_roots (batch, 2k, 90), col_roots
    (batch, 2k, 90), droots (batch, 32)), every square byte-identical to
    extend_and_dah_fn's (the counterpart of
    celestia_app_tpu/kernels/fused.jit_extend_and_dah_batched)."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    extend = extend_square_fn(k, construction, device)

    def run(odss: torch.Tensor):
        if tuple(odss.shape) != (batch, k, k, SHARE_SIZE):
            raise ValueError(f"expected ({batch}, {k}, {k}, {SHARE_SIZE}) squares, "
                             f"got {tuple(odss.shape)}")
        eds = extend(odss)
        return (eds, *roots_from_eds_batched(eds, k))

    return run


# --- forest retention (the serve plane's read side) -------------------------
#
# The pipeline above keeps only the 4k roots of the NMT levels it computes;
# the proof-serving plane (serve/) needs every node of every row and column
# tree, so that a batch of samples is answered by gathers instead of
# hashing.  The forest is rebuilt from the retained EDS once per retained
# height, beside the block path rather than inside it.


def forest_level_layout(k: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(widths, offsets) of the flattened forest of 2k trees of 2k leaves.

    Level h holds 2k trees x (2k >> h) nodes; the flat (N, 90) array
    concatenates the levels leaf first, each level row-major by tree, so
    node (tree t, level h, index i) is flat[offsets[h] + t*widths[h] + i]:
    the indexing contract of serve/cache.py and serve/sampler.py."""
    n = 2 * k
    widths = []
    w = n
    while w >= 1:
        widths.append(w)
        w //= 2
    offsets, off = [], 0
    for w in widths:
        offsets.append(off)
        off += n * w
    return tuple(widths), tuple(offsets)


def forest_fn(k: int):
    """f(eds) -> (row_flat, col_flat): both axes' complete forests of
    90-byte min || max || hash digests (the nmt/hasher.py wire form),
    flattened per forest_level_layout.  One leaf-hash launch for the whole
    square (each digest serves its row and its column tree), then one node
    launch per level and axis."""

    def run(eds: torch.Tensor):
        return forest_from_digests(*leaf_digests(leaf_namespaces(eds, k), eds))

    return run


def forest_from_digests(mins, maxs, hashes):
    """The two flat forests of forest_fn from the (2k, 2k) leaf digests."""

    def flatten(levels) -> torch.Tensor:
        return torch.cat([torch.cat([m, x, h], dim=2).reshape(-1, 90) for m, x, h in levels])

    row_levels = tree_levels_from_digests(mins, maxs, hashes)
    col_levels = tree_levels_from_digests(
        mins.transpose(0, 1).contiguous(),
        maxs.transpose(0, 1).contiguous(),
        hashes.transpose(0, 1).contiguous(),
    )
    return flatten(row_levels), flatten(col_levels)


def row_block_leaf_digests(eds, k: int, device: torch.device):
    """Leaf digests of a row-sharded EDS (parallel/mesh.RowSharded): each
    block is hashed where it lies (one sha256_leaves launch per block, on
    the current stream of its device), and the (2k, 2k) namespace and
    digest grids gather onto `device`; the EDS itself never moves."""
    n = 2 * k
    ns = torch.empty((n, n, NAMESPACE_SIZE), dtype=torch.uint8, device=device)
    hashes = torch.empty((n, n, 32), dtype=torch.uint8, device=device)
    rows = eds.rows_per_block
    for b, block in enumerate(eds.blocks):
        block_ns = leaf_namespaces(block, k, row0=b * rows)
        ns[b * rows:(b + 1) * rows] = block_ns
        hashes[b * rows:(b + 1) * rows] = leaf_digests(block_ns, block)[2]
    return ns, ns, hashes


@lru_cache(maxsize=None)
def forest(k: int, device=None):
    """The forest builder of square size k on `device` (default CUDA;
    raises without a card): f(eds) moves `eds` there if it lies elsewhere;
    a row-sharded EDS is hashed block by block where it lies."""
    from celestia_app_tpu_torch.trace.device_ledger import track
    from celestia_app_tpu_torch.trace.journal import note_jit_build

    dev = resolve_device(device)
    run = forest_fn(k)

    def build(eds):
        if hasattr(eds, "blocks"):
            return forest_from_digests(*row_block_leaf_digests(eds, k, dev))
        return run(eds.to(dev))

    note_jit_build("forest")
    return track(build, "forest", k=k)


@lru_cache(maxsize=None)
def forest_sharded(k: int, mesh):
    """The forest builder whose output is the serve plane's row partition
    (the port of celestia_app_tpu/kernels/fused.jit_forest_sharded):
    f(eds) -> (row_flat, col_flat), each a parallel/mesh.RowSharded of the
    flat forest padded to a multiple of the mesh width, block i on shard i.
    The forest is built on shard 0's device, then each shard copies its
    block once, at admission; every gather reads the blocks where they
    lie."""
    from celestia_app_tpu_torch.parallel.mesh import RowSharded, padded_rows, place_rows

    from celestia_app_tpu_torch.trace.device_ledger import track
    from celestia_app_tpu_torch.trace.journal import note_jit_build

    n = 2 * k
    rows = n * (2 * n - 1)  # sum of n*w over widths n, n/2, ..., 1
    padded = padded_rows(rows, mesh.size)
    build = forest(k, mesh.devices[0])

    def run(eds):
        flats = []
        for flat in build(eds):
            if padded > rows:
                flat = torch.cat([flat, flat.new_zeros((padded - rows, flat.shape[1]))])
            mesh.enter()
            sharded = RowSharded(mesh, place_rows(mesh, flat, padded // mesh.size))
            mesh.leave((sharded,))
            flats.append(sharded)
        return tuple(flats)

    note_jit_build("forest_sharded")
    return track(run, "forest_sharded", k=k, mode="sharded", shards=mesh.size)
