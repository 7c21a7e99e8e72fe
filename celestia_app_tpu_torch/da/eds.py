"""Extended data square: the 2k x 2k erasure-coded share matrix and its
NMT roots (reference pkg/da/data_availability_header.go:65-75), computed on
the card by the lowering that kernels/fused.pipeline_mode selects.

Accessors mirror the rsmt2d surface of celestia_app_tpu/da/eds.py; they
return host copies.  The per-line trees (`row_tree`, `col_tree`) serve the
proof constructors of proof/share_proof.py: indexing into the device forest
when the serve cache retains the square, else host trees built from the
shares.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from celestia_app_tpu_torch.constants import (
    MAX_CODEC_SQUARE_SIZE,
    NAMESPACE_SIZE,
    PARITY_NAMESPACE_BYTES,
    SHARE_SIZE,
)
from celestia_app_tpu_torch.device import resolve_device
from celestia_app_tpu_torch.gf.rs import active_construction
from celestia_app_tpu_torch.kernels import fused
from celestia_app_tpu_torch.kernels.rs import extend_square_fn, use_xor
from celestia_app_tpu_torch.nmt.tree import NamespacedMerkleTree

MODES = ("fused", "fused_epi", "staged", "host")


def leaf_namespaces(eds: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(row_ns, col_ns), each (2k, 2k, 29): the leaf namespaces of the row
    trees and of the column trees (the transpose)."""
    row_ns = fused.leaf_namespaces(eds, k)
    return row_ns, row_ns.transpose(0, 1)


def roots_fn(k: int):
    """The hashing half of the pipeline: eds (2k, 2k, S) ->
    (row_roots, col_roots, droot)."""

    def roots(eds: torch.Tensor):
        return fused.roots_from_eds(eds, k)

    return roots


def _pipeline(k: int, construction: str | None, device):
    """The staged lowering: ods (k, k, 512) -> (eds, row_roots, col_roots,
    droot) as extend, then hash (celestia_app_tpu/da/eds.py::_pipeline)."""
    extend = extend_square_fn(k, construction, device)
    roots = roots_fn(k)

    def run(ods: torch.Tensor):
        eds = extend(ods)
        return (eds, *roots(eds))

    return run


def pipeline_for_mode(mode: str, k: int, construction: str | None = None, device=None):
    """The pipeline of one lowering: "fused", "fused_epi" (the epilogue
    kernel), or "staged".  The port compiles nothing ahead, so "host", the
    JAX package's eager staged floor, is the staged pipeline here."""
    if mode not in MODES:
        raise ValueError(f"unknown pipeline mode {mode!r}; expected one of {MODES}")
    dev = resolve_device(device)
    if mode in ("staged", "host"):
        return _pipeline(k, construction, dev)
    return fused.extend_and_dah_fn(k, construction, epilogue=(mode == "fused_epi"),
                                   device=dev)


@lru_cache(maxsize=None)
def _cached_pipeline(k: int, construction: str, xor: bool, mode: str,
                     device: torch.device):
    # `xor` is part of the key: the RS core is fixed when the pipeline is built.
    return pipeline_for_mode(mode, k, construction, device)


def _check_square(k: int) -> None:
    if k < 1 or k & (k - 1) or k > MAX_CODEC_SQUARE_SIZE:
        raise ValueError(f"invalid square size {k}")


class ExtendedDataSquare:
    """Handle to a computed EDS and its NMT roots, kept on the device."""

    def __init__(self, eds: torch.Tensor, row_roots: torch.Tensor,
                 col_roots: torch.Tensor, data_root: torch.Tensor, k: int):
        self._eds = eds
        self._row_roots = row_roots
        self._col_roots = col_roots
        self._data_root = data_root
        self.k = k  # ODS width
        # Proof-serving state: one host tree per touched line (memoized on
        # the handle) and, once the serve cache retains this square, its
        # device forest (serve/cache.CachedForest), whose levels replace
        # host hashing.
        self._tree_memo: dict = {}
        self._forest = None
        self._ods_ns: np.ndarray | None = None

    def attach_forest(self, forest) -> None:
        """Hook the retained device forest onto this handle, so every proof
        path reads its levels instead of hashing rows again."""
        self._forest = forest
        self._tree_memo.clear()

    def leaf_namespace(self, row: int, col: int) -> bytes:
        """The namespace the (row, col) leaf carries in its trees: the
        share's own inside Q0, the parity namespace in every other quadrant
        (pkg/wrapper/nmt_wrapper.go:93-114)."""
        if row < self.k and col < self.k:
            return self._eds[row, col, :NAMESPACE_SIZE].cpu().numpy().tobytes()
        return PARITY_NAMESPACE_BYTES

    def _axis_tree(self, axis: str, index: int, *, host: bool = False):
        """Memoized NMT of one row ("row") or column ("col"): a view of the
        device forest when one is attached, else a host NamespacedMerkleTree
        over the line's shares under the quadrant namespace rule.
        `host=True` forces the host build, so the sampler's host lowering
        does not depend on the forest it is held against."""
        key = (axis, index, host)
        cached = self._tree_memo.get(key)
        if cached is not None:
            return cached
        if self._forest is not None and not host:
            tree = self._forest.line_tree(axis, index)
        else:
            line = (self._eds[index] if axis == "row" else self._eds[:, index]).cpu().numpy()
            tree = NamespacedMerkleTree()
            for j in range(2 * self.k):
                r, c = (index, j) if axis == "row" else (j, index)
                ns = (line[j, :NAMESPACE_SIZE].tobytes() if r < self.k and c < self.k
                      else PARITY_NAMESPACE_BYTES)
                tree.push(ns + line[j].tobytes())
        self._tree_memo[key] = tree
        return tree

    def row_tree(self, row: int, *, host: bool = False):
        return self._axis_tree("row", row, host=host)

    def col_tree(self, col: int, *, host: bool = False):
        return self._axis_tree("col", col, host=host)

    @property
    def width(self) -> int:
        """EDS width (2k), matching rsmt2d.ExtendedDataSquare.Width()."""
        return 2 * self.k

    @classmethod
    def compute(cls, ods, construction: str | None = None,
                device=None) -> "ExtendedDataSquare":
        """Extend a (k, k, 512) uint8 ODS (numpy or tensor) on `device`
        (default CUDA; a CUDA request without a card raises) through the
        lowering $CELESTIA_PIPE_FUSED selects at this call."""
        dev = resolve_device(device)
        k = ods.shape[0]
        _check_square(k)
        if tuple(ods.shape) != (k, k, SHARE_SIZE):
            raise ValueError(f"ODS must be ({k}, {k}, {SHARE_SIZE}), got {tuple(ods.shape)}")
        x = ods if isinstance(ods, torch.Tensor) else torch.from_numpy(
            np.array(ods, dtype=np.uint8))
        if x.dtype != torch.uint8:
            raise ValueError(f"ODS must be uint8, got {x.dtype}")
        run = _cached_pipeline(k, construction or active_construction(), use_xor(),
                               fused.pipeline_mode(), dev)
        eds, rr, cr, droot = run(x.to(dev))
        return cls(eds, rr, cr, droot, k)

    # --- rsmt2d-surface accessors (host copies) ---------------------------
    def squared(self) -> np.ndarray:
        return self._eds.cpu().numpy()

    def row(self, i: int) -> np.ndarray:
        return self._eds[i].cpu().numpy()

    def col(self, j: int) -> np.ndarray:
        return self._eds[:, j].cpu().numpy()

    def flattened_ods(self) -> list[bytes]:
        q0 = self._eds[: self.k, : self.k].cpu().numpy()
        return [q0[i, j].tobytes() for i in range(self.k) for j in range(self.k)]

    def ods_namespaces(self) -> np.ndarray:
        """(k*k, 29) uint8 namespaces of the ODS shares, row major: the
        input of proof.share_proof.ods_namespace_range, read once."""
        if self._ods_ns is None:
            self._ods_ns = self._eds[: self.k, : self.k, :NAMESPACE_SIZE].cpu().numpy().reshape(
                self.k * self.k, NAMESPACE_SIZE)
        return self._ods_ns

    @staticmethod
    def _roots_list(roots: torch.Tensor) -> list[bytes]:
        rr = roots.cpu().numpy()
        return [rr[i].tobytes() for i in range(rr.shape[0])]

    def row_roots(self) -> list[bytes]:
        return self._roots_list(self._row_roots)

    def col_roots(self) -> list[bytes]:
        return self._roots_list(self._col_roots)

    def data_root(self) -> bytes:
        return self._data_root.cpu().numpy().tobytes()


def extend_shares(shares: list[bytes], construction: str | None = None,
                  device=None) -> ExtendedDataSquare:
    """Reference pkg/da/data_availability_header.go:65 ExtendShares.

    shares: the row-major ODS; their count must be the square of a power of
    two within bounds and each share SHARE_SIZE bytes.  `construction` pins
    the RS generator (default: $CELESTIA_RS_CONSTRUCTION per call);
    `device` defaults to CUDA and raises without a card."""
    n = len(shares)
    k = int(round(n ** 0.5))
    if k * k != n:
        raise ValueError(f"share count {n} is not a perfect square")
    _check_square(k)
    for i, s in enumerate(shares):
        if len(s) != SHARE_SIZE:
            raise ValueError(f"share {i} has length {len(s)}, want {SHARE_SIZE}")
    ods = np.frombuffer(b"".join(shares), dtype=np.uint8).reshape(k, k, SHARE_SIZE)
    return ExtendedDataSquare.compute(ods, construction, device)
