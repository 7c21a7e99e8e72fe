"""Extended data square: the 2k x 2k erasure-coded share matrix and its
NMT roots (reference pkg/da/data_availability_header.go:65-75), computed on
the card by the lowering that kernels/fused.pipeline_mode selects.

The ODS reaches the card through device.upload (pinned staging), or, under
the panel-streamed lowering of giant squares ($CELESTIA_PIPE_PANEL,
kernels/panel.py), one row panel at a time from the host copy.  Beside the
one-square pipelines sit the batched ones of the streaming path
(parallel/pipeline.py), which stay on the materializing lowerings, and the
speculative extend ($CELESTIA_PIPE_SPECULATE).

Accessors mirror the rsmt2d surface of celestia_app_tpu/da/eds.py; they
return host copies.  The per-line trees (`row_tree`, `col_tree`) serve the
proof constructors of proof/share_proof.py: indexing into the device forest
when the serve cache retains the square, else host trees built from the
shares.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from functools import lru_cache

import numpy as np
import torch

from celestia_app_tpu_torch.constants import (
    MAX_CODEC_SQUARE_SIZE,
    NAMESPACE_SIZE,
    PARITY_NAMESPACE_BYTES,
    SHARE_SIZE,
)
from celestia_app_tpu_torch.device import hand_over, resolve_device, upload
from celestia_app_tpu_torch.gf.rs import active_construction
from celestia_app_tpu_torch.kernels import fused
from celestia_app_tpu_torch.kernels.panel import panel_count, panel_pipeline, panel_rows
from celestia_app_tpu_torch.kernels.rs import encode_core, extend_square_fn
from celestia_app_tpu_torch.nmt.tree import NamespacedMerkleTree
from celestia_app_tpu_torch.trace import journal

MODES = ("fused", "fused_epi", "staged", "host", "panel", "sharded_panel")


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
    kernel), "staged", "panel" (kernels/panel.panel_pipeline, which takes
    the host ODS and uploads it panel by panel) or "sharded_panel"
    (kernels/panel_sharded.sharded_panel_pipeline: the same over the
    $CELESTIA_EXTEND_SHARDS mesh, its EDS a parallel/mesh.RowSharded).  The
    port compiles nothing ahead, so "host", the JAX package's eager staged
    floor, is the staged pipeline here."""
    if mode not in MODES:
        raise ValueError(f"unknown pipeline mode {mode!r}; expected one of {MODES}")
    dev = resolve_device(device)
    if mode in ("staged", "host"):
        return _pipeline(k, construction, dev)
    if mode == "panel":
        return panel_pipeline(k, construction, device=dev)
    if mode == "sharded_panel":
        from celestia_app_tpu_torch.kernels.panel_sharded import sharded_panel_pipeline

        return sharded_panel_pipeline(k, construction, device=dev)
    return fused.extend_and_dah_fn(k, construction, epilogue=(mode == "fused_epi"),
                                   device=dev)


def _config(k: int, mode: str, device: torch.device) -> tuple:
    """What a pipeline fixes when it is built beyond (k, construction, mode,
    device): the RS core (kernels/rs.encode_core), under "panel" and
    "sharded_panel" the panel height, under "sharded_panel" the shard count.
    Part of every pipeline cache key."""
    shards = 0
    if mode == "sharded_panel":
        from celestia_app_tpu_torch.kernels.panel_sharded import shards_for_k

        shards = shards_for_k(k, device)
    return (encode_core(k, device), panel_rows(k) if mode in ("panel", "sharded_panel") else 0,
            shards)


@lru_cache(maxsize=None)
def _cached_pipeline(k: int, construction: str, config: tuple, mode: str,
                     device: torch.device):
    return pipeline_for_mode(mode, k, construction, device)


def _pipeline_and_state(k: int, construction: str, mode: str, device: torch.device):
    """The cached pipeline of the active configuration, and "miss" when this
    call built it (the journal's `compile` field), else "hit"."""
    misses = _cached_pipeline.cache_info().misses
    run = _cached_pipeline(k, construction, _config(k, mode, device), mode, device)
    return run, ("miss" if _cached_pipeline.cache_info().misses > misses else "hit")


def _panel_fields(mode: str, k: int, device=None) -> dict:
    """Journal extras of a panel-streamed dispatch: the panels it streamed,
    and under "sharded_panel" the panel steps per shard and the mesh width
    `shards` (celestia_app_tpu/da/eds._panel_fields)."""
    if mode == "sharded_panel":
        from celestia_app_tpu_torch.kernels.panel_sharded import (
            sharded_panel_count,
            shards_for_k,
        )

        return {"panels": sharded_panel_count(k, device), "shards": shards_for_k(k, device)}
    return {"panels": panel_count(k)} if mode == "panel" else {}


# --- batched (multi-square) pipeline ----------------------------------------


def _host_pipeline_batched(k: int, construction: str | None, device):
    """Each square through the staged pipeline on its own, outputs stacked
    to the batched shape (celestia_app_tpu/da/eds._host_pipeline_batched)."""
    run_one = _pipeline(k, construction, device)

    def run(odss: torch.Tensor):
        outs = [run_one(odss[b]) for b in range(odss.shape[0])]
        return tuple(torch.stack([o[i] for o in outs]) for i in range(4))

    return run


def _batched_pipeline_for_mode(mode: str, k: int, batch: int,
                               construction: str | None = None, device=None):
    """f(odss) with odss (batch, k, k, S) -> (eds, row_roots, col_roots,
    droots), each with the leading batch axis.  fused_epi folds into the
    fused batch (kernels/fused.extend_and_dah_batched_fn says why); staged
    runs that batch too, which is the staged composition (the batched
    extend, then the batched roots) as the port has no fused program to
    tell it from; host runs square by square."""
    if mode not in MODES:
        raise ValueError(f"unknown pipeline mode {mode!r}; expected one of {MODES}")
    dev = resolve_device(device)
    construction = construction or active_construction()
    if mode == "host":
        return _host_pipeline_batched(k, construction, dev)
    return fused.extend_and_dah_batched_fn(k, batch, construction, dev)


@lru_cache(maxsize=None)
def _cached_batched_pipeline(k: int, construction: str, core: tuple, mode: str, batch: int,
                             device: torch.device):
    return _batched_pipeline_for_mode(mode, k, batch, construction, device)


def pipeline_batched(k: int, batch: int, construction: str | None = None, device=None):
    """The cached batched pipeline of the active lowering and RS core: the
    multi-square counterpart of the pipeline `compute` runs
    (celestia_app_tpu/da/eds.jit_pipeline_batched).  Its lowering is
    pipeline_mode(), never "panel": giant squares do not batch."""
    dev = resolve_device(device)
    return _cached_batched_pipeline(k, construction or active_construction(),
                                    encode_core(k, dev), fused.pipeline_mode(), batch, dev)


def _staged_input(ods, mode: str, dev: torch.device):
    """The pipeline's input: under "panel" and "sharded_panel" the ODS as it
    lies (a host array made contiguous; the runner uploads one panel at a
    time, per shard), else the whole square on `dev` (a host array through
    device.upload)."""
    if mode in ("panel", "sharded_panel"):
        return ods if isinstance(ods, torch.Tensor) else np.ascontiguousarray(ods, dtype=np.uint8)
    if isinstance(ods, torch.Tensor):
        return ods.to(dev)
    return upload(np.ascontiguousarray(ods, dtype=np.uint8), dev)[0]


def _check_square(k: int) -> None:
    if k < 1 or k & (k - 1) or k > MAX_CODEC_SQUARE_SIZE:
        raise ValueError(f"invalid square size {k}")


class ExtendedDataSquare:
    """Handle to a computed EDS and its NMT roots, kept on the device (or,
    from the sharded lowerings, on the shards of a mesh as a
    parallel/mesh.RowSharded, which the accessors index the same way)."""

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
        # Retention listener: a streamed square's BlockPipeline sets it so
        # that retention by the serve cache pins the staging slot that fed
        # the square (parallel/pipeline._BufferRing.pin).
        self._retain_cb = None

    def attach_forest(self, forest) -> None:
        """Hook the retained device forest onto this handle, so every proof
        path reads its levels instead of hashing rows again, and tell the
        feeding buffer ring, if any, that the square is retained."""
        self._forest = forest
        self._tree_memo.clear()
        if self._retain_cb is not None:
            self._retain_cb()

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
        lowering kernels/fused.pipeline_mode_for_k selects at this call
        ($CELESTIA_EXTEND_SHARDS, $CELESTIA_PIPE_PANEL, then
        $CELESTIA_PIPE_FUSED).  Under "panel" the runner takes the host copy
        and uploads it panel by panel, never the whole square; under
        "sharded_panel" each shard of the extend mesh does so for its slab,
        and the EDS stays row-sharded (parallel/mesh.RowSharded): reads of
        rows, shares and host bytes go to the owning block.  With
        $CELESTIA_PIPE_SPECULATE armed, a pending speculation of exactly
        these bytes is claimed instead of computed again."""
        dev = resolve_device(device)
        k = ods.shape[0]
        _check_square(k)
        if tuple(ods.shape) != (k, k, SHARE_SIZE):
            raise ValueError(f"ODS must be ({k}, {k}, {SHARE_SIZE}), got {tuple(ods.shape)}")
        if isinstance(ods, torch.Tensor) and ods.dtype != torch.uint8:
            raise ValueError(f"ODS must be uint8, got {ods.dtype}")
        construction = construction or active_construction()
        spec_outcome = None
        if speculation_enabled() and _SPECULATOR.pending():
            claimed = _SPECULATOR.claim(ods, construction, dev)
            if claimed is not None:
                eds_obj, spec_mode = claimed
                journal.record("compute", k, mode=spec_mode, compile="hit",
                               speculation="hit")
                return eds_obj
            # A pending entry that did not match is the round-change
            # outcome: its square is discarded, never served.
            spec_outcome = "discard"
        mode = fused.pipeline_mode_for_k(k, dev)
        run, state = _pipeline_and_state(k, construction, mode, dev)
        t0 = time.perf_counter()
        x = _staged_input(ods, mode, dev)
        t1 = time.perf_counter()
        eds, rr, cr, droot = run(x)
        journal.record("compute", k, mode=mode, compile=state, upload_ms=(t1 - t0) * 1e3,
                       dispatch_ms=(time.perf_counter() - t1) * 1e3,
                       **_panel_fields(mode, k, dev),
                       **({"speculation": spec_outcome} if spec_outcome else {}))
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
    if set(map(len, shares)) != {SHARE_SIZE}:
        i, length = next((i, len(s)) for i, s in enumerate(shares) if len(s) != SHARE_SIZE)
        raise ValueError(f"share {i} has length {length}, want {SHARE_SIZE}")
    # A bytearray, so the ODS is a writable array that a tensor can view.
    ods = np.frombuffer(bytearray().join(shares), dtype=np.uint8).reshape(k, k, SHARE_SIZE)
    return ExtendedDataSquare.compute(ods, construction, device)


# --- speculative extend ------------------------------------------------------
#
# $CELESTIA_PIPE_SPECULATE=on arms cross-height speculation
# (celestia_app_tpu/da/eds.py): a caller that sees the next proposal early
# starts its extend + DAH ahead of adoption, and compute() claims the result
# instead of computing again.  A claim hits only when the bytes (by SHA-256
# digest), the RS construction and the device are exactly those speculated;
# anything else discards the entry, costing one wasted computation.  Unlike
# the JAX package, whose speculate() swallows a dispatch fault behind its
# degradation ladder, a kernel fault here raises to the caller.


def speculation_enabled() -> bool:
    """$CELESTIA_PIPE_SPECULATE: "on", "1" or "true" arms the seam (default
    off: speculation trades wasted work for latency, the operator's call)."""
    return os.environ.get("CELESTIA_PIPE_SPECULATE", "").lower() in ("on", "1", "true")


def _host_bytes(ods) -> np.ndarray:
    if isinstance(ods, torch.Tensor):
        return ods.cpu().numpy()
    return np.ascontiguousarray(ods, dtype=np.uint8)


class SpeculativeExtender:
    """One in-flight speculative extend: the next proposal's square.

    `speculate()` digests the candidate ODS and, on the card, uploads it
    and launches the active pipeline on a side stream of its own, parking
    the outputs with the event recorded after them; it returns without
    waiting.  `claim()` returns the square iff the claimed bytes,
    construction and device are the speculated ones, having made the
    caller's stream wait on that event; any mismatch discards the entry.
    `discard()` is the explicit round-change hook.  At most one entry: a
    second speculate() replaces, and counts as discarding, the first.
    `outcomes` counts hits and discards."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entry: dict | None = None
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        self.outcomes = {"hit": 0, "discard": 0}

    @staticmethod
    def _digest(host: np.ndarray) -> bytes:
        return hashlib.sha256(host.tobytes()).digest()

    def _stream(self, dev: torch.device):
        with self._lock:
            if dev not in self._streams:
                self._streams[dev] = torch.cuda.Stream(dev)
            return self._streams[dev]

    def speculate(self, ods, *, height: int | None = None, round_: int | None = None,
                  construction: str | None = None, device=None) -> bool:
        """Start extending `ods` ahead of adoption on `device` (default
        CUDA); False when the seam is off (callers need no second gate)."""
        if not speculation_enabled():
            return False
        dev = resolve_device(device)
        k = ods.shape[0]
        _check_square(k)
        if tuple(ods.shape) != (k, k, SHARE_SIZE):
            raise ValueError(f"ODS must be ({k}, {k}, {SHARE_SIZE}), got {tuple(ods.shape)}")
        construction = construction or active_construction()
        host = _host_bytes(ods)
        mode = fused.pipeline_mode_for_k(k, dev)
        run = _cached_pipeline(k, construction, _config(k, mode, dev), mode, dev)
        done = None
        if dev.type == "cuda":
            stream = self._stream(dev)
            # Ordered after the caller's queued work, which includes the
            # generator upload of a pipeline built by the line above.
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                out = run(_staged_input(host, mode, dev))
                done = torch.cuda.Event()
                done.record(stream)
        else:
            out = run(_staged_input(host, mode, dev))
        with self._lock:
            if self._entry is not None:
                self.outcomes["discard"] += 1
            self._entry = {"digest": self._digest(host), "height": height, "round": round_,
                           "k": k, "construction": construction, "device": dev,
                           "mode": mode, "outputs": out, "done": done}
        return True

    def claim(self, ods, construction: str | None = None, device=None):
        """(ExtendedDataSquare, mode) when the pending speculation is exactly
        the square being adopted (bytes, construction, device: default
        CUDA), else None, with the mismatched entry discarded."""
        with self._lock:
            entry, self._entry = self._entry, None
        if entry is None:
            return None
        dev = resolve_device(device)
        if (entry["k"] != ods.shape[0] or entry["device"] != dev
                or entry["construction"] != (construction or active_construction())
                or entry["digest"] != self._digest(_host_bytes(ods))):
            with self._lock:
                self.outcomes["discard"] += 1
            return None
        with self._lock:
            self.outcomes["hit"] += 1
        hand_over(entry["outputs"], entry["done"])
        return ExtendedDataSquare(*entry["outputs"], entry["k"]), entry["mode"]

    def discard(self) -> bool:
        """Drop the pending entry (the round-change signal); True when there
        was one."""
        with self._lock:
            entry, self._entry = self._entry, None
            if entry is not None:
                self.outcomes["discard"] += 1
        return entry is not None

    def pending(self) -> bool:
        with self._lock:
            return self._entry is not None


_SPECULATOR = SpeculativeExtender()


def speculator() -> SpeculativeExtender:
    """The process-wide speculative extender (one in-flight next-block
    speculation per process, like the consensus loop it serves)."""
    return _SPECULATOR
