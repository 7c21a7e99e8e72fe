"""Extended data square: the 2k x 2k erasure-coded share matrix and its
NMT roots (reference pkg/da/data_availability_header.go:65-75), computed on
the card by the lowering that kernels/fused.pipeline_mode selects.

The ODS reaches the card through device.upload (pinned staging), or, under
the panel-streamed lowering of giant squares ($CELESTIA_PIPE_PANEL,
kernels/panel.py), one row panel at a time from the host copy.  Beside the
one-square pipelines sit the batched ones of the streaming path
(parallel/pipeline.py), which stay on the materializing lowerings, and the
speculative extend ($CELESTIA_PIPE_SPECULATE).

Every dispatch — `compute`, `speculate`, warm-up aside — rides
chaos/degrade.guarded_dispatch: a fault is retried within its rung, a
streak of faults steps the process-wide ladder down a rung (every rung
gives the same bytes, and every rung runs on the card), and past the floor
the original error raises.  Around it the same plane as the JAX module:
the parity sentinel ($CELESTIA_PARITY_SENTINEL=N re-runs every Nth block
through the staged pipeline on a thread and stream of its own and compares
data roots), warm-up (`warmup`, `$CELESTIA_WARMUP_K`), the compile column
of the journal (`pipeline_cache_state`), the device ledger's tracked
pipelines, and the C-bridge backend ($CELESTIA_SQUARE_BACKEND=bridge,
whose every fault falls back to the in-process path on the same card).

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
import weakref
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
from celestia_app_tpu_torch.trace.device_ledger import register_owner as _register_owner
from celestia_app_tpu_torch.trace.device_ledger import releasable

MODES = ("fused", "fused_epi", "staged", "host", "panel", "sharded_panel")

#: Ledger family of each materializing mode's pipeline (the JAX package's
#: program families; the panel runners track themselves, per panel
#: configuration, in kernels/panel.py and kernels/panel_sharded.py).
_FAMILIES = {"fused": "extend_and_dah", "fused_epi": "extend_and_dah",
             "staged": "staged_pipeline", "host": "host_pipeline"}


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


#: The pipelines _cached_pipeline has built, by cache key, as weak
#: references: the compile column of the journal, readable without building
#: anything, and "miss" again once the cache dropped the pipeline.
_BUILT: dict[tuple, weakref.ref] = {}


@lru_cache(maxsize=None)
def _cached_pipeline(k: int, construction: str, config: tuple, mode: str,
                     device: torch.device):
    inner = pipeline_for_mode(mode, k, construction, device)
    if mode in _FAMILIES:
        from celestia_app_tpu_torch.trace.device_ledger import track

        journal.note_jit_build(_FAMILIES[mode])
        run = track(inner, _FAMILIES[mode], k=k, construction=construction, mode=mode)
    else:
        def run(x):  # the panel runners track themselves
            return inner(x)
    _BUILT[(k, construction, config, mode, device)] = weakref.ref(run)
    return run


releasable(_cached_pipeline)
releasable(_BUILT)


def _is_built(k: int, construction: str, mode: str, dev: torch.device) -> bool:
    ref = _BUILT.get((k, construction, _config(k, mode, dev), mode, dev))
    return ref is not None and ref() is not None


def _pipeline_and_state(k: int, construction: str, mode: str, device: torch.device):
    """The cached pipeline of the active configuration, and "miss" when this
    call built it (the journal's `compile` field), else "hit"."""
    misses = _cached_pipeline.cache_info().misses
    run = _cached_pipeline(k, construction, _config(k, mode, device), mode, device)
    return run, ("miss" if _cached_pipeline.cache_info().misses > misses else "hit")


def pipeline_cache_state(k: int, construction: str | None = None, device=None) -> str:
    """"hit" when the pipeline the active seam would dispatch for (k,
    construction) on `device` (default CUDA) is already built this process,
    else "miss" — the block journal's compile column, readable without
    building anything.  The panel runners are warm once a full run of
    their configuration completed (kernels/panel.is_warm,
    kernels/panel_sharded.is_sharded_warm)."""
    dev = resolve_device(device)
    construction = construction or active_construction()
    mode = fused.pipeline_mode_for_k(k, dev)
    built = _is_built(k, construction, mode, dev)
    if mode == "sharded_panel":
        from celestia_app_tpu_torch.kernels.panel_sharded import is_sharded_warm

        built = built and is_sharded_warm(k, construction, dev)
    elif mode == "panel":
        from celestia_app_tpu_torch.kernels.panel import is_warm

        built = built and is_warm(k, construction, dev)
    return "hit" if built else "miss"


def _resolver(k: int, construction: str, dev: torch.device):
    """The `resolve(mode)` of chaos/degrade.guarded_dispatch for one
    square: the cached pipeline of `mode`, fed its input the way that
    lowering takes it (_staged_input), so a ladder step from a panel rung
    onto a materializing one uploads the host copy it was handed, and a
    step between materializing rungs reuses the uploaded square.  No
    lowering of the port writes its input, so a retry reads the same
    bytes and guarded_dispatch needs no `refresh`."""

    def resolve(mode: str):
        run = _cached_pipeline(k, construction, _config(k, mode, dev), mode, dev)
        return lambda x: run(_staged_input(x, mode, dev))

    return resolve


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
    from celestia_app_tpu_torch.trace.device_ledger import track

    family = "host_pipeline_batched" if mode == "host" else "extend_and_dah_batched"
    journal.note_jit_build(family)
    return track(_batched_pipeline_for_mode(mode, k, batch, construction, device), family,
                 k=k, construction=construction, mode="host" if mode == "host" else "fused",
                 batch=batch)


releasable(_cached_batched_pipeline)


def batched_pipeline_for_mode(mode: str, k: int, batch: int, construction: str | None = None,
                              device=None):
    """The cached batched pipeline of an EXPLICIT mode and the active RS
    core: the stream dispatcher's batched `resolve` (fused_epi and staged
    fold into the fused batch, _batched_pipeline_for_mode)."""
    dev = resolve_device(device)
    return _cached_batched_pipeline(k, construction or active_construction(),
                                    encode_core(k, dev), mode, batch, dev)


def pipeline_batched(k: int, batch: int, construction: str | None = None, device=None):
    """The cached batched pipeline of the active lowering and RS core: the
    multi-square counterpart of the pipeline `compute` runs
    (celestia_app_tpu/da/eds.jit_pipeline_batched).  Its lowering is
    pipeline_mode(), never "panel": giant squares do not batch."""
    return batched_pipeline_for_mode(fused.pipeline_mode(), k, batch, construction, device)


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
        $CELESTIA_PIPE_FUSED, floored by the degradation ladder).  The
        dispatch rides chaos/degrade.guarded_dispatch: a fault is retried,
        a streak of them steps the ladder, and the journal row names the
        rung that ran; past the floor the original error raises.  Under
        "panel" the runner takes the host copy and uploads it panel by
        panel, never the whole square; under "sharded_panel" each shard of
        the extend mesh does so for its slab, and the EDS stays row-sharded
        (parallel/mesh.RowSharded): reads of rows, shares and host bytes go
        to the owning block.  With $CELESTIA_PIPE_SPECULATE armed, a
        pending speculation of exactly these bytes is claimed instead of
        computed again.  With $CELESTIA_PARITY_SENTINEL armed, every Nth
        square's data root is re-checked off the hot path."""
        from celestia_app_tpu_torch.chaos.degrade import guarded_dispatch

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
                _maybe_parity_check(ods, k, construction, eds_obj._data_root, spec_mode, dev)
                return eds_obj
            # A pending entry that did not match is the round-change
            # outcome: its square is discarded, never served.
            spec_outcome = "discard"
        state = pipeline_cache_state(k, construction, dev)
        t0 = time.perf_counter()
        x = _staged_input(ods, fused.pipeline_mode_for_k(k, dev), dev)
        t1 = time.perf_counter()
        mode, (eds, rr, cr, droot) = guarded_dispatch(_resolver(k, construction, dev), x,
                                                      k=k, device=dev)
        journal.record("compute", k, mode=mode, compile=state, upload_ms=(t1 - t0) * 1e3,
                       dispatch_ms=(time.perf_counter() - t1) * 1e3,
                       **_panel_fields(mode, k, dev),
                       **({"speculation": spec_outcome} if spec_outcome else {}))
        _maybe_parity_check(ods, k, construction, droot, mode, dev)
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
    `device` defaults to CUDA and raises without a card.

    $CELESTIA_SQUARE_BACKEND=bridge routes the extension through the C ABI
    worker (bridge/, the reference's wrapper/nmt_wrapper.go:73-86 seam for a
    host-language consensus daemon) when the call's construction is the
    active one (the worker reads $CELESTIA_RS_CONSTRUCTION); any bridge
    fault falls back to the in-process path — the node must keep
    committing, and both paths give the same bytes on the same kernels."""
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
    if square_backend() == "bridge" and construction in (None, active_construction()):
        result = _try_bridge_extend(ods)
        if result is not None:
            return result
    return ExtendedDataSquare.compute(ods, construction, device)


# --- bridge backend (C ABI worker) -----------------------------------------
#
# The port of the JAX module's bridge backend, over the port's
# bridge/client.py.  The worker runs `compute` on $CELESTIA_BRIDGE_DEVICE
# (default the card) and the fallback runs it in process on the caller's
# device, so a fault of the worker costs one round trip and never moves the
# work to the CPU.

_BRIDGE_CLIENT = None
_BRIDGE_LOCK = threading.Lock()  # created at import: first use is racy


def square_backend() -> str:
    """The active square-extension backend: "device" (in process, the
    default) or "bridge" ($CELESTIA_SQUARE_BACKEND)."""
    return os.environ.get("CELESTIA_SQUARE_BACKEND", "device")


def _bridge_lib_path() -> str:
    """$CELESTIA_BRIDGE_LIB, default the library chip_smoke.py builds from
    bridge/celestia_square_bridge.cpp into the port's build directory."""
    from celestia_app_tpu_torch.kernels._build import BUILD_DIR

    default = os.path.join(str(BUILD_DIR), "bridge", "libcelestia_square_bridge.so")
    return os.environ.get("CELESTIA_BRIDGE_LIB", default)


def _bridge_client():
    """Process-wide BridgeClient, created on first use (spawns the
    persistent worker).  Raises on init failure — the caller falls back."""
    global _BRIDGE_CLIENT

    with _BRIDGE_LOCK:
        if _BRIDGE_CLIENT is None:
            from celestia_app_tpu_torch.bridge.client import BridgeClient

            _BRIDGE_CLIENT = BridgeClient(_bridge_lib_path())
        return _BRIDGE_CLIENT


def _reset_bridge() -> None:
    """Drop the (possibly dead) client so a later block can retry init."""
    global _BRIDGE_CLIENT
    client, _BRIDGE_CLIENT = _BRIDGE_CLIENT, None
    if client is not None:
        try:
            client.shutdown()
        except Exception:  # chaos-ok: tearing down an already-dead worker
            pass


def _try_bridge_extend(ods: np.ndarray) -> ExtendedDataSquare | None:
    """One bridge round trip; None on any fault (the caller falls back).

    The fallback contract: a killed or hung worker must cost one failed
    call, not the block — the client is reset so the NEXT block retries a
    fresh worker while this one takes the in-process path.  The square
    comes back as host tensors (the pipes carry bytes)."""
    import sys

    k = ods.shape[0]
    try:
        eds, rr, cr, droot = _bridge_client().extend_and_dah(ods)
        return ExtendedDataSquare(
            torch.from_numpy(eds), torch.from_numpy(rr), torch.from_numpy(cr),
            torch.frombuffer(bytearray(droot), dtype=torch.uint8), k)
    except Exception as e:  # chaos-ok: any bridge fault -> in-process path
        print(f"square bridge fault ({e}); falling back to device pipeline",
              file=sys.stderr)
        _reset_bridge()
        return None


# --- speculative extend ------------------------------------------------------
#
# $CELESTIA_PIPE_SPECULATE=on arms cross-height speculation
# (celestia_app_tpu/da/eds.py): a caller that sees the next proposal early
# starts its extend + DAH ahead of adoption, and compute() claims the result
# instead of computing again.  A claim hits only when the bytes (by SHA-256
# digest), the RS construction and the device are exactly those speculated;
# anything else discards the entry, costing one wasted computation.  The
# dispatch rides the degradation ladder as compute's does; past its floor
# the JAX speculate() returns False, the port's raises to the caller (the
# App wraps it in device.on_device: a device fault is not a verdict).


def speculation_enabled() -> bool:
    """$CELESTIA_PIPE_SPECULATE: "on", "1" or "true" arms the seam (default
    off: speculation trades wasted work for latency, the operator's call)."""
    return os.environ.get("CELESTIA_PIPE_SPECULATE", "").lower() in ("on", "1", "true")


def _host_bytes(ods) -> np.ndarray:
    if isinstance(ods, torch.Tensor):
        return ods.cpu().numpy()
    return np.ascontiguousarray(ods, dtype=np.uint8)


def _speculation_counter():
    from celestia_app_tpu_torch.trace.metrics import registry

    return registry().counter(
        "celestia_speculation_total",
        "speculative extends by outcome: hit (claimed) / discard "
        "(content or construction changed before adoption, e.g. a round "
        "change re-proposed the square)",
    )


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
    `outcomes` counts hits and discards, as `celestia_speculation_total
    {outcome}` does process-wide."""

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
        from celestia_app_tpu_torch.chaos.degrade import guarded_dispatch

        construction = construction or active_construction()
        host = _host_bytes(ods)
        resolve = _resolver(k, construction, dev)
        # Built on the caller's stream, so the side stream, ordered after
        # it, sees the generator upload of a pipeline built here.
        resolve(fused.pipeline_mode_for_k(k, dev))
        done = None
        if dev.type == "cuda":
            stream = self._stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                mode, out = guarded_dispatch(resolve, host, k=k, device=dev)
                done = torch.cuda.Event()
                done.record(stream)
        else:
            mode, out = guarded_dispatch(resolve, host, k=k, device=dev)
        with self._lock:
            if self._entry is not None:
                self.outcomes["discard"] += 1
                _speculation_counter().inc(outcome="discard")
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
            _speculation_counter().inc(outcome="discard")
            return None
        with self._lock:
            self.outcomes["hit"] += 1
        _speculation_counter().inc(outcome="hit")
        hand_over(entry["outputs"], entry["done"])
        return ExtendedDataSquare(*entry["outputs"], entry["k"]), entry["mode"]

    def discard(self) -> bool:
        """Drop the pending entry (the round-change signal); True when there
        was one."""
        with self._lock:
            entry, self._entry = self._entry, None
            if entry is not None:
                self.outcomes["discard"] += 1
        if entry is not None:
            _speculation_counter().inc(outcome="discard")
        return entry is not None

    def pending(self) -> bool:
        with self._lock:
            return self._entry is not None


_SPECULATOR = SpeculativeExtender()


def _nbytes(t) -> int:
    """Bytes of a tensor or of a parallel/mesh.RowSharded's blocks."""
    return sum(int(b.numel()) * b.element_size() for b in getattr(t, "blocks", (t,)))


def _speculator_owned_bytes() -> int:
    """Device bytes parked by the pending speculation (the outputs claim()
    would adopt) — the ownership-ledger callback; 0 when none is pending."""
    with _SPECULATOR._lock:
        entry = _SPECULATOR._entry
    if entry is None:
        return 0
    return sum(_nbytes(t) for t in entry["outputs"])


_register_owner("speculative_extend", _speculator_owned_bytes)


def speculator() -> SpeculativeExtender:
    """The process-wide speculative extender (one in-flight next-block
    speculation per process, like the consensus loop it serves)."""
    return _SPECULATOR


# --- warm-up -------------------------------------------------------------------


def warmup_sizes(upto: int) -> list[int]:
    """The upto=N expansion: every power of two 1..upto (pure, so the
    contract is testable without paying the builds)."""
    sizes = [1 << i for i in range(upto.bit_length())]
    return [k for k in sizes if k <= upto]


def _kernel_libraries(k: int, mode: str, dev: torch.device) -> list[str]:
    """The kernel libraries (kernels/_build.LIBRARIES) a square of size k
    reaches under `mode` on `dev`: sha256 always; rs_dense for the dense
    core, the panel column partials and repair's sweeps; rs_xor for the
    XOR core; rs_dense_leaf for the epilogue rung.  The FFT core launches
    no kernel of its own."""
    libs = {"sha256", "rs_dense"}
    if encode_core(k, dev)[0] == "xor":
        libs.add("rs_xor")
    if mode == "fused_epi":
        libs.add("rs_dense_leaf")
    return sorted(libs)


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def warmup(square_sizes: list[int] | None = None, upto: int | None = None,
           constructions: tuple[str, ...] | None = None, batches: tuple[int, ...] = (),
           device=None) -> list[int]:
    """Pay every first-call cost of the given square sizes up front, on
    `device` (default CUDA; raises without a card): servers call this at
    startup so that no block pays it on the critical path.  Pass either an
    explicit list or `upto` for every power of two 1..upto.  Returns the
    warmed sizes.

    Per size and construction (default: the active one), with the mode
    resolved PER SIZE (kernels/fused.pipeline_mode_for_k): on the card,
    kernels/_build builds and loads every kernel library the mode reaches
    (_kernel_libraries); compute's entry runs once on a zero square, and
    repair's (the process mode, kernels/fused.pipeline_mode) too where it
    differs; `batches` additionally runs the batched pipelines at those
    coalesced sizes (a server with $CELESTIA_PIPE_BATCH=B warms
    batches=tuple(range(2, B+1)); panel sizes never batch).  Each size
    journals a "warmup" row with its `compile` state before and `warm_ms`,
    and device_ledger.note_warmup records it."""
    from celestia_app_tpu_torch.trace.device_ledger import note_warmup

    if square_sizes is None:
        assert upto is not None, "pass square_sizes or upto"
        square_sizes = warmup_sizes(upto)
    dev = resolve_device(device)
    if constructions is None:
        constructions = (active_construction(),)
    for construction in constructions:
        for k in square_sizes:
            _check_square(k)
            mode = fused.pipeline_mode_for_k(k, dev)
            state = pipeline_cache_state(k, construction, dev)
            t0 = time.perf_counter()
            if dev.type == "cuda":
                from celestia_app_tpu_torch.kernels import _build

                libs = _kernel_libraries(k, mode, dev)
                _build.build(libs)
                for lib in libs:
                    _build.library(lib)
            ods = np.zeros((k, k, SHARE_SIZE), dtype=np.uint8)
            resolve = _resolver(k, construction, dev)
            resolve(mode)(ods)
            repair_mode = fused.pipeline_mode()
            if repair_mode != mode:
                resolve(repair_mode)(ods)
            _synchronize(dev)
            journal.record("warmup", k, mode=mode, compile=state, construction=construction,
                           **_panel_fields(mode, k, dev),
                           warm_ms=(time.perf_counter() - t0) * 1e3)
            note_warmup(k, construction, mode)
            if mode in ("panel", "sharded_panel"):
                continue  # giant squares never coalesce (BlockPipeline)
            for batch in batches:
                if batch < 2:
                    continue  # batch-1 dispatch rides the unbatched entry
                t0 = time.perf_counter()
                stack = upload(np.zeros((batch, k, k, SHARE_SIZE), dtype=np.uint8), dev)[0]
                batched_pipeline_for_mode(fused.pipeline_mode(), k, batch, construction,
                                          dev)(stack)
                _synchronize(dev)
                journal.record("warmup", k, mode=fused.pipeline_mode(), compile=state,
                               construction=construction, batch_size=batch,
                               warm_ms=(time.perf_counter() - t0) * 1e3)
    return list(square_sizes)


def extra_warmup_sizes() -> list[int]:
    """$CELESTIA_WARMUP_K: comma/space-separated extra square sizes to warm
    at server startup beyond the app's effective cap — the giant-square
    operator knob.  Malformed or non-power-of-two entries are skipped
    loudly rather than failing the start."""
    import sys

    raw = os.environ.get("CELESTIA_WARMUP_K", "")
    sizes: list[int] = []
    for tok in raw.replace(",", " ").split():
        try:
            k = int(tok)
        except ValueError:
            print(f"ignoring malformed CELESTIA_WARMUP_K entry {tok!r}",
                  file=sys.stderr)
            continue
        if 1 <= k <= MAX_CODEC_SQUARE_SIZE and k & (k - 1) == 0:
            sizes.append(k)
        else:
            print(f"ignoring out-of-range CELESTIA_WARMUP_K entry {k}",
                  file=sys.stderr)
    return sizes


# --- fused-vs-staged parity sentinel ---------------------------------------------
#
# $CELESTIA_PARITY_SENTINEL=N re-runs every Nth computed block's DAH through
# the STAGED pipeline off the hot path (a daemon thread, on a CUDA stream of
# its own) and compares data roots, ticking
# celestia_parity_checks_total{result=match|mismatch|error}.  A mismatch
# also writes a `parity_mismatch` trace row and flight-recorder bundle.
# Nothing here ever raises into the caller: the hot path records an event
# after the block's launches and hands over the host copy of the ODS; the
# staged re-run and both reads of the roots happen on the sentinel thread.

_PARITY_LOCK = threading.Lock()
_PARITY_COUNT = 0
_PARITY_THREADS: list = []
_SENTINEL_STREAMS: dict = {}


def parity_sentinel_every() -> int:
    """$CELESTIA_PARITY_SENTINEL: check every Nth block (0 = disabled)."""
    try:
        return int(os.environ.get("CELESTIA_PARITY_SENTINEL", "0") or "0")
    except ValueError:
        return 0


def _maybe_parity_check(ods, k: int, construction: str, droot, mode: str,
                        dev: torch.device) -> None:
    """Hot-path side: count the block and, every Nth, hand the host ODS and
    the served root (with an event recorded after the launches that wrote
    it) to a background checker.  `mode` is the rung that computed it: the
    staged rung and its host twin ARE the reference lowering, and are not
    re-run against themselves."""
    every = parity_sentinel_every()
    if every <= 0 or mode not in ("sharded_panel", "panel", "fused", "fused_epi"):
        return
    global _PARITY_COUNT
    with _PARITY_LOCK:
        _PARITY_COUNT += 1
        if _PARITY_COUNT % every:
            return
        _PARITY_THREADS[:] = [t for t in _PARITY_THREADS if t.is_alive()]
    done = None
    if droot.device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(droot.device))
    t = threading.Thread(
        target=_parity_check,
        args=(_host_bytes(ods), k, construction, droot, done, dev, _parity_provenance()),
        daemon=True, name="parity-sentinel",
    )
    with _PARITY_LOCK:
        _PARITY_THREADS.append(t)
    t.start()


def _parity_provenance() -> dict:
    """trace_id/height of the dispatch that armed this check, captured on
    the HOT-PATH side — the checker thread runs after the context is gone."""
    from celestia_app_tpu_torch.trace.context import current_context

    ctx = current_context()
    return {
        "trace_id": ctx.trace_id if ctx is not None else None,
        "height": ctx.baggage.get("height") if ctx is not None else None,
    }


def _staged_root(ods_host: np.ndarray, k: int, construction: str,
                 dev: torch.device) -> bytes:
    """The staged pipeline's data root of `ods_host` on `dev`, computed on
    the calling thread's own stream (a CUDA stream of the sentinel's)."""
    run = _cached_pipeline(k, construction, _config(k, "staged", dev), "staged", dev)
    if dev.type != "cuda":
        return run(_staged_input(ods_host, "staged", dev))[3].numpy().tobytes()
    # A pipeline built just now uploaded its tables on this thread's
    # current stream: done before the sentinel's stream reads them.
    torch.cuda.current_stream(dev).synchronize()
    with _PARITY_LOCK:
        stream = _SENTINEL_STREAMS.get(dev)
        if stream is None:
            stream = _SENTINEL_STREAMS[dev] = torch.cuda.Stream(dev)
    with torch.cuda.stream(stream):
        out = run(_staged_input(ods_host, "staged", dev))
        return out[3].cpu().numpy().tobytes()


def _parity_check(ods_host, k: int, construction: str, droot, done,
                  dev: torch.device, provenance: dict | None = None) -> None:
    from celestia_app_tpu_torch.trace.metrics import registry
    from celestia_app_tpu_torch.trace.tracer import traced

    provenance = provenance or {"trace_id": None, "height": None}
    checks = registry().counter(
        "celestia_parity_checks_total",
        "fused-vs-staged DAH parity sentinel verdicts",
    )
    try:
        if done is not None:
            done.synchronize()  # the served root is written
        served_root = droot.cpu().numpy().tobytes()
        staged_root = _staged_root(ods_host, k, construction, dev)
        if staged_root == served_root:
            checks.inc(result="match")
            return
        checks.inc(result="mismatch")
        traced().write(
            "parity_mismatch", k=k, construction=construction,
            served=served_root.hex(), staged=staged_root.hex(),
            **provenance,
        )
        # A root divergence between lowerings that give the same bytes by
        # contract is the most urgent trigger there is: capture the state
        # before any ring buffer moves (never raises).
        from celestia_app_tpu_torch.trace.flight_recorder import note_trigger

        note_trigger(
            "parity_mismatch", k=k, construction=construction,
            served=served_root.hex(), staged=staged_root.hex(),
        )
    except Exception as e:  # chaos-ok: the sentinel must never raise
        checks.inc(result="error")
        traced().write(
            "parity_mismatch", k=k, construction=construction,
            error=f"{type(e).__name__}: {e}"[:200], **provenance,
        )


def drain_parity_checks(timeout_s: float = 30.0) -> None:
    """Wait out in-flight sentinel checks (tests / orderly shutdown)."""
    with _PARITY_LOCK:
        threads = list(_PARITY_THREADS)
    for t in threads:
        t.join(timeout_s)
