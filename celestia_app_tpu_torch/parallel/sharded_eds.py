"""Multi-device EDS construction: the square's rows partitioned over a mesh.

The port of celestia_app_tpu/parallel/sharded_eds.py.  Shard i of an
n-shard mesh (parallel/mesh.py) owns ODS rows [i*k/n, (i+1)*k/n):

  * ROW PHASE: it RS-extends its rows, (k/n, k, S) -> (k/n, 2k, S);
  * one share all_to_all re-cuts the top half into 2k/n-column blocks, so
    shard j holds every top row of columns [j*2k/n, (j+1)*2k/n);
  * COLUMN PHASE: it extends its columns (Q2 and Q3 at once, the row and
    column encodes commute), hashes each leaf of its (2k, 2k/n) block once
    under the quadrant namespace rule and reduces its column trees to their
    roots;
  * ROW TREES without moving shares back: a shard's columns are a
    contiguous, aligned power-of-two slice of every row, so its digests
    reduce locally to one 90-byte subtree node per row
    (kernels/nmt.reduce_to_width, the single-card tree's ignore-max rule);
    the (2k, 90) nodes of all shards gather onto shard 0, which runs the
    top log2(n) levels, gathers the column roots and hashes the data root.

`make_sharded_pipeline` hands back the EDS row-sharded (rows [j*2k/n,
(j+1)*2k/n) on shard j, a parallel/mesh.RowSharded) through a second share
all_to_all; `make_sharded_dah_pipeline` returns the roots only, so shares
cross shards exactly once.  Roots and the data root are tensors on shard
0's device.  Every byte equals the single-device pipeline's.
"""

from __future__ import annotations

import time
from functools import lru_cache

import numpy as np
import torch

from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, SHARE_SIZE
from celestia_app_tpu_torch.gf.rs import active_construction
from celestia_app_tpu_torch.kernels.fused import leaf_namespaces
from celestia_app_tpu_torch.kernels.merkle import merkle_root_pow2
from celestia_app_tpu_torch.kernels.nmt import (
    leaf_digests,
    reduce_to_width,
    tree_roots_from_digests,
)
from celestia_app_tpu_torch.kernels.rs import encode_core, encode_fn
from celestia_app_tpu_torch.parallel.mesh import (
    Mesh,
    RowSharded,
    all_to_all,
    device_mesh,
    device_count,
    gather,
    place_rows,
)
from celestia_app_tpu_torch.trace import journal
from celestia_app_tpu_torch.trace.device_ledger import releasable


def split_nodes(nodes: torch.Tensor):
    """(..., 90) min || max || hash nodes -> (mins, maxs, hashes)."""
    return (nodes[..., :NAMESPACE_SIZE], nodes[..., NAMESPACE_SIZE:2 * NAMESPACE_SIZE],
            nodes[..., 2 * NAMESPACE_SIZE:])


def join_nodes(mins, maxs, hashes) -> torch.Tensor:
    return torch.cat([mins, maxs, hashes], dim=-1)


def _check(k: int, mesh: Mesh) -> None:
    if k % mesh.size:
        raise ValueError(f"device count {mesh.size} must divide square size {k}")


def _pipeline(k: int, mesh: Mesh, construction: str | None, roots_only: bool):
    _check(k, mesh)
    n = mesh.size
    kl, cw = k // n, 2 * k // n
    encodes = [encode_fn(k, construction, d) for d in mesh.devices]

    def run(ods):
        """ods: the (k, k, S) ODS (host array or tensor), or the per-shard
        (k/n, k, S) row blocks already on their shards."""
        if isinstance(ods, (list, tuple)):
            if len(ods) != n or any(tuple(b.shape) != (kl, k, SHARE_SIZE) for b in ods):
                raise ValueError(f"want {n} ODS row blocks of ({kl}, {k}, {SHARE_SIZE})")
        elif tuple(ods.shape) != (k, k, SHARE_SIZE):
            raise ValueError(f"bad ODS shape {tuple(ods.shape)} for k={k}")
        mesh.enter()
        rows = list(ods) if isinstance(ods, (list, tuple)) else place_rows(mesh, ods, kl)
        tops, cols = [], []
        for i, dev in enumerate(mesh.devices):
            with mesh.on(i):
                top = torch.empty((kl, 2 * k, SHARE_SIZE), dtype=torch.uint8, device=dev)
                top[:, :k] = rows[i]
                top[:, k:] = encodes[i](rows[i], 1)
                tops.append(top)
                # This shard's column block of the EDS, (2k rows, 2k/n cols):
                # the all_to_all fills the top half.
                cols.append(torch.empty((2 * k, cw, SHARE_SIZE), dtype=torch.uint8, device=dev))
        all_to_all(mesh, tops, split_dim=1, concat_dim=0, out=[c[:k] for c in cols])
        del tops, rows
        row_nodes, col_roots = [], []
        for j, dev in enumerate(mesh.devices):
            with mesh.on(j):
                full = cols[j]
                full[k:] = encodes[j](full[:k], 0)
                ns = leaf_namespaces(full, k, col0=j * cw)  # (2k, 2k/n, 29)
                _, _, hashes = leaf_digests(ns, full)
                nst = ns.transpose(0, 1).contiguous()
                col_roots.append(tree_roots_from_digests(nst, nst,
                                                         hashes.transpose(0, 1).contiguous()))
                row_nodes.append(join_nodes(*reduce_to_width(ns, ns, hashes, 1)))  # (2k, 1, 90)
        # The top log2(n) levels of the row trees on shard 0, over the
        # subtree nodes in shard (= column) order.
        nodes = gather(mesh, row_nodes, dim=1, dst=0)  # (2k, n, 90)
        all_cols = gather(mesh, col_roots, dim=0, dst=0)  # (2k, 90)
        with mesh.on(0):
            row_roots = join_nodes(*reduce_to_width(*split_nodes(nodes), 1))[:, 0]
            droot = merkle_root_pow2(torch.cat([row_roots, all_cols], dim=0))
        roots = (row_roots, all_cols, droot)
        if roots_only:
            mesh.leave(roots)
            return roots
        eds = RowSharded(mesh, all_to_all(mesh, cols, split_dim=0, concat_dim=1))
        mesh.leave((eds, *roots))
        return (eds, *roots)

    return run


def make_sharded_pipeline(k: int, mesh: Mesh, construction: str | None = None):
    """f(ods) -> (eds, row_roots, col_roots, data_root): eds a RowSharded
    (2k, 2k, S) with rows [j*2k/n, (j+1)*2k/n) on shard j, the roots and
    data root on shard 0's device.  Requires n | k."""
    return _pipeline(k, mesh, construction, roots_only=False)


def make_sharded_dah_pipeline(k: int, mesh: Mesh, construction: str | None = None):
    """DAH-only twin: f(ods) -> (row_roots, col_roots, data_root); shares
    cross shards once, in the column-phase all_to_all."""
    return _pipeline(k, mesh, construction, roots_only=True)


def default_mesh(n: int | None = None, axis: str = "data", device=None) -> Mesh:
    """1-D mesh over the first n devices (all of them by default; on the
    CPU, CPU_SHARDS shards)."""
    return device_mesh(device_count(device) if n is None else n, axis, device)


@lru_cache(maxsize=None)
def _cached_pipeline(k: int, mesh: Mesh, construction: str, core: tuple, roots_only: bool):
    return _pipeline(k, mesh, construction, roots_only)


releasable(_cached_pipeline)


def cached_pipeline(k: int, mesh: Mesh, construction: str | None = None,
                    roots_only: bool = False):
    """The sharded pipeline cached on (k, mesh, RS construction, RS core,
    roots_only): a flip of $CELESTIA_RS_CONSTRUCTION or of the core never
    reuses a stale one."""
    core = encode_core(k, mesh.devices[0])
    return _cached_pipeline(k, mesh, construction or active_construction(), core, roots_only)


def sharded_extend_and_dah(ods, mesh: Mesh):
    """Run the cached sharded pipeline on a (k, k, S) ODS: (eds, row_roots,
    col_roots, data_root).  Journals one "sharded" row (mode "sharded",
    `devices` the mesh width): upload_ms is the placement of the rows on
    the shards, dispatch_ms the enqueue of the rest; nothing synchronizes."""
    k = ods.shape[0]
    misses = _cached_pipeline.cache_info().misses
    fn = cached_pipeline(k, mesh)
    state = "miss" if _cached_pipeline.cache_info().misses > misses else "hit"
    t0 = time.perf_counter()
    if not isinstance(ods, torch.Tensor):
        ods = np.ascontiguousarray(ods, dtype=np.uint8)
    mesh.enter()
    rows = place_rows(mesh, ods, k // mesh.size)
    t1 = time.perf_counter()
    out = fn(rows)
    journal.record("sharded", k, mode="sharded", compile=state, devices=mesh.size,
                   upload_ms=(t1 - t0) * 1e3, dispatch_ms=(time.perf_counter() - t1) * 1e3)
    return out
