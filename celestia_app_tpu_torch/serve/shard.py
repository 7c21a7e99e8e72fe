"""The sharded proof-serving plane: row-partitioned NMT forests and share
reads routed to the owning shard of a row-sharded EDS.

The port of celestia_app_tpu/serve/shard.py.  $CELESTIA_SERVE_SHARDS=N
(N > 1) partitions every retained height's two flat (N_nodes, 90) forests
row-wise over a 1-D "serve" mesh (parallel/mesh.py):

  * ADMISSION lays each forest out once (kernels/fused.forest_sharded: the
    forest is built, padded to a multiple of N, and each shard copies its
    contiguous block);
  * a GATHER routes every proof-node row host-side to the shard that owns
    it (parallel/mesh.route_to_shards: one integer divide) and each shard
    takes its rows from its own block, where it lies;
  * SHARE READS of a row-sharded EDS (the sharded extend and the sharded
    panel lowering keep theirs row-sharded, parallel/mesh.RowSharded) go
    to the block that owns each coordinate's row; the EDS is never
    gathered onto one device.

A gather returns the same rows whatever the layout, so the sharded plane
is byte-identical to the single-device one.  Not ported: the JAX read-side
ladder (sharded gather -> single device -> host, the chaos seam
proof.shard) and the Prometheus counters and gauge; a sharded fault
raises to the caller.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from celestia_app_tpu_torch.kernels.fused import forest_sharded
from celestia_app_tpu_torch.parallel.mesh import (
    SERVE_AXIS,
    Mesh,
    RowSharded,
    device_count,
    device_mesh,
    padded_rows,
    shard_of_row,
)
from celestia_app_tpu_torch.serve import cache
from celestia_app_tpu_torch.serve.cache import CachedForest


def serve_shards(device=None) -> int:
    """$CELESTIA_SERVE_SHARDS: how many shards the serve plane's forests are
    partitioned across (<= 1: the single-device plane, the default).
    Clamped to the device count of `device`'s type (default CUDA; raises
    without a card once the variable asks for shards), loudly; a malformed
    value warns and serves unsharded.  The rules of the JAX package."""
    raw = os.environ.get("CELESTIA_SERVE_SHARDS", "0") or "0"
    try:
        want = int(raw)
    except ValueError:
        warnings.warn(f"CELESTIA_SERVE_SHARDS={raw!r} is not an integer; serving UNSHARDED",
                      stacklevel=2)
        return 0
    if want <= 1:
        return 0
    have = device_count(device)
    if want > have:
        warnings.warn(f"CELESTIA_SERVE_SHARDS={want} but only {have} devices; "
                      f"sharding the serve plane over {have}", stacklevel=2)
        return have
    return want


def serve_mesh(shards: int, device=None) -> Mesh:
    return device_mesh(shards, SERVE_AXIS, device)


def leaf_shard_of(k: int, shards: int, row: int, col: int, axis: str = "row") -> int:
    """Owning shard of a sampled coordinate's level-0 forest node: row
    sampling proves leaf `col` of row tree `row`, column sampling the
    transpose; node (tree, leaf) sits at flat row tree*2k + leaf
    (forest_level_layout: offsets[0] == 0)."""
    n = 2 * k
    rows_per_shard = padded_rows(n * (2 * n - 1), shards) // shards
    tree, leaf = (col, row) if axis == "col" else (row, col)
    return shard_of_row(tree * n + leaf, rows_per_shard)


def eds_share_layout(buf):
    """(mesh, axis, shards) when `buf` is a row-sharded EDS
    (parallel/mesh.RowSharded), else None: the serve plane finds share
    sharding on the buffer it is handed, so the extend and serve settings
    never have to agree."""
    if not isinstance(buf, RowSharded):
        return None
    return buf.mesh, buf.mesh.axis, buf.shards


def sharded_share_gather(buf, coords) -> np.ndarray | None:
    """(B, SHARE_SIZE) shares of [(row, col), ...] from a row-sharded EDS,
    each coordinate read on the shard that owns its row (flat share offset
    r*n + c; equal contiguous row blocks flatten to equal contiguous flat
    blocks, so it is the forest gather's one-divide routing).  None when
    `buf` is not row-sharded: the caller's single-device read answers."""
    if eds_share_layout(buf) is None:
        return None
    n_cols = int(buf.shape[1])
    return buf.take(np.asarray([r * n_cols + c for r, c in coords], dtype=np.int64))


class ShardedCachedForest(CachedForest):
    """One height's retained proof state with both forests row-partitioned
    over the serve mesh.  The surface of CachedForest, so the sampler and
    the spill tier see no difference; spilled, the forests are one host
    tensor each and gather as the single-device plane's do."""

    def __init__(self, height: int, eds, row_flat: RowSharded, col_flat: RowSharded,
                 mesh: Mesh):
        super().__init__(height, eds, row_flat, col_flat)
        self.mesh = mesh
        self.axis = mesh.axis
        self.shards = mesh.size
        n = 2 * self.k
        self.forest_rows = n * (2 * n - 1)
        self.rows_per_shard = padded_rows(self.forest_rows, self.shards) // self.shards

    def leaf_shard(self, row: int, col: int, axis: str = "row") -> int:
        return leaf_shard_of(self.k, self.shards, row, col, axis)

    def gather(self, axis: str, flat_indices) -> np.ndarray:
        """(len(flat_indices), 90) node bytes: on the device tier each row
        comes from the shard that owns it."""
        flat = self.row_flat if axis == "row" else self.col_flat
        if not isinstance(flat, RowSharded):  # spilled: one host tensor
            return super().gather(axis, flat_indices)
        return flat.take(flat_indices)

    def shard_resident_bytes(self) -> dict[str, int]:
        """Per-shard resident forest bytes (both axes): equal blocks."""
        per = self.rows_per_shard * 90 * 2
        return {str(s): per for s in range(self.shards)}


def build_entry(height: int, eds, device=None, mesh: Mesh | None = None) -> CachedForest:
    """One height's retained entry, the admission seam of ForestCache.put:
    over `mesh` when one is given (a mesh that repeats one card runs its
    shards there), else under $CELESTIA_SERVE_SHARDS > 1 over the serve
    mesh of `device`'s type, the forests are laid out row-partitioned and
    the entry is a ShardedCachedForest; otherwise the single-device build
    on `device` (default CUDA), byte-identical."""
    if mesh is None:
        shards = serve_shards(device)
        mesh = serve_mesh(shards, device) if shards > 1 else None
    if mesh is not None:
        row_flat, col_flat = forest_sharded(eds.k, mesh)(eds._eds)
        return ShardedCachedForest(height, eds, row_flat, col_flat, mesh)
    row_flat, col_flat = cache.forest(eds.k, device)(eds._eds)
    return CachedForest(height, eds, row_flat, col_flat)


def mesh_stats(entries) -> dict | None:
    """The "mesh" view of ForestCache.stats over its device-tier entries:
    shard count, axis and per-shard resident forest bytes summed across
    heights; None when no entry is sharded."""
    shards, axis = 0, SERVE_AXIS
    per: dict[str, int] = {}
    for entry in entries:
        if not isinstance(entry, ShardedCachedForest):
            continue
        shards, axis = max(shards, entry.shards), entry.axis
        if entry.device_resident:
            for s, b in entry.shard_resident_bytes().items():
                per[s] = per.get(s, 0) + b
    if not shards:
        return None
    return {"shards": shards, "axis": axis, "per_shard_resident_bytes": per}
