"""Sharded panel-streamed extend + DAH: a giant square's row panels
partitioned over a device mesh.

The port of celestia_app_tpu/kernels/panel_sharded.py, on the single-card
runner's schedule (kernels/panel.py).  $CELESTIA_EXTEND_SHARDS=N gives each
shard of the 1-D "extend" mesh (parallel/mesh.py) one contiguous slab of
k/N ODS rows, streamed in panels of the active height (clamped to the
slab; a height that does not divide the slab shortens the last step on
every shard at once, never padding):

  * ROW PHASE, shard-local: per step every shard uploads, row-extends and
    leaf-hashes its own panel (the single-card runner's panel body).
  * COLUMN PHASE, dense leg: mod 2 of a sum is the XOR of per-part mod-2
    partials.  Shard b owns parity rows [b*slab, (b+1)*slab), its
    accumulator slice.  Per step every shard gathers the step's n
    extended panels and contracts them, in one rs_dense launch, against its
    generator rows G_bits[b*slab*m : (b+1)*slab*m] restricted to the
    columns of the step's rows on every shard; the product XORs into its
    own slice.  No partial product crosses shards: the JAX program
    all-reduces (slab, 2k, S) partials per step and output block, this
    gathers (h, 2k, S) panels, which is h/slab of the traffic, keeps every
    XOR on the owner's stream and contracts n*h rows per launch.
  * COLUMN PHASE, FFT leg (kernels/rs.encode_core picks the FFT): the
    butterflies contract over the whole row axis, so the top half
    all_to_alls into 2k/N-column blocks, kernels/fft.col_block_encode_fn
    runs shard-local in blocks of 2*rows columns, and a second all_to_all
    lands the parity rows back on their row owners.
  * ROOTS: each shard holds whole rows (its top slab and its parity slab),
    so its row roots are local; its two slabs are aligned power-of-two
    runs of every column, so the column trees reduce locally to two
    subtree nodes per column.  Shard 0 gathers the row roots at their
    natural rows and the 2N nodes per column in row order, reduces the top
    log2(2N) levels (the same reduce_to_width as every tree) and hashes
    the data root.
  * OUTPUT: the EDS stays where it was computed, a parallel/mesh.RowSharded
    of 2N slabs (shard i: rows [i*slab, (i+1)*slab) and [k + i*slab, k +
    (i+1)*slab)); nothing reassembles it on one device.  The roots-only
    twin never holds the top half beyond one step (dense leg).

It is the "sharded_panel" rung of the degradation ladder
(chaos/degrade.py): before the accumulators, per step, before each step's
column contraction (or the FFT leg's exchange) and before the roots, the
runner passes the chaos seams device.dispatch("sharded_panel") and
device.extend_shard, so an injected fault lands mid-schedule, and a
faulting step walks the ladder to the single-card panel runner.
`is_sharded_warm` is the journal's compile column, and each runner is
registered with the device ledger (family sharded_panel_pipeline).
"""

from __future__ import annotations

import os
import sys
from functools import lru_cache

import torch

from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, SHARE_SIZE
from celestia_app_tpu_torch.device import resolve_device
from celestia_app_tpu_torch.gf.rs import active_construction, codec_for_width
from celestia_app_tpu_torch.kernels.fft import col_block_encode_fn
from celestia_app_tpu_torch.kernels.fused import leaf_namespaces
from celestia_app_tpu_torch.kernels.merkle import merkle_root_pow2
from celestia_app_tpu_torch.kernels.nmt import (
    leaf_digests,
    parity_namespaces,
    reduce_to_width,
    tree_roots_from_digests,
)
from celestia_app_tpu_torch.kernels.panel import _to_device, panel_bounds, panel_rows
from celestia_app_tpu_torch.kernels.rs import (
    encode_core,
    encode_fn,
    generator_tensor,
    xor_encode_into,
)
from celestia_app_tpu_torch.kernels.rs_dense import tma_rows
from celestia_app_tpu_torch.parallel.mesh import (
    EXTEND_AXIS,
    Mesh,
    RowSharded,
    all_to_all,
    device_count,
    device_mesh,
    gather,
    send,
)
from celestia_app_tpu_torch.parallel.sharded_eds import join_nodes, split_nodes
from celestia_app_tpu_torch.trace.device_ledger import releasable


def _pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1) if n >= 1 else 0


_WARNED: set[str] = set()


def _warn_once(key: str, msg: str) -> None:
    if key in _WARNED:
        return
    _WARNED.add(key)
    print(msg, file=sys.stderr)


def extend_shards(device=None) -> int:
    """$CELESTIA_EXTEND_SHARDS: how many shards the extend + DAH pipeline
    partitions row panels across (<= 1: the single-device panel runner).

    "auto" takes every device of `device`'s type (default CUDA; raises
    without a card once the variable asks for shards), floored to a power
    of two.  An integer is clamped to the device count and floored to a
    power of two, loudly; a malformed value warns and turns sharding off.
    The rules and messages of the JAX package."""
    raw = (os.environ.get("CELESTIA_EXTEND_SHARDS", "") or "").strip().lower()
    if raw in ("", "0", "off", "1"):
        return 0
    if raw == "auto":
        n = _pow2_floor(device_count(device))
        return n if n >= 2 else 0
    try:
        want = int(raw)
    except ValueError:
        _warn_once(
            f"malformed:{raw}",
            f"ignoring malformed CELESTIA_EXTEND_SHARDS value {raw!r} "
            "(want an integer shard count or 'auto'); extend sharding is "
            "OFF",
        )
        return 0
    if want <= 1:
        return 0
    have = device_count(device)
    n = _pow2_floor(min(want, have))
    if n != want:
        _warn_once(
            f"clamp:{want}:{n}",
            f"CELESTIA_EXTEND_SHARDS={want} clamped to {n} "
            f"({have} devices; power-of-two shard counts only)",
        )
    return n if n >= 2 else 0


def shards_for_k(k: int, device=None) -> int:
    """Shards the sharded panel lowering engages with at square size k: 0
    when the panel seam is off at k, when $CELESTIA_EXTEND_SHARDS asks for
    fewer than 2, or when k is smaller than the mesh."""
    if not panel_rows(k):
        return 0
    n = extend_shards(device)
    if n < 2 or k < n:
        return 0
    return n


def extend_mesh(shards: int, device=None) -> Mesh:
    return device_mesh(shards, EXTEND_AXIS, device)


def local_panel_bounds(k: int, shards: int) -> tuple[tuple[int, int], ...]:
    """Every shard's panel schedule over its k/shards-row slab (the same on
    every shard: slabs are equal)."""
    slab = k // shards
    rows = min(panel_rows(k) or slab, slab)
    return panel_bounds(slab, rows)


def sharded_panel_count(k: int, device=None) -> int:
    """Panel steps the sharded lowering streams at square size k (each step
    a panel on every shard); 0 when it is off."""
    n = shards_for_k(k, device)
    return len(local_panel_bounds(k, n)) if n else 0


@lru_cache(maxsize=None)
def _owner_generator_slices(k: int, construction: str, devices: tuple, bounds: tuple) -> tuple:
    """Per step, per owner shard b: the bits G_bits[b*slab*m : (b+1)*slab*m,
    cols] on b's device, where cols are the generator columns of the step's
    rows on every shard in shard order, [(i*slab + r0)*m, (i*slab + r1)*m)
    for i = 0..n-1: the operand that contracts the all_gathered panels into
    b's parity rows.  Gathered on b's device from its resident generator
    (kernels/rs.generator_tensor), each its own 16-byte-strided buffer
    (rs_dense.tma_rows, TMA's rule).  Across steps and owners they are the
    generator's bytes once."""
    from celestia_app_tpu_torch.trace.device_ledger import note_owned_bytes

    n = len(devices)
    slab = k // n
    out = []
    for r0, r1 in bounds:
        step = []
        for b in range(n):
            m, g_bits = generator_tensor(k, construction, devices[b])
            cols = torch.cat([torch.arange((i * slab + r0) * m, (i * slab + r1) * m,
                                           device=devices[b]) for i in range(n)])
            step.append(tma_rows(torch.index_select(
                g_bits[b * slab * m:(b + 1) * slab * m], 1, cols)))
        out.append(tuple(step))
    note_owned_bytes("sharded_generator_slices", (k, construction, tuple(map(str, devices)),
                                                  bounds),
                     sum(int(t.untyped_storage().nbytes()) for step in out for t in step))
    return tuple(out)


releasable(_owner_generator_slices, "sharded_generator_slices")


#: Resolved configurations (k, construction, mesh, rows, core) whose runner
#: completed one full run this process — the compile column of the sharded
#: rung (da/eds.pipeline_cache_state), keyed like kernels/panel._PANEL_WARM
#: plus the mesh.
_SHARDED_WARM: set[tuple] = releasable(set())


def is_sharded_warm(k: int, construction: str | None = None, device=None) -> bool:
    """Whether the sharded runner the seams resolve for k on `device`'s
    extend mesh (default CUDA) has completed a run this process."""
    construction = construction or active_construction()
    dev = resolve_device(device)
    shards = shards_for_k(k, dev)
    if not shards:
        return False
    mesh = extend_mesh(shards, dev)
    rows = min(panel_rows(k) or k // shards, k // shards)
    return (k, construction, mesh, rows, encode_core(k, mesh.devices[0])) in _SHARDED_WARM


def _seams() -> None:
    from celestia_app_tpu_torch import chaos

    chaos.device_dispatch("sharded_panel")
    chaos.extend_shard()


def sharded_panel_pipeline(k: int, construction: str | None = None, roots_only: bool = False,
                           device=None, mesh: Mesh | None = None):
    """The sharded panel-streamed pipeline callable for square size k.

    f(ods) -> (eds, row_roots, col_roots, droot), or (row_roots, col_roots,
    droot) for the roots_only twin, where eds is a RowSharded over the mesh
    and the roots lie on shard 0's device.  `ods` is the (k, k, S) ODS, a
    host array or tensor (a pinned one is copied without blocking); each
    shard uploads its own panels.

    The mesh is `mesh` when given (a mesh that repeats one card runs its
    shards there), else the extend mesh of $CELESTIA_EXTEND_SHARDS over
    `device` (default CUDA; raises without a card), which must engage at k
    (shards_for_k) as in the JAX package."""
    construction = construction or active_construction()
    if mesh is None:
        dev = resolve_device(device)
        shards = shards_for_k(k, dev)
        if not shards:
            raise ValueError(
                f"sharded panel mode not engaged for k={k} "
                f"(CELESTIA_EXTEND_SHARDS={os.environ.get('CELESTIA_EXTEND_SHARDS')!r}, "
                f"CELESTIA_PIPE_PANEL={os.environ.get('CELESTIA_PIPE_PANEL')!r})")
        mesh = extend_mesh(shards, dev)
    if k % mesh.size:
        raise ValueError(f"mesh of {mesh.size} must divide square size {k}")
    slab = k // mesh.size
    rows = min(panel_rows(k) or slab, slab)
    return _sharded_runner(k, construction, roots_only, mesh, rows,
                           encode_core(k, mesh.devices[0]))


@lru_cache(maxsize=None)
def _sharded_runner(k: int, construction: str, roots_only: bool, mesh: Mesh, rows: int,
                    core: tuple):
    n = mesh.size
    slab = k // n
    bounds = panel_bounds(slab, rows)
    use_fft = core[0] == "fft"
    m = codec_for_width(k, construction).field.m
    encodes = [encode_fn(k, construction, d) for d in mesh.devices]
    if use_fft:
        col_block = col_block_encode_fn(k, construction, md=core[1])
        cwidth = min(2 * rows, 2 * k // n)
    else:
        g_steps = _owner_generator_slices(k, construction, mesh.devices, bounds)
    w = 2 * k

    def run(x):
        if isinstance(x, (list, tuple)):
            raise ValueError("sharded panel mode takes the whole (k, k, S) ODS "
                             "(each shard stages its own panels)")
        if tuple(x.shape) != (k, k, SHARE_SIZE):
            raise ValueError(f"bad ODS shape {tuple(x.shape)} for k={k}")
        mesh.enter()
        try:
            out = _run(x)
        except BaseException:  # chaos-ok: re-raised once the shards are idle
            # Nothing of a failed run may still read the caller's input.
            mesh.synchronize()
            raise
        _SHARDED_WARM.add((k, construction, mesh, rows, core))
        return out

    def _run(x):
        tops, bottoms, top_ns, top_hashes = [], [], [[] for _ in range(n)], [[] for _ in range(n)]
        blocks = []
        _seams()
        for i, dev in enumerate(mesh.devices):
            with mesh.on(i):
                block = None if roots_only else torch.empty((2 * slab, w, SHARE_SIZE),
                                                            dtype=torch.uint8, device=dev)
                blocks.append(block)
                tops.append(block[:slab] if block is not None else (
                    torch.empty((slab, w, SHARE_SIZE), dtype=torch.uint8, device=dev)
                    if use_fft else None))
                if use_fft:
                    bottoms.append(block[slab:] if block is not None else None)
                else:
                    bottoms.append(block[slab:].zero_() if block is not None else torch.zeros(
                        (slab, w, SHARE_SIZE), dtype=torch.uint8, device=dev))
        for j, (r0, r1) in enumerate(bounds):
            _seams()
            exts = []
            for i, dev in enumerate(mesh.devices):
                with mesh.on(i):
                    panel = _to_device(x[i * slab + r0:i * slab + r1], dev)
                    ext = tops[i][r0:r1] if tops[i] is not None else torch.empty(
                        (r1 - r0, w, SHARE_SIZE), dtype=torch.uint8, device=dev)
                    ext[:, :k] = panel
                    ext[:, k:] = encodes[i](panel, 1)
                    ns = leaf_namespaces(ext, k, row0=i * slab + r0)
                    top_ns[i].append(ns)
                    top_hashes[i].append(leaf_digests(ns, ext)[2])
                    exts.append(ext)
            if not use_fft:
                _seams()
                # The step's all_gather, one owner at a time, so that one
                # gathered (n*h, 2k, S) buffer is alive at once on the host's
                # side (each owner's stream reuses its own memory).
                for b in range(n):
                    panels = gather(mesh, exts, dim=0, dst=b)
                    with mesh.on(b):
                        xor_encode_into(bottoms[b], panels, g_steps[j][b], m)
                    del panels
            del exts
        if use_fft:
            _seams()
            cols = all_to_all(mesh, tops, split_dim=1, concat_dim=0)  # (k, 2k/n, S) each
            parity_cols = []
            for j, dev in enumerate(mesh.devices):
                with mesh.on(j):
                    out = torch.empty_like(cols[j])
                    for c0 in range(0, cols[j].shape[1], cwidth):
                        out[:, c0:c0 + cwidth] = col_block(cols[j][:, c0:c0 + cwidth])
                    parity_cols.append(out)
            del cols
            bottoms = all_to_all(mesh, parity_cols, split_dim=0, concat_dim=1,
                                 out=None if roots_only else bottoms)
            del parity_cols
        _seams()
        row_parts, col_nodes = [], []
        for i, dev in enumerate(mesh.devices):
            with mesh.on(i):
                par = parity_namespaces((slab, w), dev)
                bot_hashes = leaf_digests(par, bottoms[i])[2]
                ns = torch.cat([*top_ns[i], par], dim=0)  # (2 slab, 2k, 29)
                hashes = torch.cat([*top_hashes[i], bot_hashes], dim=0)
                row_parts.append(tree_roots_from_digests(ns, ns, hashes))  # (2 slab, 90)
                # Columns: the top and the parity slab of each column, two
                # aligned runs of slab leaves, each reduced to one node.
                nst = ns.transpose(0, 1).reshape(2 * w, slab, NAMESPACE_SIZE)
                ht = hashes.transpose(0, 1).reshape(2 * w, slab, 32)
                col_nodes.append(join_nodes(*reduce_to_width(nst, nst, ht, 1)).view(w, 2, 90))
            top_ns[i] = top_hashes[i] = None
        dev0 = mesh.devices[0]
        with mesh.on(0):
            row_roots = torch.empty((w, 90), dtype=torch.uint8, device=dev0)
            nodes = torch.empty((w, 2 * n, 90), dtype=torch.uint8, device=dev0)
        for i in range(n):
            send(mesh, row_parts[i][:slab], i, 0, row_roots[i * slab:(i + 1) * slab])
            send(mesh, row_parts[i][slab:], i, 0, row_roots[k + i * slab:k + (i + 1) * slab])
            send(mesh, col_nodes[i][:, 0], i, 0, nodes[:, i])
            send(mesh, col_nodes[i][:, 1], i, 0, nodes[:, n + i])
        with mesh.on(0):
            col_roots = join_nodes(*reduce_to_width(*split_nodes(nodes), 1))[:, 0]
            droot = merkle_root_pow2(torch.cat([row_roots, col_roots], dim=0))
        roots = (row_roots, col_roots, droot)
        if roots_only:
            mesh.leave(roots)
            return roots
        eds = RowSharded(mesh, [b[:slab] for b in blocks] + [b[slab:] for b in blocks],
                         owners=list(range(n)) * 2)
        mesh.leave((eds, *roots))
        return (eds, *roots)

    from celestia_app_tpu_torch.trace.device_ledger import track
    from celestia_app_tpu_torch.trace.journal import note_jit_build

    note_jit_build("sharded_panel_pipeline")
    return track(run, "sharded_panel_pipeline", k=k, construction=construction,
                 mode="sharded_panel", batch=rows, shards=n)


releasable(_sharded_runner)
