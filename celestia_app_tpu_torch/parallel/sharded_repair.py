"""Multi-device erasure repair: decode sweeps split over a device mesh.

The port of celestia_app_tpu/parallel/sharded_repair.py.  The damaged
square is small beside a card (537 MB at k=512) and a decode reads
arbitrary surviving positions, so every shard holds a replica of it and
the compute is split over lines: each same-pattern group's lines are cut
into n contiguous parts, shard i decodes its part with the group's
full-line recover matrix (kernels/rs.encode_axis -> rs_dense on the card),
survivors kept, and an all_gather hands every replica every decoded line.
The crossword alternates row and column sweeps until the square is whole,
as the JAX program does.  The re-extension of the recovered ODS runs on
the sharded extend (parallel/sharded_eds.py), each shard feeding its ODS
rows from its own replica, and the survivor check runs per EDS row block
on its shard against its replica; one bool per shard crosses to the
host.

The contract of da/repair.repair: IrrecoverableSquare below the
threshold, RootMismatch when the survivors are not one codeword or the
roots differ from `dah`.  No ladder: a fault raises.
"""

from __future__ import annotations

import numpy as np
import torch

from celestia_app_tpu_torch.constants import SHARE_SIZE
from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader
from celestia_app_tpu_torch.da.eds import ExtendedDataSquare
from celestia_app_tpu_torch.da.repair import (
    IrrecoverableSquare,
    RootMismatch,
    _private,
    _recover_bits_device,
    _solvable_groups,
)
from celestia_app_tpu_torch.gf.rs import active_construction, codec_for_width
from celestia_app_tpu_torch.kernels.rs import encode_axis
from celestia_app_tpu_torch.parallel.mesh import Mesh, all_gather
from celestia_app_tpu_torch.parallel.sharded_eds import cached_pipeline, default_mesh


def _sweep(mesh: Mesh, data: list, present_devs: list, k: int, axis: int,
           construction: str, lines: list[int], pattern: bytes) -> None:
    """Decode one pattern group's `lines` along `axis`, the lines cut over
    the shards, and write every decoded line into every replica
    (`present_devs`: the availability mask on each shard)."""
    m = codec_for_width(k, construction).field.m
    n = mesh.size
    parts = np.array_split(np.asarray(lines, dtype=np.int64), n)
    decoded = []
    for i, dev in enumerate(mesh.devices):
        with mesh.on(i):
            R_bits, known_idx = _recover_bits_device(k, pattern, construction, dev)
            line_idx = torch.from_numpy(parts[i]).to(dev)
            pm = present_devs[i].index_select(axis, line_idx)[..., None]
            got = data[i].index_select(axis, line_idx)  # (L_i, 2k, S) or (2k, L_i, S)
            full = encode_axis(got.index_select(1 - axis, known_idx), R_bits, m,
                               contract_axis=1 - axis)
            mixed = torch.where(pm, got, full)
            decoded.append(mixed if axis == 0 else mixed.transpose(0, 1).contiguous())
    every = all_gather(mesh, decoded, dim=0)  # (L, 2k, S) line-major on each shard
    for i, dev in enumerate(mesh.devices):
        with mesh.on(i):
            line_idx = torch.from_numpy(np.asarray(lines, dtype=np.int64)).to(dev)
            data[i].index_copy_(axis, line_idx,
                                every[i] if axis == 0 else every[i].transpose(0, 1))


def sharded_repair(shares, present, mesh: Mesh | None = None,
                   dah: DataAvailabilityHeader | None = None, device=None) -> ExtendedDataSquare:
    """Reconstruct the full EDS with decode sweeps split over `mesh`
    (default: every device of `device`'s type, default CUDA; raises without
    a card).

    The contract of da/repair.repair: shares (2k, 2k, SHARE_SIZE) uint8,
    numpy or tensor, with arbitrary bytes at missing positions, never
    modified; present the (2k, 2k) availability mask.  The result's EDS is
    row-sharded over the mesh.  Requires n | 2k (and n | k for the
    re-extension)."""
    if mesh is None:
        mesh = default_mesh(device=device)
    host = shares.cpu().numpy() if isinstance(shares, torch.Tensor) else np.asarray(shares)
    present_host = np.array(present, dtype=bool, copy=True)
    n_axis = host.shape[0]
    if (host.dtype != np.uint8 or host.shape != (n_axis, n_axis, SHARE_SIZE) or n_axis % 2
            or present_host.shape != (n_axis, n_axis)):
        raise ValueError(f"bad EDS {host.dtype} {host.shape} or mask {present_host.shape}")
    k = n_axis // 2
    n = mesh.size
    if (2 * k) % n:
        raise ValueError(f"device count {n} must divide EDS width {2 * k}")
    # Fixed at entry: a flip of the environment mid-repair must not decode
    # with one generator and verify with another.
    construction = active_construction()
    if k % n:
        raise ValueError(f"device count {n} must divide square size {k}")
    present_orig = present_host.copy()
    mesh.enter()
    data = _replicas(mesh, np.ascontiguousarray(host))

    while not present_host.all():
        progressed = False
        for axis in (0, 1):
            groups = _solvable_groups(present_host, k, axis, data_only=False)
            if not groups:
                continue
            # One mask upload per shard and sweep: the groups of a sweep
            # decode disjoint lines (the JAX program's present_dev).
            present_devs = []
            for i, dev in enumerate(mesh.devices):
                with mesh.on(i):
                    present_devs.append(_private(present_host, dev))
            for pattern, lines in groups.items():
                _sweep(mesh, data, present_devs, k, axis, construction, lines, pattern)
                if axis == 0:
                    present_host[lines, :] = True
                else:
                    present_host[:, lines] = True
                progressed = True
        if not progressed:
            raise IrrecoverableSquare(f"stuck with {int((~present_host).sum())} missing shares")

    kl = k // n
    pipe = cached_pipeline(k, mesh, construction)
    eds, rr, cr, droot = pipe([data[i][i * kl:(i + 1) * kl, :k] for i in range(n)])
    # Survivors are authoritative: each shard checks its EDS row block
    # against its replica under the input mask (a sweep never writes a
    # present cell, so there the replica holds the input's bytes).
    mesh.enter()
    rows = eds.rows_per_block
    bad = []
    for b, (block, owner) in enumerate(zip(eds.blocks, eds.owners)):
        with mesh.on(owner):
            r0 = b * rows
            mask = _private(present_orig[r0:r0 + rows], mesh.devices[owner])
            bad.append(((block != data[owner][r0:r0 + rows]).any(dim=2) & mask).any())
    mesh.leave()
    if any(bool(b) for b in bad):
        raise RootMismatch("recovered shares are not a consistent codeword")
    out = ExtendedDataSquare(eds, rr, cr, droot, k)
    if dah is not None and not DataAvailabilityHeader.from_eds(out).equals(dah):
        raise RootMismatch("repaired square does not match the DAH")
    return out


def _replicas(mesh: Mesh, host: np.ndarray) -> list:
    """The damaged square on every shard, each its own buffer."""
    from celestia_app_tpu_torch.device import upload

    out = []
    for i, dev in enumerate(mesh.devices):
        with mesh.on(i):
            out.append(upload(host, dev, stream=mesh.streams[i])[0])
    return out
