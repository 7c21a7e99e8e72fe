"""Erasure repair: reconstruct a full EDS from >= 25% of its shares.

The port of celestia_app_tpu/da/repair.py (rsmt2d.ExtendedDataSquare.Repair
parity; BASELINE config 4 is a quadrant erasure).  The damaged square goes
to the device once; every decode sweep, the re-extension and the survivor
consistency check run there, and one bool and the roots come back.

  * A sweep decodes every solvable line of one axis.  Lines are grouped by
    erasure pattern; each group's k known shares are gathered and run
    through one RS product (kernels/rs.encode_axis, the dense kernel on
    the card) against the group's recover matrix cut down to its missing
    positions, and one index_copy_ writes every decoded (line, missing
    position) cell of the sweep.  Survivors are never written.
  * Repair decodes what the output needs: the result is the re-extension
    of the recovered ODS, so parity lines are decoded only when a round
    makes no progress on the data and the crossword needs them.  A
    pure-parity erasure does no sweep at all.
  * The recover matrices are cached on the device per (k, pattern,
    construction, device), so a repeated erasure shape skips the O(k^3)
    host solve and the upload.  At k=512 one matrix is (8192, 8192) int8,
    64 MiB; the bounds are those of the JAX package (128 cut-down and 64
    full-line matrices).

$CELESTIA_REPAIR_SWEEP pins the algorithm: "batched" (default, above) or
"grouped", the per-group baseline that decodes whole lines until the full
square is present; the two give the same bytes.

Every sweep and the re-extension ride chaos/degrade.guarded_dispatch, so
a repair-path fault steps the same ladder as every other extend: the
batched sweep is the fused-family rung, the per-group sweep the staged rung
and, in the port, also the host floor (the same sweep on the same card).
The re-extension runs the lowering kernels/fused.pipeline_mode names, with
the RS construction fixed at entry.  A retry of a sweep re-reads only
survivor cells and rewrites only missing ones, so it is idempotent, and
the availability mask advances only after a sweep succeeded.  Survivors are
authoritative: a set that is not one codeword is rejected (RootMismatch),
as is a square whose roots differ from `dah`; each rejection is an
adversary detection (`celestia_da_detections_total{kind=
"root_mismatch"}`, chaos/adversary.detections), fires the `root_mismatch`
flight-recorder trigger and, when the height is known, enqueues a heal
(serve/heal.note_detection).  The recover matrices' bytes are the ledger
owner `repair_recover_cache`.
"""

from __future__ import annotations

import os
import weakref
from functools import lru_cache

import numpy as np
import torch

from celestia_app_tpu_torch.constants import SHARE_SIZE
from celestia_app_tpu_torch.convert import bits_tensor
from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader
from celestia_app_tpu_torch.da.eds import ExtendedDataSquare, _resolver
from celestia_app_tpu_torch.device import resolve_device, upload
from celestia_app_tpu_torch.gf.rs import active_construction, codec_for_width
from celestia_app_tpu_torch.kernels.rs import encode_axis
from celestia_app_tpu_torch.trace.device_ledger import register_owner as _register_owner


class IrrecoverableSquare(ValueError):
    """Not enough shares to reconstruct the square."""


class RootMismatch(ValueError):
    """Repaired square does not match the DataAvailabilityHeader."""


def repair_sweep_mode() -> str:
    """$CELESTIA_REPAIR_SWEEP: "batched" (default) or "grouped"."""
    return "grouped" if os.environ.get("CELESTIA_REPAIR_SWEEP", "") == "grouped" else "batched"


def _root_mismatch_detected(reason: str, height: int | None = None, **context) -> None:
    """Every repair rejection is an adversary-detection event: tick the
    detection counter and black-box the moment (the survivor set and the
    DAH that disagreed are in the trace tables right now), and hand the
    height to the healing engine that owns it."""
    from celestia_app_tpu_torch.chaos.adversary import detections
    from celestia_app_tpu_torch.trace.flight_recorder import note_trigger

    detections().inc(kind="root_mismatch")
    if height is not None:
        context["height"] = height
        from celestia_app_tpu_torch.serve import heal

        heal.note_detection("root_mismatch", height)
    note_trigger("root_mismatch", reason=reason, **context)


#: Live recover-matrix tensors by cache key — a WEAK view over what the
#: bounded lru caches below still hold, so the ownership ledger's figure
#: falls when an entry evicts (trace/device_ledger.py).
_RECOVER_CACHE_TENSORS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def _recover_cache_bytes() -> int:
    """Bytes held by the recover-matrix caches (the ownership-ledger
    callback): the bit-expanded matrices still alive."""
    return sum(int(t.numel()) * t.element_size() for t in list(_RECOVER_CACHE_TENSORS.values()))


_register_owner("repair_recover_cache", _recover_cache_bytes)


def _private(present: np.ndarray, device: torch.device) -> torch.Tensor:
    """The mask on `device` in a buffer of its own: repair mutates its host
    mask while device work that reads the upload may still be in flight,
    and torch.from_numpy on the CPU would alias it."""
    return torch.tensor(present, dtype=torch.bool, device=device)


@lru_cache(maxsize=64)
def _recover_bits_device(k: int, pattern: bytes, construction: str, device: torch.device):
    """(R_bits (2k*m, k*m) int8, known_idx (k,)) on `device` for one erasure
    pattern of a width-2k line: the full-line recover matrix of the grouped
    sweep."""
    codec = codec_for_width(k, construction)
    known_pos = np.nonzero(np.frombuffer(pattern, dtype=bool))[0][:k]
    R = codec.recover_matrix(known_pos)
    R_bits = bits_tensor(codec.field.expand_bit_matrix(R), device)
    _RECOVER_CACHE_TENSORS[("full", k, pattern, construction, device)] = R_bits
    return R_bits, torch.from_numpy(known_pos.astype(np.int64)).to(device)


@lru_cache(maxsize=128)
def _recover_bits_missing(k: int, pattern: bytes, construction: str, device: torch.device):
    """(R_miss_bits (miss*m, k*m) int8 on `device`, known_pos (k,), miss_pos
    (miss,) host int64) for one pattern: the (2k, k) recover matrix cut to
    the missing rows before bit expansion, so the batched sweep computes
    only the cells it writes."""
    codec = codec_for_width(k, construction)
    mask = np.frombuffer(pattern, dtype=bool)
    known_pos = np.nonzero(mask)[0][:k]
    miss_pos = np.nonzero(~mask)[0]
    R = codec.recover_matrix(known_pos)
    R_miss = bits_tensor(codec.field.expand_bit_matrix(R[miss_pos]), device)
    _RECOVER_CACHE_TENSORS[("missing", k, pattern, construction, device)] = R_miss
    return R_miss, known_pos.astype(np.int64), miss_pos.astype(np.int64)


@lru_cache(maxsize=64)
def _stacked_sweep_inputs(k: int, construction: str, axis: int, patterns: tuple[bytes, ...],
                          lines: tuple[tuple[int, ...], ...], device: torch.device):
    """Index tensors of one batched sweep over `patterns[g]` decoding
    `lines[g]`, uploaded as one buffer and cached per erasure shape:
    (gathers, shapes, write_idx).  gathers[g] picks group g's known cells
    out of the flat (4k^2, S) square in the order of shapes[g] ((lines, k)
    for a row sweep, (k, lines) for a column sweep); write_idx lists every
    decoded (line, missing position) cell of the sweep in the order the
    groups' products emit them."""
    n = 2 * k
    gathers, writes, shapes = [], [], []
    for pat, ls in zip(patterns, lines):
        _, known, miss = _recover_bits_missing(k, pat, construction, device)
        ls = np.asarray(ls, dtype=np.int64)
        if axis == 0:
            gathers.append((ls[:, None] * n + known[None, :]).ravel())
            writes.append((ls[:, None] * n + miss[None, :]).ravel())
            shapes.append((len(ls), k))
        else:
            gathers.append((known[:, None] * n + ls[None, :]).ravel())
            writes.append((miss[:, None] * n + ls[None, :]).ravel())
            shapes.append((k, len(ls)))
    flat = torch.from_numpy(np.concatenate(gathers + writes)).to(device)
    views, off = [], 0
    for g in gathers:
        views.append(flat[off:off + len(g)])
        off += len(g)
    return tuple(views), tuple(shapes), flat[off:]


def _batched_sweep(data: torch.Tensor, k: int, axis: int, construction: str,
                   patterns: dict[bytes, list[int]]) -> torch.Tensor:
    """Decode every group of one sweep: one RS product per pattern group
    over its lines' known shares, then one index_copy_ of the missing cells
    (the port of the JAX package's vmapped sweep, celestia_app_tpu/da/
    repair.py:197-280; no sentinel padding, so nothing else is written)."""
    pats = tuple(patterns)
    lines = tuple(tuple(patterns[p]) for p in pats)
    m = codec_for_width(k, construction).field.m
    n = 2 * k
    gathers, shapes, write_idx = _stacked_sweep_inputs(k, construction, axis, pats, lines,
                                                       data.device)
    cells = data.view(n * n, SHARE_SIZE)
    decoded = []
    for pat, gidx, shape in zip(pats, gathers, shapes):
        R_miss = _recover_bits_missing(k, pat, construction, data.device)[0]
        known = cells.index_select(0, gidx).view(*shape, SHARE_SIZE)
        # Row sweep: (lines, k, S) -> (lines, miss, S); column sweep:
        # (k, lines, S) -> (miss, lines, S), both in write_idx's order.
        dec = encode_axis(known, R_miss, m, contract_axis=1 - axis)
        decoded.append(dec.reshape(-1, SHARE_SIZE))
    cells.index_copy_(0, write_idx, torch.cat(decoded))
    return data


def _grouped_sweep(data: torch.Tensor, present_host: np.ndarray, k: int, axis: int,
                   construction: str, patterns: dict[bytes, list[int]]) -> torch.Tensor:
    """The per-group baseline: decode each group's lines whole with the
    full-line recover matrix and write them back with the present cells
    kept (celestia_app_tpu/da/repair.py:283-353).  `present_host` is read,
    never written: the caller marks the lines once the sweep succeeded."""
    m = codec_for_width(k, construction).field.m
    present_dev = _private(present_host, data.device)
    for pat, ls in patterns.items():
        R_bits, known_idx = _recover_bits_device(k, pat, construction, data.device)
        line_idx = torch.tensor(ls, dtype=torch.int64, device=data.device)
        pm = present_dev.index_select(axis, line_idx)[..., None]
        lines = data.index_select(axis, line_idx)  # (L, 2k, S) or (2k, L, S)
        known = lines.index_select(1 - axis, known_idx)
        full = encode_axis(known, R_bits, m, contract_axis=1 - axis)
        data.index_copy_(axis, line_idx, torch.where(pm, lines, full))
    return data


def _sweep_for_mode(mode: str, k: int, axis: int, construction: str,
                    patterns: dict[bytes, list[int]], present_host: np.ndarray):
    """One sweep's callable on a ladder rung — the repair path's face of
    guarded_dispatch's `resolve`: the batched sweep on the fused-family
    rungs, the per-group sweep on staged and on the host floor.  Both
    write the same bytes, and only into missing cells."""
    if mode in ("fused", "fused_epi"):
        sweep = _sweep_program("batched", k, construction)
        return lambda data: sweep(data, k, axis, construction, patterns)
    sweep = _sweep_program("grouped", k, construction)
    return lambda data: sweep(data, present_host, k, axis, construction, patterns)


@lru_cache(maxsize=None)
def _sweep_program(kind: str, k: int, construction: str):
    """The sweep of `kind` ("batched" or "grouped") registered with the
    device ledger per (k, construction), under the JAX package's families
    repair_batched_sweep and repair_sweep."""
    from celestia_app_tpu_torch.trace.device_ledger import track

    if kind == "batched":
        return track(_batched_sweep, "repair_batched_sweep", k=k, construction=construction,
                     mode="batched")
    return track(_grouped_sweep, "repair_sweep", k=k, construction=construction, mode="staged")


def _mark(present_host: np.ndarray, axis: int, lines) -> None:
    if axis == 0:
        present_host[lines, :] = True
    else:
        present_host[:, lines] = True


def _solvable_groups(present_host: np.ndarray, k: int, axis: int, *,
                     data_only: bool) -> dict[bytes, list[int]]:
    """Pattern -> lines for one sweep.  `data_only` keeps the lines that
    recover at least one missing ODS position."""
    pm = present_host if axis == 0 else present_host.T
    incomplete = ~pm.all(axis=1)
    solvable = incomplete & (pm.sum(axis=1) >= k)
    if data_only:
        data_missing = ~pm[:, :k].all(axis=1)
        data_missing[k:] = False  # lines >= k are pure parity
        solvable = solvable & data_missing
    patterns: dict[bytes, list[int]] = {}
    for i in np.nonzero(solvable)[0]:
        patterns.setdefault(pm[i].tobytes(), []).append(int(i))
    return patterns


def _solve_batched(data, present_host: np.ndarray, k: int, construction: str):
    """Crossword solve to ODS completion, one guarded sweep per axis and
    round: data-bearing lines first; a round without data progress falls
    back to every solvable line, so a recovered parity line can unlock a
    data line.  Stops as soon as the ODS is whole (everything else
    re-derives from it)."""
    from celestia_app_tpu_torch.chaos.degrade import guarded_dispatch

    def sweep_round(data, *, data_only: bool):
        progressed = False
        for axis in (0, 1):
            patterns = _solvable_groups(present_host, k, axis, data_only=data_only)
            if not patterns:
                continue
            _, data = guarded_dispatch(
                lambda m: _sweep_for_mode(m, k, axis, construction, patterns, present_host),
                data)
            for lines in patterns.values():
                _mark(present_host, axis, lines)
            progressed = True
        return progressed, data

    while not present_host[:k, :k].all():
        progressed, data = sweep_round(data, data_only=True)
        if not present_host[:k, :k].all() and not progressed:
            progressed, data = sweep_round(data, data_only=False)
        if not progressed:
            raise IrrecoverableSquare(
                f"stuck with {int((~present_host[:k, :k]).sum())} missing ODS shares")
    return data


def _solve_grouped(data, present_host: np.ndarray, k: int, construction: str):
    """$CELESTIA_REPAIR_SWEEP=grouped: alternate row and column sweeps until
    the full square is present, one decode per erasure-pattern group, each
    sweep guarded (every rung runs the per-group sweep here: it is the
    baseline the batched solve is held to)."""
    from celestia_app_tpu_torch.chaos.degrade import guarded_dispatch

    while not present_host.all():
        progressed = False
        for axis in (0, 1):
            patterns = _solvable_groups(present_host, k, axis, data_only=False)
            if patterns:
                sweep = _sweep_program("grouped", k, construction)
                _, data = guarded_dispatch(
                    lambda m: lambda d: sweep(d, present_host, k, axis, construction, patterns),
                    data)
                for lines in patterns.values():
                    _mark(present_host, axis, lines)
                progressed = True
        if not progressed:
            raise IrrecoverableSquare(f"stuck with {int((~present_host).sum())} missing shares")
    return data


def repair(shares, present, dah: DataAvailabilityHeader | None = None, *,
           height: int | None = None, device=None) -> ExtendedDataSquare:
    """Reconstruct the full EDS on `device` (default CUDA; raises without a
    card).

    shares: (2k, 2k, SHARE_SIZE) uint8, numpy or tensor, with arbitrary
    bytes at missing positions, never modified; present: (2k, 2k) bool
    availability mask.  If `dah` is given, the repaired square's roots must
    match it (the Repair contract: a node verifies what it reconstructs).
    `height`, when the caller knows it, stamps a rejection's trigger."""
    from celestia_app_tpu_torch.chaos.degrade import guarded_dispatch

    dev = resolve_device(device)
    present_host = np.array(present, dtype=bool, copy=True)
    if isinstance(shares, torch.Tensor):
        damaged = shares.to(dev)
    else:
        damaged, _ = upload(np.asarray(shares), dev)
    n = damaged.shape[0]
    if (damaged.dtype != torch.uint8 or tuple(damaged.shape) != (n, n, SHARE_SIZE) or n % 2
            or present_host.shape != (n, n)):
        raise ValueError(f"bad EDS {damaged.dtype} {tuple(damaged.shape)} or mask "
                         f"{present_host.shape}")
    k = n // 2
    # Fixed at entry: a flip of the environment mid-repair must not decode
    # with one generator or lowering and verify with another.
    construction = active_construction()

    data = damaged.clone(memory_format=torch.contiguous_format)
    present_orig = _private(present_host, dev)
    if repair_sweep_mode() == "grouped":
        data = _solve_grouped(data, present_host, k, construction)
    else:
        data = _solve_batched(data, present_host, k, construction)

    # Re-extend the recovered ODS: parity and the roots for the DAH check,
    # on the process mode (repair wants the materializing full EDS, so no
    # per-k panel seat) and the construction fixed at entry.
    _, (eds, rr, cr, droot) = guarded_dispatch(_resolver(k, construction, dev), data[:k, :k])
    # Survivors are authoritative: the recomputed codeword must reproduce
    # every share present in the input (decided on the device; one bool
    # crosses to the host).
    if bool(((eds != damaged).any(dim=2) & present_orig).any()):
        _root_mismatch_detected("inconsistent_survivors", height=height, k=k)
        raise RootMismatch("recovered shares are not a consistent codeword")
    out = ExtendedDataSquare(eds, rr, cr, droot, k)
    if dah is not None and not DataAvailabilityHeader.from_eds(out).equals(dah):
        _root_mismatch_detected("dah_mismatch", height=height, k=k)
        raise RootMismatch("repaired square does not match the DAH")
    return out
