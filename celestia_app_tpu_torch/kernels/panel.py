"""Panel-streamed extend + DAH: giant squares without the fused pipeline's
working set.

The port of celestia_app_tpu/kernels/panel.py.  The materializing pipeline
(kernels/fused.py) holds the ODS, the row-extended top half, the whole
(2k, 2k, 512) EDS and the column phase's intermediates on the card at once:
at k=2048 the EDS alone is 8.6 GB.  This lowering keeps the same two-phase
order (row extend, then one column contraction over all 2k top columns)
but runs it panel by panel from the host, so the ODS never lands on the
card whole and the column phase's intermediates are one panel's:

  * ROW PHASE — each panel of `rows` ODS rows is uploaded on its own,
    row-extended through kernels/rs.encode_fn (the dense, XOR or FFT core
    every lowering uses) and leaf-hashed in one `sha256_leaves` launch
    under the quadrant namespace rule.  Only the (p, 2k, 29) namespace and
    (p, 2k, 32) digest slabs accumulate.
  * COLUMN PHASE — mod 2 of a sum is the XOR of the per-panel mod-2
    partial sums, so panel rows [r0, r1) contribute
    G_bits[:, r0*m : r1*m] @ panel, computed by the dense core (rs_dense)
    and XOR-added in place into a (k, 2k, 512) parity accumulator as each
    panel completes (kernels/rs.xor_encode_into: the kernel's parity
    planes go straight into the accumulator's byte layout).  This stays
    dense under $CELESTIA_RS_XOR=on, as in the JAX package: the XOR core's
    packed generator words do not slice at arbitrary panel rows.  Where the encode
    seam selects the additive FFT (kernels/rs._fft_choice), the butterflies
    contract over the row axis and cannot XOR-split, so the top half stays
    resident and the bottom is encoded in blocks of columns instead
    (kernels/fft.col_block_encode_fn), each block's parity leaves hashed
    as it completes.
  * ROOTS — row and column trees reduce from the accumulated digest grids
    (kernels/fused.roots_from_digests), the same reduction as every other
    lowering over the same digests.

Memory: the accumulator is half the EDS (or, with `roots_only=False`, the
bottom half of the EDS the runner fills in place), plus one panel and one
partial product (as large as the accumulator: k*m bits of parity per
column), plus 61 B per leaf of digest grids, plus the resident generator
whose column slices the partials read as views.  The `roots_only` twin
never assembles the EDS.  At k=4096 that is 17.2 GB of accumulator, 17.2
GB of partial, 4.3 GB of generator and 6 GB of digests and tree levels,
and the materializing twin adds the 17.2 GB top half.

Selection seam: $CELESTIA_PIPE_PANEL = "<rows>" | "auto" (default off).
An integer streams every square in panels of that many ODS rows; "auto"
engages only at k >= 512 with 64-row panels.  The mode ("panel", from
kernels/fused.pipeline_mode_for_k) routes da/eds.compute, extend_shares,
the speculative extend and parallel/pipeline.BlockPipeline.  It is the
"panel" rung of the degradation ladder (chaos/degrade.py): every panel's
row phase, the parity-leaf (or FFT column-block) loop and the roots pass
the chaos seam device.dispatch("panel") first, so an injected fault lands
mid-panel, and a faulting panel (injected or real) walks the ladder to the
materializing base.  `is_warm` is the journal's compile column (a
configuration is warm once a full run of it completed), and each runner is
registered with the device ledger (family panel_pipeline, the panel height
in its batch column).
"""

from __future__ import annotations

import os
import sys
from functools import lru_cache

import numpy as np
import torch

from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, SHARE_SIZE
from celestia_app_tpu_torch.device import resolve_device, upload
from celestia_app_tpu_torch.gf.rs import active_construction, codec_for_width
from celestia_app_tpu_torch.kernels.fft import col_block_encode_fn
from celestia_app_tpu_torch.kernels.fused import roots_from_digests
from celestia_app_tpu_torch.kernels.nmt import leaf_digests, parity_namespaces
from celestia_app_tpu_torch.kernels.rs import (
    encode_core,
    encode_fn,
    generator_tensor,
    xor_encode_into,
)
from celestia_app_tpu_torch.kernels.rs_dense import tma_rows
from celestia_app_tpu_torch.trace.device_ledger import releasable

#: "auto" panel height (ODS rows per panel) and the square size at which
#: auto engages: below it the materializing pipeline holds the square
#: easily and takes fewer launches.
_AUTO_PANEL_ROWS = 64
_AUTO_PANEL_K = 512


def env_panel() -> str:
    return os.environ.get("CELESTIA_PIPE_PANEL", "")


def panel_rows(k: int) -> int:
    """ODS rows per panel for square size k; 0 = panel mode off.

    $CELESTIA_PIPE_PANEL: ""/unset/"off"/"0" disables; "auto" engages
    64-row panels at k >= 512; an integer N streams every square in N-row
    panels (clamped to k: one panel runs the materializing schedule
    through the panel code).  A malformed value warns once on stderr and
    turns the mode off."""
    val = env_panel().strip().lower()
    if val in ("", "0", "off"):
        return 0
    if val == "auto":
        return _AUTO_PANEL_ROWS if k >= _AUTO_PANEL_K else 0
    try:
        rows = int(val)
    except ValueError:
        _warn_malformed(val)
        return 0
    if rows <= 0:
        return 0
    return min(rows, k)


_WARNED_MALFORMED: set[str] = set()


def _warn_malformed(val: str) -> None:
    """A typo'd $CELESTIA_PIPE_PANEL falling back to the materializing
    pipeline quietly is the out-of-memory the knob exists to prevent: say
    so, once per distinct value."""
    if val in _WARNED_MALFORMED:
        return
    _WARNED_MALFORMED.add(val)
    print(f"ignoring malformed CELESTIA_PIPE_PANEL value {val!r} "
          "(want an integer row count or 'auto'); panel streaming is OFF",
          file=sys.stderr)


def panel_bounds(k: int, rows: int) -> tuple[tuple[int, int], ...]:
    """The row-panel partition [(r0, r1), ...] covering [0, k); the last
    panel is short when `rows` does not divide k."""
    return tuple((r0, min(r0 + rows, k)) for r0 in range(0, k, max(1, rows)))


def panel_count(k: int) -> int:
    """Panels the active seam streams for square size k (the journal's
    `panels` field); 0 when panel mode is off."""
    rows = panel_rows(k)
    return len(panel_bounds(k, rows)) if rows else 0


@lru_cache(maxsize=None)
def _col_generator_slices(k: int, construction: str, bounds: tuple,
                          device: torch.device) -> tuple:
    """Per-panel block-columns of the bit-expanded generator, on `device`:
    the column partial of panel rows [r0, r1) reads exactly
    G_bits[:, r0*m : r1*m].  Each is a view into the resident generator
    (kernels/rs.generator_tensor) where that view meets TMA's rule (a
    16-byte aligned base: always at m=16), else its own 16-byte-strided
    copy (rs_dense.tma_rows), as at m=8 for an odd r0.  Only the copies
    are counted as owned bytes: at k=4096 the views spare the card another
    4.29 GB."""
    from celestia_app_tpu_torch.trace.device_ledger import note_owned_bytes

    m, g_bits = generator_tensor(k, construction, device)
    slices = tuple(tma_rows(g_bits[:, r0 * m: r1 * m]) for r0, r1 in bounds)
    base = g_bits.untyped_storage().data_ptr()
    note_owned_bytes("panel_generator_slices", (k, construction, bounds, str(device)),
                     sum(int(s.untyped_storage().nbytes()) for s in slices
                         if s.untyped_storage().data_ptr() != base))
    return slices


releasable(_col_generator_slices, "panel_generator_slices")


def _as_panels(x, k: int, bounds: tuple) -> list:
    """Split the input into per-panel arrays.  Accepts the (k, k, S) ODS
    (numpy or tensor, sliced lazily so that a host array goes to the card
    one panel at a time) or a list of panels matching `bounds`."""
    if isinstance(x, (list, tuple)):
        if len(x) != len(bounds):
            raise ValueError(f"panel list length {len(x)} != plan {len(bounds)}")
        for panel, (r0, r1) in zip(x, bounds):
            if tuple(panel.shape) != (r1 - r0, k, SHARE_SIZE):
                raise ValueError(f"panel of shape {tuple(panel.shape)} != plan rows "
                                 f"{r1 - r0} of ({k}, {SHARE_SIZE})")
        return list(x)
    if tuple(x.shape) != (k, k, SHARE_SIZE):
        raise ValueError(f"bad ODS shape {tuple(x.shape)} for k={k}")
    return [x[r0:r1] for r0, r1 in bounds]


def _to_device(panel, dev: torch.device) -> torch.Tensor:
    """One panel on `dev`: a host array through device.upload (pinned
    staging), a pinned host tensor (a streaming ring slot) by a
    non-blocking copy on the current stream, any other tensor by `.to`."""
    if isinstance(panel, torch.Tensor):
        if panel.dtype != torch.uint8:
            raise ValueError(f"panel must be uint8, got {panel.dtype}")
        if panel.device.type == "cpu" and dev.type == "cuda" and panel.is_pinned():
            return panel.to(dev, non_blocking=True)
        return panel.to(dev)
    return upload(np.ascontiguousarray(panel, dtype=np.uint8), dev)[0]


def panel_pipeline(k: int, construction: str | None = None, roots_only: bool = False,
                   device=None):
    """The panel-streamed pipeline callable for square size k on `device`
    (default CUDA; raises without a card).

    Returns f(ods) -> (eds, row_roots, col_roots, droot), or the roots_only
    twin f(ods) -> (row_roots, col_roots, droot), which never assembles the
    square.  `ods` may be the (k, k, S) array (a host array is uploaded one
    panel at a time) or a list of per-panel arrays matching
    panel_bounds(k, panel_rows(k)).  With the seam off the whole square is
    one panel.

    The runner is cached on the fully resolved configuration: k, the
    construction, roots_only, the panel height and the RS core
    (kernels/rs.encode_core: dense, XOR, or FFT with its lowering)."""
    dev = resolve_device(device)
    construction = construction or active_construction()
    rows = panel_rows(k) or k
    return _panel_runner(k, construction, roots_only, rows, encode_core(k, dev), dev)


#: Resolved configurations (k, construction, rows, core, device) whose
#: runner completed one full run this process — the journal's compile
#: hit/miss signal for panel mode (da/eds.pipeline_cache_state).
_PANEL_WARM: set[tuple] = releasable(set())


def is_warm(k: int, construction: str | None = None, device=None) -> bool:
    """Whether the panel runner the seam resolves for k on `device`
    (default CUDA) has completed a run this process."""
    dev = resolve_device(device)
    construction = construction or active_construction()
    return (k, construction, panel_rows(k) or k, encode_core(k, dev), dev) in _PANEL_WARM


def _track(fn, k: int, construction: str, rows: int):
    """Register one panel runner with the device ledger (family
    panel_pipeline; the panel height rides the batch column)."""
    from celestia_app_tpu_torch.trace.device_ledger import track
    from celestia_app_tpu_torch.trace.journal import note_jit_build

    note_jit_build("panel_pipeline")
    return track(fn, "panel_pipeline", k=k, construction=construction, mode="panel", batch=rows)


@lru_cache(maxsize=None)
def _panel_runner(k: int, construction: str, roots_only: bool, rows: int, core: tuple,
                  dev: torch.device):
    from celestia_app_tpu_torch import chaos

    bounds = panel_bounds(k, rows)
    use_fft = core[0] == "fft"
    m = codec_for_width(k, construction).field.m
    encode = encode_fn(k, construction, dev)  # the row phase: `core`, resolved alike
    if use_fft:
        col_block = col_block_encode_fn(k, construction, md=core[1])
        cwidth = min(2 * rows, 2 * k)
    else:
        g_slices = _col_generator_slices(k, construction, bounds, dev)
    n = 2 * k

    def run(x):
        panels = _as_panels(x, k, bounds)
        eds = None if roots_only else torch.empty((n, n, SHARE_SIZE), dtype=torch.uint8,
                                                  device=dev)
        # Where the extended panels land: the EDS's top half, or, on the
        # FFT leg, a resident top half (the butterflies need whole columns).
        top = eds[:k] if eds is not None else (
            torch.empty((k, n, SHARE_SIZE), dtype=torch.uint8, device=dev) if use_fft else None)
        acc = None
        if not use_fft:
            acc = (eds[k:].zero_() if eds is not None else
                   torch.zeros((k, n, SHARE_SIZE), dtype=torch.uint8, device=dev))
        left = (torch.arange(n, device=dev) < k)[None, :, None]
        ns_slabs, top_hashes = [], []
        for i, (r0, r1) in enumerate(bounds):
            chaos.device_dispatch("panel")
            panel = _to_device(panels[i], dev)
            ext = (top[r0:r1] if top is not None else
                   torch.empty((r1 - r0, n, SHARE_SIZE), dtype=torch.uint8, device=dev))
            ext[:, :k] = panel
            ext[:, k:] = encode(panel, 1)
            ns = torch.where(left, ext[..., :NAMESPACE_SIZE],
                             parity_namespaces((), dev))  # (p, 2k, 29)
            ns_slabs.append(ns)
            top_hashes.append(leaf_digests(ns, ext)[2])
            if not use_fft:
                xor_encode_into(acc, ext, g_slices[i], m)
            del panel, ext
        bot_hashes = []
        if use_fft:
            for c0 in range(0, n, cwidth):
                c1 = min(c0 + cwidth, n)
                chaos.device_dispatch("panel")
                blk = col_block(top[:, c0:c1])  # (k, c, S)
                bot_hashes.append(leaf_digests(parity_namespaces((k, c1 - c0), dev), blk)[2])
                if eds is not None:
                    eds[k:, c0:c1] = blk
            bot = torch.cat(bot_hashes, dim=1)
        else:
            for r0, r1 in bounds:
                chaos.device_dispatch("panel")
                bot_hashes.append(
                    leaf_digests(parity_namespaces((r1 - r0, n), dev), acc[r0:r1])[2])
            bot = torch.cat(bot_hashes, dim=0)
        ns = torch.cat([*ns_slabs, parity_namespaces((k, n), dev)], dim=0)
        chaos.device_dispatch("panel")
        roots = roots_from_digests(ns, ns, torch.cat([*top_hashes, bot], dim=0))
        _PANEL_WARM.add((k, construction, rows, core, dev))
        return roots if roots_only else (eds, *roots)

    return _track(run, k, construction, rows)


releasable(_panel_runner)
