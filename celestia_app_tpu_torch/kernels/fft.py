"""Additive-FFT RS encode as grouped butterflies: batched 0/1 products.

The port of celestia_app_tpu/kernels/fft.py.  It lowers gf/fft.py's LCH
butterfly encode (the algorithm of the reference's rsmt2d.NewLeoRSCodec)
to batched bit products.  One stage's butterflies are 2-symbol blocks, too
skinny for a matrix unit, so stages are fused in groups of g = log2(128/m)
(g=4 for GF(2^8), g=3 for GF(2^16)): a group's composed operator is
block-diagonal with one (2^g x 2^g) GF block per surrounding index, which
bit-expands to a (128, 128) 0/1 matrix, applied as one batched product
over all blocks and share bytes.

The JAX package computes each group with `lax.dot_general` outside any
Pallas kernel; here it is `torch.bmm` (or `torch.einsum` for the `md`
lowering).  torch has no int8 batched product on CUDA, so the bits travel
as float16 on the card and float32 on the CPU: every entry of a product is
a sum of at most 128 zero/one terms, an integer below 2048, which both
types hold exactly at every partial sum; `remainder(2)` then gives the
bit.  The output equals the dense generator encode (kernels/rs.py) bit for
bit: the same linear map, another factorization (tests/test_torch_fft.py).

Op count at k=512, GF(2^16): 2 * ceil(9 / 3) = 6 groups of 128-deep
contractions against the dense encode's 8192-deep one.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from celestia_app_tpu_torch.gf.fft import encode_params, stage_twiddles
from celestia_app_tpu_torch.gf.rs import codec_for_width
from celestia_app_tpu_torch.kernels.rs import _encode_with
from celestia_app_tpu_torch.kernels.rs_dense import _pack_bits, _unpack_bits
from celestia_app_tpu_torch.trace.device_ledger import releasable


def _group_matrices(
    field, basis: tuple[int, ...], r: int, j0: int, j1: int, shift: int,
    inverse: bool,
) -> np.ndarray:
    """(hi, mid, mid) GF matrices composing butterfly stages [j0, j1).

    mid = 2^(j1-j0) symbols; hi = 2^(r-j1) surrounding blocks (the stage
    twiddles depend only on index bits >= j0 outside the group's low bits,
    so one matrix per hi-block serves every low index).  Rows track the
    butterflies: a[u] ^= w*a[v] is M[u,:] ^= w*M[v,:].
    """
    mid = 1 << (j1 - j0)
    hi = 1 << (r - j1)
    M = np.tile(np.eye(mid, dtype=np.uint32), (hi, 1, 1))
    stages = range(j0, j1) if inverse else range(j1 - 1, j0 - 1, -1)
    for j in stages:
        tw = stage_twiddles(field, basis, r, j, shift)
        d = 1 << (j - j0)
        for h in range(hi):
            for tm in range(mid >> (j - j0 + 1)):
                t = (h << (j1 - j - 1)) | tm
                w = int(tw[t])
                base = tm << (j - j0 + 1)
                u = slice(base, base + d)
                v = slice(base + d, base + 2 * d)
                if inverse:
                    M[h, v] ^= M[h, u]
                    if w:
                        M[h, u] ^= field.mul(w, M[h, v]).astype(np.uint32)
                else:
                    if w:
                        M[h, u] ^= field.mul(w, M[h, v]).astype(np.uint32)
                    M[h, v] ^= M[h, u]
    return M


@lru_cache(maxsize=None)
def encode_groups(k: int, construction: str) -> tuple:
    """The encode program for square size k: a tuple of
    (j0, j1, M_bits (hi, B, B) np.uint8) applied in order — the IFFT over
    the data coset followed by the FFT over the parity coset."""
    codec = codec_for_width(k, construction)
    field, basis, data_shift, parity_shift = encode_params(codec)
    r = max(k.bit_length() - 1, 0)
    if r == 0:
        return ()
    g = max(1, (128 // field.m).bit_length() - 1)  # 4 for m=8, 3 for m=16
    out = []
    # IFFT: stages ascend; group [j0, j1) applied low-to-high.
    bounds = list(range(0, r, g)) + [r]
    for j0, j1 in zip(bounds[:-1], bounds[1:]):
        M = _group_matrices(field, basis, r, j0, j1, data_shift, inverse=True)
        out.append((j0, j1, _expand_blocks(field, M)))
    # FFT: stages descend; group [j0, j1) applied high-to-low.
    for j0, j1 in reversed(list(zip(bounds[:-1], bounds[1:]))):
        M = _group_matrices(field, basis, r, j0, j1, parity_shift, inverse=False)
        out.append((j0, j1, _expand_blocks(field, M)))
    return tuple(out)


def _expand_blocks(field, M: np.ndarray) -> np.ndarray:
    """Bit-expand (hi, mid, mid) GF blocks -> (hi, mid*m, mid*m) uint8."""
    return np.stack([field.expand_bit_matrix(M[h]) for h in range(M.shape[0])])


def bits_dtype(device: torch.device) -> torch.dtype:
    """The type the bits travel in: float16 on the card (tensor cores),
    float32 on the CPU; both exact for the group products (module doc)."""
    return torch.float16 if device.type == "cuda" else torch.float32


@lru_cache(maxsize=None)
def _device_groups(k: int, construction: str, device: torch.device) -> tuple:
    """encode_groups(k, construction) with each matrix on `device`."""
    dtype = bits_dtype(device)
    return tuple((j0, j1, torch.from_numpy(M).to(device=device, dtype=dtype))
                 for j0, j1, M in encode_groups(k, construction))


releasable(_device_groups)


def _apply_groups(bits: torch.Tensor, groups: tuple, m: int,
                  md: bool | None = None) -> torch.Tensor:
    """Run the encode program on bit planes.

    bits: (k, m, cols) 0/1 in bits_dtype — symbol-major bit layout (bit b
    of symbol i at [i, b, :]).  Returns the transformed (k, m, cols).

    Two lowerings, byte-identical ($CELESTIA_RS_FFT_MD=1 selects `md` when
    `md` is None; callers may force one):
      * default — explicit transpose to (hi, B, lo*cols), then one batched
        2-D product per group (`torch.bmm`);
      * md — one `torch.einsum` contracting over both the mid and the bit
        axes in their natural positions, the layout left to the library.
    """
    if md is None:
        md = os.environ.get("CELESTIA_RS_FFT_MD") == "1"
    k, _, cols = bits.shape
    for j0, j1, M in groups:
        mid = 1 << (j1 - j0)
        lo = 1 << j0
        hi = k // (mid * lo)
        x = bits.reshape(hi, mid, lo, m, cols)
        if md:
            M5 = M.reshape(hi, mid, m, mid, m)
            y = torch.einsum("harnb,hnlbc->harlc", M5, x)  # (hi, mid, m, lo, cols)
        else:
            B = mid * m
            x2 = x.permute(0, 1, 3, 2, 4).reshape(hi, B, lo * cols)
            y = torch.bmm(M, x2).view(hi, mid, m, lo, cols)
        y.remainder_(2)
        bits = y.permute(0, 1, 3, 2, 4).reshape(k, m, cols)
    return bits


def _fft_planes(planes: torch.Tensor, groups: tuple, m: int, md: bool | None) -> torch.Tensor:
    """(n, bps, cols) byte planes -> the (n, bps, cols) parity planes."""
    n, bps, cols = planes.shape
    if not groups:  # k == 1: parity equals data
        return planes.clone()
    bits = _unpack_bits(planes).reshape(n, m, cols).to(bits_dtype(planes.device))
    out = _apply_groups(bits, groups, m, md)
    return _pack_bits(out.to(torch.uint8).reshape(n * m, cols), n, bps)


def encode_axis_fft(data: torch.Tensor, k: int, construction: str,
                    contract_axis: int = 1, md: bool | None = None) -> torch.Tensor:
    """FFT-encode over `contract_axis` of (..., S) uint8 byte shares.

    Same surface as kernels/rs.encode_axis with the generator implied:
    returns the k parity shares with the contracted axis replaced, other
    axes untouched.  Bit-identical to the dense generator path."""
    m = codec_for_width(k, construction).field.m
    groups = _device_groups(k, construction, data.device)

    def core(_G, planes: torch.Tensor, _m: int) -> torch.Tensor:
        return _fft_planes(planes, groups, m, md)

    return _encode_with(core, data, None, m, contract_axis)


def col_block_encode_fn(k: int, construction: str, md: bool | None = None):
    """The panel-blocked staging of the column-phase butterflies
    (kernels/panel.py's FFT leg): f(top_cols (k, c, S)) -> (k, c, S).

    The butterfly network contracts over the row axis, so it cannot be
    XOR-split across row panels the way the dense generator can; but every
    column's butterfly chain is independent (columns are pure batch in
    _apply_groups), so blocking the batch axis runs the identical stage
    program on c columns at a time.  That bounds the 8x bit-plane inflation
    to one block: at k=2048 the whole top half would unpack to 3.4e10 bits,
    68 GB as float16.  Bytes are those of the unblocked call sliced at the same
    columns."""

    def run(top_cols: torch.Tensor) -> torch.Tensor:
        return encode_axis_fft(top_cols, k, construction, contract_axis=0, md=md)

    return run
