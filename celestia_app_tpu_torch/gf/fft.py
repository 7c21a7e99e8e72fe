"""Additive (LCH) FFT over GF(2^m): leopard's O(n log n) evaluation algorithm.

The port's own copy of celestia_app_tpu/gf/fft.py (numpy only, byte for
byte the same transforms).  Here it also builds the RS generator itself
(gf/rs.RSCodec: the encode of the identity), which at k=2048 takes seconds
where the Gaussian solve takes minutes.

The reference pins `rsmt2d.NewLeoRSCodec` (pkg/appconsts/global_consts.go:92),
whose encode is the Lin-Chung-Han additive FFT ("Novel Polynomial Basis and
Its Application to Reed-Solomon Erasure Codes", FFT butterflies over the
subspace polynomial basis) as implemented by klauspost/reedsolomon's leopard
ports.  This module is the host reference for that algorithm, parameterized
by the subspace basis so BOTH of this repo's RS constructions ride it:

  * leopard construction — basis = gf/leopard.cantor_basis; data shares sit
    on the grid's high coset (shift b_K), parity on the low (shift 0);
  * vandermonde construction — basis = (1, 2, 4, ..): the evaluation points
    0..2k-1 ARE that basis's subspace enumeration (omega_i == i), data on
    the low half (shift 0), parity on the high coset (shift k).

Correctness contract (pinned by tests/test_fft.py and
tests/test_torch_fft.py): for every k and both constructions, `encode_fft`
reproduces RSCodec.encode — the generator matmul
G = V_parity @ inv(V_data) — bit for bit.  The FFT is the same
linear map computed in O(n log n) butterflies instead of O(n^2) dot
products; kernels/fft.py lowers the butterfly stages to batched bit-matmul
groups.

Machinery (FNT-paper notation):

  W_j(x)  = prod_{v in span(b_0..b_{j-1})} (x + v)     subspace vanishing
            polynomial — GF(2)-linearized, so W_j(x+y) = W_j(x) + W_j(y);
  What_j  = W_j / W_j(b_j)                              normalized;
  stage-j butterfly between a[i] and a[i+2^j] with twiddle
  w = What_j(omega_block + shift):
      FFT   (coeffs -> values, stages j = r-1 .. 0):
          a[i]     ^= w * a[i+d];   a[i+d] ^= a[i]
      IFFT  (values -> coeffs, stages j = 0 .. r-1):
          a[i+d]   ^= a[i];         a[i]   ^= w * a[i+d]
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from celestia_app_tpu_torch.gf.field import GF


@lru_cache(maxsize=None)
def _subspace_table(field: GF, basis: tuple[int, ...]) -> np.ndarray:
    """T[j][i] = W_j(basis[i]) for j <= i < r (zero for i < j).

    Recurrence: W_0(x) = x and W_{j+1}(x) = W_j(x) * (W_j(x) + W_j(b_j)),
    since W_{j+1}(x) = W_j(x) * W_j(x + b_j) and W_j is linearized.
    """
    r = len(basis)
    T = np.zeros((r + 1, r), dtype=np.uint32)
    T[0, :] = np.asarray(basis, dtype=np.uint32)
    for j in range(r):
        pivot = T[j, j]
        for i in range(j + 1, r):
            T[j + 1, i] = int(field.mul(T[j, i], T[j, i] ^ pivot))
    return T


def _w_eval(field: GF, basis: tuple[int, ...], j: int, x: int) -> int:
    """W_j(x) for an arbitrary field element x: product over the 2^j
    subspace elements (used only for coset shifts; grid points go through
    the linear table)."""
    out = 1
    for v_idx in range(1 << j):
        v = 0
        for b in range(j):
            if (v_idx >> b) & 1:
                v ^= basis[b]
        out = int(field.mul(out, x ^ v))
    return out


def stage_twiddles(
    field: GF, basis: tuple[int, ...], r: int, j: int, shift: int
) -> np.ndarray:
    """What_j at every stage-j block base point (+ coset shift).

    Returns (n / 2^{j+1},) GF elements: entry t is
    What_j(omega_{t * 2^{j+1}} + shift), the constant twiddle of block t.
    """
    T = _subspace_table(field, tuple(basis))
    norm_inv = int(field.inv(T[j, j]))
    w_shift = _w_eval(field, tuple(basis), j, shift) if shift else 0
    n_blocks = 1 << (r - j - 1)
    out = np.zeros(n_blocks, dtype=np.uint32)
    for t in range(n_blocks):
        w = w_shift
        for b in range(j + 1, r):  # block base has bits only at j+1..r-1
            if (t >> (b - j - 1)) & 1:
                w ^= int(T[j, b])
        out[t] = int(field.mul(w, norm_inv))
    return out.astype(field.dtype)


def fft(field: GF, basis, a: np.ndarray, shift: int = 0) -> np.ndarray:
    """Evaluate novel-basis coefficients a[0..n) at span(basis[:r]) + shift.

    a: (n, ...) GF symbols, n = 2^r a power of two; returns same shape.
    """
    a = np.array(a, dtype=np.uint32, copy=True)
    n = a.shape[0]
    r = n.bit_length() - 1
    assert 1 << r == n, f"transform size {n} not a power of two"
    basis = tuple(basis)
    for j in range(r - 1, -1, -1):
        d = 1 << j
        tw = stage_twiddles(field, basis, r, j, shift)
        for t in range(n >> (j + 1)):
            base = t << (j + 1)
            u = a[base : base + d]
            v = a[base + d : base + 2 * d]
            w = int(tw[t])
            if w:
                u ^= field.mul(w, v).astype(np.uint32)
            v ^= u
    return a.astype(field.dtype)


def ifft(field: GF, basis, a: np.ndarray, shift: int = 0) -> np.ndarray:
    """Inverse of `fft`: values at span(basis[:r]) + shift -> coefficients."""
    a = np.array(a, dtype=np.uint32, copy=True)
    n = a.shape[0]
    r = n.bit_length() - 1
    assert 1 << r == n, f"transform size {n} not a power of two"
    basis = tuple(basis)
    for j in range(r):
        d = 1 << j
        tw = stage_twiddles(field, basis, r, j, shift)
        for t in range(n >> (j + 1)):
            base = t << (j + 1)
            u = a[base : base + d]
            v = a[base + d : base + 2 * d]
            v ^= u
            w = int(tw[t])
            if w:
                u ^= field.mul(w, v).astype(np.uint32)
    return a.astype(field.dtype)


def encode_params(codec) -> tuple[GF, tuple[int, ...], int, int]:
    """(field, k-point basis, data coset shift, parity coset shift) for an
    RSCodec — the FFT-encode description of its construction."""
    k = codec.k
    K = k.bit_length() - 1
    if codec.construction == "leopard":
        from celestia_app_tpu_torch.gf.leopard import cantor_basis

        basis = cantor_basis(codec.field.m)
        data_shift = basis[K] if k > 1 else basis[0]
        return codec.field, tuple(basis[:K]), data_shift, 0
    if codec.construction == "vandermonde":
        basis = tuple(1 << i for i in range(max(K, 1)))
        return codec.field, basis[:K], 0, k
    raise ValueError(f"no FFT description for construction {codec.construction!r}")


def encode_fft(codec, data_symbols: np.ndarray) -> np.ndarray:
    """Systematic encode via IFFT(data coset) -> FFT(parity coset).

    data_symbols: (k, ...) GF symbols; returns (k, ...) parity symbols,
    identical to codec.field.matmul(codec.generator, data_symbols).
    """
    field, basis, data_shift, parity_shift = encode_params(codec)
    coeffs = ifft(field, basis, data_symbols, data_shift)
    return fft(field, basis, coeffs, parity_shift)
