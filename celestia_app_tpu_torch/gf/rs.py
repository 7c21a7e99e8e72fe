"""Systematic Reed-Solomon over GF(2^8)/GF(2^16): the rsmt2d codec seam.

Mirrors the capability surface of `rsmt2d.Codec` (reference
pkg/appconsts/global_consts.go:92 selects rsmt2d.NewLeoRSCodec): encode k data
shares to k parity shares, and decode the full codeword from any k of the 2k
shares.  Field selection follows leopard's rule: codewords of <= 256 symbols
use GF(2^8) (square size k <= 128), wider codewords use GF(2^16)
(k in {256, 512}).

Construction (fully specified, deterministic - consensus-critical):
  * evaluation points are the field elements 0, 1, ..., 2k-1;
  * data share i holds the codeword values at point i, parity share p the
    values at point k+p, of the unique degree-<k interpolating polynomial;
  * parity generator  G = V[k:2k] @ inv(V[0:k])  (k x k over GF);
  * GF(2^16) symbols are little-endian byte pairs within a share.

G is computed as the additive-FFT encode of the identity (gf/fft.encode_fft,
O(k^2 log k)), the same matrix the JAX package solves for by Gaussian
elimination (O(k^3): minutes at k=2048); tests/test_torch_gf.py holds the
two equal.

Everything here is host-side numpy: the encode oracle for tests, and the
constant matrices that the RS kernels (kernels/rs.py) consume bit-expanded.
MDS: any k x k minor of the 2k x k Vandermonde at distinct points is
invertible, so any k surviving shares determine the codeword.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

from celestia_app_tpu_torch.gf.fft import encode_fft
from celestia_app_tpu_torch.gf.field import GF, _field


def field_for_width(codeword_width: int) -> GF:
    """Field used for a codeword of `codeword_width` total shares (2k)."""
    if codeword_width <= 256:
        return _field(8)
    if codeword_width <= 65536:
        return _field(16)
    raise ValueError(f"codeword too wide: {codeword_width}")


class RSCodec:
    """Systematic RS codec for a fixed number of data shares k.

    `construction` selects the evaluation-point layout (and field poly):
      * "vandermonde" — this repo's fully-specified default: data at points
        0..k-1, parity at k..2k-1, repo field polynomials;
      * "leopard" — the reference-parity attempt (gf/leopard.py): the
        additive-FFT omega grid with data on its high half, leopard field
        polynomials. Same MDS/systematic surface, different parity bytes.
    Both constructions share every code path below — only `points` and
    `field` differ, and the device kernel consumes the resulting generator
    as data.
    """

    def __init__(self, k: int, construction: str = "vandermonde"):
        if k < 1 or k & (k - 1):
            raise ValueError(f"k must be a power of two, got {k}")
        self.k = k
        self.construction = construction
        if construction == "leopard":
            from celestia_app_tpu_torch.gf.leopard import leopard_field, leopard_points

            self.field = leopard_field(8 if 2 * k <= 256 else 16)
            points = leopard_points(k, self.field)
        elif construction == "vandermonde":
            self.field = field_for_width(2 * k)
            points = np.arange(2 * k, dtype=np.uint32).astype(self.field.dtype)
        else:
            raise ValueError(f"unknown RS construction {construction!r}")
        f = self.field
        self._v_all = f.vandermonde(points, k)  # (2k, k), for recover_matrix
        # G = V[k:] @ inv(V[:k]): the parity of each unit data vector.
        self.generator = encode_fft(self, np.eye(k, dtype=f.dtype))  # (k, k)
        self._generator_bits: np.ndarray | None = None

    # --- symbol <-> byte packing -----------------------------------------
    def to_symbols(self, shares: np.ndarray) -> np.ndarray:
        """(n, share_size) uint8 -> (n, share_size/bytes_per_symbol) field dtype."""
        shares = np.asarray(shares, dtype=np.uint8)
        if self.field.m == 8:
            return shares
        assert shares.shape[-1] % 2 == 0
        return shares.view("<u2")

    def from_symbols(self, symbols: np.ndarray) -> np.ndarray:
        if self.field.m == 8:
            return np.asarray(symbols, dtype=np.uint8)
        return np.asarray(symbols, dtype="<u2").view(np.uint8)

    # --- codec surface (rsmt2d.Codec parity) ------------------------------
    def encode(self, data_shares: np.ndarray) -> np.ndarray:
        """(k, share_size) uint8 data -> (k, share_size) uint8 parity."""
        data = np.asarray(data_shares, dtype=np.uint8)
        assert data.shape[0] == self.k, data.shape
        sym = self.to_symbols(data)
        parity = self.field.matmul(self.generator, sym)
        return self.from_symbols(parity)

    def extend(self, data_shares: np.ndarray) -> np.ndarray:
        """(k, s) -> (2k, s): data followed by parity (systematic layout)."""
        data = np.asarray(data_shares, dtype=np.uint8)
        return np.concatenate([data, self.encode(data)], axis=0)

    def recover_matrix(self, known_positions: np.ndarray) -> np.ndarray:
        """(2k, k) GF matrix R with full_codeword = R @ codeword[known[:k]].

        `known_positions` must list >= k distinct positions in [0, 2k); the
        first k are used.  This is the erasure-decode as a constant matmul -
        the same shape a device repair consumes.
        """
        pos = np.asarray(known_positions, dtype=np.int64)[: self.k]
        if len(pos) < self.k:
            raise ValueError(f"need >= {self.k} shares to decode, got {len(pos)}")
        f = self.field
        V_known = self._v_all[pos]  # (k, k)
        return f.matmul(self._v_all, f.inv_matrix(V_known))  # (2k, k)

    def decode(self, shares: np.ndarray, present: np.ndarray) -> np.ndarray:
        """Reconstruct all 2k shares.

        shares: (2k, share_size) uint8 with arbitrary content at missing rows;
        present: (2k,) bool mask of available shares.
        Mirrors rsmt2d.ExtendedDataSquare.Repair's per-axis decode.
        """
        shares = np.asarray(shares, dtype=np.uint8)
        present = np.asarray(present, dtype=bool)
        known = np.where(present)[0]
        R = self.recover_matrix(known)
        sym = self.to_symbols(shares[known[: self.k]])
        return self.from_symbols(self.field.matmul(R, sym))

    # --- device lowering --------------------------------------------------
    def generator_bits(self) -> np.ndarray:
        """Bit-expanded generator: (k*m, k*m) uint8 in {0,1}, built once per
        codec (1.07 GB at k=2048) and handed out read-only."""
        if self._generator_bits is None:
            bits = self.field.expand_bit_matrix(self.generator)
            bits.setflags(write=False)
            self._generator_bits = bits
        return self._generator_bits

    def extend_bits(self) -> np.ndarray:
        """Bit-expanded [I; G]: (2k*m, k*m) - one matmul yields the full
        extended column, handy for the fused column phase."""
        full = np.concatenate(
            [np.eye(self.k, dtype=self.field.dtype), self.generator], axis=0
        )
        return self.field.expand_bit_matrix(full)


@lru_cache(maxsize=None)
def _codec_cached(k: int, construction: str) -> RSCodec:
    return RSCodec(k, construction)


def active_construction() -> str:
    """The process-wide RS construction selected by $CELESTIA_RS_CONSTRUCTION.

    Every cached device program that bakes a generator in (da/eds.py,
    da/repair.py, kernels/rs.py, parallel/sharded_*.py) keys its cache on
    this value, so flipping the env var mid-process selects a different
    cache entry instead of silently serving stale compiles (the round-3
    nondeterministic RootMismatch hazard)."""
    return os.environ.get("CELESTIA_RS_CONSTRUCTION", "vandermonde")


def codec_for_width(k: int, construction: str | None = None) -> RSCodec:
    """Cached codec for square size k (codewords are 2k wide).

    `construction` defaults to $CELESTIA_RS_CONSTRUCTION (or "vandermonde").
    """
    if construction is None:
        construction = active_construction()
    return _codec_cached(k, construction)
