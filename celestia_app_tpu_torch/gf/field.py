"""GF(2^m) arithmetic over numpy arrays (host-side reference + matrix setup).

The GPU kernels never execute table lookups: every GF operation that reaches
the device is first lowered here to a constant binary matrix (multiplication
by a field constant is GF(2)-linear on the bit vector), so the device work is
a plain 0/1 matmul.  This module provides:

  * exp/log table arithmetic for GF(2^8) (poly 0x11D) and GF(2^16)
    (poly 0x1100B) - used to build generator matrices and as a CPU oracle;
  * vectorized GF matrix multiply / Gaussian inverse (for erasure decode);
  * `mul_bit_matrix`: the m x m GF(2) matrix of "multiply by constant c",
    the building block of the device-side bit-expanded generator.

Parity notes vs the reference stack: rsmt2d's default codec is leopard
(FFT RS); its parity bytes are one fixed linear code among many MDS codes.
We use the classic systematic evaluation-point construction (data = values at
points 0..k-1, parity = values at points k..2k-1 of the unique interpolating
polynomial), which is MDS by the Vandermonde argument and fully determined by
this spec - the determinism contract (SURVEY P1) is what consensus needs.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_PRIM_POLY = {8: 0x11D, 16: 0x1100B}


def _clmul_mod(a: int, b: int, m: int, poly: int) -> int:
    """Carry-less multiply mod poly — table-free bootstrap multiply."""
    prod = 0
    while b:
        if b & 1:
            prod ^= a
        a <<= 1
        b >>= 1
    for bit in range(2 * m - 2, m - 1, -1):
        if prod >> bit & 1:
            prod ^= poly << (bit - m)
    return prod


def _pow_mod(a: int, e: int, m: int, poly: int) -> int:
    out = 1
    while e:
        if e & 1:
            out = _clmul_mod(out, a, m, poly)
        a = _clmul_mod(a, a, m, poly)
        e >>= 1
    return out


def _prime_factors(n: int) -> list[int]:
    out, d = [], 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def _poly_gcd(a: int, b: int) -> int:
    """GCD of GF(2)[x] polynomials (bitmask representation)."""
    while b:
        while a.bit_length() >= b.bit_length() and a:
            a ^= b << (a.bit_length() - b.bit_length())
        a, b = b, a
    return a


def _is_irreducible(poly: int, m: int) -> bool:
    """Degree-m poly irreducible over GF(2): x^(2^m) == x mod poly AND
    gcd(x^(2^(m/p)) + x, poly) == 1 for every prime p | m (the Frobenius
    condition alone also accepts squarefree products of smaller factors)."""
    t = 2
    for _ in range(m):
        t = _clmul_mod(t, t, m, poly)
    if t != 2:
        return False
    for p in _prime_factors(m):
        t = 2
        for _ in range(m // p):
            t = _clmul_mod(t, t, m, poly)
        if _poly_gcd(t ^ 2, poly) != 1:
            return False
    return True


class GF:
    """GF(2^m) with exp/log tables, m in {8, 16}. Elements are numpy uints.

    `poly` defaults to this repo's codec polynomials; pass another
    irreducible polynomial (e.g. leopard ff16's) to get that field. The
    exp/log tables are built on the smallest generator element, so
    non-primitive polynomials whose `x` is not a generator still work.
    """

    def __init__(self, m: int, poly: int | None = None):
        if m not in (8, 16):
            raise ValueError(f"unsupported field GF(2^{m})")
        self.m = m
        self.order = 1 << m
        self.poly = poly if poly is not None else _PRIM_POLY[m]
        self.dtype = np.uint8 if m == 8 else np.uint16
        if not _is_irreducible(self.poly, m):
            raise ValueError(f"0x{self.poly:x} is not irreducible over GF(2)")
        # Smallest generator: order test against the prime factors of 2^m-1.
        n1 = self.order - 1
        factors = _prime_factors(n1)
        for g in range(2, self.order):
            if all(_pow_mod(g, n1 // p, m, self.poly) != 1 for p in factors):
                break
        else:  # unreachable for a field: its unit group is cyclic
            raise ValueError(f"no generator in GF(2^{m})/0x{self.poly:x}")
        # exp table of length 2*(order-1) so exp[log a + log b] needs no mod.
        exp = np.zeros(2 * (self.order - 1), dtype=np.uint32)
        log = np.zeros(self.order, dtype=np.uint32)
        x = 1
        for i in range(n1):
            exp[i] = x
            log[x] = i
            x = _clmul_mod(x, g, m, self.poly)
        exp[n1:] = exp[:n1]
        self.exp = exp
        self.log = log

    # --- scalar/array ops -------------------------------------------------
    def mul(self, a, b):
        """Elementwise GF multiply (broadcasting)."""
        a = np.asarray(a, dtype=np.uint32)
        b = np.asarray(b, dtype=np.uint32)
        # log sums stay below 2*(order-1): the doubled exp table needs no mod
        out = self.exp[self.log[a] + self.log[b]]
        out = np.where((a == 0) | (b == 0), 0, out)
        return out.astype(self.dtype)

    def inv(self, a):
        a = np.asarray(a, dtype=np.uint32)
        if np.any(a == 0):
            raise ZeroDivisionError("GF inverse of 0")
        return self.exp[(self.order - 1 - self.log[a]) % (self.order - 1)].astype(self.dtype)

    def pow(self, a: int, e: int):
        if a == 0:
            return self.dtype(0 if e else 1)
        return self.dtype(self.exp[(int(self.log[a]) * e) % (self.order - 1)])

    def matmul(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        """GF matrix multiply: (n,k) x (k,p) -> (n,p).

        Vectorized over the contraction via table lookups + XOR-reduce.
        """
        A = np.asarray(A, dtype=np.uint32)
        B = np.asarray(B, dtype=np.uint32)
        n, k = A.shape
        k2, p = B.shape
        assert k == k2, (A.shape, B.shape)
        out = np.zeros((n, p), dtype=np.uint32)
        logB = self.log[B]  # (k, p)
        for i in range(k):  # XOR-accumulate one rank-1 GF outer product at a time
            col = A[:, i]  # (n,)
            prod = self.exp[self.log[col][:, None] + logB[i][None, :]]
            prod = np.where((col[:, None] == 0) | (B[i][None, :] == 0), 0, prod)
            out ^= prod
        return out.astype(self.dtype)

    def inv_matrix(self, A: np.ndarray) -> np.ndarray:
        """Gaussian elimination inverse over GF(2^m)."""
        A = np.array(A, dtype=np.uint32)
        n = A.shape[0]
        assert A.shape == (n, n)
        aug = np.concatenate([A, np.eye(n, dtype=np.uint32)], axis=1)
        for col in range(n):
            piv = col + int(np.argmax(aug[col:, col] != 0))
            if aug[piv, col] == 0:
                raise np.linalg.LinAlgError("singular GF matrix")
            if piv != col:
                aug[[col, piv]] = aug[[piv, col]]
            aug[col] = self.mul(aug[col], self.inv(aug[col, col])).astype(np.uint32)
            mask = aug[:, col] != 0
            mask[col] = False
            rows = np.where(mask)[0]
            if rows.size:
                factors = aug[rows, col]
                aug[rows] ^= self.mul(factors[:, None], aug[col][None, :]).astype(np.uint32)
        return aug[:, n:].astype(self.dtype)

    def vandermonde(self, points: np.ndarray, k: int) -> np.ndarray:
        """V[i, j] = points[i]^j, shape (len(points), k)."""
        points = np.asarray(points, dtype=np.uint32)
        V = np.ones((len(points), k), dtype=np.uint32)
        for j in range(1, k):
            V[:, j] = self.mul(V[:, j - 1], points)
        return V.astype(self.dtype)

    # --- bit-expansion (device lowering) ---------------------------------
    def mul_bit_matrix(self, c: int) -> np.ndarray:
        """The m x m GF(2) matrix M_c with bits(c*x) = M_c @ bits(x) mod 2.

        Bit b of a symbol is (x >> b) & 1; column b of M_c is bits(c * 2^b).
        """
        m = self.m
        M = np.zeros((m, m), dtype=np.uint8)
        for b in range(m):
            prod = int(self.mul(c, 1 << b))
            for r in range(m):
                M[r, b] = (prod >> r) & 1
        return M

    def expand_bit_matrix(self, A: np.ndarray) -> np.ndarray:
        """Bit-expand a GF matrix (n,k) -> binary matrix (n*m, k*m).

        (G_bits @ data_bits) mod 2 == bits(G gfmatmul data): the whole GF
        matmul becomes one 0/1 matmul, which is what the RS kernels run.
        Block (i, j) is mul_bit_matrix(A[i, j]): its column b is the bits
        of A[i, j] * 2^b, computed here for all (i, j) at once per b.
        """
        A = np.asarray(A, dtype=np.uint32)
        n, k = A.shape
        m = self.m
        out = np.empty((n, m, k, m), dtype=np.uint8)
        for b in range(m):
            prod = self.mul(A, 1 << b).astype(np.uint32)  # (n, k)
            for r in range(m):
                out[:, r, :, b] = (prod >> r) & 1
        return out.reshape(n * m, k * m)


@lru_cache(maxsize=None)
def _field(m: int, poly: int | None = None) -> GF:
    return GF(m, poly)


GF8 = _field(8)
GF16 = _field(16)
