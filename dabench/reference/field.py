"""GF(2^m) for the reference codec: a frozen copy of the constants, and the
parity generator derived from them by Lagrange interpolation.

Nothing here imports the program.  The two constructions the program
offers are fixed by these numbers alone:

  * "leopard" (rsmt2d.NewLeoRSCodec, klauspost/reedsolomon leopard8 and
    leopard16): GF(2^8) mod 0x11D for codewords of at most 256 shares,
    GF(2^16) mod 0x1002D above that.  The evaluation grid is
    omega[i] = XOR of CANTOR_BASIS[m][j] over the set bits j of i; data
    share i sits at omega[k + i], parity share p at omega[p].
  * "vandermonde": GF(2^8) mod 0x11D or GF(2^16) mod 0x1100B; data share
    i at the point i, parity share p at the point k + p.

Either way parity p is the value at its point of the polynomial of degree
below k through the data, so G[p, i] = prod_{j != i} (x_p + x_j) /
(x_i + x_j) over the data points x_j (addition is XOR).  In logs that is
A[p] - log(x_p + x_i) - B[i] with A[p] = sum_j log(x_p + x_j) and B[i] =
sum_{j != i} log(x_i + x_j), an O(k^2) formula that shares nothing with
the program's Gaussian or FFT derivation.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

LEOPARD_POLY = {8: 0x11D, 16: 0x1002D}
VANDERMONDE_POLY = {8: 0x11D, 16: 0x1100B}

# The Cantor bases of the leopard fields: b_0 = 1 and b_{j+1} the smallest
# x with x^2 + x = b_j.  Frozen here; tests derive them again.
CANTOR_BASIS = {
    8: (0x1, 0xD6, 0x98, 0x92, 0x56, 0xC8, 0x58, 0xE6),
    16: (0x1, 0xACCA, 0x3C0E, 0x163E, 0xC582, 0xED2E, 0x914C, 0x4012,
         0x6C98, 0x10D8, 0x6A72, 0xB900, 0xFDB8, 0xFB34, 0xFF38, 0x991E),
}


def field_bits(k: int) -> int:
    """Symbol width of a codeword of 2k shares: 8 up to 256 shares, else 16."""
    return 8 if 2 * k <= 256 else 16


def clmul_mod(a: int, b: int, m: int, poly: int) -> int:
    """a * b in GF(2^m) mod `poly`, by shift and add."""
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


class Field:
    """Log and antilog tables of GF(2^m) mod `poly` over its smallest
    primitive element."""

    def __init__(self, m: int, poly: int):
        self.m, self.poly = m, poly
        self.order = (1 << m) - 1
        g = next(x for x in range(2, 1 << m) if self._is_primitive(x))
        exp = np.zeros(2 * self.order, dtype=np.int64)
        x = 1
        for i in range(self.order):
            exp[i] = x
            x = clmul_mod(x, g, m, poly)
        exp[self.order:] = exp[: self.order]
        log = np.zeros(1 << m, dtype=np.int64)
        log[exp[: self.order]] = np.arange(self.order)
        self.exp, self.log = exp, log

    def _is_primitive(self, x: int) -> bool:
        n, m, poly = self.order, self.m, self.poly
        factors = [p for p in (3, 5, 17, 257, 65537) if n % p == 0]

        def power(a: int, e: int) -> int:
            out = 1
            while e:
                if e & 1:
                    out = clmul_mod(out, a, m, poly)
                a = clmul_mod(a, a, m, poly)
                e >>= 1
            return out

        return power(x, n) == 1 and all(power(x, n // p) != 1 for p in factors)

    def mul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        a, b = np.asarray(a, dtype=np.int64), np.asarray(b, dtype=np.int64)
        out = self.exp[(self.log[a] + self.log[b]) % self.order]
        return np.where((a == 0) | (b == 0), 0, out)


@lru_cache(maxsize=None)
def field(m: int, poly: int) -> Field:
    return Field(m, poly)


def points(k: int, construction: str) -> tuple[Field, np.ndarray, np.ndarray]:
    """(field, data points (k,), parity points (k,)) of a construction."""
    m = field_bits(k)
    if construction == "leopard":
        f = field(m, LEOPARD_POLY[m])
        idx = np.arange(2 * k)
        omega = np.zeros(2 * k, dtype=np.int64)
        for j, b in enumerate(CANTOR_BASIS[m]):
            omega ^= np.where((idx >> j) & 1, b, 0)
        return f, omega[k:], omega[:k]
    if construction == "vandermonde":
        f = field(m, VANDERMONDE_POLY[m])
        return f, np.arange(k, dtype=np.int64), np.arange(k, 2 * k, dtype=np.int64)
    raise ValueError(f"unknown construction {construction!r}")


def interpolation(f: Field, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """M (len(dst), len(src)) over `f`: the values at `dst` of the polynomial
    of degree below len(src) through values at `src`, as M @ values."""
    lg = f.log
    cross = lg[dst[:, None] ^ src[None, :]]  # never log 0: the sets are disjoint
    a = cross.sum(axis=1)
    inner = lg[np.where(np.eye(len(src), dtype=bool), 1, src[:, None] ^ src[None, :])]
    b = inner.sum(axis=1)  # the diagonal adds log 1 = 0
    return f.exp[(a[:, None] - cross - b[None, :]) % f.order]


def generator(k: int, construction: str, recover: bool = False) -> tuple[Field, np.ndarray]:
    """(field, G (k, k)) with parity = G @ data over the field; with
    `recover`, data = G @ parity (the same interpolation the other way)."""
    f, data, parity = points(k, construction)
    return f, interpolation(f, parity, data) if recover else interpolation(f, data, parity)


def generator_bits(k: int, construction: str, recover: bool = False) -> np.ndarray:
    """G over GF(2): (k*m, k*m) uint8 with row (p, r) and column (i, t) the
    bit r of G[p, i] * x^t, so that output bit r of symbol p is the XOR of
    bit t of input symbol i over the ones of its row."""
    f, g = generator(k, construction, recover)
    m = f.m
    units = 1 << np.arange(m)
    prod = f.mul(g[:, :, None], units[None, None, :])  # (k, k, m): G[p, i] * x^t
    bits = (prod[:, :, :, None] >> np.arange(m)) & 1  # (p, i, t, r)
    return np.ascontiguousarray(bits.transpose(0, 3, 1, 2).reshape(k * m, k * m)).astype(np.uint8)
