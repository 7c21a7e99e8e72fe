"""The yardstick's peaks and the work of a square, counted from its shapes.

Work is the same whatever implements it: each input byte read once, each
output byte written once, and the operations the algorithm needs.

  * RS encode: a line of k shares holds 4096 / m symbol columns, each a
    (k m) x (k m) product of bits: k^2 m 4096 bit-products a line.  An
    extension encodes 3k lines (the k rows, then the 2k columns), so
    3 k^3 m 4096; a quadrant's decode sweep of k lines adds k^3 m 4096.
    They run on the chip's fastest bit-product pipe: 8 x the published
    int8 rate, the 8:1 binary-to-int8 ratio NVIDIA publishes for the A100
    (the H100's binary wgmma was measured at 99.3 % of it).  An O(k log k)
    encoder would need a new count.
  * NMT: 4k^2 leaves of 9 SHA-256 compressions each (a leaf is hashed once
    for its row and its column) and 4k (2k - 1) inner nodes of 3, each
    compression SHA_OPS_PER_COMPRESSION 32-bit integer operations.

Peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
"""

from __future__ import annotations

SHARE_SIZE = 512
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
# int32 pipes: the data sheet's 67 TFLOP/s float32 counts two operations
# per FMA on 128 lanes per SM; the int32 pipe has 64 lanes per SM and one
# operation per lane and clock, a quarter of that.
INT32_OPS_PER_S = 67e12 / 4
BIT_PRODUCTS_PER_S = 8 * INT8_OPS_PER_S / 2  # 8 binary MACs per int8 MAC
# Least 32-bit integer operations of one SHA-256 compression with 3-input
# logic (LOP3) and adds (IADD3) and one funnel shift per rotation: 64 rounds
# x 14, 48 schedule words x 10, 8 final adds.
SHA_OPS_PER_COMPRESSION = 64 * 14 + 48 * 10 + 8
LEAF_COMPRESSIONS = 9  # 0x00 || 29-byte namespace || 512-byte share: 542 bytes
NODE_COMPRESSIONS = 3  # 0x01 || 90 || 90: 181 bytes


def bound_s(bytes_moved: float, ops: float, rate: float) -> float:
    """The least seconds: the larger of the bytes' and the operations' time."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / rate)


def rs_bit_products(k: int, m: int, extensions: int = 1, decodes: int = 0) -> float:
    return (3 * extensions + decodes) * k ** 3 * m * 4096


def rs_least_s(k: int, m: int, extensions: int = 1, decodes: int = 0) -> float:
    """RS work of `extensions` extensions (ODS in, 3 parity quadrants out)
    and `decodes` quadrant decode sweeps (k^2 shares in, k^2 out)."""
    square = k * k * SHARE_SIZE
    moved = extensions * 4 * square + decodes * 2 * square
    return bound_s(moved, rs_bit_products(k, m, extensions, decodes), BIT_PRODUCTS_PER_S)


def nmt_compressions(k: int) -> int:
    return 4 * k * k * LEAF_COMPRESSIONS + 4 * k * (2 * k - 1) * NODE_COMPRESSIONS


def nmt_least_s(k: int, squares: int = 1) -> float:
    """NMT work of the 4k trees of `squares` EDSs: the EDS read once and
    the roots written once.  The data root's 8k - 1 small hashes are left
    out (under 0.1 % of the trees')."""
    moved = squares * (4 * k * k * SHARE_SIZE + 4 * k * 90)
    ops = squares * nmt_compressions(k) * SHA_OPS_PER_COMPRESSION
    return bound_s(moved, ops, INT32_OPS_PER_S)
