"""RIPEMD-160 in plain Python (Dobbertin, Bosselaers, Preneel 1996).

Account addresses hash a public key with RIPEMD-160.  `hashlib.new(
"ripemd160")` exists only where OpenSSL was built with its legacy provider,
which OpenSSL 3 leaves out by default, so the port keeps its own.  The
address path hashes 32-byte SHA-256 digests, one 64-byte block each.
"""

from __future__ import annotations

import struct

_MASK = 0xFFFFFFFF

# Message word order of the left and right lines, round by round.
_R_LEFT = (
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
    3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
    1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
    4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13,
)
_R_RIGHT = (
    5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
    6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
    15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
    8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
    12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11,
)
# Left rotations.
_S_LEFT = (
    11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
    7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
    11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
    11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
    9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6,
)
_S_RIGHT = (
    8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
    9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
    9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
    15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
    8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11,
)
_K_LEFT = (0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E)
_K_RIGHT = (0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000)


def _f(j: int, x: int, y: int, z: int) -> int:
    """The round function of round j (0..4); the right line runs them in
    the reverse order."""
    if j == 0:
        return x ^ y ^ z
    if j == 1:
        return (x & y) | (~x & z)
    if j == 2:
        return (x | ~y) ^ z
    if j == 3:
        return (x & z) | (y & ~z)
    return x ^ (y | ~z)


def _rol(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _MASK


def _compress(h: list[int], block: bytes) -> None:
    x = struct.unpack("<16I", block)
    al, bl, cl, dl, el = h
    ar, br, cr, dr, er = h
    for i in range(80):
        j = i >> 4
        t = (al + _f(j, bl, cl, dl) + x[_R_LEFT[i]] + _K_LEFT[j]) & _MASK
        t = (_rol(t, _S_LEFT[i]) + el) & _MASK
        al, bl, cl, dl, el = el, t, bl, _rol(cl, 10), dl
        t = (ar + _f(4 - j, br, cr, dr) + x[_R_RIGHT[i]] + _K_RIGHT[j]) & _MASK
        t = (_rol(t, _S_RIGHT[i]) + er) & _MASK
        ar, br, cr, dr, er = er, t, br, _rol(cr, 10), dr
    t = (h[1] + cl + dr) & _MASK
    h[1] = (h[2] + dl + er) & _MASK
    h[2] = (h[3] + el + ar) & _MASK
    h[3] = (h[4] + al + br) & _MASK
    h[4] = (h[0] + bl + cr) & _MASK
    h[0] = t


def ripemd160(data: bytes) -> bytes:
    """The 20-byte RIPEMD-160 digest of `data`."""
    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    padded = bytes(data) + b"\x80" + b"\x00" * ((55 - len(data)) % 64)
    padded += struct.pack("<Q", (8 * len(data)) & 0xFFFFFFFFFFFFFFFF)
    for off in range(0, len(padded), 64):
        _compress(h, padded[off:off + 64])
    return struct.pack("<5I", *h)
