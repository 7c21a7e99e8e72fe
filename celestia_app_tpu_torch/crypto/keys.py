"""Account keys: secp256k1 (cosmos account scheme) with compact signatures.

The port's counterpart of celestia_app_tpu/crypto/keys.py, with the same
API and the same bytes: 33-byte compressed pubkeys, 64-byte r||s
signatures over sha256(msg) with RFC 6979 nonces and low-S normalization,
addresses = ripemd160(sha256(pubkey)) in bech32 ("celestia" HRP).

The JAX package signs and verifies through the `cryptography` package,
which the port does not use: the curve arithmetic is here, in Python
integers.  Points are kept in Jacobian coordinates (X, Y, Z) ~ (X/Z^2,
Y/Z^3), so a whole scalar multiplication needs no field inversion.
`u1·G + u2·Q` runs as one interleaved width-w NAF ladder (Shamir's trick)
over a table of odd multiples of G built once per process and a table of
odd multiples of Q built per call.  The curve's endomorphism
(x, y) -> (β·x, y) = λ·(x, y) splits each 256-bit scalar into two of 128
bits (GLV), so the ladder runs 128 doublings for the four terms, and the
endomorphism's tables cost one multiplication per entry.  The final
x-coordinate test is made projectively (X == r·Z^2), so a verify costs
one inversion modulo the group order and one field inversion for the Q
table.  Signing takes the same ladder with u2 = 0.
"""

from __future__ import annotations

import hashlib
import hmac
import secrets
import threading

from celestia_app_tpu_torch.crypto import bech32
from celestia_app_tpu_torch.crypto.ripemd160 import ripemd160

ACCOUNT_HRP = "celestia"

# The curve y^2 = x^3 + 7 over F_p, its group order and generator (SEC 2).
_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
_ORDER = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

# The endomorphism: λ·(x, y) = (β·x, y), and the short basis of the
# lattice {(a, b): a + b·λ = 0 (mod n)} that splits a scalar (GLV).
_LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
_BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
_A1 = 0x3086D221A7D46BCDE86C90E49284EB15
_B1 = -0xE4437ED6010E88286F547FA90ABFE4C3
_A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
_B2 = _A1

# NAF widths: 2^(w-2) odd multiples in each table.
_G_WIDTH = 8
_Q_WIDTH = 5

# A Jacobian point is a tuple (X, Y, Z); Z == 0 is the point at infinity.
_INFINITY = (1, 1, 0)


def _sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def _double(pt):
    """2·pt (dbl-2009-l for a = 0)."""
    x, y, z = pt
    if z == 0 or y == 0:
        return _INFINITY
    a = x * x % _P
    b = y * y % _P
    c = b * b % _P
    d = 2 * ((x + b) * (x + b) - a - c) % _P
    e = 3 * a % _P
    x3 = (e * e - 2 * d) % _P
    return x3, (e * (d - x3) - 8 * c) % _P, 2 * y * z % _P


def _add_affine(pt, qx: int, qy: int):
    """pt + (qx, qy) for an affine (qx, qy) (madd-2007-bl)."""
    x1, y1, z1 = pt
    if z1 == 0:
        return qx, qy, 1
    z1z1 = z1 * z1 % _P
    h = (qx * z1z1 - x1) % _P
    r = 2 * (qy * z1 * z1z1 - y1) % _P
    if h == 0:
        return _double(pt) if r == 0 else _INFINITY
    hh = h * h % _P
    i = 4 * hh % _P
    j = h * i % _P
    v = x1 * i % _P
    x3 = (r * r - j - 2 * v) % _P
    return x3, (r * (v - x3) - 2 * y1 * j) % _P, ((z1 + h) * (z1 + h) - z1z1 - hh) % _P


def _add(p1, p2):
    """p1 + p2, both Jacobian (add-2007-bl)."""
    if p1[2] == 0:
        return p2
    if p2[2] == 0:
        return p1
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1z1 = z1 * z1 % _P
    z2z2 = z2 * z2 % _P
    u1 = x1 * z2z2 % _P
    u2 = x2 * z1z1 % _P
    s1 = y1 * z2 * z2z2 % _P
    s2 = y2 * z1 * z1z1 % _P
    h = (u2 - u1) % _P
    r = 2 * (s2 - s1) % _P
    if h == 0:
        return _double(p1) if r == 0 else _INFINITY
    i = 4 * h * h % _P
    j = h * i % _P
    v = u1 * i % _P
    x3 = (r * r - j - 2 * v) % _P
    y3 = (r * (v - x3) - 2 * s1 * j) % _P
    return x3, y3, ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) * h % _P


def _to_affine_all(points) -> list[tuple[int, int]]:
    """Affine coordinates of finite Jacobian points, with one inversion
    (Montgomery's simultaneous inversion)."""
    prefix = [1]
    for _, _, z in points:
        prefix.append(prefix[-1] * z % _P)
    inv = pow(prefix[-1], -1, _P)
    out = [None] * len(points)
    for i in range(len(points) - 1, -1, -1):
        x, y, z = points[i]
        zinv = inv * prefix[i] % _P
        inv = inv * z % _P
        zz = zinv * zinv % _P
        out[i] = (x * zz % _P, y * zz * zinv % _P)
    return out


def _odd_multiples(x: int, y: int, width: int) -> list[tuple[int, int]]:
    """[1, 3, 5, ..., 2^(width-1) - 1]·(x, y), affine."""
    twice = _double((x, y, 1))
    pts = [(x, y, 1)]
    for _ in range((1 << (width - 2)) - 1):
        pts.append(_add(pts[-1], twice))
    return _to_affine_all(pts)


def _wnaf(k: int, width: int) -> list[int]:
    """Width-w NAF digits of k, least significant first: each nonzero
    digit odd and below 2^(w-1) in magnitude, and any two nonzero digits
    at least w positions apart."""
    digits = []
    half, full = 1 << (width - 1), 1 << width
    while k:
        if k & 1:
            d = k & (full - 1)
            if d >= half:
                d -= full
            k -= d
        else:
            d = 0
        digits.append(d)
        k >>= 1
    return digits


def _split(k: int) -> tuple[int, int]:
    """(k1, k2) with k = k1 + k2·λ (mod n) and |k1|, |k2| < 2^129."""
    c1 = (_B2 * k + _ORDER // 2) // _ORDER
    c2 = (-_B1 * k + _ORDER // 2) // _ORDER
    return k - c1 * _A1 - c2 * _A2, -c1 * _B1 - c2 * _B2


def _endo(table: list[tuple[int, int]]) -> list[tuple[int, int]]:
    return [(_BETA * x % _P, y) for x, y in table]


_G_TABLES: tuple[list, list] | None = None
_G_TABLES_LOCK = threading.Lock()


def _g_tables() -> tuple[list, list]:
    """Odd multiples of G and of λ·G, built once per process."""
    global _G_TABLES
    if _G_TABLES is None:
        with _G_TABLES_LOCK:
            if _G_TABLES is None:
                table = _odd_multiples(_GX, _GY, _G_WIDTH)
                _G_TABLES = (table, _endo(table))
    return _G_TABLES


def _mul_add(u1: int, u2: int = 0, q: tuple[int, int] | None = None):
    """u1·G + u2·Q (Jacobian): one doubling per bit of the 128-bit halves,
    shared by every term."""
    g_table, g_endo = _g_tables()
    k1, k2 = _split(u1)
    terms = [(k1, g_table), (k2, g_endo)]
    if u2:
        q_table = _odd_multiples(q[0], q[1], _Q_WIDTH)
        k3, k4 = _split(u2)
        terms += [(k3, q_table), (k4, _endo(q_table))]
    ladders = []
    for scalar, table in terms:
        width = _G_WIDTH if table is g_table or table is g_endo else _Q_WIDTH
        digits = _wnaf(abs(scalar), width)
        if scalar < 0:
            digits = [-d for d in digits]
        ladders.append((digits, table))
    acc = _INFINITY
    for i in range(max(len(d) for d, _ in ladders) - 1, -1, -1):
        acc = _double(acc)
        for digits, table in ladders:
            d = digits[i] if i < len(digits) else 0
            if d:
                px, py = table[abs(d) >> 1]
                acc = _add_affine(acc, px, py if d > 0 else _P - py)
    return acc


def _affine(pt) -> tuple[int, int]:
    x, y, z = pt
    zinv = pow(z, -1, _P)
    zz = zinv * zinv % _P
    return x * zz % _P, y * zz * zinv % _P


def _compress(x: int, y: int) -> bytes:
    return bytes([2 | (y & 1)]) + x.to_bytes(32, "big")


def _decompress(data: bytes) -> tuple[int, int]:
    """The curve point of a 33-byte compressed encoding; ValueError if the
    prefix is not 02/03 or x is not the abscissa of a curve point."""
    if len(data) != 33 or data[0] not in (2, 3):
        raise ValueError("not a compressed secp256k1 point")
    x = int.from_bytes(data[1:], "big")
    if x >= _P:
        raise ValueError("x coordinate out of range")
    rhs = (x * x * x + 7) % _P
    y = pow(rhs, (_P + 1) // 4, _P)  # p = 3 (mod 4)
    if y * y % _P != rhs:
        raise ValueError("x is not on the curve")
    if y & 1 != data[0] & 1:
        y = _P - y
    return x, y


def _rfc6979_nonces(d: int, h1: bytes):
    """The RFC 6979 §3.2 nonce sequence for key d and digest h1 (HMAC-SHA256,
    qlen = hlen = 256)."""
    x = d.to_bytes(32, "big")
    h = (int.from_bytes(h1, "big") % _ORDER).to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        candidate = int.from_bytes(v, "big")
        if 1 <= candidate < _ORDER:
            yield candidate
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


class PrivateKey:
    """A secp256k1 signing key: the scalar d, 1 <= d < n."""

    def __init__(self, d: int):
        if not 1 <= d < _ORDER:
            raise ValueError("private scalar out of range")
        self._d = d
        self._pub: PublicKey | None = None

    @classmethod
    def generate(cls) -> "PrivateKey":
        return cls(secrets.randbelow(_ORDER - 1) + 1)

    @classmethod
    def from_seed(cls, seed: bytes) -> "PrivateKey":
        """Deterministic key from a seed (testing/txsim reproducibility); the
        JAX package's derivation, so a seed names the same account there."""
        d = int.from_bytes(_sha256(b"celestia_app_tpu-key" + seed), "big") % (_ORDER - 1) + 1
        return cls(d)

    def public_key(self) -> "PublicKey":
        if self._pub is None:
            self._pub = PublicKey(_compress(*_affine(_mul_add(self._d))))
        return self._pub

    def sign(self, msg: bytes) -> bytes:
        """64-byte r||s signature over sha256(msg), low-S normalized.

        Deterministic (RFC 6979) like the reference's cosmos-sdk/btcec
        signer: identical (key, msg) always yields identical bytes."""
        h1 = _sha256(msg)
        e = int.from_bytes(h1, "big")
        for k in _rfc6979_nonces(self._d, h1):
            r = _affine(_mul_add(k))[0] % _ORDER
            if r == 0:
                continue
            s = pow(k, -1, _ORDER) * (e + r * self._d) % _ORDER
            if s == 0:
                continue
            if s > _ORDER // 2:
                s = _ORDER - s
            return r.to_bytes(32, "big") + s.to_bytes(32, "big")


class PublicKey:
    """A 33-byte compressed secp256k1 public key."""

    def __init__(self, compressed: bytes):
        if len(compressed) != 33:
            raise ValueError(f"compressed pubkey must be 33 bytes, got {len(compressed)}")
        self.bytes = compressed
        self._point: tuple[int, int] | None = None

    def verify(self, msg: bytes, sig: bytes) -> bool:
        """ECDSA verification of a 64-byte low-S r||s over sha256(msg).
        False, never an exception, for any malformed signature or key."""
        if len(sig) != 64:
            return False
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if not 0 < r < _ORDER or not 0 < s <= _ORDER // 2:
            return False
        if self._point is None:
            try:
                self._point = _decompress(self.bytes)
            except ValueError:
                return False
        e = int.from_bytes(_sha256(msg), "big")
        w = pow(s, -1, _ORDER)
        x, _, z = _mul_add(e * w % _ORDER, r * w % _ORDER, self._point)
        if z == 0:
            return False
        # x(R) mod n == r, tested without an inversion: X == c·Z^2 for the
        # field elements c < p with c = r (mod n).
        zz = z * z % _P
        c = r
        while c < _P:
            if x == c * zz % _P:
                return True
            c += _ORDER
        return False

    def address_bytes(self) -> bytes:
        return ripemd160(_sha256(self.bytes))

    def address(self) -> str:
        return bech32.encode(ACCOUNT_HRP, self.address_bytes())


def validate_address(addr: str) -> bytes:
    """Decode a bech32 account address; raises ValueError if invalid."""
    hrp, payload = bech32.decode(addr)
    if hrp != ACCOUNT_HRP:
        raise ValueError(f"wrong address prefix {hrp!r}")
    if len(payload) != 20:
        raise ValueError(f"address payload must be 20 bytes, got {len(payload)}")
    return payload
