"""Bech32 address encoding (BIP-173), as used for cosmos-style addresses.

Reference account addresses are bech32("celestia", ripemd160(sha256(pk)))
(cosmos-sdk types; surfaced all over x/blob e.g. MsgPayForBlobs.signer).
"""

from __future__ import annotations

_CHARSET = "qpzry9x8gf2tvdw0s3jn54khce6mua7l"
_GEN = (0x3B6A57B2, 0x26508E6D, 0x1EA119FA, 0x3D4233DD, 0x2A1462B3)


def _polymod(values: list[int]) -> int:
    chk = 1
    for v in values:
        b = chk >> 25
        chk = (chk & 0x1FFFFFF) << 5 ^ v
        for i in range(5):
            chk ^= _GEN[i] if (b >> i) & 1 else 0
    return chk


def _hrp_expand(hrp: str) -> list[int]:
    return [ord(c) >> 5 for c in hrp] + [0] + [ord(c) & 31 for c in hrp]


def _create_checksum(hrp: str, data: list[int]) -> list[int]:
    values = _hrp_expand(hrp) + data
    mod = _polymod(values + [0] * 6) ^ 1
    return [(mod >> 5 * (5 - i)) & 31 for i in range(6)]


def _convertbits(data: bytes | list[int], frombits: int, tobits: int, pad: bool) -> list[int]:
    acc = 0
    bits = 0
    ret: list[int] = []
    maxv = (1 << tobits) - 1
    for value in data:
        if value < 0 or value >> frombits:
            raise ValueError("invalid value for conversion")
        acc = (acc << frombits) | value
        bits += frombits
        while bits >= tobits:
            bits -= tobits
            ret.append((acc >> bits) & maxv)
    if pad:
        if bits:
            ret.append((acc << (tobits - bits)) & maxv)
    elif bits >= frombits or ((acc << (tobits - bits)) & maxv):
        raise ValueError("invalid padding in bech32 data")
    return ret


def encode(hrp: str, payload: bytes) -> str:
    data = _convertbits(payload, 8, 5, True)
    checksum = _create_checksum(hrp, data)
    return hrp + "1" + "".join(_CHARSET[d] for d in data + checksum)


def decode(addr: str) -> tuple[str, bytes]:
    """Returns (hrp, payload); raises ValueError on any malformation."""
    if addr.lower() != addr and addr.upper() != addr:
        raise ValueError("mixed-case bech32")
    addr = addr.lower()
    pos = addr.rfind("1")
    if pos < 1 or pos + 7 > len(addr) or len(addr) > 90:
        raise ValueError("invalid bech32 framing")
    hrp, rest = addr[:pos], addr[pos + 1 :]
    if any(c not in _CHARSET for c in rest):
        raise ValueError("invalid bech32 character")
    data = [_CHARSET.index(c) for c in rest]
    if _polymod(_hrp_expand(hrp) + data) != 1:
        raise ValueError("bad bech32 checksum")
    return hrp, bytes(_convertbits(data[:-6], 5, 8, False))
