"""The port's account keys on the CPU, byte-identical to the JAX package's:
`PrivateKey.from_seed` public keys and addresses, RFC 6979 signatures
(`sign` bytes), `PublicKey.verify` verdicts on honest and malformed inputs,
RIPEMD-160 against hashlib and the published vectors, and bech32.

The JAX package signs and verifies through `cryptography` (OpenSSL); the
port does both in Python integers, so every case compares the two.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
from cryptography.hazmat.primitives.asymmetric import ec

from celestia_app_tpu.crypto import bech32 as jax_bech32
from celestia_app_tpu.crypto import keys as jax_keys
from celestia_app_tpu_torch.crypto import bech32, keys
from celestia_app_tpu_torch.crypto.ripemd160 import ripemd160

N = keys._ORDER


def jax_key(d: int) -> jax_keys.PrivateKey:
    return jax_keys.PrivateKey(ec.derive_private_key(d, ec.SECP256K1()))


SEEDS = [f"account-{i}".encode() for i in range(8)] + [b"", b"mallory", bytes(range(40))]


@pytest.mark.parametrize("seed", SEEDS, ids=lambda s: s.hex()[:16] or "empty")
def test_from_seed_pubkey_and_address_equal(seed):
    port, ref = keys.PrivateKey.from_seed(seed), jax_keys.PrivateKey.from_seed(seed)
    assert port.public_key().bytes == ref.public_key().bytes
    assert port.public_key().address_bytes() == ref.public_key().address_bytes()
    assert port.public_key().address() == ref.public_key().address()
    assert keys.validate_address(port.public_key().address()) == port.public_key().address_bytes()


def _sign_cases():
    rng = np.random.default_rng(6979)
    for i in range(104):
        seed = f"signer-{i % 13}".encode()
        msg = rng.bytes(int(rng.integers(0, 400)))
        yield pytest.param(seed, msg, id=f"{i}")


@pytest.mark.parametrize("seed,msg", list(_sign_cases()))
def test_sign_bytes_equal_jax(seed, msg):
    port, ref = keys.PrivateKey.from_seed(seed), jax_keys.PrivateKey.from_seed(seed)
    sig = port.sign(msg)
    assert sig == ref.sign(msg)
    assert int.from_bytes(sig[32:], "big") <= N // 2  # low-S
    assert port.public_key().verify(msg, sig)


def test_rfc6979_public_vector():
    """d=1, msg="Satoshi Nakamoto": the published (r, low-S s) pair, as in
    tests/test_deterministic_signing.py."""
    sig = keys.PrivateKey(1).sign(b"Satoshi Nakamoto")
    assert int.from_bytes(sig[:32], "big") == (
        0x934B1EA10A4B3C1757E2B0C017D0B6143CE3C9A7E6A4A49860D7A6AB210EE3D8)
    assert int.from_bytes(sig[32:], "big") == (
        0x2442CE9D2B916064108014783E923EC36B49743E2FFA1C4496F01A512AAFD9E5)
    assert sig == jax_key(1).sign(b"Satoshi Nakamoto")


@pytest.mark.parametrize("d", [1, 2, 3, N - 1, N // 2, 0xDEADBEEF, 2**128 + 7])
def test_sign_at_edge_scalars(d):
    msg = b"edge scalar"
    assert keys.PrivateKey(d).sign(msg) == jax_key(d).sign(msg)
    assert keys.PrivateKey(d).public_key().bytes == jax_key(d).public_key().bytes


def test_endomorphism_constants():
    """lambda·G == (beta·Gx, Gy): the GLV split rests on this pair."""
    x, y = keys._affine(keys._mul_add(keys._LAMBDA))
    assert (x, y) == (keys._BETA * keys._GX % keys._P, keys._GY)
    rng = np.random.default_rng(3)
    for _ in range(200):
        k = int.from_bytes(rng.bytes(32), "big") % N
        k1, k2 = keys._split(k)
        assert (k1 + k2 * keys._LAMBDA - k) % N == 0
        assert max(abs(k1), abs(k2)).bit_length() <= 129


def _not_on_curve_x() -> int:
    x = 5
    while True:
        rhs = (x ** 3 + 7) % keys._P
        if pow(rhs, (keys._P - 1) // 2, keys._P) != 1:
            return x
        x += 1


def _infinity_case() -> tuple[bytes, bytes, bytes]:
    """(pubkey, msg, sig) whose verification sum u1·G + u2·Q is the point at
    infinity: Q = d·G with e + r·d = 0 (mod n)."""
    msg = b"reaches infinity"
    e = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    r, s = 12345, 6789
    d = (-e * pow(r, -1, N)) % N
    pub = keys.PrivateKey(d).public_key().bytes
    return pub, msg, r.to_bytes(32, "big") + s.to_bytes(32, "big")


def _verify_cases():
    key, other = keys.PrivateKey.from_seed(b"v"), keys.PrivateKey.from_seed(b"w")
    pub, msg = key.public_key().bytes, b"the message"
    sig = key.sign(msg)
    r, s = int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:], "big")

    def rs(r_, s_):
        return r_.to_bytes(32, "big") + s_.to_bytes(32, "big")

    x_off = _not_on_curve_x()
    cases = {
        "honest": (pub, msg, sig),
        "high_s": (pub, msg, rs(r, N - s)),
        "r_zero": (pub, msg, rs(0, s)),
        "r_order": (pub, msg, rs(N, s)),
        "s_zero": (pub, msg, rs(r, 0)),
        "s_order": (pub, msg, rs(r, N)),
        "short_sig": (pub, msg, sig[:63]),
        "long_sig": (pub, msg, sig + b"\x00"),
        "empty_sig": (pub, msg, b""),
        "wrong_key": (other.public_key().bytes, msg, sig),
        "wrong_message": (pub, msg + b"!", sig),
        "bad_prefix_04": (b"\x04" + pub[1:], msg, sig),
        "bad_prefix_00": (b"\x00" + pub[1:], msg, sig),
        "flipped_parity": (bytes([pub[0] ^ 1]) + pub[1:], msg, sig),
        "off_curve": (b"\x02" + x_off.to_bytes(32, "big"), msg, sig),
        "x_above_p": (b"\x02" + (keys._P + 1).to_bytes(32, "big"), msg, sig),
        "point_at_infinity": _infinity_case(),
    }
    return [pytest.param(*v, id=k) for k, v in cases.items()]


@pytest.mark.parametrize("pub,msg,sig", _verify_cases())
def test_verify_verdicts_equal_jax(pub, msg, sig):
    assert keys.PublicKey(pub).verify(msg, sig) == jax_keys.PublicKey(pub).verify(msg, sig)


def test_verify_honest_true_and_malformed_false():
    verdicts = {c.id: keys.PublicKey(c.values[0]).verify(*c.values[1:])
                for c in _verify_cases()}
    assert verdicts.pop("honest") is True
    assert not any(verdicts.values()), verdicts


RIPEMD160_VECTORS = {  # Dobbertin, Bosselaers, Preneel: the published test vectors
    b"": "9c1185a5c5e9fc54612808977ee8f548b2258d31",
    b"a": "0bdc9d2d256b3ee9daae347be6f4dc835a467ffe",
    b"abc": "8eb208f7e05d987a9b044a8e98c6b087f15a0bfc",
    b"message digest": "5d0689ef49d2fae572b881b123a85ffa21595f36",
    b"abcdefghijklmnopqrstuvwxyz": "f71c27109c692c1b56bbdceb5b9d2865b3708dbc",
    b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq":
        "12a053384a9c0c88e405a06c27dcf49ada62eb2b",
    b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789":
        "b0e20b6e3116640286ed3a87a5713079b21f5189",
    b"1234567890" * 8: "9b752e45573d4b39f4dbd3323cab82bf63326bfb",
}


@pytest.mark.parametrize("msg,digest", list(RIPEMD160_VECTORS.items()),
                         ids=[str(len(m)) for m in RIPEMD160_VECTORS])
def test_ripemd160_published_vectors(msg, digest):
    assert ripemd160(msg).hex() == digest


def test_ripemd160_equals_hashlib_lengths_0_to_200():
    rng = np.random.default_rng(160)
    for n in range(201):
        data = rng.bytes(n)
        assert ripemd160(data) == hashlib.new("ripemd160", data).digest(), n


@pytest.mark.parametrize("n", [0, 1, 20, 32, 33, 40])
def test_bech32_round_trip_equals_jax(n):
    payload = np.random.default_rng(n).bytes(n)
    addr = bech32.encode("celestia", payload)
    assert addr == jax_bech32.encode("celestia", payload)
    assert bech32.decode(addr) == jax_bech32.decode(addr) == ("celestia", payload)


@pytest.mark.parametrize("addr", [
    "celestia1qqqqqqqqqqqqqqqqqqqqqqqqqqqqqqqqqqqqqqqq",  # bad checksum
    "Celestia1xyz",                                       # mixed case
    "celestia1",                                          # too short
    "celestia1b" + "q" * 38,                              # 'b' is not in the charset
])
def test_bech32_rejections_equal_jax(addr):
    with pytest.raises(ValueError) as port:
        bech32.decode(addr)
    with pytest.raises(ValueError) as ref:
        jax_bech32.decode(addr)
    assert str(port.value) == str(ref.value)
