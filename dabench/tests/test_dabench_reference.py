"""The plain reference against hashlib, against its own frozen constants and
against the program's CPU path at small sizes, for both constructions."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from dabench import squares
from dabench.reference import field, nmt
from dabench.reference.eds import Reference
from dabench.reference.sha256 import sha256

LAYOUT = {"compact_fraction": [0.05, 0.2], "pfb_fraction": 0.3, "fill": [0.5, 1.0],
          "blob_alpha": 1.1, "blob_max_fraction": 0.25}


@pytest.mark.parametrize("length", [0, 1, 55, 56, 64, 65, 91, 181, 542])
def test_sha256_equals_hashlib(length):
    rng = np.random.default_rng(length)
    msgs = rng.integers(0, 256, (33, length), dtype=np.uint8)
    got = sha256(torch.from_numpy(msgs)).numpy()
    assert [d.tobytes() for d in got] == [hashlib.sha256(m.tobytes()).digest() for m in msgs]


@pytest.mark.parametrize("m,poly", [(8, 0x11D), (16, 0x1002D)])
def test_frozen_cantor_basis_derives_again(m, poly):
    f = field.field(m, poly)
    xs = np.arange(1 << m)
    square_plus = f.mul(xs, xs) ^ xs
    basis = [1]
    for _ in range(m - 1):
        basis.append(int(np.nonzero(square_plus == basis[-1])[0][0]))
    assert tuple(basis) == field.CANTOR_BASIS[m]


@pytest.mark.parametrize("construction", ["leopard", "vandermonde"])
@pytest.mark.parametrize("k", [1, 2, 4, 8, 64, 256])
def test_generator_equals_the_programs(construction, k):
    from celestia_app_tpu_torch.gf.rs import RSCodec

    _, g = field.generator(k, construction)
    assert np.array_equal(g, RSCodec(k, construction).generator.astype(np.int64))


def test_generator_bits_multiply_like_the_field():
    f, g = field.generator(4, "leopard")
    bits = field.generator_bits(4, "leopard")
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 4)
    data_bits = ((data[:, None] >> np.arange(8)) & 1).ravel()
    parity_bits = (bits.astype(np.int64) @ data_bits) & 1
    want = np.bitwise_xor.reduce(f.mul(g, data[None, :]), axis=1)
    assert np.array_equal(parity_bits.reshape(4, 8) @ (1 << np.arange(8)), want)


@pytest.mark.parametrize("construction", ["leopard", "vandermonde"])
@pytest.mark.parametrize("k", [1, 2, 4, 8, 64])
def test_recover_gives_back_the_ods_from_its_row_parity(construction, k):
    """Q0 interpolated back from Q1 alone, as a Q0 repair needs."""
    pool, _ = squares.pool(k, 1, 77 + k, LAYOUT, "cpu")
    ref = Reference(k, construction, "cpu")
    eds = ref.eds(pool[0])
    damaged = eds.clone()
    damaged[:k, :k] = 0
    assert np.array_equal(ref.recover_ods(damaged).numpy(), pool[0])


def _squares(k, seed, n=2):
    pool, at = squares.pool(k, n, seed, LAYOUT, "cpu")
    return pool, at


@pytest.mark.parametrize("construction", ["leopard", "vandermonde"])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_reference_equals_the_programs_cpu_path(construction, k, monkeypatch):
    from celestia_app_tpu_torch.da.eds import ExtendedDataSquare

    monkeypatch.setenv("CELESTIA_RS_CONSTRUCTION", construction)
    pool, at = _squares(k, 1000 + k)
    odss = [pool[0], squares.stamp(pool[1].copy(), at[1], 12345)]
    ref = Reference(k, construction, "cpu")
    rr, cr, dr = ref.roots(odss)
    for i, ods in enumerate(odss):
        eds = ExtendedDataSquare.compute(ods, construction=construction, device="cpu")
        assert np.array_equal(ref.eds(ods).numpy(), eds.squared())
        assert dr[i].tobytes() == eds.data_root()
        assert [r.tobytes() for r in rr[i]] == eds.row_roots()
        assert [c.tobytes() for c in cr[i]] == eds.col_roots()


def test_min_dah_golden():
    from celestia_app_tpu_torch.da.dah import tail_padding_share

    ods = np.frombuffer(tail_padding_share(), dtype=np.uint8).reshape(1, 1, 512)
    dr = Reference(1, "leopard", "cpu").roots([ods])[2]
    assert dr[0].tobytes().hex() == ("3d96b7d238e7e0456f6af8e7cdf0a67b"
                                     "d6cf9c2089ecb559c659dcaa1f880353")


def test_stamped_squares_differ_and_so_do_their_roots():
    pool, at = _squares(4, 7, n=1)
    a = squares.stamp(pool[0].copy(), at[0], 1)
    b = squares.stamp(pool[0].copy(), at[0], 2)
    assert (a != b).sum() >= 1 and (a != b).sum() <= squares.STAMP_BYTES
    dr = Reference(4, "leopard", "cpu").roots([a, b])[2]
    assert dr[0].tobytes() != dr[1].tobytes()


def test_square_layout_rises_and_pads():
    k = 16
    ns, at = squares.layout(k, np.random.default_rng(5), LAYOUT)
    rows = [r.tobytes() for r in ns]
    assert rows == sorted(rows)  # namespaces rise in row-major order
    assert rows[0] == squares.TX_NS.tobytes()
    assert rows[-1] == squares.TAIL_PADDING_NS.tobytes()
    assert rows[at] not in (squares.TX_NS.tobytes(), squares.PFB_NS.tobytes())


def test_pool_is_a_function_of_the_seed():
    a, _ = squares.pool(4, 3, 2**40 + 1, LAYOUT, "cpu")
    b, _ = squares.pool(4, 3, 2**40 + 1, LAYOUT, "cpu")
    c, _ = squares.pool(4, 3, 2**40 + 2, LAYOUT, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[0], a[1])


def test_parity_namespace_rule_of_inner_nodes():
    parity = bytes([0xFF]) * 29
    low, high = bytes(28) + b"\x05", bytes(28) + b"\x09"

    def leaf(ns):
        return np.frombuffer(ns + ns + bytes(32), dtype=np.uint8)

    leaves = torch.from_numpy(np.stack([leaf(low), leaf(high), leaf(parity), leaf(parity)])[None])
    root = nmt.tree_roots(leaves)[0].numpy().tobytes()
    assert root[:29] == low and root[29:58] == high  # the parity maximum is ignored
