"""The port's own copy of gf/ against the JAX package's.

The RS generator is consensus-critical: the port must bit-expand the very
same matrix the JAX package does, for both constructions, and both must
match the committed generator pins (tests/golden/generators.json).
"""

from __future__ import annotations

import gc
import hashlib
import json
import os

import jax
import numpy as np
import pytest

from celestia_app_tpu.gf import field as jax_field
from celestia_app_tpu.gf import leopard as jax_leopard
from celestia_app_tpu.gf.rs import RSCodec as JaxRSCodec
from celestia_app_tpu_torch.gf import field, leopard
from celestia_app_tpu_torch.gf.rs import RSCodec, active_construction, codec_for_width


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran, when it ends:
    each loaded XLA:CPU executable holds hundreds to thousands of memory
    mappings, and a test worker that keeps every module's programs can
    reach the kernel's per-process map limit, where the next compile
    aborts."""
    yield
    jax.clear_caches()
    gc.collect()


_GOLDENS = json.load(
    open(os.path.join(os.path.dirname(__file__), "golden", "generators.json"))
)


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
@pytest.mark.parametrize("k", [1, 2, 8, 32, 128])
def test_generator_bits_equal_jax_package(k, construction):
    ours = RSCodec(k, construction)
    ref = JaxRSCodec(k, construction)
    assert ours.field.m == ref.field.m and ours.field.poly == ref.field.poly
    assert np.array_equal(ours.generator, ref.generator)
    assert np.array_equal(ours.generator_bits(), ref.generator_bits())


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
@pytest.mark.parametrize("k", [2, 4, 8, 16, 32, 64])
def test_generator_matches_golden(k, construction):
    g = np.ascontiguousarray(RSCodec(k, construction).generator)
    assert hashlib.sha256(g.astype("<u4").tobytes()).hexdigest() == _GOLDENS[
        f"{construction}/{k}"
    ]


@pytest.mark.parametrize("m", [8, 16])
def test_field_arithmetic_equals_jax_package(m):
    ours, ref = field._field(m), jax_field._field(m)
    rng = np.random.default_rng(m)
    a = rng.integers(0, 1 << m, 4096)
    b = rng.integers(1, 1 << m, 4096)
    assert np.array_equal(ours.mul(a, b), ref.mul(a, b))
    assert np.array_equal(ours.inv(b), ref.inv(b))
    for c in (1, 2, 0x53, (1 << m) - 1):
        assert np.array_equal(ours.mul_bit_matrix(c), ref.mul_bit_matrix(c))


@pytest.mark.parametrize("m", [8, 16])
def test_leopard_grid_equals_jax_package(m):
    assert leopard.cantor_basis(m) == jax_leopard.cantor_basis(m)
    k = 64
    assert np.array_equal(
        leopard.leopard_points(k, leopard.leopard_field(m)),
        jax_leopard.leopard_points(k, jax_leopard.leopard_field(m)),
    )


def test_host_encode_equals_jax_package():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (16, 512), dtype=np.uint8)
    for construction in ("vandermonde", "leopard"):
        assert np.array_equal(
            RSCodec(16, construction).encode(data),
            JaxRSCodec(16, construction).encode(data),
        )


def test_active_construction_reads_the_same_variable(monkeypatch):
    monkeypatch.delenv("CELESTIA_RS_CONSTRUCTION", raising=False)
    assert active_construction() == "vandermonde"
    monkeypatch.setenv("CELESTIA_RS_CONSTRUCTION", "leopard")
    assert active_construction() == "leopard"
    assert codec_for_width(4).construction == "leopard"
    with pytest.raises(ValueError):
        RSCodec(3)


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
@pytest.mark.parametrize("k", [4, 64, 256])
def test_fft_built_generator_equals_the_gaussian_solve(k, construction):
    """The port builds G as the FFT encode of the identity; the JAX package
    solves V[k:] @ inv(V[:k]) by Gaussian elimination.  Same matrix, the
    GF(2^16) regime (k=256) included."""
    ours = RSCodec(k, construction)
    ref = JaxRSCodec(k, construction)
    assert ours.generator.dtype == ref.generator.dtype
    assert np.array_equal(ours.generator, ref.generator)
    assert np.array_equal(ours._v_all, ref._v_all)


@pytest.mark.parametrize("k", [512, 2048])
def test_giant_vandermonde_generator_has_its_closed_form(k):
    """With data at points 0..k-1 and parity at k..2k-1, Lagrange
    interpolation gives G[p, i] = C / ((k + p) ^ i) with one constant
    C = prod(k..2k-1) / prod(1..k-1) over GF(2^16): an oracle independent of
    both the FFT and the Gaussian solve, cheap at the giant sizes."""
    codec = codec_for_width(k, "vandermonde")
    f = codec.field
    log = f.log.astype(np.int64)
    n1 = f.order - 1
    log_c = (log[np.arange(k, 2 * k)].sum() - log[np.arange(1, k)].sum()) % n1
    pts = (k + np.arange(k))[:, None] ^ np.arange(k)[None, :]  # (k + p) ^ i, never 0
    want = f.exp[(log_c - log[pts]) % n1].astype(f.dtype)
    assert np.array_equal(codec.generator, want)


@pytest.mark.parametrize("m", [8, 16])
def test_expand_bit_matrix_equals_jax_package(m):
    rng = np.random.default_rng(m + 1)
    A = rng.integers(0, 1 << m, (6, 9))
    A[0, :3] = 0
    ours = field._field(m).expand_bit_matrix(A)
    assert ours.dtype == np.uint8
    assert np.array_equal(ours, jax_field._field(m).expand_bit_matrix(A))


def test_generator_bits_built_once_and_read_only():
    codec = RSCodec(8, "leopard")
    bits = codec.generator_bits()
    assert codec.generator_bits() is bits and not bits.flags.writeable


@pytest.mark.parametrize("Pm,nm", [(8, 8), (24, 40), (136, 264), (256, 2048)])
def test_pack_generator_words_equal_jax_package(Pm, nm):
    from celestia_app_tpu.kernels.rs_xor import pack_generator_words as jax_pack
    from celestia_app_tpu_torch.convert import pack_generator_words

    G = np.random.default_rng(Pm + nm).integers(0, 2, (Pm, nm)).astype(np.uint8)
    ours = pack_generator_words(G)
    ref = np.asarray(jax_pack(G))
    assert ours.dtype == np.uint32 and ours.shape == ref.shape
    assert np.array_equal(ours, ref)
