"""The port's RS encode (plain dense and XOR versions, on the CPU) against
the JAX package's dense encode and its Pallas kernels in interpret mode.

Both constructions, both contraction axes, ragged k down to k=1, and one
GF(2^16) case (the k=256 generator over a narrow batch) so that the m=16
byte-pair order is pinned here.  The CUDA kernels are compared with these
plain versions in tests/test_torch_cuda.py and chip_smoke.py.
"""

from __future__ import annotations

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_app_tpu.gf.rs import RSCodec as JaxRSCodec
from celestia_app_tpu.kernels import rs as jax_rs
from celestia_app_tpu.kernels import rs_pallas as jax_rs_pallas
from celestia_app_tpu.kernels import rs_xor as jax_rs_xor
from celestia_app_tpu_torch.convert import expand_bits_tensor, pack_generator_words
from celestia_app_tpu_torch.gf.rs import RSCodec
from celestia_app_tpu_torch.kernels.rs import (
    encode_axis,
    encode_axis_xor,
    encode_fn,
    generator_tensor,
    generator_words,
)
from celestia_app_tpu_torch.kernels.rs_xor import pack_data_words


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



def _tensors(k: int, construction: str):
    m, G_bits = generator_tensor(k, construction, "cpu")
    return m, {"G_bits": G_bits, "G_words": generator_words(k, construction, "cpu")[1]}


def _port_both(data: np.ndarray, k: int, construction: str, axis: int):
    m, t = _tensors(k, construction)
    x = torch.from_numpy(data)
    dense = encode_axis(x, t["G_bits"], m, axis).numpy()
    xor = encode_axis_xor(x, t["G_words"], m, axis).numpy()
    return dense, xor


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
@pytest.mark.parametrize("k", [1, 2, 4, 16])
def test_encode_equals_jax_dense_and_xor(k, construction):
    codec = JaxRSCodec(k, construction)
    m = codec.field.m
    G_bits = jnp.asarray(codec.generator_bits())
    G_words = jnp.asarray(jax_rs_xor.pack_generator_words(codec.generator_bits()))
    rng = np.random.default_rng(k * 11 + len(construction))
    base = rng.integers(0, 256, (3, k, 16), dtype=np.uint8)
    for axis in (0, 1):
        data = np.ascontiguousarray(np.moveaxis(base, 1, axis))
        want = np.asarray(jax_rs.encode_axis(jnp.asarray(data), G_bits, m, axis))
        if k >= 2:
            xor_ref = jax_rs_xor.encode_axis_xor(
                jnp.asarray(data), G_words, m, axis, interpret=True)
            assert np.array_equal(np.asarray(xor_ref), want)
        dense, xor = _port_both(data, k, construction, axis)
        assert np.array_equal(dense, want), (k, construction, axis)
        assert np.array_equal(xor, want), (k, construction, axis)


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
def test_encode_equals_jax_pallas_dense_k16(construction):
    k = 16
    codec = JaxRSCodec(k, construction)
    m = codec.field.m
    G_bits = jnp.asarray(codec.generator_bits())
    rng = np.random.default_rng(23)
    base = rng.integers(0, 256, (3, k, 64), dtype=np.uint8)
    for axis in (0, 1):
        data = np.ascontiguousarray(np.moveaxis(base, 1, axis))
        want = np.asarray(jax_rs_pallas.encode_axis_pallas(
            jnp.asarray(data), G_bits, m, axis, interpret=True))
        dense, xor = _port_both(data, k, construction, axis)
        assert np.array_equal(dense, want) and np.array_equal(xor, want)


def test_gf16_byte_pair_order_k256():
    """k=256 runs in GF(2^16): symbols are little-endian byte pairs."""
    k = 256
    codec = JaxRSCodec(k, "vandermonde")
    m = codec.field.m
    assert m == 16
    rng = np.random.default_rng(256)
    data = rng.integers(0, 256, (k, 1, 512), dtype=np.uint8)
    want = np.asarray(jax_rs.encode_axis(
        jnp.asarray(data), jnp.asarray(codec.generator_bits()), m, 0))
    # the host codec agrees on one column of shares
    assert np.array_equal(want[:, 0], codec.encode(data[:, 0]))
    dense, xor = _port_both(data, k, "vandermonde", 0)
    assert np.array_equal(dense, want)
    assert np.array_equal(xor, want)


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
@pytest.mark.parametrize("k", [1, 2, 16])
def test_codec_tensors_match_jax_packing(k, construction):
    G = JaxRSCodec(k, construction).generator_bits()
    m, t = _tensors(k, construction)
    assert np.array_equal(t["G_bits"].numpy(), G.astype(np.int8))
    want = jax_rs_xor.pack_generator_words(G)
    assert np.array_equal(t["G_words"].numpy().view(np.uint32), want)
    assert np.array_equal(pack_generator_words(G), want)


@pytest.mark.parametrize("shape", [(2, 1, 40), (3, 2, 17), (4, 2, 8)])
def test_data_word_packing_matches_jax(shape):
    x = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(jax_rs_xor.pack_data_words(jnp.asarray(x)))
    got = pack_data_words(torch.from_numpy(x)).numpy().view(np.uint32)
    assert np.array_equal(got, want)


def test_encode_fn_selects_xor_by_env(monkeypatch):
    rng = np.random.default_rng(5)
    ods = torch.from_numpy(rng.integers(0, 256, (8, 8, 512), dtype=np.uint8))
    monkeypatch.setenv("CELESTIA_RS_XOR", "off")
    dense = encode_fn(8, "vandermonde", "cpu")(ods, 1)
    monkeypatch.setenv("CELESTIA_RS_XOR", "on")
    xor = encode_fn(8, "vandermonde", "cpu")(ods, 1)
    assert torch.equal(dense, xor)
    want = RSCodec(8, "vandermonde").encode(ods[3].numpy())
    assert np.array_equal(dense[3].numpy(), want)


def test_codec_tensors_reject_non_bit_matrices():
    """The device bit expansion takes only a 2-D matrix of field elements."""
    field = RSCodec(2, "vandermonde").field
    with pytest.raises(ValueError):
        expand_bits_tensor(field, np.full((8, 8), 256, dtype=np.int64), "cpu")
    with pytest.raises(ValueError):
        expand_bits_tensor(field, np.full((8, 8), -1, dtype=np.int64), "cpu")
    with pytest.raises(ValueError):
        expand_bits_tensor(field, np.zeros((8, 12, 2), dtype=np.uint8), "cpu")
