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


@pytest.mark.parametrize("shape", [(2, 1, 40), (3, 2, 17), (4, 2, 8), (3, 1, 1), (5, 2, 3)])
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


def _mod2_numpy(G: np.ndarray, x: np.ndarray, m: int) -> np.ndarray:
    """(Pm, nm) 0/1 generator, (n, bps, cols) byte planes -> (Pm/m, bps, cols)
    parity planes: contraction index 8q + t is bit t of flat byte row q, and
    output bit row r is bit r % 8 of byte row r / 8."""
    n, bps, cols = x.shape
    bits = np.unpackbits(x.reshape(n * bps, 1, cols), axis=1, bitorder="little")
    prod = (G.astype(np.int64) @ bits.reshape(n * bps * 8, cols)) & 1
    out = np.packbits(prod.reshape(-1, 8, cols).astype(np.uint8), axis=1, bitorder="little")
    return out.reshape(G.shape[0] // m, bps, cols)


@pytest.mark.parametrize("cols", [1, 120, 257, 1000])
@pytest.mark.parametrize("Pm,nm,m", [(24, 40, 8), (32, 48, 16), (136, 264, 8)])
def test_xor_plain_on_random_generators(Pm, nm, m, cols):
    """The XOR core's plain version on random 0/1 generators at the ragged
    shapes the card checks its kernel on: packed words, a contraction that
    is not a multiple of 32 bits, cols not a multiple of 4 (down to 1).
    Against a numpy GF(2) product, and against the JAX XOR kernel in
    interpret mode at one width per shape that its row tiling takes (128
    rows, or all of Pm below that: 136 rows are no RS shape)."""
    from celestia_app_tpu_torch.kernels.rs_xor import mod2_matmul_planes_xor

    rng = np.random.default_rng(Pm * 7 + cols)
    G = rng.integers(0, 2, (Pm, nm), dtype=np.uint8)
    x = rng.integers(0, 256, (nm // m, m // 8, cols), dtype=np.uint8)
    words = pack_generator_words(G)
    got = mod2_matmul_planes_xor(torch.from_numpy(words.view(np.int32)), torch.from_numpy(x), m)
    want = _mod2_numpy(G, x, m)
    assert np.array_equal(got.numpy(), want)
    if cols == 120 and Pm % min(128, Pm) == 0:
        ref = jax_rs_xor.mod2_matmul_planes_xor(jnp.asarray(words), jnp.asarray(x), m,
                                                interpret=True)
        assert np.array_equal(np.asarray(ref), want)


@pytest.mark.parametrize("Pm,nm,cols", [(8, 8, 1), (24, 40, 3), (136, 264, 257), (64, 1024, 16)])
def test_kernel_operands_layout(Pm, nm, cols):
    """The XOR kernel's generator operand holds, row by row, the bytes of
    np.packbits(G_bits, bitorder="little") zero-padded to whole words (the
    bits of pack_generator_words, transposed), at a row stride that is a
    multiple of 16 bytes; its data operand is pack_data_words', at a row
    stride of whole 16-byte pieces."""
    from celestia_app_tpu_torch.kernels.rs_xor import kernel_operands

    rng = np.random.default_rng(Pm + nm + cols)
    G = rng.integers(0, 2, (Pm, nm), dtype=np.uint8)
    words = pack_generator_words(G)
    x = torch.from_numpy(rng.integers(0, 256, (nm // 8, 1, cols), dtype=np.uint8))
    Gk, B = kernel_operands(torch.from_numpy(words.view(np.int32)), x)
    nw = words.shape[0]
    want = np.zeros((Pm, 4 * nw), dtype=np.uint8)
    want[:, : -(-nm // 8)] = np.packbits(G, axis=1, bitorder="little")
    assert Gk.shape == (Pm, 4 * nw) and Gk.dtype == torch.uint8
    assert np.array_equal(Gk.numpy(), want)
    assert np.array_equal(Gk.numpy().view("<u4").T, words)
    assert Gk.stride(0) % 16 == 0 and (4 * B.stride(0)) % 16 == 0
    assert torch.equal(B, pack_data_words(x))


def test_pipe_probe_runs_only_on_a_card():
    """kernels/rs_xor.pipe_rates measures the card's pipes; asked for the
    CPU it refuses before it builds anything."""
    from celestia_app_tpu_torch.kernels.rs_xor import pipe_rates

    with pytest.raises(RuntimeError, match="CUDA device"):
        pipe_rates("cpu")


@pytest.mark.parametrize("kernel", ["rs_dense", "rs_dense_leaf", "rs_xor"])
def test_sweep_variants_name_one_place_in_the_sources(kernel):
    """Each build variant of kernels/sweep_rs_dense replaces text that occurs
    exactly once in its kernel's source and the shared headers, so an
    edited kernel cannot silently leave a variant equal to the built-in."""
    from celestia_app_tpu_torch.kernels import _build, sweep_rs_dense

    texts = [p.read_text() for p in _build.CSRC.glob("*.cuh")]
    texts.append((_build.CSRC / _build.LIBRARIES[kernel][0]).read_text())
    for name, subs in sweep_rs_dense.VARIANTS[kernel].items():
        for old, _ in subs:
            assert sum(t.count(old) for t in texts) == 1, (name, old)
