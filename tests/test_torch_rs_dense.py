"""The dense RS wrapper's layout helpers on the CPU.

The CUDA kernel (csrc/rs_dense.cu) reads the generator and the byte planes
and writes the parity through TMA, which needs 16-byte row strides.
`kernels.rs.generator_tensor` pads the generator's rows once, and `tma_rows` pads any
other tensor's rows; these tests hold both to the plain version's bytes and
to the JAX package's dense core, at the ragged shapes where padding is
needed (k=1 has an 8-byte generator row).  The kernel itself is compared
with the plain version in tests/test_torch_cuda.py and chip_smoke.py.
"""

from __future__ import annotations

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_app_tpu.kernels import rs as jax_rs
from celestia_app_tpu_torch.gf.rs import RSCodec
from celestia_app_tpu_torch.kernels import rs_dense
from celestia_app_tpu_torch.kernels.rs import encode_axis, generator_tensor


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



@pytest.mark.parametrize("k", [1, 2, 4, 16])
def test_codec_generator_rows_are_tma_aligned(k):
    codec = RSCodec(k, "leopard")
    m = codec.field.m
    G = generator_tensor(k, "leopard", "cpu")[1]
    assert G.shape == (k * m, k * m)
    assert G.stride(1) == 1 and G.stride(0) % 16 == 0
    assert rs_dense.tma_rows(G) is G  # no per-call copy
    assert np.array_equal(G.numpy(), codec.generator_bits().astype(np.int8))
    # the padding past n*m is zero, so a kernel reading whole rows adds nothing
    full = torch.as_strided(G, (k * m, G.stride(0)), (G.stride(0), 1))
    assert not full[:, k * m:].any()


@pytest.mark.parametrize("k", [1, 2, 4, 16])
def test_padded_generator_gives_plain_bytes(k):
    """The padded-row generator encodes exactly as a compact copy of it,
    and as the host codec."""
    codec = RSCodec(k, "vandermonde")
    m = codec.field.m
    G = generator_tensor(k, "vandermonde", "cpu")[1]
    compact = G.contiguous()
    rng = np.random.default_rng(k)
    ods = torch.from_numpy(rng.integers(0, 256, (k, k, 512), dtype=np.uint8))
    got = encode_axis(ods, G, m, 1)
    assert torch.equal(got, encode_axis(ods, compact, m, 1))
    assert np.array_equal(got[0].numpy(), codec.encode(ods[0].numpy()))


@pytest.mark.parametrize("cols", [1, 120, 257, 1000])
def test_tma_rows_pads_ragged_strides(cols):
    rng = np.random.default_rng(cols)
    x = torch.from_numpy(rng.integers(0, 256, (5, cols), dtype=np.uint8))
    t = rs_dense.tma_rows(x)
    assert torch.equal(t, x)
    assert t.stride(1) == 1 and t.stride(0) % 16 == 0
    assert t.stride(0) == rs_dense.padded_width(cols)
    assert (t is x) == (cols % 16 == 0)
    # a strided view whose rows are already 16-byte spaced is taken as is
    wide = torch.zeros((5, rs_dense.padded_width(cols) + 16), dtype=torch.uint8)
    view = wide[:, :cols]
    assert rs_dense.tma_rows(view) is view


@pytest.mark.parametrize("cols", [1, 120, 257, 1000])
@pytest.mark.parametrize("Pm,nm,m", [(24, 40, 8), (32, 48, 16)])
def test_random_generator_padded_planes_equal_jax(Pm, nm, m, cols):
    """A random 0/1 generator (not an RS one) at ragged Pm, nm and cols:
    the plain version on padded-stride operands gives the JAX dense core's
    bytes, so it is a sound oracle for the kernel's edge tiles."""
    rng = np.random.default_rng(Pm * cols + nm)
    G = rng.integers(0, 2, (Pm, nm), dtype=np.int8)
    x = rng.integers(0, 256, (nm // m, m // 8, cols), dtype=np.uint8)
    want = np.asarray(jax_rs._mod2_matmul_planes(jnp.asarray(G), jnp.asarray(x), m))
    Gp = rs_dense.tma_rows(torch.from_numpy(G))
    xp = rs_dense.tma_rows(torch.from_numpy(x).reshape(-1, cols)).view(x.shape)
    got = rs_dense.mod2_matmul_planes_plain(Gp, xp, m)
    assert got.shape == (Pm // m, m // 8, cols)
    assert np.array_equal(got.numpy(), want)


def test_check_aligned_rejects_misaligned_pointers():
    buf = torch.zeros(96, dtype=torch.uint8)
    rs_dense.check_aligned(buf, buf[16:48])
    with pytest.raises(ValueError, match="16-byte aligned"):
        rs_dense.check_aligned(buf[1:33].view(2, 16))
