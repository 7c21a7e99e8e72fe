"""The port's additive-FFT encode against the JAX package and the dense path.

gf/fft.py is the port's own numpy copy of celestia_app_tpu/gf/fft.py, and
kernels/fft.py lowers its butterflies to batched 0/1 products in torch
(float32 on the CPU, float16 on the card).  The same seeded inputs go
through both packages, and the FFT encode must equal the dense generator
encode byte for byte, on both axes, for both constructions and both
lowerings (default and md); the column-blocked staging of the panel path
must equal the unblocked call sliced.  The encode seam (_fft_choice,
encode_core, encode_fn) follows the JAX rules.
"""

from __future__ import annotations

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_app_tpu.gf import fft as jax_gf_fft
from celestia_app_tpu.gf.rs import RSCodec as JaxRSCodec
from celestia_app_tpu.kernels import fft as jax_fft
from celestia_app_tpu.kernels import rs as jax_rs
from celestia_app_tpu_torch.gf import fft as gf_fft
from celestia_app_tpu_torch.gf.leopard import cantor_basis, leopard_field
from celestia_app_tpu_torch.gf.rs import RSCodec, codec_for_width
from celestia_app_tpu_torch.kernels import fft, rs


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


CPU = torch.device("cpu")
CUDA = torch.device("cuda")  # a device object only: nothing here runs on it


@pytest.fixture(autouse=True)
def _no_ambient_seams(monkeypatch):
    for var in ("CELESTIA_RS_FFT", "CELESTIA_RS_FFT_MD", "CELESTIA_RS_XOR"):
        monkeypatch.delenv(var, raising=False)


# --- gf/fft.py: the host transforms ------------------------------------------


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32, 64, 128])
def test_encode_fft_equals_jax_and_generator(k, construction):
    rng = np.random.default_rng(k)
    codec = RSCodec(k, construction)
    data = rng.integers(0, codec.field.order, (k, 9)).astype(codec.field.dtype)
    got = gf_fft.encode_fft(codec, data)
    assert np.array_equal(got, jax_gf_fft.encode_fft(JaxRSCodec(k, construction), data))
    assert np.array_equal(got, codec.field.matmul(codec.generator, data))
    assert gf_fft.encode_params(codec)[1:] == jax_gf_fft.encode_params(
        JaxRSCodec(k, construction))[1:]


@pytest.mark.parametrize("m", [8, 16])
def test_stage_twiddles_and_transforms_equal_jax(m):
    rng = np.random.default_rng(m)
    field = leopard_field(m)
    basis = cantor_basis(m)
    from celestia_app_tpu.gf.leopard import leopard_field as jax_leopard_field

    jfield = jax_leopard_field(m)
    for r in (1, 3, 5):
        x = rng.integers(0, field.order, (1 << r, 3)).astype(field.dtype)
        for shift in (0, int(basis[r]), 0x17):
            for j in range(r):
                assert np.array_equal(gf_fft.stage_twiddles(field, basis, r, j, shift),
                                      jax_gf_fft.stage_twiddles(jfield, basis, r, j, shift))
            y = gf_fft.fft(field, basis[:r], x, shift)
            assert np.array_equal(y, jax_gf_fft.fft(jfield, basis[:r], x, shift))
            assert np.array_equal(gf_fft.ifft(field, basis[:r], y, shift), x)
            assert np.array_equal(gf_fft.ifft(field, basis[:r], x, shift),
                                  jax_gf_fft.ifft(jfield, basis[:r], x, shift))


# --- kernels/fft.py: the grouped butterflies --------------------------------


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
@pytest.mark.parametrize("k", [1, 2, 4, 8, 64, 256])
def test_encode_groups_equal_jax(k, construction):
    ours = fft.encode_groups(k, construction)
    ref = jax_fft.encode_groups(k, construction)
    assert len(ours) == len(ref)
    for (a0, a1, A), (b0, b1, B) in zip(ours, ref):
        assert (a0, a1) == (b0, b1)
        assert A.dtype == B.dtype and np.array_equal(A, B)


@pytest.mark.parametrize("md", [False, True])
@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
@pytest.mark.parametrize("k", [2, 8, 64])
def test_encode_axis_fft_equals_jax_and_dense(k, construction, md):
    rng = np.random.default_rng(10 * k + md)
    dense = rs.encode_fn(k, construction, "cpu")  # the dense core: seams unset, k < 512
    assert rs.encode_core(k, CPU) == ("dense",)
    for axis, shape in ((1, (k, k, 512)), (0, (k, 2 * k, 512))):
        data = rng.integers(0, 256, shape, dtype=np.uint8)
        got = fft.encode_axis_fft(torch.from_numpy(data), k, construction, axis, md=md)
        want = dense(torch.from_numpy(data), axis)
        assert torch.equal(got, want)
        ref = jax_fft.encode_axis_fft(jnp.asarray(data), k, construction, axis, md=md)
        assert np.array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
def test_encode_axis_fft_batches_leading_axes(construction):
    """Leading batch axes (the batched pipelines' stacked squares) go
    through in one call, each square's parity its own."""
    k = 4
    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.integers(0, 256, (3, k, k, 512), dtype=np.uint8))
    got = fft.encode_axis_fft(data, k, construction, contract_axis=-2)
    for b in range(3):
        assert torch.equal(got[b], fft.encode_axis_fft(data[b], k, construction, 1))
    dense = rs.encode_fn(k, construction, "cpu")
    assert torch.equal(got, dense(data, -2))


@pytest.mark.parametrize("env_md", [None, "0", "1"])
def test_md_and_default_lowerings_equal(env_md, monkeypatch):
    if env_md is not None:
        monkeypatch.setenv("CELESTIA_RS_FFT_MD", env_md)
    rng = np.random.default_rng(5)
    for k, construction in ((16, "leopard"), (32, "vandermonde")):
        data = torch.from_numpy(rng.integers(0, 256, (k, 6, 512), dtype=np.uint8))
        by_env = fft.encode_axis_fft(data, k, construction, 0)
        assert torch.equal(by_env, fft.encode_axis_fft(data, k, construction, 0, md=True))
        assert torch.equal(by_env, fft.encode_axis_fft(data, k, construction, 0, md=False))


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
@pytest.mark.parametrize("k,width", [(8, 3), (16, 5), (16, 32)])
def test_col_block_encode_equals_unblocked_sliced(k, width, construction):
    rng = np.random.default_rng(k + width)
    top = torch.from_numpy(rng.integers(0, 256, (k, 2 * k, 512), dtype=np.uint8))
    whole = fft.encode_axis_fft(top, k, construction, contract_axis=0)
    run = fft.col_block_encode_fn(k, construction)
    for c0 in range(0, 2 * k, width):
        c1 = min(c0 + width, 2 * k)
        assert torch.equal(run(top[:, c0:c1]), whole[:, c0:c1])


def test_bits_dtype_is_exact_for_the_group_sums():
    assert fft.bits_dtype(CUDA) == torch.float16
    assert fft.bits_dtype(CPU) == torch.float32
    # Every partial sum of a group product is an integer in [0, 128].
    sums = torch.arange(0, 129, dtype=torch.float32)
    assert torch.equal(sums.to(torch.float16).to(torch.float32), sums)


# --- the encode seam ------------------------------------------------------------

SEAM_CASES = [(None, 2), (None, 256), (None, 512), (None, 2048), ("auto", 512), ("on", 2),
              ("on", 512), ("off", 512), ("bogus", 1024)]


@pytest.mark.parametrize("md", [None, "1"])
@pytest.mark.parametrize("env,k", SEAM_CASES)
def test_fft_choice_follows_the_jax_rules(env, k, md, monkeypatch):
    if env is not None:
        monkeypatch.setenv("CELESTIA_RS_FFT", env)
    if md is not None:
        monkeypatch.setenv("CELESTIA_RS_FFT_MD", md)
    # On the CPU the JAX package's platform is the CPU too: the same answer.
    assert rs._fft_choice(k, CPU) == jax_rs._fft_choice(k)
    # On the card auto stays dense; "on" forces the FFT everywhere.
    use_fft, force_md = rs._fft_choice(k, CUDA)
    assert use_fft == (env == "on") and force_md is None
    core = rs.encode_core(k, CPU)
    use, force = jax_rs._fft_choice(k)
    if use:
        assert core == ("fft", (md == "1") if force is None else force)
    else:
        assert core == ("dense",)


def test_encode_core_precedence_fft_over_xor(monkeypatch):
    monkeypatch.setenv("CELESTIA_RS_XOR", "on")
    assert rs.encode_core(8, CPU) == ("xor",)
    monkeypatch.setenv("CELESTIA_RS_FFT", "on")
    assert rs.encode_core(8, CPU) == ("fft", False)
    assert rs.encode_core(8, CUDA) == ("fft", False)
    monkeypatch.setenv("CELESTIA_RS_FFT_MD", "1")
    assert rs.encode_core(8, CPU) == ("fft", True)


@pytest.mark.parametrize("env", ["on", "off"])
def test_encode_fn_fft_branch_gives_dense_bytes(env, monkeypatch):
    monkeypatch.setenv("CELESTIA_RS_FFT", env)
    monkeypatch.setenv("CELESTIA_RS_XOR", "on")  # fft > xor > dense
    k = 16
    data = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (k, k, 512),
                                                             dtype=np.uint8))
    ext = rs.extend_square_fn(k, "vandermonde", "cpu")(data)
    monkeypatch.setenv("CELESTIA_RS_FFT", "off")
    monkeypatch.setenv("CELESTIA_RS_XOR", "off")
    assert torch.equal(ext, rs.extend_square_fn(k, "vandermonde", "cpu")(data))
    codec = codec_for_width(k, "vandermonde")
    assert np.array_equal(ext[0, k:].numpy(), codec.encode(data[0].numpy()))
