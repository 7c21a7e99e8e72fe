"""The port's fused_epi lowering on the CPU, byte-identical to the JAX package.

On the CPU `extend_leaf_digests` runs its plain version and `bottom_leaf_fn`
the seated encode followed by the leaf digests, as the JAX package does off
the TPU; tests/test_rs_xor.py holds that composition to the Pallas kernel
in interpret mode, and tests/test_torch_cuda.py holds the CUDA kernel to
the plain version on the card.
"""

from __future__ import annotations

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_app_tpu.kernels import fused as jax_fused
from celestia_app_tpu.kernels.rs import encode_fn as jax_encode_fn
from celestia_app_tpu.kernels.rs_xor import bottom_leaf_fn as jax_bottom_leaf_fn
from celestia_app_tpu_torch.constants import SHARE_SIZE
from celestia_app_tpu_torch.convert import codec_tensors
from celestia_app_tpu_torch.da import eds as port_eds
from celestia_app_tpu_torch.da import extend_shares
from celestia_app_tpu_torch.gf.rs import RSCodec
from celestia_app_tpu_torch.kernels import fused, rs_xor
from celestia_app_tpu_torch.kernels.rs import encode_fn

KS = [1, 2, 4, 8, 16]
CONSTRUCTIONS = ["vandermonde", "leopard"]


def _rand(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("construction", CONSTRUCTIONS)
@pytest.mark.parametrize("k", KS)
def test_extend_leaf_digests_equals_jax_bottom_leaf_fn(k, construction, monkeypatch):
    monkeypatch.delenv("CELESTIA_RS_XOR", raising=False)
    top = _rand(k, k, 2 * k, SHARE_SIZE)
    want_bottom, want_hashes = jax_bottom_leaf_fn(
        k, construction, fallback_encode=jax_encode_fn(k, construction)
    )(jnp.asarray(top))
    want_bottom, want_hashes = np.asarray(want_bottom), np.asarray(want_hashes)

    codec = RSCodec(k, construction)
    m = codec.field.m
    G_words = codec_tensors(codec.generator_bits(), m, "cpu")["G_words"]
    bottom, hashes = rs_xor.extend_leaf_digests(torch.from_numpy(top), G_words, m)
    assert np.array_equal(bottom.numpy(), want_bottom)
    assert np.array_equal(hashes.numpy(), want_hashes)
    # The port's own CPU branch of bottom_leaf_fn, on either RS seat.
    for xor in ("off", "on"):
        monkeypatch.setenv("CELESTIA_RS_XOR", xor)
        fn = rs_xor.bottom_leaf_fn(k, construction, device="cpu",
                                   fallback_encode=encode_fn(k, construction, "cpu"))
        b2, h2 = fn(torch.from_numpy(top))
        assert np.array_equal(b2.numpy(), want_bottom)
        assert np.array_equal(h2.numpy(), want_hashes)
    msg = b"\x00" + b"\xff" * 29 + want_bottom[k - 1, 2 * k - 1].tobytes()
    assert want_hashes[k - 1, 2 * k - 1].tobytes() == hashlib.sha256(msg).digest()


@pytest.mark.parametrize("construction", CONSTRUCTIONS)
@pytest.mark.parametrize("k", KS)
def test_epilogue_pipeline_equals_jax(k, construction):
    ods = _rand(100 + k, k, k, SHARE_SIZE)
    want = jax_fused.jit_extend_and_dah(k, construction, epilogue=True)(jnp.asarray(ods))
    want_eds, want_rows, want_cols, want_root = (np.asarray(x) for x in want)
    got = fused.extend_and_dah_fn(k, construction, epilogue=True, device="cpu")(
        torch.from_numpy(ods))
    eds, rows, cols, root = (x.numpy() for x in got)
    assert np.array_equal(eds, want_eds)
    assert np.array_equal(rows, want_rows) and np.array_equal(cols, want_cols)
    assert root.tobytes() == want_root.tobytes()
    roots_only = fused.extend_and_dah_fn(k, construction, roots_only=True, epilogue=True,
                                         device="cpu")(torch.from_numpy(ods))
    assert root.tobytes() == roots_only[2].numpy().tobytes()


@pytest.mark.parametrize("value", ["on", "off", "epi", "auto", None])
def test_env_base_mode_equals_jax(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("CELESTIA_PIPE_FUSED", raising=False)
    else:
        monkeypatch.setenv("CELESTIA_PIPE_FUSED", value)
    assert fused.env_base_mode() == jax_fused.env_base_mode()
    assert fused.pipeline_mode() == fused.env_base_mode()


def test_modes_resolve_per_call_and_agree(monkeypatch):
    """Flipping $CELESTIA_PIPE_FUSED between calls changes the lowering the
    next call takes (the cache key holds the mode) and never the bytes."""
    k = 4
    shares = [s.tobytes() for s in _rand(7, k * k, SHARE_SIZE)]
    port_eds._cached_pipeline.cache_clear()
    roots = {}
    for value in ("epi", "off", "on", "epi"):
        monkeypatch.setenv("CELESTIA_PIPE_FUSED", value)
        eds = extend_shares(shares, "leopard", device="cpu")
        roots[value] = (eds.data_root(), eds.row_roots(), eds.squared().tobytes())
    assert len(set((r, tuple(rr), sq) for r, rr, sq in roots.values())) == 1
    info = port_eds._cached_pipeline.cache_info()
    assert (info.currsize, info.hits) == (3, 1)  # one pipeline per mode, epi reused


def test_pipeline_for_mode_checks_its_mode():
    k = 2
    ods = torch.from_numpy(_rand(3, k, k, SHARE_SIZE))
    outs = [port_eds.pipeline_for_mode(mode, k, "vandermonde", "cpu")(ods)
            for mode in port_eds.MODES]
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))
    with pytest.raises(ValueError, match="unknown pipeline mode"):
        port_eds.pipeline_for_mode("panel", k, "vandermonde", "cpu")


def test_bottom_leaf_fn_needs_the_seated_encode():
    with pytest.raises(TypeError):
        rs_xor.bottom_leaf_fn(2, "vandermonde", device="cpu")


def test_epilogue_input_checks():
    codec = RSCodec(2, "vandermonde")
    G_words = codec_tensors(codec.generator_bits(), 8, "cpu")["G_words"]
    with pytest.raises(ValueError):
        rs_xor.extend_leaf_digests(torch.zeros((2, 4, 100), dtype=torch.uint8), G_words, 8)
    with pytest.raises(ValueError):
        rs_xor.extend_leaf_digests(torch.zeros((2, 4, SHARE_SIZE), dtype=torch.uint8),
                                   G_words, 32)
