"""The port's fused_epi lowering on the CPU, byte-identical to the JAX package.

On the CPU `extend_leaf_digests` runs its plain version and `bottom_leaf_fn`
the seated encode followed by the leaf digests, as the JAX package does off
the TPU; tests/test_rs_xor.py holds that composition to the Pallas kernel
in interpret mode, and tests/test_torch_cuda.py holds the CUDA kernel to
the plain version on the card.
"""

from __future__ import annotations

import gc
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_app_tpu.kernels import fused as jax_fused
from celestia_app_tpu.kernels.rs import encode_fn as jax_encode_fn
from celestia_app_tpu.kernels.rs_xor import bottom_leaf_fn as jax_bottom_leaf_fn
from celestia_app_tpu_torch.constants import SHARE_SIZE
from celestia_app_tpu_torch.da import eds as port_eds
from celestia_app_tpu_torch.da import extend_shares
from celestia_app_tpu_torch.gf.rs import RSCodec
from celestia_app_tpu_torch.kernels import fused, rs_xor
from celestia_app_tpu_torch.kernels.rs import encode_fn, generator_tensor, generator_words


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
    G_bits = generator_tensor(k, construction, "cpu")[1]
    bottom, hashes = rs_xor.extend_leaf_digests(torch.from_numpy(top), G_bits, m)
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


def test_pipeline_for_mode_checks_its_mode(monkeypatch):
    k = 2
    ods = torch.from_numpy(_rand(3, k, k, SHARE_SIZE))
    # "sharded_panel" needs its seams engaged at k (2 CPU shards, 1-row panels).
    monkeypatch.setenv("CELESTIA_EXTEND_SHARDS", "2")
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "1")
    outs = [port_eds.pipeline_for_mode(mode, k, "vandermonde", "cpu")(ods)
            for mode in port_eds.MODES]
    for out in outs[1:]:
        assert all(np.array_equal(np.asarray(a.numpy() if hasattr(a, "numpy") else a),
                                  b.numpy()) for a, b in zip(out, outs[0]))
    with pytest.raises(ValueError, match="unknown pipeline mode"):
        port_eds.pipeline_for_mode("sharded", k, "vandermonde", "cpu")


def test_bottom_leaf_fn_needs_the_seated_encode():
    with pytest.raises(TypeError):
        rs_xor.bottom_leaf_fn(2, "vandermonde", device="cpu")


def test_epilogue_input_checks():
    G_bits = generator_tensor(2, "vandermonde", "cpu")[1]
    with pytest.raises(ValueError):
        rs_xor.extend_leaf_digests(torch.zeros((2, 4, 100), dtype=torch.uint8), G_bits, 8)
    with pytest.raises(ValueError):
        rs_xor.extend_leaf_digests(torch.zeros((2, 4, SHARE_SIZE), dtype=torch.uint8),
                                   G_bits, 32)
    with pytest.raises(ValueError):  # 3 rows of top against a generator for 2
        rs_xor.extend_leaf_digests(torch.zeros((3, 4, SHARE_SIZE), dtype=torch.uint8),
                                   G_bits, 8)
    with pytest.raises(ValueError):  # the packed XOR words are not the epilogue's operand
        rs_xor.extend_leaf_digests(torch.zeros((2, 4, SHARE_SIZE), dtype=torch.uint8),
                                   generator_words(2, "vandermonde", "cpu")[1], 8)


def _gf2_parity_shares(G: np.ndarray, top: np.ndarray, m: int) -> np.ndarray:
    """numpy reference of the column-phase product: bit t of byte b of
    symbol s of share j is contraction index j*m + 8b + t (LSB first)."""
    n, n2, S = top.shape
    bps = m // 8
    sym = top.reshape(n, n2, S // bps, bps)
    bits = np.unpackbits(sym[..., None], axis=-1, bitorder="little")  # (n, n2, nsym, bps, 8)
    x = bits.transpose(0, 3, 4, 1, 2).reshape(n * m, n2 * (S // bps)).astype(np.int64)
    par = (G.astype(np.int64) @ x) & 1  # (P*m, n2*nsym)
    P = G.shape[0] // m
    out = par.reshape(P, bps, 8, n2, S // bps).transpose(0, 3, 4, 1, 2)
    return np.packbits(out.astype(np.uint8), axis=-1, bitorder="little").reshape(P, n2, S)


@pytest.mark.parametrize("m", [8, 16])
@pytest.mark.parametrize("n,P,n2", [(3, 5, 7), (17, 9, 3), (40, 24, 5), (1, 1, 1)])
def test_plain_epilogue_on_random_generators(n, P, n2, m):
    """Non-square random 0/1 generators (P != n): the plain version equals a
    numpy GF(2) product and hashlib leaf digests under the parity namespace."""
    rng = np.random.default_rng(n * 1000 + P * 10 + m)
    G = rng.integers(0, 2, (P * m, n * m), dtype=np.int8)
    top = rng.integers(0, 256, (n, n2, SHARE_SIZE), dtype=np.uint8)
    bottom, hashes = rs_xor.extend_leaf_digests(torch.from_numpy(top), torch.from_numpy(G), m)
    want = _gf2_parity_shares(G, top, m)
    assert np.array_equal(bottom.numpy(), want)
    for p in range(P):
        for b in range(n2):
            msg = b"\x00" + b"\xff" * 29 + want[p, b].tobytes()
            assert hashes[p, b].numpy().tobytes() == hashlib.sha256(msg).digest()


@pytest.mark.parametrize("m", [8, 16])
def test_leaf_operands_share_order(m):
    """The kernel's data operand is the half square's rows as they lie: at
    m=8 they are the byte planes, at m=16 bytes 2c and 2c + 1 of row j are
    byte rows 2j and 2j + 1 of plane column c (the order the kernel's
    producer de-interleaves).  The generator comes back with a row stride
    that TMA takes, equal in value."""
    from celestia_app_tpu_torch.kernels.rs_dense import TMA_ALIGN

    rng = np.random.default_rng(m)
    if m == 8:  # k=1: 8-byte generator rows, padded to 16
        k = 1
        G = torch.from_numpy(RSCodec(k, "vandermonde").generator_bits().astype(np.int8))
    else:
        k = 2
        G = torch.from_numpy(rng.integers(0, 2, (3 * m, k * m), dtype=np.int8))
    top = torch.from_numpy(rng.integers(0, 256, (k, 2 * k, SHARE_SIZE), dtype=np.uint8))
    G_tma, rows = rs_xor.leaf_operands(top, G, m)
    assert torch.equal(G_tma, G) and G_tma.stride(0) % TMA_ALIGN == 0
    assert rows.shape == (k, 2 * k * SHARE_SIZE) and rows.stride(0) % TMA_ALIGN == 0
    assert rows.data_ptr() == top.data_ptr()  # no copy of a contiguous half square
    bps = m // 8
    planes = top.reshape(k, 2 * k, SHARE_SIZE // bps, bps).movedim(3, 1).reshape(k * bps, -1)
    de_interleaved = rows.reshape(k, -1, bps).permute(0, 2, 1).reshape(k * bps, -1)
    assert torch.equal(de_interleaved, planes)
