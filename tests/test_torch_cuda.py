"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The kernels have no CPU mode, so these tests skip without an NVIDIA card;
`python3 chip_smoke.py` runs the same comparisons at the main path's full
shapes.  On a card: `python -m pytest tests/test_torch_cuda.py -m cuda`.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from celestia_app_tpu_torch.convert import codec_tensors
from celestia_app_tpu_torch.gf.rs import RSCodec
from celestia_app_tpu_torch.kernels import _build, rs_dense, rs_xor
from celestia_app_tpu_torch.kernels import sha256 as sha
from celestia_app_tpu_torch.kernels.rs import _encode_with

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode "
                    "(chip_smoke.py runs these comparisons on the card)")
    return torch.device("cuda")


def _bytes(rng, *shape):
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))


@pytest.mark.parametrize("length", [0, 1, 55, 56, 64, 65, 91, 181, 542])
def test_sha256_kernel_equals_plain(cuda, length):
    rng = np.random.default_rng(length)
    for n in (1, 127, 128, 129, 4097):
        msgs = _bytes(rng, n, length)
        before = _build.LAUNCHES["sha256"]
        got = sha.sha256(msgs.to(cuda)).cpu()
        assert _build.LAUNCHES["sha256"] == before + 1
        assert torch.equal(got, sha.sha256_plain(msgs))
        assert got[0].numpy().tobytes() == hashlib.sha256(msgs[0].numpy().tobytes()).digest()


def test_leaf_kernel_equals_plain(cuda):
    rng = np.random.default_rng(1)
    for n in (1, 100, 128, 1000):
        ns, shares = _bytes(rng, n, 29), _bytes(rng, n, 512)
        got = sha.sha256_leaves(ns.to(cuda), shares.to(cuda)).cpu()
        assert torch.equal(got, sha.sha256_leaves_plain(ns, shares))


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
@pytest.mark.parametrize("k", [1, 2, 4, 16, 128, 256])
def test_rs_kernels_equal_plain(cuda, k, construction):
    rng = np.random.default_rng(k)
    codec = RSCodec(k, construction)
    m = codec.field.m
    on_card = codec_tensors(codec.generator_bits(), m, cuda)
    on_cpu = codec_tensors(codec.generator_bits(), m, "cpu")
    for axis, shape in ((1, (k, k, 512)), (0, (k, 2 * k, 512)), (1, (3, k, 40))):
        data = _bytes(rng, *shape)
        want = _encode_with(rs_dense.mod2_matmul_planes_plain, data, on_cpu["G_bits"], m, axis)
        dense = _encode_with(rs_dense.mod2_matmul_planes, data.to(cuda), on_card["G_bits"],
                             m, axis)
        xor = _encode_with(rs_xor.mod2_matmul_planes_xor, data.to(cuda), on_card["G_words"],
                           m, axis)
        assert torch.equal(dense.cpu(), want), (k, construction, axis)
        assert torch.equal(xor.cpu(), want), (k, construction, axis)


@pytest.mark.parametrize("xor", [False, True])
def test_pipeline_on_card_equals_cpu(cuda, xor, monkeypatch):
    from celestia_app_tpu_torch.da import extend_shares

    monkeypatch.setenv("CELESTIA_RS_XOR", "on" if xor else "off")
    rng = np.random.default_rng(7)
    shares = [rng.integers(0, 256, 512, dtype=np.uint8).tobytes() for _ in range(64)]
    on_card = extend_shares(shares, "leopard")
    on_cpu = extend_shares(shares, "leopard", device="cpu")
    assert on_card.row_roots() == on_cpu.row_roots()
    assert on_card.col_roots() == on_cpu.col_roots()
    assert on_card.data_root() == on_cpu.data_root()


@pytest.mark.parametrize("k,construction", [
    (1, "vandermonde"), (2, "leopard"), (4, "vandermonde"), (16, "leopard"),
    (128, "vandermonde"), (256, "leopard"), (256, "vandermonde"),
])
def test_epilogue_kernel_equals_plain(cuda, k, construction):
    """The fused extend + leaf-hash kernel against its plain version on the
    same card tensors; k = 256 runs GF(2^16), where a share's symbol bytes
    come in pairs."""
    rng = np.random.default_rng(k)
    codec = RSCodec(k, construction)
    m = codec.field.m
    G_words = codec_tensors(codec.generator_bits(), m, cuda)["G_words"]
    top = _bytes(rng, k, 2 * k, 512).to(cuda)
    before = _build.LAUNCHES["rs_xor_leaf"]
    bottom, hashes = rs_xor.extend_leaf_digests(top, G_words, m)
    assert _build.LAUNCHES["rs_xor_leaf"] == before + 1
    want_bottom, want_hashes = rs_xor.extend_leaf_digests_plain(top, G_words, m)
    assert torch.equal(bottom, want_bottom), (k, construction)
    assert torch.equal(hashes, want_hashes), (k, construction)
    for i, j in ((0, 0), (k - 1, 2 * k - 1)):
        msg = b"\x00" + b"\xff" * 29 + bottom[i, j].cpu().numpy().tobytes()
        assert hashes[i, j].cpu().numpy().tobytes() == hashlib.sha256(msg).digest()


@pytest.mark.parametrize("xor", [False, True])
def test_epi_pipeline_on_card_equals_cpu(cuda, xor, monkeypatch):
    """CELESTIA_PIPE_FUSED=epi on the card: one epilogue launch per extend,
    the same roots and EDS as the CPU's fused pipeline."""
    from celestia_app_tpu_torch.da import extend_shares

    monkeypatch.setenv("CELESTIA_RS_XOR", "on" if xor else "off")
    rng = np.random.default_rng(8)
    shares = [rng.integers(0, 256, 512, dtype=np.uint8).tobytes() for _ in range(256)]
    on_cpu = extend_shares(shares, "vandermonde", device="cpu")
    monkeypatch.setenv("CELESTIA_PIPE_FUSED", "epi")
    _build.reset_launches()
    on_card = extend_shares(shares, "vandermonde")
    assert _build.LAUNCHES["rs_xor_leaf"] == 1
    assert _build.LAUNCHES["sha256_leaf"] == 1
    assert _build.LAUNCHES["rs_xor" if xor else "rs_dense"] == 1
    assert on_card.data_root() == on_cpu.data_root()
    assert np.array_equal(on_card.squared(), on_cpu.squared())


def test_extend_block_on_card_equals_cpu(cuda, monkeypatch):
    from celestia_app_tpu_torch.app import extend_block

    txs = [bytes([i]) * (100 + 37 * i) for i in range(40)]
    on_cpu = extend_block(txs, device="cpu")
    for mode in ("on", "off", "epi"):
        monkeypatch.setenv("CELESTIA_PIPE_FUSED", mode)
        assert extend_block(txs).data_root() == on_cpu.data_root()
    assert extend_block([]) is None
