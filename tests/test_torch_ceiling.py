"""The codec ceiling, k=4096, on the CPU: what the port decides and counts
at that size without allocating a square of it (chip_smoke.phase_ceiling
runs the square itself on the card):

  * under the recipe the JAX package's k=4096 smoke runs
    ($CELESTIA_PIPE_PANEL=auto, $CELESTIA_EXTEND_SHARDS=8), the panel
    height, the panel count, the shard count, the per-shard schedule and
    the selected lowering equal the JAX package's;
  * the square-size gate takes 4096 and refuses 8192, in both packages;
  * chip_smoke's launch formulas give the counts the phase holds the card
    to (128 rs_dense, 128 sha256_leaves, 41 sha256_batch per square);
  * the generator bit-expanded on the device (convert.expand_bits_tensor,
    the one the kernels read) is byte-equal to gf/field.expand_bit_matrix
    and to the JAX package's generator bits, with the padded row stride;
  * the panel's column partials XOR straight into the accumulator
    (kernels/rs.xor_encode_into) the bytes encode_axis gives, and their
    generator slices are views of the resident generator at m=16;
  * trace/device_ledger.release_device_caches empties every cache the
    extend and repair paths register and the next square is built again
    with the same roots;
  * chip_smoke.host_line_root, the phase's host-side root check, equals
    the roots of ExtendedDataSquare.compute.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

import chip_smoke
from celestia_app_tpu.constants import MAX_CODEC_SQUARE_SIZE as JAX_MAX
from celestia_app_tpu.da.eds import ExtendedDataSquare as JaxEDS
from celestia_app_tpu.gf.rs import RSCodec as JaxRSCodec
from celestia_app_tpu.kernels import fused as jax_fused
from celestia_app_tpu.kernels import panel as jax_panel
from celestia_app_tpu.kernels import panel_sharded as jax_ps
from celestia_app_tpu_torch.chaos import degrade
from celestia_app_tpu_torch.constants import MAX_CODEC_SQUARE_SIZE
from celestia_app_tpu_torch.convert import expand_bits_tensor
from celestia_app_tpu_torch.da import eds as eds_mod
from celestia_app_tpu_torch.gf.rs import RSCodec, codec_for_width
from celestia_app_tpu_torch.kernels import fft, fused, panel, panel_sharded, rs
from celestia_app_tpu_torch.kernels.rs import encode_axis, generator_tensor, xor_encode_into
from celestia_app_tpu_torch.parallel import sharded_eds
from celestia_app_tpu_torch.trace import device_ledger, journal

repair = importlib.import_module("celestia_app_tpu_torch.da.repair")

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean():
    degrade.reset_for_tests()
    yield
    degrade.reset_for_tests()


@pytest.mark.parametrize("shards", ["8", ""])
def test_recipe_decisions_equal_the_jax_package(monkeypatch, shards):
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "auto")
    monkeypatch.setenv("CELESTIA_EXTEND_SHARDS", shards)
    k = 4096
    assert panel.panel_rows(k) == jax_panel.panel_rows(k) == 64
    assert panel.panel_count(k) == jax_panel.panel_count(k) == 64
    want_shards = 8 if shards else 0
    assert panel_sharded.shards_for_k(k, CPU) == jax_ps.shards_for_k(k) == want_shards
    assert fused.pipeline_mode_for_k(k, CPU) == jax_fused.pipeline_mode_for_k(k) == (
        "sharded_panel" if shards else "panel")
    if shards:
        assert panel_sharded.local_panel_bounds(k, 8) == jax_ps.local_panel_bounds(k, 8)
        assert panel_sharded.sharded_panel_count(k, CPU) == 8
        assert panel_sharded.local_panel_bounds(k, 4) == tuple(
            (r, r + 64) for r in range(0, 1024, 64))


def test_square_size_gate_takes_the_ceiling_and_refuses_twice_it():
    assert MAX_CODEC_SQUARE_SIZE == JAX_MAX == 4096
    eds_mod._check_square(4096)
    with pytest.raises(ValueError, match="invalid square size 8192"):
        eds_mod._check_square(8192)
    # A zero-stride view: the gate refuses before a byte of it is read.
    huge = np.broadcast_to(np.zeros(1, dtype=np.uint8), (8192, 8192, 512))
    with pytest.raises(ValueError, match="invalid square size 8192"):
        eds_mod.ExtendedDataSquare.compute(huge, device="cpu")
    with pytest.raises(ValueError, match="invalid square size 8192"):
        JaxEDS.compute(huge)


def test_launch_formulas_at_the_ceiling():
    assert chip_smoke.giant_launches(4096, "panel auto", 64) == {
        "sha256": 41, "rs_dense": 128, "rs_xor": 0, "rs_dense_leaf": 0, "sha256_leaf": 128}
    per_shard = chip_smoke.mesh_launches(4096, 4, 64)
    assert [s["rs_dense"] for s in per_shard] == [32] * 4
    assert [s["sha256_leaf"] for s in per_shard] == [17] * 4
    assert [s["sha256"] for s in per_shard] == [41, 23, 23, 23]


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
@pytest.mark.parametrize("k", [16, 256])
def test_generator_bits_built_on_the_device_equal_the_host_expansion(k, construction):
    codec = RSCodec(k, construction)
    got = expand_bits_tensor(codec.field, codec.generator, CPU)
    host = codec.field.expand_bit_matrix(codec.generator)
    assert torch.equal(got, torch.from_numpy(host.astype(np.int8)))
    assert np.array_equal(got.numpy(), JaxRSCodec(k, construction).generator_bits())
    assert got.stride(0) % 16 == 0 and got.data_ptr() % 16 == 0
    m, cached = generator_tensor(k, construction, CPU)
    assert m == codec.field.m and torch.equal(cached, got)
    assert generator_tensor(k, construction, "cpu")[1] is cached


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
def test_xor_encode_into_equals_encode_axis(construction):
    k, rows = 16, 5
    m, G = generator_tensor(k, construction, CPU)
    rng = np.random.default_rng(3)
    ext = torch.from_numpy(rng.integers(0, 256, (rows, 2 * k, 512), dtype=np.uint8))
    acc0 = torch.from_numpy(rng.integers(0, 256, (k, 2 * k, 512), dtype=np.uint8))
    g = G[:, 3 * m:(3 + rows) * m]
    acc = acc0.clone()
    xor_encode_into(acc, ext, g, m)
    assert torch.equal(acc, acc0 ^ encode_axis(ext, g, m, contract_axis=0))
    with pytest.raises(ValueError, match="accumulator"):
        xor_encode_into(acc[:-1], ext, g, m)


def test_panel_slices_are_views_of_the_generator_at_m16():
    k = 256
    bounds = panel.panel_bounds(k, 64)
    slices = panel._col_generator_slices(k, "vandermonde", bounds, CPU)
    m, G = generator_tensor(k, "vandermonde", CPU)
    assert m == 16
    for (r0, r1), s in zip(bounds, slices):
        assert s.untyped_storage().data_ptr() == G.untyped_storage().data_ptr()
        assert torch.equal(s, G[:, r0 * m:r1 * m])


def test_release_device_caches_empties_them_and_rebuilds(monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "4")
    ods = chip_smoke.random_square(16, seed=5)
    first = eds_mod.ExtendedDataSquare.compute(ods, device="cpu")
    assert panel._panel_runner.cache_info().currsize and rs._generator_tensor.cache_info().currsize
    device_ledger.release_device_caches()
    for cache in (panel._panel_runner, panel._col_generator_slices, rs._generator_tensor,
                  rs._generator_words, eds_mod._cached_pipeline, eds_mod._cached_batched_pipeline,
                  panel_sharded._sharded_runner, panel_sharded._owner_generator_slices,
                  sharded_eds._cached_pipeline, fft._device_groups, repair._recover_bits_device,
                  repair._recover_bits_missing, repair._stacked_sweep_inputs,
                  repair._sweep_program):
        assert cache.cache_info().currsize == 0
    assert not (eds_mod._BUILT or panel._PANEL_WARM or panel_sharded._SHARDED_WARM)
    owned = device_ledger.reconcile("cpu")["owners"]
    assert owned.get("codec_tensors", 0) == owned.get("panel_generator_slices", 0) == 0
    again = eds_mod.ExtendedDataSquare.compute(ods, device="cpu")
    assert journal.rows("compute")[-1]["compile"] == "miss"
    assert again.data_root() == first.data_root() and again.row_roots() == first.row_roots()


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
def test_host_line_root_equals_the_computed_roots(construction):
    k = 8
    ods = chip_smoke.random_square(k, seed=9)
    eds = eds_mod.ExtendedDataSquare.compute(ods, construction, device="cpu")
    codec = codec_for_width(k, construction)
    rows, cols = eds.row_roots(), eds.col_roots()
    for i in (0, 5, k - 1):
        assert chip_smoke.host_line_root(codec, ods, "row", i) == rows[i]
        assert chip_smoke.host_line_root(codec, ods, "col", i) == cols[i]
