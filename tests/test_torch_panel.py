"""The panel-streamed lowering of giant squares (kernels/panel.py) on the CPU.

The same seeded ODS goes through the JAX package's `panel_pipeline` and the
port's, and both must equal the port's staged (materializing) pipeline byte
for byte: EDS, row and column roots, data root.  Both RS constructions,
panel heights that divide k and ones that do not, the roots-only twin, the
FFT column leg ($CELESTIA_RS_FFT=on), and the routing seams: compute,
extend_shares, the speculative extend and the streaming pipeline (batch
forced to 1).  The JAX side compiles one set of small programs per
(k, panel height, construction), so the shapes stay at k <= 16.
"""

from __future__ import annotations

import gc

import jax
import numpy as np
import pytest
import torch

from celestia_app_tpu.kernels import fused as jax_fused
from celestia_app_tpu.kernels import panel as jax_panel
from celestia_app_tpu.parallel import pipeline as jax_pipeline
from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, SHARE_SIZE
from celestia_app_tpu_torch.da import DataAvailabilityHeader, extend_shares
from celestia_app_tpu_torch.da import eds as port_eds
from celestia_app_tpu_torch.da.eds import ExtendedDataSquare, pipeline_for_mode, speculator
from celestia_app_tpu_torch.kernels import fused, panel
from celestia_app_tpu_torch.kernels import rs_dense
from celestia_app_tpu_torch.parallel.pipeline import BlockPipeline, stream_blocks
from celestia_app_tpu_torch.trace import journal


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


K2_HASH = "b56e4d251ac266f4b91cc5464b3fc7efcbdc888064647496d13133f0dc65ac25"

SEAMS = ("CELESTIA_PIPE_PANEL", "CELESTIA_RS_FFT", "CELESTIA_RS_FFT_MD", "CELESTIA_RS_XOR",
         "CELESTIA_PIPE_FUSED", "CELESTIA_EXTEND_SHARDS", "CELESTIA_PIPE_SPECULATE",
         "CELESTIA_RS_CONSTRUCTION", "CELESTIA_PIPE_BATCH")


@pytest.fixture(autouse=True)
def _no_ambient_seams(monkeypatch):
    """Each test sets the seams it needs; none inherits them."""
    for var in SEAMS:
        monkeypatch.delenv(var, raising=False)


def _random_ods(k: int, seed: int) -> np.ndarray:
    """Random shares whose namespaces rise in row-major order."""
    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, (k * k, SHARE_SIZE), dtype=np.uint8)
    ods[:, :NAMESPACE_SIZE] = 0
    ods[:, NAMESPACE_SIZE - 2:NAMESPACE_SIZE] = np.sort(
        rng.integers(0, 2**16, k * k)).astype(">u2").view(np.uint8).reshape(-1, 2)
    return ods.reshape(k, k, SHARE_SIZE)


def _staged(ods: np.ndarray, construction: str):
    k = ods.shape[0]
    return pipeline_for_mode("staged", k, construction, "cpu")(torch.from_numpy(ods))


def _assert_outputs_equal(got, want) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b)


# --- the seam functions --------------------------------------------------------

SEAM_VALUES = ["", "off", "0", "OFF", "auto", " Auto ", "1", "5", "48", "64", "5000", "-3",
               "bogus", "1.5"]


@pytest.mark.parametrize("val", SEAM_VALUES)
def test_seam_functions_equal_jax(val, monkeypatch, capsys):
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", val)
    monkeypatch.setattr(panel, "_WARNED_MALFORMED", set())
    monkeypatch.setattr(jax_panel, "_WARNED_MALFORMED", set())
    # The JAX pipeline_mode_for_k also walks its degradation ladder, which
    # the port does not have: the port's equals the JAX base mode.
    for k in (1, 2, 16, 256, 512, 1024, 2048):
        assert panel.panel_rows(k) == jax_panel.panel_rows(k), k
        assert panel.panel_count(k) == jax_panel.panel_count(k), k
        assert fused.env_base_mode_for_k(k) == jax_fused.env_base_mode_for_k(k), k
        assert fused.pipeline_mode_for_k(k) == jax_fused.env_base_mode_for_k(k), k
    err = capsys.readouterr().err
    # A malformed value warns once per process and value, in the JAX words.
    malformed = val.strip().lower() in ("bogus", "1.5")
    port_lines = [ln for ln in err.splitlines() if "CELESTIA_PIPE_PANEL" in ln]
    assert len(port_lines) == (2 if malformed else 0)
    if malformed:
        assert port_lines[0] == port_lines[1]


@pytest.mark.parametrize("fused_env", ["on", "off", "epi"])
def test_mode_for_k_falls_to_the_fused_seam(fused_env, monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_FUSED", fused_env)
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "auto")
    for k in (128, 256, 512, 2048):
        assert fused.pipeline_mode_for_k(k) == jax_fused.env_base_mode_for_k(k)
    assert fused.pipeline_mode_for_k(512) == "panel"
    assert fused.pipeline_mode_for_k(256) == fused.pipeline_mode()


@pytest.mark.parametrize("k", [1, 2, 7, 16, 512, 2048])
@pytest.mark.parametrize("rows", [1, 3, 5, 48, 64, 4096])
def test_panel_bounds_equal_jax(k, rows):
    bounds = panel.panel_bounds(k, rows)
    assert bounds == jax_panel.panel_bounds(k, rows)
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


# --- the runner against the JAX package and the staged pipeline ---------------

CASES = [(2, 1), (8, 4), (8, 3), (16, 8), (16, 5)]


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
@pytest.mark.parametrize("k,rows", CASES)
def test_panel_pipeline_equals_jax_and_staged(k, rows, construction, monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", str(rows))
    ods = _random_ods(k, seed=100 * k + rows)
    want = _staged(ods, construction)
    got = panel.panel_pipeline(k, construction, device="cpu")(ods)
    _assert_outputs_equal(got, want)
    _assert_outputs_equal(jax_panel.panel_pipeline(k, construction)(ods), want)
    # The roots-only twin: the same roots and no square.
    twin = panel.panel_pipeline(k, construction, roots_only=True, device="cpu")(ods)
    _assert_outputs_equal(twin, want[1:])
    _assert_outputs_equal(jax_panel.panel_pipeline(k, construction, roots_only=True)(ods),
                          want[1:])


@pytest.mark.parametrize("md", ["0", "1"])
@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
@pytest.mark.parametrize("k,rows", [(8, 3), (16, 5)])
def test_panel_fft_leg_equals_jax_and_staged(k, rows, construction, md, monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", str(rows))
    monkeypatch.setenv("CELESTIA_RS_FFT", "on")
    monkeypatch.setenv("CELESTIA_RS_FFT_MD", md)
    ods = _random_ods(k, seed=7 * k + rows)
    monkeypatch.setenv("CELESTIA_RS_FFT", "off")
    want = _staged(ods, construction)
    monkeypatch.setenv("CELESTIA_RS_FFT", "on")
    run = panel.panel_pipeline(k, construction, device="cpu")
    assert run is panel._panel_runner(k, construction, False, rows, ("fft", md == "1"),
                                      torch.device("cpu"))
    _assert_outputs_equal(run(ods), want)
    _assert_outputs_equal(panel.panel_pipeline(k, construction, roots_only=True,
                                               device="cpu")(ods), want[1:])
    _assert_outputs_equal(jax_panel.panel_pipeline(k, construction)(ods), want)


@pytest.mark.parametrize("xor", ["off", "on"])
def test_panel_row_phase_follows_the_rs_core(xor, monkeypatch):
    """Under $CELESTIA_RS_XOR=on the row phase runs the XOR core and the
    column partials stay dense; the bytes do not change."""
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "3")
    monkeypatch.setenv("CELESTIA_RS_XOR", xor)
    ods = _random_ods(8, seed=3)
    _assert_outputs_equal(panel.panel_pipeline(8, "leopard", device="cpu")(ods),
                          _staged(ods, "leopard"))


def test_panel_inputs_list_tensor_and_shape_checks(monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "3")
    ods = _random_ods(8, seed=11)
    run = panel.panel_pipeline(8, "vandermonde", device="cpu")
    want = run(ods)
    bounds = panel.panel_bounds(8, 3)
    as_list = [torch.from_numpy(ods[r0:r1].copy()) for r0, r1 in bounds]
    _assert_outputs_equal(run(as_list), want)
    _assert_outputs_equal(run([ods[r0:r1] for r0, r1 in bounds]), want)
    _assert_outputs_equal(run(torch.from_numpy(ods)), want)
    with pytest.raises(ValueError):
        run(as_list[:-1])
    with pytest.raises(ValueError):
        run([as_list[1], as_list[0], as_list[2]][::-1])
    with pytest.raises(ValueError):
        run(ods[:4])
    with pytest.raises(ValueError):
        run(torch.from_numpy(ods).to(torch.int16))
    # The input is never written.
    assert np.array_equal(ods, _random_ods(8, seed=11))


def test_runner_cache_follows_the_resolved_configuration(monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "3")
    a = panel.panel_pipeline(8, "vandermonde", device="cpu")
    assert panel.panel_pipeline(8, "vandermonde", device="cpu") is a
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "5")
    assert panel.panel_pipeline(8, "vandermonde", device="cpu") is not a
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "3")
    monkeypatch.setenv("CELESTIA_RS_FFT", "on")
    assert panel.panel_pipeline(8, "vandermonde", device="cpu") is not a
    monkeypatch.setenv("CELESTIA_RS_FFT", "auto")
    assert panel.panel_pipeline(8, "vandermonde", device="cpu") is a
    assert panel.panel_pipeline(8, "vandermonde", roots_only=True, device="cpu") is not a


def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        panel.panel_pipeline(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExtendedDataSquare.compute(_random_ods(4, seed=1))


def test_col_generator_slices_are_tma_aligned():
    """At m=8 a panel starting on an odd row begins 8 bytes into a 16-byte
    generator row: each cached slice is its own aligned buffer."""
    bounds = panel.panel_bounds(16, 5)
    slices = panel._col_generator_slices(16, "leopard", bounds, torch.device("cpu"))
    from celestia_app_tpu_torch.gf.rs import codec_for_width

    g = codec_for_width(16, "leopard").generator_bits()
    for (r0, r1), s in zip(bounds, slices):
        assert s.data_ptr() % rs_dense.TMA_ALIGN == 0 and s.stride(0) % rs_dense.TMA_ALIGN == 0
        assert np.array_equal(s.numpy(), g[:, r0 * 8:r1 * 8])


def test_tma_rows_copies_a_misaligned_view():
    base = torch.arange(16 * 48, dtype=torch.int16).to(torch.int8).reshape(16, 48)
    view = base[:, 8:24]  # row stride 48, base 8 bytes in
    out = rs_dense.tma_rows(view)
    assert out.data_ptr() % rs_dense.TMA_ALIGN == 0 and torch.equal(out, view)
    aligned = base[:, 16:40]
    assert rs_dense.tma_rows(aligned).data_ptr() == aligned.data_ptr()


# --- the routing seams --------------------------------------------------------


def test_k2_golden_through_one_row_panels(monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "1")
    ns = bytes([0x00]) + bytes(18) + bytes([0x01]) * 10
    share = ns + b"\xff" * (SHARE_SIZE - NAMESPACE_SIZE)
    eds = extend_shares([share] * 4, device="cpu")
    assert DataAvailabilityHeader.from_eds(eds).hash().hex() == K2_HASH
    row = journal.rows("compute")[-1]
    assert row["mode"] == "panel" and row["panels"] == 2


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
def test_compute_journals_panels(construction, monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "3")
    port_eds._cached_pipeline.cache_clear()
    ods = _random_ods(8, seed=21)
    want = _staged(ods, construction)
    first = ExtendedDataSquare.compute(ods, construction, device="cpu")
    row = journal.rows("compute")[-1]
    assert (row["mode"], row["panels"], row["compile"], row["k"]) == ("panel", 3, "miss", 8)
    again = ExtendedDataSquare.compute(torch.from_numpy(ods), construction, device="cpu")
    assert journal.rows("compute")[-1]["compile"] == "hit"
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "5")
    ExtendedDataSquare.compute(ods, construction, device="cpu")
    row = journal.rows("compute")[-1]
    assert (row["panels"], row["compile"]) == (2, "miss")
    for eds in (first, again):
        _assert_outputs_equal((eds._eds, eds._row_roots, eds._col_roots, eds._data_root), want)
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "off")
    ExtendedDataSquare.compute(ods, construction, device="cpu")
    assert "panels" not in journal.rows("compute")[-1]


def test_speculation_under_panel_mode(monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "3")
    monkeypatch.setenv("CELESTIA_PIPE_SPECULATE", "on")
    ods = _random_ods(8, seed=5)
    spec = speculator()
    hits = spec.outcomes["hit"]
    assert spec.speculate(ods, device="cpu")
    eds = ExtendedDataSquare.compute(ods, device="cpu")
    assert spec.outcomes["hit"] == hits + 1
    assert journal.rows("compute")[-1]["mode"] == "panel"
    _assert_outputs_equal((eds._eds, eds._data_root), (_staged(ods, "vandermonde")[0],
                                                       _staged(ods, "vandermonde")[3]))


@pytest.mark.parametrize("construction", ["vandermonde", "leopard"])
def test_stream_under_panel_mode_equals_jax(construction, monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "3")
    monkeypatch.setenv("CELESTIA_RS_CONSTRUCTION", construction)
    squares = [(f"h{i}", _random_ods(8, seed=40 + i)) for i in range(5)]
    before = len(journal.rows("stream"))
    got = list(stream_blocks(iter(squares), 8, depth=2, batch=3, device="cpu"))
    want = list(jax_pipeline.stream_blocks(iter(squares), 8, depth=2, batch=3))
    assert [t for t, _ in got] == [t for t, _ in want] == [t for t, _ in squares]
    for (_, a), (_, b), (_, ods) in zip(got, want, squares):
        assert a.data_root() == b.data_root()
        assert a.row_roots() == b.row_roots() and a.col_roots() == b.col_roots()
        assert np.array_equal(a.squared(), np.asarray(b.squared()))
        assert a.data_root() == _staged(ods, construction)[3].numpy().tobytes()
    rows = journal.rows("stream")[before:]
    assert len(rows) == 5
    assert all(r["mode"] == "panel" and r["batch_size"] == 1 and r["panels"] == 3
               for r in rows)


def test_block_pipeline_forces_batch_one_and_stages_on_the_host(monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "2")
    pipe = BlockPipeline(4, depth=2, batch=4, device="cpu")
    try:
        assert pipe.batch == 1 and pipe._panel == 2 and pipe._mode == "panel"
        ods = _random_ods(4, seed=9)
        pipe.submit(ods, "a")
        ((tag, eds),) = list(pipe.drain())
    finally:
        pipe.close()
    assert tag == "a"
    _assert_outputs_equal((eds._eds, eds._data_root),
                          (_staged(ods, "vandermonde")[0], _staged(ods, "vandermonde")[3]))


def test_a_faulting_panel_raises_out_of_compute_and_the_stream(monkeypatch):
    """A faulting panel steps the degradation ladder to the materializing
    base (the same bytes); a fault that outlasts the ladder (every rung's
    dispatch fails) raises out of compute and out of the stream."""
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.chaos import degrade

    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "2")
    monkeypatch.setenv("CELESTIA_PIPE_FUSED", "on")

    def boom(*_a, **_k):
        raise RuntimeError("injected panel fault")

    monkeypatch.setattr(panel, "xor_encode_into", boom)
    ods = _random_ods(4, seed=13)
    try:
        eds = ExtendedDataSquare.compute(ods, device="cpu")
        assert journal.rows("compute")[-1]["mode"] == "fused"
        assert degrade.degraded_state() == {"device": "fused"}
        _assert_outputs_equal((eds._eds, eds._data_root),
                              (_staged(ods, "vandermonde")[0], _staged(ods, "vandermonde")[3]))
        chaos.install("seed=13,dispatch_fail=1.0,dispatch_fail_all=1")
        before = len(journal.rows("compute"))
        with pytest.raises(RuntimeError, match="injected dispatch_fail"):
            ExtendedDataSquare.compute(ods, device="cpu")
        assert len(journal.rows("compute")) == before  # nothing computed, nothing journaled
        with pytest.raises(RuntimeError, match="pipeline feeder failed") as info:
            list(stream_blocks(iter([("a", ods), ("b", ods)]), 4, depth=2, device="cpu"))
        assert "injected dispatch_fail" in repr(info.value.__cause__)
    finally:
        chaos.uninstall()
        degrade.reset_for_tests()
