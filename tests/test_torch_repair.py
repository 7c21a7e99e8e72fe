"""The port's erasure repair on the CPU, held against the JAX package's.

Each damaged square (from a numpy seed) goes through the JAX
`da.repair.repair` and the port's `repair(..., device="cpu")`; the repaired
squares, the row and column roots and the data root must be byte-identical,
and both must raise the same errors.  The JAX side compiles one program set
per (k, construction, pipeline mode), a few seconds each on the CPU, so the
cases share few of them.
"""

from __future__ import annotations

import gc
import importlib

import jax
import numpy as np
import pytest
import torch

from celestia_app_tpu.da import DataAvailabilityHeader as JaxDAH
from celestia_app_tpu.da import IrrecoverableSquare as JaxIrrecoverable
from celestia_app_tpu.da import RootMismatch as JaxRootMismatch
from celestia_app_tpu.da import repair as jax_repair
from celestia_app_tpu.gf.rs import RSCodec as JaxRSCodec
from celestia_app_tpu.kernels.rs import decode_axis_fn as jax_decode_axis_fn
from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, SHARE_SIZE
from celestia_app_tpu_torch.convert import expand_bits_tensor
from celestia_app_tpu_torch.da import (
    DataAvailabilityHeader,
    IrrecoverableSquare,
    RootMismatch,
    extend_shares,
    repair,
)
from celestia_app_tpu_torch.gf.rs import codec_for_width
from celestia_app_tpu_torch.kernels.rs import decode_axis_fn


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


CONSTRUCTIONS = ("vandermonde", "leopard")
# The module, which da/__init__ shadows with its `repair` function.
repair_mod = importlib.import_module("celestia_app_tpu_torch.da.repair")


def _square(k: int, construction: str, seed: int):
    """A namespace-ordered random ODS extended by the port on the CPU:
    (full EDS numpy, port DAH, JAX DAH with the same roots)."""
    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, (k * k, SHARE_SIZE), dtype=np.uint8)
    ods[:, :NAMESPACE_SIZE] = 0
    ods[:, NAMESPACE_SIZE - 1] = np.sort(rng.integers(0, 200, k * k))
    eds = extend_shares([s.tobytes() for s in ods], construction, device="cpu")
    dah = DataAvailabilityHeader.from_eds(eds)
    return eds.squared(), dah, JaxDAH(row_roots=dah.row_roots, column_roots=dah.column_roots)


def _damaged(full: np.ndarray, present: np.ndarray) -> np.ndarray:
    return np.where(present[..., None], full, 0).astype(np.uint8)


def _threshold_mask(k: int, rng) -> np.ndarray:
    """A random erasure at the 25 % threshold: k random rows keep k random
    shares each, k*k of the 4k^2.  Each kept row decodes on its own
    pattern; the columns then decode from those rows."""
    present = np.zeros((2 * k, 2 * k), dtype=bool)
    for r in rng.choice(2 * k, size=k, replace=False):
        present[r, rng.choice(2 * k, size=k, replace=False)] = True
    return present


def _both(full, present, jax_dah, port_dah, monkeypatch, construction):
    """Repair one damaged square with both packages; assert byte equality
    with each other and with the original square."""
    monkeypatch.setenv("CELESTIA_RS_CONSTRUCTION", construction)
    damaged = _damaged(full, present)
    before = damaged.copy()
    want = jax_repair(damaged.copy(), present, jax_dah)
    got = repair(damaged, present, port_dah, device="cpu")
    assert np.array_equal(damaged, before), "repair modified its input"
    assert np.array_equal(got.squared(), np.asarray(want.squared()))
    assert np.array_equal(got.squared(), full)
    assert got.row_roots() == want.row_roots()
    assert got.col_roots() == want.col_roots()
    assert got.data_root() == want.data_root()
    return got


@pytest.mark.parametrize("construction", CONSTRUCTIONS)
@pytest.mark.parametrize("quadrant", ["Q0", "Q3"])
@pytest.mark.parametrize("k", [4, 8])
def test_quadrant_erasure_matches_jax(k, quadrant, construction, monkeypatch):
    full, dah, jax_dah = _square(k, construction, seed=k)
    present = np.ones((2 * k, 2 * k), dtype=bool)
    rows = slice(0, k) if quadrant == "Q0" else slice(k, 2 * k)
    present[rows, rows] = False
    _both(full, present, jax_dah, dah, monkeypatch, construction)


@pytest.mark.parametrize("k", [8, 16])
def test_random_threshold_erasure_matches_jax(k, monkeypatch):
    full, dah, jax_dah = _square(k, "vandermonde", seed=100 + k)
    rng = np.random.default_rng(k)
    for _ in range(2):
        _both(full, _threshold_mask(k, rng), jax_dah, dah, monkeypatch, "vandermonde")


def _row_only(k):
    present = np.ones((2 * k, 2 * k), dtype=bool)
    present[[1, 3, 5, 6], :] = False  # 4 of 8 rows gone, k survive per column
    return present


def _col_only(k):
    present = np.ones((2 * k, 2 * k), dtype=bool)
    present[:, [0, 2, 4, 7]] = False
    return present


def _parity_crossword(k):
    """Row 0 keeps 2 < k shares; the columns restore it."""
    present = np.ones((2 * k, 2 * k), dtype=bool)
    present[0, 2:] = False
    return present


def _ods_crossword(k):
    """Row 0 has k-1 < k survivors and lost ODS data; the columns restore it."""
    present = np.ones((2 * k, 2 * k), dtype=bool)
    present[0, :k + 1] = False
    return present


@pytest.mark.parametrize("pattern", [_row_only, _col_only, _parity_crossword, _ods_crossword],
                         ids=["row_only", "col_only", "parity_crossword", "ods_crossword"])
def test_axis_and_crossword_erasures_match_jax(pattern, monkeypatch):
    k = 4
    full, dah, jax_dah = _square(k, "vandermonde", seed=4)
    _both(full, pattern(k), jax_dah, dah, monkeypatch, "vandermonde")


@pytest.mark.parametrize("fused", ["on", "epi", "off"])
def test_pipeline_modes_match_jax(fused, monkeypatch):
    """The re-extension in each lowering $CELESTIA_PIPE_FUSED selects (the
    JAX package also runs the per-group sweep under "off")."""
    monkeypatch.setenv("CELESTIA_PIPE_FUSED", fused)
    k = 4
    full, dah, jax_dah = _square(k, "vandermonde", seed=4)
    present = np.ones((2 * k, 2 * k), dtype=bool)
    present[:k, :k] = False
    _both(full, present, jax_dah, dah, monkeypatch, "vandermonde")
    _both(full, _threshold_mask(k, np.random.default_rng(5)), jax_dah, dah, monkeypatch,
          "vandermonde")


@pytest.mark.parametrize("construction", CONSTRUCTIONS)
@pytest.mark.parametrize("k", [4, 8])
def test_sweep_modes_give_the_same_square(k, construction, monkeypatch):
    """$CELESTIA_REPAIR_SWEEP batched == grouped: squares and roots, on a
    quadrant and a threshold erasure; the grouped port equals the grouped
    JAX repair too."""
    full, dah, jax_dah = _square(k, construction, seed=200 + k)
    q0 = np.ones((2 * k, 2 * k), dtype=bool)
    q0[:k, :k] = False
    for present in (q0, _threshold_mask(k, np.random.default_rng(k))):
        monkeypatch.setenv("CELESTIA_REPAIR_SWEEP", "grouped")
        grouped = _both(full, present, jax_dah, dah, monkeypatch, construction)
        monkeypatch.setenv("CELESTIA_REPAIR_SWEEP", "batched")
        batched = repair(_damaged(full, present), present, dah, device="cpu")
        assert np.array_equal(grouped.squared(), batched.squared())
        assert grouped.row_roots() == batched.row_roots()
        assert grouped.col_roots() == batched.col_roots()
        assert grouped.data_root() == batched.data_root()


@pytest.mark.parametrize("sweep", ["batched", "grouped"])
def test_below_threshold_is_irrecoverable(sweep, monkeypatch):
    """k-1 survivors per row, packed into k-1 columns: no sweep can start."""
    monkeypatch.setenv("CELESTIA_REPAIR_SWEEP", sweep)
    k = 4
    full, _, _ = _square(k, "vandermonde", seed=4)
    rng = np.random.default_rng(78)
    for _ in range(2):
        present = np.zeros((2 * k, 2 * k), dtype=bool)
        present[:, rng.choice(2 * k, size=k - 1, replace=False)] = True
        with pytest.raises(JaxIrrecoverable):
            jax_repair(_damaged(full, present), present)
        with pytest.raises(IrrecoverableSquare):
            repair(_damaged(full, present), present, device="cpu")


@pytest.mark.parametrize("sweep", ["batched", "grouped"])
def test_corrupted_survivor_and_wrong_dah_raise_root_mismatch(sweep, monkeypatch):
    monkeypatch.setenv("CELESTIA_REPAIR_SWEEP", sweep)
    k = 4
    full, dah, jax_dah = _square(k, "vandermonde", seed=4)
    present = np.ones((2 * k, 2 * k), dtype=bool)
    present[k:, k:] = False
    corrupted = _damaged(full, present)
    corrupted[0, 0, 100] ^= 0xFF  # a "surviving" share
    with pytest.raises(JaxRootMismatch):
        jax_repair(corrupted.copy(), present, jax_dah)
    with pytest.raises(RootMismatch):
        repair(corrupted, present, dah, device="cpu")
    # A consistent square against the DAH of another square.
    other, other_dah, other_jax_dah = _square(k, "vandermonde", seed=5)
    with pytest.raises(JaxRootMismatch):
        jax_repair(_damaged(full, present), present, other_jax_dah)
    with pytest.raises(RootMismatch):
        repair(_damaged(full, present), present, other_dah, device="cpu")


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("sweep", ["batched", "grouped"])
def test_sweeps_never_write_a_present_position(axis, sweep):
    """Each line keeps 2k-1 shares; the decode reads the first k of them.
    A present share past those k is altered: a sweep that wrote any present
    position would replace it with the decoded value."""
    k = 4
    full, _, _ = _square(k, "vandermonde", seed=7)
    n = 2 * k
    present = np.ones((n, n), dtype=bool)
    lines = [0, 3, 6]
    if axis == 0:
        present[lines, 1] = False
    else:
        present[1, lines] = False
    data = torch.from_numpy(_damaged(full, present))
    altered = data.clone()
    for line in lines:
        cell = (line, n - 1) if axis == 0 else (n - 1, line)
        altered[cell][100] ^= 0xFF
    patterns = repair_mod._solvable_groups(present, k, axis, data_only=False)
    if sweep == "batched":
        out = repair_mod._batched_sweep(altered.clone(), k, axis, "vandermonde", patterns)
    else:
        out = repair_mod._grouped_sweep(altered.clone(), present.copy(), k, axis,
                                        "vandermonde", patterns)
    mask = torch.from_numpy(present)
    assert torch.equal(out[mask], altered[mask]), "a present position was written"
    assert torch.equal(out[~mask], torch.from_numpy(full)[~mask])


@pytest.mark.parametrize("construction", CONSTRUCTIONS)
@pytest.mark.parametrize("k", [2, 4, 8])
def test_decode_axis_fn_matches_jax(k, construction):
    """The full-line recover matrix through decode_axis_fn: the port's and
    the JAX package's codewords agree and equal the encoded lines."""
    rng = np.random.default_rng(k)
    codec = JaxRSCodec(k, construction)
    data = rng.integers(0, 256, (3, k, SHARE_SIZE), dtype=np.uint8)
    lines = np.stack([codec.extend(d) for d in data])  # (3, 2k, S)
    known_pos = np.sort(rng.choice(2 * k, size=k, replace=False))
    R_bits = codec.field.expand_bit_matrix(codec.recover_matrix(known_pos))
    known = lines[:, known_pos]
    want = np.asarray(jax_decode_axis_fn(k, construction)(known, R_bits))
    port_codec = codec_for_width(k, construction)
    port_R = expand_bits_tensor(port_codec.field, port_codec.recover_matrix(known_pos), "cpu")
    got = decode_axis_fn(k, construction)(torch.from_numpy(known), port_R)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, lines)


def test_repair_takes_a_tensor_and_raises_without_a_card():
    k = 2
    full, dah, _ = _square(k, "vandermonde", seed=9)
    present = np.ones((2 * k, 2 * k), dtype=bool)
    present[:k, :k] = False
    got = repair(torch.from_numpy(_damaged(full, present)), present, dah, device="cpu")
    assert np.array_equal(got.squared(), full)
    with pytest.raises(ValueError):
        repair(full[:, :3], present, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            repair(_damaged(full, present), present, dah)
