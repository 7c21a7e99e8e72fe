"""The port's sharded repair (parallel/sharded_repair.py) on the CPU, and the
routing of the sharded panel lowering through compute, extend_shares, the
stream and the speculative extend.

Repairs go through the JAX package's `sharded_repair` on the 8 forced host
devices of tests/conftest.py and through the port on CPU shards; the result
must be the original square and roots, as the port's single-device repair
gives them.  Both RS constructions, n in {2, 4, 8}, quadrant and crossword
erasures, and the IrrecoverableSquare / RootMismatch contract.  The JAX
ladder and chaos cases are not ported (the port has no ladder).
"""

from __future__ import annotations

import gc

import jax
import numpy as np
import pytest
import torch

from celestia_app_tpu.parallel import default_mesh as jax_default_mesh
from celestia_app_tpu.parallel.sharded_repair import sharded_repair as jax_sharded_repair
from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, SHARE_SIZE
from celestia_app_tpu_torch.da import DataAvailabilityHeader, extend_shares
from celestia_app_tpu_torch.da.eds import ExtendedDataSquare, pipeline_for_mode, speculator
from celestia_app_tpu_torch.da.repair import IrrecoverableSquare, RootMismatch, repair
from celestia_app_tpu_torch.parallel import sharded_eds
from celestia_app_tpu_torch.parallel.mesh import Mesh, RowSharded
from celestia_app_tpu_torch.parallel.pipeline import BlockPipeline, stream_blocks
from celestia_app_tpu_torch.parallel.sharded_repair import sharded_repair
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


SEAMS = ("CELESTIA_PIPE_PANEL", "CELESTIA_EXTEND_SHARDS", "CELESTIA_RS_FFT", "CELESTIA_RS_FFT_MD",
         "CELESTIA_RS_XOR", "CELESTIA_PIPE_FUSED", "CELESTIA_PIPE_SPECULATE",
         "CELESTIA_RS_CONSTRUCTION", "CELESTIA_PIPE_BATCH", "CELESTIA_SERVE_SHARDS")


@pytest.fixture(autouse=True)
def _no_ambient_seams(monkeypatch):
    """Each test sets the seams it needs; none inherits them."""
    for var in SEAMS:
        monkeypatch.delenv(var, raising=False)


def random_ods(k: int, seed: int) -> np.ndarray:
    """Random shares, namespaces below the parity namespace."""
    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, (k, k, SHARE_SIZE), dtype=np.uint8)
    ods[..., 0] = 0
    return ods


def staged(ods: np.ndarray, construction: str):
    k = ods.shape[0]
    return pipeline_for_mode("staged", k, construction, "cpu")(torch.from_numpy(ods))


def host(x) -> np.ndarray:
    if isinstance(x, RowSharded):
        return x.numpy()
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def engage(monkeypatch, shards, rows) -> None:
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", str(rows))
    monkeypatch.setenv("CELESTIA_EXTEND_SHARDS", str(shards))


# --- sharded repair ---------------------------------------------------------------------


def _damaged(full: np.ndarray, present: np.ndarray) -> np.ndarray:
    return np.where(present[..., None], full, 7).astype(np.uint8)


@pytest.mark.parametrize("k,n,quadrant,construction", [
    (8, 4, "q3", "vandermonde"), (4, 2, "q0", "leopard"), (8, 8, "crossword", "vandermonde"),
])
def test_sharded_repair_equals_jax_and_single_device(k, n, quadrant, construction, monkeypatch):
    monkeypatch.setenv("CELESTIA_RS_CONSTRUCTION", construction)
    ods = random_ods(k, seed=k * 7 + n)
    ref = ExtendedDataSquare.compute(ods, device="cpu")
    full = ref.squared()
    dah = DataAvailabilityHeader.from_eds(ref)
    present = np.ones((2 * k, 2 * k), dtype=bool)
    if quadrant == "q3":
        present[k:, k:] = False
    elif quadrant == "q0":
        present[:k, :k] = False
    else:  # rows and columns in turn (the JAX test's crossword)
        present[1, 1:] = False
        present[:, 2] = False
        present[5, :k] = False
    damaged = _damaged(full, present)
    out = sharded_repair(damaged, present, sharded_eds.default_mesh(n, device="cpu"), dah)
    assert isinstance(out._eds, RowSharded) and out._eds.shards == n
    assert np.array_equal(out.squared(), full)
    assert (out.row_roots(), out.col_roots(), out.data_root()) == \
        (ref.row_roots(), ref.col_roots(), ref.data_root())
    jax_out = jax_sharded_repair(damaged, present, jax_default_mesh(n), None)
    assert np.array_equal(jax_out.squared(), full) and jax_out.data_root() == ref.data_root()
    single = repair(damaged, present, dah, device="cpu")
    assert np.array_equal(single.squared(), full)


def test_sharded_repair_contract():
    k = 4
    mesh = Mesh(["cpu"] * 2, "data")
    ref = ExtendedDataSquare.compute(random_ods(k, seed=99), device="cpu")
    full = ref.squared()
    present = np.ones((2 * k, 2 * k), dtype=bool)
    present[:, 2] = False
    bad = _damaged(full, present)
    bad[0, 0, 100] ^= 0xFF
    with pytest.raises(RootMismatch, match="consistent codeword"):
        sharded_repair(bad, present, mesh)
    other = DataAvailabilityHeader.from_eds(ExtendedDataSquare.compute(random_ods(k, 5),
                                                                       device="cpu"))
    with pytest.raises(RootMismatch, match="DAH"):
        sharded_repair(_damaged(full, present), present, mesh, other)
    few = np.zeros((2 * k, 2 * k), dtype=bool)
    few[:k - 1, :k - 1] = True
    with pytest.raises(IrrecoverableSquare):
        sharded_repair(_damaged(full, few), few, mesh)
    with pytest.raises(ValueError, match="must divide EDS width"):
        sharded_repair(full, np.ones((2 * k, 2 * k), dtype=bool), Mesh(["cpu"] * 3, "data"))
    before = full.copy()
    sharded_repair(torch.from_numpy(full), np.ones((2 * k, 2 * k), dtype=bool), mesh)
    assert np.array_equal(full, before)  # the input is never modified
# --- routing: compute, the stream, speculation ----------------------------------------


def test_compute_routes_and_journals_shards(monkeypatch):
    k = 8
    ods = random_ods(k, seed=77)
    ods[..., :NAMESPACE_SIZE] = 0  # namespaces rise in row-major order: host trees build
    ods[..., NAMESPACE_SIZE - 1] = np.arange(k * k, dtype=np.uint8).reshape(k, k)
    ref = ExtendedDataSquare.compute(ods, "vandermonde", device="cpu")
    engage(monkeypatch, 8, 2)
    before = len(journal.rows("compute"))
    eds = ExtendedDataSquare.compute(ods, "vandermonde", device="cpu")
    row = journal.rows("compute")[before:][-1]
    assert (row["mode"], row["shards"], row["panels"]) == ("sharded_panel", 8, 1)
    assert isinstance(eds._eds, RowSharded) and eds._eds.shards == 8
    assert eds.data_root() == ref.data_root()
    assert eds.row_roots() == ref.row_roots() and eds.col_roots() == ref.col_roots()
    assert np.array_equal(eds.squared(), ref.squared())
    for i in (0, k - 1, k, 2 * k - 1):
        assert np.array_equal(eds.row(i), ref.row(i)) and np.array_equal(eds.col(i), ref.col(i))
        assert eds.leaf_namespace(i, k - 1) == ref.leaf_namespace(i, k - 1)
    assert eds.flattened_ods() == ref.flattened_ods()
    assert eds.row_tree(k + 1).root() == ref.row_tree(k + 1).root() == ref.row_roots()[k + 1]
    assert eds.col_tree(2).root() == ref.col_roots()[2]
    shares = [s.tobytes() for s in ods.reshape(k * k, SHARE_SIZE)]
    assert extend_shares(shares, "vandermonde", device="cpu").data_root() == ref.data_root()


def test_stream_and_speculation_ride_the_sharded_rung(monkeypatch):
    k = 8
    odss = [(i, random_ods(k, seed=300 + i)) for i in range(3)]
    refs = {t: ExtendedDataSquare.compute(o, device="cpu").data_root() for t, o in odss}
    engage(monkeypatch, 4, 1)
    pipe = BlockPipeline(k, depth=2, batch=4, device="cpu")
    assert pipe.batch == 1  # giant squares never coalesce
    pipe.close()
    before = len(journal.rows("stream"))
    for tag, eds in stream_blocks(iter(odss), k, depth=2, batch=3, device="cpu"):
        assert eds.data_root() == refs[tag], tag
    rows = journal.rows("stream")[before:]
    assert [(r["mode"], r["shards"], r["panels"], r["batch_size"]) for r in rows] == \
        [("sharded_panel", 4, 2, 1)] * 3

    monkeypatch.setenv("CELESTIA_PIPE_SPECULATE", "on")
    spec = speculator()
    hits = spec.outcomes["hit"]
    assert spec.speculate(odss[0][1], device="cpu")
    eds = ExtendedDataSquare.compute(odss[0][1], device="cpu")
    assert spec.outcomes["hit"] == hits + 1
    assert isinstance(eds._eds, RowSharded) and eds.data_root() == refs[0]


