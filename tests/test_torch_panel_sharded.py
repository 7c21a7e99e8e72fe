"""The port's sharded panel lowering (kernels/panel_sharded.py) on the CPU.

The same numpy-seeded squares go through the JAX package's
`sharded_panel_pipeline` on the 8 forced host devices of tests/conftest.py
and through the port on CPU shards, and every byte must agree with both the
JAX result and the port's staged single-device pipeline: the EDS (a
parallel/mesh.RowSharded), the row and column roots, the data root.  Both
RS constructions, n in {2, 4, 8}, the dense and the FFT column legs, a
short last panel, a panel height above the slab, the roots-only twins, and
the k=2 and k=128 goldens.
"""

from __future__ import annotations

import gc

import jax
import numpy as np
import pytest
import torch

from celestia_app_tpu.kernels import panel_sharded as jax_ps
from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, PARITY_NAMESPACE_BYTES, SHARE_SIZE
from celestia_app_tpu_torch.da import DataAvailabilityHeader
from celestia_app_tpu_torch.da.dah import tail_padding_share
from celestia_app_tpu_torch.da.eds import pipeline_for_mode
from celestia_app_tpu_torch.kernels import panel_sharded as ps
from celestia_app_tpu_torch.parallel.mesh import Mesh, RowSharded


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
K128_HASH = "0bd3abeeacfbb0b92dfbdac4a154868e3c4e79666f7fcf6c620bb90dd3a0dcf0"

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


def boundary_ods(k: int, seed: int) -> np.ndarray:
    """Shares whose last ODS column carries the parity namespace itself, so
    that parity namespaces meet Q0 on both sides of the Q0 | Q1 boundary, a
    shard boundary of every even mesh: the ignore-max rule there decides
    the subtree merge."""
    ods = random_ods(k, seed)
    ods[:, -1, :NAMESPACE_SIZE] = np.frombuffer(PARITY_NAMESPACE_BYTES, dtype=np.uint8)
    return ods


def golden_share() -> bytes:
    ns = bytes([0x00]) + bytes(18) + bytes([0x01]) * 10
    return ns + b"\xff" * (SHARE_SIZE - NAMESPACE_SIZE)


def staged(ods: np.ndarray, construction: str):
    k = ods.shape[0]
    return pipeline_for_mode("staged", k, construction, "cpu")(torch.from_numpy(ods))


def host(x) -> np.ndarray:
    if isinstance(x, RowSharded):
        return x.numpy()
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_equal(got, *wants) -> None:
    for want in wants:
        assert len(got) == len(want)
        for name, a, b in zip(("eds", "row_roots", "col_roots", "droot")[-len(got):], got, want):
            assert np.array_equal(host(a), host(b)), name


def engage(monkeypatch, shards, rows) -> None:
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", str(rows))
    monkeypatch.setenv("CELESTIA_EXTEND_SHARDS", str(shards))


# --- the sharded panel lowering --------------------------------------------------


@pytest.mark.parametrize("k,shards,rows,construction,fft", [
    (4, 2, 2, "vandermonde", False),   # panels divide the slab
    (8, 2, 3, "leopard", False),       # a short last panel on every shard
    (8, 8, 2, "vandermonde", False),   # one ODS row per shard
    (8, 4, 3, "vandermonde", True),    # the FFT leg's all_to_alls
])
def test_sharded_panel_equals_jax_and_staged(k, shards, rows, construction, fft, monkeypatch):
    engage(monkeypatch, shards, rows)
    if fft:
        monkeypatch.setenv("CELESTIA_RS_FFT", "on")
    ods = boundary_ods(k, seed=k * 31 + shards * 7 + rows)
    want = [np.asarray(x) for x in jax_ps.sharded_panel_pipeline(k, construction)(ods)]
    got = ps.sharded_panel_pipeline(k, construction, device="cpu")(ods)
    eds = got[0]
    assert isinstance(eds, RowSharded) and eds.owners == tuple(range(shards)) * 2
    assert eds.mesh is ps.extend_mesh(shards, "cpu")
    assert_equal(got, want, staged(ods, construction))
    twin = ps.sharded_panel_pipeline(k, construction, roots_only=True, device="cpu")(ods)
    assert_equal(twin, want[1:])


@pytest.mark.parametrize("k,shards,rows,construction,fft", [
    (16, 4, 3, "leopard", False), (16, 2, 5, "leopard", True), (16, 2, 16, "leopard", False),
])
def test_sharded_panel_wider_matrix_equals_staged(k, shards, rows, construction, fft,
                                                  monkeypatch):
    """Explicit meshes of CPU shards (the form chip_smoke.py uses on one
    card), panel heights that do and do not divide the slab, and a height
    above the slab (clamped to it)."""
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", str(rows))
    if fft:
        monkeypatch.setenv("CELESTIA_RS_FFT", "on")
    mesh = Mesh(["cpu"] * shards, "extend")
    ods = random_ods(k, seed=shards * 100 + rows)
    want = staged(ods, construction)
    assert_equal(ps.sharded_panel_pipeline(k, construction, mesh=mesh)(ods), want)
    assert_equal(ps.sharded_panel_pipeline(k, construction, roots_only=True, mesh=mesh)(
        torch.from_numpy(ods)), want[1:])


def test_sharded_panel_needs_the_seams():
    with pytest.raises(ValueError, match="not engaged"):
        ps.sharded_panel_pipeline(8, device="cpu")
    mesh = Mesh(["cpu"] * 2, "extend")
    run = ps.sharded_panel_pipeline(8, "vandermonde", mesh=mesh)
    with pytest.raises(ValueError, match="whole"):
        run([random_ods(8, 0)])
    with pytest.raises(ValueError, match="bad ODS shape"):
        run(random_ods(4, 0))


# --- goldens through the sharded paths --------------------------------------------------


def _golden(k: int) -> np.ndarray:
    share = tail_padding_share() if k == 1 else golden_share()
    return np.frombuffer(share * (k * k), dtype=np.uint8).reshape(k, k, SHARE_SIZE)


def _dah_hash(rr, cr) -> str:
    return DataAvailabilityHeader([r.numpy().tobytes() for r in rr],
                                  [c.numpy().tobytes() for c in cr]).hash().hex()


@pytest.mark.parametrize("k,n,rows,want", [(2, 2, 1, K2_HASH), (128, 8, 5, K128_HASH)])
def test_goldens_through_the_sharded_panel(k, n, rows, want, monkeypatch):
    engage(monkeypatch, n, rows)
    rr, cr, droot = ps.sharded_panel_pipeline(k, roots_only=True, device="cpu")(_golden(k))
    assert _dah_hash(rr, cr) == want == droot.numpy().tobytes().hex()


