"""The port's sharded extend + DAH (parallel/sharded_eds.py) on the CPU,
and the environment seams of the sharded lowerings.

The same numpy-seeded squares go through the JAX package's
`sharded_extend_and_dah` on the 8 forced host devices of tests/conftest.py
and through the port on CPU shards (parallel/mesh.device_mesh(n,
device="cpu")); every byte must agree with both the JAX result and the
port's single-device pipeline: the EDS, the row and column roots, the data
root.  Both RS constructions, n in {1, 2, 4, 8}, squares whose parity
namespaces meet Q0 at a shard boundary, the DAH-only twin, the MinDAH, k=2
and k=128 goldens, and $CELESTIA_EXTEND_SHARDS's parsing, clamps, warnings
and the per-k mode routing held to the JAX functions.
"""

from __future__ import annotations

import gc

import jax
import numpy as np
import pytest
import torch

from celestia_app_tpu.kernels import fused as jax_fused
from celestia_app_tpu.kernels import panel_sharded as jax_ps
from celestia_app_tpu.parallel import default_mesh as jax_default_mesh
from celestia_app_tpu.parallel import sharded_extend_and_dah as jax_sharded_extend
from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, PARITY_NAMESPACE_BYTES, SHARE_SIZE
from celestia_app_tpu_torch.da import DataAvailabilityHeader
from celestia_app_tpu_torch.da.dah import tail_padding_share
from celestia_app_tpu_torch.da.eds import pipeline_for_mode
from celestia_app_tpu_torch.kernels import fused
from celestia_app_tpu_torch.kernels import panel_sharded as ps
from celestia_app_tpu_torch.parallel import sharded_eds
from celestia_app_tpu_torch.parallel.mesh import Mesh, RowSharded, device_mesh
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


MIN_DAH_HASH = "3d96b7d238e7e0456f6af8e7cdf0a67bd6cf9c2089ecb559c659dcaa1f880353"
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


# --- the sharded extend + DAH ---------------------------------------------------


@pytest.mark.parametrize("k,n,construction,square", [
    (2, 2, "leopard", random_ods), (8, 4, "leopard", boundary_ods),
    (8, 8, "vandermonde", boundary_ods),
])
def test_sharded_extend_equals_jax_and_single_device(k, n, construction, square, monkeypatch):
    monkeypatch.setenv("CELESTIA_RS_CONSTRUCTION", construction)
    ods = square(k, seed=k * 31 + n)
    want = [np.asarray(x) for x in jax_sharded_extend(ods, jax_default_mesh(n))]
    mesh = sharded_eds.default_mesh(n, device="cpu")
    before = len(journal.rows("sharded"))
    got = sharded_eds.sharded_extend_and_dah(ods, mesh)
    assert isinstance(got[0], RowSharded) and len(got[0].blocks) == n
    assert got[0].rows_per_block == 2 * k // n
    assert_equal(got, want, staged(ods, construction))
    row = journal.rows("sharded")[before:][-1]
    assert (row["mode"], row["devices"], row["k"]) == ("sharded", n, k)
    dah = sharded_eds.make_sharded_dah_pipeline(k, mesh, construction)(torch.from_numpy(ods))
    assert_equal(dah, want[1:])


def test_sharded_extend_one_shard_and_the_divisibility_rule():
    ods = random_ods(4, 0)
    got = sharded_eds.make_sharded_pipeline(4, Mesh(["cpu"]), "vandermonde")(ods)
    assert_equal(got, staged(ods, "vandermonde"))
    with pytest.raises(ValueError, match="must divide square size 4"):
        sharded_eds.make_sharded_pipeline(4, device_mesh(8, "data", "cpu"))
    with pytest.raises(ValueError, match="bad ODS shape"):
        sharded_eds.make_sharded_pipeline(4, device_mesh(2, "data", "cpu"))(ods[:2])


# --- the seams, against the JAX package --------------------------------------------


@pytest.mark.parametrize("raw", ["", "0", "off", "1", "2", "8", " 4 ", "auto", "AUTO", "64", "6",
                                 "3", "-2", "banana", "1.5"])
def test_extend_shards_parse_equals_jax(raw, monkeypatch, capsys):
    monkeypatch.setenv("CELESTIA_EXTEND_SHARDS", raw)
    monkeypatch.setattr(ps, "_WARNED", set())
    monkeypatch.setattr(jax_ps, "_WARNED", set())
    got = ps.extend_shards("cpu")
    port_err = capsys.readouterr().err
    assert got == jax_ps.extend_shards()
    assert port_err == capsys.readouterr().err
    if raw.strip() in ("64", "6", "3"):
        assert "clamped" in port_err
    if raw in ("banana", "1.5"):
        assert "malformed" in port_err


@pytest.mark.parametrize("shards,panel", [("8", "4"), ("2", "3"), ("auto", "auto"), ("4", ""),
                                          ("0", "2"), ("8", "off")])
def test_engagement_and_mode_routing_per_k_equal_jax(shards, panel, monkeypatch):
    monkeypatch.setenv("CELESTIA_EXTEND_SHARDS", shards)
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", panel)
    for k in (1, 2, 4, 8, 16, 64, 512, 2048):
        assert ps.shards_for_k(k, "cpu") == jax_ps.shards_for_k(k), k
        assert ps.sharded_panel_count(k, "cpu") == jax_ps.sharded_panel_count(k), k
        assert fused.pipeline_mode_for_k(k, "cpu") == jax_fused.env_base_mode_for_k(k), k
        n = ps.shards_for_k(k, "cpu")
        if n:
            assert ps.local_panel_bounds(k, n) == jax_ps.local_panel_bounds(k, n)
    assert fused.pipeline_mode() == "fused"  # k-less callers unchanged


def test_short_last_panel_schedule(monkeypatch):
    engage(monkeypatch, 2, 3)
    assert ps.local_panel_bounds(8, 2) == ((0, 3), (3, 4))
    assert ps.sharded_panel_count(8, "cpu") == 2


def test_the_seams_need_a_card_unless_the_cpu_is_asked(monkeypatch):
    """With the variables unset nothing counts devices; once they ask for
    shards, the default device is CUDA, which raises without a card."""
    assert fused.pipeline_mode_for_k(4) == "fused"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    engage(monkeypatch, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fused.pipeline_mode_for_k(4)


# --- goldens through the sharded paths --------------------------------------------------


def _golden(k: int) -> np.ndarray:
    share = tail_padding_share() if k == 1 else golden_share()
    return np.frombuffer(share * (k * k), dtype=np.uint8).reshape(k, k, SHARE_SIZE)


def _dah_hash(rr, cr) -> str:
    return DataAvailabilityHeader([r.numpy().tobytes() for r in rr],
                                  [c.numpy().tobytes() for c in cr]).hash().hex()


@pytest.mark.parametrize("k,n,want", [(1, 1, MIN_DAH_HASH), (2, 2, K2_HASH), (128, 4, K128_HASH)])
def test_goldens_through_the_sharded_extend(k, n, want):
    _, rr, cr, droot = sharded_eds.sharded_extend_and_dah(_golden(k), Mesh(["cpu"] * n, "data"))
    assert _dah_hash(rr, cr) == want == droot.numpy().tobytes().hex()


