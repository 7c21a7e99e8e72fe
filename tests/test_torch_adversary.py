"""The port's protocol adversary (chaos/adversary.py), held against the JAX
package: for the same spec the withheld and malformed coordinate sets, the
corrupted bytes and the forged root are equal; `tamper_entry` corrupts a
clone of a port entry's EDS tensor where it lies (a plain tensor or a
row-sharded one) to the JAX `corrupt_square` bytes; `chaos.install` builds
the adversary in both packages; every detection goes to the one counter.
Host code and k=4 squares; no JAX program is compiled.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from celestia_app_tpu import chaos as jax_chaos
from celestia_app_tpu.chaos.adversary import Adversary as JaxAdversary
from celestia_app_tpu_torch import chaos
from celestia_app_tpu_torch.chaos.adversary import Adversary, detections
from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, SHARE_SIZE
from celestia_app_tpu_torch.da import extend_shares
from celestia_app_tpu_torch.da.repair import RootMismatch, repair
from celestia_app_tpu_torch.parallel.mesh import RowSharded, device_mesh
from celestia_app_tpu_torch.serve import ForestCache
from celestia_app_tpu_torch.trace.metrics import registry

SPECS = (
    {"seed": 3, "withhold_frac": 0.25, "malform_shares": 3, "wrong_root": 1},
    {"seed": 31, "withhold_frac": 0.5, "malform_shares": 1},
    {"seed": 7, "withhold_frac": 0.95, "malform_shares": 64},
    {"seed": 0, "withhold_frac": 1.0, "malform_shares": 1000, "wrong_root": 1},
)


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    chaos.uninstall()
    jax_chaos.uninstall()


def pair(spec: dict):
    return Adversary.from_params(spec), JaxAdversary.from_params(spec)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("height,n", [(1, 4), (1, 8), (7, 8), (12, 32), (3, 256)])
def test_sets_bytes_and_root_equal_jax(spec, height, n):
    port, jax = pair(spec)
    assert port.withheld_set(height, n) == jax.withheld_set(height, n)
    assert port.malformed_coords(height, n) == jax.malformed_coords(height, n)
    for r, c in list(jax.withheld_set(height, n))[:8]:
        assert port.withholds(height, n, r, c)
    rng = np.random.default_rng(height * n)
    width = SHARE_SIZE if n <= 32 else 16  # a narrow square keeps k=128 cheap
    square = rng.integers(0, 256, (n, n, width), dtype=np.uint8)
    want = jax.corrupt_square(height, square)
    assert np.array_equal(port.corrupt_square(height, square), want)
    got = port.corrupt_tensor(height, torch.from_numpy(square))
    assert np.array_equal(got.numpy(), want)
    assert (want != square).sum() == len(jax.malformed_coords(height, n))
    root = bytes(range(32))
    assert port.forged_root(root) == jax.forged_root(root)
    assert port.tampers() == jax.tampers()


def test_no_adversary_key_is_the_honest_path():
    assert Adversary.from_params({"seed": 5}) is None
    assert Adversary.from_params({"withhold_frac": 0, "malform_shares": 0}) is None
    chaos.install("seed=5,proof_fail=0.5")
    assert chaos.active_adversary() is None
    chaos.install("seed=5,withhold_frac=0.25")
    jax_chaos.install("seed=5,withhold_frac=0.25")
    assert (chaos.active_adversary().withheld_set(4, 8)
            == jax_chaos.active_adversary().withheld_set(4, 8))


def det_ods(k: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ns = np.sort(rng.integers(0, 128, k * k).astype(np.uint8))
    ods = rng.integers(0, 256, (k * k, SHARE_SIZE), dtype=np.uint8)
    ods[:, :NAMESPACE_SIZE] = 0
    ods[:, NAMESPACE_SIZE - 1] = ns
    return ods


@pytest.fixture(scope="module")
def eds4():
    return extend_shares([s.tobytes() for s in det_ods(4)], device="cpu")


def test_tamper_entry_corrupts_a_clone_on_the_entry_device(eds4):
    entry = ForestCache(heights=2, spill=1, device="cpu").put(9, eds4)
    honest = eds4.squared().copy()
    spec = {"seed": 13, "malform_shares": 3, "wrong_root": 1}
    port, jax = pair(spec)
    view = port.tamper_entry(entry)
    assert view is not entry and view.eds is not entry.eds
    assert view.eds._eds.device == entry.eds._eds.device
    assert np.array_equal(view.eds._eds.numpy(), jax.corrupt_square(9, honest))
    assert np.array_equal(entry.eds._eds.numpy(), honest)  # the honest entry is untouched
    assert view.data_root == jax.forged_root(entry.data_root)
    assert view.row_flat is entry.row_flat  # the honest forests stay in place
    assert port.tamper_entry(entry) is view  # one attack, one view
    port.invalidate_tampered(9)
    again = port.tamper_entry(entry)
    assert again is not view
    assert np.array_equal(again.eds._eds.numpy(), view.eds._eds.numpy())
    # No tampering key: the entry itself.
    assert Adversary.from_params({"withhold_frac": 0.5}).tamper_entry(entry) is entry


def test_corrupt_tensor_on_a_row_sharded_square():
    port, jax = pair({"seed": 3, "malform_shares": 9})
    n = 8
    square = np.random.default_rng(8).integers(0, 256, (n, n, SHARE_SIZE), dtype=np.uint8)
    mesh = device_mesh(4, "data", device="cpu")
    blocks = [torch.from_numpy(square[i * 2:(i + 1) * 2].copy()) for i in range(4)]
    rs = RowSharded(mesh, blocks)
    got = port.corrupt_tensor(5, rs)
    assert isinstance(got, RowSharded)
    assert np.array_equal(got.numpy(), jax.corrupt_square(5, square))
    assert np.array_equal(rs.numpy(), square)


def _count(name: str, **labels) -> float:
    fam = registry().get(name)
    if fam is None:
        return 0.0
    return sum(v for key, v in fam.samples() if all(key.get(a) == b for a, b in labels.items()))


def test_detections_is_the_one_counter(eds4):
    assert detections() is registry().get("celestia_da_detections_total")
    k = 4
    bad = eds4.squared().copy()
    bad[k + 1, 2, 90] ^= 1
    present = np.ones((2 * k, 2 * k), dtype=bool)
    present[:k, :k] = False
    before = _count("celestia_da_detections_total", kind="root_mismatch")
    with pytest.raises(RootMismatch):
        repair(bad, present, height=11, device="cpu")
    assert _count("celestia_da_detections_total", kind="root_mismatch") == before + 1
    injected = _count("celestia_chaos_injections_total", seam="adversary.malform")
    Adversary.from_params({"seed": 1, "malform_shares": 1}).count_injection(
        "adversary.malform", "malform_shares")
    assert _count("celestia_chaos_injections_total", seam="adversary.malform") == injected + 1
