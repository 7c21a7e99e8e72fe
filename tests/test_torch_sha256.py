"""The port's batched SHA-256 (plain versions, on the CPU) against the JAX
package's and hashlib.

The JAX Pallas SHA has no practical interpret run on the CPU
(tests/test_sha_pallas.py), so the generic path is held against
`_sha256_jnp` and the fused-leaf path against `_leaf_tile_compute` run
eagerly, as tests/test_sha_fused.py does.  The CUDA kernels are compared
with these plain versions in tests/test_torch_cuda.py and chip_smoke.py.
"""

from __future__ import annotations

import gc
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_app_tpu.kernels.sha256 import (
    _digest_bytes,
    _leaf_tile_compute,
    _sha256_jnp,
)
from celestia_app_tpu_torch.kernels import _build
from celestia_app_tpu_torch.kernels.sha256 import (
    sha256,
    sha256_leaves,
    sha256_leaves_plain,
)


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



def _msgs(n: int, length: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, length), dtype=np.uint8)


@pytest.mark.parametrize("length", [65, 91, 181, 542])
def test_generic_equals_jax_and_hashlib(length):
    msgs = _msgs(130, length, seed=length)  # not a multiple of a 128-thread block
    got = sha256(torch.from_numpy(msgs)).numpy()
    assert np.array_equal(got, np.asarray(_sha256_jnp(jnp.asarray(msgs))))
    for i in (0, 64, 129):
        assert got[i].tobytes() == hashlib.sha256(msgs[i].tobytes()).digest()


@pytest.mark.parametrize("length", [0, 1, 55, 56, 63, 64, 119, 120])
@pytest.mark.parametrize("n", [1, 3])
def test_padding_boundaries_equal_hashlib(length, n):
    msgs = _msgs(n, length, seed=length + n)
    got = sha256(torch.from_numpy(msgs)).numpy()
    for i in range(n):
        assert got[i].tobytes() == hashlib.sha256(msgs[i].tobytes()).digest()


def test_leaf_plain_equals_jax_leaf_tile():
    n = 16
    rng = np.random.default_rng(3)
    ns = rng.integers(0, 256, (n, 29), dtype=np.uint8)
    shares = rng.integers(0, 256, (n, 512), dtype=np.uint8)
    want = np.asarray(_digest_bytes(_leaf_tile_compute(jnp.asarray(ns), jnp.asarray(shares), n).T))
    got = sha256_leaves(torch.from_numpy(ns), torch.from_numpy(shares)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(
        sha256_leaves_plain(torch.from_numpy(ns), torch.from_numpy(shares)).numpy(), want
    )
    assert got[5].tobytes() == hashlib.sha256(
        b"\x00" + ns[5].tobytes() + shares[5].tobytes()).digest()


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = dict(_build.LAUNCHES)
    sha256(torch.from_numpy(_msgs(4, 181, seed=1)))
    sha256_leaves(torch.zeros((2, 29), dtype=torch.uint8), torch.zeros((2, 512), dtype=torch.uint8))
    assert _build.LAUNCHES == before


def test_empty_batch_and_bad_input():
    assert sha256(torch.zeros((0, 65), dtype=torch.uint8)).shape == (0, 32)
    with pytest.raises(ValueError):
        sha256(torch.zeros((2, 65), dtype=torch.int32))
    with pytest.raises(ValueError):
        sha256_leaves(torch.zeros((2, 28), dtype=torch.uint8), torch.zeros((2, 512), dtype=torch.uint8))
    with pytest.raises(ValueError):
        sha256_leaves(torch.zeros((2, 29), dtype=torch.uint8), torch.zeros((3, 512), dtype=torch.uint8))
