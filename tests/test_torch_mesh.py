"""The port's device mesh (parallel/mesh.py) on the CPU, held against numpy
and against the JAX package's collectives under shard_map on the 8 forced
host devices of tests/conftest.py.

Covers the copy collectives (all_to_all, gather, all_gather, xor_allreduce)
and that none of their outputs aliases an input, the routing helpers
carried over from the JAX module, device_mesh's limits, the row-sharded
array's reads, and the launcher's device checks (kernels/_build.launch),
which run before any kernel is built.
"""

from __future__ import annotations

import gc
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from celestia_app_tpu.parallel import mesh as jax_mesh
from celestia_app_tpu.parallel._compat import shard_map
from celestia_app_tpu_torch.kernels import _build
from celestia_app_tpu_torch.parallel import mesh
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


ROOT = Path(__file__).resolve().parent.parent
SHARDS = (2, 4, 8)


def cpu_mesh(n: int, axis: str = "x") -> Mesh:
    return Mesh(["cpu"] * n, axis)


def jax_program(n: int, body):
    """body under shard_map over the first n forced host devices, the input
    and output row-sharded."""
    jm = JaxMesh(np.array(jax.devices()[:n]), ("x",))
    return jax.jit(shard_map(body, mesh=jm, in_specs=P("x"), out_specs=P("x")))


def blocks_of(x: np.ndarray, n: int) -> list[torch.Tensor]:
    return [torch.from_numpy(b.copy()) for b in np.split(x, n)]


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("split_dim,concat_dim", [(1, 0), (0, 1)])
def test_all_to_all_equals_jax(n, split_dim, concat_dim):
    """The tiled all_to_all of lax.all_to_all, shard by shard."""
    rng = np.random.default_rng(n * 10 + split_dim)
    x = rng.integers(0, 256, (n * 2 * n, 4 * n, 3), dtype=np.uint8)
    want = np.asarray(jax_program(n, lambda b: lax.all_to_all(
        b, "x", split_axis=split_dim, concat_axis=concat_dim, tiled=True))(jnp.asarray(x)))
    got = mesh.all_to_all(cpu_mesh(n), blocks_of(x, n), split_dim, concat_dim)
    assert np.array_equal(torch.cat(got).numpy(), want)


@pytest.mark.parametrize("n", SHARDS)
def test_xor_allreduce_equals_jax_butterfly(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 256, (n * 3, 17), dtype=np.uint8)
    want = np.asarray(jax_program(n, lambda b: jax_mesh.xor_allreduce(b, "x", n))(
        jnp.asarray(x)))
    blocks = blocks_of(x, n)
    got = mesh.xor_allreduce(cpu_mesh(n), blocks)
    assert np.array_equal(torch.cat(got).numpy(), want)
    folded = np.bitwise_xor.reduce(np.stack(np.split(x, n)), axis=0)
    for g in got:
        assert np.array_equal(g.numpy(), folded)


def test_xor_allreduce_needs_a_power_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        mesh.xor_allreduce(cpu_mesh(3), [torch.zeros(2, dtype=torch.uint8)] * 3)


@pytest.mark.parametrize("n", SHARDS)
def test_gather_and_all_gather_equal_numpy(n):
    rng = np.random.default_rng(n + 100)
    parts = [rng.integers(0, 256, (i + 1, 5), dtype=np.uint8) for i in range(n)]
    m = cpu_mesh(n)
    want = np.concatenate(parts)
    blocks = [torch.from_numpy(p) for p in parts]
    assert np.array_equal(mesh.gather(m, blocks, dim=0, dst=n - 1).numpy(), want)
    outs = mesh.all_gather(m, blocks, dim=0)
    assert len(outs) == n and all(np.array_equal(o.numpy(), want) for o in outs)
    assert len({o.data_ptr() for o in outs}) == n  # one buffer per shard


def test_collective_outputs_never_alias_inputs():
    """A one-device mesh is where .to() would hand back the input itself:
    every output is a buffer of its own, so writing it leaves the inputs
    and the other shards' outputs as they were."""
    n = 4
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (n * n, 2 * n), dtype=np.uint8)
    m = cpu_mesh(n)
    blocks = blocks_of(x, n)
    outs = (mesh.all_to_all(m, blocks, 1, 0) + mesh.all_gather(m, blocks, 0)
            + mesh.xor_allreduce(m, blocks) + [mesh.gather(m, blocks, 0)])
    kept = [o.clone() for o in outs]
    for o in outs:
        o.fill_(0x5A)
    assert np.array_equal(torch.cat(blocks).numpy(), x)
    for a in outs:
        for b in blocks:
            assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
    assert any(not torch.equal(a, b) for a, b in zip(outs, kept))


def test_send_writes_into_a_strided_view():
    m = cpu_mesh(2)
    out = torch.zeros((3, 2, 4), dtype=torch.uint8)
    src = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
    mesh.send(m, src, 1, 0, out[:, 1])
    assert torch.equal(out[:, 1], src) and not out[:, 0].any()


@pytest.mark.parametrize("rows,shards", [(0, 1), (1, 1), (7, 2), (8, 4), (9, 8), (4600, 8)])
def test_layout_helpers_equal_jax(rows, shards):
    assert mesh.padded_rows(rows, shards) == jax_mesh.padded_rows(rows, shards)
    for n in (0, 1, 2, 3, 5, 64, 65):
        assert mesh.bucket_pow2(n) == jax_mesh.bucket_pow2(n)
    rps = max(1, mesh.padded_rows(rows, shards) // shards)
    for r in range(0, max(rows, 1), max(1, rows // 7)):
        assert mesh.shard_of_row(r, rps) == jax_mesh.shard_of_row(r, rps)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_to_shards_equals_jax(seed):
    rng = np.random.default_rng(seed)
    shards, rps = 4, 37
    idx = rng.integers(0, shards * rps, 1 + 50 * seed)
    got = mesh.route_to_shards(idx, shards, rps)
    want = jax_mesh.route_to_shards(idx, shards, rps)
    assert np.array_equal(got[0], want[0])
    assert all(np.array_equal(a, b) for a, b in zip(got[1], want[1]))
    assert np.array_equal(got[2], want[2])
    assert np.array_equal(got[0][got[1]] + got[1][0] * rps, idx)


def test_device_mesh_on_the_cpu():
    m = mesh.device_mesh(8, "x", device="cpu")
    assert m.size == 8 and m.shape == {"x": 8} and m.axis == "x"
    assert m is mesh.device_mesh(8, "x", device="cpu")  # one Mesh per key
    assert all(d.type == "cpu" for d in m.devices) and m.streams == (None,) * 8
    assert mesh.device_count("cpu") == mesh.CPU_SHARDS == len(jax.devices())
    for bad in (0, 9):
        with pytest.raises(ValueError, match="available"):
            mesh.device_mesh(bad, "x", device="cpu")


def test_device_mesh_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default CUDA mesh is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.device_mesh(2)


def test_row_sharded_reads_go_to_the_owning_block():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (8, 6, 5), dtype=np.uint8)
    m = cpu_mesh(2)
    # Four 2-row blocks, two per shard (the sharded panel runner's layout).
    rs = RowSharded(m, blocks_of(x, 4), owners=[0, 1, 0, 1])
    assert tuple(rs.shape) == x.shape and rs.rows_per_block == 2
    assert [rs.owner_of_row(r) for r in range(8)] == [0, 0, 1, 1, 0, 0, 1, 1]
    assert np.array_equal(rs.numpy(), x)
    assert np.array_equal(rs[5].numpy(), x[5])
    assert np.array_equal(rs[-1, 2, :3].numpy(), x[-1, 2, :3])
    assert rs[5].untyped_storage().data_ptr() == rs.blocks[2].untyped_storage().data_ptr()
    for index in [(slice(None), 3), (slice(1, 7), slice(2, 4)), slice(2, 4), (slice(3, 3),)]:
        assert np.array_equal(rs[index].numpy(), x[index]), index
    flat = rng.integers(0, 8 * 6, 40)
    assert np.array_equal(rs.take(flat), x.reshape(-1, 5)[flat])
    with pytest.raises(ValueError, match="step 1"):
        rs[::2]
    with pytest.raises(ValueError, match="unequal"):
        RowSharded(m, [torch.zeros((2, 3)), torch.zeros((3, 3))])


def test_launch_takes_the_device_of_its_tensors():
    """kernels/_build.launch checks its tensors' device before building
    anything: one CUDA device, never a mix."""
    cpu = torch.zeros(4, dtype=torch.uint8)
    meta = torch.empty(4, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="want one CUDA device"):
        _build.launch("sha256", "sha256", "sha256_batch", cpu, 1, 4, meta)
    with pytest.raises(ValueError, match="want a CUDA device"):
        _build.launch("sha256", "sha256", "sha256_batch", cpu, 1, 4, cpu)
    _build.reset_launches()
    assert _build.STREAM_LAUNCHES == {} and set(_build.LAUNCHES.values()) == {0}


def test_kernel_setup_is_per_device():
    """The tensor-core kernels prepare each device on its first launch there
    (csrc/rs_dense.cuh prepare: per (kernel, device ordinal), under a
    lock), never once per process."""
    csrc = ROOT / "celestia_app_tpu_torch" / "csrc"
    for name in ("rs_dense.cu", "rs_dense_leaf.cu"):
        assert not re.search(r"static\s+int\s+sms", (csrc / name).read_text()), name
    header = (csrc / "rs_dense.cuh").read_text()
    assert "std::map<std::pair<const void*, int>, int> prepared" in header
    assert "cudaGetDevice(&dev)" in header
