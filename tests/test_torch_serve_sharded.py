"""The port's sharded proof-serving plane (serve/shard.py) on the CPU.

The same deterministic squares are retained by the JAX package's
ForestCache under $CELESTIA_SERVE_SHARDS=8 on the 8 forced host devices of
tests/conftest.py and by the port's on CPU shards; the sampled proofs must
be the same wire bytes, equal to the port's single-device entry and host
lowering, both RS constructions, every quadrant.  Also: the spill tier, the
knob's parsing and warnings, the routing functions, the stats "mesh" block,
share reads from a row-sharded EDS (the sharded extend's and the sharded
panel lowering's) against the JAX sharded share gather and the host bytes,
and serve-sharded forests over extend-sharded shares.  The JAX ladder,
chaos and metrics cases are not ported.
"""

from __future__ import annotations

import gc
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_app_tpu.da.eds import ExtendedDataSquare as JaxEDS
from celestia_app_tpu.parallel import default_mesh as jax_default_mesh
from celestia_app_tpu.parallel import sharded_extend_and_dah as jax_sharded_extend
from celestia_app_tpu.rpc.codec import to_jsonable
from celestia_app_tpu.serve import shard as jax_shard
from celestia_app_tpu.serve.api import render
from celestia_app_tpu.serve.cache import ForestCache as JaxForestCache
from celestia_app_tpu.serve.sampler import ProofSampler as JaxSampler
from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, SHARE_SIZE
from celestia_app_tpu_torch.da import extend_shares
from celestia_app_tpu_torch.da.eds import ExtendedDataSquare
from celestia_app_tpu_torch.kernels.fused import forest
from celestia_app_tpu_torch.parallel import sharded_eds
from celestia_app_tpu_torch.parallel.mesh import Mesh, RowSharded, route_to_shards
from celestia_app_tpu_torch.serve import ForestCache, ProofSampler
from celestia_app_tpu_torch.serve import shard
from celestia_app_tpu_torch.serve.cache import CachedForest


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
# The k=8 vandermonde sample (3, 11) payload digest of
# tests/test_das_proofs.py and tests/test_serve_sharded.py.
SAMPLE_3_11_VANDERMONDE = "43147e47f167ac87c90e408127e212d601e856397dc673d2e265824194fcbd04"


@pytest.fixture(autouse=True)
def _no_ambient_seams(monkeypatch):
    for var in ("CELESTIA_SERVE_SHARDS", "CELESTIA_EXTEND_SHARDS", "CELESTIA_PIPE_PANEL",
                "CELESTIA_RS_CONSTRUCTION", "CELESTIA_SERVE_HEIGHTS", "CELESTIA_SERVE_SPILL"):
        monkeypatch.delenv(var, raising=False)


def det_square(k: int, seed: int = 1) -> np.ndarray:
    """The namespace-ordered ODS of tests/test_das_proofs.py."""
    rng = np.random.default_rng(seed)
    ns = np.sort(rng.integers(0, 128, k * k).astype(np.uint8))
    ods = rng.integers(0, 256, (k * k, SHARE_SIZE), dtype=np.uint8)
    ods[:, :NAMESPACE_SIZE] = 0
    ods[:, NAMESPACE_SIZE - 1] = ns
    return ods.reshape(k, k, SHARE_SIZE)


_SQUARES: dict = {}


def square(k: int, construction: str, seed: int = 1):
    """(port EDS, JAX EDS handle over the same bytes and roots), cached."""
    key = (k, construction, seed)
    if key not in _SQUARES:
        ods = det_square(k, seed)
        eds = extend_shares([s.tobytes() for s in ods.reshape(k * k, SHARE_SIZE)], construction,
                            device="cpu")
        jax_eds = JaxEDS(jnp.asarray(eds.squared()), eds.row_roots(), eds.col_roots(),
                         eds.data_root(), k)
        _SQUARES[key] = (eds, jax_eds)
    return _SQUARES[key]


def wire(proofs) -> list[bytes]:
    return [render(to_jsonable(p)) for p in proofs]


def quadrant_coords(k: int) -> list[tuple[int, int]]:
    n = 2 * k
    return sorted({(0, 0), (k - 1, k - 1), (0, n - 1), (k - 1, k), (n - 1, 0), (k, k - 1),
                   (n - 1, n - 1), (k, k), (3, 11), (k // 2, n - 2)})


@pytest.mark.parametrize("construction", CONSTRUCTIONS)
def test_sharded_gathers_equal_jax_single_device_and_host(construction, monkeypatch):
    k = 8
    eds, jax_eds = square(k, construction)
    monkeypatch.setenv("CELESTIA_SERVE_SHARDS", "8")
    entry = ForestCache(heights=2, spill=2, device="cpu").put(1, eds)
    jax_entry = JaxForestCache(heights=2, spill=2).put(1, jax_eds)
    assert isinstance(entry, shard.ShardedCachedForest) and entry.shards == 8
    assert isinstance(jax_entry, jax_shard.ShardedCachedForest)
    assert isinstance(entry.row_flat, RowSharded) and len(entry.row_flat.blocks) == 8
    assert entry.rows_per_shard == jax_entry.rows_per_shard
    monkeypatch.setenv("CELESTIA_SERVE_SHARDS", "0")
    single = ForestCache(heights=2, spill=2, device="cpu").put(1, eds)
    assert type(single) is CachedForest
    sampler, jax_sampler = ProofSampler(device="cpu"), JaxSampler()
    coords = quadrant_coords(k)
    for axis in ("row", "col"):
        got = wire(sampler.sample_batch(entry, coords, axis=axis))
        assert got == wire(jax_sampler.sample_batch(jax_entry, coords, axis=axis)), axis
        assert got == wire(sampler.sample_batch(single, coords, axis=axis)), axis
        assert got == wire(sampler.host_proof(entry, r, c, axis) for r, c in coords), axis
        flat = [entry.flat_index(t, lvl, 0) for t in (0, 2 * k - 1) for lvl in range(5)]
        assert np.array_equal(entry.gather(axis, flat), single.gather(axis, flat))
        assert np.array_equal(entry.gather(axis, flat), jax_entry.gather(axis, flat))
    if construction == "vandermonde":
        proof = sampler.sample_batch(entry, [(3, 11)])[0]
        assert hashlib.sha256(wire([proof])[0]).hexdigest() == SAMPLE_3_11_VANDERMONDE


def test_spilled_sharded_entry_serves_identical_bytes(monkeypatch):
    monkeypatch.setenv("CELESTIA_SERVE_SHARDS", "4")
    cache = ForestCache(heights=1, spill=2, device="cpu")
    entry = cache.put(1, square(4, "vandermonde", seed=9)[0])
    sampler = ProofSampler(device="cpu")
    coords = [(0, 0), (5, 7), (7, 2)]
    before = wire(sampler.sample_batch(entry, coords))
    cache.put(2, square(4, "vandermonde", seed=10)[0])
    spilled, tier = cache.get(1)
    assert tier == "host" and spilled is entry and not entry.device_resident
    assert isinstance(entry.row_flat, torch.Tensor)  # one host tensor after spill
    assert wire(sampler.sample_batch(entry, coords)) == before
    assert cache.stats()["mesh"]["shards"] == 4


def test_forest_layout_and_routing_are_layout_math(monkeypatch):
    monkeypatch.setenv("CELESTIA_SERVE_SHARDS", "8")
    eds = square(2, "vandermonde", seed=13)[0]
    entry = shard.build_entry(8, eds, device="cpu")
    n = 2 * entry.k
    assert entry.forest_rows == n * (2 * n - 1)
    assert entry.row_flat.shape[0] % entry.shards == 0
    assert entry.row_flat.shape[0] >= entry.forest_rows
    assert entry.row_flat.owners == tuple(range(8))
    want = forest(2, "cpu")(eds._eds)
    assert torch.equal(entry.row_flat.cpu()[:entry.forest_rows], want[0])
    assert torch.equal(entry.col_flat.cpu()[:entry.forest_rows], want[1])
    idx = [0, 1, entry.rows_per_shard, entry.forest_rows - 1]
    local, (owner, slot), counts = route_to_shards(idx, entry.shards, entry.rows_per_shard)
    assert int(sum(counts)) == len(idx)
    for i, flat in enumerate(idx):
        s = int(owner[i])
        assert s == flat // entry.rows_per_shard == entry.row_flat.owner_of_row(flat)
        assert local[s, slot[i]] == flat - s * entry.rows_per_shard
    for k in (2, 8, 64):
        for shards in (2, 3, 8):
            for row, col, axis in ((0, 0, "row"), (5 % (2 * k), 1, "col"), (2 * k - 1, 3, "row")):
                assert shard.leaf_shard_of(k, shards, row, col, axis) == \
                    jax_shard.leaf_shard_of(k, shards, row, col, axis)
    assert entry.leaf_shard(3, 1, "col") == jax_shard.leaf_shard_of(2, 8, 3, 1, "col")


@pytest.mark.parametrize("raw", [None, "", "0", "1", "2", "8", "64", "banana", "-4"])
def test_serve_shards_knob_equals_jax(raw, monkeypatch, recwarn):
    if raw is not None:
        monkeypatch.setenv("CELESTIA_SERVE_SHARDS", raw)
    got = shard.serve_shards("cpu")
    port_warnings = [str(w.message) for w in recwarn.list]
    recwarn.clear()
    assert got == jax_shard.serve_shards()
    assert port_warnings == [str(w.message) for w in recwarn.list]
    if raw in ("64", "banana"):
        assert len(port_warnings) == 1


def test_stats_mesh_block_equals_jax(monkeypatch):
    eds, jax_eds = square(2, "vandermonde", seed=21)
    monkeypatch.setenv("CELESTIA_SERVE_SHARDS", "8")
    cache, jax_cache = ForestCache(heights=2, spill=2, device="cpu"), JaxForestCache(heights=2,
                                                                                     spill=2)
    cache.put(1, eds)
    jax_cache.put(1, jax_eds)
    assert cache.stats()["mesh"] == jax_cache.stats()["mesh"]
    monkeypatch.setenv("CELESTIA_SERVE_SHARDS", "0")
    plain = ForestCache(heights=2, spill=2, device="cpu")
    plain.put(1, eds)
    assert plain.stats()["mesh"] is None


def test_share_reads_route_to_the_owning_shard_as_jax():
    """A row-sharded EDS from the sharded extend: share reads, parity
    quadrants included, equal the JAX sharded share gather and the host
    bytes; each row is read from the block of its owning shard."""
    k, n = 8, 4
    ods = det_square(k, seed=3)
    eds, rr, cr, droot = sharded_eds.sharded_extend_and_dah(ods, Mesh(["cpu"] * n, "data"))
    jax_eds = jax_sharded_extend(ods, jax_default_mesh(n))[0]
    assert shard.eds_share_layout(eds)[1:] == ("data", n)
    assert jax_shard.eds_share_layout(jax_eds)[1:] == ("data", n)
    assert shard.eds_share_layout(eds.cpu()) is None
    coords = quadrant_coords(k) + [(r, c) for r in range(0, 2 * k, 3) for c in (0, 2 * k - 1)]
    got = shard.sharded_share_gather(eds, coords)
    assert np.array_equal(got, jax_shard.sharded_share_gather(jax_eds, coords))
    full = eds.numpy()
    assert np.array_equal(got, np.stack([full[r, c] for r, c in coords]))
    handle = ExtendedDataSquare(eds, rr, cr, droot, k)
    entry = ForestCache(heights=1, spill=1, device="cpu").put(1, handle)
    assert entry.share_shards == n
    assert np.array_equal(entry.gather_shares(coords), got)
    assert entry.eds._eds is eds  # kept as it arrived: no copy, no reshard


def test_serve_sharded_forests_over_extend_sharded_shares(monkeypatch):
    """Both meshes at once: the sharded panel lowering's EDS (two slabs per
    extend shard) retained under an 8-wide serve mesh, proofs equal to the
    single-device plane's."""
    k = 8
    ods = det_square(k, seed=4)
    ref = ExtendedDataSquare.compute(ods, device="cpu")
    monkeypatch.setenv("CELESTIA_PIPE_PANEL", "3")
    monkeypatch.setenv("CELESTIA_EXTEND_SHARDS", "2")
    eds = ExtendedDataSquare.compute(ods, device="cpu")
    assert isinstance(eds._eds, RowSharded) and eds._eds.owners == (0, 1, 0, 1)
    monkeypatch.setenv("CELESTIA_SERVE_SHARDS", "8")
    entry = ForestCache(heights=1, spill=1, device="cpu").put(1, eds)
    assert isinstance(entry, shard.ShardedCachedForest) and entry.share_shards == 2
    monkeypatch.setenv("CELESTIA_SERVE_SHARDS", "0")
    single = ForestCache(heights=1, spill=1, device="cpu").put(1, ref)
    sampler = ProofSampler(device="cpu")
    coords = quadrant_coords(k)
    for axis in ("row", "col"):
        assert wire(sampler.sample_batch(entry, coords, axis=axis)) == \
            wire(sampler.sample_batch(single, coords, axis=axis))
    assert os.environ.get("CELESTIA_SERVE_SHARDS") == "0"
