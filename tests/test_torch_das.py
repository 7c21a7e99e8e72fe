"""The port's read side on the CPU, held against the JAX package: the flat
NMT forests, the sampler's proofs, the DAS golden payloads, the batched
verifier's verdicts, and the host copies (merkle audit paths, NmtHasher,
NamespacedMerkleTree, nmt range proofs, ShareProof.verify).

The JAX handles are built from the port's own square and roots, so the JAX
side compiles only its forest and verifier programs.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_app_tpu import merkle as jax_merkle
from celestia_app_tpu.da.eds import ExtendedDataSquare as JaxEDS
from celestia_app_tpu.kernels.fused import forest_level_layout as jax_forest_level_layout
from celestia_app_tpu.kernels.fused import jit_forest
from celestia_app_tpu.nmt import proof as jax_nmt_proof
from celestia_app_tpu.nmt.hasher import NmtHasher as JaxNmtHasher
from celestia_app_tpu.nmt.tree import NamespacedMerkleTree as JaxTree
from celestia_app_tpu.rpc.codec import share_proof_from_json, to_jsonable
from celestia_app_tpu.serve.api import render
from celestia_app_tpu.serve.cache import ForestCache as JaxForestCache
from celestia_app_tpu.serve.sampler import ProofSampler as JaxSampler
from celestia_app_tpu.serve.verify import leaf_digests as jax_leaf_digests
from celestia_app_tpu.serve.verify import verify_proofs as jax_verify_proofs
from celestia_app_tpu_torch import merkle
from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, PARITY_NAMESPACE_BYTES, SHARE_SIZE
from celestia_app_tpu_torch.da import extend_shares
from celestia_app_tpu_torch.kernels.fused import (
    forest,
    forest_fn,
    forest_level_layout,
    leaf_namespaces,
)
from celestia_app_tpu_torch.kernels.nmt import leaf_digests as nmt_leaf_digests
from celestia_app_tpu_torch.kernels.nmt import tree_levels_from_digests
from celestia_app_tpu_torch.nmt import proof as nmt_proof
from celestia_app_tpu_torch.nmt.hasher import NmtHasher
from celestia_app_tpu_torch.nmt.tree import NamespacedMerkleTree
from celestia_app_tpu_torch.proof.share_proof import (
    ShareProof,
    new_namespace_proof,
    new_share_inclusion_proof,
    new_share_sample_proof,
)
from celestia_app_tpu_torch.serve import ForestCache, ProofSampler
from celestia_app_tpu_torch.serve.sampler import BadProofDetected
from celestia_app_tpu_torch.serve.verify import leaf_digests, verify_mode, verify_proofs


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


def det_square(k: int, seed: int = 1) -> np.ndarray:
    """The namespace-ordered ODS of tests/test_das_proofs.py."""
    rng = np.random.default_rng(seed)
    ns = np.sort(rng.integers(0, 128, k * k).astype(np.uint8))
    ods = rng.integers(0, 256, (k * k, SHARE_SIZE), dtype=np.uint8)
    ods[:, :NAMESPACE_SIZE] = 0
    ods[:, NAMESPACE_SIZE - 1] = ns
    return ods


_SQUARES: dict = {}


def square(k: int, construction: str, seed: int = 1):
    """(port EDS, JAX EDS handle over the same bytes and roots), cached."""
    key = (k, construction, seed)
    if key not in _SQUARES:
        eds = extend_shares([s.tobytes() for s in det_square(k, seed)], construction,
                            device="cpu")
        jax_eds = JaxEDS(jnp.asarray(eds.squared()), eds.row_roots(), eds.col_roots(),
                         eds.data_root(), k)
        _SQUARES[key] = (eds, jax_eds)
    return _SQUARES[key]


def run_square(k: int, construction: str):
    """A square whose namespaces come in runs of k shares, k/2 shares off
    the row boundaries, so each run spans two rows."""
    ods = det_square(k, seed=5)
    ods[:, NAMESPACE_SIZE - 1] = (np.arange(k * k) + k // 2) // k
    return extend_shares([s.tobytes() for s in ods], construction, device="cpu")


def multi_row_proof(eds) -> ShareProof:
    k = eds.k
    proof = new_share_inclusion_proof(eds, k // 2, k // 2 + k)
    assert len(proof.share_proofs) == 2
    return proof


def entries(k: int, construction: str, seed: int = 1):
    """(port entry, JAX entry) of one retained height."""
    eds, jax_eds = square(k, construction, seed)
    return (ForestCache(heights=1, spill=1, device="cpu").put(1, eds),
            JaxForestCache(heights=1, spill=1).put(1, jax_eds))


def wire(proof) -> bytes:
    return render(to_jsonable(proof))


def as_jax(proof):
    """The JAX package's dataclasses holding the same proof fields."""
    return share_proof_from_json(to_jsonable(proof))


def quadrant_coords(k: int) -> list[tuple[int, int]]:
    n = 2 * k
    return sorted({(0, 0), (k - 1, k - 1), (0, n - 1), (k - 1, k), (n - 1, 0), (k, k - 1),
                   (n - 1, n - 1), (k, k), (k // 2, n - 2), (n - 2, k // 2)})


# --- forests -----------------------------------------------------------------


@pytest.mark.parametrize("construction", CONSTRUCTIONS)
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_forest_matches_jax(k, construction):
    eds, _ = square(k, construction)
    assert forest_level_layout(k) == jax_forest_level_layout(k)
    row_flat, col_flat = forest_fn(k)(eds._eds)
    want_row, want_col = jit_forest(k)(jnp.asarray(eds.squared()))
    assert np.array_equal(row_flat.numpy(), np.asarray(want_row))
    assert np.array_equal(col_flat.numpy(), np.asarray(want_col))
    assert torch.equal(forest(k, "cpu")(eds._eds)[1], col_flat)


def test_forest_levels_are_the_tree_levels():
    """Each level of the flat forests, read through forest_level_layout,
    is the level tree_levels_from_digests gives; the top level is the
    square's roots."""
    k = 4
    eds, _ = square(k, "vandermonde")
    widths, offsets = forest_level_layout(k)
    mins, maxs, hashes = nmt_leaf_digests(leaf_namespaces(eds._eds, k), eds._eds)
    for flat, levels in zip(
            forest_fn(k)(eds._eds),
            (tree_levels_from_digests(mins, maxs, hashes),
             tree_levels_from_digests(*(t.transpose(0, 1).contiguous()
                                        for t in (mins, maxs, hashes))))):
        for w, off, (m, x, h) in zip(widths, offsets, levels):
            level = flat[off:off + 2 * k * w].reshape(2 * k, w, 90)
            assert torch.equal(level, torch.cat([m, x, h], dim=2))
    row_flat, col_flat = forest_fn(k)(eds._eds)
    top = offsets[-1]
    assert [bytes(r.numpy()) for r in row_flat[top:]] == eds.row_roots()
    assert [bytes(r.numpy()) for r in col_flat[top:]] == eds.col_roots()


# --- the sampler -------------------------------------------------------------


@pytest.mark.parametrize("construction", CONSTRUCTIONS)
@pytest.mark.parametrize("k", [2, 8])
def test_sample_batch_matches_jax(k, construction):
    """Every quadrant, both axes: the port's batched proofs equal the JAX
    sampler's field by field and as wire bytes, and the port's and the
    JAX package's host lowerings."""
    entry, jax_entry = entries(k, construction)
    coords = quadrant_coords(k)
    sampler, jax_sampler = ProofSampler(device="cpu"), JaxSampler()
    root = entry.data_root
    for axis in ("row", "col"):
        got = sampler.sample_batch(entry, coords, axis=axis)
        want = jax_sampler.sample_batch(jax_entry, coords, axis=axis)
        for (row, col), p, w in zip(coords, got, want):
            assert to_jsonable(p) == to_jsonable(w), (row, col, axis)
            assert wire(p) == wire(w)
            assert p == sampler.host_proof(entry, row, col, axis)
            assert wire(p) == wire(jax_sampler.host_proof(jax_entry, row, col, axis))
            assert p.verify(root)


def test_forest_backed_trees_equal_host_trees():
    k = 4
    eds, _ = square(k, "leopard", seed=3)
    entry = ForestCache(heights=1, spill=1, device="cpu").put(1, eds)
    assert eds._forest is entry
    for i in (0, k, 2 * k - 1):
        assert eds.row_tree(i).levels() == eds.row_tree(i, host=True).levels()
        assert eds.col_tree(i).levels() == eds.col_tree(i, host=True).levels()
    assert eds.leaf_namespace(0, 0) == eds.squared()[0, 0, :NAMESPACE_SIZE].tobytes()
    assert eds.leaf_namespace(0, k) == PARITY_NAMESPACE_BYTES


class TestGoldenPins:
    """The payload digests pinned in tests/test_das_proofs.py, through the
    port's constructors and its batched sampler."""

    ROOTS = {
        "vandermonde": "1383e9f9ad9f7b01e37f9f0928087136ca4dcd254779f6d47c91a5a0720f3626",
        "leopard": "1d689b0e786d39dcd1e7a7c52ba20fbd16c33dbacbf7965b7cdde2d13b1657f5",
    }
    SAMPLE_3_11 = {
        "vandermonde": "43147e47f167ac87c90e408127e212d601e856397dc673d2e265824194fcbd04",
        "leopard": "c9b208db2f8f23623b4d9c47b5079b3099c840587935152f386c91bb9d8dee0d",
    }
    NS_PROOF = {
        "vandermonde": "3fc7f5be55807dc4fc7bc2dad9cb88444de4c0ccce56ceb6d20999b849b85e0d",
        "leopard": "cd1c091c5ea3604cd2ebf49e0e2251a4f3e76e36b16bf38da5a2d0fa241c5ff2",
    }

    @pytest.mark.parametrize("construction", CONSTRUCTIONS)
    def test_golden_sample_and_namespace_payloads(self, construction):
        eds = extend_shares([s.tobytes() for s in det_square(8)], construction, device="cpu")
        assert eds.data_root().hex() == self.ROOTS[construction]
        sample = new_share_sample_proof(eds, 3, 11)
        assert hashlib.sha256(wire(sample)).hexdigest() == self.SAMPLE_3_11[construction]
        nsp = new_namespace_proof(eds, bytes(28) + b"\x25")
        assert hashlib.sha256(wire(nsp)).hexdigest() == self.NS_PROOF[construction]
        assert nsp.verify(eds.data_root())

    @pytest.mark.parametrize("construction", CONSTRUCTIONS)
    def test_batched_path_reproduces_the_golden_bytes(self, construction):
        eds = extend_shares([s.tobytes() for s in det_square(8)], construction, device="cpu")
        entry = ForestCache(heights=1, spill=1, device="cpu").put(1, eds)
        proof = ProofSampler(device="cpu").sample_batch(entry, [(3, 11)])[0]
        assert hashlib.sha256(wire(proof)).hexdigest() == self.SAMPLE_3_11[construction]
        # With the forest attached the constructors index it: same bytes.
        nsp = new_namespace_proof(eds, bytes(28) + b"\x25")
        assert hashlib.sha256(wire(nsp)).hexdigest() == self.NS_PROOF[construction]


def test_share_proof_queue_and_serve_modes(monkeypatch):
    """Concurrent share_proof callers get the batch's proofs; the host
    lowering gives the same bytes; the verification gate passes honest
    proofs and refuses a forged data root."""
    k = 4
    entry, _ = entries(k, "vandermonde")
    sampler = ProofSampler(device="cpu")
    coords = [(r, c) for r in range(0, 2 * k, 3) for c in range(0, 2 * k, 2)]
    want = {(r, c, axis): p for axis in ("row", "col")
            for (r, c), p in zip(coords, sampler.sample_batch(entry, coords, axis))}
    monkeypatch.setenv("CELESTIA_SERVE_BATCH_MS", "20")
    got: dict = {}

    def ask(r, c, axis):
        got[(r, c, axis)] = sampler.share_proof(entry, r, c, axis, timeout_s=60)

    threads = [threading.Thread(target=ask, args=key) for key in want]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert got == want
    monkeypatch.setenv("CELESTIA_SERVE_MODE", "host")
    assert sampler.sample_batch(entry, coords) == [want[(r, c, "row")] for r, c in coords]
    monkeypatch.setenv("CELESTIA_SERVE_VERIFY", "1")
    monkeypatch.delenv("CELESTIA_SERVE_MODE")
    assert sampler.sample_batch(entry, coords[:3]) == [want[(r, c, "row")]
                                                      for r, c in coords[:3]]
    entry.data_root = bytes(32)
    with pytest.raises(BadProofDetected):
        sampler.sample_batch(entry, coords[:3])
    with pytest.raises(ValueError):
        sampler.sample_batch(entry, [(2 * k, 0)])
    with pytest.raises(ValueError):
        sampler.sample_batch(entry, [(0, 0)], axis="diag")


def test_concurrent_puts_of_one_height_build_one_forest(monkeypatch):
    """Eight threads put one height at once: one forest build, one entry."""
    import sys

    from celestia_app_tpu_torch.serve import cache as cache_mod

    eds, _ = square(4, "vandermonde", seed=9)
    builds = []
    real = cache_mod.forest

    def counting(k, device):
        builds.append(k)
        return real(k, device)

    monkeypatch.setattr(cache_mod, "forest", counting)
    cache = ForestCache(heights=2, spill=2, device="cpu")
    got: list = []
    barrier = threading.Barrier(8)

    def put():
        barrier.wait(timeout=60)
        got.append(cache.put(7, eds))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=put) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and all(e is got[0] for e in got)
    assert builds == [4]


def test_forest_cache_tiers():
    eds1, _ = square(8, "vandermonde", seed=6)
    eds2, _ = square(8, "vandermonde", seed=7)
    cache = ForestCache(heights=1, spill=1, device="cpu")
    sampler = ProofSampler(device="cpu")
    entry = cache.put(1, eds1)
    assert cache.put(1, eds1) is entry
    on_device = sampler.sample_batch(entry, [(0, 0), (9, 13)])
    cache.put(2, eds2)
    spilled, tier = cache.get(1)
    assert tier == "host" and spilled is entry and not entry.device_resident
    assert sampler.sample_batch(entry, [(0, 0), (9, 13)]) == on_device
    assert cache.contains(1) and cache.contains(2)
    assert cache.get(2)[1] == "device"
    cache.put(3, square(8, "vandermonde", seed=8)[0])  # drops height 1
    assert cache.get(1) == (None, "miss") and not cache.contains(1)
    stats = cache.stats()
    assert stats["device_heights"] == [3] and stats["host_heights"] == [2]
    assert stats["hits"] == {"device": 1, "host": 1} and stats["misses"] == 1
    assert stats["hit_ratio"] == round(2 / 3, 4) and stats["last_eviction"] == 2
    assert ForestCache(heights=0, device="cpu").put(9, eds1) is None


# --- the batched verifier ------------------------------------------------------


def _flip_share(proof, offset=100):
    raw = bytearray(proof.data[0])
    raw[offset] ^= 0xFF
    return dataclasses.replace(proof, data=(bytes(raw),))


def _swap_siblings(proof):
    nmt = proof.share_proofs[0]
    nodes = list(nmt.nodes)
    nodes[0], nodes[1] = nodes[1], nodes[0]
    return dataclasses.replace(proof, share_proofs=(dataclasses.replace(nmt, nodes=tuple(nodes)),))


def _wrong_row_root(proof):
    rp = proof.row_proof
    root = bytearray(rp.row_roots[0])
    root[-1] ^= 1
    return dataclasses.replace(proof, row_proof=dataclasses.replace(rp, row_roots=(bytes(root),)))


def _short_share(proof):
    return dataclasses.replace(proof, data=(proof.data[0][:100],))


@pytest.mark.parametrize("construction", CONSTRUCTIONS)
def test_verify_proofs_matches_jax(construction, monkeypatch):
    """Accept and reject queues: tampered shares, swapped siblings, wrong row
    roots, a forged data root, a malformed share, non-canonical multi-row
    proofs, and two heights in one queue.  The port's verdicts equal the
    JAX package's and the host verifier's, in both verify modes."""
    k = 8
    entry, _ = entries(k, construction)
    other, _ = entries(4, construction, seed=2)
    sampler = ProofSampler(device="cpu")
    rng = np.random.default_rng(11)
    coords = [tuple(int(v) for v in rng.integers(0, 2 * k, 2)) for _ in range(24)]
    queue = sampler.sample_batch(entry, coords[:12]) + sampler.sample_batch(entry, coords[12:],
                                                                            axis="col")
    roots = [entry.data_root] * len(queue)
    queue[1] = _flip_share(queue[1])
    queue[4] = _swap_siblings(queue[4])
    queue[7] = _wrong_row_root(queue[7])
    queue[9] = _short_share(queue[9])
    roots[13] = bytes(32)
    runs = run_square(k, construction)
    multi = multi_row_proof(runs)
    queue += [multi, dataclasses.replace(multi, data=multi.data[:-1])]
    roots += [runs.data_root()] * 2
    queue += sampler.sample_batch(other, [(0, 1), (7, 7), (5, 2)])
    roots += [other.data_root] * 3
    want = [p.verify(r) for p, r in zip(queue, roots)]
    assert want.count(False) == 6
    jax_queue = [as_jax(p) for p in queue]
    assert [p.verify(r) for p, r in zip(jax_queue, roots)] == want
    assert jax_verify_proofs(jax_queue, roots) == want
    assert verify_proofs(queue, roots, device="cpu") == want
    monkeypatch.setenv("CELESTIA_VERIFY_MODE", "host")
    assert verify_mode() == "host"
    assert verify_proofs(queue, roots, device="cpu") == want
    monkeypatch.delenv("CELESTIA_VERIFY_MODE")
    assert verify_proofs(queue[:24], bytes(32), device="cpu") == [False] * 24
    assert verify_proofs([], bytes(32), device="cpu") == []
    with pytest.raises(ValueError):
        verify_proofs(queue, roots[:3], device="cpu")


def test_leaf_digests_match_jax(monkeypatch):
    rng = np.random.default_rng(3)
    ns = rng.integers(0, 256, (5, NAMESPACE_SIZE), dtype=np.uint8)
    ns[-1] = 0xFF
    shares = rng.integers(0, 256, (5, SHARE_SIZE), dtype=np.uint8)
    want = np.asarray(jax_leaf_digests(ns, shares))
    assert np.array_equal(leaf_digests(ns, shares, device="cpu"), want)
    assert want[0].tobytes() == JaxNmtHasher.hash_leaf(ns[0].tobytes() + shares[0].tobytes())
    monkeypatch.setenv("CELESTIA_VERIFY_MODE", "host")
    assert np.array_equal(leaf_digests(ns, shares, device="cpu"), want)
    assert leaf_digests(ns[:0], shares[:0], device="cpu").shape == (0, 90)


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    eds, _ = square(2, "vandermonde")
    for call in (lambda: forest(2), lambda: ForestCache(), lambda: ProofSampler(),
                 lambda: verify_proofs([], bytes(32)), lambda: leaf_digests(
                     np.zeros((1, 29), np.uint8), np.zeros((1, 512), np.uint8))):
        with pytest.raises(RuntimeError):
            call()


# --- the host copies -------------------------------------------------------------


def _ns(rng, n):
    """n sorted random namespaces, the last one the parity namespace."""
    ids = sorted(rng.integers(0, 256, (n, NAMESPACE_SIZE), dtype=np.uint8).tolist())
    out = [bytes(i) for i in ids]
    out[-1] = PARITY_NAMESPACE_BYTES
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9])
def test_merkle_copies_match(n):
    rng = np.random.default_rng(n)
    items = [rng.bytes(int(rng.integers(0, 100))) for _ in range(n)]
    assert merkle.hash_from_byte_slices(items) == jax_merkle.hash_from_byte_slices(items)
    root = merkle.hash_from_byte_slices(items)
    for i in range(n):
        path = merkle.proof(items, i)
        assert path == jax_merkle.proof(items, i)
        leaf_h = merkle.leaf_hash(items[i])
        assert (merkle.compute_root_from_path(i, n, leaf_h, path)
                == jax_merkle.compute_root_from_path(i, n, leaf_h, path) == root)
        assert merkle.verify_proof(root, items[i], i, n, path)
        assert not merkle.verify_proof(root, items[i] + b"x", i, n, path)
        assert (merkle.verify_proof(root, items[i], i, n, path[:-1])
                == jax_merkle.verify_proof(root, items[i], i, n, path[:-1]))
    if n & (n - 1) == 0:
        levels = merkle.levels_from_leaves(items)
        assert levels == jax_merkle.levels_from_leaves(items)
        assert all(merkle.path_from_levels(levels, i) == merkle.proof(items, i)
                   for i in range(n))
    else:
        with pytest.raises(ValueError):
            merkle.levels_from_leaves(items)


def test_nmt_hasher_copy_matches():
    rng = np.random.default_rng(5)
    a, b, c = _ns(rng, 3)
    leaves = [NmtHasher.hash_leaf(ns + rng.bytes(40)) for ns in (a, b, c)]
    for x, y in ((leaves[0], leaves[1]), (leaves[1], leaves[2]), (leaves[0], leaves[2])):
        assert NmtHasher.hash_node(x, y) == JaxNmtHasher.hash_node(x, y)
    # The ignore-max rule: a parity right child keeps the left max.
    assert NmtHasher.hash_node(leaves[0], leaves[2])[NAMESPACE_SIZE:2 * NAMESPACE_SIZE] == a
    with pytest.raises(ValueError):
        NmtHasher.hash_node(leaves[1], leaves[0])
    with pytest.raises(ValueError):
        NmtHasher.hash_leaf(b"short")
    assert NmtHasher.empty_root() == JaxNmtHasher.empty_root()
    data = a + b"payload"
    assert NmtHasher.hash_leaf(data) == JaxNmtHasher.hash_leaf(data)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 16])
def test_nmt_tree_and_range_proofs_match(n):
    rng = np.random.default_rng(n)
    leaves = [ns + rng.bytes(32) for ns in _ns(rng, n)]
    tree, jax_tree = NamespacedMerkleTree(), JaxTree()
    for leaf in leaves:
        tree.push(leaf)
        jax_tree.push(leaf)
    assert tree.root() == jax_tree.root() and tree.levels() == jax_tree.levels()
    assert len(tree) == n
    root = tree.root()
    for start in range(n):
        for end in range(start + 1, n + 1):
            p = nmt_proof.prove_range(tree, start, end)
            assert dataclasses.astuple(p) == dataclasses.astuple(
                jax_nmt_proof.prove_range(jax_tree, start, end))
            assert nmt_proof.verify_range(root, p, leaves[start:end])
            bad = leaves[start][:-1] + bytes([leaves[start][-1] ^ 1])
            assert not nmt_proof.verify_range(root, p, [bad] + leaves[start + 1:end])
            if n & (n - 1) == 0:
                assert (nmt_proof.range_proof_node_coords(n, start, end)
                        == jax_nmt_proof.range_proof_node_coords(n, start, end))
                assert nmt_proof.prove_range_from_levels(tree.levels(), start, end) == p
    with pytest.raises(RuntimeError):
        tree.push(leaves[0])  # finalized


@pytest.mark.parametrize("construction", CONSTRUCTIONS)
def test_share_proof_verify_copy_matches(construction):
    """The port's ShareProof.verify and the JAX package's, on the same proof
    fields, honest and altered."""
    eds, _ = square(4, construction)
    root = eds.data_root()
    proofs = [new_share_sample_proof(eds, r, c, axis) for r, c in ((0, 0), (5, 2), (7, 7))
              for axis in ("row", "col")]
    proofs += [_flip_share(proofs[0]), _swap_siblings(proofs[1]), _wrong_row_root(proofs[2])]
    for p in proofs:
        assert p.verify(root) == as_jax(p).verify(root)
        assert not p.verify(bytes(32))
    assert [p.verify(root) for p in proofs] == [True] * 6 + [False] * 3
    runs = run_square(4, construction)
    multi = multi_row_proof(runs)
    short = dataclasses.replace(multi, data=multi.data[1:])
    for p, ok in ((multi, True), (short, False), (_flip_share(multi), False)):
        assert p.verify(runs.data_root()) == as_jax(p).verify(runs.data_root()) == ok
