"""The port's NMT and Merkle reductions (plain versions, on the CPU) against
the JAX package's device functions and its host hashers."""

from __future__ import annotations

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_app_tpu import merkle as jax_host_merkle
from celestia_app_tpu.kernels import merkle as jax_merkle
from celestia_app_tpu.kernels import nmt as jax_nmt
from celestia_app_tpu.nmt.hasher import NmtHasher
from celestia_app_tpu_torch import merkle as host_merkle
from celestia_app_tpu_torch.constants import PARITY_NAMESPACE_BYTES
from celestia_app_tpu_torch.kernels import nmt
from celestia_app_tpu_torch.kernels.merkle import merkle_root_pow2


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


_PARITY = np.frombuffer(PARITY_NAMESPACE_BYTES, dtype=np.uint8)


def _leaves(t: int, l: int, d: int, seed: int, parity_from: int | None = None):
    """T trees of L leaves with non-decreasing namespaces along each tree;
    leaves at index >= parity_from carry the parity namespace."""
    rng = np.random.default_rng(seed)
    ns = np.zeros((t, l, 29), dtype=np.uint8)
    ns[..., 21:] = np.sort(rng.integers(0, 256, (t, l), dtype=np.uint8), axis=1)[..., None]
    if parity_from is not None:
        ns[:, parity_from:] = _PARITY
    data = rng.integers(0, 256, (t, l, d), dtype=np.uint8)
    return ns, data


def _np(levels_or_tensors):
    return [np.asarray(x) for x in levels_or_tensors]


@pytest.mark.parametrize("d", [512, 64])
def test_leaf_digests_equal_jax_and_host(d):
    ns, data = _leaves(3, 4, d, seed=d)
    got = _np(nmt.leaf_digests(torch.from_numpy(ns), torch.from_numpy(data)))
    want = _np(jax_nmt.leaf_digests(jnp.asarray(ns), jnp.asarray(data)))
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    host = NmtHasher.hash_leaf(ns[1, 2].tobytes() + data[1, 2].tobytes())
    assert got[0][1, 2].tobytes() + got[1][1, 2].tobytes() + got[2][1, 2].tobytes() == host


@pytest.mark.parametrize("parity_from", [None, 2, 3])
def test_reduce_level_ignore_max_rule(parity_from):
    """A right child whose min is the parity namespace leaves the parent's
    max at the left child's max."""
    ns, data = _leaves(2, 4, 512, seed=9, parity_from=parity_from)
    digests = nmt.leaf_digests(torch.from_numpy(ns), torch.from_numpy(data))
    got = _np(nmt.reduce_level(*digests))
    want = _np(jax_nmt.reduce_level(*(jnp.asarray(x.numpy()) for x in digests)))
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    leaf = [[b"".join(x[t, i].numpy().tobytes() for x in digests) for i in range(4)]
            for t in range(2)]
    for t in range(2):
        for p in range(2):
            node = NmtHasher.hash_node(leaf[t][2 * p], leaf[t][2 * p + 1])
            assert b"".join(g[t, p].tobytes() for g in got) == node
    if parity_from == 3:  # pair (2, 3): right child parity, left not
        assert got[1][0, 1].tobytes() == ns[0, 2].tobytes()


@pytest.mark.parametrize("t,l", [(1, 1), (4, 2), (2, 8)])
def test_tree_roots_equal_jax(t, l):
    ns, data = _leaves(t, l, 512, seed=t * l, parity_from=l // 2 if l > 1 else None)
    digests = nmt.leaf_digests(torch.from_numpy(ns), torch.from_numpy(data))
    got = nmt.tree_roots_from_digests(*digests).numpy()
    jd = [jnp.asarray(x.numpy()) for x in digests]
    assert np.array_equal(got, np.asarray(jax.jit(jax_nmt.tree_roots_from_digests)(*jd)))
    levels = nmt.tree_levels_from_digests(*digests)
    assert len(levels) == l.bit_length()
    assert np.array_equal(nmt.roots_from_levels(levels).numpy(), got)
    half = nmt.reduce_to_width(*digests, width=max(1, l // 2))
    assert half[2].shape[1] == max(1, l // 2)


@pytest.mark.parametrize("n,width", [(1, 90), (8, 90), (4, 32)])
def test_merkle_root_pow2_equals_jax_and_host(n, width):
    leaves = np.random.default_rng(n).integers(0, 256, (n, width), dtype=np.uint8)
    got = merkle_root_pow2(torch.from_numpy(leaves)).numpy().tobytes()
    assert got == np.asarray(jax.jit(jax_merkle.merkle_root_pow2)(jnp.asarray(leaves))).tobytes()
    items = [leaves[i].tobytes() for i in range(n)]
    assert got == host_merkle.hash_from_byte_slices(items)
    assert got == jax_host_merkle.hash_from_byte_slices(items)


def test_host_merkle_equals_jax_package_on_any_count():
    items = [bytes([i]) * (i + 1) for i in range(13)]
    for n in range(14):
        assert host_merkle.hash_from_byte_slices(items[:n]) == \
            jax_host_merkle.hash_from_byte_slices(items[:n])
    with pytest.raises(ValueError):
        merkle_root_pow2(torch.zeros((3, 90), dtype=torch.uint8))


# --- multiproofs and namespace proofs (nmt/proof.py, second half) ------------


def _trees(n: int, seed: int):
    """The same NMT of n leaves in both packages: namespaces in runs, a
    parity tail, raw 48-byte leaves."""
    from celestia_app_tpu.nmt.tree import NamespacedMerkleTree as JaxTree
    from celestia_app_tpu_torch.nmt.tree import NamespacedMerkleTree

    rng = np.random.default_rng(seed)
    ns = np.sort(rng.integers(1, 6, n))
    ours, theirs = NamespacedMerkleTree(), JaxTree()
    for i in range(n):
        namespace = (PARITY_NAMESPACE_BYTES if i >= n - n // 4 and n > 2
                     else bytes(28) + bytes([int(ns[i])]))
        leaf = namespace + rng.integers(0, 256, 48, dtype=np.uint8).tobytes()
        ours.push(leaf)
        theirs.push(leaf)
    return ours, theirs


@pytest.mark.parametrize("n,seed", [(2, 1), (8, 2), (16, 3), (64, 4)])
def test_multiproofs_equal_jax(n, seed):
    from celestia_app_tpu.nmt import proof as jax_proof
    from celestia_app_tpu_torch.nmt import proof

    ours, theirs = _trees(n, seed)
    assert ours.root() == theirs.root()
    rng = np.random.default_rng(seed)
    cuts = sorted(set(int(c) for c in rng.integers(0, n + 1, 6)) | {0, n})
    ranges = [(a, b) for a, b in zip(cuts, cuts[1:]) if rng.random() < 0.7] or [(0, n)]
    levels = ours.levels()
    mp = proof.multiproof_from_levels(levels, ranges)
    want = jax_proof.multiproof_from_levels(theirs.levels(), ranges)
    assert (mp.ranges, mp.nodes, mp.node_refs, mp.total) == \
        (want.ranges, want.nodes, want.node_refs, want.total)
    parts = proof.split_multiproof(mp)
    for (s, e), part in zip(ranges, parts):
        alone = proof.prove_range(ours, s, e)
        assert (part.start, part.end, part.nodes, part.total) == \
            (alone.start, alone.end, alone.nodes, alone.total)
    leaves = [[ours._leaves[i] for i in range(s, e)] for s, e in ranges]
    assert proof.verify_multiproof(ours.root(), mp, leaves)
    assert jax_proof.verify_multiproof(theirs.root(), want, leaves)
    bad = [list(x) for x in leaves]
    bad[0][0] = bad[0][0][:-1] + bytes([bad[0][0][-1] ^ 1])
    assert not proof.verify_multiproof(ours.root(), mp, bad)
    assert not proof.verify_multiproof(ours.root(), mp, leaves[:-1] if len(leaves) > 1 else [])
    broken = proof.NmtMultiProof(mp.ranges, mp.nodes, ((len(mp.nodes) + 5,),) * len(mp.ranges),
                                 mp.total)
    assert not proof.verify_multiproof(ours.root(), broken, leaves)
    for args in ([(3, 2)], [(0, 2), (1, 3)], [], [(0, n + 1)]):
        with pytest.raises(ValueError):
            proof.multiproof_from_levels(levels, args)


@pytest.mark.parametrize("n,seed", [(8, 5), (16, 6), (32, 7)])
def test_namespace_proofs_equal_jax(n, seed):
    from celestia_app_tpu.nmt import proof as jax_proof
    from celestia_app_tpu_torch.nmt import proof

    ours, theirs = _trees(n, seed)
    root = ours.root()
    queries = [bytes(28) + bytes([v]) for v in range(0, 8)] + [PARITY_NAMESPACE_BYTES]
    for namespace in queries:
        p, leaves = proof.prove_namespace(ours, namespace)
        q, want_leaves = jax_proof.prove_namespace(theirs, namespace)
        assert (p.start, p.end, p.nodes, p.total) == (q.start, q.end, q.nodes, q.total)
        assert leaves == want_leaves
        absence = None if leaves else ours.levels()[0][p.start]
        got = proof.verify_namespace(root, p, namespace, leaves, absence)
        assert got == jax_proof.verify_namespace(root, q, namespace, leaves, absence)
        assert got
        # Claiming a neighbour's namespace with this proof fails in both.
        other = bytes(28) + bytes([(namespace[-1] + 1) % 256])
        assert proof.verify_namespace(root, p, other, leaves, absence) == \
            jax_proof.verify_namespace(root, q, other, leaves, absence)
    p, leaves = proof.prove_namespace(ours, queries[2])
    assert not proof.verify_namespace(root, p, queries[2], [], None)
