"""The port's blob share commitments on the CPU, byte-identical to the JAX
package: the MMR chunking and subtree coordinates, the host oracle and the
batched path (`create_commitments_batched(..., device="cpu")`, the plain
kernel versions), commitments re-derived from the row trees of a square
the port extended, the memo's cap and its use from several threads,
`kernels.nmt.tree_roots` / `tree_levels` and `NamespacedMerkleTree
.subtree_root`.
"""

from __future__ import annotations

import gc
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_app_tpu.inclusion import commitment as jax_commitment
from celestia_app_tpu.kernels import nmt as jax_nmt
from celestia_app_tpu.nmt.tree import NamespacedMerkleTree as JaxTree
from celestia_app_tpu.shares.namespace import Namespace as JaxNamespace
from celestia_app_tpu.shares.sparse import Blob as JaxBlob
from celestia_app_tpu_torch.constants import PARITY_NAMESPACE_BYTES
from celestia_app_tpu_torch.da import extend_shares
from celestia_app_tpu_torch.inclusion import (
    commitment_from_row_trees,
    create_commitment,
    create_commitments,
    create_commitments_batched,
    merkle_mountain_range_sizes,
    subtree_root_coordinates,
)
from celestia_app_tpu_torch.inclusion import batched
from celestia_app_tpu_torch.kernels import nmt
from celestia_app_tpu_torch.nmt.tree import NamespacedMerkleTree
from celestia_app_tpu_torch.shares import Blob, Namespace
from celestia_app_tpu_torch.square import Builder
from celestia_app_tpu_torch.square.layout import next_share_index, subtree_width
from celestia_app_tpu_torch.tx.envelopes import BlobTx


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



def blob_pair(tag: int, size: int, seed: int) -> tuple[Blob, JaxBlob]:
    """The same blob in the port's and the JAX package's types."""
    data = np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()
    sub_id = bytes([tag]) * 10
    return Blob(Namespace.v0(sub_id), data), JaxBlob(JaxNamespace.v0(sub_id), data)


@pytest.mark.parametrize("max_size", [1, 4, 16, 64, 128])
@pytest.mark.parametrize("total", [0, 1, 3, 11, 170, 513, 4088])
def test_mmr_sizes_equal_jax(total, max_size):
    got = merkle_mountain_range_sizes(total, max_size)
    assert got == jax_commitment.merkle_mountain_range_sizes(total, max_size)
    assert sum(got) == total and all(s & (s - 1) == 0 for s in got)


@pytest.mark.parametrize("square_size", [8, 64, 128])
@pytest.mark.parametrize("count", [1, 3, 63, 170, 1025, 4088, 5000])
def test_subtree_root_coordinates_equal_jax(count, square_size):
    """At an aligned start (the layout's next index after a few shares),
    and at a start one share past it, which misaligns any chunk wider
    than one share: both packages answer alike, or both raise."""
    aligned = next_share_index(5, count, 64)
    for start in (aligned, aligned + 1):
        try:
            want = jax_commitment.subtree_root_coordinates(start, count, square_size, 64)
        except ValueError:
            with pytest.raises(ValueError, match="misaligned"):
                subtree_root_coordinates(start, count, square_size, 64)
            continue
        assert subtree_root_coordinates(start, count, square_size, 64) == want


# The blob sizes of tests/test_batched_commitments.py: 1 share, 3 shares
# (three single-share chunks at threshold 64), 170 shares (42 x 4 + 2),
# and 5000 B.
SIZES = [100, 478 * 3, 478 * 170, 5000]


@pytest.mark.parametrize("size", SIZES)
def test_commitment_equals_jax(size):
    port, ref = blob_pair(3, size, size)
    want = jax_commitment.create_commitment(ref)
    assert create_commitment(port) == want
    assert create_commitments_batched([port], device="cpu") == [want]


def test_batched_many_blobs_equal_jax(monkeypatch):
    """Every size group in one call, a duplicate blob, a second namespace."""
    monkeypatch.setattr(batched, "_COMMIT_MEMO", {})
    pairs = [blob_pair(1 + i % 2, s, 50 + i) for i, s in enumerate(SIZES)]
    pairs.append(pairs[1])
    ports = [p for p, _ in pairs]
    want = [jax_commitment.create_commitment(r) for _, r in pairs]
    assert create_commitments_batched(ports, device="cpu") == want
    assert create_commitments(ports) == want


def test_batched_empty():
    assert create_commitments_batched([], device="cpu") == []


def test_batched_on_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port, _ = blob_pair(1, 100, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_commitments_batched([port])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_commitments_batched([])


@pytest.mark.parametrize("blob_sizes", [[100], [3000, 40_000], [478 * 70, 600, 478 * 3]])
def test_commitment_from_row_trees_equals_jax(blob_sizes):
    """The blob sets of tests/test_inclusion.py, placed by the port's square
    builder and extended by the port on the CPU: the commitment re-derived
    from the EDS row trees equals the JAX blob-local one."""
    pairs = [blob_pair(10 + i, s, 70 + i) for i, s in enumerate(blob_sizes)]
    builder = Builder(64)
    rng = np.random.default_rng(9)
    for port, _ in pairs:
        assert builder.append_blob_tx(BlobTx(rng.bytes(60), (port,)))
    square = builder.export()
    eds = extend_shares(square.share_bytes(), device="cpu")
    trees = {r: eds.row_tree(r) for r in range(square.size)}
    for i, (port, ref) in enumerate(pairs):
        lo, hi = square.blob_share_range(i, 0)
        got = commitment_from_row_trees(trees, lo, hi - lo, square.size)
        assert got == jax_commitment.create_commitment(ref)
        assert got == create_commitments_batched([port], device="cpu")[0]


def test_memo_never_exceeds_cap(monkeypatch):
    """The JAX package's memo-cap regression against the port: a batch with
    more distinct blobs than _COMMIT_MEMO_MAX keeps the memo bounded, the
    survivors are the most recent inserts, and they serve hits."""
    monkeypatch.setattr(batched, "_COMMIT_MEMO_MAX", 4)
    monkeypatch.setattr(batched, "_COMMIT_MEMO", {})
    pairs = [blob_pair(30 + i, 64 + i, 90 + i) for i in range(7)]  # 7 distinct > cap 4
    blobs = [p for p, _ in pairs]
    out = create_commitments_batched(blobs, device="cpu")
    assert out == [jax_commitment.create_commitment(r) for _, r in pairs]
    assert len(batched._COMMIT_MEMO) <= 4
    before = batched.memo_stats()
    again = create_commitments_batched(blobs[-4:], device="cpu")
    after = batched.memo_stats()
    assert again == out[-4:]
    assert (after["hits"] - before["hits"], after["misses"] - before["misses"]) == (4, 0)
    assert len(batched._COMMIT_MEMO) <= 4


def test_threads_share_the_memo(monkeypatch):
    """Four threads on overlapping blob sets at once, with a short switch
    interval: every answer equals the host oracle, the memo stays under its
    cap, and each entry holds its blob's commitment."""
    monkeypatch.setattr(batched, "_COMMIT_MEMO_MAX", 6)
    monkeypatch.setattr(batched, "_COMMIT_MEMO", {})
    pairs = [blob_pair(40 + i, 478 * (1 + i), 110 + i) for i in range(8)]
    want = [jax_commitment.create_commitment(r) for _, r in pairs]
    sets = [list(range(t, t + 5)) for t in range(4)]  # overlapping windows
    results: dict[int, list[bytes]] = {}
    errors: list[BaseException] = []

    def run(t: int) -> None:
        try:
            for _ in range(3):
                results[t] = create_commitments_batched([pairs[i][0] for i in sets[t]],
                                                        device="cpu")
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    for t, idx in enumerate(sets):
        assert results[t] == [want[i] for i in idx]
    assert len(batched._COMMIT_MEMO) <= 6
    by_key = {batched._memo_key(p, 64): c for (p, _), c in zip(pairs, want)}
    assert all(by_key[key] == c for key, c in batched._COMMIT_MEMO.items())


@pytest.mark.parametrize("leaves", [1, 2, 8, 64])
def test_tree_roots_and_levels_equal_jax(leaves):
    """T trees of L leaves with sorted namespaces ending in parity leaves
    (the ignore-max rule), through the port's tree_roots / tree_levels and
    the JAX ones."""
    rng = np.random.default_rng(leaves)
    t = 3
    ns = np.sort(rng.integers(0, 256, (t, leaves, 29), dtype=np.uint8), axis=1)
    ns[:, leaves // 2 + (leaves == 1):] = np.frombuffer(PARITY_NAMESPACE_BYTES, np.uint8)
    data = rng.integers(0, 256, (t, leaves, 512), dtype=np.uint8)
    roots = nmt.tree_roots(torch.from_numpy(ns), torch.from_numpy(data))
    want = np.asarray(jax_nmt.tree_roots(jnp.asarray(ns), jnp.asarray(data)))
    assert roots.numpy().tobytes() == want.tobytes()
    levels = nmt.tree_levels(torch.from_numpy(ns), torch.from_numpy(data))
    jax_levels = jax_nmt.tree_levels(jnp.asarray(ns), jnp.asarray(data))
    assert len(levels) == len(jax_levels) == leaves.bit_length()
    for got, ref in zip(levels, jax_levels):
        for g, r in zip(got, ref):
            assert g.numpy().tobytes() == np.asarray(r).tobytes()
    if leaves == 1:  # the root is the leaf digest, min == max == ns
        assert np.array_equal(roots[:, :29].numpy(), ns[:, 0])
        assert np.array_equal(roots[:, 29:58].numpy(), ns[:, 0])


def _tree_pair(n: int):
    rng = np.random.default_rng(n)
    port, ref = NamespacedMerkleTree(), JaxTree()
    ids = np.sort(rng.integers(0, 256, n, dtype=np.uint8))
    for i in range(n):
        leaf = bytes(28) + bytes([ids[i]]) + rng.bytes(100)
        port.push(leaf)
        ref.push(leaf)
    return port, ref


def test_subtree_root_equals_jax():
    port, ref = _tree_pair(16)
    for size in (1, 2, 4, 8, 16):
        for start in range(0, 16, size):
            got = port.subtree_root(start, start + size)
            assert got == ref.subtree_root(start, start + size)
    assert port.subtree_root(0, 16) == port.root()


@pytest.mark.parametrize("start,end,what", [(1, 3, "unaligned"), (2, 2, "unaligned"),
                                            (0, 3, "unaligned"), (0, 32, "exceeds"),
                                            (16, 32, "exceeds")])
def test_subtree_root_rejects_like_jax(start, end, what):
    port, ref = _tree_pair(16)
    with pytest.raises(ValueError, match=what):
        ref.subtree_root(start, end)
    with pytest.raises(ValueError, match=what):
        port.subtree_root(start, end)


@pytest.mark.parametrize("count,want", [(3, [1, 1, 1]), (67, [2] * 33 + [1]),
                                        (170, [4] * 42 + [2])])
def test_chunk_sizes_are_powers_of_two(count, want):
    """A blob's chunks are powers of two, the only leaf counts tree_roots
    takes: 3 shares have width 1 at threshold 64 (three single-share
    chunks), 67 shares width 2, 170 shares width 4."""
    assert merkle_mountain_range_sizes(count, subtree_width(count, 64)) == want
