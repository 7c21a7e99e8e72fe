"""NMT range proofs (inclusion of a contiguous leaf range).

Parity with the nmt library's ProveRange + VerifyInclusion as the reference
proof path uses them (pkg/wrapper/nmt_wrapper.go:127,
pkg/proof/proof.go:151-202): the proof carries the subtree roots beside the
range in left-to-right DFS order; verification recomputes the root from the
claimed leaves and those nodes, carrying namespace ranges with the
ignore-max rule.  The range-proof half of celestia_app_tpu/nmt/proof.py;
multiproofs and namespace proofs are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

from celestia_app_tpu_torch.merkle import split_point
from celestia_app_tpu_torch.nmt.hasher import NmtHasher
from celestia_app_tpu_torch.nmt.tree import NamespacedMerkleTree


@dataclass(frozen=True)
class NmtRangeProof:
    """Inclusion proof for leaves [start, end) of an NMT."""

    start: int
    end: int
    nodes: tuple[bytes, ...]  # 90-byte namespaced digests, DFS order
    total: int  # leaf count of the proven tree


def _subtree_digest(digests: list[bytes], lo: int, hi: int) -> bytes:
    if hi - lo == 1:
        return digests[lo]
    sp = split_point(hi - lo)
    return NmtHasher.hash_node(
        _subtree_digest(digests, lo, lo + sp), _subtree_digest(digests, lo + sp, hi)
    )


def prove_range(tree: NamespacedMerkleTree, start: int, end: int) -> NmtRangeProof:
    digests = tree.leaf_digests()
    n = len(digests)
    if not 0 <= start < end <= n:
        raise ValueError(f"invalid range [{start},{end}) of {n} leaves")
    nodes: list[bytes] = []

    def walk(lo: int, hi: int) -> None:
        if hi <= start or lo >= end:
            nodes.append(_subtree_digest(digests, lo, hi))
            return
        if hi - lo == 1:
            return  # in-range leaf: supplied by the verifier
        sp = split_point(hi - lo)
        walk(lo, lo + sp)
        walk(lo + sp, hi)

    walk(0, n)
    return NmtRangeProof(start, end, tuple(nodes), n)


def range_proof_node_coords(total: int, start: int, end: int) -> list[tuple[int, int]]:
    """The (level, index) coordinates of a range proof's nodes, in the DFS
    order `prove_range` emits them; level 0 = leaves.

    Power-of-two totals only: every out-of-range subtree the DFS visits is
    then a complete aligned block, one entry of a precomputed level (a
    tree's `levels()` or the device forest), so a proof is indexing.  The
    batched sampler, the host lowering and the batched verifier share this
    plan, which is what makes their bytes and verdicts agree."""
    if total & (total - 1) or total <= 0:
        raise ValueError(f"range_proof_node_coords needs a power of two, got {total}")
    if not 0 <= start < end <= total:
        raise ValueError(f"invalid range [{start},{end}) of {total} leaves")
    coords: list[tuple[int, int]] = []

    def walk(lo: int, hi: int) -> None:
        if hi <= start or lo >= end:
            size = hi - lo
            coords.append((size.bit_length() - 1, lo // size))
            return
        if hi - lo == 1:
            return
        sp = (hi - lo) // 2  # power-of-two split == split_point
        walk(lo, lo + sp)
        walk(lo + sp, hi)

    walk(0, total)
    return coords


def prove_range_from_levels(levels: list[list[bytes]], start: int, end: int) -> NmtRangeProof:
    """`prove_range` from precomputed digest levels (leaf level first):
    the same bytes for power-of-two trees, no hashing."""
    total = len(levels[0])
    nodes = tuple(levels[lvl][idx] for lvl, idx in range_proof_node_coords(total, start, end))
    return NmtRangeProof(start, end, nodes, total)


def _verify_digests(root: bytes, proof: NmtRangeProof, leaf_digests: list[bytes]) -> bool:
    if len(leaf_digests) != proof.end - proof.start:
        return False
    if not 0 <= proof.start < proof.end <= proof.total:
        return False
    it = iter(proof.nodes)

    def walk(lo: int, hi: int) -> bytes:
        if hi <= proof.start or lo >= proof.end:
            return next(it)
        if hi - lo == 1:
            return leaf_digests[lo - proof.start]
        sp = split_point(hi - lo)
        left = walk(lo, lo + sp)
        right = walk(lo + sp, hi)
        return NmtHasher.hash_node(left, right)

    try:
        computed = walk(0, proof.total)
    except (StopIteration, ValueError):
        # ValueError: hash_node rejects namespace-order violations.
        return False
    if next(it, None) is not None:
        return False  # unconsumed proof nodes
    return computed == root


def verify_range(root: bytes, proof: NmtRangeProof, leaf_ndata: list[bytes]) -> bool:
    """Verify leaves (ns-prefixed raw data, in order) against a 90-byte root."""
    return _verify_digests(root, proof, [NmtHasher.hash_leaf(nd) for nd in leaf_ndata])
