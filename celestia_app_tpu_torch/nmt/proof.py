"""NMT range proofs (inclusion of a contiguous leaf range).

Parity with the nmt library's ProveRange + VerifyInclusion as the reference
proof path uses them (pkg/wrapper/nmt_wrapper.go:127,
pkg/proof/proof.go:151-202): the proof carries the subtree roots beside the
range in left-to-right DFS order; verification recomputes the root from the
claimed leaves and those nodes, carrying namespace ranges with the
ignore-max rule.  The port's copy of celestia_app_tpu/nmt/proof.py, whole:
range proofs, the deduped multiproofs of the attestation payload, and
namespace inclusion and absence proofs.
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


# --- deduped multiproofs (the attestation plane's wire unit) ---------------


@dataclass(frozen=True)
class NmtMultiProof:
    """Inclusion proof for a SET of leaf ranges of one NMT.

    s ranges of one tree share most of their upper path nodes; here each
    shared node is serialized ONCE (`nodes`, first-use order) and every
    range consumes its nodes by index (`node_refs`, the exact DFS order
    `prove_range` emits) — so reconstructing any range's NmtRangeProof
    is pure indexing and byte-identical to proving it alone, while the
    wire stops paying s x for shared interior nodes."""

    ranges: tuple[tuple[int, int], ...]  # sorted, disjoint [start, end)
    nodes: tuple[bytes, ...]  # unique 90-byte digests, first-use order
    node_refs: tuple[tuple[int, ...], ...]  # per range, DFS order
    total: int  # leaf count of the proven tree


def multiproof_from_levels(
    levels: list[list[bytes]], ranges
) -> NmtMultiProof:
    """Deduped proof for sorted disjoint `ranges` from precomputed digest
    levels (leaf level first; power-of-two trees).  Deterministic: node
    table order is first use, walking ranges in their sorted order and
    each range's nodes in DFS order."""
    total = len(levels[0])
    rs = tuple((int(s), int(e)) for s, e in ranges)
    prev_end = 0
    for s, e in rs:
        if not 0 <= s < e <= total:
            raise ValueError(f"invalid range [{s},{e}) of {total} leaves")
        if s < prev_end:
            raise ValueError(
                f"ranges must be sorted and disjoint (range [{s},{e}) "
                f"overlaps or precedes end {prev_end})"
            )
        prev_end = e
    if not rs:
        raise ValueError("multiproof needs at least one range")
    table: dict[tuple[int, int], int] = {}
    nodes: list[bytes] = []
    refs: list[tuple[int, ...]] = []
    for s, e in rs:
        rr: list[int] = []
        for coord in range_proof_node_coords(total, s, e):
            j = table.get(coord)
            if j is None:
                j = table[coord] = len(nodes)
                lvl, idx = coord
                nodes.append(levels[lvl][idx])
            rr.append(j)
        refs.append(tuple(rr))
    return NmtMultiProof(rs, tuple(nodes), tuple(refs), total)


def split_multiproof(mp: NmtMultiProof) -> list[NmtRangeProof]:
    """Per-range NmtRangeProofs reconstructed from the deduped table —
    byte-identical to `prove_range` of each range alone.  Raises
    IndexError on out-of-table refs (attacker-shaped input)."""
    return [
        NmtRangeProof(s, e, tuple(mp.nodes[j] for j in refs), mp.total)
        for (s, e), refs in zip(mp.ranges, mp.node_refs)
    ]


def verify_multiproof(
    root: bytes, mp: NmtMultiProof, leaf_ndata_per_range: list[list[bytes]]
) -> bool:
    """Host verification: every range's leaves (ns-prefixed raw data)
    verify against the 90-byte root.  The batched path reconstructs the
    same per-range proofs and decides them in one device program
    (serve/verify.py)."""
    if len(leaf_ndata_per_range) != len(mp.ranges):
        return False
    if len(mp.node_refs) != len(mp.ranges):
        return False
    try:
        parts = split_multiproof(mp)
    except IndexError:
        return False
    return all(
        verify_range(root, proof, leaves)
        for proof, leaves in zip(parts, leaf_ndata_per_range)
    )


# --- namespace proofs (nmt ProveNamespace / VerifyNamespace parity) --------


def prove_namespace(
    tree: NamespacedMerkleTree, namespace: bytes
) -> tuple[NmtRangeProof, list[bytes]]:
    """Prove all leaves of `namespace` (inclusion), or its absence.

    Returns (proof, leaf_ndata).  Empty leaf list = absence proof: the proof
    covers the single leaf at the namespace's would-be position (verified by
    digest), mirroring the nmt library's absence proofs.
    """
    ns_list = [l[: len(namespace)] for l in tree._leaves]
    n = len(ns_list)
    start = next((i for i, ns in enumerate(ns_list) if ns >= namespace), n)
    end = next((i for i, ns in enumerate(ns_list) if ns > namespace), n)
    if start < end:  # present
        return prove_range(tree, start, end), list(tree._leaves[start:end])
    # Absent: prove the leaf at the insertion position (clamped for
    # beyond-the-last-namespace queries).
    pos = min(start, n - 1)
    return prove_range(tree, pos, pos + 1), []


def verify_namespace(
    root: bytes,
    proof: NmtRangeProof,
    namespace: bytes,
    leaf_ndata: list[bytes],
    absence_leaf_digest: bytes | None = None,
) -> bool:
    """Verify a namespace proof: inclusion completeness or absence.

    Inclusion: every proven leaf carries `namespace`, and the proof's
    sibling nodes show nothing with that namespace exists outside the range
    (left siblings' max < ns, right siblings' min > ns).  Absence: the
    single covered leaf digest has a different namespace and the same
    completeness bounds hold.
    """
    size = len(namespace)
    if leaf_ndata:
        if any(l[:size] != namespace for l in leaf_ndata):
            return False
        if not verify_range(root, proof, leaf_ndata):
            return False
    else:
        if absence_leaf_digest is None:
            return False
        if proof.end - proof.start != 1:
            return False
        leaf_min = NmtHasher.min_namespace(absence_leaf_digest)[:size]
        if leaf_min == namespace:
            return False  # the leaf IS the namespace: not an absence proof
        if not _verify_digests(root, proof, [absence_leaf_digest]):
            return False
        # For an interior absence the covered leaf must sit past the
        # namespace; a leaf below it only proves absence if it is the last
        # leaf of the tree.
        if leaf_min < namespace and proof.end != proof.total:
            return False

    # Completeness: no leaf with `namespace` hidden inside a sibling node.
    it = iter(proof.nodes)

    def walk(lo: int, hi: int) -> None:
        if hi <= proof.start:
            node = next(it)
            if NmtHasher.max_namespace(node)[:size] >= namespace:
                raise ValueError("namespace leaks left of the proven range")
            return
        if lo >= proof.end:
            node = next(it)
            if NmtHasher.min_namespace(node)[:size] <= namespace:
                raise ValueError("namespace leaks right of the proven range")
            return
        if hi - lo == 1:
            return
        sp = split_point(hi - lo)
        walk(lo, lo + sp)
        walk(lo + sp, hi)

    try:
        walk(0, proof.total)
    except (ValueError, StopIteration):
        return False
    return True
