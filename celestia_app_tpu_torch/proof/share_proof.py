"""Share inclusion proofs to the data root.

Parity with reference pkg/proof/proof.go:
  - RowProof: binary Merkle audit paths of row (or column) roots into the
    DAH data root;
  - ShareProof (NewShareInclusionProofFromEDS :79-140): raw shares, one NMT
    range proof per touched row, and the row proof.

The per-line trees come from `eds.row_tree` / `eds.col_tree`: indexing into
the device forest when the serve cache retains the square (serve/cache.py),
else host trees built once per line and handle.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from celestia_app_tpu_torch import merkle
from celestia_app_tpu_torch.constants import NAMESPACE_SIZE
from celestia_app_tpu_torch.da.eds import ExtendedDataSquare
from celestia_app_tpu_torch.nmt.proof import (
    NmtRangeProof,
    prove_range_from_levels,
    verify_range,
)


@dataclass(frozen=True)
class RowProof:
    """Proves row roots [start_row, end_row) belong to a data root."""

    row_roots: tuple[bytes, ...]  # 90-byte namespaced roots
    proofs: tuple[tuple[bytes, ...], ...]  # merkle audit paths
    start_row: int
    end_row: int
    total: int  # leaves of the data-root tree (4k)

    def verify(self, data_root: bytes) -> bool:
        if self.end_row - self.start_row != len(self.row_roots):
            return False
        if len(self.proofs) != len(self.row_roots):
            return False
        for i, (root, path) in enumerate(zip(self.row_roots, self.proofs)):
            if not merkle.verify_proof(data_root, root, self.start_row + i, self.total,
                                       list(path)):
                return False
        return True


@dataclass(frozen=True)
class ShareProof:
    """Proves a contiguous run of shares is committed by a data root."""

    data: tuple[bytes, ...]  # the raw 512-byte shares
    share_proofs: tuple[NmtRangeProof, ...]  # one per touched row
    namespace: bytes  # 29-byte leaf namespace of the proven shares
    row_proof: RowProof

    def verify(self, data_root: bytes) -> bool:
        if not self.row_proof.verify(data_root):
            return False
        cursor = 0
        for row_root, nmt_proof in zip(self.row_proof.row_roots, self.share_proofs):
            count = nmt_proof.end - nmt_proof.start
            leaves = [self.namespace + share for share in self.data[cursor:cursor + count]]
            if not verify_range(row_root, nmt_proof, leaves):
                return False
            cursor += count
        return cursor == len(self.data)


def _range_proof(tree, lo: int, hi: int) -> NmtRangeProof:
    """Range proof off a memoized tree's levels: every tree of the square
    has a power-of-two leaf count, so the proof is indexing, byte-identical
    to the recursive prove_range walk."""
    return prove_range_from_levels(tree.levels(), lo, hi)


def _row_proof(eds: ExtendedDataSquare, start_row: int, end_row: int) -> RowProof:
    """RowProof for leaves [start_row, end_row) of the 4k data-root tree (row
    roots first, then column roots: a column-tree proof passes indices >=
    2k).  With a forest attached the audit paths index its memoized
    root-tree levels; the bytes are the same either way."""
    forest = eds._forest
    if forest is not None:
        all_roots = forest.row_roots + forest.col_roots
        paths = (tuple(merkle.path_from_levels(forest.root_levels, r))
                 for r in range(start_row, end_row))
    else:
        all_roots = eds.row_roots() + eds.col_roots()
        paths = (tuple(merkle.proof(all_roots, r)) for r in range(start_row, end_row))
    return RowProof(
        row_roots=tuple(all_roots[r] for r in range(start_row, end_row)),
        proofs=tuple(paths),
        start_row=start_row,
        end_row=end_row,
        total=len(all_roots),
    )


def new_share_inclusion_proof(eds: ExtendedDataSquare, start: int, end: int) -> ShareProof:
    """Proof for ODS shares [start, end) (row-major coordinates), all of one
    namespace (reference pkg/proof/proof.go:79 enforces the same)."""
    k = eds.k
    if not 0 <= start < end <= k * k:
        raise ValueError(f"invalid ODS share range [{start},{end})")
    start_row, end_row = start // k, (end - 1) // k + 1
    spans = [(r,
              start % k if r == start_row else 0,
              (end - 1) % k + 1 if r == end_row - 1 else k)
             for r in range(start_row, end_row)]
    coords = [(r, c) for r, lo, hi in spans for c in range(lo, hi)]
    forest = eds._forest
    if forest is not None and forest.eds is eds:
        mat = forest.gather_shares(coords)
    else:
        mat = eds.squared()[tuple(np.transpose(coords))]
    namespace = mat[0, :NAMESPACE_SIZE].tobytes()

    shares: list[bytes] = []
    nmt_proofs: list[NmtRangeProof] = []
    pos = 0
    for r, lo, hi in spans:
        for c in range(lo, hi):
            raw = mat[pos].tobytes()
            pos += 1
            if raw[:NAMESPACE_SIZE] != namespace:
                raise ValueError(f"share ({r},{c}) namespace differs from range start")
            shares.append(raw)
        nmt_proofs.append(_range_proof(eds.row_tree(r), lo, hi))
    return ShareProof(
        data=tuple(shares),
        share_proofs=tuple(nmt_proofs),
        namespace=namespace,
        row_proof=_row_proof(eds, start_row, end_row),
    )


def new_share_sample_proof(eds: ExtendedDataSquare, row: int, col: int,
                           axis: str = "row") -> ShareProof:
    """Proof for one coordinate of the extended square, the DAS sampling
    unit: parity shares prove like data shares, under the quadrant
    namespace rule.  `axis` picks the tree that commits the share: "row"
    proves leaf `col` of row tree `row`; "col" proves leaf `row` of column
    tree `col`, whose root is data-root leaf 2k + col."""
    n = 2 * eds.k
    if not (0 <= row < n and 0 <= col < n):
        raise ValueError(f"EDS coordinate ({row},{col}) outside {n}x{n}")
    if axis not in ("row", "col"):
        raise ValueError(f"axis must be 'row' or 'col', got {axis!r}")
    share = eds._eds[row, col].cpu().numpy().tobytes()
    if axis == "col":
        nmt = _range_proof(eds.col_tree(col), row, row + 1)
        root_index = n + col
    else:
        nmt = _range_proof(eds.row_tree(row), col, col + 1)
        root_index = row
    return ShareProof(
        data=(share,),
        share_proofs=(nmt,),
        namespace=eds.leaf_namespace(row, col),
        row_proof=_row_proof(eds, root_index, root_index + 1),
    )


def ods_namespace_range(eds: ExtendedDataSquare, namespace: bytes) -> tuple[int, int] | None:
    """The contiguous row-major ODS range [start, end) holding `namespace`,
    or None when no share carries it (the square builder lays shares out
    in namespace order, so one namespace is one run)."""
    if len(namespace) != NAMESPACE_SIZE:
        raise ValueError(f"namespace must be {NAMESPACE_SIZE} bytes")
    matches = np.all(eds.ods_namespaces() == np.frombuffer(namespace, dtype=np.uint8), axis=1)
    idx = np.flatnonzero(matches)
    if idx.size == 0:
        return None
    start, end = int(idx[0]), int(idx[-1]) + 1
    if end - start != idx.size:
        raise ValueError(f"namespace {namespace.hex()} is not contiguous in the square")
    return start, end


def new_namespace_proof(eds: ExtendedDataSquare, namespace: bytes) -> ShareProof | None:
    """All shares of `namespace` with their multi-row inclusion proof, or
    None when the namespace is absent from the square."""
    rng = ods_namespace_range(eds, namespace)
    if rng is None:
        return None
    return new_share_inclusion_proof(eds, rng[0], rng[1])
