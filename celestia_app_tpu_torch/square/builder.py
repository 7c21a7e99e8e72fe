"""Deterministic square construction: Build (proposer) / Construct (validator).

Behavioral parity with the go-square Builder as driven by the reference app
(square.Build at app/prepare_proposal.go:50, square.Construct at
app/process_proposal.go:122 and app/extend_block.go:16):

  * the square holds, in order: normal txs (compact shares, TRANSACTION
    namespace), PFB txs wrapped as IndexWrappers (compact shares,
    PAY_FOR_BLOB namespace), primary-reserved padding, blobs sorted by
    namespace (stable in PFB order within a namespace) at subtree-aligned
    start indexes, namespace padding between blobs, tail padding to k*k;
  * blob start alignment follows the non-interactive default rules
    (layout.next_share_index), independent of the square size;
  * the square size is the smallest power of two that fits.

The one place this construction is self-referential: blob start indexes are
written into the PFB IndexWrappers, whose byte length changes the compact
share count, which moves the blob starts.  We resolve the fixpoint by
seeding every index at its upper bound and iterating; sizes only shrink, so
the iteration converges and both Build and Construct land on the identical
layout.

The same layout, byte for byte, as celestia_app_tpu/square/builder.py, of
which this is a copy without the trace spans and the square journal.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from celestia_app_tpu_torch.constants import SUBTREE_ROOT_THRESHOLD
from celestia_app_tpu_torch.shares.compact import (
    compact_shares_needed,
    split_txs,
    tx_sequence_len,
    write_uvarint,
)
from celestia_app_tpu_torch.shares.namespace import (
    PAY_FOR_BLOB_NAMESPACE,
    TRANSACTION_NAMESPACE,
)
from celestia_app_tpu_torch.shares.share import (
    Share,
    reserved_padding_shares,
    tail_padding_shares,
)
from celestia_app_tpu_torch.shares.sparse import SparseShareSplitter
from celestia_app_tpu_torch.square.layout import next_share_index, round_up_power_of_two
from celestia_app_tpu_torch.tx.envelopes import (
    BlobTx,
    IndexWrapper,
    unmarshal_blob_tx,
)


@dataclass(frozen=True)
class BlobPlacement:
    """Where one blob landed in the square."""

    pfb_index: int  # index into the builder's blob-tx list
    blob_index: int  # index within that blob tx
    start: int  # first share index (row-major)
    share_count: int


@dataclass(frozen=True)
class _Layout:
    size: int  # square size k
    tx_share_count: int
    pfb_share_count: int
    txs: tuple[bytes, ...]  # normal txs, block order
    wrapped_pfbs: tuple[bytes, ...]
    placements: tuple[BlobPlacement, ...]
    end: int  # share index one past the last non-tail-padding share


@dataclass(frozen=True)
class NamespaceUsage:
    """One namespace's footprint in a built square."""

    namespace: bytes  # the 29-byte encoded namespace
    blobs: int
    shares: int
    data_bytes: int  # sum of blob payload lengths


@dataclass(frozen=True)
class SquareAccounting:
    """Exact share-count breakdown of one exported square.

    Every share in the k*k square is attributed to exactly one bucket, so
    tx + pfb + blob + reserved + namespace + tail == size*size always —
    the invariant the tests pin.
    """

    size: int  # square size k
    tx_shares: int  # compact TRANSACTION-namespace shares
    pfb_shares: int  # compact PAY_FOR_BLOB shares (IndexWrappers)
    blob_shares: int  # sparse shares holding blob payloads
    reserved_padding: int  # compact range -> first blob alignment gap
    namespace_padding: int  # alignment gaps between blobs
    tail_padding: int  # end of content -> k*k
    namespaces: tuple[NamespaceUsage, ...]  # sorted by namespace bytes

    @property
    def total_shares(self) -> int:
        return self.size * self.size

    @property
    def used_shares(self) -> int:
        """Shares carrying data (everything that is not padding)."""
        return self.tx_shares + self.pfb_shares + self.blob_shares

    @property
    def padding_shares(self) -> int:
        return self.reserved_padding + self.namespace_padding + self.tail_padding

    @property
    def occupancy(self) -> float:
        """used / k*k — the square-size efficiency signal."""
        return self.used_shares / self.total_shares


class SquareOverflow(ValueError):
    """The content does not fit in the maximum square size."""


def _compact_share_index(byte_offset: int) -> int:
    """Index of the compact share containing sequence byte `byte_offset`."""
    from celestia_app_tpu_torch.constants import (
        CONTINUATION_COMPACT_SHARE_CONTENT_SIZE as CONT,
        FIRST_COMPACT_SHARE_CONTENT_SIZE as FIRST,
    )

    if byte_offset < FIRST:
        return 0
    return 1 + (byte_offset - FIRST) // CONT


class Square:
    """An immutable k x k square of shares plus its layout metadata."""

    def __init__(
        self,
        shares: list[Share],
        layout: _Layout,
        accounting: SquareAccounting | None = None,
    ):
        self.shares = shares
        self.size = layout.size
        self._layout = layout
        self.accounting = accounting

    def __len__(self) -> int:
        return len(self.shares)

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Square)
            and self.size == other.size
            and [s.raw for s in self.shares] == [s.raw for s in other.shares]
        )

    def share_bytes(self) -> list[bytes]:
        return [s.raw for s in self.shares]

    def is_empty(self) -> bool:
        return self._layout.end == 0

    @property
    def tx_share_range(self) -> tuple[int, int]:
        return (0, self._layout.tx_share_count)

    @property
    def pfb_share_range(self) -> tuple[int, int]:
        lo = self._layout.tx_share_count
        return (lo, lo + self._layout.pfb_share_count)

    @property
    def placements(self) -> tuple[BlobPlacement, ...]:
        return self._layout.placements

    def blob_share_range(self, pfb_index: int, blob_index: int) -> tuple[int, int]:
        for p in self._layout.placements:
            if p.pfb_index == pfb_index and p.blob_index == blob_index:
                return (p.start, p.start + p.share_count)
        raise KeyError(f"no blob ({pfb_index}, {blob_index}) in square")

    def wrapped_pfb_txs(self) -> tuple[bytes, ...]:
        """The IndexWrapper bytes committed in the PAY_FOR_BLOB shares."""
        return self._layout.wrapped_pfbs

    def find_tx_share_range(self, tx_index: int) -> tuple[int, int]:
        """Share span [lo, hi) of block tx `tx_index`.

        Block tx order is normal txs then blob txs (reference go-square
        square.FindTxShareRange via pkg/proof/proof.go:28-42); for a blob tx
        the span covers its IndexWrapper bytes in the PFB compact run.
        """
        n_tx = len(self._layout.txs)
        if tx_index < n_tx:
            units, region_start = list(self._layout.txs), 0
            unit = tx_index
        else:
            unit = tx_index - n_tx
            if unit >= len(self._layout.wrapped_pfbs):
                raise IndexError(f"tx index {tx_index} out of range")
            units = list(self._layout.wrapped_pfbs)
            region_start = self._layout.tx_share_count
        offset = sum(len(write_uvarint(len(u))) + len(u) for u in units[:unit])
        length = len(write_uvarint(len(units[unit]))) + len(units[unit])
        return (
            region_start + _compact_share_index(offset),
            region_start + _compact_share_index(offset + length - 1) + 1,
        )


class Builder:
    """Accumulates txs and blob txs; exports the deterministic square."""

    def __init__(
        self,
        max_square_size: int,
        subtree_root_threshold: int = SUBTREE_ROOT_THRESHOLD,
    ):
        if max_square_size < 1 or max_square_size & (max_square_size - 1):
            raise ValueError(f"max square size must be a power of two: {max_square_size}")
        self.max_square_size = max_square_size
        self.subtree_root_threshold = subtree_root_threshold
        self._txs: list[bytes] = []
        self._blob_txs: list[BlobTx] = []
        self._solves = 0  # layout fixpoint runs (fit checks + exports)

    # --- append (greedy fit checks) ---------------------------------------
    def append_tx(self, tx: bytes) -> bool:
        self._txs.append(tx)
        if self._fits():
            return True
        self._txs.pop()
        return False

    def append_blob_tx(self, btx: BlobTx) -> bool:
        self._blob_txs.append(btx)
        if self._fits():
            return True
        self._blob_txs.pop()
        return False

    def _fits(self) -> bool:
        try:
            self._solve()
            return True
        except SquareOverflow:
            return False

    # --- layout -----------------------------------------------------------
    def _solve(self) -> _Layout:
        self._solves += 1
        tx_shares = compact_shares_needed(tx_sequence_len(self._txs))

        # All blobs in placement order: sorted by namespace, stable in
        # (pfb, blob) order (priority within a namespace is submission order;
        # spec data_square_layout.md "Ordering").
        indexed_blobs = [
            (ti, bi, blob)
            for ti, btx in enumerate(self._blob_txs)
            for bi, blob in enumerate(btx.blobs)
        ]
        order = sorted(
            range(len(indexed_blobs)),
            key=lambda i: indexed_blobs[i][2].namespace.to_bytes(),
        )

        # Fixpoint: seed every share index at its upper bound so wrapper
        # sizes start maximal and only shrink.
        bound = self.max_square_size * self.max_square_size
        starts: dict[tuple[int, int], int] = {
            (ti, bi): bound for ti, bi, _ in indexed_blobs
        }
        for _ in range(32):
            wrapped = tuple(
                IndexWrapper(
                    btx.tx,
                    tuple(starts[(ti, bi)] for bi in range(len(btx.blobs))),
                ).marshal()
                for ti, btx in enumerate(self._blob_txs)
            )
            pfb_shares = compact_shares_needed(tx_sequence_len(list(wrapped)))
            cursor = tx_shares + pfb_shares
            new_starts: dict[tuple[int, int], int] = {}
            placements: list[BlobPlacement] = []
            for oi in order:
                ti, bi, blob = indexed_blobs[oi]
                count = blob.share_count()
                start = next_share_index(cursor, count, self.subtree_root_threshold)
                new_starts[(ti, bi)] = start
                placements.append(BlobPlacement(ti, bi, start, count))
                cursor = start + count
            if new_starts == starts:
                break
            starts = new_starts
        else:  # pragma: no cover - the monotone iteration always converges
            raise RuntimeError("square layout fixpoint did not converge")

        end = cursor
        size = max(1, round_up_power_of_two(math.isqrt(max(end - 1, 0)) + 1))
        if size > self.max_square_size:
            raise SquareOverflow(
                f"content needs square size {size} > max {self.max_square_size}"
            )
        return _Layout(
            size=size,
            tx_share_count=tx_shares,
            pfb_share_count=pfb_shares,
            txs=tuple(self._txs),
            wrapped_pfbs=wrapped,
            placements=tuple(placements),
            end=end,
        )

    def export(self) -> Square:
        layout = self._solve()
        shares: list[Share] = []
        shares += split_txs(self._txs, TRANSACTION_NAMESPACE)
        shares += split_txs(list(layout.wrapped_pfbs), PAY_FOR_BLOB_NAMESPACE)
        assert len(shares) == layout.tx_share_count + layout.pfb_share_count

        if layout.placements:
            first_start = layout.placements[0].start
            shares += reserved_padding_shares(first_start - len(shares))
            sparse = SparseShareSplitter()
            cursor = first_start
            for p in layout.placements:
                if p.start > cursor:
                    sparse.write_namespace_padding(p.start - cursor)
                    cursor = p.start
                blob = self._blob_txs[p.pfb_index].blobs[p.blob_index]
                sparse.write(blob)
                cursor += p.share_count
            shares += sparse.export()

        total = layout.size * layout.size
        shares += tail_padding_shares(total - len(shares))
        return Square(shares, layout, self._accounting(layout))

    def _accounting(self, layout: _Layout) -> SquareAccounting:
        """The padding/occupancy breakdown export() used to throw away:
        re-derived from the solved layout alone (no extra fixpoint runs)."""
        compact_end = layout.tx_share_count + layout.pfb_share_count
        if layout.placements:
            reserved = layout.placements[0].start - compact_end
            ns_pad = 0
            cursor = layout.placements[0].start
            for p in layout.placements:
                ns_pad += p.start - cursor
                cursor = p.start + p.share_count
            blob_shares = sum(p.share_count for p in layout.placements)
        else:
            reserved = ns_pad = blob_shares = 0
        per_ns: dict[bytes, list[int]] = {}  # ns bytes -> [blobs, shares, bytes]
        for p in layout.placements:
            blob = self._blob_txs[p.pfb_index].blobs[p.blob_index]
            agg = per_ns.setdefault(blob.namespace.to_bytes(), [0, 0, 0])
            agg[0] += 1
            agg[1] += p.share_count
            agg[2] += len(blob.data)
        return SquareAccounting(
            size=layout.size,
            tx_shares=layout.tx_share_count,
            pfb_shares=layout.pfb_share_count,
            blob_shares=blob_shares,
            reserved_padding=reserved,
            namespace_padding=ns_pad,
            tail_padding=layout.size * layout.size - layout.end,
            namespaces=tuple(
                NamespaceUsage(ns, b, s, by)
                for ns, (b, s, by) in sorted(per_ns.items())
            ),
        )

    # --- introspection ----------------------------------------------------
    def current_size(self) -> int:
        return self._solve().size

    @property
    def txs(self) -> list[bytes]:
        return list(self._txs)

    @property
    def blob_txs(self) -> list[BlobTx]:
        return list(self._blob_txs)


def _classify(raw_txs: list[bytes]) -> list[tuple[bytes, BlobTx | None]]:
    return [(raw, unmarshal_blob_tx(raw)) for raw in raw_txs]


def build(
    raw_txs: list[bytes],
    max_square_size: int,
    subtree_root_threshold: int = SUBTREE_ROOT_THRESHOLD,
) -> tuple[Square, list[bytes]]:
    """Proposer path (reference square.Build, app/prepare_proposal.go:50).

    Greedily packs as many txs as fit — normal txs first, then blob txs —
    dropping the rest.  Returns (square, kept_txs) where kept_txs are the
    original bytes in block order (normal txs, then BlobTxs).
    """
    builder = Builder(max_square_size, subtree_root_threshold)
    kept_normal: list[bytes] = []
    kept_blob: list[bytes] = []
    for raw, btx in _classify(raw_txs):
        if btx is None:
            if builder.append_tx(raw):
                kept_normal.append(raw)
        else:
            if builder.append_blob_tx(btx):
                kept_blob.append(raw)
    sq = builder.export()
    return sq, kept_normal + kept_blob


def construct(
    raw_txs: list[bytes],
    max_square_size: int,
    subtree_root_threshold: int = SUBTREE_ROOT_THRESHOLD,
) -> Square:
    """Validator path (reference square.Construct, app/process_proposal.go:122).

    Every tx must fit; raises SquareOverflow otherwise.
    """
    builder = Builder(max_square_size, subtree_root_threshold)
    for raw, btx in _classify(raw_txs):
        ok = builder.append_tx(raw) if btx is None else builder.append_blob_tx(btx)
        if not ok:
            raise SquareOverflow("proposal txs overflow the maximum square size")
    return builder.export()
