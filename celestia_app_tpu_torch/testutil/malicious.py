"""Malicious app variants: fault injection for negative testing.

Parity with the reference's malicious-node harness (test/util/malicious:
app.go BehaviorConfig, out_of_order_builder.go:63-90, tree.go BlindTree):
a proposer that builds invalid squares — shares out of namespace order, or
an outright wrong data root — so tests can prove an honest validator
rejects them.  This is also the wrong-kernel-output fault model for the TPU
pipeline (SURVEY §4.5).

The port's copy of celestia_app_tpu/testutil/malicious.py.  `MaliciousApp`
passes `device` through `**kwargs` to the port's App (None means CUDA and
raises without a card), and extends its tampered square on that device.
"""

from __future__ import annotations

from celestia_app_tpu_torch.app import App, BlockData
from celestia_app_tpu_torch.da import DataAvailabilityHeader, extend_shares
from celestia_app_tpu_torch.shares.share import Share
from celestia_app_tpu_torch.square import builder as square

OUT_OF_ORDER = "out_of_order"
WRONG_ROOT = "wrong_root"


class MaliciousApp(App):
    """An App whose PrepareProposal misbehaves from `start_height` on."""

    def __init__(self, behavior: str = OUT_OF_ORDER, start_height: int = 1, **kwargs):
        super().__init__(**kwargs)
        if behavior not in (OUT_OF_ORDER, WRONG_ROOT):
            raise ValueError(f"unknown behavior {behavior}")
        self.behavior = behavior
        self.start_height = start_height

    def prepare_proposal(self, raw_txs: list[bytes]) -> BlockData:
        if self.height + 1 < self.start_height:
            return super().prepare_proposal(raw_txs)
        filtered = self._filter_txs(raw_txs)
        sq, kept = square.build(filtered, self.max_effective_square_size())
        if self.behavior == WRONG_ROOT:
            return BlockData(tuple(kept), sq.size, b"\xde\xad" * 16)

        # OUT_OF_ORDER: swap two distinct-namespace blob shares, then commit
        # honestly to the tampered square (the reference's OutOfOrderExport
        # swaps blobs across namespaces and hashes with a BlindTree that
        # skips namespace-order validation).
        shares = [bytearray(s.raw) for s in sq.shares]
        placements = sq.placements
        if len(placements) >= 2 and placements[0].start != placements[1].start:
            a, b = placements[0].start, placements[1].start
            shares[a], shares[b] = shares[b], shares[a]
        raw_shares = [bytes(s) for s in shares]
        try:
            eds = extend_shares(raw_shares, device=self.device)
            dah = DataAvailabilityHeader.from_eds(eds)
            root = dah.hash()
        except ValueError:
            root = b"\xbe\xef" * 16
        return BlockData(tuple(kept), sq.size, root)
