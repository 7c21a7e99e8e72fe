"""IBC-lite: the channel/packet machinery the transfer stack mounts on.

Scope (PARITY.md): packet lifecycle parity — send/recv/ack/timeout with
commitments, receipts (relay dedup), and acks in state; ICS-20 transfer
with escrow/voucher denom tracing; the reference's middleware stack order
(tokenfilter > packet-forward [v2] > transfer, app/app.go:329-346).
Light clients and the 4-step handshakes are out of scope: channels are
established directly (the ibctesting `path.Setup` shortcut), and proof
verification is delegated to the consensus layer driving the app.
"""

from celestia_app_tpu_torch.modules.ibc.core import (
    Channel,
    ChannelKeeper,
    Height,
    IBCError,
    Packet,
)
from celestia_app_tpu_torch.modules.ibc.transfer import (
    IBCModule,
    TransferKeeper,
    TransferModule,
    voucher_denom,
)
from celestia_app_tpu_torch.modules.ibc.stack import (
    PacketForwardMiddleware,
    TokenFilterMiddleware,
    build_transfer_stack,
)

__all__ = [
    "Channel",
    "ChannelKeeper",
    "Height",
    "IBCError",
    "IBCModule",
    "Packet",
    "PacketForwardMiddleware",
    "TokenFilterMiddleware",
    "TransferKeeper",
    "TransferModule",
    "build_transfer_stack",
    "voucher_denom",
]
