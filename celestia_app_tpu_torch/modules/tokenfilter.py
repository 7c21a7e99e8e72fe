"""x/tokenfilter: reject inbound non-native IBC tokens (TIA-only chain).

Behavioral parity with reference x/tokenfilter/ibc_middleware.go:21-78: on a
received transfer packet, accept only if the receiver chain is the token's
source (the denom path starts with this packet's source port/channel, i.e.
the token is TIA returning home); everything else gets an error ack.  The
middleware is stateless and unilateral, stacked first in the transfer stack
(app/app.go:329-346).
"""

from __future__ import annotations

import json
from dataclasses import dataclass


@dataclass(frozen=True)
class FungibleTokenPacketData:
    denom: str
    amount: str
    sender: str
    receiver: str
    memo: str = ""

    @classmethod
    def from_json(cls, raw: bytes) -> "FungibleTokenPacketData":
        d = json.loads(raw)
        return cls(
            denom=d["denom"],
            amount=str(d.get("amount", "")),
            sender=d.get("sender", ""),
            receiver=d.get("receiver", ""),
            memo=d.get("memo", ""),
        )


def receiver_chain_is_source(source_port: str, source_channel: str, denom: str) -> bool:
    """ibc-go transfertypes.ReceiverChainIsSource: the denom path begins with
    the packet's source port/channel iff the token originated here."""
    return denom.startswith(f"{source_port}/{source_channel}/")


@dataclass(frozen=True)
class Ack:
    success: bool
    error: str = ""


def on_recv_packet(source_port: str, source_channel: str, packet_data: bytes) -> Ack:
    """The middleware decision for one received packet."""
    try:
        data = FungibleTokenPacketData.from_json(packet_data)
    except (ValueError, KeyError, TypeError):
        # Not a transfer packet: pass through to the wrapped module
        # (ibc_middleware.go:44-51).
        return Ack(success=True)
    if receiver_chain_is_source(source_port, source_channel, data.denom):
        return Ack(success=True)
    return Ack(
        success=False,
        error=f"only native denom transfers accepted, got {data.denom}",
    )
