"""The transfer middleware stack, in the reference's order.

app/app.go:329-346 (top to bottom): Token Filter > Packet Forward
Middleware (app version 2 only, via the versioned IBC module) > Transfer.
"""

from __future__ import annotations

import json

from celestia_app_tpu_torch.modules.ibc.core import Height, IBCError, Packet
from celestia_app_tpu_torch.modules.ibc.transfer import (
    TransferKeeper,
    TransferModule,
    error_ack,
    ack_is_error,
)
from celestia_app_tpu_torch.modules.tokenfilter import on_recv_packet as tokenfilter_decision


class TokenFilterMiddleware:
    """x/tokenfilter mounted as middleware (ibc_middleware.go:21-78):
    wraps only OnRecvPacket; everything else passes straight through."""

    def __init__(self, inner):
        self.inner = inner

    def on_recv_packet(self, ctx, packet: Packet) -> bytes:
        decision = tokenfilter_decision(
            packet.source_port, packet.source_channel, packet.data
        )
        if not decision.success:
            return error_ack(decision.error)
        return self.inner.on_recv_packet(ctx, packet)

    def on_acknowledgement_packet(self, ctx, packet: Packet, ack: bytes) -> None:
        self.inner.on_acknowledgement_packet(ctx, packet, ack)

    def on_timeout_packet(self, ctx, packet: Packet) -> None:
        self.inner.on_timeout_packet(ctx, packet)


class PacketForwardMiddleware:
    """packet-forward-middleware, reduced to the one-hop forward the
    reference's PFM tests exercise (test/pfm): a transfer whose memo is
    {"forward": {"receiver": ..., "port": ..., "channel": ...}} is
    delivered to this chain, then immediately re-sent onward; the onward
    leg's failure refunds the intermediate receiver here (simplified
    non-atomic retry model; the reference's escrow-chaining is noted in
    PARITY.md)."""

    def __init__(self, inner, transfer_keeper: TransferKeeper):
        self.inner = inner
        self.keeper = transfer_keeper

    @staticmethod
    def _forward_directive(packet: Packet) -> dict | None:
        try:
            data = json.loads(packet.data)
            memo = data.get("memo", "")
            fwd = json.loads(memo).get("forward") if memo else None
        except (ValueError, TypeError, AttributeError):
            return None
        if not isinstance(fwd, dict):
            return None
        if not all(isinstance(fwd.get(k), str) for k in ("receiver", "channel")):
            return None
        return fwd

    def on_recv_packet(self, ctx, packet: Packet) -> bytes:
        fwd = self._forward_directive(packet)
        if fwd is None:
            return self.inner.on_recv_packet(ctx, packet)
        from celestia_app_tpu_torch.modules.ibc.transfer import local_denom_on_recv

        try:
            # Deliver locally first (mint/unescrow to the hop receiver)...
            data = json.loads(packet.data)
            hop_receiver = data["receiver"]
            amount = int(data["amount"])
            local_denom = local_denom_on_recv(packet, data["denom"])
        except (ValueError, KeyError, TypeError) as e:
            # Malformed packet data becomes an error ack (prompt refund on
            # the origin chain), never a failed tx that strands the packet.
            return error_ack(f"invalid packet data: {e}")
        ack = self.inner.on_recv_packet(ctx, packet)
        if ack_is_error(ack):
            return ack
        # ...then send onward from the hop account.
        try:
            self.keeper.send_transfer(
                source_channel=fwd["channel"],
                sender=hop_receiver,
                receiver=fwd["receiver"],
                denom=local_denom,
                amount=amount,
                source_port=fwd.get("port", packet.destination_port),
                memo=fwd.get("next", ""),
            )
        except (IBCError, ValueError) as e:
            return error_ack(f"forward failed: {e}")
        return ack

    def on_acknowledgement_packet(self, ctx, packet: Packet, ack: bytes) -> None:
        self.inner.on_acknowledgement_packet(ctx, packet, ack)

    def on_timeout_packet(self, ctx, packet: Packet) -> None:
        self.inner.on_timeout_packet(ctx, packet)


def build_transfer_stack(
    app_version: int, transfer_keeper: TransferKeeper, token_filter: bool = True
):
    """Reference stack wiring incl. the versioned-IBC-module gate:
    PFM participates only at app version >= 2 (app/app.go:336-344).
    `token_filter=False` builds the counterparty simapp's stack (the
    reference keeps such a chain in test/pfm/simapp.go for exactly this)."""
    stack = TransferModule(transfer_keeper)
    if app_version >= 2:
        stack = PacketForwardMiddleware(stack, transfer_keeper)
    if token_filter:
        stack = TokenFilterMiddleware(stack)
    return stack
