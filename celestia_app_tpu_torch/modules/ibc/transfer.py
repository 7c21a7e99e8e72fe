"""ICS-20 fungible token transfer (ibc-go modules/apps/transfer).

Semantics mirrored from the ibc-go transfer keeper the reference mounts
(app/app.go:324-334):

  send:  sender chain is source  -> escrow native tokens (module account)
         sender chain is sink    -> burn the voucher
  recv:  receiver chain is source-> unescrow (strip one hop from the trace)
         receiver chain is sink  -> mint voucher "port/channel/denom"
  error ack / timeout            -> refund exactly what send took

Packet data is the ICS-20 JSON FungibleTokenPacketData, byte-compatible
with what a counterparty ibc-go chain would produce (sorted keys are NOT
required by the spec; we emit the ibc-go field order).
"""

from __future__ import annotations

import json
from typing import Protocol

from celestia_app_tpu_torch.modules.ibc.core import ChannelKeeper, Height, IBCError, Packet
from celestia_app_tpu_torch.modules.tokenfilter import (
    FungibleTokenPacketData,
    receiver_chain_is_source,
)
from celestia_app_tpu_torch.state.accounts import BankKeeper

TRANSFER_PORT = "transfer"


def escrow_address(port: str, channel_id: str) -> str:
    """Per-channel escrow module account (ibc-go GetEscrowAddress)."""
    return f"ibc-escrow/{port}/{channel_id}"


def voucher_denom(dest_port: str, dest_channel: str, denom: str) -> str:
    """The received token's denom on the sink chain (one more trace hop)."""
    return f"{dest_port}/{dest_channel}/{denom}"


def sender_chain_is_source(source_port: str, source_channel: str, denom: str) -> bool:
    return not denom.startswith(f"{source_port}/{source_channel}/")


def local_denom_on_recv(packet: Packet, denom: str) -> str:
    """The denom a received token carries on THIS chain: strip one trace
    hop when the token is returning home, else add this channel's hop."""
    if receiver_chain_is_source(packet.source_port, packet.source_channel, denom):
        return denom[len(f"{packet.source_port}/{packet.source_channel}/"):]
    return voucher_denom(packet.destination_port, packet.destination_channel, denom)


def packet_data_bytes(data: FungibleTokenPacketData) -> bytes:
    """ibc-go ModuleCdc JSON encoding of FungibleTokenPacketData."""
    obj = {
        "denom": data.denom,
        "amount": data.amount,
        "sender": data.sender,
        "receiver": data.receiver,
    }
    if data.memo:
        obj["memo"] = data.memo
    return json.dumps(obj, separators=(",", ":")).encode()


SUCCESS_ACK = b'{"result":"AQ=="}'  # ibc-go channeltypes.NewResultAcknowledgement([]byte{1})


def error_ack(msg: str) -> bytes:
    return json.dumps({"error": msg}, separators=(",", ":")).encode()


def ack_is_error(ack: bytes) -> bool:
    try:
        return "error" in json.loads(ack)
    except (ValueError, TypeError):
        return True


class IBCModule(Protocol):
    """porttypes.IBCModule, reduced to the packet callbacks the stack uses."""

    def on_recv_packet(self, ctx, packet: Packet) -> bytes: ...
    def on_acknowledgement_packet(self, ctx, packet: Packet, ack: bytes) -> None: ...
    def on_timeout_packet(self, ctx, packet: Packet) -> None: ...


class TransferKeeper:
    """Send-side + refund half of the transfer app."""

    def __init__(self, channels: ChannelKeeper, bank: BankKeeper):
        self.channels = channels
        self.bank = bank
        # Packets sent during this keeper's lifetime (one msg execution):
        # middleware like PFM sends from inside OnRecvPacket, and the msg
        # handler surfaces these as ibc.send_packet events for relayers.
        self.sent: list[Packet] = []

    def send_transfer(
        self,
        source_channel: str,
        sender: str,
        receiver: str,
        denom: str,
        amount: int,
        timeout_height: Height = Height(),
        timeout_timestamp_ns: int = 0,
        memo: str = "",
        source_port: str = TRANSFER_PORT,
    ) -> Packet:
        if amount <= 0:
            raise IBCError("transfer amount must be positive")
        if sender_chain_is_source(source_port, source_channel, denom):
            # Escrow natives in the per-channel module account.
            self.bank.send(
                sender, escrow_address(source_port, source_channel), amount,
                denom=denom,
            )
        else:
            self.bank.burn(sender, amount, denom=denom)
        data = FungibleTokenPacketData(denom, str(amount), sender, receiver, memo)
        packet = self.channels.send_packet(
            source_port, source_channel, packet_data_bytes(data),
            timeout_height, timeout_timestamp_ns,
        )
        self.sent.append(packet)
        return packet

    def _refund(self, packet: Packet) -> None:
        data = FungibleTokenPacketData.from_json(packet.data)
        amount = int(data.amount)
        if sender_chain_is_source(packet.source_port, packet.source_channel, data.denom):
            self.bank.send(
                escrow_address(packet.source_port, packet.source_channel),
                data.sender, amount, denom=data.denom,
            )
        else:
            self.bank.mint(data.sender, amount, denom=data.denom)


class TransferModule:
    """The IBCModule at the bottom of the stack (receive + ack/timeout)."""

    def __init__(self, keeper: TransferKeeper):
        self.keeper = keeper

    def on_recv_packet(self, ctx, packet: Packet) -> bytes:
        try:
            data = FungibleTokenPacketData.from_json(packet.data)
            amount = int(data.amount)
            if amount <= 0:
                return error_ack("invalid amount")
            bank = self.keeper.bank
            local = local_denom_on_recv(packet, data.denom)
            if receiver_chain_is_source(
                packet.source_port, packet.source_channel, data.denom
            ):
                # Token returning home: release escrow.
                bank.send(
                    escrow_address(packet.destination_port, packet.destination_channel),
                    data.receiver, amount, denom=local,
                )
            else:
                bank.mint(data.receiver, amount, denom=local)
            return SUCCESS_ACK
        except (ValueError, KeyError) as e:
            return error_ack(str(e))

    def on_acknowledgement_packet(self, ctx, packet: Packet, ack: bytes) -> None:
        if ack_is_error(ack):
            self.keeper._refund(packet)

    def on_timeout_packet(self, ctx, packet: Packet) -> None:
        self.keeper._refund(packet)
