"""IBC core-lite: channels, packets, commitments, receipts, acks.

The 04-channel state machine as the transfer stack consumes it
(ibc-go v6 modules/core/04-channel/keeper): SendPacket stores a packet
commitment, RecvPacket writes a receipt (the replay guard the reference's
RedundantRelayDecorator consults), WriteAcknowledgement stores the ack,
AcknowledgePacket / TimeoutPacket delete the commitment.  Commitment bytes
follow ibc-go's CommitPacket: sha256(timeout_timestamp BE8 ||
revision_number BE8 || revision_height BE8 || sha256(data)).

Handshakes and light-client proof verification are out of scope (channels
are created OPEN, proofs are the relayer's word — see package docstring).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from celestia_app_tpu_torch.encoding.proto import (
    WIRE_LEN,
    WIRE_VARINT,
    decode_fields,
    encode_bytes_field,
    encode_varint_field,
)
from celestia_app_tpu_torch.state.store import KVStore


class IBCError(ValueError):
    pass


@dataclass(frozen=True)
class Height:
    """ibc-go exported.Height (revision number + height); 0-0 = no timeout."""

    revision_number: int = 0
    revision_height: int = 0

    def is_zero(self) -> bool:
        return self.revision_number == 0 and self.revision_height == 0


@dataclass(frozen=True)
class Channel:
    port: str
    channel_id: str
    counterparty_port: str
    counterparty_channel_id: str
    state: str = "OPEN"
    version: str = "ics20-1"
    # Set when the channel was created by the proof-verified handshake
    # (modules/ibc/handshake.py); empty for direct-OPEN test channels.
    # A connection-backed channel REQUIRES packet proofs on relay.
    connection_id: str = ""
    # ibc-go channeltypes.Order: UNORDERED (transfer) or ORDERED (ICA).
    # ORDERED channels enforce exact receive sequencing and CLOSE on a
    # packet timeout (a gap can never be filled once its packet expired).
    ordering: str = "UNORDERED"

    def marshal(self) -> bytes:
        out = (
            encode_bytes_field(1, self.port.encode())
            + encode_bytes_field(2, self.channel_id.encode())
            + encode_bytes_field(3, self.counterparty_port.encode())
            + encode_bytes_field(4, self.counterparty_channel_id.encode())
            + encode_bytes_field(5, self.state.encode())
            + encode_bytes_field(6, self.version.encode())
        )
        if self.connection_id:
            out += encode_bytes_field(7, self.connection_id.encode())
        if self.ordering != "UNORDERED":
            out += encode_bytes_field(8, self.ordering.encode())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Channel":
        f = {num: val for num, wt, val in decode_fields(raw) if wt == WIRE_LEN}
        return cls(
            f[1].decode(), f[2].decode(), f[3].decode(), f[4].decode(),
            f[5].decode(), f[6].decode(), f.get(7, b"").decode(),
            f.get(8, b"UNORDERED").decode(),
        )


@dataclass(frozen=True)
class Packet:
    """channeltypes.Packet (ibc-go proto field numbers)."""

    sequence: int
    source_port: str
    source_channel: str
    destination_port: str
    destination_channel: str
    data: bytes
    timeout_height: Height = Height()
    timeout_timestamp_ns: int = 0

    def marshal(self) -> bytes:
        return (
            encode_varint_field(1, self.sequence)
            + encode_bytes_field(2, self.source_port.encode())
            + encode_bytes_field(3, self.source_channel.encode())
            + encode_bytes_field(4, self.destination_port.encode())
            + encode_bytes_field(5, self.destination_channel.encode())
            + encode_bytes_field(6, self.data)
            + encode_bytes_field(
                7,
                encode_varint_field(1, self.timeout_height.revision_number)
                + encode_varint_field(2, self.timeout_height.revision_height),
            )
            + encode_varint_field(8, self.timeout_timestamp_ns)
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Packet":
        ints = {num: val for num, wt, val in decode_fields(raw) if wt == WIRE_VARINT}
        strs = {num: val for num, wt, val in decode_fields(raw) if wt == WIRE_LEN}
        th = Height()
        if 7 in strs:
            hf = {n: v for n, wt, v in decode_fields(strs[7]) if wt == WIRE_VARINT}
            th = Height(hf.get(1, 0), hf.get(2, 0))
        return cls(
            ints.get(1, 0), strs[2].decode(), strs[3].decode(),
            strs[4].decode(), strs[5].decode(), strs.get(6, b""),
            th, ints.get(8, 0),
        )

    def commitment(self) -> bytes:
        """ibc-go channeltypes.CommitPacket."""
        buf = self.timeout_timestamp_ns.to_bytes(8, "big")
        buf += self.timeout_height.revision_number.to_bytes(8, "big")
        buf += self.timeout_height.revision_height.to_bytes(8, "big")
        buf += hashlib.sha256(self.data).digest()
        return hashlib.sha256(buf).digest()


def next_counter(store: KVStore, key: bytes) -> int:
    """Monotonic 8-byte-BE counter starting at 0 (client / connection /
    channel id allocation — one definition of the byte width and start)."""
    n = int.from_bytes(store.get(key) or b"\x00", "big")
    store.set(key, (n + 1).to_bytes(8, "big"))
    return n


def _chan_key(kind: bytes, port: str, channel_id: str, seq: int | None = None) -> bytes:
    key = b"ibc/" + kind + b"/" + port.encode() + b"/" + channel_id.encode()
    if seq is not None:
        key += b"/" + seq.to_bytes(8, "big")
    return key


class ChannelKeeper:
    """04-channel keeper over the app's KV store."""

    def __init__(self, store: KVStore):
        self.store = store

    # --- channel registry ----------------------------------------------------
    def create_channel(self, channel: Channel) -> None:
        """Direct-OPEN channel creation (the ibctesting Setup shortcut)."""
        key = _chan_key(b"chan", channel.port, channel.channel_id)
        if self.store.get(key) is not None:
            raise IBCError(f"channel {channel.channel_id} already exists")
        self.store.set(key, channel.marshal())
        self.store.set(
            _chan_key(b"nextseq", channel.port, channel.channel_id),
            (1).to_bytes(8, "big"),
        )

    def channel(self, port: str, channel_id: str) -> Channel:
        raw = self.store.get(_chan_key(b"chan", port, channel_id))
        if raw is None:
            raise IBCError(f"unknown channel {port}/{channel_id}")
        return Channel.unmarshal(raw)

    def channels(self) -> list[Channel]:
        return [Channel.unmarshal(v) for _, v in self.store.iterate(b"ibc/chan/")]

    # --- send ---------------------------------------------------------------
    def send_packet(
        self,
        source_port: str,
        source_channel: str,
        data: bytes,
        timeout_height: Height = Height(),
        timeout_timestamp_ns: int = 0,
    ) -> Packet:
        chan = self.channel(source_port, source_channel)
        if chan.state != "OPEN":
            raise IBCError(f"channel {source_channel} not open")
        seq_key = _chan_key(b"nextseq", source_port, source_channel)
        seq = int.from_bytes(self.store.get(seq_key) or b"\x01", "big")
        self.store.set(seq_key, (seq + 1).to_bytes(8, "big"))
        packet = Packet(
            seq, source_port, source_channel,
            chan.counterparty_port, chan.counterparty_channel_id,
            data, timeout_height, timeout_timestamp_ns,
        )
        self.store.set(
            _chan_key(b"commit", source_port, source_channel, seq),
            packet.commitment(),
        )
        return packet

    def packet_commitment(self, port: str, channel_id: str, seq: int) -> bytes | None:
        return self.store.get(_chan_key(b"commit", port, channel_id, seq))

    # --- receive ------------------------------------------------------------
    def has_receipt(self, packet: Packet) -> bool:
        return (
            self.store.get(
                _chan_key(
                    b"receipt", packet.destination_port,
                    packet.destination_channel, packet.sequence,
                )
            )
            is not None
        )

    def recv_packet(self, packet: Packet, height: int, time_ns: int) -> None:
        """Receipt write + replay/timeout checks (RecvPacket core half)."""
        chan = self.channel(packet.destination_port, packet.destination_channel)
        if chan.state != "OPEN":
            # Reachable since handshakes exist: a TRYOPEN channel awaiting
            # open_confirm must not accept packets (ibc-go RecvPacket).
            raise IBCError(
                f"channel {packet.destination_channel} is {chan.state}, not OPEN"
            )
        if (
            chan.counterparty_port != packet.source_port
            or chan.counterparty_channel_id != packet.source_channel
        ):
            raise IBCError("packet routed to the wrong channel")
        if chan.ordering == "ORDERED":
            # ibc-go ORDERED semantics: the receive sequence must be
            # exactly the next expected (ErrPacketSequenceOutOfOrder);
            # the counter, not receipts, is the replay protection.
            recv_key = _chan_key(
                b"nextrecvseq", packet.destination_port,
                packet.destination_channel,
            )
            expected = int.from_bytes(self.store.get(recv_key) or b"\x01", "big")
            if packet.sequence != expected:
                raise IBCError(
                    f"ordered channel {packet.destination_channel}: packet "
                    f"sequence {packet.sequence} != next expected {expected}"
                )
            self.store.set(recv_key, (expected + 1).to_bytes(8, "big"))
        elif self.has_receipt(packet):
            raise IBCError(
                f"packet sequence {packet.sequence} already received"
            )
        if (
            not packet.timeout_height.is_zero()
            and height >= packet.timeout_height.revision_height
        ):
            raise IBCError("packet timeout height elapsed on receiver")
        if packet.timeout_timestamp_ns and time_ns >= packet.timeout_timestamp_ns:
            raise IBCError("packet timeout timestamp elapsed on receiver")
        self.store.set(
            _chan_key(
                b"receipt", packet.destination_port,
                packet.destination_channel, packet.sequence,
            ),
            b"\x01",
        )

    def write_acknowledgement(self, packet: Packet, ack: bytes) -> None:
        self.store.set(
            _chan_key(
                b"ack", packet.destination_port,
                packet.destination_channel, packet.sequence,
            ),
            hashlib.sha256(ack).digest(),
        )

    def acknowledgement(self, port: str, channel_id: str, seq: int) -> bytes | None:
        return self.store.get(_chan_key(b"ack", port, channel_id, seq))

    # --- ack / timeout on the sender ----------------------------------------
    def _check_counterparty_routing(self, packet: Packet) -> None:
        """packet.destination MUST be the source channel's counterparty.
        CommitPacket excludes the destination fields, so without this check
        a relayer could rewrite them and prove non-receipt (or replay an
        ack) under a key nothing was ever written to — ibc-go's
        AcknowledgePacket/TimeoutPacket make the same check for the same
        reason."""
        chan = self.channel(packet.source_port, packet.source_channel)
        if (
            chan.counterparty_port != packet.destination_port
            or chan.counterparty_channel_id != packet.destination_channel
        ):
            raise IBCError(
                f"packet destination {packet.destination_port}/"
                f"{packet.destination_channel} is not channel "
                f"{packet.source_channel}'s counterparty"
            )
        return chan

    def _delete_commitment(self, packet: Packet) -> None:
        key = _chan_key(
            b"commit", packet.source_port, packet.source_channel, packet.sequence
        )
        stored = self.store.get(key)
        if stored is None:
            raise IBCError(
                f"packet sequence {packet.sequence} has no commitment "
                "(already acked or timed out)"
            )
        if stored != packet.commitment():
            raise IBCError("packet commitment mismatch")
        self.store.delete(key)

    def acknowledge_packet(self, packet: Packet) -> None:
        chan = self._check_counterparty_routing(packet)
        if chan.state != "OPEN":
            raise IBCError(
                f"channel {packet.source_channel} is {chan.state}, not OPEN"
            )
        self._delete_commitment(packet)

    def timeout_packet(self, packet: Packet, proof_height: int, proof_time_ns: int) -> None:
        """TimeoutPacket: the packet must actually be past its timeout as
        observed on the counterparty (height/time from the relayer's
        verified proof / attested consensus time).  NO channel-state
        check: in-flight packets on a CLOSED channel must still flush
        through timeouts (ibc-go TimeoutPacket works on any state so
        escrows can refund after a close).  On an ORDERED channel the
        timeout CLOSES the channel (ibc-go timeoutExecuted): the expired
        sequence leaves a hole the receiver's exact-order rule can never
        accept past."""
        chan = self._check_counterparty_routing(packet)
        timed_out = (
            not packet.timeout_height.is_zero()
            and proof_height >= packet.timeout_height.revision_height
        ) or (
            packet.timeout_timestamp_ns
            and proof_time_ns >= packet.timeout_timestamp_ns
        )
        if not timed_out:
            raise IBCError("packet has not timed out yet")
        self._delete_commitment(packet)
        if chan.ordering == "ORDERED" and chan.state != "CLOSED":
            self.store.set(
                _chan_key(b"chan", chan.port, chan.channel_id),
                Channel(
                    chan.port, chan.channel_id, chan.counterparty_port,
                    chan.counterparty_channel_id, "CLOSED", chan.version,
                    chan.connection_id, chan.ordering,
                ).marshal(),
            )
