"""IBC core-lite, the reads the ante handler makes: packet commitments and
receipts (RedundantRelayDecorator, app/ante.py).

The port's copy of that part of celestia_app_tpu/modules/ibc/core.py:
`Height`, `Packet` (what a relay message decodes its packet into) and the
`ChannelKeeper` lookups `packet_commitment` and `has_receipt`, with the
store keys of the JAX keeper.  The channel state machine (send, receive,
acknowledge, time out) comes with the message handlers (ROADMAP, queue 1).
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


@dataclass(frozen=True)
class Height:
    """ibc-go exported.Height (revision number + height); 0-0 = no timeout."""

    revision_number: int = 0
    revision_height: int = 0

    def is_zero(self) -> bool:
        return self.revision_number == 0 and self.revision_height == 0


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


def _chan_key(kind: bytes, port: str, channel_id: str, seq: int | None = None) -> bytes:
    key = b"ibc/" + kind + b"/" + port.encode() + b"/" + channel_id.encode()
    if seq is not None:
        key += b"/" + seq.to_bytes(8, "big")
    return key


class ChannelKeeper:
    """04-channel keeper over the app's KV store (reads only)."""

    def __init__(self, store: KVStore):
        self.store = store

    def packet_commitment(self, port: str, channel_id: str, seq: int) -> bytes | None:
        return self.store.get(_chan_key(b"commit", port, channel_id, seq))

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
