"""Minimal protobuf wire-format helpers (proto3, deterministic encoding).

Just enough of the wire format for the consensus-critical envelopes the
framework must round-trip byte-exactly — BlobTx / Blob / IndexWrapper
(reference proto/celestia/core/v1/blob/blob.proto; spec
specs/src/specs/data_structures.md "IndexWrapper") — without a protobuf
runtime dependency.  Encoding is canonical: fields in ascending field-number
order, packed repeated scalars, no defaults emitted.
"""

from __future__ import annotations

WIRE_VARINT = 0
WIRE_I64 = 1
WIRE_LEN = 2
WIRE_I32 = 5


def encode_uvarint(n: int) -> bytes:
    if n < 0:
        raise ValueError("uvarint must be non-negative")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_uvarint(buf: bytes, pos: int) -> tuple[int, int]:
    """Returns (value, new_pos)."""
    shift = 0
    value = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated uvarint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7
        if shift > 63:
            raise ValueError("uvarint overflow")


def _tag(field_number: int, wire_type: int) -> bytes:
    return encode_uvarint((field_number << 3) | wire_type)


def encode_bytes_field(field_number: int, data: bytes) -> bytes:
    """Length-delimited field (bytes / string / embedded message)."""
    return _tag(field_number, WIRE_LEN) + encode_uvarint(len(data)) + data


def encode_varint_field(field_number: int, value: int) -> bytes:
    """Scalar varint field; proto3 omits zero-valued scalars."""
    if value == 0:
        return b""
    return _tag(field_number, WIRE_VARINT) + encode_uvarint(value)


def encode_packed_uint32_field(field_number: int, values: list[int]) -> bytes:
    """Packed repeated uint32 (proto3 default packing)."""
    if not values:
        return b""
    payload = b"".join(encode_uvarint(v) for v in values)
    return encode_bytes_field(field_number, payload)


def int64_from_uvarint(v: int) -> int:
    """Interpret an unsigned varint as a proto int64 (two's complement):
    values >= 2^63 are negative.  Decoders for int64 fields must apply
    this, or a negative wire value (10-byte varint) silently becomes a
    huge positive and dodges < 0 / <= 0 validation.  NOT for proto
    `sint64` fields — those are zigzag-encoded."""
    return v - (1 << 64) if v >= (1 << 63) else v


def decode_fields(buf: bytes) -> list[tuple[int, int, object]]:
    """Parse a message into [(field_number, wire_type, value)].

    LEN fields yield bytes; varints yield int.  Raises ValueError on any
    malformed input (the caller treats that as "not this message type").
    """
    out: list[tuple[int, int, object]] = []
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = read_uvarint(buf, pos)
        field_number, wire_type = key >> 3, key & 7
        if field_number == 0:
            raise ValueError("field number 0 is invalid")
        if wire_type == WIRE_VARINT:
            value, pos = read_uvarint(buf, pos)
        elif wire_type == WIRE_LEN:
            ln, pos = read_uvarint(buf, pos)
            if pos + ln > n:
                raise ValueError("truncated length-delimited field")
            value = buf[pos : pos + ln]
            pos += ln
        elif wire_type == WIRE_I64:
            if pos + 8 > n:
                raise ValueError("truncated i64 field")
            value = buf[pos : pos + 8]
            pos += 8
        elif wire_type == WIRE_I32:
            if pos + 4 > n:
                raise ValueError("truncated i32 field")
            value = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        out.append((field_number, wire_type, value))
    return out


def decode_packed_uint32(payload: bytes) -> list[int]:
    values = []
    pos = 0
    while pos < len(payload):
        v, pos = read_uvarint(payload, pos)
        values.append(v)
    return values
