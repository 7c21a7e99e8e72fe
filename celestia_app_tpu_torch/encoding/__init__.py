from celestia_app_tpu_torch.encoding.proto import (
    decode_fields,
    decode_packed_uint32,
    encode_bytes_field,
    encode_packed_uint32_field,
    encode_uvarint,
    encode_varint_field,
    read_uvarint,
)

__all__ = [
    "decode_fields",
    "decode_packed_uint32",
    "encode_bytes_field",
    "encode_packed_uint32_field",
    "encode_uvarint",
    "encode_varint_field",
    "read_uvarint",
]
