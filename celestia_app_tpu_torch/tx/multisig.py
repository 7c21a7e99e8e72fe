"""Threshold multisig pubkeys (the sdk's LegacyAminoPubKey surface).

Reference: the default sdk ante chain admits multisig accounts with up to
TxSigLimit = 7 sub-signatures (NewValidateSigCountDecorator +
SigVerificationDecorator in app/ante/ante.go:15-82); celestia-app changes
neither.  Wire shapes follow cosmos protos:

  /cosmos.crypto.multisig.LegacyAminoPubKey { threshold=1, public_keys=2 }
  ModeInfo.Multi { bitarray=1 (CompactBitArray), mode_infos=2 }
  CompactBitArray { extra_bits_stored=1, elems=2 }   (MSB-first bits)
  MultiSignature  { signatures=1 repeated }          (set-bit order)

Documented deviation: the sdk derives the multisig ADDRESS from the legacy
amino encoding of the key set (sha256(amino(pubkey))[:20]); amino is not
reimplemented here, so the address hashes the proto encoding instead —
deterministic and collision-resistant over (threshold, keys), but not
byte-equal to an sdk-derived multisig address.  Every sub-signature signs
the standard SIGN_MODE_DIRECT SignDoc of the outer tx.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from celestia_app_tpu_torch.crypto import bech32
from celestia_app_tpu_torch.crypto.keys import ACCOUNT_HRP, PublicKey
from celestia_app_tpu_torch.encoding.proto import (
    WIRE_LEN,
    WIRE_VARINT,
    decode_fields,
    encode_bytes_field,
    encode_varint_field,
)
from celestia_app_tpu_torch.tx.messages import Any

URL_MULTISIG_PUBKEY = "/cosmos.crypto.multisig.LegacyAminoPubKey"
URL_SECP256K1_PUBKEY = "/cosmos.crypto.secp256k1.PubKey"


def _marshal_simple_pubkey(pk: PublicKey) -> bytes:
    return Any(URL_SECP256K1_PUBKEY, encode_bytes_field(1, pk.bytes)).marshal()


@dataclass(frozen=True)
class MultisigPubKey:
    """t-of-n threshold key over secp256k1 sub-keys."""

    threshold: int
    public_keys: tuple[PublicKey, ...]

    def __post_init__(self):
        if not 1 <= self.threshold <= len(self.public_keys):
            raise ValueError(
                f"threshold {self.threshold} out of range for "
                f"{len(self.public_keys)} keys"
            )

    # --- wire --------------------------------------------------------------
    def value_bytes(self) -> bytes:
        out = encode_varint_field(1, self.threshold)
        for pk in self.public_keys:
            out += encode_bytes_field(2, _marshal_simple_pubkey(pk))
        return out

    def to_any(self) -> Any:
        return Any(URL_MULTISIG_PUBKEY, self.value_bytes())

    @classmethod
    def from_value(cls, raw: bytes) -> "MultisigPubKey":
        threshold = 0
        keys: list[PublicKey] = []
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_VARINT:
                threshold = val
            elif num == 2 and wt == WIRE_LEN:
                a = Any.unmarshal(val)
                if a.type_url != URL_SECP256K1_PUBKEY:
                    raise ValueError(f"multisig sub-key type {a.type_url}")
                for n2, w2, v2 in decode_fields(a.value):
                    if n2 == 1 and w2 == WIRE_LEN:
                        keys.append(PublicKey(v2))
        return cls(threshold, tuple(keys))

    # --- identity ----------------------------------------------------------
    def address(self) -> str:
        digest = hashlib.sha256(self.value_bytes()).digest()[:20]
        return bech32.encode(ACCOUNT_HRP, digest)

    # --- verification ------------------------------------------------------
    def verify_multi(
        self, doc: bytes, bits: tuple[bool, ...], signatures: tuple[bytes, ...]
    ) -> bool:
        """True iff >= threshold sub-keys signed `doc`; `bits[i]` marks
        whether key i participated, `signatures` in set-bit order."""
        if len(bits) != len(self.public_keys):
            return False
        set_idx = [i for i, b in enumerate(bits) if b]
        if len(set_idx) != len(signatures) or len(set_idx) < self.threshold:
            return False
        return all(
            self.public_keys[i].verify(doc, sig)
            for i, sig in zip(set_idx, signatures)
        )


# --- CompactBitArray ------------------------------------------------------
def marshal_bitarray(bits: tuple[bool, ...]) -> bytes:
    n = len(bits)
    elems = bytearray((n + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            elems[i // 8] |= 0x80 >> (i % 8)  # MSB-first, sdk CompactBitArray
    return encode_varint_field(1, n % 8) + encode_bytes_field(2, bytes(elems))


def unmarshal_bitarray(raw: bytes) -> tuple[bool, ...]:
    extra = 0
    elems = b""
    for num, wt, val in decode_fields(raw):
        if num == 1 and wt == WIRE_VARINT:
            extra = val
        elif num == 2 and wt == WIRE_LEN:
            elems = val
    n = len(elems) * 8 - ((8 - extra) % 8 if extra else 0)
    return tuple(bool(elems[i // 8] & (0x80 >> (i % 8))) for i in range(n))


# --- MultiSignature -------------------------------------------------------
def marshal_multisignature(signatures: tuple[bytes, ...]) -> bytes:
    out = b""
    for s in signatures:
        out += encode_bytes_field(1, s)
    return out


def unmarshal_multisignature(raw: bytes) -> tuple[bytes, ...]:
    return tuple(
        val for num, wt, val in decode_fields(raw) if num == 1 and wt == WIRE_LEN
    )
