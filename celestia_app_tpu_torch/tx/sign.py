"""Transaction envelope + SIGN_MODE_DIRECT signing.

Wire parity with cosmos tx.proto as the reference consumes it through
pkg/user (Signer, pkg/user/signer.go:23-36): TxBody / AuthInfo / SignDoc /
TxRaw with the standard field numbers, secp256k1 pubkeys wrapped in Any.
"""

from __future__ import annotations

from dataclasses import dataclass

from celestia_app_tpu_torch.crypto.keys import PrivateKey, PublicKey
from celestia_app_tpu_torch.encoding.proto import (
    WIRE_LEN,
    WIRE_VARINT,
    decode_fields,
    encode_bytes_field,
    encode_varint_field,
)
from celestia_app_tpu_torch.tx.messages import Any, Coin, decode_msg

URL_SECP256K1_PUBKEY = "/cosmos.crypto.secp256k1.PubKey"
SIGN_MODE_DIRECT = 1


@dataclass(frozen=True)
class Fee:
    """cosmos.tx.v1beta1.Fee {amount=1, gas_limit=2, payer=3, granter=4}.
    `granter` routes the fee through an x/feegrant allowance (the
    reference's txsim master account pays sub-account fees this way,
    test/txsim/account.go:238-239)."""

    amount: tuple[Coin, ...]
    gas_limit: int
    payer: str = ""
    granter: str = ""

    def marshal(self) -> bytes:
        out = b""
        for c in self.amount:
            out += encode_bytes_field(1, c.marshal())
        out += encode_varint_field(2, self.gas_limit)
        if self.payer:
            out += encode_bytes_field(3, self.payer.encode())
        if self.granter:
            out += encode_bytes_field(4, self.granter.encode())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Fee":
        coins: list[Coin] = []
        gas = 0
        payer, granter = "", ""
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                coins.append(Coin.unmarshal(val))
            elif num == 2 and wt == WIRE_VARINT:
                gas = val
            elif num == 3 and wt == WIRE_LEN:
                payer = val.decode()
            elif num == 4 and wt == WIRE_LEN:
                granter = val.decode()
        return cls(tuple(coins), gas, payer, granter)


def _marshal_pubkey(pk) -> bytes:
    from celestia_app_tpu_torch.tx.multisig import MultisigPubKey

    if isinstance(pk, MultisigPubKey):
        return pk.to_any().marshal()
    return Any(URL_SECP256K1_PUBKEY, encode_bytes_field(1, pk.bytes)).marshal()


def _unmarshal_pubkey(raw: bytes):
    from celestia_app_tpu_torch.tx.multisig import URL_MULTISIG_PUBKEY, MultisigPubKey

    a = Any.unmarshal(raw)
    if a.type_url == URL_MULTISIG_PUBKEY:
        return MultisigPubKey.from_value(a.value)
    if a.type_url != URL_SECP256K1_PUBKEY:
        raise ValueError(f"unsupported pubkey type {a.type_url}")
    for num, wt, val in decode_fields(a.value):
        if num == 1 and wt == WIRE_LEN:
            return PublicKey(val)
    raise ValueError("pubkey Any missing key bytes")


def _marshal_mode_info_single(mode: int) -> bytes:
    return encode_bytes_field(1, encode_varint_field(1, mode))


def _marshal_mode_info_multi(bits: tuple[bool, ...]) -> bytes:
    from celestia_app_tpu_torch.tx.multisig import marshal_bitarray

    inner = encode_bytes_field(1, marshal_bitarray(bits))
    for b in bits:
        if b:
            inner += encode_bytes_field(2, _marshal_mode_info_single(SIGN_MODE_DIRECT))
    return encode_bytes_field(2, inner)  # ModeInfo.multi = field 2


@dataclass(frozen=True)
class SignerInfo:
    """One tx signer.  `public_key` is a PublicKey or a MultisigPubKey;
    `mode_bits` (multisig only) marks which sub-keys participated."""

    public_key: object
    sequence: int
    mode_bits: tuple[bool, ...] | None = None

    def marshal(self) -> bytes:
        mode = (
            _marshal_mode_info_multi(self.mode_bits)
            if self.mode_bits is not None
            else _marshal_mode_info_single(SIGN_MODE_DIRECT)
        )
        return (
            encode_bytes_field(1, _marshal_pubkey(self.public_key))
            + encode_bytes_field(2, mode)
            + encode_varint_field(3, self.sequence)
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "SignerInfo":
        from celestia_app_tpu_torch.tx.multisig import unmarshal_bitarray

        pk = None
        seq = 0
        mode_bits = None
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                pk = _unmarshal_pubkey(val)
            elif num == 2 and wt == WIRE_LEN:
                for n2, w2, v2 in decode_fields(val):
                    if n2 == 2 and w2 == WIRE_LEN:  # ModeInfo.multi
                        for n3, w3, v3 in decode_fields(v2):
                            if n3 == 1 and w3 == WIRE_LEN:
                                mode_bits = unmarshal_bitarray(v3)
            elif num == 3 and wt == WIRE_VARINT:
                seq = val
        if pk is None:
            raise ValueError("signer info missing public key")
        return cls(pk, seq, mode_bits)


@dataclass(frozen=True)
class TxBody:
    """cosmos tx.proto TxBody: messages=1, memo=2, timeout_height=3,
    extension_options=1023, non_critical_extension_options=2047."""

    messages: tuple[Any, ...]
    memo: str = ""
    timeout_height: int = 0
    extension_options: tuple[Any, ...] = ()
    non_critical_extension_options: tuple[Any, ...] = ()

    def marshal(self) -> bytes:
        out = b""
        for m in self.messages:
            out += encode_bytes_field(1, m.marshal())
        if self.memo:
            out += encode_bytes_field(2, self.memo.encode())
        if self.timeout_height:
            out += encode_varint_field(3, self.timeout_height)
        for e in self.extension_options:
            out += encode_bytes_field(1023, e.marshal())
        for e in self.non_critical_extension_options:
            out += encode_bytes_field(2047, e.marshal())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "TxBody":
        msgs: list[Any] = []
        memo = ""
        timeout_height = 0
        ext: list[Any] = []
        non_critical: list[Any] = []
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                msgs.append(Any.unmarshal(val))
            elif num == 2 and wt == WIRE_LEN:
                memo = val.decode()
            elif num == 3 and wt == WIRE_VARINT:
                timeout_height = val
            elif num == 1023 and wt == WIRE_LEN:
                ext.append(Any.unmarshal(val))
            elif num == 2047 and wt == WIRE_LEN:
                non_critical.append(Any.unmarshal(val))
        return cls(tuple(msgs), memo, timeout_height, tuple(ext), tuple(non_critical))


@dataclass(frozen=True)
class AuthInfo:
    signer_infos: tuple[SignerInfo, ...]
    fee: Fee

    def marshal(self) -> bytes:
        out = b""
        for s in self.signer_infos:
            out += encode_bytes_field(1, s.marshal())
        out += encode_bytes_field(2, self.fee.marshal())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "AuthInfo":
        infos: list[SignerInfo] = []
        fee = Fee((), 0)
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                infos.append(SignerInfo.unmarshal(val))
            elif num == 2 and wt == WIRE_LEN:
                fee = Fee.unmarshal(val)
        return cls(tuple(infos), fee)


def sign_doc_bytes(
    body_bytes: bytes, auth_info_bytes: bytes, chain_id: str, account_number: int
) -> bytes:
    return (
        encode_bytes_field(1, body_bytes)
        + encode_bytes_field(2, auth_info_bytes)
        + encode_bytes_field(3, chain_id.encode())
        + encode_varint_field(4, account_number)
    )


@dataclass(frozen=True)
class Tx:
    """A decoded transaction (TxRaw contents)."""

    body_bytes: bytes
    auth_info_bytes: bytes
    signatures: tuple[bytes, ...]

    def marshal(self) -> bytes:
        out = encode_bytes_field(1, self.body_bytes) + encode_bytes_field(
            2, self.auth_info_bytes
        )
        for s in self.signatures:
            out += encode_bytes_field(3, s)
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Tx":
        body, auth = b"", b""
        sigs: list[bytes] = []
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                body = val
            elif num == 2 and wt == WIRE_LEN:
                auth = val
            elif num == 3 and wt == WIRE_LEN:
                sigs.append(val)
        if not body or not auth:
            raise ValueError("tx missing body or auth info")
        return cls(body, auth, tuple(sigs))

    @property
    def body(self) -> TxBody:
        return TxBody.unmarshal(self.body_bytes)

    @property
    def auth_info(self) -> AuthInfo:
        return AuthInfo.unmarshal(self.auth_info_bytes)

    def msgs(self) -> list:
        return [decode_msg(m) for m in self.body.messages]

    def verify_signature(self, chain_id: str, account_number: int) -> bool:
        """Verify the (single) signer's SIGN_MODE_DIRECT signature — a
        plain secp256k1 key, or a threshold multisig (every sub-signature
        signs the same SignDoc)."""
        from celestia_app_tpu_torch.tx.multisig import (
            MultisigPubKey,
            unmarshal_multisignature,
        )

        info = self.auth_info
        if len(info.signer_infos) != 1 or len(self.signatures) != 1:
            return False
        signer = info.signer_infos[0]
        doc = sign_doc_bytes(
            self.body_bytes, self.auth_info_bytes, chain_id, account_number
        )
        if isinstance(signer.public_key, MultisigPubKey):
            if signer.mode_bits is None:
                return False
            return signer.public_key.verify_multi(
                doc, signer.mode_bits, unmarshal_multisignature(self.signatures[0])
            )
        return signer.public_key.verify(doc, self.signatures[0])


def build_and_sign(
    msgs: list,
    key: PrivateKey,
    chain_id: str,
    account_number: int,
    sequence: int,
    fee: Fee,
    memo: str = "",
    timeout_height: int = 0,
) -> bytes:
    """Construct and sign a tx; returns the TxRaw bytes."""
    body = TxBody(tuple(m.to_any() for m in msgs), memo, timeout_height)
    auth = AuthInfo((SignerInfo(key.public_key(), sequence),), fee)
    body_bytes = body.marshal()
    auth_bytes = auth.marshal()
    doc = sign_doc_bytes(body_bytes, auth_bytes, chain_id, account_number)
    return Tx(body_bytes, auth_bytes, (key.sign(doc),)).marshal()


def build_and_sign_multisig(
    msgs: list,
    multisig_pk,
    signing_keys: dict[int, PrivateKey],
    chain_id: str,
    account_number: int,
    sequence: int,
    fee: Fee,
    memo: str = "",
    timeout_height: int = 0,
) -> bytes:
    """Construct a t-of-n multisig tx.  `signing_keys` maps sub-key index
    -> PrivateKey for each participant; every participant signs the same
    SIGN_MODE_DIRECT SignDoc and the signatures travel as one
    MultiSignature in set-bit order."""
    from celestia_app_tpu_torch.tx.multisig import marshal_multisignature

    bits = tuple(
        i in signing_keys for i in range(len(multisig_pk.public_keys))
    )
    body = TxBody(tuple(m.to_any() for m in msgs), memo, timeout_height)
    auth = AuthInfo((SignerInfo(multisig_pk, sequence, bits),), fee)
    body_bytes = body.marshal()
    auth_bytes = auth.marshal()
    doc = sign_doc_bytes(body_bytes, auth_bytes, chain_id, account_number)
    sigs = tuple(
        signing_keys[i].sign(doc)
        for i in range(len(multisig_pk.public_keys))
        if i in signing_keys
    )
    return Tx(body_bytes, auth_bytes, (marshal_multisignature(sigs),)).marshal()
