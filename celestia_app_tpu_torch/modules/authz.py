"""x/authz: grant another account the authority to execute msgs for you.

The reference wires cosmos-sdk x/authz (app/modules.go:153-155).  A
granter issues a Grant (authorization + optional expiration) to a grantee;
the grantee then submits MsgExec wrapping messages whose *inner* signer is
the granter — the app checks each inner msg against the grant before
dispatching it through the normal handlers.

Authorization types (sdk authz semantics):

  * GenericAuthorization: unconditional authority over one msg type URL;
  * SendAuthorization: bank sends up to a rolling spend limit (the limit
    decrements per accepted send; exhausted grants prune themselves).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from celestia_app_tpu_torch.encoding.proto import (
    WIRE_LEN,
    WIRE_VARINT,
    decode_fields,
    encode_bytes_field,
    encode_varint_field,
)
from celestia_app_tpu_torch.state.store import KVStore

_GRANT_PREFIX = b"authz/"

URL_GENERIC_AUTHORIZATION = "/cosmos.authz.v1beta1.GenericAuthorization"
URL_SEND_AUTHORIZATION = "/cosmos.bank.v1beta1.SendAuthorization"
URL_MSG_SEND = "/cosmos.bank.v1beta1.MsgSend"


class AuthzError(ValueError):
    pass


@dataclass(frozen=True)
class Grant:
    """authorization for one msg type URL; spend_limit applies only to
    SendAuthorization (0 = generic/no limit)."""

    msg_type_url: str
    spend_limit: int = 0
    expiration_ns: int = 0  # 0 = never

    def marshal(self) -> bytes:
        return (
            encode_bytes_field(1, self.msg_type_url.encode())
            + encode_varint_field(2, self.spend_limit)
            + encode_varint_field(3, self.expiration_ns)
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Grant":
        url = ""
        ints = {}
        for n, wt, v in decode_fields(raw):
            if n == 1 and wt == WIRE_LEN:
                url = v.decode()
            elif wt == WIRE_VARINT:
                ints[n] = v
        return cls(url, ints.get(2, 0), ints.get(3, 0))


class AuthzKeeper:
    def __init__(self, store: KVStore):
        self.store = store

    def _key(self, granter: str, grantee: str, url: str) -> bytes:
        return (
            _GRANT_PREFIX + granter.encode() + b"/" + grantee.encode()
            + b"/" + url.encode()
        )

    def grant(self, granter: str, grantee: str, g: Grant) -> None:
        """MsgGrant: overwrites an existing grant for the same
        (granter, grantee, msg type) — sdk SaveGrant semantics."""
        if granter == grantee:
            raise AuthzError("cannot self-grant")
        if not g.msg_type_url:
            raise AuthzError("authorization needs a msg type url")
        self.store.set(self._key(granter, grantee, g.msg_type_url), g.marshal())

    def revoke(self, granter: str, grantee: str, url: str) -> None:
        if self.store.get(self._key(granter, grantee, url)) is None:
            raise AuthzError(f"no grant {granter} -> {grantee} for {url}")
        self.store.delete(self._key(granter, grantee, url))

    def get(self, granter: str, grantee: str, url: str) -> Grant | None:
        raw = self.store.get(self._key(granter, grantee, url))
        # `is not None`, not truthiness — defensive symmetry with feegrant
        # (a Grant always carries its url so never marshals empty, but the
        # existence check must not depend on that).
        return Grant.unmarshal(raw) if raw is not None else None

    def accept(self, granter: str, grantee: str, msg, time_ns: int) -> None:
        """Authorize one inner msg of a MsgExec (sdk DispatchActions):
        checks existence/expiry, and for SendAuthorization decrements the
        spend limit (exhausted grants prune)."""
        url = msg.TYPE_URL
        g = self.get(granter, grantee, url)
        if g is None:
            raise AuthzError(
                f"no authorization {granter} -> {grantee} for {url}"
            )
        if g.expiration_ns and time_ns >= g.expiration_ns:
            self.store.delete(self._key(granter, grantee, url))
            raise AuthzError("authorization expired")
        # SendAuthorization (spend_limit) covers MsgSend ONLY, as in the
        # sdk: its Accept() rejects every other msg type, and the wire
        # shape carries no msg-type field.  A MsgMultiSend under authz
        # needs a GenericAuthorization of the MultiSend URL — unlimited,
        # exactly the sdk's semantics (MsgAuthzGrant.validate_basic
        # refuses spend_limit on non-MsgSend grants, so a limited
        # MultiSend grant cannot exist on the wire).
        if g.spend_limit and url == URL_MSG_SEND:
            total = sum(c.amount for c in msg.amount if c.denom == "utia")
            if total > g.spend_limit:
                raise AuthzError(
                    f"send of {total} exceeds authorization limit {g.spend_limit}"
                )
            g = replace(g, spend_limit=g.spend_limit - total)
            if g.spend_limit == 0:
                self.store.delete(self._key(granter, grantee, url))
                return
            self.store.set(self._key(granter, grantee, url), g.marshal())
