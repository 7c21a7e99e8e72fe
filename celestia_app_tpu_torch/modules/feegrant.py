"""x/feegrant: fee allowances — one account pays another's tx fees.

The reference wires cosmos-sdk x/feegrant (app/modules.go:117-119) and its
own load generator depends on it: txsim's master account grants a
BasicAllowance to every sub-account so one funded account pays all fees
(test/txsim/account.go:238-239,318-330).  A tx opts in by setting
Fee.granter; the DeductFee ante decorator then charges the granter through
`use_grant` instead of the signer.

Allowance types (sdk x/feegrant/feegrant.pb.go semantics):

  * BasicAllowance: optional total spend limit + optional expiration;
  * PeriodicAllowance: a rolling per-period limit that refills every
    `period`, capped by an optional overall basic limit;
  * AllowedMsgAllowance: any allowance, restricted to a set of msg type
    URLs.

`use_grant` mutates state exactly like the sdk: a spent-out or expired
allowance is pruned; a periodic refill advances `period_reset` in whole
periods so a long-idle grant does not accumulate unboundedly.
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

_GRANT_PREFIX = b"feegrant/"


class FeegrantError(ValueError):
    pass


@dataclass(frozen=True)
class Allowance:
    """One stored allowance (the three sdk shapes flattened: a basic
    allowance is the periodic fields zeroed; msg restrictions empty =
    any msg)."""

    spend_limit: int = 0  # 0 = unlimited
    expiration_ns: int = 0  # 0 = never
    period_ns: int = 0  # 0 = not periodic
    period_spend_limit: int = 0
    period_can_spend: int = 0
    period_reset_ns: int = 0
    allowed_msgs: tuple[str, ...] = ()  # empty = all

    def marshal(self) -> bytes:
        out = (
            encode_varint_field(1, self.spend_limit)
            + encode_varint_field(2, self.expiration_ns)
            + encode_varint_field(3, self.period_ns)
            + encode_varint_field(4, self.period_spend_limit)
            + encode_varint_field(5, self.period_can_spend)
            + encode_varint_field(6, self.period_reset_ns)
        )
        for url in self.allowed_msgs:
            out += encode_bytes_field(7, url.encode())
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Allowance":
        ints = {n: v for n, wt, v in decode_fields(raw) if wt == WIRE_VARINT}
        msgs = [
            v.decode() for n, wt, v in decode_fields(raw)
            if n == 7 and wt == WIRE_LEN
        ]
        return cls(
            ints.get(1, 0), ints.get(2, 0), ints.get(3, 0),
            ints.get(4, 0), ints.get(5, 0), ints.get(6, 0), tuple(msgs),
        )


class FeegrantKeeper:
    def __init__(self, store: KVStore):
        self.store = store

    def _key(self, granter: str, grantee: str) -> bytes:
        return _GRANT_PREFIX + granter.encode() + b"/" + grantee.encode()

    def grant(self, granter: str, grantee: str, allowance: Allowance) -> None:
        """MsgGrantAllowance; granting on top of an existing grant is an
        error in the sdk (revoke first)."""
        if granter == grantee:
            raise FeegrantError("cannot self-grant a fee allowance")
        if self.store.get(self._key(granter, grantee)) is not None:
            raise FeegrantError(
                f"fee allowance {granter} -> {grantee} already exists"
            )
        self.store.set(self._key(granter, grantee), allowance.marshal())

    def revoke(self, granter: str, grantee: str) -> None:
        if self.store.get(self._key(granter, grantee)) is None:
            raise FeegrantError(f"no fee allowance {granter} -> {grantee}")
        self.store.delete(self._key(granter, grantee))

    def get(self, granter: str, grantee: str) -> Allowance | None:
        raw = self.store.get(self._key(granter, grantee))
        # `is not None`, not truthiness: an unlimited/no-expiry allowance
        # marshals to zero bytes and is still a grant.
        return Allowance.unmarshal(raw) if raw is not None else None

    def use_grant(
        self,
        granter: str,
        grantee: str,
        fee: int,
        msg_urls: list[str],
        time_ns: int,
    ) -> None:
        """Charge `fee` against the allowance (the DeductFeeDecorator's
        feegrant path).  Raises FeegrantError if the grant is missing,
        expired, spent out, or doesn't cover one of the msg types."""
        a = self.get(granter, grantee)
        if a is None:
            raise FeegrantError(f"no fee allowance {granter} -> {grantee}")
        if a.expiration_ns and time_ns >= a.expiration_ns:
            self.store.delete(self._key(granter, grantee))
            raise FeegrantError("fee allowance expired")
        if a.allowed_msgs:
            for url in msg_urls:
                if url not in a.allowed_msgs:
                    raise FeegrantError(
                        f"fee allowance does not cover {url}"
                    )
        if a.period_ns:
            # Refill in whole periods (sdk tryResetPeriod).
            if time_ns >= a.period_reset_ns:
                periods = (time_ns - a.period_reset_ns) // a.period_ns + 1
                can = min(
                    a.period_spend_limit,
                    a.spend_limit if a.spend_limit else a.period_spend_limit,
                )
                a = replace(
                    a,
                    period_can_spend=can,
                    period_reset_ns=a.period_reset_ns + periods * a.period_ns,
                )
            if fee > a.period_can_spend:
                raise FeegrantError(
                    f"fee {fee} exceeds period allowance {a.period_can_spend}"
                )
            a = replace(a, period_can_spend=a.period_can_spend - fee)
        if a.spend_limit:
            if fee > a.spend_limit:
                raise FeegrantError(
                    f"fee {fee} exceeds allowance {a.spend_limit}"
                )
            a = replace(a, spend_limit=a.spend_limit - fee)
            if a.spend_limit == 0:
                # Spent out: prune (sdk deletes zero allowances).
                self.store.delete(self._key(granter, grantee))
                return
        self.store.set(self._key(granter, grantee), a.marshal())
