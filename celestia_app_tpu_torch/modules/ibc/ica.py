"""ICS-27 interchain accounts — host side.

The reference wires ica host-only at v2 (app/modules.go:185-187;
default_overrides.go:161-166 enables the host, disables the controller)
with a governance-curated message whitelist (app/ica_host.go:3-17).

A controller chain opens a channel to port "icahost" from its own port
"icacontroller-{owner}"; the host derives and registers a fresh account
bound to (connection, controller port).  EXECUTE_TX packets then carry
msgs whose signer must be exactly that account, executed through the
app's normal handlers and answered with a success/error ack.

Wire shapes (ibc-go ICS-27 protos):
    InterchainAccountPacketData {type=1, data=2, memo=3}
    CosmosTx                    {messages=1 (repeated Any)}
    type EXECUTE_TX = 1
"""

from __future__ import annotations

import hashlib

from celestia_app_tpu_torch.encoding.proto import (
    WIRE_LEN,
    WIRE_VARINT,
    decode_fields,
    encode_bytes_field,
    encode_varint_field,
)
from celestia_app_tpu_torch.modules.ibc.core import IBCError
from celestia_app_tpu_torch.state.store import KVStore

ICA_HOST_PORT = "icahost"
ICA_VERSION = "ics27-1"
CONTROLLER_PORT_PREFIX = "icacontroller-"
EXECUTE_TX = 1

_ACCOUNT_PREFIX = b"ica/account/"
_PARAMS_KEY = b"ica/host_params"

# The celestia whitelist, now matching app/ica_host.go:3-17 row for row
# (gov votes ride the v1 url there, implemented since round 4).
DEFAULT_ALLOW_MESSAGES = (
    "/ibc.applications.transfer.v1.MsgTransfer",
    "/cosmos.bank.v1beta1.MsgSend",
    "/cosmos.staking.v1beta1.MsgDelegate",
    "/cosmos.staking.v1beta1.MsgBeginRedelegate",
    "/cosmos.staking.v1beta1.MsgUndelegate",
    "/cosmos.staking.v1beta1.MsgCancelUnbondingDelegation",
    "/cosmos.distribution.v1beta1.MsgSetWithdrawAddress",
    "/cosmos.distribution.v1beta1.MsgWithdrawDelegatorReward",
    "/cosmos.distribution.v1beta1.MsgFundCommunityPool",
    "/cosmos.gov.v1.MsgVote",
    "/cosmos.feegrant.v1beta1.MsgGrantAllowance",
    "/cosmos.feegrant.v1beta1.MsgRevokeAllowance",
)


def encode_packet_data(msgs, memo: str = "") -> bytes:
    """InterchainAccountPacketData wrapping a CosmosTx of `msgs`
    (controller-side helper; each msg needs .to_any())."""
    cosmos_tx = b""
    for m in msgs:
        cosmos_tx += encode_bytes_field(1, m.to_any().marshal())
    out = encode_varint_field(1, EXECUTE_TX)
    out += encode_bytes_field(2, cosmos_tx)
    if memo:
        out += encode_bytes_field(3, memo.encode())
    return out


def decode_packet_data(raw: bytes) -> tuple[int, list, str]:
    """(type, [decoded msgs], memo) — raises on unknown inner msg types."""
    from celestia_app_tpu_torch.tx.messages import Any, decode_msg

    ptype, data, memo = 0, b"", ""
    for n, wt, v in decode_fields(raw):
        if n == 1 and wt == WIRE_VARINT:
            ptype = v
        elif n == 2 and wt == WIRE_LEN:
            data = v
        elif n == 3 and wt == WIRE_LEN:
            memo = v.decode()
    msgs = []
    for n, wt, v in decode_fields(data):
        if n == 1 and wt == WIRE_LEN:
            msgs.append(decode_msg(Any.unmarshal(v)))
    return ptype, msgs, memo


class ICAHostKeeper:
    def __init__(self, store: KVStore):
        self.store = store

    # --- params --------------------------------------------------------------
    def host_enabled(self) -> bool:
        raw = self.store.get(_PARAMS_KEY)
        return True if raw is None else bool(raw[0])

    def set_host_enabled(self, enabled: bool) -> None:
        allow = self.allow_messages()
        self._save_params(enabled, allow)

    def allow_messages(self) -> tuple[str, ...]:
        raw = self.store.get(_PARAMS_KEY)
        if raw is None:
            return DEFAULT_ALLOW_MESSAGES
        urls = [
            v.decode() for n, wt, v in decode_fields(raw[1:])
            if n == 1 and wt == WIRE_LEN
        ]
        return tuple(urls)

    def _save_params(self, enabled: bool, allow: tuple[str, ...]) -> None:
        out = bytes([int(enabled)])
        for url in allow:
            out += encode_bytes_field(1, url.encode())
        self.store.set(_PARAMS_KEY, out)

    # --- registration --------------------------------------------------------
    @staticmethod
    def derive_address(connection_id: str, controller_port: str) -> str:
        """Deterministic host address for (connection, controller port) —
        the ibc-go scheme hashes the same pair."""
        from celestia_app_tpu_torch.crypto import bech32

        digest = hashlib.sha256(
            b"ics27-host|" + connection_id.encode() + b"|"
            + controller_port.encode()
        ).digest()[:20]
        return bech32.encode("celestia", digest)

    def register_account(
        self, auth, connection_id: str, controller_port: str
    ) -> str:
        """Bind (connection, controller port) to a fresh host account —
        the channel-open half of ICS-27 registration.  Idempotent: an
        existing registration returns its address (channel reopen)."""
        if not controller_port.startswith(CONTROLLER_PORT_PREFIX):
            raise IBCError(
                f"controller port {controller_port!r} must start with "
                f"{CONTROLLER_PORT_PREFIX!r}"
            )
        key = (
            _ACCOUNT_PREFIX + connection_id.encode() + b"/"
            + controller_port.encode()
        )
        existing = self.store.get(key)
        if existing is not None:
            return existing.decode()
        address = self.derive_address(connection_id, controller_port)
        auth.get_or_create(address)
        self.store.set(key, address.encode())
        return address

    def interchain_account(
        self, connection_id: str, controller_port: str
    ) -> str | None:
        raw = self.store.get(
            _ACCOUNT_PREFIX + connection_id.encode() + b"/"
            + controller_port.encode()
        )
        return raw.decode() if raw is not None else None


class ICAHostModule:
    """The IBC app module mounted at port `icahost` (the recv-side
    callback the app's packet router dispatches to).  `execute` is the
    app's msg dispatcher: (ctx, msg, gas_remaining) -> (gas, events)."""

    def __init__(self, keeper: ICAHostKeeper, execute):
        self.keeper = keeper
        self.execute = execute

    def on_recv_packet(self, ctx, packet) -> tuple[bytes, list]:
        """Returns (ack, events).  Any failure is an error ack — never a
        state change (the app runs this on a cache like transfer's recv)."""
        from celestia_app_tpu_torch.modules.ibc.transfer import SUCCESS_ACK, error_ack

        try:
            if not self.keeper.host_enabled():
                raise IBCError("ica host is disabled")
            # The account is bound to the CHANNEL's identity, not packet
            # bytes a relayer could rewrite: the source port names the
            # controller, and recv_packet has already matched it against
            # the destination channel's counterparty.
            from celestia_app_tpu_torch.modules.ibc.core import ChannelKeeper

            chan = ChannelKeeper(ctx.store).channel(
                packet.destination_port, packet.destination_channel
            )
            account = self.keeper.interchain_account(
                chan.connection_id, packet.source_port
            )
            if account is None:
                raise IBCError(
                    f"no interchain account for {packet.source_port}"
                )
            ptype, msgs, _memo = decode_packet_data(packet.data)
            if ptype != EXECUTE_TX:
                raise IBCError(f"unsupported ICA packet type {ptype}")
            if not msgs:
                raise IBCError("ICA packet carries no messages")
            allow = self.keeper.allow_messages()
            events: list = []
            for m in msgs:
                if m.TYPE_URL not in allow:
                    raise IBCError(
                        f"message {m.TYPE_URL} not in the ICA allow list"
                    )
                signer = getattr(m, "signer", None) or getattr(
                    m, "from_address", None
                )
                if signer != account:
                    raise IBCError(
                        f"ICA msg signer {signer} is not the interchain "
                        f"account {account}"
                    )
                _gas, evts = self.execute(ctx, m, 1_000_000)
                events.extend(evts)
            return SUCCESS_ACK, events
        except (IBCError, ValueError) as e:
            return error_ack(str(e)), []
