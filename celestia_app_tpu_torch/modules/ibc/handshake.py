"""03-connection + 04-channel handshakes, proof-verified end to end.

The reference's handshakes live in ibc-go core (02/03/04 keepers).  Here
each step verifies the counterparty's PREVIOUS step through the
connection's light client (modules/ibc/client.py): the counterparty wrote
its connection/channel record into its SMT-committed store, the relayer
ships `cms.proof(key)` for that record, and `verify_membership` checks it
against the app hash a verified Commit pinned.  Both chains run this same
code, so the storage keys proven are symmetric by construction:

    connection record:  ibc/conn/{connection_id}
    channel record:     ibc/chan/{port}/{channel_id}
    packet commitment:  ibc/commit/{port}/{channel}/{seq, 8B BE}
    packet receipt:     ibc/receipt/{port}/{channel}/{seq, 8B BE}
    packet ack:         ibc/ack/{port}/{channel}/{seq, 8B BE}

State machines (ibc-go semantics):
    connection: INIT -> TRYOPEN -> OPEN        (Init/Try/Ack/Confirm)
    channel:    INIT -> TRYOPEN -> OPEN        (Init/Try/Ack/Confirm)
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from celestia_app_tpu_torch.encoding.proto import (
    WIRE_LEN,
    decode_fields,
    encode_bytes_field,
)
from celestia_app_tpu_torch.modules.ibc.client import ClientKeeper
from celestia_app_tpu_torch.modules.ibc.core import Channel, IBCError, _chan_key
from celestia_app_tpu_torch.state.store import KVStore

_CONN_PREFIX = b"ibc/conn/"
_NEXT_CONN_KEY = b"ibc/next_connection_id"
_NEXT_CHAN_KEY = b"ibc/next_channel_id"


def connection_key(connection_id: str) -> bytes:
    return _CONN_PREFIX + connection_id.encode()


def channel_key(port: str, channel_id: str) -> bytes:
    return _chan_key(b"chan", port, channel_id)


@dataclass(frozen=True)
class ConnectionEnd:
    connection_id: str
    client_id: str  # our client of the counterparty chain
    counterparty_connection_id: str = ""
    counterparty_client_id: str = ""
    state: str = "INIT"

    def marshal(self) -> bytes:
        return (
            encode_bytes_field(1, self.connection_id.encode())
            + encode_bytes_field(2, self.client_id.encode())
            + encode_bytes_field(3, self.counterparty_connection_id.encode())
            + encode_bytes_field(4, self.counterparty_client_id.encode())
            + encode_bytes_field(5, self.state.encode())
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "ConnectionEnd":
        f = {n: v for n, wt, v in decode_fields(raw) if wt == WIRE_LEN}
        return cls(
            f[1].decode(), f[2].decode(), f.get(3, b"").decode(),
            f.get(4, b"").decode(), f.get(5, b"OPEN").decode(),
        )


class ConnectionKeeper:
    """03-connection: the four-step handshake, each step proving the
    counterparty's record through the light client."""

    def __init__(self, store: KVStore):
        self.store = store
        self.clients = ClientKeeper(store)

    def _next_id(self) -> str:
        from celestia_app_tpu_torch.modules.ibc.core import next_counter

        return f"connection-{next_counter(self.store, _NEXT_CONN_KEY)}"

    def _save(self, end: ConnectionEnd) -> None:
        self.store.set(connection_key(end.connection_id), end.marshal())

    def connection(self, connection_id: str) -> ConnectionEnd:
        raw = self.store.get(connection_key(connection_id))
        if raw is None:
            raise IBCError(f"no connection {connection_id}")
        return ConnectionEnd.unmarshal(raw)

    def open_init(self, client_id: str, counterparty_client_id: str) -> str:
        """ConnOpenInit (chain A): record intent; nothing to prove yet."""
        self.clients.client_state(client_id)  # must exist
        end = ConnectionEnd(
            self._next_id(), client_id,
            counterparty_client_id=counterparty_client_id, state="INIT",
        )
        self._save(end)
        return end.connection_id

    def open_try(
        self, client_id: str, counterparty_connection_id: str,
        counterparty_client_id: str, proof_init, proof_height: int,
    ) -> str:
        """ConnOpenTry (chain B): verify A really has an INIT record
        naming our client.  A's INIT doesn't know B's connection id yet —
        it recorded only the client pair, which is exactly what we verify."""
        expected = ConnectionEnd(
            counterparty_connection_id,
            client_id=counterparty_client_id,  # A's client of us
            counterparty_connection_id="",
            counterparty_client_id=client_id,  # our client of A, as A named it
            state="INIT",
        )
        self.clients.verify_membership(
            client_id, proof_height,
            connection_key(counterparty_connection_id),
            expected.marshal(), proof_init,
        )
        end = ConnectionEnd(
            self._next_id(), client_id,
            counterparty_connection_id=counterparty_connection_id,
            counterparty_client_id=counterparty_client_id, state="TRYOPEN",
        )
        self._save(end)
        return end.connection_id

    def open_ack(
        self, connection_id: str, counterparty_connection_id: str,
        proof_try, proof_height: int,
    ) -> None:
        """ConnOpenAck (chain A): verify B's TRYOPEN names our connection."""
        end = self.connection(connection_id)
        if end.state != "INIT":
            raise IBCError(
                f"connection {connection_id} is {end.state}, expected INIT"
            )
        expected = ConnectionEnd(
            counterparty_connection_id, end.counterparty_client_id,
            counterparty_connection_id=connection_id,
            counterparty_client_id=end.client_id, state="TRYOPEN",
        )
        self.clients.verify_membership(
            end.client_id, proof_height,
            connection_key(counterparty_connection_id),
            expected.marshal(), proof_try,
        )
        self._save(replace(
            end, state="OPEN",
            counterparty_connection_id=counterparty_connection_id,
        ))

    def open_confirm(
        self, connection_id: str, proof_ack, proof_height: int
    ) -> None:
        """ConnOpenConfirm (chain B): verify A went OPEN."""
        end = self.connection(connection_id)
        if end.state != "TRYOPEN":
            raise IBCError(
                f"connection {connection_id} is {end.state}, expected TRYOPEN"
            )
        expected = ConnectionEnd(
            end.counterparty_connection_id, end.counterparty_client_id,
            counterparty_connection_id=connection_id,
            counterparty_client_id=end.client_id, state="OPEN",
        )
        self.clients.verify_membership(
            end.client_id, proof_height,
            connection_key(end.counterparty_connection_id),
            expected.marshal(), proof_ack,
        )
        self._save(replace(end, state="OPEN"))


class ChannelHandshake:
    """04-channel handshake over an OPEN connection.  Channels created
    this way carry their connection id, which marks them proof-required
    on the packet path (modules/ibc/__init__ relay verification)."""

    def __init__(self, store: KVStore):
        self.store = store
        self.connections = ConnectionKeeper(store)

    def _next_channel_id(self) -> str:
        from celestia_app_tpu_torch.modules.ibc.core import next_counter

        return f"channel-{next_counter(self.store, _NEXT_CHAN_KEY)}"

    def _save(self, chan: Channel) -> None:
        self.store.set(channel_key(chan.port, chan.channel_id), chan.marshal())

    def _get(self, port: str, channel_id: str) -> Channel:
        raw = self.store.get(channel_key(port, channel_id))
        if raw is None:
            raise IBCError(f"unknown channel {port}/{channel_id}")
        return Channel.unmarshal(raw)

    def _open_connection(self, connection_id: str) -> ConnectionEnd:
        end = self.connections.connection(connection_id)
        if end.state != "OPEN":
            raise IBCError(
                f"connection {connection_id} is {end.state}, expected OPEN"
            )
        return end

    @staticmethod
    def _ordering_for(port: str, counterparty_port: str) -> str:
        """Channel ordering by application (ibc-go: the app module picks
        it at handshake time): ICA runs over ORDERED channels, transfer
        (and everything else here) over UNORDERED.  Both ends derive the
        same answer (the ports swap but the rule is symmetric), and it is
        part of the proven channel ends, so a mismatch fails the
        handshake."""
        from celestia_app_tpu_torch.modules.ibc.ica import (
            CONTROLLER_PORT_PREFIX,
            ICA_HOST_PORT,
        )

        ica = (
            port == ICA_HOST_PORT
            or counterparty_port == ICA_HOST_PORT
            or port.startswith(CONTROLLER_PORT_PREFIX)
            or counterparty_port.startswith(CONTROLLER_PORT_PREFIX)
        )
        return "ORDERED" if ica else "UNORDERED"

    def open_init(self, connection_id: str, port: str,
                  counterparty_port: str, version: str = "ics20-1") -> str:
        self._open_connection(connection_id)
        chan = Channel(
            port, self._next_channel_id(), counterparty_port, "",
            state="INIT", version=version, connection_id=connection_id,
            ordering=self._ordering_for(port, counterparty_port),
        )
        self._save(chan)
        return chan.channel_id

    def open_try(
        self, connection_id: str, port: str, counterparty_port: str,
        counterparty_channel_id: str, proof_init, proof_height: int,
        version: str = "ics20-1",
    ) -> str:
        end = self._open_connection(connection_id)
        ordering = self._ordering_for(port, counterparty_port)
        expected = Channel(
            counterparty_port, counterparty_channel_id, port, "",
            state="INIT", version=version,
            connection_id=end.counterparty_connection_id,
            ordering=ordering,
        )
        self.connections.clients.verify_membership(
            end.client_id, proof_height,
            channel_key(counterparty_port, counterparty_channel_id),
            expected.marshal(), proof_init,
        )
        chan = Channel(
            port, self._next_channel_id(), counterparty_port,
            counterparty_channel_id, state="TRYOPEN", version=version,
            connection_id=connection_id, ordering=ordering,
        )
        self._save(chan)
        self._on_chan_open_try(chan)
        return chan.channel_id

    def _on_chan_open_try(self, chan: Channel) -> None:
        """App-module channel-open callback (ibc-go OnChanOpenTry): a
        channel opened TO port `icahost` registers the interchain account
        for (connection, controller port) — without this the handshake
        would open a channel no EXECUTE_TX could ever use."""
        from celestia_app_tpu_torch.modules.ibc.ica import ICA_HOST_PORT, ICAHostKeeper

        if chan.port == ICA_HOST_PORT:
            from celestia_app_tpu_torch.state.accounts import AuthKeeper

            ICAHostKeeper(self.store).register_account(
                AuthKeeper(self.store), chan.connection_id,
                chan.counterparty_port,
            )

    def open_ack(
        self, port: str, channel_id: str, counterparty_channel_id: str,
        proof_try, proof_height: int,
    ) -> None:
        chan = self._get(port, channel_id)
        if chan.state != "INIT":
            raise IBCError(f"channel {channel_id} is {chan.state}, expected INIT")
        end = self._open_connection(chan.connection_id)
        expected = Channel(
            chan.counterparty_port, counterparty_channel_id, port, channel_id,
            state="TRYOPEN", version=chan.version,
            connection_id=end.counterparty_connection_id,
            ordering=chan.ordering,
        )
        self.connections.clients.verify_membership(
            end.client_id, proof_height,
            channel_key(chan.counterparty_port, counterparty_channel_id),
            expected.marshal(), proof_try,
        )
        self._save(replace(
            chan, state="OPEN",
            counterparty_channel_id=counterparty_channel_id,
        ))
        self._init_sequence(port, channel_id)

    def open_confirm(
        self, port: str, channel_id: str, proof_ack, proof_height: int
    ) -> None:
        chan = self._get(port, channel_id)
        if chan.state != "TRYOPEN":
            raise IBCError(
                f"channel {channel_id} is {chan.state}, expected TRYOPEN"
            )
        end = self._open_connection(chan.connection_id)
        expected = Channel(
            chan.counterparty_port, chan.counterparty_channel_id, port,
            channel_id, state="OPEN", version=chan.version,
            connection_id=end.counterparty_connection_id,
            ordering=chan.ordering,
        )
        self.connections.clients.verify_membership(
            end.client_id, proof_height,
            channel_key(chan.counterparty_port, chan.counterparty_channel_id),
            expected.marshal(), proof_ack,
        )
        self._save(replace(chan, state="OPEN"))
        self._init_sequence(port, channel_id)

    def _init_sequence(self, port: str, channel_id: str) -> None:
        key = _chan_key(b"nextseq", port, channel_id)
        if self.store.get(key) is None:
            self.store.set(key, (1).to_bytes(8, "big"))

    # --- closing (ChanCloseInit / ChanCloseConfirm) -------------------------
    @staticmethod
    def _user_close_forbidden(port: str) -> str | None:
        """ibc-go app-module OnChanCloseInit parity: ICS-20 refuses
        (escrowed funds must stay redeemable) and BOTH ICA sides refuse
        (ICA channels close only through the ordered-channel timeout
        path, never by users)."""
        from celestia_app_tpu_torch.modules.ibc.ica import (
            CONTROLLER_PORT_PREFIX,
            ICA_HOST_PORT,
        )
        from celestia_app_tpu_torch.modules.ibc.transfer import TRANSFER_PORT

        if port == TRANSFER_PORT:
            return (
                "transfer channels cannot be closed by users "
                "(ics20 OnChanCloseInit)"
            )
        if port == ICA_HOST_PORT or port.startswith(CONTROLLER_PORT_PREFIX):
            return (
                "interchain-account channels cannot be closed by users "
                "(ica OnChanCloseInit; they close via the timeout path)"
            )
        return None

    def close_init(self, port: str, channel_id: str) -> None:
        """ChanCloseInit: the local end goes CLOSED (only for app ports
        whose module allows user-initiated closes)."""
        chan = self._get(port, channel_id)
        if chan.state != "OPEN":
            raise IBCError(
                f"channel {channel_id} is {chan.state}, expected OPEN"
            )
        refusal = self._user_close_forbidden(port)
        if refusal is not None:
            raise IBCError(refusal)
        self._save(replace(chan, state="CLOSED"))

    def close_confirm(
        self, port: str, channel_id: str, proof_init, proof_height: int
    ) -> None:
        """ChanCloseConfirm: close the local end after PROVING the
        counterparty already closed (connection-backed channels only).
        In-flight packets still flush: timeout_packet works on CLOSED
        channels (core.py), so escrows refund after a close."""
        chan = self._get(port, channel_id)
        if chan.state == "CLOSED":
            return  # idempotent
        if not chan.connection_id:
            raise IBCError(
                "close-confirm needs a connection-backed channel "
                "(direct-OPEN test channels close via close_init on both "
                "ends)"
            )
        end = self.connections.connection(chan.connection_id)
        expected = Channel(
            chan.counterparty_port, chan.counterparty_channel_id, port,
            channel_id, state="CLOSED", version=chan.version,
            connection_id=end.counterparty_connection_id,
            ordering=chan.ordering,
        )
        self.connections.clients.verify_membership(
            end.client_id, proof_height,
            channel_key(chan.counterparty_port, chan.counterparty_channel_id),
            expected.marshal(), proof_init,
        )
        self._save(replace(chan, state="CLOSED"))


# --- packet-proof verification (the relay msgs' proof path) -----------------


def _require_proof(proof, what: str):
    if proof is None:
        raise IBCError(
            f"channel is connection-backed: a verified {what} proof is "
            "required (IBC-lite trusted relay only applies to direct-OPEN "
            "channels)"
        )


def verify_recv_proof(store, chan: Channel, packet, proof, proof_height: int) -> None:
    """MsgRecvPacket on a connection-backed channel: the packet's
    commitment must exist in the SENDER's proven state."""
    _require_proof(proof, "commitment")
    conn = ConnectionKeeper(store)
    end = conn.connection(chan.connection_id)
    key = _chan_key(
        b"commit", packet.source_port, packet.source_channel, packet.sequence
    )
    conn.clients.verify_membership(
        end.client_id, proof_height, key, packet.commitment(), proof
    )


def verify_ack_proof(
    store, chan: Channel, packet, ack: bytes, proof, proof_height: int
) -> None:
    """MsgAcknowledgement: the RECEIVER's proven state holds
    sha256(ack) under the packet's ack key (ibc-go
    CommitAcknowledgement)."""
    import hashlib

    _require_proof(proof, "acknowledgement")
    conn = ConnectionKeeper(store)
    end = conn.connection(chan.connection_id)
    key = _chan_key(
        b"ack", packet.destination_port, packet.destination_channel,
        packet.sequence,
    )
    conn.clients.verify_membership(
        end.client_id, proof_height, key, hashlib.sha256(ack).digest(), proof
    )


def verify_timeout_proof(
    store, chan: Channel, packet, proof, proof_height: int
) -> None:
    """MsgTimeout: the RECEIVER's proven state has NO receipt for the
    packet at `proof_height` (it never arrived), and the proof height
    itself is past the packet's height timeout — so it can never arrive
    before timing out.  Timestamp timeouts verify against the
    counterparty's +2/3-attested block time (counterparty_proof_time),
    not anyone's local clock."""
    _require_proof(proof, "non-receipt")
    conn = ConnectionKeeper(store)
    end = conn.connection(chan.connection_id)
    key = _chan_key(
        b"receipt", packet.destination_port, packet.destination_channel,
        packet.sequence,
    )
    conn.clients.verify_non_membership(end.client_id, proof_height, key, proof)


def counterparty_proof_time(store, chan: Channel, proof_height: int) -> int:
    """The attested counterparty time bounding a non-receipt at
    `proof_height` (ibc-go GetTimestampAtHeight over the 07-tendermint
    consensus state).

    The proven state is the counterparty's app hash AFTER its block
    `proof_height`, pinned by the consensus state at proof_height + 1 —
    whose time_ns is inside the +2/3-signed block id (consensus/votes.py
    block_id).  Any future receipt lands in a block >= proof_height + 1
    with a strictly later time (BFT time monotonicity, enforced at
    proposal validation), so `cs.time_ns >= packet.timeout_timestamp`
    proves the packet can never be accepted.  Returns 0 (= timestamp
    timeout never provable; use a height timeout) for consensus states
    recorded without a time."""
    conn = ConnectionKeeper(store)
    end = conn.connection(chan.connection_id)
    cs = conn.clients.consensus_state(end.client_id, proof_height + 1)
    return cs.time_ns
