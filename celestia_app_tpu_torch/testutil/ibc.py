"""Two connected in-process chains + a relayer (the ibctesting analog).

Mirrors the reference's IBC test setup shape (test/tokenfilter/setup.go,
test/pfm/simapp.go drive ibctesting paths): two apps with an OPEN channel
pair, a funded relayer account on each side, and helpers that move packets
and acks across as signed MsgRecvPacket / MsgAcknowledgement / MsgTimeout
txs through real blocks.

The port's copy of celestia_app_tpu/testutil/ibc.py.  `ChainEnd`,
`ConnectedChains` and `VerifiedChains` take a `device` on which both chain
ends' Apps run (None means CUDA and raises without a card; "cpu" runs the
plain PyTorch versions of the kernels).
"""

from __future__ import annotations

from celestia_app_tpu_torch.crypto.keys import PrivateKey
from celestia_app_tpu_torch.modules.ibc import Channel, ChannelKeeper, Packet
from celestia_app_tpu_torch.state.accounts import AuthKeeper
from celestia_app_tpu_torch.testutil.testnode import (
    TestNode,
    deterministic_genesis,
    funded_keys,
)
from celestia_app_tpu_torch.tx.messages import (
    Coin,
    MsgAcknowledgement,
    MsgRecvPacket,
    MsgTimeout,
    MsgTransfer,
)
from celestia_app_tpu_torch.tx.sign import Fee, build_and_sign

TRANSFER_PORT = "transfer"


class ChainEnd:
    def __init__(
        self, name: str, app_version: int, channel_id: str, token_filter: bool = True,
        device=None,
    ):
        from celestia_app_tpu_torch.app import App
        from celestia_app_tpu_torch.state.dec import Dec

        self.keys = [
            PrivateKey.from_seed(f"{name}-user-{i}".encode()) for i in range(3)
        ]
        self.relayer = PrivateKey.from_seed(f"{name}-relayer".encode())
        # The consensus keys behind deterministic_genesis's validator set —
        # what signs the Commits light clients verify.
        self.val_keys = [
            PrivateKey.from_seed(f"validator-{i}".encode()) for i in range(3)
        ]
        app = App(
            node_min_gas_price=Dec.from_str("0.000001"),
            ibc_token_filter=token_filter,
            device=device,
        )
        app.init_chain(
            deterministic_genesis(
                self.keys + [self.relayer],
                chain_id=f"{name}-chain",
                app_version=app_version,
            )
        )
        self.node = TestNode(keys=self.keys + [self.relayer], app=app)
        self.channel_id = channel_id

    @property
    def chain_id(self) -> str:
        return self.node.chain_id

    @property
    def height(self) -> int:
        return self.node.app.height

    @property
    def store(self):
        return self.node.app.cms.working

    def produce(self):
        return self.node.produce_block()

    def app_hash_at(self, height: int) -> bytes:
        # The commit store records every height's hash — no parallel
        # bookkeeping, so blocks produced through ANY path count.
        return self.node.app.cms.app_hash_at(height)

    def submit(self, key: PrivateKey, msg, gas: int = 400_000):
        addr = key.public_key().address()
        acct = AuthKeeper(self.node.app.cms.working).get_account(addr)
        raw = build_and_sign(
            [msg], key, self.node.chain_id, acct.account_number, acct.sequence,
            Fee((Coin("utia", 20_000),), gas),
        )
        res = self.node.broadcast(raw)
        if res.code != 0:
            return res, []
        _, results = self.produce()
        return results[-1], results

    # --- the light-client surface (what a relayer reads off this chain) ----
    def validator_map(self):
        from celestia_app_tpu_torch.crypto.keys import PublicKey
        from celestia_app_tpu_torch.state.staking import StakingKeeper

        return {
            v.address: (PublicKey(v.pubkey), v.power)
            for v in StakingKeeper(self.node.app.cms.working).bonded_validators()
            if v.pubkey
        }

    def commit_for(self, height: int, keys: list | None = None):
        """A real +2/3 Commit for `height`, signed by the genesis
        validators' consensus keys (what the serving plane's voting round
        produces; TestNode has no vote plane, so the harness signs).
        `keys` overrides the signer set — rotation tests model a chain
        whose validators changed by signing later commits with new keys."""
        from celestia_app_tpu_torch.consensus import PRECOMMIT, Commit, Vote, block_id

        data_root = self.node.blocks[height - 1].hash
        prev_hash = self.app_hash_at(height - 1)
        time_ns = self.node.block_times[height]
        bid = block_id(data_root, prev_hash, time_ns)
        votes = tuple(
            Vote.sign(k, self.chain_id, height, PRECOMMIT, bid)
            for k in (keys if keys is not None else self.val_keys)
        )
        return Commit(height, bid, votes, data_root, prev_hash, time_ns=time_ns)

    def proof_at(self, key: bytes, height: int):
        return self.node.app.cms.proof_at(key, height)

    def balance(self, address: str, denom: str = "utia") -> int:
        from celestia_app_tpu_torch.state.accounts import BankKeeper

        return BankKeeper(self.node.app.cms.working).balance(address, denom=denom)


class ConnectedChains:
    """celestia (chain_a, tokenfilter ON) <-> counterparty simapp (chain_b,
    no filter — the reference's test/pfm/simapp.go role), over
    transfer/channel-0 on both ends."""

    def __init__(self, app_version: int = 2, b_token_filter: bool = False, device=None):
        self.a = ChainEnd("alpha", app_version, "channel-0", device=device)
        self.b = ChainEnd("beta", app_version, "channel-0", token_filter=b_token_filter,
                          device=device)
        for end, other in ((self.a, self.b), (self.b, self.a)):
            ChannelKeeper(end.node.app.cms.working).create_channel(
                Channel(
                    TRANSFER_PORT, end.channel_id, TRANSFER_PORT, other.channel_id
                )
            )

    @staticmethod
    def _sent_packet(results) -> Packet | None:
        for r in results:
            for e in r.events:
                if e[0] == "ibc.send_packet":
                    return Packet.unmarshal(bytes.fromhex(e[1]))
        return None

    @staticmethod
    def _written_ack(results) -> bytes | None:
        for r in results:
            for e in r.events:
                if e[0] == "ibc.write_acknowledgement":
                    return bytes.fromhex(e[2])
        return None

    def transfer(
        self, src: ChainEnd, dst: ChainEnd, key: PrivateKey, receiver: str,
        denom: str, amount: int, timeout_height: int = 0,
        timeout_timestamp_ns: int = 0, memo: str = "",
    ):
        """Send a transfer on src; returns (packet, tx result)."""
        msg = MsgTransfer(
            TRANSFER_PORT, src.channel_id, Coin(denom, amount),
            key.public_key().address(), receiver,
            timeout_revision_height=timeout_height,
            timeout_timestamp_ns=timeout_timestamp_ns, memo=memo,
        )
        result, results = src.submit(key, msg)
        return self._sent_packet(results), result

    def relay(self, packet: Packet, src: ChainEnd, dst: ChainEnd) -> bytes:
        """recv on dst, ack back on src; returns the acknowledgement."""
        relayer = dst.relayer
        result, results = dst.submit(
            relayer,
            MsgRecvPacket(packet.marshal(), relayer.public_key().address()),
        )
        assert result.code == 0, result.log
        ack = self._written_ack(results)
        assert ack is not None, "recv wrote no acknowledgement"
        result, _ = src.submit(
            src.relayer,
            MsgAcknowledgement(
                packet.marshal(), src.relayer.public_key().address(), ack
            ),
        )
        assert result.code == 0, result.log
        return ack

    def timeout(self, packet: Packet, src: ChainEnd, proof_height: int):
        return src.submit(
            src.relayer,
            MsgTimeout(
                packet.marshal(), src.relayer.public_key().address(),
                proof_height=proof_height,
            ),
        )


class VerifiedChains:
    """Two chains joined the REAL way: light clients of each other's
    consensus, the 03-connection + 04-channel handshakes proof-verified
    step by step, and packet relay that ships SMT state proofs with every
    MsgRecvPacket / MsgAcknowledgement / MsgTimeout (the full ibc-go path
    the IBC-lite harness above shortcuts)."""

    def __init__(self, app_version: int = 2, b_token_filter: bool = False, device=None):
        from celestia_app_tpu_torch.modules.ibc.client import ClientKeeper

        self.a = ChainEnd("alpha", app_version, "", token_filter=True, device=device)
        self.b = ChainEnd(
            "beta", app_version, "", token_filter=b_token_filter, device=device
        )
        # A block of history so clients have something to verify.
        self.a.produce()
        self.b.produce()
        self.client_on_a = ClientKeeper(self.a.store).create_client(
            self.b.chain_id, self.b.validator_map()
        )
        self.client_on_b = ClientKeeper(self.b.store).create_client(
            self.a.chain_id, self.a.validator_map()
        )

    def _client_of(self, holder: ChainEnd) -> str:
        return self.client_on_a if holder is self.a else self.client_on_b

    def sync(self, src: ChainEnd, dst: ChainEnd) -> int:
        """Land src's pending state in a commit and update dst's client of
        src with it.  Returns the height dst can now verify proofs at:
        the commit at H+1 pins src's app hash at H."""
        from celestia_app_tpu_torch.modules.ibc.client import ClientKeeper

        src.produce()  # capture pending writes at height H
        src.produce()  # H+1: its commit attests H's app hash
        ClientKeeper(dst.store).update_client(
            self._client_of(dst), src.commit_for(src.height)
        )
        return src.height - 1

    def handshake(self, version: str = "ics20-1") -> tuple[str, str]:
        """The full 8-step dance; returns (channel_id on a, on b)."""
        from celestia_app_tpu_torch.modules.ibc.handshake import (
            ChannelHandshake,
            ConnectionKeeper,
            channel_key,
            connection_key,
        )

        a, b = self.a, self.b
        conn_a = ConnectionKeeper(a.store).open_init(
            self.client_on_a, self.client_on_b
        )
        h = self.sync(a, b)
        conn_b = ConnectionKeeper(b.store).open_try(
            self.client_on_b, conn_a, self.client_on_a,
            a.proof_at(connection_key(conn_a), h), h,
        )
        h = self.sync(b, a)
        ConnectionKeeper(a.store).open_ack(
            conn_a, conn_b, b.proof_at(connection_key(conn_b), h), h
        )
        h = self.sync(a, b)
        ConnectionKeeper(b.store).open_confirm(
            conn_b, a.proof_at(connection_key(conn_a), h), h
        )

        chan_a = ChannelHandshake(a.store).open_init(
            conn_a, TRANSFER_PORT, TRANSFER_PORT, version
        )
        h = self.sync(a, b)
        chan_b = ChannelHandshake(b.store).open_try(
            conn_b, TRANSFER_PORT, TRANSFER_PORT, chan_a,
            a.proof_at(channel_key(TRANSFER_PORT, chan_a), h), h, version,
        )
        h = self.sync(b, a)
        ChannelHandshake(a.store).open_ack(
            TRANSFER_PORT, chan_a, chan_b,
            b.proof_at(channel_key(TRANSFER_PORT, chan_b), h), h,
        )
        h = self.sync(a, b)
        ChannelHandshake(b.store).open_confirm(
            TRANSFER_PORT, chan_b,
            a.proof_at(channel_key(TRANSFER_PORT, chan_a), h), h,
        )
        self.a.channel_id = chan_a
        self.b.channel_id = chan_b
        return chan_a, chan_b

    # --- proof-carrying relay ------------------------------------------------
    def relay_recv(self, packet: Packet, src: ChainEnd, dst: ChainEnd):
        """recv on dst with a verified commitment proof from src."""
        from celestia_app_tpu_torch.modules.ibc.core import _chan_key
        from celestia_app_tpu_torch.state import smt

        h = self.sync(src, dst)
        key = _chan_key(
            b"commit", packet.source_port, packet.source_channel,
            packet.sequence,
        )
        proof = smt.proof_marshal(src.proof_at(key, h))
        relayer = dst.relayer
        return dst.submit(
            relayer,
            MsgRecvPacket(
                packet.marshal(), relayer.public_key().address(),
                proof_height=h, proof=proof,
            ),
        )

    def relay_ack(self, packet: Packet, ack: bytes, src: ChainEnd, dst: ChainEnd):
        """ack back on src with a verified ack proof from dst."""
        from celestia_app_tpu_torch.modules.ibc.core import _chan_key
        from celestia_app_tpu_torch.state import smt

        h = self.sync(dst, src)
        key = _chan_key(
            b"ack", packet.destination_port, packet.destination_channel,
            packet.sequence,
        )
        proof = smt.proof_marshal(dst.proof_at(key, h))
        return src.submit(
            src.relayer,
            MsgAcknowledgement(
                packet.marshal(), src.relayer.public_key().address(), ack,
                proof_height=h, proof=proof,
            ),
        )

    def relay_timeout(self, packet: Packet, src: ChainEnd, dst: ChainEnd):
        """timeout on src with a verified NON-receipt proof from dst."""
        from celestia_app_tpu_torch.modules.ibc.core import _chan_key
        from celestia_app_tpu_torch.state import smt

        h = self.sync(dst, src)
        key = _chan_key(
            b"receipt", packet.destination_port, packet.destination_channel,
            packet.sequence,
        )
        proof = smt.proof_marshal(dst.proof_at(key, h))
        return src.submit(
            src.relayer,
            MsgTimeout(
                packet.marshal(), src.relayer.public_key().address(),
                proof_height=h, proof=proof,
            ),
        )


# VerifiedChains sends transfers exactly like the IBC-lite harness.
VerifiedChains._sent_packet = staticmethod(ConnectedChains._sent_packet)
VerifiedChains._written_ack = staticmethod(ConnectedChains._written_ack)
VerifiedChains.transfer = ConnectedChains.transfer
