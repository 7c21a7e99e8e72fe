"""The port's IBC stack, held to the JAX App's by record and replay.

The JAX package's own two-chain harness (celestia_app_tpu/testutil/ibc.py:
two in-process chains joined by an OPEN transfer channel, packets relayed
as signed txs through real blocks) runs the scenarios: a transfer out and
back home, a foreign token refused by the tokenfilter and refunded, a
timeout refund, a redundant relay landing twice in one block, a packet
forward (PFM) at v2 and none at v1; an interchain-accounts host at v2
running a send and a delegation through the App's own handlers (error acks
for a foreign signer and a message off the allow list, the ack relayed back
to the controller), and its packet refused at v1; and, on a pair joined the
full way (light clients of each other, the connection and channel
handshakes), a transfer whose every relay carries a state proof, and a
timeout proven by non-receipt. While they run, each chain's
`finalize_block` and `commit` are wrapped on the App instance and record
the block's arguments, its TxResults and app hash, and the writes the
harness made to the working store since the last commit (the channels it
opens directly, the interchain account it registers and funds). Each
chain's blocks are then replayed into a port App (`App(device="cpu")`)
built from the same genesis, or carried over by `convert.app_from_export`
where the chain made blocks before it was recorded: per block, the same
TxResults (code, log, gas, events) and the same app hash.

The harness's proposals compile JAX programs (k <= 2), so the chains are
set up once per module.
"""

from __future__ import annotations

import gc
import json

import jax
import pytest

from celestia_app_tpu.modules.ibc import Channel as JaxChannel
from celestia_app_tpu.modules.ibc import ChannelKeeper as JaxChannelKeeper
from celestia_app_tpu.modules.ibc import Packet as JaxPacket
from celestia_app_tpu.modules.ibc import voucher_denom
from celestia_app_tpu.modules.ibc.transfer import SUCCESS_ACK, ack_is_error
from celestia_app_tpu.testutil.ibc import TRANSFER_PORT, ConnectedChains, VerifiedChains
from celestia_app_tpu.modules.ibc.core import _chan_key
from celestia_app_tpu.modules.ibc.ica import (
    CONTROLLER_PORT_PREFIX,
    ICA_HOST_PORT,
    ICAHostKeeper,
    encode_packet_data,
)
from celestia_app_tpu.state.accounts import AuthKeeper, BankKeeper
from celestia_app_tpu.state.staking import StakingKeeper
from celestia_app_tpu.tx.messages import Coin as JaxCoin
from celestia_app_tpu.tx.messages import MsgAcknowledgement as JaxMsgAcknowledgement
from celestia_app_tpu.tx.messages import MsgDelegate as JaxMsgDelegate
from celestia_app_tpu.tx.messages import MsgRecvPacket as JaxMsgRecvPacket
from celestia_app_tpu.tx.messages import MsgSend as JaxMsgSend
from celestia_app_tpu.tx.messages import MsgUnjail as JaxMsgUnjail
from celestia_app_tpu.tx.sign import Fee, build_and_sign
from celestia_app_tpu_torch.app import App
from celestia_app_tpu_torch.convert import app_from_export
from celestia_app_tpu_torch.crypto import PrivateKey
from celestia_app_tpu_torch.modules import ibc as port_ibc
from celestia_app_tpu_torch.state.dec import Dec
from celestia_app_tpu_torch.testutil import deterministic_genesis


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran, when it ends:
    each loaded XLA:CPU executable holds hundreds to thousands of memory
    mappings, and a test worker that keeps every module's programs can
    reach the kernel's per-process map limit, where the next compile
    aborts."""
    yield
    jax.clear_caches()
    gc.collect()


def result(r) -> tuple:
    return r.code, r.log, r.gas_wanted, r.gas_used, r.events


def record(app) -> list[dict]:
    """Wrap `app.finalize_block` and `app.commit` on the instance; returns
    the list each block's record is appended to, after a first entry that
    holds what `convert.app_from_export` needs to start from the App's
    committed state as it is now."""
    m = app.minter
    blocks: list[dict] = [{
        "items": app.cms.export(), "chain_id": app.chain_id, "app_version": app.app_version,
        "height": app.height, "genesis_time_ns": app.genesis_time_ns,
        "last_block_time_ns": app.last_block_time_ns,
        "minter": {"inflation_rate": m.inflation_rate.raw,
                   "annual_provisions": m.annual_provisions.raw,
                   "previous_block_time_ns": m.previous_block_time_ns},
        "v2_upgrade_height": app.v2_upgrade_height,
        "ibc_token_filter": app.ibc_token_filter,
    }]
    finalize, commit = app.finalize_block, app.commit

    def recording_finalize(time_ns, txs, last_commit_signers=None, evidence=()):
        assert not evidence
        committed = app.cms.export()
        working = app.cms.working.snapshot()
        block = {
            "writes": {k: v for k, v in working.items() if committed.get(k) != v},
            "deletes": [k for k in committed if k not in working],
            "time_ns": time_ns, "txs": list(txs), "signers": last_commit_signers,
        }
        results = finalize(time_ns, txs, last_commit_signers=last_commit_signers)
        block["results"] = [result(r) for r in results]
        blocks.append(block)
        return results

    def recording_commit():
        blocks[-1]["app_hash"] = commit()
        return blocks[-1]["app_hash"]

    app.finalize_block, app.commit = recording_finalize, recording_commit
    return blocks


def recv(end, packet, key=None):
    key = key or end.relayer
    return end.submit(key, JaxMsgRecvPacket(packet.marshal(), key.public_key().address()))


def scenarios_v2(chains: ConnectedChains) -> dict:
    """The v2 scenarios on the JAX harness, each checked on the JAX side."""
    a, b = chains.a, chains.b
    alice, bob = a.keys[0], b.keys[0]
    alice_addr, bob_addr = (k.public_key().address() for k in (alice, bob))
    # A transfer out, and the voucher back home.
    packet, res = chains.transfer(a, b, alice, bob_addr, "utia", 1_000)
    assert res.code == 0 and chains.relay(packet, src=a, dst=b) == SUCCESS_ACK
    voucher = voucher_denom(TRANSFER_PORT, b.channel_id, "utia")
    packet, res = chains.transfer(b, a, bob, alice_addr, voucher, 400)
    assert res.code == 0 and chains.relay(packet, src=b, dst=a) == SUCCESS_ACK
    assert b.balance(bob_addr, denom=voucher) == 600
    # B's own token refused by celestia's tokenfilter, refunded on B.
    packet, res = chains.transfer(b, a, b.keys[1], alice_addr, "utia", 500)
    ack = chains.relay(packet, src=b, dst=a)
    assert res.code == 0 and ack_is_error(ack) and b"only native denom" in ack
    # A timeout refund.
    packet, res = chains.transfer(a, b, a.keys[1], "beta1receiver", "utia", 700,
                                  timeout_height=3)
    assert res.code == 0
    res, _ = chains.timeout(packet, src=a, proof_height=3)
    assert res.code == 0, res.log
    # A redundant relay: two relayers' recvs of one packet in one block.
    packet, _ = chains.transfer(a, b, a.keys[2], b.keys[2].public_key().address(), "utia", 5)
    raws = []
    for key in (b.relayer, b.keys[2]):
        addr = key.public_key().address()
        raws.append(b.node.broadcast(_signed_recv(b, key, packet, addr)))
    assert [r.code for r in raws] == [0, 0]
    _, results = b.node.produce_block()
    assert [r.code for r in results] == [0, 0]
    assert sum(e[0] == "ibc.noop" for r in results for e in r.events) == 1
    # A forward through B back home (PFM at v2).
    final_addr = a.keys[1].public_key().address()
    memo = json.dumps({"forward": {"receiver": final_addr, "channel": b.channel_id}})
    packet, res = chains.transfer(a, b, alice, bob_addr, "utia", 250, memo=memo)
    res, results = recv(b, packet)
    onward = chains._sent_packet(results)
    assert res.code == 0 and onward is not None
    assert chains.relay(onward, src=b, dst=a) == SUCCESS_ACK
    return {}


def scenarios_v1(chains: ConnectedChains) -> dict:
    a, b = chains.a, chains.b
    memo = json.dumps({"forward": {"receiver": "whoever", "channel": b.channel_id}})
    packet, res = chains.transfer(a, b, a.keys[0], b.keys[0].public_key().address(), "utia",
                                  9, memo=memo)
    assert res.code == 0
    res, results = recv(b, packet)
    assert res.code == 0 and chains._sent_packet(results) is None  # no PFM at v1
    ack = chains._written_ack(results)
    res, _ = a.submit(a.relayer, JaxMsgAcknowledgement(
        packet.marshal(), a.relayer.public_key().address(), ack))
    assert ack == SUCCESS_ACK and res.code == 0
    ica_refused_at_v1(chains)
    return {}


def _signed_recv(end, key, packet, addr: str) -> bytes:
    acct = AuthKeeper(end.node.app.cms.working).get_account(addr)
    return build_and_sign([JaxMsgRecvPacket(packet.marshal(), addr)], key, end.node.chain_id,
                          acct.account_number, acct.sequence,
                          Fee((JaxCoin("utia", 20_000),), 400_000))


def scenarios_verified(chains: VerifiedChains) -> dict:
    """Light clients of each other, the connection and channel handshakes,
    then a transfer relayed with proofs both ways and a timeout refunded on
    a proof of non-receipt."""
    chains.handshake()
    a, b = chains.a, chains.b
    packet, res = chains.transfer(a, b, a.keys[0], b.keys[0].public_key().address(), "utia",
                                  9_000)
    assert res.code == 0, res.log
    res, results = chains.relay_recv(packet, a, b)
    ack = chains._written_ack(results)
    assert res.code == 0 and ack == SUCCESS_ACK, res.log
    res, _ = chains.relay_ack(packet, ack, a, b)
    assert res.code == 0, res.log
    packet, res = chains.transfer(a, b, a.keys[1], b.keys[0].public_key().address(), "utia",
                                  700, timeout_height=b.height + 1)
    assert res.code == 0, res.log
    b.produce()
    res, _ = chains.relay_timeout(packet, a, b)
    assert res.code == 0, res.log
    return {}


OWNER_PORT = CONTROLLER_PORT_PREFIX + "alice"


def ica_host(chains: ConnectedChains) -> tuple:
    """Chain a hosts an interchain account for chain b's controller port,
    over an ORDERED channel pair the harness opens directly; the account is
    registered and funded the same way (writes to the working store)."""
    a, b = chains.a, chains.b
    for end, port, counterparty in ((a, ICA_HOST_PORT, OWNER_PORT),
                                    (b, OWNER_PORT, ICA_HOST_PORT)):
        JaxChannelKeeper(end.store).create_channel(JaxChannel(
            port, "channel-7", counterparty, "channel-7", version="ics27-1",
            ordering="ORDERED"))
    ica = ICAHostKeeper(a.store).register_account(AuthKeeper(a.store), "", OWNER_PORT)
    BankKeeper(a.store).mint(ica, 1_000_000)
    return a, b, ica


def ica_recv(chains, a, b, msgs, sequence: int) -> tuple:
    """Relay one ICA packet of `msgs` to the host; returns (code, ack)."""
    packet = JaxPacket(sequence, OWNER_PORT, "channel-7", ICA_HOST_PORT, "channel-7",
                       encode_packet_data(msgs))
    res, results = recv(a, packet)
    return res.code, chains._written_ack(results), packet


def scenarios_ica(chains: ConnectedChains) -> dict:
    """The ICA host at v2: the inner messages run through the App's own
    handlers (a send and a delegation), a message signed by another
    account and one off the allow list get error acks, and the ack of the
    send is relayed back to the controller."""
    a, b, ica = ica_host(chains)
    to = a.keys[0].public_key().address()
    validator = StakingKeeper(a.store).validators()[0].address
    code, ack, packet = ica_recv(chains, a, b, [JaxMsgSend(ica, to, (JaxCoin("utia", 40_000),))],
                                 1)
    assert (code, ack) == (0, b'{"result":"AQ=="}')
    b.store.set(_chan_key(b"commit", OWNER_PORT, "channel-7", 1), packet.commitment())
    res, _ = b.submit(b.relayer, JaxMsgAcknowledgement(
        packet.marshal(), b.relayer.public_key().address(), ack))
    assert res.code == 0, res.log
    code, ack, _ = ica_recv(chains, a, b,
                            [JaxMsgDelegate(ica, validator, JaxCoin("utia", 500_000))], 2)
    assert (code, ack) == (0, b'{"result":"AQ=="}')
    code, ack, _ = ica_recv(chains, a, b, [JaxMsgSend(to, ica, (JaxCoin("utia", 999),))], 3)
    assert code == 0 and b"not the interchain account" in ack
    code, ack, _ = ica_recv(chains, a, b, [JaxMsgUnjail(ica)], 4)
    assert code == 0 and b"not in the ICA allow list" in ack
    return {}


def ica_refused_at_v1(chains: ConnectedChains) -> None:
    a, b, ica = ica_host(chains)
    msg = JaxMsgSend(ica, a.keys[0].public_key().address(), (JaxCoin("utia", 1),))
    packet = JaxPacket(1, OWNER_PORT, "channel-7", ICA_HOST_PORT, "channel-7",
                       encode_packet_data([msg]))
    res, _ = recv(a, packet)
    assert res.code == 2 and "v2 module" in res.log


@pytest.fixture(scope="module")
def recorded() -> dict:
    """name -> (chain end, its recorded blocks, its genesis app version),
    for a v2 and a v1 pair joined directly and a v2 pair joined through
    light clients and handshakes (recorded from its first block on)."""
    out = {}
    for name, version, make, scenarios in (
        ("v2", 2, ConnectedChains, scenarios_v2), ("v1", 1, ConnectedChains, scenarios_v1),
        ("ica", 2, ConnectedChains, scenarios_ica),
        ("verified", 2, VerifiedChains, scenarios_verified),
    ):
        chains = make(app_version=version)
        blocks = {end: record(end.node.app) for end in (chains.a, chains.b)}
        scenarios(chains)
        for label, end in (("alpha", chains.a), ("beta", chains.b)):
            out[f"{name}_{label}"] = (end, blocks[end], version)
    return out


def port_app(end, app_version: int) -> App:
    """The port App of a harness chain end: the same genesis (keys from the
    same seeds) and options."""
    name = end.chain_id.removesuffix("-chain")
    keys = [PrivateKey.from_seed(f"{name}-user-{i}".encode()) for i in range(3)]
    keys.append(PrivateKey.from_seed(f"{name}-relayer".encode()))
    app = App(node_min_gas_price=Dec.from_str("0.000001"),
              ibc_token_filter=end.node.app.ibc_token_filter, device="cpu")
    app.init_chain(deterministic_genesis(keys, chain_id=end.chain_id, app_version=app_version))
    return app


@pytest.mark.parametrize("name", ["v2_alpha", "v2_beta", "v1_alpha", "v1_beta", "ica_alpha",
                                  "ica_beta", "verified_alpha", "verified_beta"])
def test_replayed_blocks_equal(recorded, name):
    end, (start, *blocks), version = recorded[name]
    if start["height"] == 0:
        app = port_app(end, version)
    else:  # the chain made blocks before it was recorded: carry its state over
        app = app_from_export(device="cpu", **start)
    assert app.cms.last_app_hash == end.node.app.cms.app_hash_at(start["height"])
    assert blocks
    for height, block in enumerate(blocks, start=start["height"] + 1):
        for key, value in block["writes"].items():
            app.cms.working.set(key, value)
        for key in block["deletes"]:
            app.cms.working.delete(key)
        got = app.finalize_block(block["time_ns"], block["txs"],
                                 last_commit_signers=block["signers"])
        assert [result(r) for r in got] == block["results"], f"height {height}"
        assert app.commit() == block["app_hash"], f"height {height}"
    # What the chain's IBC state holds at the end, read through the port.
    channels = port_ibc.ChannelKeeper(app.cms.working)
    assert channels.channel(TRANSFER_PORT, end.channel_id).state == "OPEN"


def test_recorded_scenarios_cover_every_relay_message(recorded):
    """The replayed blocks hold every relay outcome the handlers give: sent
    packets, written acks (success and error), acknowledgements, a
    timeout, a no-op redundant recv, and a forward's onward packet."""
    kinds = {e[0] for _, blocks, _ in recorded.values() for b in blocks[1:]
             for r in b["results"] for e in r[4]}
    assert {"ibc.send_packet", "ibc.write_acknowledgement", "ibc.acknowledge_packet",
            "ibc.timeout_packet", "ibc.noop"} <= kinds
