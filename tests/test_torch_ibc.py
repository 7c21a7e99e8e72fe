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
import importlib
import json
import types

import jax
import pytest

from celestia_app_tpu.modules.ibc.ica import CONTROLLER_PORT_PREFIX
from celestia_app_tpu.testutil.ibc import TRANSFER_PORT, ConnectedChains, VerifiedChains
from celestia_app_tpu_torch.app import App
from celestia_app_tpu_torch.convert import app_from_export
from celestia_app_tpu_torch.crypto import PrivateKey
from celestia_app_tpu_torch.modules import ibc as port_ibc
from celestia_app_tpu_torch.state.dec import Dec
from celestia_app_tpu_torch.testutil import deterministic_genesis


def package(pkg: str) -> types.SimpleNamespace:
    """The names the scenarios use, from package `pkg` (the JAX package or
    the port), so that the same scenario drives either package's harness."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    ns = types.SimpleNamespace()
    for module, names in (
        ("modules.ibc", ("Channel", "ChannelKeeper", "Packet", "voucher_denom")),
        ("modules.ibc.transfer", ("SUCCESS_ACK", "ack_is_error")),
        ("modules.ibc.core", ("_chan_key",)),
        ("modules.ibc.ica", ("ICA_HOST_PORT", "ICAHostKeeper", "encode_packet_data")),
        ("state.accounts", ("AuthKeeper", "BankKeeper")),
        ("state.staking", ("StakingKeeper",)),
        ("tx.messages", ("Coin", "MsgAcknowledgement", "MsgDelegate", "MsgRecvPacket",
                         "MsgSend", "MsgUnjail")),
        ("tx.sign", ("Fee", "build_and_sign")),
        ("testutil.ibc", ("ConnectedChains", "VerifiedChains")),
    ):
        for name in names:
            setattr(ns, name, getattr(mod(module), name))
    return ns


JAX = package("celestia_app_tpu")
PORT = package("celestia_app_tpu_torch")


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


def recv(end, packet, key=None, L=None):
    L = L or JAX
    key = key or end.relayer
    return end.submit(key, L.MsgRecvPacket(packet.marshal(), key.public_key().address()))


def scenarios_v2(chains: ConnectedChains, L=None) -> dict:
    """The v2 scenarios on a harness of package `L` (default the JAX one),
    each checked on that side."""
    L = L or JAX
    a, b = chains.a, chains.b
    alice, bob = a.keys[0], b.keys[0]
    alice_addr, bob_addr = (k.public_key().address() for k in (alice, bob))
    # A transfer out, and the voucher back home.
    packet, res = chains.transfer(a, b, alice, bob_addr, "utia", 1_000)
    assert res.code == 0 and chains.relay(packet, src=a, dst=b) == L.SUCCESS_ACK
    voucher = L.voucher_denom(TRANSFER_PORT, b.channel_id, "utia")
    packet, res = chains.transfer(b, a, bob, alice_addr, voucher, 400)
    assert res.code == 0 and chains.relay(packet, src=b, dst=a) == L.SUCCESS_ACK
    assert b.balance(bob_addr, denom=voucher) == 600
    # B's own token refused by celestia's tokenfilter, refunded on B.
    packet, res = chains.transfer(b, a, b.keys[1], alice_addr, "utia", 500)
    ack = chains.relay(packet, src=b, dst=a)
    assert res.code == 0 and L.ack_is_error(ack) and b"only native denom" in ack
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
        raws.append(b.node.broadcast(_signed_recv(b, key, packet, addr, L)))
    assert [r.code for r in raws] == [0, 0]
    _, results = b.node.produce_block()
    assert [r.code for r in results] == [0, 0]
    assert sum(e[0] == "ibc.noop" for r in results for e in r.events) == 1
    # A forward through B back home (PFM at v2).
    final_addr = a.keys[1].public_key().address()
    memo = json.dumps({"forward": {"receiver": final_addr, "channel": b.channel_id}})
    packet, res = chains.transfer(a, b, alice, bob_addr, "utia", 250, memo=memo)
    res, results = recv(b, packet, L=L)
    onward = chains._sent_packet(results)
    assert res.code == 0 and onward is not None
    assert chains.relay(onward, src=b, dst=a) == L.SUCCESS_ACK
    return {}


def scenarios_v1(chains: ConnectedChains, L=None) -> dict:
    L = L or JAX
    a, b = chains.a, chains.b
    memo = json.dumps({"forward": {"receiver": "whoever", "channel": b.channel_id}})
    packet, res = chains.transfer(a, b, a.keys[0], b.keys[0].public_key().address(), "utia",
                                  9, memo=memo)
    assert res.code == 0
    res, results = recv(b, packet, L=L)
    assert res.code == 0 and chains._sent_packet(results) is None  # no PFM at v1
    ack = chains._written_ack(results)
    res, _ = a.submit(a.relayer, L.MsgAcknowledgement(
        packet.marshal(), a.relayer.public_key().address(), ack))
    assert ack == L.SUCCESS_ACK and res.code == 0
    ica_refused_at_v1(chains, L)
    return {}


def _signed_recv(end, key, packet, addr: str, L) -> bytes:
    acct = L.AuthKeeper(end.node.app.cms.working).get_account(addr)
    return L.build_and_sign([L.MsgRecvPacket(packet.marshal(), addr)], key, end.node.chain_id,
                            acct.account_number, acct.sequence,
                            L.Fee((L.Coin("utia", 20_000),), 400_000))


def scenarios_verified(chains: VerifiedChains, L=None) -> dict:
    """Light clients of each other, the connection and channel handshakes,
    then a transfer relayed with proofs both ways and a timeout refunded on
    a proof of non-receipt."""
    L = L or JAX
    chains.handshake()
    a, b = chains.a, chains.b
    packet, res = chains.transfer(a, b, a.keys[0], b.keys[0].public_key().address(), "utia",
                                  9_000)
    assert res.code == 0, res.log
    res, results = chains.relay_recv(packet, a, b)
    ack = chains._written_ack(results)
    assert res.code == 0 and ack == L.SUCCESS_ACK, res.log
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


def ica_host(chains: ConnectedChains, L) -> tuple:
    """Chain a hosts an interchain account for chain b's controller port,
    over an ORDERED channel pair the harness opens directly; the account is
    registered and funded the same way (writes to the working store)."""
    a, b = chains.a, chains.b
    for end, port, counterparty in ((a, L.ICA_HOST_PORT, OWNER_PORT),
                                    (b, OWNER_PORT, L.ICA_HOST_PORT)):
        L.ChannelKeeper(end.store).create_channel(L.Channel(
            port, "channel-7", counterparty, "channel-7", version="ics27-1",
            ordering="ORDERED"))
    ica = L.ICAHostKeeper(a.store).register_account(L.AuthKeeper(a.store), "", OWNER_PORT)
    L.BankKeeper(a.store).mint(ica, 1_000_000)
    return a, b, ica


def ica_recv(chains, a, b, msgs, sequence: int, L) -> tuple:
    """Relay one ICA packet of `msgs` to the host; returns (code, ack)."""
    packet = L.Packet(sequence, OWNER_PORT, "channel-7", L.ICA_HOST_PORT, "channel-7",
                      L.encode_packet_data(msgs))
    res, results = recv(a, packet, L=L)
    return res.code, chains._written_ack(results), packet


def scenarios_ica(chains: ConnectedChains, L=None) -> dict:
    """The ICA host at v2: the inner messages run through the App's own
    handlers (a send and a delegation), a message signed by another
    account and one off the allow list get error acks, and the ack of the
    send is relayed back to the controller."""
    L = L or JAX
    a, b, ica = ica_host(chains, L)
    to = a.keys[0].public_key().address()
    validator = L.StakingKeeper(a.store).validators()[0].address
    code, ack, packet = ica_recv(chains, a, b, [L.MsgSend(ica, to, (L.Coin("utia", 40_000),))],
                                 1, L)
    assert (code, ack) == (0, b'{"result":"AQ=="}')
    b.store.set(L._chan_key(b"commit", OWNER_PORT, "channel-7", 1), packet.commitment())
    res, _ = b.submit(b.relayer, L.MsgAcknowledgement(
        packet.marshal(), b.relayer.public_key().address(), ack))
    assert res.code == 0, res.log
    code, ack, _ = ica_recv(chains, a, b,
                            [L.MsgDelegate(ica, validator, L.Coin("utia", 500_000))], 2, L)
    assert (code, ack) == (0, b'{"result":"AQ=="}')
    code, ack, _ = ica_recv(chains, a, b, [L.MsgSend(to, ica, (L.Coin("utia", 999),))], 3, L)
    assert code == 0 and b"not the interchain account" in ack
    code, ack, _ = ica_recv(chains, a, b, [L.MsgUnjail(ica)], 4, L)
    assert code == 0 and b"not in the ICA allow list" in ack
    return {}


def ica_refused_at_v1(chains: ConnectedChains, L) -> None:
    a, b, ica = ica_host(chains, L)
    msg = L.MsgSend(ica, a.keys[0].public_key().address(), (L.Coin("utia", 1),))
    packet = L.Packet(1, OWNER_PORT, "channel-7", L.ICA_HOST_PORT, "channel-7",
                      L.encode_packet_data([msg]))
    res, _ = recv(a, packet, L=L)
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


SCENARIOS = {"v2": (2, "ConnectedChains", scenarios_v2), "v1": (1, "ConnectedChains", scenarios_v1),
             "ica": (2, "ConnectedChains", scenarios_ica),
             "verified": (2, "VerifiedChains", scenarios_verified)}


@pytest.mark.parametrize("name", ["v1", "v2", "ica", "verified"])
def test_port_harness_drives_both_ends(recorded, name):
    """The port's own harness (testutil/ibc.py, device="cpu") runs the same
    scenario on two port chain ends: at every height each end's app hash
    is the JAX harness's."""
    version, make, scenarios = SCENARIOS[name]
    chains = getattr(PORT, make)(app_version=version, device="cpu")
    scenarios(chains, PORT)
    for label, end in (("alpha", chains.a), ("beta", chains.b)):
        jax_end = recorded[f"{name}_{label}"][0]
        assert end.height == jax_end.height >= 1
        assert [end.app_hash_at(h) for h in range(1, end.height + 1)] == \
            [jax_end.app_hash_at(h) for h in range(1, end.height + 1)], label
    assert (chains.a.channel_id, chains.b.channel_id) == \
        (recorded[f"{name}_alpha"][0].channel_id, recorded[f"{name}_beta"][0].channel_id)
