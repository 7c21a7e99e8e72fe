"""The port's tx layer and ante chain on the CPU, against the JAX package:
every message type of tx/messages.py signed by the JAX `build_and_sign`
(and a multisig tx) decodes, re-encodes and verifies the same in the port
(`Tx.unmarshal` / `marshal`, `sign_doc_bytes`, `decode_msg`,
`validate_basic`), and `run_ante` gives the same result (priority, gas
wanted and consumed, signer, or the error's class and message) and leaves
the same state on a branched store for the cases of
tests/test_ante_parity.py, in CheckTx and in DeliverTx mode.  No JAX
program runs here: the ante chain is host code in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import celestia_app_tpu.app as jax_app_pkg
from celestia_app_tpu.app import gas as jax_gas
from celestia_app_tpu.app.app import Ctx as JaxCtx
from celestia_app_tpu.crypto import PrivateKey as JaxKey
from celestia_app_tpu.modules.ibc import core as jax_ibc
from celestia_app_tpu.state.store import KVStore as JaxKVStore
from celestia_app_tpu.testutil import deterministic_genesis as jax_genesis
from celestia_app_tpu.tx import messages as jax_messages
from celestia_app_tpu.tx import multisig as jax_multisig
from celestia_app_tpu.tx import sign as jax_sign
import celestia_app_tpu_torch.app as port_app_pkg
from celestia_app_tpu_torch.app import gas as port_gas
from celestia_app_tpu_torch.app.app import Ctx as PortCtx
from celestia_app_tpu_torch.crypto import PrivateKey
from celestia_app_tpu_torch.modules.blob.types import estimate_gas, new_msg_pay_for_blobs
from celestia_app_tpu_torch.modules.ibc import core as port_ibc
from celestia_app_tpu_torch.shares import Blob, Namespace
from celestia_app_tpu_torch.state.store import KVStore as PortKVStore
from celestia_app_tpu_torch.testutil import deterministic_genesis, funded_keys
from celestia_app_tpu_torch.tx import messages as port_messages
from celestia_app_tpu_torch.tx import multisig as port_multisig
from celestia_app_tpu_torch.tx import sign as port_sign

CHAIN = "tpu-test-chain"
SEEDS = [f"account-{i}".encode() for i in range(4)]


def sample_msgs(m, ibc, addrs: list[str], pubkey: bytes) -> dict:
    """One message of every type registered in `m.MSG_DECODERS`, built from
    the module `m` (either package's tx/messages.py) with plausible fields."""
    a0, a1, a2 = addrs[:3]
    coins = (m.Coin("utia", 7),)
    packet = ibc.Packet(3, "transfer", "channel-0", "transfer", "channel-1",
                        b'{"amount":"5","denom":"utia"}', ibc.Height(1, 90), 10**18).marshal()
    proposal = m.MsgSubmitProposal("title", "desc", (m.ProposalParamChange(
        "blob", "GasPerBlobByte", '"10"'),), (m.Coin("utia", 10**10),), a0)
    half = "0.500000000000000000"
    msgs = [
        m.MsgCreateValidator("val", "0.100000000000000000", a0, a0, pubkey, m.Coin("utia", 1000)),
        m.MsgEditValidator("val2", a0, "0.200000000000000000"),
        m.MsgGrantAllowance(a0, a1, 100, 10**18, (m.URL_MSG_SEND,)),
        m.MsgRevokeAllowance(a0, a1),
        m.MsgAuthzGrant(a0, a1, m.URL_MSG_SEND, 50, 0),
        m.MsgAuthzExec(a1, (m.MsgSend(a0, a2, coins).to_any(),)),
        m.MsgAuthzRevoke(a0, a1, m.URL_MSG_SEND),
        m.MsgUnjail(a0),
        m.MsgWithdrawDelegatorReward(a0, a1),
        m.MsgWithdrawValidatorCommission(a0),
        m.MsgSetWithdrawAddress(a0, a1),
        m.MsgFundCommunityPool(coins, a0),
        m.MsgDelegate(a0, a1, m.Coin("utia", 10)),
        m.MsgUndelegate(a0, a1, m.Coin("utia", 10)),
        m.MsgBeginRedelegate(a0, a1, m.Coin("utia", 10), a2),
        m.MsgCancelUnbondingDelegation(a0, a1, m.Coin("utia", 5), 3),
        m.MsgPayForBlobs(a0, (bytes(18) + bytes(range(1, 12)),), (100,), (bytes(range(32)),), (0,)),
        m.MsgSend(a0, a1, coins),
        m.MsgMultiSend((m.BankIO(a0, (m.Coin("utia", 14),)),),
                       (m.BankIO(a1, coins), m.BankIO(a2, coins))),
        m.MsgCreateVestingAccount(a0, a1, coins, 2 * 10**9, True),
        m.MsgCreatePeriodicVestingAccount(a0, a1, 10**9, (m.VestingPeriod(60, coins),
                                                          m.VestingPeriod(120, coins))),
        m.MsgCreatePermanentLockedAccount(a0, a1, coins),
        m.MsgVerifyInvariant(a0, "bank", "total-supply"),
        m.MsgSubmitEvidence(a0, m.Any("/cosmos.evidence.v1beta1.Equivocation", b"\x08\x01")),
        m.MsgSignalVersion(a0, 3),
        m.MsgTryUpgrade(a0),
        proposal,
        m.MsgVote(1, a0, 1),
        m.MsgVoteWeighted(1, a0, ((1, half), (3, half))),
        m.MsgDeposit(1, a0, coins),
        m.MsgSubmitProposalV1((m.MsgExecLegacyContent(
            proposal._content(), m.gov_module_address()).to_any(),), coins, a0, "meta"),
        m.MsgVoteV1(1, a0, 1, "meta"),
        m.MsgVoteWeightedV1(1, a0, ((1, half), (2, half)), "meta"),
        m.MsgDepositV1(1, a0, coins),
        m.MsgTransfer("transfer", "channel-0", m.Coin("utia", 5), a0, a1, 1, 100, 0, "memo"),
        m.MsgRecvPacket(packet, a0, proof_height=5, proof=b"\x01\x02"),
        m.MsgAcknowledgement(packet, a0, acknowledgement=b'{"result":"AQ=="}'),
        m.MsgTimeout(packet, a0, proof_height=7),
    ]
    return {type(msg).TYPE_URL: msg for msg in msgs}


def _keys():
    return [JaxKey.from_seed(s) for s in SEEDS]


def _addrs():
    return [k.public_key().address() for k in _keys()]


def test_every_type_url_is_registered_in_the_port():
    assert set(port_messages.MSG_DECODERS) == set(jax_messages.MSG_DECODERS)
    assert set(sample_msgs(jax_messages, jax_ibc, _addrs(), bytes(33))) == set(
        jax_messages.MSG_DECODERS)


def _validate(msg) -> str:
    vb = getattr(msg, "validate_basic", None)
    if vb is None:
        return "none"
    try:
        vb()
    except ValueError as e:
        return f"{type(e).__name__}: {e}"
    return "ok"


@pytest.mark.parametrize("url", sorted(jax_messages.MSG_DECODERS))
def test_tx_of_each_message_type_decodes_as_in_jax(url):
    keys, addrs = _keys(), _addrs()
    jmsg = sample_msgs(jax_messages, jax_ibc, addrs, keys[0].public_key().bytes)[url]
    pmsg = sample_msgs(port_messages, port_ibc, addrs, keys[0].public_key().bytes)[url]
    assert pmsg.to_any().marshal() == jmsg.to_any().marshal()
    fee = jax_sign.Fee((jax_messages.Coin("utia", 2000),), 200_000)
    raw = jax_sign.build_and_sign([jmsg], keys[0], CHAIN, 0, 3, fee, memo="m", timeout_height=9)
    tx = port_sign.Tx.unmarshal(raw)
    assert tx.marshal() == raw
    jtx = jax_sign.Tx.unmarshal(raw)
    assert port_sign.sign_doc_bytes(tx.body_bytes, tx.auth_info_bytes, CHAIN, 0) == \
        jax_sign.sign_doc_bytes(jtx.body_bytes, jtx.auth_info_bytes, CHAIN, 0)
    assert tx.body.marshal() == jtx.body.marshal()
    assert tx.auth_info.marshal() == jtx.auth_info.marshal()
    (decoded,) = tx.msgs()
    (jdecoded,) = jtx.msgs()
    assert type(decoded).__name__ == type(jdecoded).__name__
    assert decoded.to_any().marshal() == jdecoded.to_any().marshal()
    assert _validate(decoded) == _validate(jdecoded)
    assert tx.verify_signature(CHAIN, 0) and jtx.verify_signature(CHAIN, 0)
    assert not tx.verify_signature(CHAIN, 1)


def test_multisig_tx_decodes_and_verifies_as_in_jax():
    keys = _keys()
    jpk = jax_multisig.MultisigPubKey(2, tuple(k.public_key() for k in keys[:3]))
    msg = jax_messages.MsgSend(jpk.address(), _addrs()[3], (jax_messages.Coin("utia", 9),))
    fee = jax_sign.Fee((jax_messages.Coin("utia", 2000),), 200_000)
    raw = jax_sign.build_and_sign_multisig([msg], jpk, {0: keys[0], 2: keys[2]}, CHAIN, 4, 0, fee)
    tx = port_sign.Tx.unmarshal(raw)
    assert tx.marshal() == raw
    (info,) = tx.auth_info.signer_infos
    assert isinstance(info.public_key, port_multisig.MultisigPubKey)
    assert info.public_key.address() == jpk.address()
    assert info.public_key.value_bytes() == jpk.value_bytes()
    assert info.mode_bits == (True, False, True)
    assert tx.verify_signature(CHAIN, 4)
    assert not tx.verify_signature(CHAIN, 5)
    port_keys = [PrivateKey.from_seed(s) for s in SEEDS]
    ppk = port_multisig.MultisigPubKey(2, tuple(k.public_key() for k in port_keys[:3]))
    pmsg = port_messages.MsgSend(ppk.address(), _addrs()[3], (port_messages.Coin("utia", 9),))
    again = port_sign.build_and_sign_multisig(
        [pmsg], ppk, {0: port_keys[0], 2: port_keys[2]}, CHAIN, 4, 0,
        port_sign.Fee((port_messages.Coin("utia", 2000),), 200_000))
    assert again == raw


def test_gas_store_schedule_equal():
    """The gaskv schedule charges the same gas for the same accesses."""
    def drive(gas, store):
        meter = gas.GasMeter(None)
        gs = gas.GasKVStore(store, meter)
        gs.set(b"key1", b"value-bytes")
        gs.get(b"key1")
        gs.get(b"missing")
        gs.has(b"key1")
        gs.iterate(b"key")
        gs.delete(b"key1")
        return meter.consumed
    assert drive(port_gas, PortKVStore()) == drive(jax_gas, JaxKVStore())
    for name in ("TX_SIZE_COST_PER_BYTE", "SIG_VERIFY_COST_SECP256K1", "MAX_MEMO_CHARACTERS",
                 "TX_SIG_LIMIT"):
        assert getattr(port_gas, name) == getattr(jax_gas, name)


# --- run_ante parity ---------------------------------------------------------

FEE = (20_000, 100_000)  # utia, gas


def _genesis_variants(keys):
    """name -> (port genesis, JAX genesis) for the ante cases' chains."""
    jkeys = _keys()
    multisig = port_multisig.MultisigPubKey(2, tuple(k.public_key() for k in keys[:3]))
    out = {}
    for name, kw in {"v2": {}, "v1": {"app_version": 1},
                     "v1_small": {"app_version": 1, "gov_max_square_size": 4},
                     "v2_small": {"gov_max_square_size": 4}}.items():
        out[name] = (deterministic_genesis(keys, **kw), jax_genesis(jkeys, **kw))
    port, ref = out["v2"]
    out["no_pubkeys"] = tuple(dataclasses.replace(
        g, accounts=tuple(dataclasses.replace(a, pubkey=b"") for a in g.accounts))
        for g in (port, ref))
    out["multisig"] = (
        dataclasses.replace(port, accounts=port.accounts + (
            port_app_pkg.GenesisAccount(multisig.address(), 10**9),)),
        dataclasses.replace(ref, accounts=ref.accounts + (
            jax_app_pkg.GenesisAccount(multisig.address(), 10**9),)))
    return out


@pytest.fixture(scope="module")
def chains():
    """name -> (port App, JAX App) at genesis (apps on the CPU; nothing here
    reaches the device)."""
    keys = funded_keys(4)
    apps = {}
    for name, (pg, jg) in _genesis_variants(keys).items():
        port, ref = port_app_pkg.App(device="cpu"), jax_app_pkg.App()
        port.init_chain(pg)
        ref.init_chain(jg)
        apps[name] = (port, ref)
    return keys, apps


def _signed(keys, body, fee=FEE, seq=0, signer=0, sign_with=None, infos=None):
    key = keys[signer]
    auth = port_sign.AuthInfo(infos or (port_sign.SignerInfo(key.public_key(), seq),),
                              port_sign.Fee((port_messages.Coin("utia", fee[0]),) if fee[0]
                                            else (), fee[1]))
    body_bytes, auth_bytes = body.marshal(), auth.marshal()
    doc = port_sign.sign_doc_bytes(body_bytes, auth_bytes, CHAIN, signer)
    sigs = tuple(k.sign(doc) for k in (sign_with or [key]))
    return port_sign.Tx(body_bytes, auth_bytes, sigs).marshal()


def _send(keys, amount=5, **kw):
    a = [k.public_key().address() for k in keys]
    return port_sign.TxBody((port_messages.MsgSend(a[0], a[1], (
        port_messages.Coin("utia", amount),)).to_any(),), **kw)


def _pfb(keys, size, gas=None, fee=None):
    blob = Blob(Namespace.v0(bytes([7]) * 10), bytes(np.random.default_rng(size).bytes(size)))
    msg = new_msg_pay_for_blobs(keys[0].public_key().address(), [blob])
    g = gas or estimate_gas([size])
    return _signed(keys, port_sign.TxBody((msg.to_any(),)), fee=(fee or g, g))


def _relay(keys, cls):
    packet = port_ibc.Packet(1, "transfer", "channel-0", "transfer", "channel-1", b"{}")
    msg = cls(packet.marshal(), keys[0].public_key().address(), proof_height=3)
    return _signed(keys, port_sign.TxBody((msg.to_any(),)))


def _multisig(keys):
    pk = port_multisig.MultisigPubKey(2, tuple(k.public_key() for k in keys[:3]))
    msg = port_messages.MsgSend(pk.address(), keys[3].public_key().address(),
                                (port_messages.Coin("utia", 3),))
    return port_sign.build_and_sign_multisig(
        [msg], pk, {0: keys[0], 1: keys[1]}, CHAIN, 4, 0,
        port_sign.Fee((port_messages.Coin("utia", 20_000),), 100_000))


def _ante_cases(keys):
    """name -> (chain, height, raw tx)."""
    a = [k.public_key().address() for k in keys]
    m = port_messages
    bad_addr = port_sign.TxBody((m.MsgSend(a[0], "not-an-address", (m.Coin("utia", 5),)).to_any(),))
    zero = _send(keys, amount=0)
    probe = _signed(keys, _send(keys))
    sig_gas_limit = (len(probe) * port_gas.TX_SIZE_COST_PER_BYTE
                     + port_gas.SIG_VERIFY_COST_SECP256K1 - 1)
    empty_proposal = port_sign.TxBody((m.MsgSubmitProposal(
        "t", "d", (), (m.Coin("utia", 100),), a[0]).to_any(),))
    return {
        "send": ("v2", 1, _signed(keys, _send(keys))),
        "send_below_node_min_price": ("v2", 1, _signed(keys, _send(keys), fee=(1, 100_000))),
        "version_gate": ("v1", 1, _signed(keys, port_sign.TxBody(
            (m.MsgSignalVersion(a[0], 2).to_any(),)))),
        "out_of_gas": ("v2", 1, _signed(keys, _send(keys), fee=(20_000, 60))),
        "extension_options": ("v2", 1, _signed(keys, _send(
            keys, extension_options=(m.Any("/test.Ext", b"x"),)))),
        "non_critical_extension": ("v2", 1, _signed(keys, _send(
            keys, non_critical_extension_options=(m.Any("/test.Nce", b"x"),)))),
        "validate_basic_address": ("v2", 1, _signed(keys, bad_addr)),
        "validate_basic_zero": ("v2", 1, _signed(keys, zero)),
        "timeout_height": ("v2", 3, _signed(keys, _send(keys, timeout_height=1))),
        "memo_too_long": ("v2", 1, _signed(keys, _send(keys, memo="m" * 257))),
        "zero_fee": ("v2", 1, _signed(keys, _send(keys), fee=(0, 100_000))),
        "fee_before_sig": ("v2", 1, _signed(keys, _send(keys), fee=(10**18, 100_000), seq=5)),
        "pubkey_set_on_first_use": ("no_pubkeys", 1, _signed(keys, _send(keys))),
        "two_signers": ("v2", 1, _signed(keys, _send(keys), sign_with=keys[:2], infos=(
            port_sign.SignerInfo(keys[0].public_key(), 0),
            port_sign.SignerInfo(keys[1].public_key(), 0)))),
        "sig_gas": ("v2", 1, _signed(keys, _send(keys), fee=(20_000, sig_gas_limit))),
        "bad_signature": ("v2", 1, _signed(keys, _send(keys), sign_with=[keys[1]])),
        "sequence_mismatch": ("v2", 1, _signed(keys, _send(keys), seq=3)),
        "pfb": ("v2", 1, _pfb(keys, 2000)),
        "pfb_gas_below_blob_gas": ("v2", 1, _pfb(keys, 5000, gas=30_000, fee=30_000)),
        "v1_total_blob_size": ("v1_small", 1, _pfb(keys, 60_000)),
        "v2_blob_shares": ("v2_small", 1, _pfb(keys, 60_000)),
        "empty_proposal": ("v2", 1, _signed(keys, empty_proposal)),
        "fee_granter_without_grant": ("v2", 1, _granted(keys)),
        "fee_payer_not_signer": ("v2", 1, _payer(keys)),
        "recv_packet": ("v2", 1, _relay(keys, m.MsgRecvPacket)),
        "redundant_timeout": ("v2", 1, _relay(keys, m.MsgTimeout)),
        "multisig_send": ("multisig", 1, _multisig(keys)),
        "garbage": ("v2", 1, b"\x0a\x03abc"),
    }


def _granted(keys):
    fee = port_sign.Fee((port_messages.Coin("utia", 20_000),), 100_000,
                        granter=keys[2].public_key().address())
    return port_sign.build_and_sign([port_messages.MsgSend(
        keys[0].public_key().address(), keys[1].public_key().address(),
        (port_messages.Coin("utia", 5),))], keys[0], CHAIN, 0, 0, fee)


def _payer(keys):
    fee = port_sign.Fee((port_messages.Coin("utia", 20_000),), 100_000,
                        payer=keys[3].public_key().address())
    return port_sign.build_and_sign([port_messages.MsgSend(
        keys[0].public_key().address(), keys[1].public_key().address(),
        (port_messages.Coin("utia", 5),))], keys[0], CHAIN, 0, 0, fee)


def _outcome(pkg_tx, ctx_cls, ante, app, raw: bytes, height: int, check: bool):
    ctx = ctx_cls(app.cms.working.branch(), height, app.last_block_time_ns, app.app_version)
    try:
        res = ante(app, ctx, pkg_tx.unmarshal(raw), is_check_tx=check, tx_bytes=raw)
        got = ("ok", res.priority, res.gas_wanted, res.gas_consumed, res.signer)
    except Exception as e:  # the class and message are what is compared
        got = (type(e).__name__, str(e))
    return got, sorted(ctx.store.snapshot().items())


ANTE_CASES = sorted(_ante_cases(funded_keys(4)))


@pytest.mark.parametrize("check", [True, False], ids=["check_tx", "deliver"])
@pytest.mark.parametrize("name", ANTE_CASES)
def test_run_ante_equals_jax(chains, name, check):
    keys, apps = chains
    chain, height, raw = _ante_cases(keys)[name]
    port, ref = apps[chain]
    got = _outcome(port_sign.Tx, PortCtx, port_app_pkg.run_ante, port, raw, height, check)
    want = _outcome(jax_sign.Tx, JaxCtx, jax_app_pkg.run_ante, ref, raw, height, check)
    assert got == want


def test_ante_cases_cover_acceptance_and_rejection(chains):
    keys, apps = chains
    results = {}
    for name, (chain, height, raw) in _ante_cases(keys).items():
        port = apps[chain][0]
        results[name] = _outcome(port_sign.Tx, PortCtx, port_app_pkg.run_ante, port, raw,
                                 height, True)[0][0]
    accepted = {n for n, r in results.items() if r == "ok"}
    assert accepted == {"send", "non_critical_extension", "pubkey_set_on_first_use", "pfb",
                        "recv_packet", "multisig_send"}, results
