"""The port's ABCI App on the CPU (`App(device="cpu")`, the plain kernel
versions) against the JAX App, byte for byte: the store and app hash after
`init_chain`, `check_tx` results, `prepare_proposal` BlockData (txs, square
size, data root) for the empty block and blocks of k = 2 to 16 under both
RS constructions, `process_proposal` verdicts on own, non-proposer and
tampered proposals, a state carried across by `convert.app_from_export`
after two JAX blocks, and the golden block's pinned data root (the one
chip_smoke.py's phase_app checks on the card).  Then what only the port
has: `App()` (device None, CUDA) raises without a card, a device fault
raises out of `process_proposal` while a tampered blob still gives False,
and `speculate_proposal` returns False only on a mismatch.

The blocks are signed by the port (testutil.blocks.block_txs); the port's
signatures are the JAX package's (tests/test_torch_crypto.py).  Each block
size compiles the JAX App's programs once, so the sizes are few and small.
"""

from __future__ import annotations

import gc
import os

import jax
import pytest
import torch

import chip_smoke
from celestia_app_tpu.app import App as JaxApp
from celestia_app_tpu.app import BlockData as JaxBlockData
from celestia_app_tpu.testutil import TestNode as JaxTestNode
from celestia_app_tpu.testutil import deterministic_genesis as jax_genesis
from celestia_app_tpu.testutil import funded_keys as jax_keys
from celestia_app_tpu_torch.app import App, BlockData
from celestia_app_tpu_torch.app import app as app_mod
from celestia_app_tpu_torch.convert import app_from_export
from celestia_app_tpu_torch.device import DeviceFault
from celestia_app_tpu_torch.inclusion import batched
from celestia_app_tpu_torch.modules.blob.types import estimate_gas, new_msg_pay_for_blobs
from celestia_app_tpu_torch.shares import Blob
from celestia_app_tpu_torch.testutil import deterministic_genesis, funded_keys
from celestia_app_tpu_torch.testutil.blocks import block_txs
from celestia_app_tpu_torch.tx.envelopes import BlobTx, unmarshal_blob_tx
from celestia_app_tpu_torch.tx.messages import Coin, MsgSend
from celestia_app_tpu_torch.tx.sign import Fee, build_and_sign

GOLDEN_HASH = "8791374a3d404fe00ebe222e097227c221505eaaf67ce4334c7280a00986c643"
GOLDEN = {"n_keys": 4, "seed": 10, "sends": 3, "pfbs": 3, "blob_shares": (1, 4)}


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


def apps(n_keys: int = 4, **genesis_kw) -> tuple[App, JaxApp]:
    port, ref = App(device="cpu"), JaxApp()
    port.init_chain(deterministic_genesis(funded_keys(n_keys), **genesis_kw))
    ref.init_chain(jax_genesis(jax_keys(n_keys), **genesis_kw))
    return port, ref


def fields(data) -> tuple:
    return data.txs, data.square_size, data.hash


def result(r) -> tuple:
    return r.code, r.log, r.gas_wanted, r.gas_used, r.events


def jax_data(data: BlockData) -> JaxBlockData:
    return JaxBlockData(*fields(data))


@pytest.mark.parametrize("kw", [
    {}, {"app_version": 1}, {"gov_max_square_size": 128, "data_commitment_window": 100},
    {"n_validators": 1, "chain_id": "other-chain"},
], ids=["default", "v1", "k128_window", "one_validator"])
def test_init_chain_store_and_app_hash_equal(kw):
    port, ref = apps(**kw)
    assert port.cms.export() == ref.cms.export()
    assert port.cms.last_app_hash == ref.cms.last_app_hash
    assert port.max_effective_square_size() == ref.max_effective_square_size()
    assert (port.gov_max_square_size, port.gas_per_blob_byte) == (
        ref.gov_max_square_size, ref.gas_per_blob_byte)
    assert port.minfee.network_min_gas_price().raw == ref.minfee.network_min_gas_price().raw


def test_golden_block_hash_pinned():
    """The golden block: its data root from the JAX App, pinned, equals the
    port's, and is the root chip_smoke.py holds the card to."""
    port, ref = apps(GOLDEN["n_keys"])
    txs = block_txs(funded_keys(GOLDEN["n_keys"]), port.chain_id, **{
        k: v for k, v in GOLDEN.items() if k != "n_keys"})
    want = ref.prepare_proposal(txs)
    got = port.prepare_proposal(txs)
    assert want.hash.hex() == GOLDEN_HASH
    assert fields(got) == fields(want)
    assert len(got.txs) == len(txs) and got.square_size == 4
    assert chip_smoke.APP_GOLDEN_HASH == GOLDEN_HASH
    assert chip_smoke.APP_GOLDEN == GOLDEN


def _tampered_blob(data: BlockData) -> BlockData:
    i = next(i for i, t in enumerate(data.txs) if unmarshal_blob_tx(t) is not None)
    btx = unmarshal_blob_tx(data.txs[i])
    b = btx.blobs[0]
    evil = BlobTx(btx.tx, (Blob(b.namespace, b.data[:-1] + bytes([b.data[-1] ^ 0x99])),)
                  + tuple(btx.blobs[1:])).marshal()
    return BlockData(data.txs[:i] + (evil,) + data.txs[i + 1:], data.square_size, data.hash)


def _proposals(port: App, data: BlockData) -> dict:
    keys = funded_keys(4)
    mallory = type(keys[0]).from_seed(b"mallory")
    addr = mallory.public_key().address()
    unsigned = build_and_sign([MsgSend(addr, addr, (Coin("utia", 1),))], mallory,
                              port.chain_id, 99, 0, Fee((Coin("utia", 9000),), 90_000))
    bare_pfb = unmarshal_blob_tx(next(t for t in data.txs if unmarshal_blob_tx(t))).tx
    return {
        "honest": data,
        "tampered_blob": _tampered_blob(data),
        "wrong_hash": BlockData(data.txs, data.square_size, bytes(32)),
        "wrong_square_size": BlockData(data.txs, data.square_size * 2, data.hash),
        "unsigned_injected_tx": BlockData((unsigned,) + data.txs, data.square_size, data.hash),
        "pfb_outside_blob_tx": BlockData((bare_pfb,) + data.txs, data.square_size, data.hash),
        "garbage_tx": BlockData((b"\x0a\x03abc",) + data.txs, data.square_size, data.hash),
        "dropped_tx": BlockData(data.txs[1:], data.square_size, data.hash),
    }


# (n_keys, block_txs arguments, RS construction): k = 2, 4, 8, 16, two under
# each construction (each k compiles the JAX App's programs once; the chain
# of test_app_from_export reuses k = 2 and 4), and the empty block.
BLOCKS = {
    "empty": (4, {"seed": 1, "sends": 0, "pfbs": 0}, "vandermonde"),
    "k2_vandermonde": (4, {"seed": 2, "sends": 2, "pfbs": 1, "blob_shares": (1, 1)},
                       "vandermonde"),
    "k4_golden": (4, {k: v for k, v in GOLDEN.items() if k != "n_keys"}, "vandermonde"),
    "k8_leopard": (8, {"seed": 8, "sends": 4, "pfbs": 8, "blob_shares": (2, 6)}, "leopard"),
    "k16_leopard": (8, {"seed": 16, "sends": 4, "pfbs": 16, "blob_shares": (6, 14)}, "leopard"),
}
WANT_K = {"empty": 1, "k2_vandermonde": 2, "k4_golden": 4, "k8_leopard": 8, "k16_leopard": 16}


@pytest.fixture(scope="module")
def proposals():
    """name -> (the port's BlockData, JAX's, txs, construction), each
    prepared by a fresh pair of apps."""
    out = {}
    old = os.environ.get("CELESTIA_RS_CONSTRUCTION")
    try:
        for name, (n_keys, kw, construction) in BLOCKS.items():
            os.environ["CELESTIA_RS_CONSTRUCTION"] = construction
            port, ref = apps(n_keys)
            txs = block_txs(funded_keys(n_keys), port.chain_id, **kw)
            out[name] = (port.prepare_proposal(txs), ref.prepare_proposal(txs), txs,
                         construction)
    finally:
        if old is None:
            os.environ.pop("CELESTIA_RS_CONSTRUCTION", None)
        else:
            os.environ["CELESTIA_RS_CONSTRUCTION"] = old
    return out


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_prepare_proposal_block_data_equal(proposals, name):
    got, want, txs, _ = proposals[name]
    assert fields(got) == fields(want)
    assert got.square_size == WANT_K[name]
    assert len(got.txs) == len(txs)


@pytest.mark.parametrize("case", ["honest", "tampered_blob", "wrong_hash", "wrong_square_size",
                                  "unsigned_injected_tx", "pfb_outside_blob_tx", "garbage_tx",
                                  "dropped_tx"])
@pytest.mark.parametrize("who", ["proposer", "non_proposer"])
def test_process_proposal_verdicts_equal(proposals, monkeypatch, case, who):
    name = "k4_golden"
    data, _, txs, construction = proposals[name]
    monkeypatch.setenv("CELESTIA_RS_CONSTRUCTION", construction)
    port, ref = apps(BLOCKS[name][0])
    if who == "proposer":
        assert fields(port.prepare_proposal(txs)) == fields(ref.prepare_proposal(txs))
    proposal = _proposals(port, data)[case]
    got = port.process_proposal(proposal)
    assert got == ref.process_proposal(jax_data(proposal))
    assert got is (case == "honest")


@pytest.mark.parametrize("name", ["k2_vandermonde", "k8_leopard", "k16_leopard", "empty"])
def test_non_proposer_accepts_every_block(proposals, monkeypatch, name):
    data, _, _, construction = proposals[name]
    monkeypatch.setenv("CELESTIA_RS_CONSTRUCTION", construction)
    port, ref = apps(BLOCKS[name][0])
    assert port.process_proposal(data) is True
    assert ref.process_proposal(jax_data(data)) is True


def _check_txs(keys, chain_id) -> dict:
    """name -> raw tx, the CheckTx cases of tests/test_app.py and more."""
    base = block_txs(keys, chain_id, seed=4, sends=1, pfbs=1, blob_shares=(2, 2))
    send, pfb = base
    addr, to = keys[0].public_key().address(), keys[1].public_key().address()
    msg = MsgSend(addr, to, (Coin("utia", 1),))
    btx = unmarshal_blob_tx(pfb)
    low_fee = build_and_sign(
        [MsgSend(addr, to, (Coin("utia", 1),))], keys[0], chain_id, 0, 0,
        Fee((Coin("utia", 1),), 100_000))
    def pfb_tx(size: int, gas: int, fee: int) -> bytes:
        blob = Blob(btx.blobs[0].namespace, bytes(range(256)) * (size // 256))
        msg = new_msg_pay_for_blobs(addr, [blob])
        return BlobTx(build_and_sign([msg], keys[0], chain_id, 0, 0,
                                     Fee((Coin("utia", fee),), gas)), (blob,)).marshal()

    return {
        "send": send,
        "pfb": pfb,
        "bad_sequence": build_and_sign([msg], keys[0], chain_id, 0, 5,
                                       Fee((Coin("utia", 20_000),), 100_000)),
        "fee_below_node_minimum": low_fee,
        "pfb_zero_fee": pfb_tx(512, estimate_gas([512]), 0),
        "insufficient_pfb_gas": pfb_tx(100_096, 80_000, 80_000),
        "tampered_blob": BlobTx(btx.tx, (Blob(btx.blobs[0].namespace,
                                              btx.blobs[0].data[:-1] + b"\x00"),)).marshal(),
        "blob_count_mismatch": BlobTx(btx.tx, btx.blobs + btx.blobs).marshal(),
        "garbage": b"\x0a\x03abc",
    }


def test_check_tx_results_equal():
    port, ref = apps(4)
    cases = _check_txs(funded_keys(4), port.chain_id)
    got = {name: result(port.check_tx(raw)) for name, raw in cases.items()}
    want = {name: result(ref.check_tx(raw)) for name, raw in cases.items()}
    assert got == want
    assert {n for n, r in got.items() if r[0] == 0} == {"send", "pfb"}
    # The same bytes again: the check state advanced the sequences.
    assert result(port.check_tx(cases["send"])) == result(ref.check_tx(cases["send"]))
    assert port.check_tx(cases["send"]).code != 0


def test_app_from_export_carries_a_jax_chain_across():
    """Two JAX blocks (sequences advanced, fees paid, a blob), then both apps
    go on from the exported state: CheckTx, Prepare and Process agree."""
    n = 4
    node = JaxTestNode(jax_genesis(jax_keys(n)), jax_keys(n))
    keys = funded_keys(n)
    first = block_txs(keys, node.chain_id, seed=41, sends=3, pfbs=2, blob_shares=(1, 3))
    for raws in (first[:3], first[3:]):
        for raw in raws:
            assert node.broadcast(raw).code == 0
        node.produce_block()
    jax_app = node.app
    assert jax_app.height == 2
    port = app_from_export(
        jax_app.cms.export(), chain_id=jax_app.chain_id, app_version=jax_app.app_version,
        height=jax_app.height, genesis_time_ns=jax_app.genesis_time_ns,
        last_block_time_ns=jax_app.last_block_time_ns, device="cpu")
    assert port.cms.last_app_hash == jax_app.cms.last_app_hash
    assert port.cms.working.snapshot() == jax_app.cms.working.snapshot()
    sequences = [2, 1, 1, 1]  # signers take turns: 0, 1, 2 sent, then 3 and 0 paid blobs
    txs = block_txs(keys, node.chain_id, seed=42, sends=2, pfbs=2, blob_shares=(1, 3),
                    sequences=sequences)
    stale = block_txs(keys, node.chain_id, seed=43, sends=1, pfbs=0)  # sequence 0 again
    for raw in txs + stale:
        assert result(port.check_tx(raw)) == result(jax_app.check_tx(raw))
    got = port.prepare_proposal(txs + stale)
    want = jax_app.prepare_proposal(txs + stale)
    assert fields(got) == fields(want)
    assert len(got.txs) == len(txs)
    assert port.process_proposal(got) is jax_app.process_proposal(want) is True


def test_app_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: App() runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        App()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app_from_export({}, chain_id="c", app_version=2, height=1, genesis_time_ns=0,
                        last_block_time_ns=0)


def test_device_fault_raises_while_a_tampered_blob_is_rejected(proposals, monkeypatch):
    data, _, _, construction = proposals["k4_golden"]
    monkeypatch.setenv("CELESTIA_RS_CONSTRUCTION", construction)
    port, _ = apps(4)
    assert port.process_proposal(_tampered_blob(data)) is False

    def fault(*args, **kwargs):
        raise RuntimeError("injected device fault")

    with monkeypatch.context() as m:  # in the commitments
        batched._COMMIT_MEMO.clear()
        m.setattr(batched, "tree_roots", fault)
        with pytest.raises(DeviceFault, match="blob share commitments") as info:
            port.process_proposal(data)
        assert "injected device fault" in repr(info.value.__cause__)
    with monkeypatch.context() as m:  # in the extend, the commitments memoized
        port = apps(4)[0]
        batched.create_commitments_batched(
            [b for t in data.txs if (btx := unmarshal_blob_tx(t)) for b in btx.blobs],
            device="cpu")
        m.setattr(app_mod, "extend_shares", fault)
        with pytest.raises(DeviceFault, match="extend"):
            port.process_proposal(data)
    assert port.process_proposal(data) is True  # nothing was memoized by the fault


def test_speculate_proposal(proposals, monkeypatch):
    from celestia_app_tpu_torch.da.eds import speculator

    data, _, _, construction = proposals["k4_golden"]
    monkeypatch.setenv("CELESTIA_RS_CONSTRUCTION", construction)
    port, ref = apps(4)
    assert port.speculate_proposal(data) is False  # the seam is off by default
    monkeypatch.setenv("CELESTIA_PIPE_SPECULATE", "on")
    mismatched = {
        "size": BlockData(data.txs, 8, data.hash),
        "empty": BlockData((), 1, data.hash),
        "overflow": BlockData(data.txs, 4, data.hash),
    }
    port.square_size_upper_bound = ref.square_size_upper_bound = 2  # the square cannot build
    assert port.speculate_proposal(mismatched["overflow"]) is False
    assert ref.speculate_proposal(jax_data(mismatched["overflow"])) is False
    port.square_size_upper_bound = ref.square_size_upper_bound = 128
    for proposal in (mismatched["size"], mismatched["empty"]):
        assert port.speculate_proposal(proposal) is False
        assert ref.speculate_proposal(jax_data(proposal)) is False
    hits = speculator().outcomes["hit"]
    assert port.speculate_proposal(data, height=1) is True
    assert port.process_proposal(data) is True
    assert speculator().outcomes["hit"] == hits + 1
    monkeypatch.setattr(app_mod, "speculator", lambda: (_ for _ in ()).throw(
        RuntimeError("injected dispatch fault")))
    with pytest.raises(DeviceFault, match="speculative extend"):
        port.speculate_proposal(data)
