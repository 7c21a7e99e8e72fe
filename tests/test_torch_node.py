"""The port's in-process node on the CPU against the JAX package's: a JAX
`TestNode` and a port `TestNode(device="cpu")` on the same genesis take the
same `TxClient` submissions (fee retry and sequence resync included), the
same seeded `txsim.run`, and a recheck that evicts; their BlockData,
TxResults, app hashes, pools and tx indexes are equal.  The same holds for
`Network(3)`.  Then what only the port has: `TestNode()` and `Network()`
(device None, CUDA) raise without a card, and a `DeviceFault` is never read
as a rejected or evicted tx (in `broadcast`, in the post-commit recheck,
in `TxClient`'s retry loop and in txsim).

The squares stay at k <= 4, so the JAX App compiles few programs.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import sys
import threading

import jax
import numpy as np
import pytest

import chip_smoke
from celestia_app_tpu.mempool import PriorityMempool as JaxMempool
from celestia_app_tpu.shares.namespace import Namespace as JaxNamespace
from celestia_app_tpu.shares.sparse import Blob as JaxBlob
from celestia_app_tpu.state.dec import Dec as JaxDec
from celestia_app_tpu.testutil import TestNode as JaxTestNode
from celestia_app_tpu.testutil import deterministic_genesis as jax_genesis
from celestia_app_tpu.testutil import funded_keys as jax_keys
from celestia_app_tpu.testutil.network import Network as JaxNetwork
from celestia_app_tpu.tx.messages import Coin as JaxCoin
from celestia_app_tpu.tx.messages import MsgSend as JaxMsgSend
from celestia_app_tpu.user import TxClient as JaxTxClient
from celestia_app_tpu_torch.crypto import PrivateKey
from celestia_app_tpu_torch.device import DeviceFault
from celestia_app_tpu_torch.inclusion import batched
from celestia_app_tpu_torch.shares import Blob, Namespace
from celestia_app_tpu_torch.state.dec import Dec
from celestia_app_tpu_torch.testutil import TestNode, deterministic_genesis, funded_keys
from celestia_app_tpu_torch.testutil.blocks import block_txs
from celestia_app_tpu_torch.testutil.network import ConsensusFailure, Network
from celestia_app_tpu_torch.tx.messages import Coin, MsgSend
from celestia_app_tpu_torch.tx.sign import Fee, build_and_sign
from celestia_app_tpu_torch.user import TxClient

jax_txsim = importlib.import_module("celestia_app_tpu.txsim.run")
port_txsim = importlib.import_module("celestia_app_tpu_torch.txsim.run")


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


def fields(data) -> tuple:
    return data.txs, data.square_size, data.hash


def recorded(node):
    """Wrap the node's produce_block to keep each height's BlockData,
    TxResults and app hash."""
    heights = []
    inner = node.produce_block

    def produce_block(*args, **kwargs):
        data, results = inner(*args, **kwargs)
        app = node.app if hasattr(node, "app") else node
        heights.append((fields(data), [result(r) for r in results], app.cms.last_app_hash))
        return data, results

    node.produce_block = produce_block
    return heights


def nodes(n_keys: int = 4, **genesis_kw):
    jk, pk = jax_keys(n_keys), funded_keys(n_keys)
    ref = JaxTestNode(jax_genesis(jk, **genesis_kw), jk)
    port = TestNode(deterministic_genesis(pk, **genesis_kw), pk, device="cpu")
    return ref, port


def test_txsim_golden_equal_and_pinned():
    ref, port = nodes(chip_smoke.NODE_GOLDEN["n_keys"])
    got = []
    for node, txsim in ((ref, jax_txsim), (port, port_txsim)):
        heights = recorded(node)
        stats = chip_smoke.node_golden_run(node, node.keys, txsim)
        got.append((stats, heights, node.app.cms.last_app_hash.hex(),
                    chip_smoke.index_digest(node.tx_index), node.tx_index))
    assert got[0] == got[1]
    stats, heights, app_hash, digest, index = got[1]
    assert stats == {"submitted": 12, "failed": 0, "blocks": 4}
    assert app_hash == chip_smoke.NODE_GOLDEN_APP_HASH
    assert digest == chip_smoke.NODE_GOLDEN_INDEX
    assert len(index) == 12 and all(code == 0 for _, code, _ in index.values())


def _blob(pkg, tag: int, size: int, seed: int):
    ns_cls, blob_cls = pkg
    data = np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()
    return blob_cls(ns_cls.v0(bytes([tag]) * 10), data)


def test_tx_client_submissions_equal():
    """PFBs and sends through TxClient, a fee rejection the client parses
    and retries at the node's price, a nonce mismatch it resyncs."""
    ref, port = nodes(4)
    legs = []
    for node, client_cls, pkg, send, dec in (
        (ref, JaxTxClient, (JaxNamespace, JaxBlob), (JaxMsgSend, JaxCoin), JaxDec),
        (port, TxClient, (Namespace, Blob), (MsgSend, Coin), Dec),
    ):
        heights = recorded(node)
        client = client_cls(node, node.keys[:3])
        assert client.simulate_gas([]) is None  # the in-process node has no Simulate
        responses = [client.submit_pay_for_blob([_blob(pkg, 8, 3000, 1)])]
        to = node.keys[1].public_key().address()
        responses.append(client.submit_tx([send[0](client.default_address, to,
                                                    (send[1]("utia", 123),))]))
        node.app.node_min_gas_price = dec.from_str("0.02")  # 10x the client's price
        responses.append(client.submit_pay_for_blob([_blob(pkg, 3, 900, 2)]))
        addr = client.signer.addresses()[1]
        client.signer.set_sequence(addr, 7)  # the node expects 0
        responses.append(client.submit_pay_for_blob([_blob(pkg, 5, 600, 3)], addr))
        legs.append(([dataclasses.astuple(r) for r in responses], heights,
                     node.tx_index, node.mempool.resident_txs(),
                     [client.signer.account(a).sequence for a in client.signer.addresses()]))
    assert legs[0] == legs[1]
    assert [h for h, _, _, _, _ in legs[1][0]] == [1, 2, 3, 4]
    assert legs[1][4] == [3, 1, 0]
    with pytest.raises(ValueError):
        TxClient(port, [PrivateKey.from_seed(b"stranger")])


def test_recheck_evicts_what_the_commit_invalidated():
    """Block.MaxBytes fits one send: the higher-fee seq 1 is reaped first
    and filtered out, the recheck after the empty block evicts it (the
    state expects seq 0), and seq 0 lands in the next block."""
    legs = []
    for ref_side in (True, False):
        keys = jax_keys(2) if ref_side else funded_keys(2)
        genesis = (jax_genesis if ref_side else deterministic_genesis)(keys)
        genesis = dataclasses.replace(genesis, block_max_bytes=400)
        node = (JaxTestNode(genesis, keys) if ref_side
                else TestNode(genesis, keys, device="cpu"))
        heights = recorded(node)
        a, b = (k.public_key().address() for k in funded_keys(2))
        txs = [build_and_sign([MsgSend(a, b, (Coin("utia", 9),))], funded_keys(2)[0],
                              genesis.chain_id, 0, seq, Fee((Coin("utia", fee),), 100_000))
               for seq, fee in ((0, 200), (1, 900))]
        codes = [node.broadcast(t).code for t in txs]
        pools = []
        for _ in range(3):
            node.produce_block()
            pools.append(node.mempool.resident_txs())
        legs.append((codes, heights, pools, node.tx_index))
    assert legs[0] == legs[1]
    codes, heights, pools, index = legs[1]
    assert codes == [0, 0] and [len(h[0][0]) for h in heights] == [0, 1, 0]
    assert pools == [[txs[0]], [], []] and len(index) == 1


def test_network_of_three_equal():
    legs = []
    for net, client_cls, pkg in ((JaxNetwork(3), JaxTxClient, (JaxNamespace, JaxBlob)),
                                 (Network(3, device="cpu"), TxClient, (Namespace, Blob))):
        heights = recorded(net)
        client = client_cls(net, net.keys[:2])
        for i in range(3):
            client.submit_pay_for_blob([_blob(pkg, 10 + i, 2000 * (i + 1), 20 + i)])
        legs.append((heights, [n.cms.last_app_hash for n in net.nodes],
                     [n.height for n in net.nodes]))
    assert legs[0] == legs[1]
    assert len(set(legs[1][1])) == 1 and legs[1][2] == [3, 3, 3]
    net = Network(2, device="cpu")
    client = TxClient(net, net.keys[:1])
    client.submit_pay_for_blob([_blob((Namespace, Blob), 5, 2000, 30)])
    net.nodes[1].cms.working.set(b"bank/bal/evil/utia", (10**9).to_bytes(16, "big"))
    with pytest.raises(ConsensusFailure):
        client.submit_pay_for_blob([_blob((Namespace, Blob), 5, 2000, 31)])


def test_concurrent_admission_after_check_tx_equals_the_global_pool():
    """CheckTx serially on the node, then admission from 8 threads into its
    sharded pool: the same pool as a JAX global pool fed in order."""
    keys = funded_keys(16)
    node = TestNode(deterministic_genesis(keys), keys, device="cpu")
    txs = block_txs(keys, node.chain_id, seed=6, sends=24, pfbs=40, blob_shares=(1, 3))
    checked = [node.app.check_tx(t) for t in txs]
    assert all(r.code == 0 for r in checked)
    rows = [(t, next(e[1] for e in r.events if e[0] == "priority")) for t, r in zip(txs, checked)]
    ref = JaxMempool(shards=0)
    for tx, prio in rows:
        assert ref.insert(tx, prio, node.app.height)
    errors: list[BaseException] = []

    def admit(part):
        try:
            for tx, prio in part:
                assert node.mempool.insert(tx, prio, node.app.height)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=admit, args=(rows[i::8],)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert sorted(node.mempool.resident_txs()) == sorted(ref.resident_txs())
    assert node.mempool.size_bytes() == ref.size_bytes()


def test_node_and_network_without_a_card_raise():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: TestNode() runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TestNode()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Network(3)


@pytest.fixture
def faulty(monkeypatch):
    """Make the blob commitments fail as a kernel would (the memo cleared,
    so each CheckTx of a blob tx reaches them)."""
    def arm():
        batched._COMMIT_MEMO.clear()

        def fault(*args, **kwargs):
            raise RuntimeError("injected device fault")

        monkeypatch.setattr(batched, "tree_roots", fault)

    return arm


def _pfb(node, seq: int, seed: int) -> bytes:
    return block_txs(node.keys[:1], node.chain_id, seed=seed, sends=0, pfbs=1,
                     blob_shares=(1, 2), sequences=[seq])[0]


def test_broadcast_raises_a_device_fault_and_admits_nothing(faulty):
    _, port = nodes(2)
    send = block_txs(port.keys, port.chain_id, seed=1, sends=1, pfbs=0)[0]
    assert port.broadcast(send).code == 0
    before = port.mempool.resident_txs()
    faulty()
    with pytest.raises(DeviceFault, match="blob share commitments"):
        port.broadcast(_pfb(port, 0, seed=2))
    assert port.mempool.resident_txs() == before and len(port.mempool) == 1


def test_recheck_lets_a_device_fault_out_and_keeps_the_tx(faulty):
    """A send fits the block, the PFB does not: after the commit the
    recheck of the resident PFB hits the fault, which propagates out of
    produce_block; the PFB stays resident, the committed block is recorded
    and indexed, and once the card recovers the PFB lands."""
    keys = funded_keys(2)
    genesis = dataclasses.replace(deterministic_genesis(keys), block_max_bytes=700)
    node = TestNode(genesis, keys, device="cpu")
    a, b = (k.public_key().address() for k in keys)
    send = build_and_sign([MsgSend(b, a, (Coin("utia", 9),))], keys[1], node.chain_id, 1, 0,
                          Fee((Coin("utia", 200),), 100_000))
    pfb = _pfb(node, 0, seed=4)
    assert len(pfb) > 700 > len(send)
    assert node.broadcast(pfb).code == 0 and node.broadcast(send).code == 0
    before = _recheck_evictions()
    faulty()
    with pytest.raises(DeviceFault, match="blob share commitments"):
        node.produce_block()
    assert node.app.height == 1 and node.mempool.resident_txs() == [pfb]
    assert len(node.blocks) == 1 and node.blocks[0].txs == (send,)
    assert len(node.tx_index) == 1 and _recheck_evictions() == before


def _recheck_evictions() -> float:
    from celestia_app_tpu_torch.trace.metrics import registry

    fam = registry().get("celestia_mempool_evictions_total")
    return 0.0 if fam is None else sum(v for k, v in fam.samples() if k["reason"] == "recheck")


def test_tx_client_does_not_retry_a_device_fault(faulty):
    _, port = nodes(2)
    calls = []
    inner = port.broadcast
    port.broadcast = lambda raw, ctx=None: (calls.append(raw), inner(raw, ctx))[1]
    client = TxClient(port, port.keys[:1])
    faulty()
    with pytest.raises(DeviceFault):
        client.submit_pay_for_blob([_blob((Namespace, Blob), 4, 900, 5)])
    assert len(calls) == 1 and len(port.mempool) == 0
    assert client.signer.account(client.default_address).sequence == 0


def test_txsim_lets_a_device_fault_out(faulty):
    _, port = nodes(2)
    faulty()
    with pytest.raises(DeviceFault):
        port_txsim.run(port, port.keys, [port_txsim.BlobSequence(blob_size=(100, 400))],
                       blocks=1, seed=3)
    assert len(port.mempool) == 0 and port.app.height == 0
