"""The port's HTTP RPC and what only the port's consensus plane has, on the
CPU (helpers from tests/test_torch_gossip.py): RemoteNode + TxClient
against a solo port ServingNode give the JAX node's answers; no quiet CPU
fallback; a device fault in a validator's proposal check is never a vote;
state sync is left out and says so.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time

import jax
import pytest

import chip_smoke
from celestia_app_tpu.rpc.client import RemoteNode as JaxRemoteNode
from celestia_app_tpu.rpc.codec import to_jsonable as jax_to_jsonable
from celestia_app_tpu.rpc.server import ServingNode as JaxServingNode
from celestia_app_tpu.rpc.server import serve as jax_serve
from celestia_app_tpu.shares.namespace import Namespace as JaxNamespace
from celestia_app_tpu.shares.sparse import Blob as JaxBlob
from celestia_app_tpu.testutil import deterministic_genesis as jax_genesis
from celestia_app_tpu.testutil import funded_keys as jax_keys
from celestia_app_tpu.tx.messages import Coin as JaxCoin
from celestia_app_tpu.tx.messages import MsgSend as JaxMsgSend
from celestia_app_tpu.user import TxClient as JaxTxClient
from celestia_app_tpu_torch.consensus.votes import NIL, PREVOTE
from celestia_app_tpu_torch.device import DeviceFault
from celestia_app_tpu_torch.rpc.client import RemoteNode
from celestia_app_tpu_torch.rpc.codec import to_jsonable
from celestia_app_tpu_torch.rpc.gossip import BroadcastVote
from celestia_app_tpu_torch.rpc.server import ServingNode, serve
from celestia_app_tpu_torch.shares import Blob, Namespace
from celestia_app_tpu_torch.testutil import TestNode, deterministic_genesis, funded_keys
from celestia_app_tpu_torch.testutil.blocks import block_txs
from celestia_app_tpu_torch.tx import tx_hash
from celestia_app_tpu_torch.tx.messages import Coin, MsgSend
from celestia_app_tpu_torch.user import TxClient
from test_torch_gossip import N_KEYS, check_against_jax, port_makers, running


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran (see
    tests/test_torch_node.py)."""
    yield
    jax.clear_caches()
    gc.collect()


# --- the RPC ----------------------------------------------------------------

def rpc_run(node, serve_fn, remote_cls, client_cls, blob, send) -> list:
    """A solo served node: TxClient over RemoteNode submits a PFB and a send,
    each committed by an RPC produce_block; the answers of the node's RPC."""
    server = serve_fn(node, port=0, block_interval_s=None)
    try:
        remote = remote_cls(server.url)
        client = client_cls(remote, node.keys[:2])
        responses = []
        for submit in (lambda: client.submit_pay_for_blob([blob]),
                       lambda: client.submit_tx([send(client.default_address)])):
            worker = threading.Thread(target=lambda: responses.append(submit()))
            worker.start()
            deadline = time.monotonic() + 30
            while len(node.mempool) == 0 and time.monotonic() < deadline:
                time.sleep(0.01)
            remote.produce_block()
            worker.join(30)
        proof, root = remote.tx_inclusion_proof(1, 0)
        assert proof.verify(root)
        status = remote.status()
        hashes = [tx_hash(bytes.fromhex(t)) for h in (1, 2) for t in remote.block(h)["txs"]]
        return [
            [dataclasses.astuple(r) for r in responses],
            [remote.tx_status(h) for h in hashes],
            remote.block(1), remote.block(2),
            remote.commit(1).to_json(), remote.validators(),
            remote.query_account(client.default_address).sequence,
            {k: status[k] for k in ("chain_id", "height", "app_hash", "max_square_size")},
            root,
        ], proof
    finally:
        server.stop()


def test_rpc_answers_equal():
    jk, pk = jax_keys(N_KEYS), funded_keys(N_KEYS)
    runs = []
    for node, remote_cls, client_cls, ns, blob_cls, msg, coin, jsonable in (
        (JaxServingNode(jax_genesis(jk, n_validators=1), jk), JaxRemoteNode, JaxTxClient,
         JaxNamespace, JaxBlob, JaxMsgSend, JaxCoin, jax_to_jsonable),
        (ServingNode(deterministic_genesis(pk, n_validators=1), pk, device="cpu"), RemoteNode,
         TxClient, Namespace, Blob, MsgSend, Coin, to_jsonable),
    ):
        to = node.keys[2].public_key().address()
        answers, proof = rpc_run(
            node, jax_serve if remote_cls is JaxRemoteNode else serve, remote_cls, client_cls,
            blob_cls(ns.v0(b"\x07" * 10), bytes(range(256)) * 3),
            lambda frm: msg(frm, to, (coin("utia", 42),)))
        runs.append(answers + [jsonable(proof)])
    assert runs[0] == runs[1]
    assert [s[1] for s in runs[1][1]] == [0, 0] and runs[1][2]["txs"]


# --- what only the port has -------------------------------------------------

def test_no_card_no_node():
    """device None means CUDA, with no quiet fallback to the CPU."""
    keys = funded_keys(N_KEYS)
    for make in (lambda: ServingNode(deterministic_genesis(keys), keys),
                 lambda: TestNode(deterministic_genesis(keys), keys)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_state_sync_left_out():
    keys = funded_keys(N_KEYS)
    with pytest.raises(NotImplementedError, match="snapshot"):
        ServingNode(deterministic_genesis(keys), keys, snapshot_interval=2, device="cpu")


def test_retention_device_fault_comes_out_after_the_commit():
    """A DeviceFault of the serve retention comes out of the proposer-push
    produce_block after the block, its Commit record and its tx index are
    written (the JAX node would print it and go on)."""
    keys = funded_keys(N_KEYS)
    node = ServingNode(deterministic_genesis(keys, n_validators=1), keys, device="cpu")
    raw = block_txs(keys, node.chain_id, seed=4, sends=1, pfbs=0)[0]
    assert node.broadcast(raw, relay=False).code == 0

    def put(height, eds):
        raise DeviceFault("injected: forest build failed on the device")

    node.serve_cache.put = put
    with pytest.raises(DeviceFault, match="forest build"):
        node.produce_block()
    assert node.app.height == 1 and node._blocks_by_height[1][0].txs == (raw,)
    assert node._commits[1].height == 1 and node.tx_status(tx_hash(raw))[1] == 0


def test_device_fault_is_not_a_vote():
    """A DeviceFault in one validator's proposal check (4 live) comes out of
    its `handle` to the HTTP caller, stores no payload and casts no prevote
    for the proposal; the other three commit the height, and the faulted
    validator catches up to the same app hashes.  Another validator's serve
    retention of the height holding a tx takes a DeviceFault: it still
    records the block and its Commit record and goes on to the next
    height."""
    seen = {"faults": [], "payloads": [], "votes": [], "handled": [], "retained": []}

    def inject(nodes):
        raw = block_txs(nodes[0].keys, nodes[0].chain_id, seed=6, sends=1, pfbs=0)[0]
        seen["tx"] = tx_hash(raw)
        assert nodes[3].broadcast(raw).code == 0
        inner_put = nodes[2].serve_cache.put

        def put(height, eds):
            if not seen["retained"]:
                seen["retained"].append(height)
                raise DeviceFault("injected: forest build failed on the device")
            return inner_put(height, eds)

        nodes[2].serve_cache.put = put
        victim = nodes[1]
        seen["victim"] = victim
        driver = victim.consensus_driver
        inner_process = victim.app.process_proposal
        inner_validate, inner_handle = driver._validate_payload, driver.handle
        inner_execute = driver._execute_locked

        def process_proposal(data):
            if not seen["faults"]:
                seen["faults"].append(victim.app.height + 1)
                raise DeviceFault("injected: extend + DAH failed on the device")
            return inner_process(data)

        def validate(prop, msg):
            before = set(driver.payloads)
            try:
                return inner_validate(prop, msg)
            except DeviceFault:
                seen["payloads"].append((before, set(driver.payloads), prop))
                raise

        def handle(msg):
            try:
                return inner_handle(msg)
            except DeviceFault as e:
                seen["handled"].append(repr(e))
                raise

        def execute(effects, outbox):
            seen["votes"] += [e.vote for e in effects if isinstance(e, BroadcastVote)]
            return inner_execute(effects, outbox)

        victim.app.process_proposal = process_proposal
        driver._validate_payload, driver.handle = validate, handle
        driver._execute_locked = execute

    # Validator 1 is not height 1's proposer (that is validator 2).
    with running(port_makers(range(4), 4), setup=inject) as nodes:
        chip_smoke.wait_heights(nodes, 2, timeout_s=120)
        assert all(n.wait_tx(seen["tx"], 60.0)[1] == 0 for n in nodes)
        h = seen["retained"][0]
        chip_smoke.wait_heights(nodes, h + 1, timeout_s=120)
        upto = min(n.app.height for n in nodes)
    victim = seen["victim"]
    assert seen["faults"] == [1] and seen["handled"]
    (before, after, prop), = seen["payloads"]
    assert after == before and prop.block_hash not in after and prop.height == 1
    mine = [v for v in seen["votes"] if (v.height, v.round, v.vote_type) == (1, prop.round, PREVOTE)]
    assert all(v.block_hash == NIL for v in mine), mine
    others = [n for n in nodes if n is not victim]
    assert all(n._commits[1].block_hash == prop.block_hash for n in others)
    assert seen["retained"] == [h] and nodes[2]._blocks_by_height[h][0].txs
    assert nodes[2]._commits[h].block_hash == nodes[0]._commits[h].block_hash
    assert not nodes[2].serve_cache.contains(h) and nodes[0].serve_cache.contains(h)
    check_against_jax(others + [victim], upto, 4)
