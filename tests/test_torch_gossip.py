"""The port's gossip consensus on the CPU: clusters of port `ServingNode`s
(device "cpu") whose `ConsensusDriver`s run the round machine over flood
gossip on localhost HTTP, held to the JAX package.

Each cluster's committed blocks (BlockData, time, LastCommit signers,
evidence, from the block store) are replayed in order into a JAX
`TestNode`, whose app hash must equal the cluster's at every height, and
every Commit record verifies under the JAX `verify_commit`.  Here: a full
mesh of 3 to height 4 with txs relayed from a non-proposer, and 3 live
validators of 4, where the dead validator's height commits in round >= 1.
tests/test_torch_gossip_relay.py has the ring and the WAL cluster,
tests/test_torch_gossip_rpc.py the mixed cluster, speculation, the RPC
and what only the port has.

The round timeouts are chip_smoke.CPU_CLUSTER_TIMEOUTS: the plain SHA-256
makes an empty block's Prepare take about 0.4 s here.
"""

from __future__ import annotations

import contextlib
import gc
import json

import jax
import pytest

import chip_smoke
from celestia_app_tpu.consensus import Commit as JaxCommit
from celestia_app_tpu.consensus import verify_commit as jax_verify_commit
from celestia_app_tpu.crypto.keys import PublicKey as JaxPublicKey
from celestia_app_tpu.rpc.server import ServingNode as JaxServingNode
from celestia_app_tpu.testutil import TestNode as JaxTestNode
from celestia_app_tpu.testutil import deterministic_genesis as jax_genesis
from celestia_app_tpu.testutil import funded_keys as jax_keys
from celestia_app_tpu_torch.crypto import PrivateKey
from celestia_app_tpu_torch.rpc.server import ServingNode, serve
from celestia_app_tpu_torch.testutil import deterministic_genesis, funded_keys
from celestia_app_tpu_torch.testutil.blocks import block_txs

N_KEYS = 3


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran (see
    tests/test_torch_node.py)."""
    yield
    jax.clear_caches()
    gc.collect()


def port_makers(live, n_validators: int):
    """Makers of port validators `live` (indices into the genesis set)."""
    keys = funded_keys(N_KEYS)
    genesis = deterministic_genesis(keys, n_validators=n_validators)

    def maker(i):
        return lambda: (ServingNode(genesis=genesis, keys=keys, validator_index=i,
                                    n_validators=n_validators, device="cpu"), serve)

    return [maker(i) for i in live]


def round0_proposer(h: int, n_validators: int) -> str:
    """The round-0 proposer of height h: sorted addresses, shifted by h - 1."""
    order = sorted(PrivateKey.from_seed(f"validator-{i}".encode()).public_key().address()
                   for i in range(n_validators))
    return order[(h - 1) % n_validators]


@contextlib.contextmanager
def running(makers, setup=None, **kw):
    """A served cluster (chip_smoke.gossip_cluster) with its drivers started
    after `setup(nodes)`; every server stopped on the way out."""
    nodes, servers = chip_smoke.gossip_cluster(
        makers, timeouts=chip_smoke.CPU_CLUSTER_TIMEOUTS, **kw)
    try:
        if setup is not None:
            setup(nodes)
        for n in nodes:
            n.consensus_driver.start()
        yield nodes
    finally:
        for s in servers:
            s.stop()


def block_fields(node, h: int) -> tuple:
    data, time_ns, signers, evidence = node._blocks_by_height[h]
    return data.txs, data.square_size, data.hash, time_ns, signers, evidence


def check_against_jax(nodes, upto: int, n_validators: int) -> list[bytes]:
    """Every node's blocks and app hashes at 1..upto are equal; a JAX
    TestNode replaying them commits the same app hashes; every Commit
    record verifies under the JAX verify_commit against the set its height
    ran under.  Returns the app hashes."""
    ref = nodes[0]
    hashes = [ref.app.cms.app_hash_at(h) for h in range(1, upto + 1)]
    for node in nodes[1:]:
        assert [node.app.cms.app_hash_at(h) for h in range(1, upto + 1)] == hashes
        assert all(block_fields(node, h) == block_fields(ref, h) for h in range(1, upto + 1))
    keys = jax_keys(N_KEYS)
    replay = JaxTestNode(jax_genesis(keys, n_validators=n_validators), keys)
    assert chip_smoke.replay_heights(replay, ref, upto, JaxServingNode._parse_evidence) == hashes
    for h in range(1, upto + 1):
        record = JaxCommit.from_json(json.loads(json.dumps(ref._commits[h].to_json())))
        vals = {a: (JaxPublicKey(pk.bytes), p) for a, (pk, p) in ref._valsets_by_height[h].items()}
        assert jax_verify_commit(vals, ref.chain_id, record), h
        assert record.data_root == block_fields(ref, h)[2]
    return hashes


def test_full_mesh_reaches_height_4():
    with running(port_makers(range(3), 3)) as nodes:
        keys = nodes[0].keys
        # Txs at a non-proposer: they reach proposers by relay.
        for raw in block_txs(keys, nodes[0].chain_id, seed=3, sends=3, pfbs=0):
            assert nodes[1].broadcast(raw).code == 0
        chip_smoke.wait_heights(nodes, 4, timeout_s=120)
    check_against_jax(nodes, 4, 3)
    committed = [t for h in range(1, 5) for t in nodes[0]._blocks_by_height[h][0].txs]
    assert len(committed) == 3, "the relayed txs were not all committed"


def test_dead_proposer_height_commits_in_later_round():
    """3 live validators of 4, the dead one the round-0 proposer of height 1:
    height 1 commits in round >= 1, height 2 goes on."""
    dead = 2
    assert round0_proposer(1, 4) == PrivateKey.from_seed(b"validator-2").public_key().address()
    with running(port_makers([i for i in range(4) if i != dead], 4)) as nodes:
        chip_smoke.wait_heights(nodes, 2, timeout_s=120)
    assert nodes[0]._commits[1].round >= 1
    assert all(v.validator != round0_proposer(1, 4) for v in nodes[0]._commits[1].precommits)
    check_against_jax(nodes, 2, 4)
