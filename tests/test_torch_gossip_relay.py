"""The port's gossip consensus on the CPU, continued from
tests/test_torch_gossip.py (whose helpers it uses): a ring of 4 port
validators, where proposals, votes and a tx cross several hops, and a
cluster of 3 with the double-sign WAL.  Each replays into a JAX TestNode
with the same app hash at every height, and its Commit records verify
under the JAX verify_commit.
"""

from __future__ import annotations

import gc
import json

import jax
import pytest

import chip_smoke
from celestia_app_tpu_torch.testutil.blocks import block_txs
from celestia_app_tpu_torch.tx import tx_hash
from test_torch_gossip import check_against_jax, port_makers, running


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran (see
    tests/test_torch_node.py)."""
    yield
    jax.clear_caches()
    gc.collect()


def test_ring_relays_over_several_hops():
    """Each validator peers with its two ring neighbours only: proposals and
    votes cross two hops, and a tx submitted to node 2 reaches node 0 (not
    its peer) and whichever proposer takes it."""
    ring = {0: [1, 3], 1: [0, 2], 2: [1, 3], 3: [2, 0]}
    nodes, servers = chip_smoke.gossip_cluster(
        port_makers(range(4), 4), timeouts=chip_smoke.CPU_CLUSTER_TIMEOUTS, topology=ring)
    try:
        raw = block_txs(nodes[2].keys, nodes[2].chain_id, seed=5, sends=1, pfbs=0)[0]
        assert nodes[2].broadcast(raw).code == 0
        for n in nodes:
            n.consensus_driver.start()
        chip_smoke.wait_heights(nodes, 2, timeout_s=120)
        assert all(n.wait_tx(tx_hash(raw), 60.0)[1] == 0 for n in nodes)
        upto = min(n.app.height for n in nodes)
    finally:
        for s in servers:
            s.stop()
    check_against_jax(nodes, upto, 4)


def test_cluster_with_wal_advances(tmp_path):
    """The WAL never blocks honest single-signing; each journal holds its
    validator's votes, one record per (height, round, type)."""
    with running(port_makers(range(3), 3), wal_dir=tmp_path) as nodes:
        chip_smoke.wait_heights(nodes, 3, timeout_s=120)
    check_against_jax(nodes, 3, 3)
    for i in range(3):
        lines = (tmp_path / f"validator-{i}.wal").read_text().splitlines()
        votes = [json.loads(line) for line in lines if '"k":"vote"' in line]
        keys = [(v["h"], v["r"], v["t"]) for v in votes]
        assert len(keys) == len(set(keys)) and {h for h, _, _ in keys} >= {1, 2, 3}
        assert nodes[i].consensus_driver.wal.fsync_ms_total > 0
