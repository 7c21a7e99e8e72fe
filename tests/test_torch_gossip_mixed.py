"""The port's gossip consensus on the CPU, continued (helpers from
tests/test_torch_gossip.py): two JAX and two port validators on one wire,
and the prevote-window speculation, as an app-level round-change drill on
both packages and in a port cluster.

Blob txs here are signed with their account's real number (testutil
blocks.block_txs), which tests/test_gossip_consensus.py's helper does not
do (it signs with 1, so check_tx rejects its key-0 tx).
"""

from __future__ import annotations

import gc

import jax
import pytest

import chip_smoke
from celestia_app_tpu.da.eds import speculator as jax_speculator
from celestia_app_tpu.rpc.server import ServingNode as JaxServingNode
from celestia_app_tpu.rpc.server import serve as jax_serve
from celestia_app_tpu.testutil import TestNode as JaxTestNode
from celestia_app_tpu.testutil import deterministic_genesis as jax_genesis
from celestia_app_tpu.testutil import funded_keys as jax_keys
from celestia_app_tpu.trace.metrics import registry as jax_registry
from celestia_app_tpu_torch.da.eds import speculator
from celestia_app_tpu_torch.testutil import TestNode
from celestia_app_tpu_torch.testutil.blocks import block_txs
from celestia_app_tpu_torch.tx import tx_hash
from test_torch_gossip import N_KEYS, check_against_jax, port_makers, running


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran (see
    tests/test_torch_node.py)."""
    yield
    jax.clear_caches()
    gc.collect()


def test_mixed_cluster_agrees():
    """Validators 0, 1 on the JAX package and 2, 3 on the port gossip over
    one wire (a 4-validator genesis: no quorum without both packages) and
    commit the same blocks and app hashes; a tx broadcast to a port node
    reaches the JAX proposers by relay."""
    jk = jax_keys(N_KEYS)
    jgen = jax_genesis(jk, n_validators=4)

    def jax_maker(i):
        return lambda: (JaxServingNode(genesis=jgen, keys=jk, validator_index=i,
                                       n_validators=4), jax_serve)

    makers = port_makers([2, 3], 4) + [jax_maker(0), jax_maker(1)]
    with running(makers) as nodes:
        raw = block_txs(nodes[0].keys, nodes[0].chain_id, seed=8, sends=1, pfbs=0)[0]
        assert nodes[0].broadcast(raw).code == 0
        chip_smoke.wait_heights(nodes, 3, timeout_s=150)
        assert all(n.wait_tx(tx_hash(raw), 60.0)[1] == 0 for n in nodes)
        upto = min(n.app.height for n in nodes)
    check_against_jax(nodes, upto, 4)
    assert [type(n).__module__.split(".")[0] for n in nodes] == [
        "celestia_app_tpu_torch"] * 2 + ["celestia_app_tpu"] * 2


# --- prevote-window speculation ---------------------------------------------

def jax_outcomes() -> dict:
    out = {"hit": 0.0, "discard": 0.0}
    for labels, val in jax_registry().counter("celestia_speculation_total", "").samples():
        out[labels.get("outcome", "?")] = val
    return out


def speculation_drill(proposer, validators, spec, outcomes) -> list:
    """A validator (not the proposer, so no own-root memo answers it)
    speculates proposal A, then processes B (the round changed): the claim
    discards; another, which has not seen B, speculates B and processes B:
    the claim hits.  Returns each step's verdicts and counter deltas."""
    txs = block_txs(proposer.keys, proposer.chain_id, seed=21, sends=0, pfbs=2,
                    blob_shares=(1, 2))
    data_a = proposer.app.prepare_proposal(txs[:1])
    data_b = proposer.app.prepare_proposal(txs[1:])
    assert data_a.txs and data_b.txs and data_a.hash != data_b.hash
    steps = []
    for validator, (speculated, processed) in zip(validators, ((data_a, data_b),
                                                               (data_b, data_b))):
        before = dict(outcomes())
        ok = validator.app.speculate_proposal(speculated, height=2, round_=0)
        pending = spec().pending()
        verdict = validator.app.process_proposal(processed)
        after = outcomes()
        steps.append((ok, pending, verdict, spec().pending(),
                      {k: after[k] - before[k] for k in ("hit", "discard")}))
    return steps


def test_speculation_round_change_drill(monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_SPECULATE", "on")
    jax_speculator().discard()
    speculator().discard()
    got = [speculation_drill(JaxTestNode(), [JaxTestNode(), JaxTestNode()], jax_speculator,
                             jax_outcomes),
           speculation_drill(TestNode(device="cpu"),
                             [TestNode(device="cpu"), TestNode(device="cpu")], speculator,
                             lambda: speculator().outcomes)]
    assert got[0] == got[1]
    assert got[1] == [(True, True, True, False, {"hit": 0, "discard": 1}),
                      (True, True, True, False, {"hit": 1, "discard": 0})]


def test_cluster_speculates_in_prevote_window(monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_SPECULATE", "on")
    before = dict(speculator().outcomes)
    with running(port_makers(range(3), 3)) as nodes:
        raw = block_txs(nodes[0].keys, nodes[0].chain_id, seed=9, sends=0, pfbs=1,
                        blob_shares=(1, 1))[0]
        assert nodes[1].broadcast(raw).code == 0
        assert all(n.wait_tx(tx_hash(raw), 90.0)[1] == 0 for n in nodes)
        upto = min(n.app.height for n in nodes)
    check_against_jax(nodes, upto, 3)
    after = speculator().outcomes
    assert after["hit"] + after["discard"] > before["hit"] + before["discard"]
