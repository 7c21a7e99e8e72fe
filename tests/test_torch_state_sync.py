"""The port's state sync (rpc/server.py, rpc/client.py), held against the
JAX package.  One chain is built on each package, the same way: one
validator, snapshot_interval=4, 11 blocks with sends on the even ones.
Then:
  * the snapshot metadata, chunk bytes and chunk hashes served over HTTP
    are equal between the packages (snapshots at 4 and 8, kept 2);
  * a port joiner syncs from the port server to the tip with the JAX node's
    app hash, serves the caught-up heights (404 below the join point) and
    produces one more height equal to a JAX joiner's;
  * a port joiner syncs from the JAX server, and a JAX joiner from the port
    server, each to the same app hash;
  * a tampered chunk, a wrong chain, a missing trust anchor and a forged
    app hash are refused with the JAX package's error, and a refused sync
    leaves the joiner untouched (these mirror tests/test_state_sync.py);
  * on a chain whose supply is large, the port joiner lands on the source's
    app hash where a JAX joiner forks at its first block: the JAX App keeps
    its minter in memory and the JAX snapshot does not carry it; the port's
    does, and a port joiner refuses the JAX snapshot there instead of
    forking (deliberate differences, rpc/server.py);
  * the port checks the metadata outside the attested state against the
    Commit two heights past the snapshot: a forged minter and a peer whose
    tip has no such Commit yet are refused, leaving the joiner untouched.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import hashlib
import json
import time

import jax
import pytest

from celestia_app_tpu.consensus import ConsensusError as JaxConsensusError
from celestia_app_tpu.rpc.client import RemoteNode as JaxRemoteNode
from celestia_app_tpu.rpc.server import ServingNode as JaxServingNode
from celestia_app_tpu.rpc.server import serve as jax_serve
from celestia_app_tpu.state.accounts import AuthKeeper as JaxAuthKeeper
from celestia_app_tpu.state.store import CommitStore as JaxCommitStore
from celestia_app_tpu.testutil import deterministic_genesis as jax_genesis
from celestia_app_tpu.testutil import funded_keys as jax_keys
from celestia_app_tpu.tx.messages import Coin as JaxCoin
from celestia_app_tpu.tx.messages import MsgSend as JaxMsgSend
from celestia_app_tpu.tx.sign import Fee as JaxFee
from celestia_app_tpu.tx.sign import build_and_sign as jax_build_and_sign
from celestia_app_tpu_torch.consensus import ConsensusError
from celestia_app_tpu_torch.rpc.client import RemoteNode
from celestia_app_tpu_torch.rpc.server import ServingNode, serve
from celestia_app_tpu_torch.serve.api import UnknownHeight
from celestia_app_tpu_torch.state.accounts import AuthKeeper, BankKeeper
from celestia_app_tpu_torch.state.store import CommitStore
from celestia_app_tpu_torch.testutil import deterministic_genesis, funded_keys
from celestia_app_tpu_torch.tx.messages import Coin, MsgSend
from celestia_app_tpu_torch.tx.sign import Fee, build_and_sign

N_KEYS = 3
BLOCKS = 11
SNAPSHOT_INTERVAL = 4
JOIN_HEIGHT = 8

PORT = dict(node=ServingNode, serve=serve, genesis=deterministic_genesis, keys=funded_keys,
            auth=AuthKeeper, sign=build_and_sign, msg=MsgSend, coin=Coin, fee=Fee,
            kw={"device": "cpu"})
JAX = dict(node=JaxServingNode, serve=jax_serve, genesis=jax_genesis, keys=jax_keys,
           auth=JaxAuthKeeper, sign=jax_build_and_sign, msg=JaxMsgSend, coin=JaxCoin,
           fee=JaxFee, kw={})


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran, when it ends
    (each loaded XLA:CPU executable holds many memory mappings)."""
    yield
    jax.clear_caches()
    gc.collect()


def build_chain(pkg: dict):
    """(node, server) of a solo validator with BLOCKS blocks, a send on
    every even one, snapshots every SNAPSHOT_INTERVAL heights.  A solo
    validator's own precommit is +2/3, so its Commits carry the quorum a
    joiner verifies."""
    keys = pkg["keys"](N_KEYS)
    node = pkg["node"](genesis=pkg["genesis"](keys, n_validators=1), keys=keys,
                       snapshot_interval=SNAPSHOT_INTERVAL, **pkg["kw"])
    server = pkg["serve"](node, port=0, block_interval_s=None)
    for i in range(BLOCKS):
        if i % 2 == 0:
            addr = keys[0].public_key().address()
            acct = pkg["auth"](node.app.cms.working).get_account(addr)
            raw = pkg["sign"](
                [pkg["msg"](addr, keys[1].public_key().address(), (pkg["coin"]("utia", 100 + i),))],
                keys[0], node.chain_id, acct.account_number, acct.sequence,
                pkg["fee"]((pkg["coin"]("utia", 20_000),), 100_000))
            assert node.broadcast(raw).code == 0
        node.produce_block()
    return node, server


@pytest.fixture(scope="module")
def chains():
    """{"port": (node, server), "jax": (node, server)}, the same chain."""
    out = {"port": build_chain(PORT), "jax": build_chain(JAX)}
    yield out
    for _, server in out.values():
        server.stop()


def joiner(pkg: dict, chain_id: str | None = None):
    keys = pkg["keys"](N_KEYS)
    kw = {} if chain_id is None else {"chain_id": chain_id}
    return pkg["node"](genesis=pkg["genesis"](keys, n_validators=1, **kw), keys=keys,
                       **pkg["kw"])


def test_chains_and_snapshots_equal_jax(chains):
    (port, port_server), (theirs, jax_server) = chains["port"], chains["jax"]
    assert port.app.height == theirs.app.height == BLOCKS
    assert port.app.cms.last_app_hash == theirs.app.cms.last_app_hash
    metas = RemoteNode(port_server.url).snapshots()
    # The port's metadata also carries the minter (rpc/server.py docstring).
    assert all(set(m.pop("minter")) == {"inflation_rate", "annual_provisions",
                                        "previous_block_time_ns"} for m in metas)
    assert metas == JaxRemoteNode(jax_server.url).snapshots()
    assert [m["height"] for m in metas] == [4, 8]  # keep 2
    assert all("chunks" not in m for m in metas)
    for meta in metas:
        for i, want in enumerate(meta["chunk_hashes"]):
            chunk = RemoteNode(port_server.url).snapshot_chunk(meta["height"], i)
            assert chunk == JaxRemoteNode(jax_server.url).snapshot_chunk(meta["height"], i)
            assert hashlib.sha256(bytes.fromhex(chunk)).hexdigest() == want
    with pytest.raises(Exception, match="no snapshot at height 3"):
        RemoteNode(port_server.url).snapshot_chunk(3, 0)
    assert port._snapshots[8]["chunks"] == theirs._snapshots[8]["chunks"]


def test_port_joiner_syncs_to_the_tip(chains, monkeypatch):
    (port, port_server), (theirs, jax_server) = chains["port"], chains["jax"]
    mine = joiner(PORT)
    assert mine.state_sync_from(port_server.url) == JOIN_HEIGHT
    assert mine.app.height == BLOCKS
    assert mine.app.cms.last_app_hash == theirs.app.cms.last_app_hash
    assert mine.app.device.type == "cpu"
    a0 = funded_keys(N_KEYS)[0].public_key().address()
    assert BankKeeper(mine.app.cms.working).balance(a0) == \
        BankKeeper(port.app.cms.working).balance(a0)
    # The caught-up heights serve the source's proofs; below the join
    # point the joiner has no blocks: UnknownHeight (a 404), no rebuild.
    for h in (9, 11):  # the heights with a send
        got = mine.das_provider().share_proof_payload(h, 0, 1)
        assert got == port.das_provider().share_proof_payload(h, 0, 1)
    port.das_provider().share_proof_payload(5, 0, 1)
    with pytest.raises(UnknownHeight):
        mine.das_provider().share_proof_payload(5, 0, 1)
    # The probe sees the joined node (time injected).
    monkeypatch.setattr(time, "time", lambda: 1e9)
    probe = mine.health_snapshot()
    assert probe["height"] == BLOCKS and probe["peers"] == 1
    # One more height, on the joiner alone, equal to a JAX joiner's.
    other = joiner(JAX)
    assert other.state_sync_from(jax_server.url) == JOIN_HEIGHT
    for node in (mine, other):
        node.peer_urls, node._peers = [], []
        node.produce_block()
    assert mine.app.height == other.app.height == BLOCKS + 1
    assert mine.app.cms.last_app_hash == other.app.cms.last_app_hash
    # The /healthz layer of both joiners: equal but for the serve cache's
    # counters, which count the payloads served above on the port joiner.
    got, want = mine.health_snapshot(), other.health_snapshot()
    assert set(got["serve"]) == set(want["serve"])
    got.pop("serve"), want.pop("serve")
    assert got == want and got["peers"] == 0


@pytest.mark.parametrize("direction", ["port_from_jax", "jax_from_port"])
def test_sync_across_packages(chains, direction):
    (port, port_server), (theirs, jax_server) = chains["port"], chains["jax"]
    if direction == "port_from_jax":
        node, url = joiner(PORT), jax_server.url
    else:
        node, url = joiner(JAX), port_server.url
    assert node.state_sync_from(url) == JOIN_HEIGHT
    assert node.app.height == BLOCKS
    assert node.app.cms.last_app_hash == port.app.cms.last_app_hash == \
        theirs.app.cms.last_app_hash


def forge_app_hash(snap: dict, commit_store) -> None:
    """Doctor the snapshot's state and re-derive every hash so it is
    self-consistent: only the next height's Commit can expose it."""
    state = json.loads(b"".join(snap["chunks"]))
    state[next(iter(state))] = "ff" * 8
    blob = json.dumps(state, separators=(",", ":")).encode()
    snap["chunks"] = [blob]
    snap["chunk_hashes"] = [hashlib.sha256(blob).hexdigest()]
    cms = commit_store()
    cms._committed[JOIN_HEIGHT] = {bytes.fromhex(k): bytes.fromhex(v) for k, v in state.items()}
    cms.load_height(JOIN_HEIGHT)
    snap["app_hash"] = cms.last_app_hash.hex()


REFUSALS = {
    "tampered_chunk": (lambda node, pkg: node._snapshots[JOIN_HEIGHT]["chunks"].__setitem__(
        0, b'{"deadbeef":"ff"}'), None, "chunk 0 hash mismatch"),
    "wrong_chain": (None, "other-chain", "snapshot is for chain"),
    "no_trust_anchor": (lambda node, pkg: node._commits.pop(JOIN_HEIGHT + 1), None,
                        "does not attest"),
    "forged_app_hash": (lambda node, pkg: forge_app_hash(
        node._snapshots[JOIN_HEIGHT], CommitStore if pkg is PORT else JaxCommitStore), None,
        "does not attest"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refused_sync_leaves_the_joiner_untouched(chains, case):
    tamper, chain_id, message = REFUSALS[case]
    errors = []
    for name, pkg in (("port", PORT), ("jax", JAX)):
        node, server = chains[name]
        with node.lock:
            saved = (copy.deepcopy(node._snapshots), dict(node._commits))
            if tamper is not None:
                tamper(node, pkg)
        try:
            mine = joiner(pkg, chain_id=chain_id)
            before = (mine.app.height, mine.app.cms.last_app_hash, mine.chain_id)
            with pytest.raises((ValueError, ConsensusError, JaxConsensusError)) as info:
                mine.state_sync_from(server.url)
            assert message in str(info.value)
            assert (mine.app.height, mine.app.cms.last_app_hash, mine.chain_id) == before
            errors.append((type(info.value).__name__, str(info.value)))
        finally:
            with node.lock:
                node._snapshots, node._commits = saved
    assert errors[0] == errors[1]


def rich_chain(pkg: dict, blocks: int = 5):
    """(node, server) of a solo validator whose 3 accounts hold 10^16 utia
    each, snapshots every 3 heights, `blocks` empty blocks."""
    keys = pkg["keys"](N_KEYS)
    genesis = pkg["genesis"](keys, n_validators=1)
    genesis = dataclasses.replace(genesis, accounts=tuple(
        dataclasses.replace(a, balance=10**16) for a in genesis.accounts))
    node = pkg["node"](genesis=genesis, keys=keys, snapshot_interval=3, **pkg["kw"])
    server = pkg["serve"](node, port=0, block_interval_s=None)
    for _ in range(blocks):
        node.produce_block()
    return node, server, genesis


def test_minter_carried_where_the_jax_snapshot_forks():
    (port, port_server, genesis), (theirs, jax_server, jax_genesis_) = (
        rich_chain(PORT), rich_chain(JAX))
    try:
        assert port.app.cms.last_app_hash == theirs.app.cms.last_app_hash
        joiners = {}
        for name, pkg, gen, url in (("port", PORT, genesis, port_server.url),
                                    ("jax", JAX, jax_genesis_, jax_server.url)):
            node = pkg["node"](genesis=gen, keys=pkg["keys"](N_KEYS), **pkg["kw"])
            assert node.state_sync_from(url) == 3 and node.app.height == 5
            joiners[name] = node.app.cms.last_app_hash
        assert joiners["port"] == port.app.cms.last_app_hash
        # The JAX joiner recomputes the annual provisions from the restored
        # supply and mints another provision at height 4: it forks.
        assert joiners["jax"] != theirs.app.cms.last_app_hash
        # A port joiner fed the JAX snapshot (no minter) would do the same:
        # the Commit at 5 exposes it, and it refuses, untouched.
        node = PORT["node"](genesis=genesis, keys=PORT["keys"](N_KEYS), **PORT["kw"])
        before = (node.app.height, node.app.cms.last_app_hash,
                  dataclasses.replace(node.app.minter))
        with pytest.raises(ConsensusError, match="does not attest height 4 executed"):
            node.state_sync_from(jax_server.url)
        assert (node.app.height, node.app.cms.last_app_hash, node.app.minter) == before
    finally:
        port_server.stop()
        jax_server.stop()


def forge_minter(snap: dict) -> None:
    snap["minter"]["annual_provisions"] = str(2 * int(snap["minter"]["annual_provisions"]))


PORT_REFUSALS = {
    "forged_minter": (lambda node: forge_minter(node._snapshots[JOIN_HEIGHT]),
                      "does not attest height 9 executed from the snapshot's metadata"),
    "forged_previous_block_time": (
        lambda node: node._snapshots[JOIN_HEIGHT]["minter"].__setitem__(
            "previous_block_time_ns", node._snapshots[JOIN_HEIGHT]["block_time_ns"] - 10**12),
        "does not attest height 9 executed from the snapshot's metadata"),
    "no_commit_past_the_next": (lambda node: node._commits.pop(JOIN_HEIGHT + 2),
                                "no commit at height 10 yet"),
}


@pytest.mark.parametrize("case", sorted(PORT_REFUSALS))
def test_unchecked_metadata_refused(chains, case):
    """The port's own check of the snapshot metadata the Commit does not
    attest; a refused sync leaves the joiner untouched."""
    tamper, message = PORT_REFUSALS[case]
    node, server = chains["port"]
    with node.lock:
        saved = (copy.deepcopy(node._snapshots), dict(node._commits))
        tamper(node)
    try:
        mine = joiner(PORT)
        before = (mine.app.height, mine.app.cms.last_app_hash, mine.chain_id,
                  dataclasses.replace(mine.app.minter), mine.app.last_block_time_ns)
        with pytest.raises(ConsensusError, match=message):
            mine.state_sync_from(server.url)
        assert (mine.app.height, mine.app.cms.last_app_hash, mine.chain_id, mine.app.minter,
                mine.app.last_block_time_ns) == before
    finally:
        with node.lock:
            node._snapshots, node._commits = saved
