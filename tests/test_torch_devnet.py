"""The port's multi-process devnet (rpc/devnet.py) on the CPU: 3 port
validator processes (`--device cpu`) in gossip mode, each in its own
process, run to height >= 3.  Their blocks and the app hashes their Commits
attest are equal across the three and equal to a JAX TestNode's replay of
the fetched blocks; a port FleetAggregator over the three URLs merges 3
reachable hosts, each with its device block; a child that dies is reported
with its log.
"""

from __future__ import annotations

import gc
import time

import jax
import pytest

from celestia_app_tpu.app.app import BlockData as JaxBlockData
from celestia_app_tpu.rpc.server import ServingNode as JaxServingNode
from celestia_app_tpu.testutil import TestNode as JaxTestNode
from celestia_app_tpu.testutil import deterministic_genesis as jax_genesis
from celestia_app_tpu.testutil import funded_keys as jax_keys
from celestia_app_tpu_torch.rpc.devnet import Devnet, free_ports, spawn_devnet
from celestia_app_tpu_torch.trace.fleet import FleetAggregator

N = 3
HEIGHT = 3
N_ACCOUNTS = 4  # run_validator's default


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran, when it ends
    (each loaded XLA:CPU executable holds many memory mappings)."""
    yield
    jax.clear_caches()
    gc.collect()


def wait_height(net: Devnet, height: int, timeout_s: float) -> int:
    deadline = time.monotonic() + timeout_s
    while True:
        net.check()
        heights = [net.client(i).status()["height"] for i in range(N)]
        if min(heights) >= height:
            return min(heights)
        if time.monotonic() > deadline:
            raise TimeoutError(f"devnet heights {heights} never all reached {height}")
        time.sleep(0.25)


def test_three_cpu_validators_agree_with_a_jax_replay(tmp_path):
    net = spawn_devnet(N, block_interval_ms=100, device="cpu", log_dir=str(tmp_path))
    try:
        top = wait_height(net, HEIGHT, timeout_s=120)
        clients = [net.client(i) for i in range(N)]
        blocks = [[c.block(h) for h in range(1, top + 1)] for c in clients]
        assert blocks[0] == blocks[1] == blocks[2]
        attested = [[c.commit(h + 1).prev_app_hash for h in range(1, top)] for c in clients]
        assert attested[0] == attested[1] == attested[2]
        state = FleetAggregator(net.urls, interval_s=3600).scrape()
        assert net.exited() == []
    finally:
        net.stop()
    assert all(f"validator {i} peers up" in net.log(i) for i in range(N))
    # Each child reports its own launches per committed height; on the CPU
    # the wrappers run the plain versions and count nothing.
    for i in range(N):
        reports = net.launches(i)
        assert reports[0][0] == 0 and reports[-1][0] >= top
        assert [h for h, _ in reports] == sorted({h for h, _ in reports})
        lo, hi, counts = net.launches_across(i, top)
        assert lo < top <= hi and set(counts) >= {"rs_dense", "sha256_leaf", "sha256"}
        assert not any(counts.values())
    keys = jax_keys(N_ACCOUNTS)
    replay = JaxTestNode(jax_genesis(keys, n_validators=N), keys)
    hashes = []
    for b in blocks[0][:-1]:
        data = JaxBlockData(txs=tuple(bytes.fromhex(t) for t in b["txs"]),
                            square_size=b["square_size"], hash=bytes.fromhex(b["data_hash"]))
        signers = b["last_commit_signers"]
        replay._commit_block_data(data, b["time_ns"],
                                  last_commit_signers=None if signers is None else set(signers),
                                  evidence=JaxServingNode._parse_evidence(b["evidence"]))
        hashes.append(replay.app.cms.last_app_hash)
    assert hashes == attested[0]
    assert state["fleet"]["hosts_total"] == state["fleet"]["hosts_reachable"] == N
    for url in net.urls:
        host = state["hosts"][url]
        assert host["status"] == "SERVING"
        assert host["device"]["measured_bytes"] > 0  # rss_high_water on the CPU
    assert state["fleet"]["device"]["hosts_reporting"] == N


def test_a_dead_child_is_reported_with_its_log(tmp_path):
    """A validator that cannot start (its port is taken) exits; spawn_devnet
    raises naming it, with its log, and stops the others."""
    import socket

    ports = free_ports(2)
    held = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    held.bind(("127.0.0.1", ports[1]))
    held.listen(1)
    try:
        with pytest.raises(RuntimeError, match=r"devnet validators exited: 1 \(exit 1\)") as info:
            spawn_devnet(2, ports=ports, device="cpu", log_dir=str(tmp_path), wait_s=60)
        assert "Address already in use" in str(info.value)
    finally:
        held.close()


def test_a_port_taken_before_the_bind_is_picked_again(tmp_path, monkeypatch):
    """With the ports left to spawn_devnet, a child that finds its port
    taken between the pick and its bind makes the spawn start over with
    fresh ports."""
    import socket

    from celestia_app_tpu_torch.rpc import devnet

    held = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    held.bind(("127.0.0.1", 0))
    held.listen(1)
    picks = []

    def pick(n):
        picks.append(free_ports(n) if picks else [held.getsockname()[1]] + free_ports(n - 1))
        return picks[-1]

    monkeypatch.setattr(devnet, "free_ports", pick)
    try:
        net = spawn_devnet(2, device="cpu", log_dir=str(tmp_path), wait_s=60)
        try:
            assert len(picks) == 2 and net.urls == [f"http://127.0.0.1:{p}" for p in picks[1]]
            assert net.exited() == []
        finally:
            net.stop()
    finally:
        held.close()
