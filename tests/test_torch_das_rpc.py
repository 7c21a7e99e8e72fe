"""The port's DAS RPCs over HTTP, held against the JAX node: one port
ServingNode (device="cpu") and one JAX ServingNode commit the same block,
and `get_share_proof` (both axes), `get_shares_by_namespace` (found and not)
and `get_attestation` through RemoteNode give the same payloads.  With
$CELESTIA_HEAL=1 each NodeServer runs a HealingEngine: a withheld sample is
refused with the JAX node's JSON-RPC error, the healer repairs the height,
and the coordinate then serves the honest payload; `stop` closes the
healer.
"""

from __future__ import annotations

import gc
import time

import jax
import pytest

from celestia_app_tpu import chaos as jax_chaos
from celestia_app_tpu.chaos import degrade as jax_degrade
from celestia_app_tpu.rpc.client import RemoteNode as JaxRemoteNode
from celestia_app_tpu.rpc.server import ServingNode as JaxServingNode
from celestia_app_tpu.rpc.server import serve as jax_serve
from celestia_app_tpu.serve import api as jax_api
from celestia_app_tpu.serve import heal as jax_heal
from celestia_app_tpu.testutil import deterministic_genesis as jax_genesis
from celestia_app_tpu.testutil import funded_keys as jax_keys
from celestia_app_tpu_torch import chaos
from celestia_app_tpu_torch.chaos import degrade
from celestia_app_tpu_torch.rpc.client import RemoteNode, RPCError
from celestia_app_tpu_torch.rpc.server import ServingNode, serve
from celestia_app_tpu_torch.serve import api, heal
from celestia_app_tpu_torch.testutil import deterministic_genesis, funded_keys
from celestia_app_tpu_torch.testutil.blocks import block_txs

N_KEYS = 4


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran, when it ends
    (each loaded XLA:CPU executable holds many memory mappings)."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def servers():
    """(port server, JAX server), each a solo node with one committed block
    of sends and PFBs, served with a healer."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CELESTIA_HEAL", "1")
    for mod in (heal, jax_heal):
        mod._reset_for_tests()
    out = []
    for node, serve_fn in (
        (JaxServingNode(jax_genesis(jax_keys(N_KEYS), n_validators=1), jax_keys(N_KEYS)),
         jax_serve),
        (ServingNode(deterministic_genesis(funded_keys(N_KEYS), n_validators=1),
                     funded_keys(N_KEYS), device="cpu"), serve),
    ):
        for raw in block_txs(funded_keys(N_KEYS), node.app.chain_id, seed=15, sends=2, pfbs=4,
                             blob_shares=(1, 3)):
            node.broadcast(raw)
        node.produce_block()
        out.append(serve_fn(node, port=0, block_interval_s=None))
    jax_server, port_server = out
    yield port_server, jax_server
    for s in out:
        s.stop()
    mp.undo()
    for mod in (heal, jax_heal):
        mod._reset_for_tests()


@pytest.fixture(autouse=True)
def _clean():
    for mod in (api, jax_api):
        mod._reset_coverage_for_tests()
    yield
    for c in (chaos, jax_chaos):
        c.uninstall()
    for d in (degrade, jax_degrade):
        d.reset_for_tests()


def calls(server, remote_cls, method: str, **params):
    return remote_cls(server.url).call(method, **params)


def test_das_rpcs_equal_jax(servers):
    port_server, jax_server = servers
    k = port_server.node.das_provider().entry(1).k
    n = 2 * k
    requests = [("get_share_proof", {"height": 1, "row": r, "col": c, "axis": a})
                for r, c in ((0, 0), (k - 1, k), (n - 1, n - 1), (k, 1)) for a in ("row", "col")]
    namespaces = sorted({bytes.fromhex(p["proof"]["namespace"]).hex()
                         for p in (calls(port_server, RemoteNode, m, **kw) for m, kw in requests)})
    requests += [("get_shares_by_namespace", {"height": 1, "namespace": ns})
                 for ns in namespaces[:2] + ["00" * 29]]
    requests.append(("get_attestation",
                     {"height": 1, "samples": f"0:0,1:{n - 1}:col,{n - 1}:2,{k}:{k}:col"}))
    for method, kw in requests:
        got = calls(port_server, RemoteNode, method, **kw)
        want = calls(jax_server, JaxRemoteNode, method, **kw)
        assert api.render(got) == jax_api.render(want), (method, kw)
    for method, kw in (("get_share_proof", {"height": 99, "row": 0, "col": 0}),
                       ("get_attestation", {"height": 1, "samples": ""})):
        errors = []
        for server, remote_cls in ((port_server, RemoteNode), (jax_server, JaxRemoteNode)):
            with pytest.raises(Exception) as info:
                calls(server, remote_cls, method, **kw)
            errors.append(str(info.value))
        assert errors[0] == errors[1]


def test_withheld_sample_is_refused_then_healed(servers):
    port_server, jax_server = servers
    honest = calls(port_server, RemoteNode, "get_share_proof", height=1, row=0, col=0)
    k = honest["square_size"]
    spec = "seed=31,withhold_frac=0.25"
    chaos.install(spec)
    jax_chaos.install(spec)
    r, c = sorted(chaos.active_adversary().withheld_set(1, 2 * k))[0]
    errors = []
    for server, remote_cls in ((port_server, RemoteNode), (jax_server, JaxRemoteNode)):
        with pytest.raises(Exception) as info:
            calls(server, remote_cls, "get_share_proof", height=1, row=r, col=c)
        errors.append(str(info.value))
    assert errors[0] == errors[1] and errors[0].startswith("ShareWithheld: ")
    engine = port_server._healer
    deadline = time.monotonic() + 120
    while engine.state()["healed"] < 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert engine.state()["healed"] == 1
    healed = calls(port_server, RemoteNode, "get_share_proof", height=1, row=r, col=c)
    chaos.uninstall()
    port_server.node.das_provider().cache.reset_for_tests()  # rebuilt from the block store
    assert healed == calls(port_server, RemoteNode, "get_share_proof", height=1, row=r, col=c)
    with pytest.raises(RPCError, match="unknown method"):
        calls(port_server, RemoteNode, "get_snapshot_chunk")


def test_stop_closes_the_healer(monkeypatch):
    monkeypatch.setenv("CELESTIA_HEAL", "1")
    keys = funded_keys(N_KEYS)
    server = serve(ServingNode(deterministic_genesis(keys, n_validators=1), keys, device="cpu"),
                   port=0, block_interval_s=None)
    engine = server._healer
    assert engine in heal.engines() and engine._thread.is_alive()
    server.stop()
    assert engine not in heal.engines() and not engine._thread.is_alive()
    monkeypatch.delenv("CELESTIA_HEAL")
    server = serve(ServingNode(deterministic_genesis(keys, n_validators=1), keys, device="cpu"),
                   port=0, block_interval_s=None)
    assert server._healer is None and server._das_provider is not None
    server.stop()
