"""The port's gRPC plane (rpc/grpc_plane.py), held against the JAX plane.

One JAX ServingNode and one port ServingNode (device="cpu") commit the same
chain: 3 genesis validators, the Blobstream window at 4 blocks, app version
1, a send and a PFB at height 1, a delegation and a gov proposal at
height 2, empty blocks to height 6.  Every handler of `_handlers(node)`
is called on both with the same request bytes, grpcio left out: the same
response bytes, or the same typed abort (status name and details) —
pagination on the three paged lists, `GetTx` / `WaitTx` on a committed, an
unknown, an empty and a malformed hash, and the DAS services on both axes,
an unknown height and a bad coordinate included.  With grpcio: a
`user.TxClient` over `GrpcNode` submits a send to a served port node and
confirms it through `WaitTx`; the debug sidecar's /metrics, the REST
gateway's and the JSON-RPC plane's are the same bytes; and a DAS call whose
proofs fault on every retry answers status INTERNAL naming DeviceFault.
"""

from __future__ import annotations

import gc
import urllib.request

import jax
import pytest

from celestia_app_tpu.rpc import grpc_plane as jax_grpc_plane
from celestia_app_tpu.rpc.server import ServingNode as JaxServingNode
from celestia_app_tpu.serve import api as jax_api
from celestia_app_tpu.testutil import deterministic_genesis as jax_genesis
from celestia_app_tpu.testutil import funded_keys as jax_keys
from celestia_app_tpu_torch import chaos
from celestia_app_tpu_torch.chaos import degrade
from celestia_app_tpu_torch.encoding.proto import encode_bytes_field, encode_varint_field
from celestia_app_tpu_torch.rpc import grpc_plane
from celestia_app_tpu_torch.rpc.server import ServingNode, serve
from celestia_app_tpu_torch.serve import api
from celestia_app_tpu_torch.state.accounts import AuthKeeper
from celestia_app_tpu_torch.state.staking import StakingKeeper
from celestia_app_tpu_torch.testutil import deterministic_genesis, funded_keys
from celestia_app_tpu_torch.testutil.blocks import block_txs
from celestia_app_tpu_torch.tx import tx_hash
from celestia_app_tpu_torch.tx.messages import (
    Coin,
    MsgDelegate,
    MsgSend,
    MsgSubmitProposal,
    ProposalParamChange,
)
from celestia_app_tpu_torch.tx.sign import Fee, build_and_sign

N_KEYS = 4
HEIGHTS = 6


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran, when it ends
    (each loaded XLA:CPU executable holds many memory mappings)."""
    yield
    jax.clear_caches()
    gc.collect()


def signed(app, key, msgs, sequence: int | None = None) -> bytes:
    addr = key.public_key().address()
    acct = AuthKeeper(app.cms.working).get_account(addr)
    return build_and_sign(msgs, key, app.chain_id, acct.account_number,
                          acct.sequence if sequence is None else sequence,
                          Fee((Coin("utia", 20_000),), 400_000))


def chain_txs(app, keys, height: int) -> list[bytes]:
    """The txs of the chain's `height`: a send and a PFB of the first
    keys at 1, a delegation and a gov proposal of the fourth at 2, none
    after (k=2 squares and the empty blocks' k=1, for the JAX node's
    compiles)."""
    if height == 1:
        return block_txs(keys[:3], app.chain_id, seed=17, sends=1, pfbs=1, blob_shares=(1, 1))
    if height == 2:
        addr = keys[3].public_key().address()
        val = StakingKeeper(app.cms.working).validators()[0].address
        proposal = MsgSubmitProposal("t", "d", (ProposalParamChange("blob", "GasPerBlobByte", "9"),),
                                     (Coin("utia", 1_000),), addr)
        return [signed(app, keys[3], [MsgDelegate(addr, val, Coin("utia", 2_000_000))]),
                signed(app, keys[3], [proposal], sequence=1)]
    return []


def chain_pair(heights: int = HEIGHTS) -> tuple:
    """(JAX node, port node) after committing the same `heights` blocks."""
    keys = funded_keys(N_KEYS)
    nodes = (
        JaxServingNode(genesis=jax_genesis(jax_keys(N_KEYS), n_validators=3,
                                           data_commitment_window=4, app_version=1),
                       keys=jax_keys(N_KEYS), validator_index=0, n_validators=1),
        ServingNode(genesis=deterministic_genesis(keys, n_validators=3,
                                                  data_commitment_window=4, app_version=1),
                    keys=keys, validator_index=0, n_validators=1, device="cpu"),
    )
    for node in nodes:
        node.peer_urls = []
    for height in range(1, heights + 1):
        txs = chain_txs(nodes[1].app, keys, height)
        for node in nodes:
            for raw in txs:
                assert node.broadcast(raw).code == 0
            _, results = node.produce_block()
            assert all(r.code == 0 for r in results), [r.log for r in results]
    assert nodes[0].app.cms.last_app_hash == nodes[1].app.cms.last_app_hash
    return nodes


@pytest.fixture(scope="module")
def nodes():
    return chain_pair()


def answer(handler, req: bytes):
    """A handler's response bytes, or its typed abort as (name, code,
    details)."""
    try:
        return handler(req)
    except Exception as e:  # noqa: BLE001 — the abort itself is compared
        return (type(e).__name__, getattr(e, "code", None), getattr(e, "details", str(e)))


def page(field: int, **kw) -> bytes:
    return encode_bytes_field(field, grpc_plane.encode_page_request(**kw))


def requests(node) -> dict:
    """(service, method) -> the request bytes each handler is called with."""
    keys = node.keys
    addr = keys[3].public_key().address()
    val = StakingKeeper(node.app.cms.working).validators()[0].address
    committed = tx_hash(node.blocks[0].txs[0]).hex().upper()
    hashes = [committed, committed.lower(), " " + committed + " ", "AB" * 32, "", "zz", "abc"]
    raw_send = signed(node.app, keys[2], [MsgSend(keys[2].public_key().address(), addr,
                                                  (Coin("utia", 7),))])
    paging = [b"", dict(), dict(offset=1), dict(limit=1), dict(limit=2, count_total=True),
              dict(reverse=True, limit=1), dict(offset=99, count_total=True),
              dict(key=b"1", limit=1), dict(key=b"junk")]

    def pages(field):
        return [p if isinstance(p, bytes) else page(field, **p) for p in paging]

    s = encode_bytes_field
    v = encode_varint_field
    das = [v(1, 1) + v(2, r) + v(3, c) + (s(4, b"col") if axis else b"")
           for r, c in ((0, 0), (1, 2), (3, 3)) for axis in (False, True)]
    das += [v(1, 99) + v(2, 0) + v(3, 0), v(1, 1) + v(2, 999) + v(3, 0), b""]
    return {
        ("cosmos.tx.v1beta1.Service", "GetTx"): [s(1, h.encode()) for h in hashes],
        ("cosmos.tx.v1beta1.Service", "Simulate"): [s(2, raw_send), s(2, b"\x00junk"), b""],
        ("cosmos.auth.v1beta1.Query", "Account"): [s(1, addr.encode()), s(1, b"celestia1none")],
        ("cosmos.bank.v1beta1.Query", "Balance"): [s(1, addr.encode()),
                                                   s(1, addr.encode()) + s(2, b"uother"), b""],
        ("cosmos.staking.v1beta1.Query", "Validators"): pages(2),
        ("cosmos.staking.v1beta1.Query", "Delegation"): [
            s(1, addr.encode()) + s(2, val.encode()), s(1, b"x") + s(2, val.encode())],
        ("cosmos.gov.v1beta1.Query", "Proposals"): pages(4),
        ("celestia.blob.v1.Query", "Params"): [b""],
        ("celestia.minfee.v1.Query", "NetworkMinGasPrice"): [b""],
        ("celestia.signal.v1.Query", "VersionTally"): [v(1, 1), v(1, 2), b""],
        ("celestia.qgb.v1.Query", "AttestationRequestByNonce"): [v(1, n) for n in (1, 2, 3, 99)],
        ("celestia.qgb.v1.Query", "LatestAttestationNonce"): [b""],
        ("celestia.qgb.v1.Query", "EVMAddress"): [s(1, val.encode()), b""],
        ("cosmos.distribution.v1beta1.Query", "DelegationRewards"): [
            s(1, addr.encode()) + s(2, val.encode()), s(1, b"x") + s(2, val.encode())],
        ("cosmos.distribution.v1beta1.Query", "CommunityPool"): [b""],
        ("cosmos.slashing.v1beta1.Query", "SigningInfo"): [s(1, val.encode()), s(1, b"x")],
        ("cosmos.slashing.v1beta1.Query", "SigningInfos"): pages(1),
        ("cosmos.slashing.v1beta1.Query", "Params"): [b""],
        ("cosmos.base.tendermint.v1beta1.Service", "GetLatestBlock"): [b""],
        ("cosmos.base.tendermint.v1beta1.Service", "GetNodeInfo"): [b""],
        ("celestia.tpu.subscription.v1.Subscription", "WaitTx"): [
            s(1, h.encode()) + v(2, t) for h in hashes for t in (0, 30)],
        ("celestia.tpu.das.v1.Das", "GetShareProof"): das,
        ("celestia.tpu.das.v1.Das", "GetSharesByNamespace"): None,  # from the square
        ("celestia.tpu.das.v1.Das", "GetAttestation"): [
            v(1, 1) + s(2, b"0:0,1:3:col,3:1"), v(1, 1) + s(2, b""), v(1, 1) + s(2, b"0:99"),
            v(1, 99) + s(2, b"0:0")],
        ("cosmos.tx.v1beta1.Service", "BroadcastTx"): [s(1, raw_send), s(1, raw_send),
                                                       s(1, b"\x00garbage")],
    }


METHODS = (
    ("cosmos.tx.v1beta1.Service", "GetTx"),
    ("cosmos.tx.v1beta1.Service", "Simulate"),
    ("cosmos.auth.v1beta1.Query", "Account"),
    ("cosmos.bank.v1beta1.Query", "Balance"),
    ("cosmos.staking.v1beta1.Query", "Validators"),
    ("cosmos.staking.v1beta1.Query", "Delegation"),
    ("cosmos.gov.v1beta1.Query", "Proposals"),
    ("celestia.blob.v1.Query", "Params"),
    ("celestia.minfee.v1.Query", "NetworkMinGasPrice"),
    ("celestia.signal.v1.Query", "VersionTally"),
    ("celestia.qgb.v1.Query", "AttestationRequestByNonce"),
    ("celestia.qgb.v1.Query", "LatestAttestationNonce"),
    ("celestia.qgb.v1.Query", "EVMAddress"),
    ("cosmos.distribution.v1beta1.Query", "DelegationRewards"),
    ("cosmos.distribution.v1beta1.Query", "CommunityPool"),
    ("cosmos.slashing.v1beta1.Query", "SigningInfo"),
    ("cosmos.slashing.v1beta1.Query", "SigningInfos"),
    ("cosmos.slashing.v1beta1.Query", "Params"),
    ("cosmos.base.tendermint.v1beta1.Service", "GetLatestBlock"),
    ("cosmos.base.tendermint.v1beta1.Service", "GetNodeInfo"),
    ("celestia.tpu.subscription.v1.Subscription", "WaitTx"),
    ("celestia.tpu.das.v1.Das", "GetShareProof"),
    ("celestia.tpu.das.v1.Das", "GetSharesByNamespace"),
    ("celestia.tpu.das.v1.Das", "GetAttestation"),
    ("cosmos.tx.v1beta1.Service", "BroadcastTx"),  # last: it fills the mempools
)

# The typed aborts the request table reaches: malformed hashes, the DAS
# lookups.
ABORTS = {"GetTx": {"INVALID_ARGUMENT"}, "WaitTx": {"INVALID_ARGUMENT"},
          "GetShareProof": {"NOT_FOUND", "INVALID_ARGUMENT"},
          "GetAttestation": {"INVALID_ARGUMENT", "NOT_FOUND"},
          "GetSharesByNamespace": {"INVALID_ARGUMENT"}}


def test_handler_table_equal_jax(nodes):
    jax_node, node = nodes
    want = {svc: sorted(methods) for svc, methods in jax_grpc_plane._handlers(jax_node).items()}
    assert {svc: sorted(m) for svc, m in grpc_plane._handlers(node).items()} == want
    assert {(svc, m) for svc in want for m in want[svc]} == set(METHODS)
    assert set(requests(node)) == set(METHODS)


def namespace_requests(node) -> list[bytes]:
    ns = node.das_provider().share_proof_payload(1, 0, 0)["proof"]["namespace"]
    return [encode_varint_field(1, 1) + encode_bytes_field(2, h.encode())
            for h in (ns, "00" * 29, "zz")]


@pytest.mark.parametrize("svc,method", METHODS, ids=[m for _, m in METHODS])
def test_handler_equal_jax(nodes, svc, method):
    """Every request of the table through the JAX and the port handler:
    the same response bytes or the same typed abort."""
    jax_node, node = nodes
    for mod in (api, jax_api):
        mod._reset_coverage_for_tests()
    reqs = (namespace_requests(node) if method == "GetSharesByNamespace"
            else requests(node)[(svc, method)])
    handler = grpc_plane._handlers(node)[svc][method]
    jax_handler = jax_grpc_plane._handlers(jax_node)[svc][method]
    aborts = set()
    for req in reqs:
        got = answer(handler, req)
        assert got == answer(jax_handler, req), req
        if isinstance(got, tuple):
            assert got[0] == "_Abort", got
            aborts.add(got[1])
    assert aborts == ABORTS.get(method, set())
    assert node.app.cms.last_app_hash == jax_node.app.cms.last_app_hash


def test_pagination_cursor_walks_the_list(nodes):
    """next_key resent as the page key walks every validator once, on both."""
    for plane, node in zip((jax_grpc_plane, grpc_plane), nodes):
        handler = plane._handlers(node)["cosmos.staking.v1beta1.Query"]["Validators"]
        seen, key = [], b""
        while True:
            resp = handler(page(2, key=key, limit=1, count_total=True))
            fields = list(grpc_plane.decode_fields(resp))
            seen += [v for n, _, v in fields if n == 1]
            info = plane._parse_page_response(next(v for n, _, v in fields if n == 2))
            assert info["total"] == 3
            if not info["next_key"]:
                break
            key = info["next_key"]
        assert len(seen) == len(set(seen)) == 3


def served_port_node(interval_s):
    keys = funded_keys(N_KEYS)
    node = ServingNode(genesis=deterministic_genesis(keys, n_validators=1), keys=keys,
                       device="cpu")
    node.peer_urls = []
    node.produce_block()
    return node, serve(node, port=0, block_interval_s=interval_s)


def test_txclient_over_a_grpc_channel():
    pytest.importorskip("grpc")
    from celestia_app_tpu_torch.user import TxClient

    node, http = served_port_node(0.25)
    plane = grpc_plane.serve_grpc(node)
    client = grpc_plane.GrpcNode(plane.target)
    try:
        assert client.chain_id == node.chain_id and client.node_info()["network"] == node.chain_id
        tx_client = TxClient(client, node.keys[:2])
        waited = []
        wait_tx = client.wait_tx
        client.wait_tx = lambda h, timeout_s=30.0: waited.append(h) or wait_tx(h, timeout_s)
        to = node.keys[1].public_key().address()
        resp = tx_client.submit_tx([MsgSend(tx_client.default_address, to, (Coin("utia", 321),))])
        assert resp.code == 0 and resp.height >= 2
        assert len(waited) == 1 and node.tx_status(waited[0]) == (resp.height, 0, "")
        vals, info = client.validators_page(limit=1, count_total=True)
        assert len(vals) == 1 and info["total"] == 1
    finally:
        client.close()
        plane.stop()
        http.stop()


def test_three_planes_serve_the_same_metrics(monkeypatch):
    pytest.importorskip("grpc")
    from celestia_app_tpu_torch.rpc.api_gateway import serve_api
    from celestia_app_tpu_torch.trace import exposition, slo

    monkeypatch.setenv("CELESTIA_SLO_TICK_S", "3600")
    monkeypatch.setenv("CELESTIA_SCRAPE_TS_S", "3600")
    # The scrapes below stamp the wall clock; give the process its old
    # stamp back afterwards, so that a later test on a pinned clock still
    # refreshes the gauge.
    monkeypatch.setattr(exposition, "_LAST_SCRAPE_TS", None)
    node, http = served_port_node(None)
    gw = serve_api(node)
    plane = grpc_plane.serve_grpc(node)
    try:
        node.produce_block()
        slo.engine().tick()
        bodies = []
        for url in (http.url, gw.url, plane.debug_url):
            with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
                assert resp.status == 200
                bodies.append(resp.read())
        assert bodies[0] == bodies[1] == bodies[2]
        assert b"celestia_block_height" in bodies[0]
    finally:
        gw.stop()
        plane.stop()
        http.stop()


def test_a_device_fault_is_an_internal_status(nodes):
    """Under a persistent proof fault the port's DAS handler raises
    DeviceFault past its retries; over the channel that is INTERNAL naming
    it, never a payload or another status."""
    grpc = pytest.importorskip("grpc")
    _, node = nodes
    plane = grpc_plane.serve_grpc(node, debug_port=None)
    client = grpc_plane.GrpcNode(plane.target)
    try:
        chaos.install("seed=1,proof_fail=1.0")
        with pytest.raises(grpc.RpcError) as info:
            client.share_proof_bytes(1, 1, 3)
        assert info.value.code() == grpc.StatusCode.INTERNAL
        assert info.value.details().startswith("DeviceFault: ")
    finally:
        chaos.uninstall()
        degrade.reset_for_tests()
        client.close()
        plane.stop()
    assert grpc_plane._handlers(node)["celestia.tpu.das.v1.Das"]["GetShareProof"](
        encode_varint_field(1, 1) + encode_varint_field(2, 1) + encode_varint_field(3, 3))
