"""The port's REST gateway (rpc/api_gateway.py), held against the JAX one.

The JAX and the port ServingNode of tests/test_torch_grpc_plane.py's chain
(device="cpu" for the port) each serve the gateway over HTTP.  Every route
answers the same status, content type and JSON body on both: the node and
block routes, accounts and balances found and not (404), the paged
validator and proposal lists with their cursors and a malformed page (400),
a committed, an unknown (404) and a malformed (400) tx hash, broadcast and
simulate with good and bad bodies (400), and an unknown path on either verb
(501).  A GET the routes do not hold falls through to the exposition, so
the gateway's /das/share_proof body is the JSON-RPC plane's byte for byte,
and the JAX gateway's.
"""

from __future__ import annotations

import base64
import gc
import json
import urllib.error
import urllib.request

import jax
import pytest
from test_torch_grpc_plane import chain_pair, signed

from celestia_app_tpu.rpc.api_gateway import serve_api as jax_serve_api
from celestia_app_tpu.rpc.server import serve as jax_serve
from celestia_app_tpu.serve import api as jax_api
from celestia_app_tpu_torch.rpc.api_gateway import serve_api
from celestia_app_tpu_torch.rpc.server import serve
from celestia_app_tpu_torch.serve import api
from celestia_app_tpu_torch.state.staking import StakingKeeper
from celestia_app_tpu_torch.tx import tx_hash
from celestia_app_tpu_torch.tx.messages import Coin, MsgSend


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran, when it ends
    (each loaded XLA:CPU executable holds many memory mappings)."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def gateways():
    """(JAX gateway, port gateway, port node, the port node's JSON-RPC
    server).  Serving each node's JSON-RPC registers its DasProvider with
    its package's exposition, where the gateway's GET falls through."""
    jax_node, node = chain_pair()
    jax_gw, gw = jax_serve_api(jax_node), serve_api(node)
    rpc = serve(node, port=0, block_interval_s=None)
    jax_rpc = jax_serve(jax_node, port=0, block_interval_s=None)
    yield jax_gw, gw, node, rpc
    for s in (jax_gw, gw, rpc, jax_rpc):
        s.stop()


def call(base: str, method: str, path: str, body: bytes | None = None):
    """(status, content type, body bytes) of one request; an HTTP error
    status is returned, not raised."""
    req = urllib.request.Request(base + path, data=body, method=method,
                                 headers={"Content-Type": "application/json"} if body else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def post_json(obj) -> bytes:
    return json.dumps(obj).encode()


def b64(raw: bytes) -> str:
    return base64.b64encode(raw).decode()


def routes(node) -> dict:
    """Route group -> [(verb, path, body)]."""
    addr = node.keys[3].public_key().address()
    committed = tx_hash(node.blocks[0].txs[0]).hex()
    send = signed(node.app, node.keys[2], [MsgSend(node.keys[2].public_key().address(), addr,
                                                   (Coin("utia", 9),))])
    val = StakingKeeper(node.app.cms.working).validators()[0].address
    page_key = b64(b"1")
    return {
        "node": [("GET", "/cosmos/base/tendermint/v1beta1/node_info", None),
                 ("GET", "/cosmos/base/tendermint/v1beta1/blocks/latest", None)],
        "accounts": [("GET", f"/cosmos/auth/v1beta1/accounts/{addr}", None),
                     ("GET", "/cosmos/auth/v1beta1/accounts/celestia1none", None),
                     ("GET", f"/cosmos/auth/v1beta1/accounts/{val}", None)],
        "balances": [("GET", f"/cosmos/bank/v1beta1/balances/{addr}", None),
                     ("GET", "/cosmos/bank/v1beta1/balances/celestia1none", None),
                     ("GET", f"/cosmos/bank/v1beta1/balances/{addr}/by_denom?denom=utia", None),
                     ("GET", f"/cosmos/bank/v1beta1/balances/{addr}/by_denom?denom=uo", None),
                     ("GET", f"/cosmos/bank/v1beta1/balances/{addr}/by_denom", None)],
        "validators": [("GET", "/cosmos/staking/v1beta1/validators" + q, None) for q in (
            "", "?pagination.limit=1&pagination.count_total=true",
            "?pagination.offset=2", "?pagination.reverse=true&pagination.limit=2",
            f"?pagination.key={page_key}&pagination.limit=1", "?pagination.offset=99",
            "?pagination.limit=x", "?pagination.key=%%%")],
        "proposals": [("GET", "/cosmos/gov/v1beta1/proposals" + q, None) for q in (
            "", "?pagination.count_total=true", "?pagination.offset=1",
            "?pagination.limit=zz")],
        "params": [("GET", "/cosmos/slashing/v1beta1/params", None),
                   ("GET", "/celestia/minfee/v1/min_gas_price", None),
                   ("GET", "/celestia/blob/v1/params", None)],
        "txs": [("GET", f"/cosmos/tx/v1beta1/txs/{committed}", None),
                ("GET", f"/cosmos/tx/v1beta1/txs/{committed.upper()}", None),
                ("GET", "/cosmos/tx/v1beta1/txs/" + "ab" * 32, None),
                ("GET", "/cosmos/tx/v1beta1/txs/abc", None)],
        "simulate": [("POST", "/cosmos/tx/v1beta1/simulate", post_json({"tx_bytes": b64(send)})),
                     ("POST", "/cosmos/tx/v1beta1/simulate",
                      post_json({"tx_bytes": b64(b"\x00junk")})),
                     ("POST", "/cosmos/tx/v1beta1/simulate", post_json({"tx": 1})),
                     ("POST", "/cosmos/tx/v1beta1/simulate", post_json({"tx_bytes": "!!"}))],
        "unknown": [("GET", "/cosmos/nothing/here", None), ("POST", "/cosmos/nothing", b"{}"),
                    ("POST", "/cosmos/tx/v1beta1/txs", b"{not json")],
        # last: it fills the mempools
        "broadcast": [("POST", "/cosmos/tx/v1beta1/txs", post_json({"tx_bytes": b64(send)})),
                      ("POST", "/cosmos/tx/v1beta1/txs", post_json({"tx_bytes": b64(send)})),
                      ("POST", "/cosmos/tx/v1beta1/txs", post_json({"tx_bytes": b64(b"zz")})),
                      ("POST", "/cosmos/tx/v1beta1/txs", post_json({}))],
    }


GROUPS = ("node", "accounts", "balances", "validators", "proposals", "params", "txs",
          "simulate", "unknown", "broadcast")
STATUSES = {"accounts": {200, 404}, "balances": {200}, "validators": {200, 400},
            "proposals": {200, 400}, "txs": {200, 404, 400}, "simulate": {200, 400},
            "unknown": {501, 400}, "broadcast": {200, 400}}


@pytest.mark.parametrize("group", GROUPS)
def test_routes_equal_jax(gateways, group):
    jax_gw, gw, node, _ = gateways
    statuses = set()
    for verb, path, body in routes(node)[group]:
        got = call(gw.url, verb, path, body)
        assert got == call(jax_gw.url, verb, path, body), (verb, path)
        assert got[1] == "application/json"
        statuses.add(got[0])
        json.loads(got[2])
    assert statuses == STATUSES.get(group, {200})


def test_route_groups_cover_every_route(gateways):
    from celestia_app_tpu_torch.rpc.api_gateway import _routes

    _, _, node, _ = gateways
    paths = {(verb, path.split("?")[0]) for group in routes(node).values()
             for verb, path, _ in group}
    for verb, pattern, _ in _routes(node):
        assert any(v == verb and pattern.match(p) for v, p in paths), pattern.pattern
    assert set(routes(node)) == set(GROUPS)


def test_das_get_falls_through_to_the_exposition(gateways):
    """GET /das/share_proof on the gateway: the JSON-RPC plane's body on the
    same node, and the JAX gateway's body on the JAX node."""
    jax_gw, gw, _, rpc = gateways
    for r, c, axis in ((0, 0, "row"), (2, 3, "col"), (3, 3, "row")):
        path = f"/das/share_proof?height=1&row={r}&col={c}&axis={axis}"
        bodies = []
        for base, mod in ((gw.url, api), (rpc.url, api), (jax_gw.url, jax_api)):
            mod._reset_coverage_for_tests()
            status, kind, body = call(base, "GET", path)
            assert status == 200 and kind == "application/json", body[:200]
            bodies.append(body)
        assert bodies[0] == bodies[1] == bodies[2]
    assert call(gw.url, "GET", "/das/share_proof?height=99&row=0&col=0") == \
        call(jax_gw.url, "GET", "/das/share_proof?height=99&row=0&col=0")
