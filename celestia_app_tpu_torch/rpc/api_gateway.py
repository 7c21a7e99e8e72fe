"""REST API gateway: the cosmos gRPC-gateway surface over HTTP+JSON.

The reference node serves three planes — Tendermint RPC, gRPC, and a
REST "API" gateway (grpc-gateway routes registered in
the reference's app/app.go:712-735; testnode wires all three,
test/util/testnode/network.go:38-43, default port 1317). This module is
the third plane: the standard cosmos REST routes mapped onto the same
node surface the other planes consume, JSON field names in snake_case as
the sdk's gateway emits them.

    GET  /cosmos/base/tendermint/v1beta1/node_info
    GET  /cosmos/base/tendermint/v1beta1/blocks/latest
    GET  /cosmos/auth/v1beta1/accounts/{address}
    GET  /cosmos/bank/v1beta1/balances/{address}
    GET  /cosmos/bank/v1beta1/balances/{address}/by_denom?denom=
    GET  /cosmos/staking/v1beta1/validators[?pagination.offset=&pagination.limit=&pagination.count_total=]
    GET  /cosmos/gov/v1beta1/proposals
    GET  /cosmos/slashing/v1beta1/params
    GET  /celestia/minfee/v1/min_gas_price
    GET  /celestia/blob/v1/params
    GET  /cosmos/tx/v1beta1/txs/{hash}
    POST /cosmos/tx/v1beta1/txs        {"tx_bytes": base64, "mode": ...}
    POST /cosmos/tx/v1beta1/simulate   {"tx_bytes": base64}

plus the shared observability surface every serving plane mounts
(trace/exposition.py): GET /metrics (byte-identical Prometheus exposition
across the JSON-RPC, REST, and gRPC-debug ports), /trace_tables[/<name>],
and /healthz.

Errors follow the gateway shape: {"code": grpc-code, "message": ...}
with HTTP 404 / 400 / 501 as the sdk maps them.

The port's copy of celestia_app_tpu/rpc/api_gateway.py.  Any other fault of
a route, a device.DeviceFault among them, answers 500 with
{"code": 13, "message": "DeviceFault: ..."}, as in the JAX gateway.
"""

from __future__ import annotations

import base64
import json
import re
import threading
from contextlib import nullcontext
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


def _node_lock(node):
    return getattr(node, "lock", None) or nullcontext()


def _power_reduction() -> int:
    from celestia_app_tpu_torch.state.staking import POWER_REDUCTION

    return POWER_REDUCTION


def _rest_page_request(q) -> dict:
    """Parse the gateway's pagination.* query params into the shared
    _paginate request shape (same cursor contract as the gRPC plane:
    clients resend next_key as pagination.key).  Raises _BadRequest on
    malformed values."""
    try:
        key = base64.b64decode((q.get("pagination.key") or [""])[0])
        return {
            "offset": int(key.decode()) if key else max(
                int((q.get("pagination.offset") or ["0"])[0]), 0),
            "limit": max(int((q.get("pagination.limit") or ["0"])[0]), 0),
            "count_total":
                (q.get("pagination.count_total") or ["false"])[0] == "true",
            "reverse":
                (q.get("pagination.reverse") or ["false"])[0] == "true",
        }
    except ValueError as e:
        raise _BadRequest(f"invalid pagination: {e}") from e


def _rest_page_response(page_req: dict, page_resp: bytes) -> dict:
    """PageResponse bytes -> the gateway's JSON pagination object."""
    from celestia_app_tpu_torch.rpc.grpc_plane import _parse_page_response

    out: dict = {}
    parsed = _parse_page_response(page_resp)
    if parsed["next_key"]:
        out["next_key"] = base64.b64encode(parsed["next_key"]).decode()
    if page_req["count_total"]:
        out["total"] = str(parsed["total"])
    return out


def _routes(node):
    """[(method, compiled path regex, handler(match, query, body) -> dict)]"""

    def node_info(m, q, body):
        return {
            "default_node_info": {
                "network": node.chain_id,
                "version": "celestia-app-tpu",
                "moniker": "tpu-node",
            },
            "application_version": {
                "app_name": "celestia-app-tpu",
                "version": str(node.app.app_version),
            },
        }

    def latest_block(m, q, body):
        with _node_lock(node):
            height = node.app.height
        return {
            "block": {
                "header": {"chain_id": node.chain_id, "height": str(height)}
            },
        }

    def account(m, q, body):
        with _node_lock(node):
            acc = node.query_account(m.group("address"))
        if acc is None:
            raise _NotFound(f"account {m.group('address')} not found")
        return {
            "account": {
                "@type": "/cosmos.auth.v1beta1.BaseAccount",
                "address": acc.address,
                "account_number": str(acc.account_number),
                "sequence": str(acc.sequence),
            }
        }

    def balances(m, q, body):
        # Every denom the address holds (the bank store is multi-denom:
        # IBC voucher denoms live beside utia), denom-sorted as the sdk
        # pages them. Address-scoped prefix walk — the global supply walk
        # would hold the node lock for O(all accounts).
        from celestia_app_tpu_torch.state.accounts import BankKeeper

        with _node_lock(node):
            bals = BankKeeper(node.app.cms.working).balances_of(
                m.group("address")
            )
        coins = sorted((d, a) for d, a in bals.items() if a)
        return {
            "balances": [
                {"denom": d, "amount": str(a)} for d, a in coins
            ],
            "pagination": {"total": str(len(coins))},
        }

    def balance_by_denom(m, q, body):
        from celestia_app_tpu_torch.state.accounts import BankKeeper

        denom = (q.get("denom") or ["utia"])[0]
        with _node_lock(node):
            amount = BankKeeper(node.app.cms.working).balance(
                m.group("address"), denom
            )
        return {"balance": {"denom": denom, "amount": str(amount)}}

    def validators(m, q, body):
        # Same pagination engine as the gRPC plane (_paginate): honors the
        # sdk cursor contract — clients resend next_key as pagination.key.
        from celestia_app_tpu_torch.rpc.grpc_plane import _paginate

        with _node_lock(node):
            vals = node.validators()
        page_req = _rest_page_request(q)
        page, page_resp = _paginate(vals, page_req)
        return {
            "validators": [
                {
                    "operator_address": v["address"],
                    "status": "BOND_STATUS_BONDED",
                    # sdk convention shared with the gRPC plane:
                    # tokens = power x PowerReduction.
                    "tokens": str(v.get("power", 0) * _power_reduction()),
                }
                for v in page
            ],
            "pagination": _rest_page_response(page_req, page_resp),
        }

    def proposals(m, q, body):
        # Paged like the validators route (shared _paginate engine) and
        # status emitted as the PROPOSAL_STATUS_* enum NAME — the
        # grpc-gateway JSON convention; a bare int here broke clients
        # switch-ing on the string values the sdk emits.
        from celestia_app_tpu_torch.modules.gov import GovKeeper
        from celestia_app_tpu_torch.rpc.grpc_plane import _paginate
        from celestia_app_tpu_torch.state.accounts import BankKeeper
        from celestia_app_tpu_torch.state.staking import StakingKeeper

        with _node_lock(node):
            store = node.app.cms.working
            props = GovKeeper(
                store, StakingKeeper(store), BankKeeper(store)
            ).proposals()
        page_req = _rest_page_request(q)
        page, page_resp = _paginate(props, page_req)
        return {
            "proposals": [
                {
                    "proposal_id": str(p.pid),
                    "status": f"PROPOSAL_STATUS_{p.status.name}",
                }
                for p in page
            ],
            "pagination": _rest_page_response(page_req, page_resp),
        }

    def slashing_params(m, q, body):
        from celestia_app_tpu_torch.modules.slashing.keeper import SlashingKeeper

        with _node_lock(node):
            p = SlashingKeeper(node.app.cms.working).params()
        return {
            "params": {
                "signed_blocks_window": str(p.signed_blocks_window),
                "min_signed_per_window": str(p.min_signed_per_window),
                "downtime_jail_duration":
                    f"{p.downtime_jail_duration_ns / 1e9:.9f}s",
                "slash_fraction_double_sign":
                    str(p.slash_fraction_double_sign),
                "slash_fraction_downtime": str(p.slash_fraction_downtime),
            }
        }

    def min_gas_price(m, q, body):
        from celestia_app_tpu_torch.modules.minfee import MinFeeKeeper

        with _node_lock(node):
            price = MinFeeKeeper(node.app.cms.working).network_min_gas_price()
        return {"network_min_gas_price": str(price)}

    def blob_params(m, q, body):
        with _node_lock(node):
            return {
                "params": {
                    "gas_per_blob_byte": node.app.gas_per_blob_byte,
                    "gov_max_square_size":
                        str(node.app.gov_max_square_size),
                }
            }

    def get_tx(m, q, body):
        txhash = m.group("hash")
        try:
            raw = bytes.fromhex(txhash)
        except ValueError as e:
            raise _BadRequest(f"invalid tx hash: {e}") from e
        with _node_lock(node):
            status = node.tx_status(raw)
        if status is None:
            raise _NotFound(f"tx not found: {txhash}")
        height, code, log = status
        return {
            "tx_response": {
                "height": str(height),
                "txhash": txhash.upper(),
                "code": code,
                "raw_log": log,
            }
        }

    def simulate_tx(m, q, body):
        # POST /cosmos/tx/v1beta1/simulate {"tx_bytes": base64} ->
        # {"gas_info": {...}} on success or a gateway error with the
        # node's log; sdk-waiver semantics (signatures/limits waived,
        # state discarded) via the same App.simulate_tx the gRPC
        # Simulate serves.
        try:
            tx_bytes = base64.b64decode(body["tx_bytes"])
        except (KeyError, TypeError, ValueError) as e:
            raise _BadRequest(f"invalid tx_bytes: {e}") from e
        with _node_lock(node):
            res = node.app.simulate_tx(tx_bytes)
        if res.code != 0:
            raise _BadRequest(f"simulation failed: {res.log}")
        return {
            "gas_info": {
                "gas_wanted": str(res.gas_wanted),
                "gas_used": str(res.gas_used),
            }
        }

    def broadcast_tx(m, q, body):
        try:
            tx_bytes = base64.b64decode(body["tx_bytes"])
        except (KeyError, TypeError, ValueError) as e:
            raise _BadRequest(f"invalid tx_bytes: {e}") from e
        from celestia_app_tpu_torch.trace.context import (
            current_context,
            new_context,
            use_context,
        )
        from celestia_app_tpu_torch.tx import tx_hash

        # Request entry: issue the trace the tx carries through the
        # mempool and into the block that commits it (trace/context.py).
        # When the hop arrived with x-celestia-trace the ingress already
        # ADOPTED it (do_POST) — child it rather than re-minting, so the
        # submit stays one trace across nodes.
        parent = current_context()
        ctx = (
            parent.child(layer="rpc", plane="rest")
            if parent is not None
            else new_context(layer="rpc", plane="rest")
        )
        with use_context(ctx):
            res = node.broadcast(tx_bytes)
        return {
            "tx_response": {
                "txhash": tx_hash(tx_bytes).hex().upper(),
                "code": res.code,
                "raw_log": res.log,
                "gas_wanted": str(res.gas_wanted),
            }
        }

    return [
        ("GET", re.compile(r"^/cosmos/base/tendermint/v1beta1/node_info$"), node_info),
        ("GET", re.compile(r"^/cosmos/base/tendermint/v1beta1/blocks/latest$"), latest_block),
        ("GET", re.compile(r"^/cosmos/auth/v1beta1/accounts/(?P<address>[^/]+)$"), account),
        ("GET", re.compile(r"^/cosmos/bank/v1beta1/balances/(?P<address>[^/]+)$"), balances),
        ("GET", re.compile(r"^/cosmos/bank/v1beta1/balances/(?P<address>[^/]+)/by_denom$"), balance_by_denom),
        ("GET", re.compile(r"^/cosmos/staking/v1beta1/validators$"), validators),
        ("GET", re.compile(r"^/cosmos/gov/v1beta1/proposals$"), proposals),
        ("GET", re.compile(r"^/cosmos/slashing/v1beta1/params$"), slashing_params),
        ("GET", re.compile(r"^/celestia/minfee/v1/min_gas_price$"), min_gas_price),
        ("GET", re.compile(r"^/celestia/blob/v1/params$"), blob_params),
        ("GET", re.compile(r"^/cosmos/tx/v1beta1/txs/(?P<hash>[0-9a-fA-F]+)$"), get_tx),
        ("POST", re.compile(r"^/cosmos/tx/v1beta1/txs$"), broadcast_tx),
        ("POST", re.compile(r"^/cosmos/tx/v1beta1/simulate$"), simulate_tx),
    ]


class _NotFound(Exception):
    pass


class _BadRequest(Exception):
    pass


class _ApiHandler(BaseHTTPRequestHandler):
    routes: list = []

    def log_message(self, fmt, *args):  # quiet
        pass

    def _respond(self, status: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _dispatch(self, method: str, body: dict | None) -> None:
        url = urlparse(self.path)
        query = parse_qs(url.query)
        for verb, pattern, handler in self.routes:
            if verb != method:
                continue
            m = pattern.match(url.path)
            if m is None:
                continue
            try:
                self._respond(200, handler(m, query, body))
            except _NotFound as e:
                self._respond(404, {"code": 5, "message": str(e)})
            except _BadRequest as e:
                self._respond(400, {"code": 3, "message": str(e)})
            except Exception as e:  # noqa: BLE001 — gateway internal error
                from celestia_app_tpu_torch.qos import (
                    QosThrottled,
                    retry_after_header,
                    throttle_body,
                )

                if isinstance(e, QosThrottled):
                    # Per-tenant QoS refusal: 429 + qos.py's ONE
                    # canonical body — the same bytes the JSON-RPC plane
                    # serves and the gRPC plane carries as its
                    # RESOURCE_EXHAUSTED detail.
                    raw = throttle_body(e)
                    self.send_response(429)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(raw)))
                    self.send_header("Retry-After", retry_after_header(e))
                    self.end_headers()
                    self.wfile.write(raw)
                    return
                self._respond(500, {"code": 13,
                                    "message": f"{type(e).__name__}: {e}"})
            return
        self._respond(501, {"code": 12,
                            "message": f"Not Implemented: {url.path}"})

    def do_GET(self):  # noqa: N802 — http.server API
        # Observability first: /metrics must serve the SAME bytes as the
        # other planes (shared handler), and none of these paths collide
        # with the cosmos route space.  An x-celestia-trace header is
        # ADOPTED (same trace_id, fresh span_id + this node's node_id)
        # so remote fetches stitch into the caller's trace.
        from celestia_app_tpu_torch.trace.exposition import (
            handle_observability_get_adopted,
            send_observability_response,
        )

        resp = handle_observability_get_adopted(self, plane="rest")
        if resp is not None:
            send_observability_response(self, resp)
            return
        self._dispatch("GET", None)

    def do_POST(self):  # noqa: N802
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(length)) if length else {}
        except (ValueError, json.JSONDecodeError):
            self._respond(400, {"code": 3, "message": "invalid JSON body"})
            return
        # Adopt the peer's trace context (if any) around route dispatch
        # so broadcast_tx childs it instead of re-minting (adopt_context
        # — see trace/context.py; adopt_or_new is the strict variant).
        from celestia_app_tpu_torch.trace.context import (
            TRACE_HEADER,
            adopt_context,
            use_context,
        )

        ctx = adopt_context(self.headers.get(TRACE_HEADER))
        if ctx is not None:
            with use_context(ctx):
                self._dispatch("POST", body)
        else:
            self._dispatch("POST", body)


@dataclass
class ApiGateway:
    httpd: ThreadingHTTPServer
    port: int

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def serve_api(node, host: str = "127.0.0.1", port: int = 0) -> ApiGateway:
    """Start the REST gateway for `node`; returns the live server."""
    handler = type("BoundApiHandler", (_ApiHandler,),
                   {"routes": _routes(node)})
    httpd = ThreadingHTTPServer((host, port), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return ApiGateway(httpd, httpd.server_address[1])
