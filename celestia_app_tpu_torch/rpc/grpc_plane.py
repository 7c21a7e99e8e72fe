"""gRPC serving plane: the cosmos service surface ecosystem clients speak.

The reference node serves gRPC alongside RPC/API
(the reference's app/app.go:712-735; testnode wires all three,
test/util/testnode/network.go:38-43).  This plane exposes the same service
shapes over real gRPC (grpcio, generic byte-level handlers — no codegen;
message codecs are hand-rolled on encoding/proto like the rest of the wire
layer, protoc-cross-validated by tests/test_proto_wire.py):

  cosmos.tx.v1beta1.Service/BroadcastTx|GetTx|Simulate    tx lifecycle
  cosmos.auth.v1beta1.Query/Account                number/sequence for signing
  cosmos.bank.v1beta1.Query/Balance                spot balance
  cosmos.staking.v1beta1.Query/Validators|Delegation      bonded set (paged)
  cosmos.gov.v1beta1.Query/Proposals               paged proposal list
  cosmos.distribution.v1beta1.Query/DelegationRewards|CommunityPool
  cosmos.slashing.v1beta1.Query/SigningInfo|SigningInfos|Params
  celestia.blob.v1.Query/Params                    blob module params
  celestia.minfee.v1.Query/NetworkMinGasPrice      network fee floor
  celestia.signal.v1.Query/VersionTally            upgrade signal tally
  celestia.qgb.v1.Query/AttestationRequestByNonce|LatestAttestationNonce|
      EVMAddress                                   blobstream relayer reads
  cosmos.base.tendermint.v1beta1.Service/GetLatestBlock|GetNodeInfo
  celestia.tpu.subscription.v1.Subscription/WaitTx long-poll tx commit
      (this framework's analog of Tendermint's websocket /subscribe —
      the reference serves that from celestia-core RPC, not gRPC)
  celestia.tpu.das.v1.Das/GetShareProof|GetSharesByNamespace|
      GetAttestation                              the DAS sampling surface
      (serve/): responses carry the canonical serve/api.render payload
      bytes, byte-identical to the HTTP planes' GET /das/* bodies

List queries speak cosmos.base.query.v1beta1 PageRequest/PageResponse
(offset/limit/count_total/reverse; next_key is an opaque offset cursor).

Alongside the gRPC listener, `serve_grpc` starts a health/debug HTTP
sidecar (GrpcPlane.debug_url) mounting the shared observability handler —
GET /metrics, /trace_tables[/<name>], /healthz — byte-identical to the
JSON-RPC and REST planes' exposition (trace/exposition.py).

`GrpcNode` is the client half: it implements the node surface TxClient
consumes (broadcast / query_account / tx_status / validators / chain_id),
so txsim and user.TxClient run unchanged against a gRPC endpoint — the
done-criterion of VERDICT r3 next-step #6.

The port's copy of celestia_app_tpu/rpc/grpc_plane.py, with one deliberate
difference: a device.DeviceFault raised by a handler (a square extended on
the card for a DAS payload, a CheckTx or a proof) aborts the call with
status INTERNAL and the detail "DeviceFault: <message>", as the JSON-RPC
plane answers it with a 500 naming it, where the JAX plane lets grpcio
answer an opaque UNKNOWN.  `grpc` is imported only where the JAX module
imports it (`serve_grpc`, `GrpcNode`), so the byte-level handlers
(`_handlers`) and the pagination codecs the REST gateway shares import and
run without it.
"""

from __future__ import annotations

from concurrent import futures
from dataclasses import dataclass

from celestia_app_tpu_torch.encoding.proto import (
    WIRE_LEN,
    WIRE_VARINT,
    decode_fields,
    encode_bytes_field,
    encode_varint_field,
)

# --- message codecs (cosmos protos, standard field numbers) ----------------


def _tx_response(height: int, txhash: str, code: int, raw_log: str,
                 gas_wanted: int = 0, gas_used: int = 0) -> bytes:
    """cosmos.base.abci.v1beta1.TxResponse {height=1, txhash=2, code=4,
    raw_log=6, gas_wanted=10, gas_used=11}."""
    out = b""
    if height:
        out += encode_varint_field(1, height)
    out += encode_bytes_field(2, txhash.encode())
    if code:
        out += encode_varint_field(4, code)
    if raw_log:
        out += encode_bytes_field(6, raw_log.encode())
    if gas_wanted:
        out += encode_varint_field(10, gas_wanted)
    if gas_used:
        out += encode_varint_field(11, gas_used)
    return out


def _parse_tx_response(raw: bytes) -> dict:
    out = {"height": 0, "txhash": "", "code": 0, "raw_log": "",
           "gas_wanted": 0, "gas_used": 0}
    for num, wt, val in decode_fields(raw):
        if num == 1 and wt == WIRE_VARINT:
            out["height"] = val
        elif num == 2 and wt == WIRE_LEN:
            out["txhash"] = val.decode()
        elif num == 4 and wt == WIRE_VARINT:
            out["code"] = val
        elif num == 6 and wt == WIRE_LEN:
            out["raw_log"] = val.decode()
        elif num == 10 and wt == WIRE_VARINT:
            out["gas_wanted"] = val
        elif num == 11 and wt == WIRE_VARINT:
            out["gas_used"] = val
    return out


def _field_str(raw: bytes, num: int) -> str:
    for n, wt, val in decode_fields(raw):
        if n == num and wt == WIRE_LEN:
            return val.decode()
    return ""


def _field_bytes(raw: bytes, num: int) -> bytes:
    for n, wt, val in decode_fields(raw):
        if n == num and wt == WIRE_LEN:
            return val
    return b""


def _field_int(raw: bytes, num: int) -> int:
    for n, wt, val in decode_fields(raw):
        if n == num and wt == WIRE_VARINT:
            return val
    return 0


# --- pagination (cosmos.base.query.v1beta1) --------------------------------


def _parse_page_request(req: bytes, field_num: int) -> dict:
    """PageRequest {key=1, offset=2, limit=3, count_total=4, reverse=5}
    embedded at `field_num` of the enclosing query request. The `key`
    cursor is this plane's next_key from the previous page (an opaque
    offset, as the sdk's store keys are opaque to clients)."""
    page = _field_bytes(req, field_num)
    out = {"offset": 0, "limit": 0, "count_total": False, "reverse": False}
    if not page:
        return out
    for n, wt, val in decode_fields(page):
        if n == 1 and wt == WIRE_LEN and val:
            try:
                out["offset"] = int(val.decode())
            except ValueError:
                pass
        elif n == 2 and wt == WIRE_VARINT:
            out["offset"] = val
        elif n == 3 and wt == WIRE_VARINT:
            out["limit"] = val
        elif n == 4 and wt == WIRE_VARINT:
            out["count_total"] = bool(val)
        elif n == 5 and wt == WIRE_VARINT:
            out["reverse"] = bool(val)
    return out


def _paginate(items: list, page: dict) -> tuple[list, bytes]:
    """Apply a parsed PageRequest; returns (page_items, PageResponse bytes
    {next_key=1, total=2})."""
    if page["reverse"]:
        items = list(reversed(items))
    total = len(items)
    start = min(max(page["offset"], 0), total)  # clamp hostile cursors
    end = total if not page["limit"] else min(start + page["limit"], total)
    resp = b""
    if end < total:
        resp += encode_bytes_field(1, str(end).encode())
    if page["count_total"]:
        resp += encode_varint_field(2, total)
    return items[start:end], resp


def encode_page_request(offset: int = 0, limit: int = 0,
                        count_total: bool = False, reverse: bool = False,
                        key: bytes = b"") -> bytes:
    out = b""
    if key:
        out += encode_bytes_field(1, key)
    if offset:
        out += encode_varint_field(2, offset)
    if limit:
        out += encode_varint_field(3, limit)
    if count_total:
        out += encode_varint_field(4, 1)
    if reverse:
        out += encode_varint_field(5, 1)
    return out


def _parse_page_response(raw: bytes) -> dict:
    return {"next_key": _field_bytes(raw, 1), "total": _field_int(raw, 2)}


# --- server ----------------------------------------------------------------

# Cap on concurrently PARKED WaitTx long-polls (see wait_tx handler); kept
# below serve_grpc's worker-pool size so subscriptions can never starve
# the unary queries sharing the pool.
_WAIT_TX_MAX_PARKED = 8


class _Abort(Exception):
    """Handler-raised gRPC failure: carries the StatusCode NAME (the grpc
    module is imported lazily — serve_grpc resolves the name to the real
    code when it aborts the RPC) plus human-readable details.  Without
    this, a malformed client input surfaced as an opaque UNKNOWN wrapping
    a Python traceback."""

    def __init__(self, code: str, details: str):
        self.code = code
        self.details = details
        super().__init__(details)


def _qos_abort(e: Exception) -> Exception:
    """Map a per-tenant QoS refusal (qos.QosThrottled) onto the typed
    RESOURCE_EXHAUSTED abort whose detail string is qos.py's ONE
    canonical payload — the very bytes the HTTP planes serve as their
    429 bodies, so the three planes stay byte-identical.  Any other
    exception passes through unchanged."""
    from celestia_app_tpu_torch.qos import QosThrottled, throttle_body

    if isinstance(e, QosThrottled):
        return _Abort("RESOURCE_EXHAUSTED", throttle_body(e).decode())
    return e


def _tx_hash_bytes(txhash: str) -> bytes:
    """Validate and decode a client-supplied hex tx hash, stripping
    whitespace and accepting either case; INVALID_ARGUMENT on anything
    else (empty, odd length, non-hex) instead of a ValueError-backed
    opaque gRPC error."""
    cleaned = txhash.strip()
    if not cleaned:
        raise _Abort("INVALID_ARGUMENT", "empty tx hash")
    try:
        return bytes.fromhex(cleaned)
    except ValueError:
        raise _Abort(
            "INVALID_ARGUMENT",
            f"malformed tx hash {cleaned[:80]!r}: expected hex",
        ) from None


def _handlers(node) -> dict:
    """method path suffix -> unary handler(bytes) -> bytes.

    State reads hold `node.lock` (when the node has one): gRPC workers run
    concurrently with the proposer loop, and the unlocked TestNode query
    methods read `cms.working` mid-commit — the JSON-RPC plane's rpc_*
    wrappers take the same lock (rpc/server.py:581,946)."""
    from contextlib import nullcontext

    def node_lock():
        return getattr(node, "lock", None) or nullcontext()

    def broadcast_tx(req: bytes) -> bytes:
        # BroadcastTxRequest {tx_bytes=1, mode=2}; mode BROADCAST_MODE_SYNC
        # semantics: CheckTx result, inclusion async (the only mode the
        # reference chain's clients rely on; pkg/user polls GetTx after).
        from celestia_app_tpu_torch.trace.context import (
            current_context,
            new_context,
            use_context,
        )

        tx_bytes = _field_bytes(req, 1)
        # Request entry: the trace the tx carries to the block that
        # commits it (trace/context.py; resolvable via /trace_tables/spans
        # on the debug sidecar).  serve_grpc's wrapper has already ADOPTED
        # an incoming x-celestia-trace metadata entry (adopt_context) —
        # child it so the cross-node submit stays one trace.
        parent = current_context()
        ctx = (
            parent.child(layer="rpc", plane="grpc")
            if parent is not None
            else new_context(layer="rpc", plane="grpc")
        )
        with use_context(ctx):
            try:
                res = node.broadcast(tx_bytes)
            except Exception as e:
                raise _qos_abort(e) from None
        import hashlib

        txhash = hashlib.sha256(tx_bytes).hexdigest().upper()
        return encode_bytes_field(
            1,
            _tx_response(0, txhash, res.code, res.log, res.gas_wanted,
                         getattr(res, "gas_used", 0)),
        )

    def get_tx(req: bytes) -> bytes:
        # GetTxRequest {hash=1 (hex)}; NotFound -> empty response (the
        # client treats an absent tx_response as "not yet included").
        # Same up-front hash validation as WaitTx: malformed hex answers
        # INVALID_ARGUMENT, never an opaque ValueError-backed error.
        txhash = _field_str(req, 1).strip()
        raw_hash = _tx_hash_bytes(txhash)
        with node_lock():
            status = node.tx_status(raw_hash)
        if status is None:
            return b""
        height, code, log = status
        return encode_bytes_field(2, _tx_response(height, txhash, code, log))

    def query_account(req: bytes) -> bytes:
        # QueryAccountRequest {address=1} -> {account=1 Any(BaseAccount)}.
        addr = _field_str(req, 1)
        with node_lock():
            acc = node.query_account(addr)
        if acc is None:
            return b""
        base = (
            encode_bytes_field(1, acc.address.encode())
            + encode_varint_field(3, acc.account_number)
            + encode_varint_field(4, acc.sequence)
        )
        any_acc = encode_bytes_field(
            1, b"/cosmos.auth.v1beta1.BaseAccount"
        ) + encode_bytes_field(2, base)
        return encode_bytes_field(1, any_acc)

    def query_balance(req: bytes) -> bytes:
        # QueryBalanceRequest {address=1, denom=2} -> {balance=1 Coin}.
        from celestia_app_tpu_torch.state.accounts import BankKeeper

        addr = _field_str(req, 1)
        denom = _field_str(req, 2) or "utia"
        with node_lock():
            amount = BankKeeper(node.app.cms.working).balance(addr, denom)
        coin = encode_bytes_field(1, denom.encode()) + encode_bytes_field(
            2, str(amount).encode()
        )
        return encode_bytes_field(1, coin)

    def query_validators(req: bytes) -> bytes:
        # QueryValidatorsRequest {status=1, pagination=2} -> {validators=1
        # repeated Validator {operator_address=1, tokens=5}, pagination=2}
        # — the fields txsim's stake sequence reads, paged.  tokens uses
        # the sdk convention (power x PowerReduction), matching the REST
        # plane; the two previously disagreed (REST utia vs gRPC raw
        # power), which skewed any client mixing the planes by 10^6.
        from celestia_app_tpu_torch.state.staking import POWER_REDUCTION

        with node_lock():
            vals = node.validators()
        page_vals, page_resp = _paginate(vals, _parse_page_request(req, 2))
        out = b""
        for v in page_vals:
            tokens = v.get("power", 0) * POWER_REDUCTION
            val = encode_bytes_field(
                1, v["address"].encode()
            ) + encode_bytes_field(5, str(tokens).encode())
            out += encode_bytes_field(1, val)
        if page_resp:
            out += encode_bytes_field(2, page_resp)
        return out

    def get_latest_block(req: bytes) -> bytes:
        # GetLatestBlockResponse {block=2 {header=1 {chain_id=2, height=3}}}.
        header = encode_bytes_field(2, node.chain_id.encode()) + encode_varint_field(
            3, node.app.height
        )
        return encode_bytes_field(2, encode_bytes_field(1, header))

    def simulate(req: bytes) -> bytes:
        # SimulateRequest {tx_bytes=2} -> SimulateResponse {gas_info=1
        # {gas_wanted=1, gas_used=2}}: the gas-estimation endpoint
        # cosmjs/TxClient call before signing for real (sig verification
        # and the gas limit waived, state discarded).
        tx_bytes = _field_bytes(req, 2)
        with node_lock():
            res = node.app.simulate_tx(tx_bytes)
        if res.code != 0:
            # Keep the unary shape and report failure through an absent
            # gas_info + Result.log (cosmos.base.abci.v1beta1.Result
            # {data=1, log=2, events=3}).
            return encode_bytes_field(
                2, encode_bytes_field(2, res.log.encode())
            )
        gas_info = encode_varint_field(1, res.gas_wanted) + encode_varint_field(
            2, res.gas_used
        )
        return encode_bytes_field(1, gas_info)

    def get_node_info(req: bytes) -> bytes:
        # GetNodeInfoResponse {default_node_info=1 {network=4, version=5,
        # moniker=7}} — the fields cosmjs reads on connect.
        info = (
            encode_bytes_field(4, node.chain_id.encode())
            + encode_bytes_field(5, b"celestia-app-tpu")
            + encode_bytes_field(7, b"tpu-node")
        )
        return encode_bytes_field(1, info)

    def query_delegation(req: bytes) -> bytes:
        # QueryDelegationRequest {delegator_addr=1, validator_addr=2} ->
        # {delegation_response=1 {delegation=1 {delegator_address=1,
        # validator_address=2, shares=3}, balance=2 Coin}} — the fields
        # staking dashboards read; shares reported 1:1 with tokens (this
        # framework's delegation records are token-denominated).
        from celestia_app_tpu_torch.state.staking import StakingKeeper

        delegator = _field_str(req, 1)
        validator = _field_str(req, 2)
        with node_lock():
            amount = StakingKeeper(node.app.cms.working).delegation(
                delegator, validator
            )
        if amount == 0:
            return b""
        # shares: gogoproto Dec wire format is the 10^18-scaled integer's
        # plain digits (big.Int text), NOT a human decimal string — a dot
        # would fail Go clients' Dec.Unmarshal.  Shares track tokens 1:1.
        delegation = (
            encode_bytes_field(1, delegator.encode())
            + encode_bytes_field(2, validator.encode())
            + encode_bytes_field(3, str(amount * 10**18).encode())
        )
        balance = encode_bytes_field(1, b"utia") + encode_bytes_field(
            2, str(amount).encode()
        )
        return encode_bytes_field(
            1,
            encode_bytes_field(1, delegation) + encode_bytes_field(2, balance),
        )

    def query_proposals(req: bytes) -> bytes:
        # QueryProposalsRequest -> {proposals=1 repeated Proposal
        # {proposal_id=1, status=3}} — the id/status pair explorers poll
        # (field 2 is the content Any in cosmos.gov.v1beta1.Proposal and
        # must not be squatted by a varint).
        from celestia_app_tpu_torch.modules.gov import GovKeeper
        from celestia_app_tpu_torch.state.staking import StakingKeeper

        with node_lock():
            store = node.app.cms.working
            from celestia_app_tpu_torch.state.accounts import BankKeeper

            props = GovKeeper(
                store, StakingKeeper(store), BankKeeper(store)
            ).proposals()
        # gov v1beta1 QueryProposalsRequest carries pagination at field 4.
        page_props, page_resp = _paginate(props, _parse_page_request(req, 4))
        out = b""
        for p in page_props:
            out += encode_bytes_field(
                1,
                encode_varint_field(1, p.pid)
                + encode_varint_field(3, int(p.status)),
            )
        if page_resp:
            out += encode_bytes_field(2, page_resp)
        return out

    def query_blob_params(req: bytes) -> bytes:
        # celestia.blob.v1 QueryParamsResponse {params=1 {
        # gas_per_blob_byte=1, gov_max_square_size=2}}.
        with node_lock():
            params = encode_varint_field(
                1, node.app.gas_per_blob_byte
            ) + encode_varint_field(2, node.app.gov_max_square_size)
        return encode_bytes_field(1, params)

    def query_min_gas_price(req: bytes) -> bytes:
        # celestia.minfee.v1 QueryNetworkMinGasPriceResponse
        # {network_min_gas_price=1 Dec} (x/minfee/query.proto). Dec rides
        # the wire as the 10^18-scaled integer's digits (gogoproto Dec).
        from celestia_app_tpu_torch.modules.minfee import MinFeeKeeper

        with node_lock():
            price = MinFeeKeeper(node.app.cms.working).network_min_gas_price()
        return encode_bytes_field(1, str(price.raw).encode())

    def query_version_tally(req: bytes) -> bytes:
        # celestia.signal.v1 QueryVersionTallyRequest {version=1} ->
        # {voting_power=1, threshold_power=2, total_voting_power=3}
        # (x/signal/query.proto).
        from celestia_app_tpu_torch.modules.signal.keeper import SignalKeeper
        from celestia_app_tpu_torch.state.staking import StakingKeeper

        version = _field_int(req, 1)
        with node_lock():
            store = node.app.cms.working
            power, threshold, total = SignalKeeper(
                store, StakingKeeper(store)
            ).version_tally(version)
        return (
            encode_varint_field(1, power)
            + encode_varint_field(2, threshold)
            + encode_varint_field(3, total)
        )

    def _blobstream_keeper(store):
        from celestia_app_tpu_torch.modules.blobstream.keeper import BlobstreamKeeper
        from celestia_app_tpu_torch.state.staking import StakingKeeper

        return BlobstreamKeeper(store, StakingKeeper(store))

    def query_attestation_by_nonce(req: bytes) -> bytes:
        # celestia.qgb.v1 QueryAttestationRequestByNonceRequest {nonce=1}
        # -> {attestation=1 Any{type_url=1, value=2}}; empty when unknown.
        nonce = _field_int(req, 1)
        with node_lock():
            att = _blobstream_keeper(node.app.cms.working).get_attestation(nonce)
        if att is None:
            return b""
        type_url = ("/celestia.qgb.v1.Valset" if att.KIND == 1
                    else "/celestia.qgb.v1.DataCommitment")
        any_att = encode_bytes_field(1, type_url.encode()) + encode_bytes_field(
            2, att.marshal()
        )
        return encode_bytes_field(1, any_att)

    def query_latest_attestation_nonce(req: bytes) -> bytes:
        # celestia.qgb.v1 QueryLatestAttestationNonceResponse {nonce=1}.
        with node_lock():
            nonce = _blobstream_keeper(node.app.cms.working).latest_nonce()
        return encode_varint_field(1, nonce) if nonce else b""

    def query_evm_address(req: bytes) -> bytes:
        # celestia.qgb.v1 QueryEVMAddressRequest {validator_address=1} ->
        # {evm_address=1}; empty when unregistered.
        validator = _field_str(req, 1)
        with node_lock():
            evm = _blobstream_keeper(node.app.cms.working).evm_address(validator)
        return encode_bytes_field(1, evm.encode()) if evm else b""

    def query_delegation_rewards(req: bytes) -> bytes:
        # cosmos.distribution.v1beta1 QueryDelegationRewardsRequest
        # {delegator_address=1, validator_address=2} -> {rewards=1 repeated
        # DecCoin {denom=1, amount=2 Dec}}.
        from celestia_app_tpu_torch.modules.distribution.keeper import (
            DistributionKeeper,
        )
        from celestia_app_tpu_torch.state.staking import StakingKeeper

        delegator = _field_str(req, 1)
        validator = _field_str(req, 2)
        with node_lock():
            store = node.app.cms.working
            pending = DistributionKeeper(store).pending_rewards(
                StakingKeeper(store), delegator, validator
            )
        if not pending:
            return b""
        coin = encode_bytes_field(1, b"utia") + encode_bytes_field(
            2, str(pending * 10**18).encode()
        )
        return encode_bytes_field(1, coin)

    def query_community_pool(req: bytes) -> bytes:
        # QueryCommunityPoolResponse {pool=1 repeated DecCoin}.
        from celestia_app_tpu_torch.modules.distribution.keeper import (
            DistributionKeeper,
        )

        with node_lock():
            pool = DistributionKeeper(node.app.cms.working).community_pool()
        if not pool.raw:
            return b""
        coin = encode_bytes_field(1, b"utia") + encode_bytes_field(
            2, str(pool.raw).encode()
        )
        return encode_bytes_field(1, coin)

    def _signing_info_msg(addr: str, info) -> bytes:
        # cosmos.slashing.v1beta1 ValidatorSigningInfo {address=1,
        # index_offset=3, jailed_until=4 Timestamp{seconds=1, nanos=2},
        # tombstoned=5, missed_blocks_counter=6}.
        out = encode_bytes_field(1, addr.encode())
        if info.index_offset:
            out += encode_varint_field(3, info.index_offset)
        if info.jailed_until_ns:
            ts = encode_varint_field(1, info.jailed_until_ns // 10**9)
            nanos = info.jailed_until_ns % 10**9
            if nanos:
                ts += encode_varint_field(2, nanos)
            out += encode_bytes_field(4, ts)
        if info.tombstoned:
            out += encode_varint_field(5, 1)
        if info.missed_blocks:
            out += encode_varint_field(6, info.missed_blocks)
        return out

    def query_signing_info(req: bytes) -> bytes:
        # QuerySigningInfoRequest {cons_address=1} -> {val_signing_info=1}.
        from celestia_app_tpu_torch.modules.slashing.keeper import SlashingKeeper

        addr = _field_str(req, 1)
        with node_lock():
            info = SlashingKeeper(node.app.cms.working).signing_info(addr)
        return encode_bytes_field(1, _signing_info_msg(addr, info))

    def query_signing_infos(req: bytes) -> bytes:
        # QuerySigningInfosRequest {pagination=1} -> {info=1 repeated,
        # pagination=2}.
        from celestia_app_tpu_torch.modules.slashing.keeper import SlashingKeeper

        with node_lock():
            infos = SlashingKeeper(node.app.cms.working).signing_infos()
        page_infos, page_resp = _paginate(infos, _parse_page_request(req, 1))
        out = b""
        for addr, info in page_infos:
            out += encode_bytes_field(1, _signing_info_msg(addr, info))
        if page_resp:
            out += encode_bytes_field(2, page_resp)
        return out

    def query_slashing_params(req: bytes) -> bytes:
        # QueryParamsResponse {params=1 {signed_blocks_window=1,
        # min_signed_per_window=2 Dec, downtime_jail_duration=3
        # Duration{seconds=1, nanos=2}, slash_fraction_double_sign=4 Dec,
        # slash_fraction_downtime=5 Dec}}.
        from celestia_app_tpu_torch.modules.slashing.keeper import SlashingKeeper

        with node_lock():
            p = SlashingKeeper(node.app.cms.working).params()
        dur = encode_varint_field(1, p.downtime_jail_duration_ns // 10**9)
        nanos = p.downtime_jail_duration_ns % 10**9
        if nanos:
            dur += encode_varint_field(2, nanos)
        params = (
            encode_varint_field(1, p.signed_blocks_window)
            + encode_bytes_field(2, str(p.min_signed_per_window.raw).encode())
            + encode_bytes_field(3, dur)
            + encode_bytes_field(4, str(p.slash_fraction_double_sign.raw).encode())
            + encode_bytes_field(5, str(p.slash_fraction_downtime.raw).encode())
        )
        return encode_bytes_field(1, params)

    # Parked WaitTx waiters are capped below the worker-pool size so
    # long-polls can never starve the unary queries sharing the pool;
    # past the cap a waiter degrades to an immediate status check (the
    # client sees a fast not-yet-committed answer and may re-subscribe).
    import threading

    wait_slots = threading.Semaphore(_WAIT_TX_MAX_PARKED)

    def wait_tx(req: bytes) -> bytes:
        # Subscription service (this framework's long-poll analog of the
        # Tendermint websocket /subscribe tm.event='Tx'; the reference
        # serves that from celestia-core's RPC, not gRPC). Request
        # {hash=1 hex, timeout_ms=2}; response {tx_response=2 TxResponse}
        # mirroring GetTxResponse so clients share parsing; empty on
        # timeout. Deliberately NOT under node_lock — the wait parks on
        # the commit event and would deadlock the proposer loop.
        # Validate the client hex BEFORE any fromhex: malformed hashes
        # answer INVALID_ARGUMENT, not an opaque ValueError-backed error.
        txhash = _field_str(req, 1).strip()
        raw_hash = _tx_hash_bytes(txhash)
        timeout_ms = _field_int(req, 2)
        if timeout_ms <= 0:
            # Absent/zero timeout: immediate status check, no park (proto3
            # cannot distinguish the two, so 0 must not mean "default").
            status = node.tx_status(raw_hash)
            if status is None:
                return b""
            height, code, log = status
            return encode_bytes_field(
                2, _tx_response(height, txhash, code, log))
        if wait_slots.acquire(blocking=False):
            try:
                status = node.wait_tx(
                    raw_hash, min(timeout_ms, 110_000) / 1000.0
                )
            finally:
                wait_slots.release()
        else:  # all park slots busy: degrade to a poll-style check
            status = node.tx_status(raw_hash)
        if status is None:
            return b""
        height, code, log = status
        return encode_bytes_field(2, _tx_response(height, txhash, code, log))

    def _node_das_provider():
        get = getattr(node, "das_provider", None)
        if get is None:
            raise _Abort(
                "UNIMPLEMENTED", "this node serves no DAS surface (serve/)"
            )
        return get()

    def _das_payload(build, kind: str) -> bytes:
        from celestia_app_tpu_torch.serve.api import UnknownHeight
        from celestia_app_tpu_torch.serve.heal import HealingInProgress
        from celestia_app_tpu_torch.serve.sampler import (
            BadProofDetected,
            ShareWithheld,
        )

        try:
            payload = build()
        except UnknownHeight as e:
            raise _Abort("NOT_FOUND", str(e)) from None
        except HealingInProgress as e:
            # The HTTP planes' 503 + Retry-After: the height is mid-heal
            # (serve/heal.py) — RETRYABLE, never the terminal
            # FAILED_PRECONDITION/DATA_LOSS the detections answer.  A
            # client that backs off and retries lands on the healed
            # height.
            raise _Abort("UNAVAILABLE", str(e)) from None
        except ShareWithheld as e:
            # The HTTP planes' 410 Gone: the share is committed but being
            # withheld — the light client's detection signal, distinct
            # from NOT_FOUND (height unknown) and from INVALID_ARGUMENT
            # (ShareWithheld is a LookupError, so without this clause it
            # would escape as an opaque UNKNOWN).
            raise _Abort(
                "FAILED_PRECONDITION", f"withholding detected: {e}"
            ) from None
        except BadProofDetected as e:
            # The HTTP planes' 502: committed root and served square
            # disagree — caught at the verification gate.  Must precede
            # the ValueError clause (BadProofDetected subclasses it):
            # a detected attack is not a malformed client request.
            raise _Abort("DATA_LOSS", str(e)) from None
        except (TypeError, ValueError) as e:
            raise _Abort("INVALID_ARGUMENT", str(e)) from None
        except Exception as e:
            # The HTTP planes' 429: a per-tenant proof-rate limit refused
            # this read (qos.py) — RESOURCE_EXHAUSTED carrying the same
            # canonical bytes.  Anything else keeps propagating.
            raise _qos_abort(e) from None
        from celestia_app_tpu_torch.serve.api import count_served, render

        # Counted where the payload dict is in hand: the per-tenant
        # (capped namespace) label rides the same counter on every plane.
        count_served("grpc", kind, payload)
        return encode_bytes_field(1, render(payload))

    def das_share_proof(req: bytes) -> bytes:
        # celestia.tpu.das.v1 GetShareProofRequest {height=1, row=2,
        # col=3, axis=4 ("row" default / "col")} -> {payload=1 bytes}:
        # the canonical serve/api.render bytes, so the gRPC answer is
        # byte-identical to the GET /das/share_proof body on the HTTP
        # planes.
        provider = _node_das_provider()
        height, row, col = (
            _field_int(req, 1), _field_int(req, 2), _field_int(req, 3)
        )
        axis = _field_str(req, 4) or "row"
        return _das_payload(
            lambda: provider.share_proof_payload(height, row, col, axis=axis),
            "share_proof",
        )

    def das_shares_by_namespace(req: bytes) -> bytes:
        # GetSharesByNamespaceRequest {height=1, namespace=2 (29-byte
        # hex string)} -> {payload=1 bytes}.
        provider = _node_das_provider()
        height, ns_hex = _field_int(req, 1), _field_str(req, 2)
        return _das_payload(
            lambda: provider.shares_payload(height, ns_hex), "shares"
        )

    def das_attestation(req: bytes) -> bytes:
        # GetAttestationRequest {height=1, samples=2 (comma-joined
        # row:col[:axis] spec)} -> {payload=1 bytes}: the canonical
        # serve/api.render bytes of the deduped multiproof attestation —
        # byte-identical to the GET /das/attestation body on the HTTP
        # planes.
        provider = _node_das_provider()
        height, samples = _field_int(req, 1), _field_str(req, 2)
        return _das_payload(
            lambda: provider.attestation_payload(height, samples),
            "attestation",
        )

    return {
        "cosmos.tx.v1beta1.Service": {
            "BroadcastTx": broadcast_tx,
            "GetTx": get_tx,
            "Simulate": simulate,
        },
        "cosmos.auth.v1beta1.Query": {"Account": query_account},
        "cosmos.bank.v1beta1.Query": {"Balance": query_balance},
        "cosmos.staking.v1beta1.Query": {
            "Validators": query_validators,
            "Delegation": query_delegation,
        },
        "cosmos.gov.v1beta1.Query": {"Proposals": query_proposals},
        "celestia.blob.v1.Query": {"Params": query_blob_params},
        "celestia.minfee.v1.Query": {
            "NetworkMinGasPrice": query_min_gas_price,
        },
        "celestia.signal.v1.Query": {"VersionTally": query_version_tally},
        "celestia.qgb.v1.Query": {
            "AttestationRequestByNonce": query_attestation_by_nonce,
            "LatestAttestationNonce": query_latest_attestation_nonce,
            "EVMAddress": query_evm_address,
        },
        "cosmos.distribution.v1beta1.Query": {
            "DelegationRewards": query_delegation_rewards,
            "CommunityPool": query_community_pool,
        },
        "cosmos.slashing.v1beta1.Query": {
            "SigningInfo": query_signing_info,
            "SigningInfos": query_signing_infos,
            "Params": query_slashing_params,
        },
        "cosmos.base.tendermint.v1beta1.Service": {
            "GetLatestBlock": get_latest_block,
            "GetNodeInfo": get_node_info,
        },
        "celestia.tpu.subscription.v1.Subscription": {"WaitTx": wait_tx},
        "celestia.tpu.das.v1.Das": {
            "GetShareProof": das_share_proof,
            "GetSharesByNamespace": das_shares_by_namespace,
            "GetAttestation": das_attestation,
        },
    }


@dataclass
class GrpcPlane:
    server: object
    port: int
    debug_httpd: object = None
    debug_port: int = 0

    @property
    def target(self) -> str:
        return f"127.0.0.1:{self.port}"

    @property
    def debug_url(self) -> str:
        return f"http://127.0.0.1:{self.debug_port}"

    def stop(self, grace: float = 0.5) -> None:
        self.server.stop(grace)
        if self.debug_httpd is not None:
            self.debug_httpd.shutdown()
            self.debug_httpd.server_close()


def _serve_debug_port(host: str, port: int):
    """The gRPC plane's health/debug sidecar: gRPC has no GET surface, so
    the shared observability handler (trace/exposition.py — /metrics,
    /trace_tables, /healthz) rides a tiny HTTP server next to it, the same
    bytes the JSON-RPC and REST planes serve."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from celestia_app_tpu_torch.trace.exposition import (
        handle_observability_get_adopted,
        send_observability_404,
        send_observability_response,
    )

    class _DebugHandler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def do_GET(self):  # noqa: N802 — http.server API
            # Adopts an incoming x-celestia-trace header, same as the
            # other planes; 404s carry Content-Length so keep-alive
            # scrapers do not stall on the connection.
            resp = handle_observability_get_adopted(self, plane="grpc")
            if resp is None:
                send_observability_404(self)
                return
            send_observability_response(self, resp)

    httpd = ThreadingHTTPServer((host, port), _DebugHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def serve_grpc(node, port: int = 0, max_workers: int = 16,
               debug_port: int | None = 0) -> GrpcPlane:
    """Start the gRPC plane for a node; returns the live server + port.

    `debug_port` (default: ephemeral) also starts the plane's health/debug
    HTTP sidecar serving the shared /metrics, /trace_tables, and /healthz;
    pass None to disable it."""
    import grpc

    ident = lambda b: b  # byte-level (de)serialization; codecs above

    def wrap(fn):
        from celestia_app_tpu_torch.device import DeviceFault
        from celestia_app_tpu_torch.trace.context import (
            TRACE_HEADER,
            adopt_context,
            use_context,
        )

        def handler(req, ctx):
            # Cross-node propagation: x-celestia-trace rides gRPC
            # invocation metadata; ADOPT it (same trace_id, fresh
            # span_id, this node's node_id) so handler spans stitch
            # into the caller's trace.
            wire = None
            for key, value in ctx.invocation_metadata() or ():
                if key == TRACE_HEADER:
                    wire = value
                    break
            trace_ctx = adopt_context(wire)
            try:
                if trace_ctx is not None:
                    with use_context(trace_ctx):
                        return fn(req)
                return fn(req)
            except _Abort as e:  # typed handler failure -> proper status
                ctx.abort(grpc.StatusCode[e.code], e.details)
            except DeviceFault as e:  # the card failed: say so, as a 500 does
                ctx.abort(grpc.StatusCode.INTERNAL, f"DeviceFault: {e}")

        return handler

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    for service, methods in _handlers(node).items():
        rpc_handlers = {
            name: grpc.unary_unary_rpc_method_handler(
                wrap(fn),
                request_deserializer=ident,
                response_serializer=ident,
            )
            for name, fn in methods.items()
        }
        server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(service, rpc_handlers),)
        )
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    server.start()
    debug_httpd = None
    debug_bound = 0
    if debug_port is not None:
        debug_httpd = _serve_debug_port("127.0.0.1", debug_port)
        debug_bound = debug_httpd.server_address[1]
    return GrpcPlane(server, bound, debug_httpd, debug_bound)


# --- client ----------------------------------------------------------------


class GrpcNode:
    """TxClient-compatible node surface over a gRPC channel.

    Implements broadcast / query_account / tx_status / validators /
    chain_id — the exact interface user.TxClient and txsim consume — so
    they run against a gRPC endpoint unchanged.
    """

    def __init__(self, target: str):
        import grpc

        self._channel = grpc.insecure_channel(target)
        ident = lambda b: b

        def traced_call(call):
            # Cross-node propagation: the active trace context rides as
            # x-celestia-trace invocation metadata on every unary call,
            # so the served node ADOPTS it (serve_grpc's wrapper) and
            # its spans stitch under the caller's trace_id.
            def invoke(req, **kwargs):
                from celestia_app_tpu_torch.trace.context import (
                    TRACE_HEADER,
                    serialize_context,
                )

                wire = serialize_context()
                if wire is not None and "metadata" not in kwargs:
                    kwargs["metadata"] = ((TRACE_HEADER, wire),)
                return call(req, **kwargs)

            return invoke

        self._call = {
            name: traced_call(self._channel.unary_unary(
                path, request_serializer=ident, response_deserializer=ident
            ))
            for name, path in {
                "broadcast": "/cosmos.tx.v1beta1.Service/BroadcastTx",
                "get_tx": "/cosmos.tx.v1beta1.Service/GetTx",
                "simulate": "/cosmos.tx.v1beta1.Service/Simulate",
                "node_info": "/cosmos.base.tendermint.v1beta1.Service/GetNodeInfo",
                "account": "/cosmos.auth.v1beta1.Query/Account",
                "balance": "/cosmos.bank.v1beta1.Query/Balance",
                "validators": "/cosmos.staking.v1beta1.Query/Validators",
                "delegation": "/cosmos.staking.v1beta1.Query/Delegation",
                "proposals": "/cosmos.gov.v1beta1.Query/Proposals",
                "blob_params": "/celestia.blob.v1.Query/Params",
                "latest": "/cosmos.base.tendermint.v1beta1.Service/GetLatestBlock",
                "min_gas_price": "/celestia.minfee.v1.Query/NetworkMinGasPrice",
                "version_tally": "/celestia.signal.v1.Query/VersionTally",
                "attestation": "/celestia.qgb.v1.Query/AttestationRequestByNonce",
                "latest_nonce": "/celestia.qgb.v1.Query/LatestAttestationNonce",
                "evm_address": "/celestia.qgb.v1.Query/EVMAddress",
                "delegation_rewards":
                    "/cosmos.distribution.v1beta1.Query/DelegationRewards",
                "community_pool":
                    "/cosmos.distribution.v1beta1.Query/CommunityPool",
                "signing_info": "/cosmos.slashing.v1beta1.Query/SigningInfo",
                "signing_infos": "/cosmos.slashing.v1beta1.Query/SigningInfos",
                "slashing_params": "/cosmos.slashing.v1beta1.Query/Params",
                "wait_tx": "/celestia.tpu.subscription.v1.Subscription/WaitTx",
                "das_share_proof": "/celestia.tpu.das.v1.Das/GetShareProof",
                "das_shares":
                    "/celestia.tpu.das.v1.Das/GetSharesByNamespace",
                "das_attestation":
                    "/celestia.tpu.das.v1.Das/GetAttestation",
            }.items()
        }

    def close(self) -> None:
        self._channel.close()

    # --- TxClient surface ---------------------------------------------------
    @property
    def chain_id(self) -> str:
        hdr = _field_bytes(_field_bytes(self._call["latest"](b""), 2), 1)
        return _field_str(hdr, 2)

    def height(self) -> int:
        hdr = _field_bytes(_field_bytes(self._call["latest"](b""), 2), 1)
        return _field_int(hdr, 3)

    def broadcast(self, raw_tx: bytes):
        from celestia_app_tpu_torch.app.app import TxResult

        resp = _parse_tx_response(
            _field_bytes(self._call["broadcast"](encode_bytes_field(1, raw_tx)), 1)
        )
        return TxResult(
            code=resp["code"], log=resp["raw_log"],
            gas_wanted=resp["gas_wanted"], gas_used=resp["gas_used"],
        )

    def query_account(self, address: str):
        from celestia_app_tpu_torch.state.accounts import Account

        resp = self._call["account"](encode_bytes_field(1, address.encode()))
        any_acc = _field_bytes(resp, 1)
        if not any_acc:
            return None
        base = _field_bytes(any_acc, 2)
        return Account(
            address=_field_str(base, 1), pubkey=b"",
            account_number=_field_int(base, 3), sequence=_field_int(base, 4),
        )

    def tx_status(self, tx_hash: bytes):
        resp = self._call["get_tx"](
            encode_bytes_field(1, tx_hash.hex().upper().encode())
        )
        tr = _field_bytes(resp, 2)
        if not tr:
            return None
        parsed = _parse_tx_response(tr)
        return parsed["height"], parsed["code"], parsed["raw_log"]

    def balance(self, address: str, denom: str = "utia") -> int:
        resp = self._call["balance"](
            encode_bytes_field(1, address.encode())
            + encode_bytes_field(2, denom.encode())
        )
        return int(_field_str(_field_bytes(resp, 1), 2) or 0)

    def produce_block(self, timeout_s: float = 120.0):
        """The cosmos gRPC surface has no dev produce-block hook; wait for
        the served node's proposer loop to commit the next height (txsim's
        per-round block barrier), shaped like TestNode.produce_block.

        Default waits out a worst-case first-ever-square-size jit compile
        inside the proposer loop (35-50 s on the 1-core box — the same
        cold-compile allowance RemoteNode's socket timeout makes,
        rpc/client.py:40-44); steady-state blocks commit in well under a
        second."""
        import time

        start = self.height()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.height() > start:
                return {"height": self.height()}, []
            time.sleep(0.05)
        raise TimeoutError(f"no block committed past height {start}")

    def validators(self) -> list[dict]:
        from celestia_app_tpu_torch.state.staking import POWER_REDUCTION

        out = []
        for num, wt, val in decode_fields(self._call["validators"](b"")):
            if num == 1 and wt == WIRE_LEN:
                # "address"/"power" match the in-process node surface so
                # txsim's sequences stay node-agnostic; the wire carries
                # tokens (power x PowerReduction, the sdk convention).
                out.append({
                    "address": _field_str(val, 1),
                    "power": int(_field_str(val, 5) or 0) // POWER_REDUCTION,
                })
        return out

    def delegation(self, delegator: str, validator: str) -> int:
        """Delegated utia of (delegator, validator); 0 if none."""
        resp = self._call["delegation"](
            encode_bytes_field(1, delegator.encode())
            + encode_bytes_field(2, validator.encode())
        )
        dr = _field_bytes(resp, 1)
        if not dr:
            return 0
        return int(_field_str(_field_bytes(dr, 2), 2) or 0)

    def proposals(self) -> list[dict]:
        """[{id, status}] of every proposal on chain."""
        out = []
        for num, wt, val in decode_fields(self._call["proposals"](b"")):
            if num == 1 and wt == WIRE_LEN:
                out.append({
                    "id": _field_int(val, 1),
                    "status": _field_int(val, 3),
                })
        return out

    def blob_params(self) -> dict:
        """{gas_per_blob_byte, gov_max_square_size} (celestia.blob.v1)."""
        p = _field_bytes(self._call["blob_params"](b""), 1)
        return {
            "gas_per_blob_byte": _field_int(p, 1),
            "gov_max_square_size": _field_int(p, 2),
        }

    def simulate(self, raw_tx: bytes) -> tuple[int, int, str]:
        """(gas_wanted, gas_used, log) of simulating `raw_tx`; gas_used 0
        with a log on failure."""
        resp = self._call["simulate"](encode_bytes_field(2, raw_tx))
        gas_info = _field_bytes(resp, 1)
        if gas_info:
            return _field_int(gas_info, 1), _field_int(gas_info, 2), ""
        return 0, 0, _field_str(_field_bytes(resp, 2), 2)

    def node_info(self) -> dict:
        """{network, version, moniker} (GetNodeInfo, the cosmjs connect
        handshake)."""
        info = _field_bytes(self._call["node_info"](b""), 1)
        return {
            "network": _field_str(info, 4),
            "version": _field_str(info, 5),
            "moniker": _field_str(info, 7),
        }

    def wait_tx(self, tx_hash: bytes, timeout_s: float = 30.0):
        """Subscription confirm: parks server-side on the commit event
        (WaitTx long-poll) instead of polling GetTx; (height, code, log)
        or None on timeout. TxClient._confirm rides this automatically.

        Re-subscribes while deadline remains: when the server's park slots
        are exhausted it degrades to an immediate status check, so a
        single call returning empty does not mean the timeout elapsed."""
        import time

        import grpc

        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining < 0.05:  # sub-50ms: not worth another round-trip
                return None
            req = encode_bytes_field(1, tx_hash.hex().upper().encode())
            req += encode_varint_field(2, int(remaining * 1000))
            t0 = time.monotonic()
            try:
                resp = self._call["wait_tx"](req, timeout=remaining + 10.0)
            except grpc.RpcError:
                return None  # deadline/transport fault == timed out
            tr = _field_bytes(resp, 2)
            if tr:
                parsed = _parse_tx_response(tr)
                return parsed["height"], parsed["code"], parsed["raw_log"]
            if time.monotonic() - t0 < 0.5:
                time.sleep(0.2)  # degraded to poll mode: pace re-subscribes

    def validators_page(self, offset: int = 0, limit: int = 0,
                        count_total: bool = False) -> tuple[list[dict], dict]:
        """One page of the validator set; returns (validators, {next_key,
        total})."""
        from celestia_app_tpu_torch.state.staking import POWER_REDUCTION

        req = encode_bytes_field(
            2, encode_page_request(offset, limit, count_total)
        )
        resp = self._call["validators"](req)
        out = []
        for num, wt, val in decode_fields(resp):
            if num == 1 and wt == WIRE_LEN:
                out.append({
                    "address": _field_str(val, 1),
                    "power": int(_field_str(val, 5) or 0) // POWER_REDUCTION,
                })
        return out, _parse_page_response(_field_bytes(resp, 2))

    def proposals_page(self, offset: int = 0, limit: int = 0,
                       count_total: bool = False) -> tuple[list[dict], dict]:
        """One page of proposals; returns (proposals, {next_key, total})."""
        req = encode_bytes_field(
            4, encode_page_request(offset, limit, count_total)
        )
        resp = self._call["proposals"](req)
        out = []
        for num, wt, val in decode_fields(resp):
            if num == 1 and wt == WIRE_LEN:
                out.append({"id": _field_int(val, 1),
                            "status": _field_int(val, 3)})
        return out, _parse_page_response(_field_bytes(resp, 2))

    def network_min_gas_price(self) -> int:
        """The x/minfee network min gas price as the 10^18-scaled raw
        integer (gogoproto Dec wire form)."""
        return int(_field_str(self._call["min_gas_price"](b""), 1) or 0)

    def version_tally(self, version: int) -> dict:
        """{voting_power, threshold_power, total_voting_power} for an
        app version (x/signal)."""
        resp = self._call["version_tally"](encode_varint_field(1, version))
        return {
            "voting_power": _field_int(resp, 1),
            "threshold_power": _field_int(resp, 2),
            "total_voting_power": _field_int(resp, 3),
        }

    def attestation(self, nonce: int):
        """The blobstream attestation at `nonce` (Valset or
        DataCommitment), or None."""
        from celestia_app_tpu_torch.modules.blobstream.keeper import (
            _unmarshal_attestation,
        )

        resp = self._call["attestation"](encode_varint_field(1, nonce))
        any_att = _field_bytes(resp, 1)
        if not any_att:
            return None
        return _unmarshal_attestation(_field_bytes(any_att, 2))

    def latest_attestation_nonce(self) -> int:
        return _field_int(self._call["latest_nonce"](b""), 1)

    def evm_address(self, validator: str) -> str | None:
        resp = self._call["evm_address"](
            encode_bytes_field(1, validator.encode())
        )
        addr = _field_str(resp, 1)
        return addr or None

    def delegation_rewards(self, delegator: str, validator: str) -> int:
        """Pending utia rewards of (delegator, validator); whole-utia
        floor of the Dec amount."""
        resp = self._call["delegation_rewards"](
            encode_bytes_field(1, delegator.encode())
            + encode_bytes_field(2, validator.encode())
        )
        coin = _field_bytes(resp, 1)
        if not coin:
            return 0
        return int(_field_str(coin, 2) or 0) // 10**18

    def community_pool(self) -> int:
        """Community pool balance as the 10^18-scaled raw integer."""
        coin = _field_bytes(self._call["community_pool"](b""), 1)
        return int(_field_str(coin, 2) or 0)

    def signing_info(self, validator: str) -> dict:
        resp = self._call["signing_info"](
            encode_bytes_field(1, validator.encode())
        )
        return self._parse_signing_info(_field_bytes(resp, 1))

    def signing_infos(self, offset: int = 0, limit: int = 0,
                      count_total: bool = False) -> tuple[list[dict], dict]:
        req = encode_bytes_field(
            1, encode_page_request(offset, limit, count_total)
        )
        resp = self._call["signing_infos"](req)
        infos = [
            self._parse_signing_info(val)
            for num, wt, val in decode_fields(resp)
            if num == 1 and wt == WIRE_LEN
        ]
        return infos, _parse_page_response(_field_bytes(resp, 2))

    @staticmethod
    def _parse_signing_info(raw: bytes) -> dict:
        ts = _field_bytes(raw, 4)
        jailed_until_ns = _field_int(ts, 1) * 10**9 + _field_int(ts, 2)
        return {
            "address": _field_str(raw, 1),
            "index_offset": _field_int(raw, 3),
            "jailed_until_ns": jailed_until_ns,
            "tombstoned": bool(_field_int(raw, 5)),
            "missed_blocks": _field_int(raw, 6),
        }

    def share_proof_bytes(self, height: int, row: int, col: int,
                          axis: str = "row") -> bytes:
        """Raw canonical payload bytes of GetShareProof — byte-identical
        to the HTTP planes' GET /das/share_proof body (the cross-plane
        identity tests compare exactly this)."""
        req = (
            encode_varint_field(1, height)
            + encode_varint_field(2, row)
            + encode_varint_field(3, col)
        )
        if axis != "row":
            req += encode_bytes_field(4, axis.encode())
        return _field_bytes(self._call["das_share_proof"](req), 1)

    def share_proof(self, height: int, row: int, col: int,
                    axis: str = "row") -> dict:
        """GetShareProof payload as a dict; `proof` reconstructs via
        rpc/codec.share_proof_from_json for client-side verify()."""
        import json

        return json.loads(self.share_proof_bytes(height, row, col, axis))

    def shares_by_namespace_bytes(self, height: int, namespace_hex: str) -> bytes:
        req = encode_varint_field(1, height) + encode_bytes_field(
            2, namespace_hex.encode()
        )
        return _field_bytes(self._call["das_shares"](req), 1)

    def shares_by_namespace(self, height: int, namespace_hex: str) -> dict:
        import json

        return json.loads(self.shares_by_namespace_bytes(height, namespace_hex))

    def attestation_bytes(self, height: int, samples: str) -> bytes:
        """Raw canonical payload bytes of GetAttestation — byte-identical
        to the HTTP planes' GET /das/attestation body (the cross-plane
        identity tests compare exactly this)."""
        req = encode_varint_field(1, height) + encode_bytes_field(
            2, samples.encode()
        )
        return _field_bytes(self._call["das_attestation"](req), 1)

    def das_attestation(self, height: int, samples: str) -> dict:
        """GetAttestation payload as a dict; per-sample proofs reconstruct
        via rpc/codec.share_proofs_from_attestation for client-side
        verification (host verify() or the batched verifier).  (Named
        das_attestation: `attestation(nonce)` is the blobstream query.)"""
        import json

        return json.loads(self.attestation_bytes(height, samples))

    def slashing_params(self) -> dict:
        p = _field_bytes(self._call["slashing_params"](b""), 1)
        dur = _field_bytes(p, 3)
        return {
            "signed_blocks_window": _field_int(p, 1),
            "min_signed_per_window": int(_field_str(p, 2) or 0),
            "downtime_jail_duration_ns":
                _field_int(dur, 1) * 10**9 + _field_int(dur, 2),
            "slash_fraction_double_sign": int(_field_str(p, 4) or 0),
            "slash_fraction_downtime": int(_field_str(p, 5) or 0),
        }
