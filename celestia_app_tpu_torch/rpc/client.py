"""RemoteNode: the wire-side node handle (reference pkg/user's gRPC conn).

Presents the same duck-typed node surface TxClient and txsim consume from
an in-process TestNode — chain_id / broadcast / query_account / tx_status /
produce_block — but every call is an HTTP JSON-RPC round trip to a served
node this process did not construct (and need not have imported).

The port's copy of celestia_app_tpu/rpc/client.py, whole; the port's
TxClient and txsim drive it as they drive a TestNode.
"""

from __future__ import annotations

import http.client
import json
import time
from dataclasses import dataclass
from urllib.parse import urlparse


class RPCError(RuntimeError):
    pass


@dataclass
class RemoteAccount:
    account_number: int
    sequence: int


@dataclass
class RemoteTxResult:
    code: int
    log: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: tuple = ()


class RemoteNode:
    """A client handle to a ServingNode's JSON-RPC endpoint."""

    # Socket timeout must exceed a worst-case cold jit compile inside the
    # served node (35-50 s measured for a first-ever square size on this
    # box): produce_block legitimately blocks that long once per size,
    # and a 30 s cap made the devnet txsim test flake exactly there.
    def __init__(self, url: str, timeout: float = 120.0, defer_status: bool = False):
        self.url = url
        parsed = urlparse(url)
        self._host = parsed.hostname
        self._port = parsed.port
        self._timeout = timeout
        self._chain_id: str | None = None
        if not defer_status:
            self._chain_id = self.status()["chain_id"]

    # --- transport ----------------------------------------------------------
    def call(self, method: str, **params):
        from celestia_app_tpu_torch.trace.context import TRACE_HEADER, serialize_context

        conn = http.client.HTTPConnection(self._host, self._port, timeout=self._timeout)
        try:
            payload = json.dumps(
                {"jsonrpc": "2.0", "id": 1, "method": method, "params": params}
            )
            headers = {"Content-Type": "application/json"}
            # Cross-node propagation: the active context rides every
            # JSON-RPC hop so the receiving node ADOPTS the trace
            # (adopt_or_new in rpc/server.py) instead of re-minting it.
            wire_ctx = serialize_context()
            if wire_ctx is not None:
                headers[TRACE_HEADER] = wire_ctx
            conn.request("POST", "/", body=payload, headers=headers)
            resp = conn.getresponse()
            body = json.loads(resp.read())
        finally:
            conn.close()
        if "error" in body:
            raise RPCError(body["error"]["message"])
        return body["result"]

    # --- node surface ---------------------------------------------------------
    @property
    def chain_id(self) -> str:
        if self._chain_id is None:
            self._chain_id = self.status()["chain_id"]
        return self._chain_id

    def status(self) -> dict:
        return self.call("status")

    def broadcast(self, raw_tx: bytes, relay: bool = True) -> RemoteTxResult:
        res = self.call("broadcast_tx", tx=raw_tx.hex(), relay=relay)
        return RemoteTxResult(code=res["code"], log=res["log"])

    def query_account(self, address: str) -> RemoteAccount | None:
        res = self.call("account", address=address)
        if res is None:
            return None
        return RemoteAccount(res["account_number"], res["sequence"])

    def tx_status(self, tx_hash: bytes) -> tuple[int, int, str] | None:
        res = self.call("tx_status", hash=tx_hash.hex())
        if res is None:
            return None
        return (res["height"], res["code"], res["log"])

    def wait_tx(self, tx_hash: bytes, timeout_s: float = 30.0):
        """Subscription confirm: long-poll calls that park server-side on
        the commit event (rpc_subscribe_tx) instead of hammering tx_status;
        (height, code, log) or None on timeout. Re-subscribes while the
        deadline remains — the server caps one park at 110 s."""
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            res = self.call(
                "subscribe_tx", hash=tx_hash.hex(), timeout_s=remaining
            )
            if res is not None:
                return (res["height"], res["code"], res["log"])

    def produce_block(self):
        """Trigger one block on the served node (dev/test surface); returns
        (block-info dict, results) shaped like TestNode.produce_block."""
        res = self.call("produce_block")
        results = [
            RemoteTxResult(code=r["code"], log=r["log"],
                           gas_wanted=r["gas_wanted"], gas_used=r["gas_used"])
            for r in res["results"]
        ]
        return res, results

    def block(self, height: int) -> dict:
        return self.call("block", height=height)

    def validators(self) -> list[dict]:
        return self.call("validators")

    def apply_block(self, height: int, time_ns: int, data) -> dict:
        return self.call(
            "apply_block",
            height=height,
            time_ns=time_ns,
            data_hash=data.hash.hex(),
            square_size=data.square_size,
            txs=[t.hex() for t in data.txs],
        )

    # --- voting round (consensus/votes.py) -----------------------------------
    def propose(self, height: int, time_ns: int, data) -> dict:
        return self.call(
            "propose",
            height=height,
            time_ns=time_ns,
            data_hash=data.hash.hex(),
            square_size=data.square_size,
            txs=[t.hex() for t in data.txs],
        )

    def precommit(self, height: int, block_hash: bytes, prevotes: list[str]) -> dict:
        return self.call(
            "precommit",
            height=height,
            data_hash=block_hash.hex(),
            prevotes=prevotes,
        )

    def finalize_commit(
        self, height: int, time_ns: int, data, commit: dict,
        last_commit_signers: list[str] | None = None,
        evidence: list | None = None,
    ) -> dict:
        return self.call(
            "finalize_commit",
            height=height,
            time_ns=time_ns,
            data_hash=data.hash.hex(),
            square_size=data.square_size,
            txs=[t.hex() for t in data.txs],
            commit=commit,
            last_commit_signers=last_commit_signers,
            evidence=evidence or [],
        )

    def consensus(self, msg: dict) -> dict:
        """Deliver a gossip consensus message (rpc/gossip.py flood)."""
        return self.call("consensus", msg=msg)

    def commit(self, height: int):
        """The height's Commit record, parsed — None if the node has none."""
        res = self.call("commit", height=height)
        if res is None:
            return None
        from celestia_app_tpu_torch.consensus import Commit

        return Commit.from_json(res)

    # --- state sync -----------------------------------------------------------
    def snapshots(self) -> list[dict]:
        return self.call("snapshots")

    def snapshot_chunk(self, height: int, index: int) -> str:
        return self.call("snapshot_chunk", height=height, index=index)

    # --- proof queries (verify client-side against the fetched roots) --------
    def tx_inclusion_proof(self, height: int, tx_index: int):
        from celestia_app_tpu_torch.rpc.codec import share_proof_from_json

        res = self.call("tx_inclusion_proof", height=height, tx_index=tx_index)
        return share_proof_from_json(res["proof"]), bytes.fromhex(res["data_root"])

    def share_inclusion_proof(self, height: int, start: int, end: int):
        from celestia_app_tpu_torch.rpc.codec import share_proof_from_json

        res = self.call("share_inclusion_proof", height=height, start=start, end=end)
        return share_proof_from_json(res["proof"]), bytes.fromhex(res["data_root"])

    def state_proof(self, key: bytes):
        from celestia_app_tpu_torch.rpc.codec import state_proof_from_json

        res = self.call("state_proof", key=key.hex())
        return state_proof_from_json(res["proof"]), bytes.fromhex(res["app_hash"])

    # --- blobstream relayer surface -----------------------------------------
    def blobstream_attestation(self, nonce: int) -> dict | None:
        return self.call("blobstream_attestation", nonce=nonce)

    def blobstream_nonces(self) -> dict:
        return self.call("blobstream_nonces")

    def data_commitment_range(self, height: int) -> dict:
        return self.call("data_commitment_range", height=height)

    def latest_data_commitment(self) -> dict | None:
        return self.call("latest_data_commitment")

    def latest_valset_before(self, nonce: int) -> dict:
        return self.call("latest_valset_before", nonce=nonce)

    def data_commitment(self, begin: int, end: int) -> bytes:
        return bytes.fromhex(self.call("data_commitment", begin=begin, end=end))

    def data_root_inclusion_proof(
        self, height: int, begin: int, end: int
    ) -> tuple[int, int, list[bytes]]:
        res = self.call(
            "data_root_inclusion_proof", height=height, begin=begin, end=end
        )
        return res["index"], res["total"], [bytes.fromhex(p) for p in res["path"]]

    def wait_for_height(self, height: int, timeout_s: float = 30.0) -> dict:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            st = self.status()
            if st["height"] >= height:
                return st
            time.sleep(0.05)
        raise TimeoutError(f"node did not reach height {height}")
