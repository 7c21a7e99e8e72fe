"""TxClient: the high-level thread-safe submission client.

Parity with reference pkg/user/tx_client.go:90-455: build/sign/broadcast
message txs and BlobTxs against a node, estimate gas, bump the gas price and
retry on parseable fee rejections, resync sequences on nonce mismatch, and
confirm inclusion.  The node here is anything with the TestNode surface
(broadcast / produce_block / app) — in production the same calls ride gRPC.

The port's copy of celestia_app_tpu/user/tx_client.py.  Only a rejection
the node returns (a TxResult with a nonzero code) is retried; whatever the
node raises, a `device.DeviceFault` of its CheckTx among it, leaves the
retry loop at once, with the sequence unchanged.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from fractions import Fraction

from celestia_app_tpu_torch.crypto import PrivateKey
from celestia_app_tpu_torch.modules.blob.types import estimate_gas
from celestia_app_tpu_torch.shares.sparse import Blob
from celestia_app_tpu_torch.user.errors import (
    parse_insufficient_min_gas_price,
    parse_nonce_mismatch,
)
from celestia_app_tpu_torch.tx import tx_hash
from celestia_app_tpu_torch.user.signer import Signer

DEFAULT_GAS_PRICE = Fraction(2, 1000)  # matches appconsts.DefaultMinGasPrice
DEFAULT_GAS_MULTIPLIER = Fraction(11, 10)
MAX_RETRIES = 5


class TxSubmissionError(RuntimeError):
    def __init__(self, code: int, log: str):
        super().__init__(f"tx rejected (code {code}): {log}")
        self.code = code
        self.log = log


@dataclass
class TxResponse:
    height: int
    code: int
    log: str = ""
    gas_wanted: int = 0
    tx_hash: bytes = b""


class TxClient:
    """Mutex-serialized client bound to one node and a set of local keys."""

    def __init__(
        self,
        node,
        keys: list[PrivateKey],
        gas_price: Fraction = DEFAULT_GAS_PRICE,
        gas_multiplier: Fraction = DEFAULT_GAS_MULTIPLIER,
        fee_granter: str = "",
    ):
        self._node = node
        self._lock = threading.Lock()
        self.gas_price = gas_price
        self.gas_multiplier = gas_multiplier
        # pkg/user SetFeeGranter: every tx's fee is charged to this
        # account's x/feegrant allowance instead of the signer.
        self.fee_granter = fee_granter
        self.signer = Signer(node.chain_id)
        for k in keys:
            addr = k.public_key().address()
            acc = node.query_account(addr)
            if acc is None:
                raise ValueError(f"account {addr} not found on chain")
            self.signer.add_account(k, acc.account_number, acc.sequence)
        self.default_address = self.signer.addresses()[0]

    # --- public API --------------------------------------------------------
    def submit_pay_for_blob(self, blobs: list[Blob], address: str | None = None) -> TxResponse:
        """Broadcast a PFB and wait for inclusion (SubmitPayForBlob :202)."""
        with self._lock:
            resp = self._broadcast_pfb(blobs, address or self.default_address)
        return self._confirm(resp)

    def simulate_gas(self, msgs: list, address: str | None = None) -> int | None:
        """Gas for `msgs` via the node's Simulate endpoint: simulated
        gas_used scaled by this client's gas_multiplier (the pkg/user
        estimation recipe).  Returns None only when the node doesn't
        expose simulation (in-process TestNode surfaces); a FAILED
        simulation raises with the node's log — silently falling back on
        a tx that would fail on-chain helps nobody.  The simulated tx
        carries a placeholder zero fee (simulate waives the limit) and
        does not bump the sequence."""
        sim = getattr(self._node, "simulate", None)
        if sim is None:
            return None
        with self._lock:
            addr = address or self.default_address
            raw = self.signer.create_tx(addr, msgs, 0, 0)
            _, used, log = sim(raw)
        if used == 0:
            raise ValueError(f"simulation failed: {log}")
        m = self.gas_multiplier
        return used * m.numerator // m.denominator

    def submit_tx(self, msgs: list, address: str | None = None, gas: int = 200_000) -> TxResponse:
        with self._lock:
            resp = self._broadcast_msgs(msgs, address or self.default_address, gas)
        return self._confirm(resp)

    def estimate_gas(self, blobs: list[Blob]) -> int:
        return estimate_gas([len(b.data) for b in blobs])

    # --- internals ---------------------------------------------------------
    def _fee_for(self, gas: int, price: Fraction) -> int:
        return -(-(gas * price.numerator) // price.denominator)  # ceil

    def _granter_for(self, address: str) -> str:
        # The master account pays its own fees directly.
        return self.fee_granter if self.fee_granter != address else ""

    def _broadcast_pfb(self, blobs, address: str) -> TxResponse:
        gas = self.estimate_gas(blobs)
        build = lambda price: self.signer.create_pay_for_blobs(
            address, blobs, gas, self._fee_for(gas, price),
            self._granter_for(address),
        )
        return self._broadcast_with_retry(build, address, gas)

    def _broadcast_msgs(self, msgs, address: str, gas: int) -> TxResponse:
        build = lambda price: self.signer.create_tx(
            address, msgs, gas, self._fee_for(gas, price),
            self._granter_for(address),
        )
        return self._broadcast_with_retry(build, address, gas)

    def _broadcast_with_retry(self, build, address: str, gas: int) -> TxResponse:
        """broadcastTx + retryBroadcastingTx (:320-410): on a parseable
        fee rejection adopt the implied price; on nonce mismatch resync."""
        price = self.gas_price
        last = None
        for _ in range(MAX_RETRIES):
            raw = build(price)
            res = self._node.broadcast(raw)  # a raise is no rejection: not retried
            if res.code == 0:
                self.signer.increment_sequence(address)
                return TxResponse(
                    height=0, code=0, gas_wanted=gas,
                    tx_hash=tx_hash(raw),
                )
            last = res
            implied = parse_insufficient_min_gas_price(res.log, gas)
            if implied is not None:
                price = max(implied, price * self.gas_multiplier)
                continue
            nonce = parse_nonce_mismatch(res.log)
            if nonce is not None:
                self.signer.set_sequence(address, nonce[0])
                continue
            break
        raise TxSubmissionError(last.code, last.log)

    def _confirm(self, resp: TxResponse, timeout_s: float = 30.0) -> TxResponse:
        """ConfirmTx (:412): wait for inclusion and report its height.

        Against an in-process node (TestNode surface) this drives a block
        directly; against a served node (no produce_block, e.g. the RPC
        client) it polls the tx index until the server's proposer loop
        commits the tx — the reference's poll-by-hash behavior.
        """
        if hasattr(self._node, "app"):  # in-process node: drive a block
            _, results = self._node.produce_block()
            for r in results:
                if r.code != 0:
                    raise TxSubmissionError(r.code, r.log)
            return TxResponse(
                height=self._node.app.height, code=0, gas_wanted=resp.gas_wanted
            )
        if hasattr(self._node, "wait_tx"):
            # Subscription path: one call that parks on the node's commit
            # event (the /subscribe analog) — no polling.
            status = self._node.wait_tx(resp.tx_hash, timeout_s)
            if status is None:
                raise TxSubmissionError(-1, "timed out waiting for tx inclusion")
            height, code, log = status
            if code != 0:
                raise TxSubmissionError(code, log)
            return TxResponse(height=height, code=0, gas_wanted=resp.gas_wanted)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            status = self._node.tx_status(resp.tx_hash)
            if status is not None:
                height, code, log = status
                if code != 0:
                    raise TxSubmissionError(code, log)
                return TxResponse(height=height, code=0, gas_wanted=resp.gas_wanted)
            time.sleep(0.05)
        raise TxSubmissionError(-1, "timed out waiting for tx inclusion")
