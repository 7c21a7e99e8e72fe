"""In-process single-node chain harness on the port's App.

The workhorse harness tier of the reference test strategy (SURVEY §4:
test/util/testnode NewNetwork) without a consensus engine: TestNode drives
the real App through the full block lifecycle — CheckTx admission,
PrepareProposal, ProcessProposal self-validation, Finalize, Commit — exactly
as the proposer's node would, with deterministic keys and genesis
(test/util/test_app.go:63 SetupTestAppWithGenesisValSet analog).

The port's copy of celestia_app_tpu/testutil/testnode.py: the same seeds
give the same accounts, validators and genesis in both packages, and the
same broadcasts give the same pool, blocks, TxResults, app hashes and tx
index.  `TestNode(..., device=None)` builds its App on `device` (None means
CUDA and raises without a card; "cpu" runs the plain kernel versions).

One deliberate difference, because a device fault must stay visible: the
post-commit recheck runs `check_tx` on the card for every resident blob
tx, and a `device.DeviceFault` it raises is not a verdict on the tx.  It
propagates out of `produce_block` with the tx still resident, after the
committed block has been recorded and indexed (the JAX node would leave
the committed block out of `blocks` and `tx_index`).
"""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext

from celestia_app_tpu_torch.app import App, BlockData, Genesis, GenesisAccount, TxResult
from celestia_app_tpu_torch.crypto import PrivateKey
from celestia_app_tpu_torch.state.dec import Dec
from celestia_app_tpu_torch.state.staking import Validator

GENESIS_TIME_NS = 1_700_000_000 * 10**9
BLOCK_INTERVAL_NS = 15 * 10**9  # GoalBlockTime
DEFAULT_BALANCE = 10**12  # 1M TIA in utia
#: The node's minimum gas price (the JAX TestNode's).
NODE_MIN_GAS_PRICE = "0.000001"


def funded_keys(n: int) -> list[PrivateKey]:
    return [PrivateKey.from_seed(f"account-{i}".encode()) for i in range(n)]


def deterministic_genesis(
    keys: list[PrivateKey],
    chain_id: str = "tpu-test-chain",
    app_version: int = 2,
    n_validators: int = 3,
    gov_max_square_size: int = 64,
    data_commitment_window: int = 0,
) -> Genesis:
    accounts = tuple(
        GenesisAccount(k.public_key().address(), DEFAULT_BALANCE, k.public_key().bytes)
        for k in keys
    )
    validators = tuple(
        Validator(
            PrivateKey.from_seed(f"validator-{i}".encode()).public_key().address(),
            PrivateKey.from_seed(f"validator-{i}".encode()).public_key().bytes,
            power=100,
        )
        for i in range(n_validators)
    )
    return Genesis(
        chain_id=chain_id,
        genesis_time_ns=GENESIS_TIME_NS,
        accounts=accounts,
        validators=validators,
        app_version=app_version,
        gov_max_square_size=gov_max_square_size,
        data_commitment_window=data_commitment_window,
    )


class TestNode:
    """A single-process chain: mempool + proposer + validator in one."""

    __test__ = False  # not a pytest class

    def __init__(
        self,
        genesis: Genesis | None = None,
        keys: list[PrivateKey] | None = None,
        app: App | None = None,
        device=None,
    ):
        from celestia_app_tpu_torch.mempool import PriorityMempool

        if app is not None:
            # Wrap an existing (e.g. carried-over) app.
            self.keys = keys or []
            self.app = app
        else:
            self.keys = keys if keys is not None else funded_keys(4)
            self.app = App(node_min_gas_price=Dec.from_str(NODE_MIN_GAS_PRICE),
                           device=device)
            self.app.init_chain(genesis or deterministic_genesis(self.keys))
        self.mempool = PriorityMempool()
        self.blocks: list[BlockData] = []
        self.block_times: dict[int, int] = {}  # height -> block time
        # Wall clock of the last commit (the /healthz block-age input).
        self.last_commit_walltime: float | None = None
        # tx hash -> (height, code, log): the RPC `tx` query's index.
        self.tx_index: dict[bytes, tuple[int, int, str]] = {}
        # Event bus: commit-time notification for tx/block subscribers —
        # the in-process analog of Tendermint's websocket /subscribe
        # (tm.event='Tx'): long-poll waiters block here instead of polling
        # the index.
        self.commit_event = threading.Condition()

    @property
    def chain_id(self) -> str:
        return self.app.chain_id

    def broadcast(self, raw_tx: bytes, ctx=None) -> TxResult:
        """CheckTx + mempool admission under a request trace: `ctx` (or
        the thread's current context, or a fresh local root) follows the
        tx into the mempool entry, so the block that later reaps it — and
        everything below, down to the DAH dispatch — shares its trace_id.
        A DeviceFault of the CheckTx raises and admits nothing.
        """
        from celestia_app_tpu_torch.trace.context import (
            current_context,
            new_context,
            trace_span,
            use_context,
        )
        from celestia_app_tpu_torch.trace.square_journal import tx_namespace_label

        if ctx is None:
            ctx = current_context()
        if ctx is None:
            ctx = new_context(layer="rpc", source="local")
        # A blob tx's submitting namespace rides the trace baggage from
        # here on: every descendant span (mempool wait, square build,
        # dispatch, commit) and its e2e observation carries the tenant.
        ns_lbl = tx_namespace_label(raw_tx)
        if ns_lbl is not None and ctx.baggage.get("namespace") != ns_lbl:
            ctx = ctx.child(namespace=ns_lbl)
        # CheckTx still serializes on the app's check state (a node lock
        # when the subclass has one), but the mempool admission below runs
        # under the pool's OWN per-shard locks (mempool.py) — concurrent
        # BroadcastTx admission does not hold the node lock end-to-end.
        check_lock = getattr(self, "lock", None) or nullcontext()
        with use_context(ctx), trace_span(
            "tx_submit", layer="rpc", e2e="submit", tx_bytes=len(raw_tx),
        ) as sp:
            with check_lock:
                res = self.app.check_tx(raw_tx)
                height = self.app.height
            sp["result"] = str(res.code)
            if res.code == 0:
                priority = next(
                    (e[1] for e in res.events if e[0] == "priority"), 0
                )
                # May raise qos.QosThrottled ($CELESTIA_QOS).
                self.mempool.insert(
                    raw_tx, priority, height, ctx=current_context(),
                    ns=ns_lbl or "tx",  # already parsed above; don't re-parse
                )
        return res

    def _block_trace_context(self, reaped: list[bytes], height: int):
        """The block's TraceContext: adopt the FIRST reaped tx's
        submission trace (reap order is deterministic, so every proposer
        picks the same one) so a single trace_id runs from BroadcastTx to
        the DAH root; an empty block roots a fresh trace."""
        from celestia_app_tpu_torch.trace.context import new_context

        for raw in reaped:
            ctx = self.mempool.ctx_for(raw)
            if ctx is not None:
                return ctx.child(height=height)
        return new_context(layer="block", height=height)

    def produce_block(
        self,
        time_ns: int | None = None,
        last_commit_signers: set[str] | None = None,
        evidence: tuple = (),
    ) -> tuple[BlockData, list[TxResult]]:
        """One full consensus round against the app itself.

        `time_ns` defaults to deterministic logical time (last + 15s, the
        GoalBlockTime) for reproducible tests; serving daemons pass wall
        clock so on-chain time tracks reality (x/mint provisions depend on
        it).  `last_commit_signers`/`evidence` feed x/slashing liveness and
        x/evidence (ABCI LastCommitInfo / ByzantineValidators).
        """
        from celestia_app_tpu_torch.trace.context import trace_span, use_context

        if time_ns is None:
            time_ns = self.app.last_block_time_ns + BLOCK_INTERVAL_NS
        reaped = self.mempool.reap(self.block_max_bytes())
        block_ctx = self._block_trace_context(reaped, self.app.height + 1)
        with use_context(block_ctx):
            with trace_span(
                "block_propose", layer="consensus", e2e="propose",
                height=self.app.height + 1, n_txs=len(reaped),
            ):
                data = self.app.prepare_proposal(reaped)
                if not self.app.process_proposal(data):
                    raise AssertionError("node rejected its own proposal")
            with trace_span(
                "block_commit", layer="consensus", e2e="commit",
                height=self.app.height + 1,
            ):
                results = self._commit_block_data(
                    data, time_ns,
                    last_commit_signers=last_commit_signers, evidence=evidence,
                )
        return data, results

    def block_max_bytes(self) -> int:
        """The on-chain Block.MaxBytes cap the mempool reaps under (the
        reference's celestia-core reap budget) — skip-semantics in the
        mempool, so one oversized high-priority tx cannot blank blocks."""
        from celestia_app_tpu_torch.modules.consensus_params import ConsensusParamsKeeper

        return ConsensusParamsKeeper(self.app.cms.working).block_max_bytes()

    def _commit_block_data(
        self,
        data: BlockData,
        time_ns: int,
        last_commit_signers: set[str] | None = None,
        evidence: tuple = (),
    ) -> list[TxResult]:
        """Execute + commit an already-validated block and do the node
        bookkeeping — the single copy of the commit sequence."""
        results = self.app.finalize_block(
            time_ns, list(data.txs),
            last_commit_signers=last_commit_signers, evidence=evidence,
        )
        self.app.commit()
        self.mempool.update(self.app.height, list(data.txs))
        try:
            # Mempool RECHECK (CometBFT's recheck=true default): replay the
            # resident txs through CheckTx against the fresh state.  This
            # (a) evicts txs the new state invalidated, and (b) rebuilds
            # the check state's sequence expectations to include resident
            # txs — without it, a client pipelining sequences ahead of
            # commits is rejected with a sequence mismatch the moment a
            # block lands.  A DeviceFault is no verdict: it propagates and
            # the tx stays.
            for raw in self.mempool.resident_txs():
                if self.app.check_tx(raw).code != 0:
                    self.mempool.remove_tx(raw)
        finally:
            self.blocks.append(data)
            self.block_times[self.app.height] = time_ns
            self.index_block(self.app.height, list(data.txs), results)
        return results

    # --- query surface shared with the RPC plane ---------------------------
    def index_block(self, height: int, txs: list[bytes], results: list[TxResult]) -> None:
        from celestia_app_tpu_torch.tx import tx_hash

        for raw, res in zip(txs, results):
            self.tx_index[tx_hash(raw)] = (height, res.code, res.log)
        self.last_commit_walltime = time.time()
        with self.commit_event:
            self.commit_event.notify_all()

    def query_account(self, address: str):
        """(account_number, sequence, pubkey) or None — the auth query."""
        from celestia_app_tpu_torch.state.accounts import AuthKeeper

        return AuthKeeper(self.app.cms.working).get_account(address)

    def tx_status(self, tx_hash: bytes) -> tuple[int, int, str] | None:
        """(height, code, log) for a committed tx, None if unknown."""
        return self.tx_index.get(tx_hash)

    def wait_tx(self, tx_hash: bytes, timeout_s: float = 30.0):
        """Block until `tx_hash` is committed; (height, code, log) or None.

        The subscription path (Tendermint /subscribe tm.event='Tx' analog):
        waiters sleep on the commit event instead of polling tx_status in a
        loop — one wakeup per committed block, zero queries in between.
        """
        deadline = time.monotonic() + timeout_s
        with self.commit_event:
            while True:
                status = self.tx_index.get(tx_hash)
                if status is not None:
                    return status
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self.commit_event.wait(remaining):
                    return self.tx_index.get(tx_hash)

    def validators(self) -> list[dict]:
        """The validator set, shaped like RemoteNode.validators() so
        clients (txsim) stay node-agnostic across local and wire nodes."""
        from celestia_app_tpu_torch.state.staking import StakingKeeper

        return [
            {"address": v.address, "power": v.power}
            for v in StakingKeeper(self.app.cms.working).validators()
        ]
