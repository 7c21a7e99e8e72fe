"""Multi-validator in-process network.

The reference has no in-process multi-validator harness — multi-node
testing goes straight to knuu/k8s (SURVEY §4.8).  Here the replicated state
machine (SURVEY §2.4 P1) is exercised directly: N real Apps share one
genesis; each round a rotating proposer runs PrepareProposal, every
validator runs ProcessProposal + finalize + commit, and the harness asserts
data roots and app hashes agree byte-for-byte — the determinism contract the
kernels must uphold.

The port's copy of celestia_app_tpu/testutil/network.py.  `Network(...,
device=None)` runs its N Apps on one device (None means CUDA and raises
without a card; "cpu" runs the plain kernel versions).
"""

from __future__ import annotations

from celestia_app_tpu_torch.app import App, BlockData, Genesis
from celestia_app_tpu_torch.mempool import PriorityMempool
from celestia_app_tpu_torch.state.dec import Dec
from celestia_app_tpu_torch.testutil.testnode import (
    BLOCK_INTERVAL_NS,
    NODE_MIN_GAS_PRICE,
    deterministic_genesis,
    funded_keys,
)


class ConsensusFailure(AssertionError):
    pass


class Network:
    """N validators running the identical state machine in one process."""

    __test__ = False

    def __init__(self, n_validators: int = 3, genesis: Genesis | None = None, keys=None,
                 device=None):
        self.keys = keys if keys is not None else funded_keys(4)
        self.genesis = genesis or deterministic_genesis(
            self.keys, n_validators=n_validators
        )
        self.nodes: list[App] = []
        for _ in range(n_validators):
            app = App(node_min_gas_price=Dec.from_str(NODE_MIN_GAS_PRICE), device=device)
            app.init_chain(self.genesis)
            self.nodes.append(app)
        self.mempool = PriorityMempool()
        self.blocks: list[BlockData] = []

    @property
    def chain_id(self) -> str:
        return self.genesis.chain_id

    @property
    def app(self) -> App:
        """Primary node view (the TxClient/testnode surface)."""
        return self.nodes[0]

    def query_account(self, address: str):
        """Auth query against the primary node (TxClient surface)."""
        from celestia_app_tpu_torch.state.accounts import AuthKeeper

        return AuthKeeper(self.nodes[0].cms.working).get_account(address)

    def broadcast(self, raw_tx: bytes):
        """CheckTx against the primary node (gossip: one mempool)."""
        res = self.nodes[0].check_tx(raw_tx)
        if res.code == 0:
            priority = next((e[1] for e in res.events if e[0] == "priority"), 0)
            self.mempool.insert(raw_tx, priority, self.nodes[0].height)
        return res

    def produce_block(self):
        """One consensus round: rotate proposer, validate everywhere,
        commit everywhere, compare roots + app hashes."""
        height = self.nodes[0].height + 1
        proposer = self.nodes[(height - 1) % len(self.nodes)]
        data = proposer.prepare_proposal(self.mempool.reap())

        for i, node in enumerate(self.nodes):
            if not node.process_proposal(data):
                raise ConsensusFailure(f"validator {i} rejected proposal at height {height}")

        time_ns = self.nodes[0].last_block_time_ns + BLOCK_INTERVAL_NS
        app_hashes = set()
        results = None
        for node in self.nodes:
            res = node.finalize_block(time_ns, list(data.txs))
            app_hashes.add(node.commit())
            if results is None:
                results = res
        if len(app_hashes) != 1:
            raise ConsensusFailure(
                f"app hash divergence at height {height}: {[h.hex()[:16] for h in app_hashes]}"
            )
        self.mempool.update(height, list(data.txs))
        self.blocks.append(data)
        return data, results
