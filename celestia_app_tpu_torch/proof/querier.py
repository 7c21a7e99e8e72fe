"""ABCI proof queriers (reference pkg/proof/querier.go:29,73; the port's copy
of celestia_app_tpu/proof/querier.py).

The reference registers "custom/txInclusionProof" and
"custom/shareInclusionProof" ABCI query routes (app/app.go:393-394); the
querier reconstructs the block's square from the raw txs supplied in the
request, extends it on `device` (default CUDA; raises without a card) and
produces proofs against the recomputed data root.
"""

from __future__ import annotations

import json

from celestia_app_tpu_torch.da import extend_shares
from celestia_app_tpu_torch.proof import (
    ShareProof,
    new_share_inclusion_proof,
    new_tx_inclusion_proof,
)
from celestia_app_tpu_torch.square import builder as square

TX_INCLUSION_ROUTE = "custom/txInclusionProof"
SHARE_INCLUSION_ROUTE = "custom/shareInclusionProof"


def query_tx_inclusion_proof(
    raw_txs: list[bytes], tx_index: int, max_square_size: int, device=None
) -> ShareProof:
    sq = square.construct(raw_txs, max_square_size)
    eds = extend_shares(sq.share_bytes(), device=device)
    return new_tx_inclusion_proof(sq, eds, tx_index)


def query_share_inclusion_proof(
    raw_txs: list[bytes], start: int, end: int, max_square_size: int, device=None
) -> ShareProof:
    sq = square.construct(raw_txs, max_square_size)
    eds = extend_shares(sq.share_bytes(), device=device)
    return new_share_inclusion_proof(eds, start, end)


def handle_query(app, path: str, data: bytes, device=None) -> ShareProof:
    """Dispatch an ABCI-style query: path = route/arg[/arg], data = JSON
    {"txs": [hex, ...]}.  `app` is any object with a
    max_effective_square_size() method."""
    parts = path.split("/")
    payload = json.loads(data)
    raw_txs = [bytes.fromhex(t) for t in payload["txs"]]
    max_k = app.max_effective_square_size()
    if path.startswith(TX_INCLUSION_ROUTE):
        return query_tx_inclusion_proof(raw_txs, int(parts[-1]), max_k, device)
    if path.startswith(SHARE_INCLUSION_ROUTE):
        return query_share_inclusion_proof(
            raw_txs, int(parts[-2]), int(parts[-1]), max_k, device
        )
    raise ValueError(f"unknown query path {path}")
