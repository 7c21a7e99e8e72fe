"""Block data -> extended data square (reference app/extend_block.go).

The consensus layer calls ExtendBlock on every committed block: rebuild the
square from the block's transactions and erasure-extend it on the card.
The counterpart of celestia_app_tpu/app/extend_block.py, without its trace
span.
"""

from __future__ import annotations

from celestia_app_tpu_torch.constants import SQUARE_SIZE_UPPER_BOUND
from celestia_app_tpu_torch.da import ExtendedDataSquare, extend_shares
from celestia_app_tpu_torch.square import builder as square


def extend_block(
    raw_txs: list[bytes],
    gov_max_square_size: int = SQUARE_SIZE_UPPER_BOUND,
    square_size_upper_bound: int = SQUARE_SIZE_UPPER_BOUND,
    construction: str | None = None,
    device=None,
) -> ExtendedDataSquare | None:
    """coretypes.Data -> EDS (extend_block.go:14-26); None for an empty block.

    `square_size_upper_bound` must match the chain's hard cap: a chain run
    under the benchmark-manifest override commits squares wider than the
    versioned 128, and a clamp here would rebuild a different square.
    `construction` pins the RS generator; the lowering follows
    $CELESTIA_PIPE_FUSED (kernels/fused.pipeline_mode) and every lowering
    gives the same bytes.  `device` defaults to CUDA and raises without a
    card.
    """
    if is_empty_block(raw_txs):
        return None
    sq = square.construct(raw_txs, min(gov_max_square_size, square_size_upper_bound))
    return extend_shares(sq.share_bytes(), construction, device)


def is_empty_block(raw_txs: list[bytes]) -> bool:
    """extend_block.go:30 IsEmptyBlock: no txs means the minimal square."""
    return len(raw_txs) == 0
