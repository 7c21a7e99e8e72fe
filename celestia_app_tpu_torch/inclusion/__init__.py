"""Blob share commitments: the host oracle (commitment.py) and the
device-batched path (batched.py)."""

from celestia_app_tpu_torch.inclusion.batched import create_commitments_batched
from celestia_app_tpu_torch.inclusion.commitment import (
    commitment_from_row_trees,
    create_commitment,
    create_commitments,
    merkle_mountain_range_sizes,
    subtree_root_coordinates,
)

__all__ = [
    "commitment_from_row_trees",
    "create_commitment",
    "create_commitments",
    "create_commitments_batched",
    "merkle_mountain_range_sizes",
    "subtree_root_coordinates",
]
