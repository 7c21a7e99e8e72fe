"""x/blobstream: the DataCommitmentWindow param, which genesis sets.

The port's copy of that part of celestia_app_tpu/modules/blobstream/
keeper.py.  The attestations (valset snapshots, data commitments, the v1
end blocker) come with the block execution (ROADMAP, queue 1).
"""

from __future__ import annotations

from celestia_app_tpu_torch.state.store import KVStore

DEFAULT_DATA_COMMITMENT_WINDOW = 400  # types/genesis.go:29

_WINDOW_KEY = b"blobstream/params/data_commitment_window"


def set_data_commitment_window(store: KVStore, window: int) -> None:
    """On-chain DataCommitmentWindow param (genesis/gov-settable, as the
    reference keeper reads it via GetDataCommitmentWindowParam)."""
    if window <= 0:
        raise ValueError("data commitment window must be positive")
    store.set(_WINDOW_KEY, window.to_bytes(8, "big"))


def get_data_commitment_window(store: KVStore) -> int:
    raw = store.get(_WINDOW_KEY)
    return int.from_bytes(raw, "big") if raw else DEFAULT_DATA_COMMITMENT_WINDOW
