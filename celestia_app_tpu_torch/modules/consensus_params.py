"""On-chain consensus params (tier 3 of the config system).

The reference keeps consensus params (incl. Block.MaxBytes and the app
version) on-chain, set from DefaultConsensusParams at genesis
(app/default_overrides.go:217-247: MaxBytes = 64x64x478 ~ 1.87 MiB,
MaxGas = -1) and mutable through governance except the paramfilter
blocklist.  PrepareProposal respects MaxBytes when packing a block (the
reference's celestia-core reaps the mempool under this cap).
"""

from __future__ import annotations

from celestia_app_tpu_torch.constants import CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
from celestia_app_tpu_torch.state.store import KVStore

# DefaultMaxBytes (pkg/appconsts/initial_consts.go:10-14).
DEFAULT_BLOCK_MAX_BYTES = 64 * 64 * CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
DEFAULT_BLOCK_MAX_GAS = -1  # unlimited, as the reference ships

_MAX_BYTES_KEY = b"consensus/block/max_bytes"
_MAX_GAS_KEY = b"consensus/block/max_gas"


class ConsensusParamsKeeper:
    def __init__(self, store: KVStore):
        self.store = store

    def block_max_bytes(self) -> int:
        raw = self.store.get(_MAX_BYTES_KEY)
        return int.from_bytes(raw, "big") if raw else DEFAULT_BLOCK_MAX_BYTES

    def set_block_max_bytes(self, value: int) -> None:
        if value <= 0:
            raise ValueError("block max bytes must be positive")
        if value >= 1 << 63:
            raise ValueError(f"block max bytes {value} out of range")
        self.store.set(_MAX_BYTES_KEY, value.to_bytes(8, "big"))

    def block_max_gas(self) -> int:
        raw = self.store.get(_MAX_GAS_KEY)
        return int.from_bytes(raw, "big", signed=True) if raw else DEFAULT_BLOCK_MAX_GAS

    def set_block_max_gas(self, value: int) -> None:
        if not (-(1 << 63) <= value < 1 << 63):
            raise ValueError(f"block max gas {value} out of range")
        self.store.set(_MAX_GAS_KEY, value.to_bytes(8, "big", signed=True))
