"""x/blob on-chain params (keeper/params.go analog).

GasPerBlobByte and GovMaxSquareSize are governance-modifiable module params
in the reference (x/blob/types/params.go, read at app/square_size.go:20-22
and x/blob/keeper/keeper.go:43); storing them in app state means a gov
change lands in the app hash like any other write.
"""

from __future__ import annotations

from celestia_app_tpu_torch.constants import (
    DEFAULT_GAS_PER_BLOB_BYTE,
    DEFAULT_GOV_MAX_SQUARE_SIZE,
)
from celestia_app_tpu_torch.state.store import KVStore

_GAS_PER_BLOB_BYTE = b"blob/params/gas_per_blob_byte"
_GOV_MAX_SQUARE_SIZE = b"blob/params/gov_max_square_size"


class BlobParamsKeeper:
    def __init__(self, store: KVStore):
        self.store = store

    def _get(self, key: bytes, default: int) -> int:
        raw = self.store.get(key)
        return int.from_bytes(raw, "big") if raw else default

    def gas_per_blob_byte(self) -> int:
        return self._get(_GAS_PER_BLOB_BYTE, DEFAULT_GAS_PER_BLOB_BYTE)

    def set_gas_per_blob_byte(self, v: int) -> None:
        if v <= 0:
            raise ValueError("GasPerBlobByte must be positive")
        self.store.set(_GAS_PER_BLOB_BYTE, int(v).to_bytes(8, "big"))

    def gov_max_square_size(self) -> int:
        return self._get(_GOV_MAX_SQUARE_SIZE, DEFAULT_GOV_MAX_SQUARE_SIZE)

    def set_gov_max_square_size(self, v: int) -> None:
        if v < 1 or v & (v - 1):
            raise ValueError("GovMaxSquareSize must be a power of two")
        self.store.set(_GOV_MAX_SQUARE_SIZE, int(v).to_bytes(8, "big"))
