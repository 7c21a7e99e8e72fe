"""x/minfee: the network-wide minimum gas price (v2+).

Parity with reference x/minfee/params.go:20-26 (default from
pkg/appconsts/v2/app_consts.go:9) and its enforcement in
app/ante/fee_checker.go:54-60.
"""

from __future__ import annotations

from celestia_app_tpu_torch.state.dec import Dec
from celestia_app_tpu_torch.state.store import KVStore

_KEY = b"minfee/network_min_gas_price"
DEFAULT_NETWORK_MIN_GAS_PRICE = Dec.from_str("0.000001")  # utia per gas


class MinFeeKeeper:
    def __init__(self, store: KVStore):
        self.store = store

    def network_min_gas_price(self) -> Dec:
        raw = self.store.get(_KEY)
        if raw is None:
            return DEFAULT_NETWORK_MIN_GAS_PRICE
        return Dec(int.from_bytes(raw, "big", signed=True))

    def set_network_min_gas_price(self, price: Dec) -> None:
        if price.raw < 0:
            raise ValueError("min gas price cannot be negative")
        self.store.set(_KEY, price.raw.to_bytes(16, "big", signed=True))
