"""x/mint: the fixed (non-governable) inflation schedule.

Behavioral parity with reference x/mint/types/{minter.go,constants.go} and
x/mint/abci.go:14-20: 8% initial inflation decaying 10% per year to a 1.5%
floor, with time-based block provisions minted to the fee collector every
BeginBlock.
"""

from __future__ import annotations

from dataclasses import dataclass

from celestia_app_tpu_torch.constants import BOND_DENOM
from celestia_app_tpu_torch.state.dec import Dec

SECONDS_PER_YEAR = int(60 * 60 * 24 * 365.2425)  # 31,556,952
NANOSECONDS_PER_YEAR = SECONDS_PER_YEAR * 1_000_000_000

INITIAL_INFLATION_RATE = Dec.from_str("0.08")
DISINFLATION_RATE = Dec.from_str("0.1")
TARGET_INFLATION_RATE = Dec.from_str("0.015")


def years_since_genesis(genesis_time_ns: int, block_time_ns: int) -> int:
    """Whole elapsed years (x/mint/types/minter.go yearsSinceGenesis)."""
    if block_time_ns < genesis_time_ns:
        return 0
    return (block_time_ns - genesis_time_ns) // NANOSECONDS_PER_YEAR


def calculate_inflation_rate(genesis_time_ns: int, block_time_ns: int) -> Dec:
    years = years_since_genesis(genesis_time_ns, block_time_ns)
    one_minus = Dec.from_int(1).sub(DISINFLATION_RATE)
    rate = INITIAL_INFLATION_RATE.mul(one_minus.power(years))
    return TARGET_INFLATION_RATE if rate < TARGET_INFLATION_RATE else rate


@dataclass
class Minter:
    inflation_rate: Dec
    annual_provisions: Dec
    bond_denom: str = BOND_DENOM
    previous_block_time_ns: int | None = None

    @classmethod
    def default(cls) -> "Minter":
        return cls(INITIAL_INFLATION_RATE, Dec.from_int(0))

    def calculate_block_provision(
        self, current_ns: int, previous_ns: int
    ) -> int:
        """utia to mint this block (minter.go CalculateBlockProvision)."""
        if current_ns < previous_ns:
            raise ValueError("current block time before previous block time")
        elapsed = current_ns - previous_ns
        portion = Dec.from_fraction(elapsed, NANOSECONDS_PER_YEAR)
        return self.annual_provisions.mul(portion).truncate_int()

    def update(self, genesis_time_ns: int, block_time_ns: int, total_supply: int) -> None:
        """BeginBlock maybeUpdateMinter: refresh rate + annual provisions."""
        new_rate = calculate_inflation_rate(genesis_time_ns, block_time_ns)
        if new_rate.raw == self.inflation_rate.raw and self.annual_provisions.raw != 0:
            return
        self.inflation_rate = new_rate
        self.annual_provisions = new_rate.mul_int(total_supply)
