"""Deterministic keys and genesis for a chain on the port's App.

The port's copy of `funded_keys`, `deterministic_genesis` and their
constants from celestia_app_tpu/testutil/testnode.py: the same seeds give
the same accounts, validators and genesis in both packages, so a chain the
JAX TestNode builds can be rebuilt on the port.  TestNode itself, the
in-process node around the App's block cycle, is not ported yet (ROADMAP,
queue 1).
"""

from __future__ import annotations

from celestia_app_tpu_torch.app import Genesis, GenesisAccount
from celestia_app_tpu_torch.crypto import PrivateKey
from celestia_app_tpu_torch.state.staking import Validator

GENESIS_TIME_NS = 1_700_000_000 * 10**9
BLOCK_INTERVAL_NS = 15 * 10**9  # GoalBlockTime
DEFAULT_BALANCE = 10**12  # 1M TIA in utia


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
