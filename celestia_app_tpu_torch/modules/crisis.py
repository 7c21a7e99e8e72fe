"""x/crisis: invariant registry + assertion.

The reference registers cosmos-sdk x/crisis (app/modules.go:123-125),
whose job is to let any module declare invariants ("total supply equals
the sum of balances") and halt the chain — or fail a check command — when
one breaks.  The sdk runs them at genesis (unless
`skipGenesisInvariants`, the flag celestia threads through app.New) and on
demand via MsgVerifyInvariant / `appd check-invariants`.

Here the registry is a plain list of (name, check) pairs over the store;
`assert_invariants` raises InvariantBroken with the failing invariant's
name.  TestNode runs them after genesis, and the CLI exposes
`check-invariants` against a running chain's state.
"""

from __future__ import annotations

from typing import Callable

from celestia_app_tpu_torch.state.store import KVStore


class InvariantBroken(AssertionError):
    pass


def _supply_matches_balances(store: KVStore) -> None:
    """bank: per-denom supply equals the sum over all balance records."""
    from celestia_app_tpu_torch.state.accounts import BankKeeper

    bank = BankKeeper(store)
    totals: dict[str, int] = {}
    for (addr, denom), amount in bank.balances().items():
        totals[denom] = totals.get(denom, 0) + amount
    for denom, total in totals.items():
        if bank.supply(denom) != total:
            raise InvariantBroken(
                f"bank/total-supply: supply({denom}) = {bank.supply(denom)} "
                f"but balances sum to {total}"
            )


def _bonded_pool_backs_delegations(store: KVStore) -> None:
    """staking: the bonded pool holds exactly the delegated tokens (the
    notional genesis self-bonds are power-book-only, by design)."""
    from celestia_app_tpu_torch.state.accounts import BankKeeper
    from celestia_app_tpu_torch.state.staking import (
        _DEL_PREFIX,  # noqa: PLC2701 — the invariant audits raw records
        BONDED_POOL,
        StakingKeeper,
    )

    bank = BankKeeper(store)
    delegated = sum(
        int.from_bytes(v, "big") for _, v in store.iterate(_DEL_PREFIX)
    )
    pool = bank.balance(BONDED_POOL)
    if pool != delegated:
        raise InvariantBroken(
            f"staking/bonded-pool: pool holds {pool} but delegations sum to "
            f"{delegated}"
        )
    # tokens == notional + delegations per validator.
    from celestia_app_tpu_torch.modules.distribution import DistributionKeeper

    sk = StakingKeeper(store)
    dist = DistributionKeeper(store)
    for v in sk.validators():
        prefix = _DEL_PREFIX + v.address.encode() + b"/"
        per_val = sum(int.from_bytes(x, "big") for _, x in store.iterate(prefix))
        expected = dist.notional(v.address) + per_val
        if sk.tokens(v.address) != expected:
            raise InvariantBroken(
                f"staking/tokens: validator {v.address} has "
                f"{sk.tokens(v.address)} tokens but notional+delegations = "
                f"{expected}"
            )


def _distribution_module_solvent(store: KVStore) -> None:
    """distribution: the module account covers every entitlement — the
    community pool, accrued commissions, and all settled + pending
    delegator rewards (sdk ModuleAccountInvariant)."""
    from celestia_app_tpu_torch.modules.distribution import (
        DISTRIBUTION_MODULE,
        DistributionKeeper,
    )
    from celestia_app_tpu_torch.state.accounts import BankKeeper
    from celestia_app_tpu_torch.state.dec import Dec
    from celestia_app_tpu_torch.state.staking import StakingKeeper

    bank = BankKeeper(store)
    dist = DistributionKeeper(store)
    sk = StakingKeeper(store)
    owed = dist.community_pool()
    for v in sk.validators():
        owed = owed.add(dist.accrued_commission(v.address))
        for d in dist.settle_all(sk, v.address):
            owed = owed.add(
                Dec.from_int(dist.pending_rewards(sk, d, v.address))
            )
    balance = bank.balance(DISTRIBUTION_MODULE)
    if owed.truncate_int() > balance:
        raise InvariantBroken(
            f"distribution/solvency: module holds {balance} but owes "
            f"{owed.truncate_int()}"
        )


def _gov_deposits_escrowed(store: KVStore) -> None:
    """gov: the module account holds at least the live deposits."""
    from celestia_app_tpu_torch.modules.gov import GOV_MODULE
    from celestia_app_tpu_torch.state.accounts import BankKeeper

    deposits = sum(
        int.from_bytes(v, "big") for k, v in store.iterate(b"gov/dep/")
    )
    balance = BankKeeper(store).balance(GOV_MODULE)
    if balance < deposits:
        raise InvariantBroken(
            f"gov/deposits: module holds {balance} but active deposits sum "
            f"to {deposits}"
        )


INVARIANTS: list[tuple[str, Callable[[KVStore], None]]] = [
    ("bank/total-supply", _supply_matches_balances),
    ("staking/bonded-pool", _bonded_pool_backs_delegations),
    ("distribution/solvency", _distribution_module_solvent),
    ("gov/deposits", _gov_deposits_escrowed),
]


def assert_invariants(store: KVStore) -> list[str]:
    """Run every registered invariant; returns the names checked.

    NOTE: runs against a BRANCH of the given store — some checks (reward
    settling) write intermediate state that must not leak into consensus
    state."""
    branch = store.branch()
    for name, check in INVARIANTS:
        check(branch)
    return [name for name, _ in INVARIANTS]
