"""x/distribution: fee allocation, delegator rewards, commission, community pool.

The reference runs cosmos-sdk x/distribution (wired at app/modules.go:137-139)
with celestia-tuned genesis: BaseProposerReward and BonusProposerReward are
both zero (app/default_overrides.go:129-135), so every block's fee-collector
balance splits exactly two ways — the community tax (sdk default 2%) into the
community pool and the rest across bonded validators proportional to power.
txsim's stake sequence depends on this module: it continuously claims rewards
via MsgWithdrawDelegatorReward (test/txsim/stake.go:95-104).

Accounting design (an F1 simplification that fits this store):

  * per validator, a cumulative-rewards-per-token Dec accumulator
    (`cum`); allocating `r` tokens of reward to a validator with `t`
    staked tokens advances cum by r/t;
  * per (validator, delegator), a snapshot of cum at the last settle and
    an accrued-but-unwithdrawn Dec balance; settle() realizes
    stake x (cum - snap) into accrued and re-snapshots. Any change to a
    delegation's stake MUST settle first (the app's staking msg handlers
    do), mirroring the sdk's before-shares-modified hook;
  * genesis validators' notional self-bond (power declared without an
    escrowed delegation, state/staking.py) is treated as an implicit
    delegation from the operator address, so their reward share accrues
    to the operator instead of leaking;
  * all reward tokens live in the `distribution` module account from the
    moment of allocation; withdraws pay the truncated integer amount and
    keep the Dec remainder accrued (sdk truncation semantics).
"""

from __future__ import annotations

from celestia_app_tpu_torch.state.dec import Dec
from celestia_app_tpu_torch.state.store import KVStore

DISTRIBUTION_MODULE = "distribution"

_CUM_PREFIX = b"dist/cum/"
_SNAP_PREFIX = b"dist/snap/"
_ACCR_PREFIX = b"dist/accr/"
_NOTIONAL_PREFIX = b"dist/notional/"
_COMM_RATE_PREFIX = b"dist/commrate/"
_COMM_PREFIX = b"dist/comm/"
_COMMUNITY_KEY = b"dist/community"
_WITHDRAW_ADDR_PREFIX = b"dist/withdrawaddr/"
_PARAMS_KEY = b"dist/params"

# sdk defaults (x/distribution DefaultParams); proposer rewards are zeroed
# by celestia's genesis override so they do not appear here at all.
DEFAULT_COMMUNITY_TAX = "0.020000000000000000"


class DistributionError(ValueError):
    pass


class DistributionKeeper:
    def __init__(self, store: KVStore):
        self.store = store

    # --- Dec-valued cells ---------------------------------------------------
    def _get_dec(self, key: bytes) -> Dec:
        raw = self.store.get(key)
        return Dec(int(raw.decode())) if raw else Dec(0)

    def _set_dec(self, key: bytes, d: Dec) -> None:
        self.store.set(key, str(d.raw).encode())

    # --- params -------------------------------------------------------------
    def community_tax(self) -> Dec:
        raw = self.store.get(_PARAMS_KEY)
        return Dec(int(raw.decode())) if raw else Dec.from_str(DEFAULT_COMMUNITY_TAX)

    def set_community_tax(self, tax: Dec) -> None:
        self.store.set(_PARAMS_KEY, str(tax.raw).encode())

    # --- commission ---------------------------------------------------------
    def commission_rate(self, validator: str) -> Dec:
        return self._get_dec(_COMM_RATE_PREFIX + validator.encode())

    def set_commission_rate(self, validator: str, rate: Dec) -> None:
        if rate < Dec(0) or Dec.from_int(1) < rate:
            raise DistributionError(f"commission rate {rate} outside [0, 1]")
        self._set_dec(_COMM_RATE_PREFIX + validator.encode(), rate)

    def accrued_commission(self, validator: str) -> Dec:
        return self._get_dec(_COMM_PREFIX + validator.encode())

    # Commission bounds declared at creation (sdk CommissionRates): the
    # operator's own promise to delegators, enforced on every edit.
    def set_commission_bounds(
        self, validator: str, max_rate: Dec, max_change_rate: Dec
    ) -> None:
        self.store.set(
            _COMM_RATE_PREFIX + validator.encode() + b"/bounds",
            f"{max_rate.raw}|{max_change_rate.raw}".encode(),
        )

    def commission_bounds(self, validator: str) -> tuple[Dec, Dec]:
        """(max_rate, max_change_rate); unlimited for validators that
        never declared bounds (genesis validators)."""
        raw = self.store.get(_COMM_RATE_PREFIX + validator.encode() + b"/bounds")
        if raw is None:
            return Dec.from_int(1), Dec.from_int(1)
        a, b = raw.decode().split("|")
        return Dec(int(a)), Dec(int(b))

    def change_commission_rate(self, validator: str, new_rate: Dec) -> None:
        """MsgEditValidator's rate change, against the declared bounds
        (sdk ErrCommissionGTMaxRate / max-change-rate checks)."""
        max_rate, max_change = self.commission_bounds(validator)
        if max_rate < new_rate:
            raise DistributionError(
                f"commission rate {new_rate} exceeds declared max {max_rate}"
            )
        old = self.commission_rate(validator)
        delta = Dec(abs(new_rate.raw - old.raw))
        if max_change < delta:
            raise DistributionError(
                f"commission change {delta} exceeds max change rate {max_change}"
            )
        self.set_commission_rate(validator, new_rate)

    # --- community pool -----------------------------------------------------
    def community_pool(self) -> Dec:
        return self._get_dec(_COMMUNITY_KEY)

    def fund_community_pool(self, bank, depositor: str, amount: int) -> None:
        """MsgFundCommunityPool: real tokens move into the module account."""
        if amount <= 0:
            raise DistributionError("community pool deposit must be positive")
        bank.send(depositor, DISTRIBUTION_MODULE, amount)
        self._set_dec(_COMMUNITY_KEY, self.community_pool().add(Dec.from_int(amount)))

    # --- notional self-bond (genesis validators) ----------------------------
    def notional(self, validator: str) -> int:
        raw = self.store.get(_NOTIONAL_PREFIX + validator.encode())
        return int(raw.decode()) if raw else 0

    def set_notional(self, validator: str, tokens: int) -> None:
        self.store.set(_NOTIONAL_PREFIX + validator.encode(), str(tokens).encode())

    def _stake(self, staking, delegator: str, validator: str) -> int:
        """Effective reward-bearing stake, incl. the operator's implicit bond."""
        stake = staking.delegation(delegator, validator)
        if delegator == validator:
            stake += self.notional(validator)
        return stake

    # --- allocation (BeginBlocker) ------------------------------------------
    def allocate(self, bank, staking) -> int:
        """Sweep the fee collector into rewards: community tax first, the
        rest across validators by power (proposer bonus is zero on celestia,
        default_overrides.go:129-135).  Returns the amount swept."""
        from celestia_app_tpu_torch.state.accounts import FEE_COLLECTOR

        fees = bank.balance(FEE_COLLECTOR)
        if fees == 0:
            return 0
        bank.send(FEE_COLLECTOR, DISTRIBUTION_MODULE, fees)

        fees_dec = Dec.from_int(fees)
        community = fees_dec.mul(self.community_tax())
        pool = fees_dec.sub(community)

        # Jailed validators earn nothing while out of the active set.
        validators = [
            v for v in staking.bonded_validators() if staking.tokens(v.address)
        ]
        total_tokens = sum(staking.tokens(v.address) for v in validators)
        if total_tokens == 0:
            # No bonded power: everything is community funds (sdk edge case).
            self._set_dec(_COMMUNITY_KEY, self.community_pool().add(fees_dec))
            return fees

        distributed = Dec(0)
        for v in validators:
            tokens = staking.tokens(v.address)
            reward = pool.mul(Dec.from_fraction(tokens, total_tokens))
            commission = reward.mul(self.commission_rate(v.address))
            shared = reward.sub(commission)
            if commission.raw:
                key = _COMM_PREFIX + v.address.encode()
                self._set_dec(key, self._get_dec(key).add(commission))
            cum_key = _CUM_PREFIX + v.address.encode()
            self._set_dec(
                cum_key,
                self._get_dec(cum_key).add(shared.quo(Dec.from_int(tokens))),
            )
            distributed = distributed.add(reward)
        # Allocation dust (rounding) joins the community pool, as in the sdk.
        self._set_dec(
            _COMMUNITY_KEY,
            self.community_pool().add(community).add(pool.sub(distributed)),
        )
        return fees

    # --- settle / withdraw --------------------------------------------------
    def settle(self, staking, delegator: str, validator: str) -> None:
        """Realize pending rewards into the accrued balance and re-snapshot.
        MUST run before any stake change for (delegator, validator) — the
        sdk's BeforeDelegationSharesModified hook."""
        cum = self._get_dec(_CUM_PREFIX + validator.encode())
        snap_key = _SNAP_PREFIX + validator.encode() + b"/" + delegator.encode()
        snap = self._get_dec(snap_key)
        stake = self._stake(staking, delegator, validator)
        if stake and cum.raw != snap.raw:
            accr_key = _ACCR_PREFIX + validator.encode() + b"/" + delegator.encode()
            pending = cum.sub(snap).mul(Dec.from_int(stake))
            self._set_dec(accr_key, self._get_dec(accr_key).add(pending))
        self._set_dec(snap_key, cum)

    def pending_rewards(self, staking, delegator: str, validator: str) -> int:
        """Query surface: what a withdraw would pay right now (truncated)."""
        cum = self._get_dec(_CUM_PREFIX + validator.encode())
        snap = self._get_dec(
            _SNAP_PREFIX + validator.encode() + b"/" + delegator.encode()
        )
        accr = self._get_dec(
            _ACCR_PREFIX + validator.encode() + b"/" + delegator.encode()
        )
        stake = self._stake(staking, delegator, validator)
        return accr.add(cum.sub(snap).mul(Dec.from_int(stake))).truncate_int()

    def withdraw_address(self, delegator: str) -> str:
        raw = self.store.get(_WITHDRAW_ADDR_PREFIX + delegator.encode())
        return raw.decode() if raw else delegator

    def set_withdraw_address(self, delegator: str, addr: str) -> None:
        self.store.set(_WITHDRAW_ADDR_PREFIX + delegator.encode(), addr.encode())

    def withdraw_rewards(self, bank, staking, delegator: str, validator: str) -> int:
        """MsgWithdrawDelegatorReward: pay the truncated integer, keep the
        Dec remainder accrued."""
        self.settle(staking, delegator, validator)
        accr_key = _ACCR_PREFIX + validator.encode() + b"/" + delegator.encode()
        accrued = self._get_dec(accr_key)
        amount = accrued.truncate_int()
        if amount < 0:
            raise DistributionError("negative accrued rewards (corrupt state)")
        if amount:
            bank.send(DISTRIBUTION_MODULE, self.withdraw_address(delegator), amount)
        self._set_dec(accr_key, accrued.sub(Dec.from_int(amount)))
        return amount

    def withdraw_commission(self, bank, validator: str) -> int:
        """MsgWithdrawValidatorCommission (operator-signed)."""
        key = _COMM_PREFIX + validator.encode()
        accrued = self._get_dec(key)
        amount = accrued.truncate_int()
        if amount == 0:
            raise DistributionError("no commission to withdraw")
        bank.send(DISTRIBUTION_MODULE, self.withdraw_address(validator), amount)
        self._set_dec(key, accrued.sub(Dec.from_int(amount)))
        return amount

    def community_pool_spend(self, bank, recipient: str, amount: int) -> None:
        """Gov-directed community pool spend (distrclient.ProposalHandler is
        registered in the reference's gov router, default_overrides.go:207)."""
        pool = self.community_pool()
        if Dec.from_int(amount).raw > pool.raw or amount <= 0:
            raise DistributionError(
                f"community pool has {pool}, cannot spend {amount}"
            )
        bank.send(DISTRIBUTION_MODULE, recipient, amount)
        self._set_dec(_COMMUNITY_KEY, pool.sub(Dec.from_int(amount)))

    # --- slashing support ---------------------------------------------------
    def settle_all(self, staking, validator: str) -> list[str]:
        """Settle every delegator of `validator` (incl. the operator's
        implicit bond).  Called before a slash changes the token/stake ratio
        so no delegator's pending rewards are computed against post-slash
        stake.  Returns the settled delegator addresses."""
        from celestia_app_tpu_torch.state.staking import _DEL_PREFIX  # noqa: PLC2701

        delegators = {validator} if self.notional(validator) else set()
        prefix = _DEL_PREFIX + validator.encode() + b"/"
        for key, _ in staking.store.iterate(prefix):
            delegators.add(key[len(prefix):].decode())
        for d in sorted(delegators):
            self.settle(staking, d, validator)
        return sorted(delegators)
