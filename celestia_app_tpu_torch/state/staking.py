"""Staking: validators + delegations (the x/staking surface the app uses).

The reference delegates staking to cosmos-sdk x/staking; the in-repo
modules read it (x/signal tallies power, x/blobstream snapshots valsets)
and txsim's stake sequence writes it (MsgDelegate/MsgUndelegate/
MsgBeginRedelegate, test/txsim/stake.go).  This keeper stores validators
(operator address, consensus pubkey, power) plus token-backed delegations:

  * power = tokens // POWER_REDUCTION (sdk DefaultPowerReduction: 1 TIA);
  * delegate escrows utia in the bonded pool and raises the validator's
    tokens/power; undelegate starts a 3-week unbonding
    (appconsts.DefaultUnbondingTime, initial_consts.go:28) released by the
    end blocker; redelegation moves bonded tokens instantly;
  * genesis validators carry notional tokens (power x reduction) with no
    escrowed backing — only delegated amounts move real funds (the
    reference funds genesis self-bond out of band too).

Rewards flow through x/distribution (modules/distribution), which treats a
genesis validator's notional power as an implicit operator self-bond;
jailing and slashing (modules/slashing) operate through the jail flag and
`slash` below.
"""

from __future__ import annotations

from dataclasses import dataclass

from celestia_app_tpu_torch.encoding.proto import (
    WIRE_LEN,
    WIRE_VARINT,
    decode_fields,
    encode_bytes_field,
    encode_varint_field,
)
from celestia_app_tpu_torch.state.store import KVStore

_VAL_PREFIX = b"staking/val/"
_TOKENS_PREFIX = b"staking/tokens/"
_DEL_PREFIX = b"staking/del/"
_UBD_PREFIX = b"staking/ubd/"
_JAIL_PREFIX = b"staking/jailed/"

POWER_REDUCTION = 1_000_000  # sdk DefaultPowerReduction: 1 TIA of stake = 1 power
UNBONDING_TIME_NS = 3 * 7 * 24 * 3600 * 10**9  # DefaultUnbondingTime, 3 weeks
BONDED_POOL = "bonded_tokens_pool"
NOT_BONDED_POOL = "not_bonded_tokens_pool"


class StakingError(ValueError):
    pass


@dataclass(frozen=True)
class Validator:
    address: str  # operator address (bech32)
    pubkey: bytes
    power: int

    def marshal(self) -> bytes:
        return (
            encode_bytes_field(1, self.address.encode())
            + encode_bytes_field(2, self.pubkey)
            + encode_varint_field(3, self.power)
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Validator":
        addr, pk, power = "", b"", 0
        for num, wt, val in decode_fields(raw):
            if num == 1 and wt == WIRE_LEN:
                addr = val.decode()
            elif num == 2 and wt == WIRE_LEN:
                pk = val
            elif num == 3 and wt == WIRE_VARINT:
                power = val
        return cls(addr, pk, power)


class StakingKeeper:
    def __init__(self, store: KVStore):
        self.store = store

    def set_validator(self, v: Validator) -> None:
        """Authoritative power registration (genesis / test harnesses).

        Refuses to reset a validator that holds delegations: overwriting
        its tokens record would desync the bonded-pool escrow from the
        delegation records (power changes for delegated validators go
        through delegate/undelegate/redelegate)."""
        if self._has_delegations(v.address):
            raise StakingError(
                f"validator {v.address} holds delegations; power cannot be "
                "set directly"
            )
        # One consensus key, one bonded entry — also on the genesis/test
        # path: vote sign bytes exclude the validator address, so two
        # records sharing a pubkey would let one signer count its power
        # twice toward +2/3 (same rule as create_validator).
        if v.pubkey:
            for other in self.validators():
                if other.pubkey == v.pubkey and other.address != v.address:
                    raise StakingError(
                        f"consensus pubkey already used by validator "
                        f"{other.address}"
                    )
        self.store.set(_VAL_PREFIX + v.address.encode(), v.marshal())
        # Keep tokens consistent with directly-set power.
        self.store.set(
            _TOKENS_PREFIX + v.address.encode(),
            (v.power * POWER_REDUCTION).to_bytes(16, "big"),
        )

    def _has_delegations(self, validator: str) -> bool:
        prefix = _DEL_PREFIX + validator.encode() + b"/"
        for _ in self.store.iterate(prefix):
            return True
        return False

    def remove_validator(self, address: str) -> None:
        self.store.delete(_VAL_PREFIX + address.encode())

    def get_validator(self, address: str) -> Validator | None:
        raw = self.store.get(_VAL_PREFIX + address.encode())
        return Validator.unmarshal(raw) if raw else None

    def has_validator(self, address: str) -> bool:
        return self.get_validator(address) is not None

    def get_power(self, address: str) -> int:
        v = self.get_validator(address)
        return v.power if v else 0

    def validators(self) -> list[Validator]:
        return [Validator.unmarshal(v) for _, v in self.store.iterate(_VAL_PREFIX)]

    def total_power(self) -> int:
        return sum(v.power for v in self.validators())

    # --- jail (x/slashing's handle on the validator set) ---------------------
    def is_jailed(self, address: str) -> bool:
        return self.store.get(_JAIL_PREFIX + address.encode()) is not None

    def jail(self, address: str) -> None:
        """Remove the validator from the bonded set (sdk jailValidator)."""
        if not self.has_validator(address):
            raise StakingError(f"no validator {address}")
        self.store.set(_JAIL_PREFIX + address.encode(), b"\x01")

    def unjail(self, address: str) -> None:
        self.store.delete(_JAIL_PREFIX + address.encode())

    def bonded_validators(self) -> list[Validator]:
        """The active (non-jailed) set: what consensus power, signal
        tallies, and blobstream valsets are built from."""
        return [v for v in self.validators() if not self.is_jailed(v.address)]

    def bonded_power(self) -> int:
        return sum(v.power for v in self.bonded_validators())

    def slash(self, bank, dist, validator: str, fraction_raw: int) -> int:
        """Burn `fraction` of the validator's tokens (sdk Slash semantics:
        bonded tokens burn from the bonded pool; every delegation — and the
        genesis notional self-bond — shrinks pro-rata).  `fraction_raw` is a
        Dec raw (1e18 = 100%).  `dist` settles rewards first so pending
        rewards are computed against pre-slash stake.  Returns burned."""
        precision = 10**18
        if not 0 <= fraction_raw <= precision:
            raise StakingError(f"slash fraction {fraction_raw} outside [0, 1e18]")
        tokens = self.tokens(validator)
        burn_total = tokens * fraction_raw // precision
        if burn_total == 0:
            return 0
        dist.settle_all(self, validator)
        prefix = _DEL_PREFIX + validator.encode() + b"/"
        burned_backed = 0
        for key, val in list(self.store.iterate(prefix)):
            stake = int.from_bytes(val, "big")
            cut = stake * fraction_raw // precision
            if cut:
                self.store.set(key, (stake - cut).to_bytes(16, "big"))
                burned_backed += cut
        notional = dist.notional(validator)
        notional_cut = notional * fraction_raw // precision
        if notional_cut:
            dist.set_notional(validator, notional - notional_cut)
        # Truncation dust stays staked: reduce tokens by what the stake
        # records actually lost, keeping tokens == notional + Σdelegations.
        # Only delegation cuts have bank escrow behind them; the genesis
        # notional self-bond is power-book-only (state/staking.py header).
        self._set_tokens(validator, tokens - burned_backed - notional_cut)
        if burned_backed:
            bank.burn(BONDED_POOL, burned_backed)
        # Unbonding entries for this validator are slashed too, or an
        # undelegation racing the evidence would dodge the burn and shift
        # the whole loss onto the delegators who stayed (the sdk slashes
        # unbonding delegations for the same reason; entries carry
        # creation heights, but this deliberately cuts ALL of the
        # validator's entries — a strict superset of the sdk's
        # created-after-infraction rule, since slash() is not told the
        # infraction height).
        burned_unbonding = 0
        for key, val in list(self.store.iterate(_UBD_PREFIX)):
            if self._ubd_parse(key)[2] != validator:
                continue
            amount = int.from_bytes(val, "big")
            cut = amount * fraction_raw // precision
            if cut:
                self.store.set(key, (amount - cut).to_bytes(16, "big"))
                burned_unbonding += cut
        if burned_unbonding:
            bank.burn(NOT_BONDED_POOL, burned_unbonding)
        return burned_backed + notional_cut + burned_unbonding

    # --- delegations ---------------------------------------------------------
    def tokens(self, validator: str) -> int:
        raw = self.store.get(_TOKENS_PREFIX + validator.encode())
        return int.from_bytes(raw, "big") if raw else 0

    def _set_tokens(self, validator: str, amount: int) -> None:
        self.store.set(_TOKENS_PREFIX + validator.encode(), amount.to_bytes(16, "big"))
        v = self.get_validator(validator)
        self.store.set(
            _VAL_PREFIX + validator.encode(),
            Validator(v.address, v.pubkey, amount // POWER_REDUCTION).marshal(),
        )

    def delegation(self, delegator: str, validator: str) -> int:
        raw = self.store.get(
            _DEL_PREFIX + validator.encode() + b"/" + delegator.encode()
        )
        return int.from_bytes(raw, "big") if raw else 0

    def _set_delegation(self, delegator: str, validator: str, amount: int) -> None:
        key = _DEL_PREFIX + validator.encode() + b"/" + delegator.encode()
        if amount:
            self.store.set(key, amount.to_bytes(16, "big"))
        else:
            self.store.delete(key)

    def delegate(self, bank, delegator: str, validator: str, amount: int) -> None:
        """MsgDelegate: escrow into the bonded pool, raise tokens/power."""
        if amount <= 0:
            raise StakingError("delegation must be positive")
        if not self.has_validator(validator):
            raise StakingError(f"no validator {validator}")
        try:
            bank.send(delegator, BONDED_POOL, amount)
        except ValueError as e:
            raise StakingError(str(e)) from e
        self._set_delegation(
            delegator, validator, self.delegation(delegator, validator) + amount
        )
        self._set_tokens(validator, self.tokens(validator) + amount)

    def undelegate(
        self, bank, delegator: str, validator: str, amount: int, time_ns: int,
        height: int = 0,
    ) -> int:
        """MsgUndelegate: tokens leave the bonded pool now, the delegator
        gets them back at completion (3-week unbonding).  Returns the
        completion time.

        `height` is the entry's creation height (sdk UnbondingDelegationEntry
        .CreationHeight) — the handle MsgCancelUnbondingDelegation names an
        entry by.  Undelegations in one block aggregate into one entry
        (same completion time, same height), as in the sdk."""
        held = self.delegation(delegator, validator)
        if amount <= 0 or amount > held:
            raise StakingError(
                f"invalid undelegation {amount} (delegated: {held})"
            )
        self._set_delegation(delegator, validator, held - amount)
        self._set_tokens(validator, self.tokens(validator) - amount)
        bank.send(BONDED_POOL, NOT_BONDED_POOL, amount)
        completion_ns = time_ns + UNBONDING_TIME_NS
        key = self._ubd_key(completion_ns, delegator, validator, height)
        prev = self.store.get(key)
        total = (int.from_bytes(prev, "big") if prev else 0) + amount
        self.store.set(key, total.to_bytes(16, "big"))
        return completion_ns

    @staticmethod
    def _ubd_key(
        completion_ns: int, delegator: str, validator: str, height: int
    ) -> bytes:
        """Unbonding entry key: completion-ordered, then addressed by
        (delegator, validator, creation height).  The height rides as
        ASCII decimal so every segment stays b"/"-split-safe."""
        return (
            _UBD_PREFIX + completion_ns.to_bytes(12, "big") + b"/"
            + delegator.encode() + b"/" + validator.encode() + b"/"
            + str(height).encode()
        )

    @staticmethod
    def _ubd_parse(key: bytes) -> tuple[int, str, str, int]:
        """(completion_ns, delegator, validator, creation_height) of an
        unbonding entry key."""
        completion_ns = int.from_bytes(
            key[len(_UBD_PREFIX): len(_UBD_PREFIX) + 12], "big"
        )
        parts = key[len(_UBD_PREFIX) + 13:].split(b"/")
        return (
            completion_ns, parts[0].decode(), parts[1].decode(),
            int(parts[2]),
        )

    def cancel_unbonding(
        self, bank, delegator: str, validator: str, amount: int,
        creation_height: int, time_ns: int,
    ) -> None:
        """MsgCancelUnbondingDelegation (sdk v0.46 x/staking): re-bond
        `amount` from the unbonding entry created at `creation_height`
        back to the SAME validator — the entry shrinks (or disappears)
        and the tokens return to the bonded pool immediately.

        sdk guards reproduced: a jailed validator refuses re-bonds
        (ErrValidatorJailed — a tombstoned double-signer must not regain
        power this way), and an entry whose completion time has passed is
        no longer cancellable even though the end blocker releases it
        later in the same block (messages run before end block)."""
        if amount <= 0:
            raise StakingError("cancel amount must be positive")
        if not self.has_validator(validator):
            raise StakingError(f"no validator {validator}")
        if self.is_jailed(validator):
            raise StakingError(f"validator {validator} is jailed")
        entry_key = None
        entry_amount = 0
        for key, val in self.store.iterate(_UBD_PREFIX):
            completion_ns, d, v, h = self._ubd_parse(key)
            if (d, v, h) == (delegator, validator, creation_height):
                if completion_ns <= time_ns:
                    raise StakingError(
                        "unbonding delegation is no longer pending "
                        f"(completed at {completion_ns})"
                    )
                entry_key = key
                entry_amount = int.from_bytes(val, "big")
                break
        if entry_key is None:
            raise StakingError(
                f"no unbonding entry for {delegator}/{validator} at "
                f"height {creation_height}"
            )
        if amount > entry_amount:
            raise StakingError(
                f"cancel amount {amount} exceeds unbonding entry "
                f"{entry_amount}"
            )
        if amount == entry_amount:
            self.store.delete(entry_key)
        else:
            self.store.set(entry_key, (entry_amount - amount).to_bytes(16, "big"))
        bank.send(NOT_BONDED_POOL, BONDED_POOL, amount)
        self._set_delegation(
            delegator, validator, self.delegation(delegator, validator) + amount
        )
        self._set_tokens(validator, self.tokens(validator) + amount)

    def begin_redelegate(
        self, delegator: str, src: str, dst: str, amount: int
    ) -> None:
        """MsgBeginRedelegate: bonded tokens move validators instantly
        (they never leave the bonded pool, as in the sdk)."""
        if src == dst:
            raise StakingError("cannot redelegate to the same validator")
        held = self.delegation(delegator, src)
        if amount <= 0 or amount > held:
            raise StakingError(f"invalid redelegation {amount} (delegated: {held})")
        if not self.has_validator(dst):
            raise StakingError(f"no validator {dst}")
        self._set_delegation(delegator, src, held - amount)
        self._set_tokens(src, self.tokens(src) - amount)
        self._set_delegation(delegator, dst, self.delegation(delegator, dst) + amount)
        self._set_tokens(dst, self.tokens(dst) + amount)

    def min_self_delegation(self, validator: str) -> int:
        raw = self.store.get(b"staking/minself/" + validator.encode())
        return int(raw.decode()) if raw else 0

    def _set_min_self_delegation(self, validator: str, amount: int) -> None:
        self.store.set(
            b"staking/minself/" + validator.encode(), str(amount).encode()
        )

    def create_validator(
        self, bank, dist, operator: str, pubkey: bytes,
        delegator: str, self_stake: int, commission_rate_raw: int = 0,
        min_self_delegation: int = 0,
    ) -> None:
        """MsgCreateValidator: a NEW validator joins with an escrowed
        self-delegation (unlike genesis validators' notional power).  The
        bonded set — consensus votes, signal tallies, blobstream valsets,
        reward allocation — picks it up from the next block."""
        if self.has_validator(operator):
            raise StakingError(f"validator {operator} already exists")
        if self_stake <= 0:
            raise StakingError("self delegation must be positive")
        if not pubkey:
            raise StakingError("validator needs a consensus pubkey")
        # One consensus key, one validator (sdk ErrValidatorPubKeyExists):
        # a shared key would let one signer double-count its power toward
        # the +2/3 quorum under two bonded-set entries.
        for v in self.validators():
            if v.pubkey == pubkey:
                raise StakingError(
                    f"consensus pubkey already used by validator {v.address}"
                )
        self.set_validator(Validator(operator, pubkey, 0))
        if commission_rate_raw:
            from celestia_app_tpu_torch.state.dec import Dec

            dist.set_commission_rate(operator, Dec(commission_rate_raw))
        if min_self_delegation:
            self._set_min_self_delegation(operator, min_self_delegation)
        self.delegate(bank, delegator, operator, self_stake)

    def complete_unbondings(self, bank, time_ns: int) -> list[tuple[str, int]]:
        """End blocker: release matured unbonding entries.  Returns the
        (delegator, amount) payouts."""
        released = []
        for key, val in self.store.iterate(_UBD_PREFIX):
            completion_ns, delegator, _, _ = self._ubd_parse(key)
            if completion_ns > time_ns:
                continue
            amount = int.from_bytes(val, "big")
            bank.send(NOT_BONDED_POOL, delegator, amount)
            self.store.delete(key)
            released.append((delegator, amount))
        return released
