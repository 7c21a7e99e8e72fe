"""Auth + bank state keepers over the KV store.

The minimal stateful substrate the reference app needs from cosmos-sdk
auth/bank for its tx flow: account numbers/sequences/pubkeys for signature
checks (ante), balances for fees and sends, module accounts for fee
collection and minting.

Vesting accounts (the reference wires x/auth/vesting, app/modules.go:105)
are base accounts with a lock schedule: `Account.locked(time_ns)` is the
still-vesting amount, and `send_spendable` refuses transfers that would dip
into it.  As in the sdk, locked tokens CAN be delegated (staking escrows
bypass the spendable check) — the lock follows the account, not the coins,
so undelegated tokens return under the same schedule.
"""

from __future__ import annotations

from dataclasses import dataclass

from celestia_app_tpu_torch.constants import BOND_DENOM
from celestia_app_tpu_torch.encoding.proto import (
    WIRE_LEN,
    WIRE_VARINT,
    decode_fields,
    encode_bytes_field,
    encode_varint_field,
)
from celestia_app_tpu_torch.state.store import KVStore

FEE_COLLECTOR = "fee_collector"
MINT_MODULE = "mint"

_ACC_PREFIX = b"auth/acc/"
_BAL_PREFIX = b"bank/bal/"
_SUPPLY_KEY = b"bank/supply/"
_GLOBAL_ACC_NUM = b"auth/global_account_number"


VESTING_NONE = 0
VESTING_CONTINUOUS = 1  # linear release between start and end
VESTING_DELAYED = 2  # everything releases at end
VESTING_PERIODIC = 3  # stepwise release per (length, amount) period
VESTING_PERMANENT = 4  # never releases (sdk PermanentLockedAccount)


@dataclass
class Account:
    address: str
    pubkey: bytes  # 33-byte compressed secp256k1, b"" until first known
    account_number: int
    sequence: int
    # Vesting schedule (x/auth/vesting Continuous/DelayedVestingAccount);
    # all-zero for base accounts, and all-zero accounts marshal exactly as
    # before these fields existed (no state-layout break).
    vesting_type: int = VESTING_NONE
    original_vesting: int = 0
    vesting_start_ns: int = 0
    vesting_end_ns: int = 0
    # Locked tokens currently delegated (sdk DelegatedVesting): they are
    # out of the balance, so the lock must not double-count them or
    # later-received liquid funds would freeze.
    delegated_vesting: int = 0
    # Periodic schedule (sdk PeriodicVestingAccount.VestingPeriods):
    # (length_ns, amount) steps releasing cumulatively from start.
    vesting_periods: tuple[tuple[int, int], ...] = ()

    def marshal(self) -> bytes:
        out = (
            encode_bytes_field(1, self.address.encode())
            + encode_bytes_field(2, self.pubkey)
            + encode_varint_field(3, self.account_number)
            + encode_varint_field(4, self.sequence)
        )
        if self.vesting_type:
            out += (
                encode_varint_field(5, self.vesting_type)
                + encode_varint_field(6, self.original_vesting)
                + encode_varint_field(7, self.vesting_start_ns)
                + encode_varint_field(8, self.vesting_end_ns)
                + encode_varint_field(9, self.delegated_vesting)
            )
            for length_ns, amount in self.vesting_periods:
                out += encode_bytes_field(
                    10,
                    encode_varint_field(1, length_ns)
                    + encode_varint_field(2, amount),
                )
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Account":
        addr, pk = "", b""
        ints = {}
        periods: list[tuple[int, int]] = []
        for fnum, wt, val in decode_fields(raw):
            if fnum == 1 and wt == WIRE_LEN:
                addr = val.decode()
            elif fnum == 2 and wt == WIRE_LEN:
                pk = val
            elif fnum == 10 and wt == WIRE_LEN:
                p = {n: v for n, w, v in decode_fields(val) if w == WIRE_VARINT}
                periods.append((p.get(1, 0), p.get(2, 0)))
            elif wt == WIRE_VARINT:
                ints[fnum] = val
        return cls(
            addr, pk, ints.get(3, 0), ints.get(4, 0),
            ints.get(5, 0), ints.get(6, 0), ints.get(7, 0), ints.get(8, 0),
            ints.get(9, 0), tuple(periods),
        )

    def _schedule_locked(self, time_ns: int) -> int:
        if self.vesting_type == VESTING_NONE or self.original_vesting == 0:
            return 0
        if self.vesting_type == VESTING_PERMANENT:
            # sdk PermanentLockedAccount: never vests.
            return self.original_vesting
        if self.vesting_type == VESTING_PERIODIC:
            # Stepwise: each period's amount releases when its cumulative
            # length elapses past start (sdk periodic_vesting_account.go).
            if time_ns <= self.vesting_start_ns:
                return self.original_vesting
            vested = 0
            t = self.vesting_start_ns
            for length_ns, amount in self.vesting_periods:
                t += length_ns
                if time_ns < t:
                    break
                vested += amount
            return max(0, self.original_vesting - vested)
        if time_ns >= self.vesting_end_ns:
            return 0
        if self.vesting_type == VESTING_DELAYED:
            return self.original_vesting
        # Continuous: vested grows linearly from start to end (truncating,
        # as sdk's coin arithmetic does); nothing vests before start.
        if time_ns <= self.vesting_start_ns:
            return self.original_vesting
        elapsed = time_ns - self.vesting_start_ns
        duration = self.vesting_end_ns - self.vesting_start_ns
        vested = self.original_vesting * elapsed // duration
        return self.original_vesting - vested

    def locked(self, time_ns: int) -> int:
        """Still-vesting tokens encumbering the BALANCE at `time_ns`
        (sdk LockedCoins = schedule minus DelegatedVesting: locked tokens
        sitting in the staking escrow are no longer in the balance)."""
        return max(0, self._schedule_locked(time_ns) - self.delegated_vesting)

    def track_delegation(self, amount: int, time_ns: int) -> None:
        """Called when this account delegates (sdk TrackDelegation):
        delegations consume locked tokens first."""
        still_locked = self.locked(time_ns)
        self.delegated_vesting += min(amount, still_locked)

    def track_undelegation(self, amount: int) -> None:
        """Called when this account undelegates (sdk TrackUndelegation)."""
        self.delegated_vesting -= min(self.delegated_vesting, amount)


class AuthKeeper:
    def __init__(self, store: KVStore):
        self.store = store

    def get_account(self, address: str) -> Account | None:
        raw = self.store.get(_ACC_PREFIX + address.encode())
        return Account.unmarshal(raw) if raw is not None else None

    def set_account(self, acc: Account) -> None:
        self.store.set(_ACC_PREFIX + acc.address.encode(), acc.marshal())

    def create_account(self, address: str, pubkey: bytes = b"") -> Account:
        n = int.from_bytes(self.store.get(_GLOBAL_ACC_NUM) or b"\x00", "big")
        self.store.set(_GLOBAL_ACC_NUM, (n + 1).to_bytes(8, "big"))
        acc = Account(address, pubkey, n, 0)
        self.set_account(acc)
        return acc

    def get_or_create(self, address: str) -> Account:
        return self.get_account(address) or self.create_account(address)


class BankKeeper:
    def __init__(self, store: KVStore):
        self.store = store

    def _key(self, address: str, denom: str) -> bytes:
        return _BAL_PREFIX + address.encode() + b"/" + denom.encode()

    def balance(self, address: str, denom: str = BOND_DENOM) -> int:
        raw = self.store.get(self._key(address, denom))
        return int.from_bytes(raw, "big") if raw else 0

    def balances_of(self, address: str) -> dict[str, int]:
        """denom -> amount for one address (the bank AllBalances query):
        an address-scoped prefix walk, not the global supply walk."""
        prefix = _BAL_PREFIX + address.encode() + b"/"
        return {
            key[len(prefix):].decode(): int.from_bytes(val, "big")
            for key, val in self.store.iterate(prefix)
        }

    def _set_balance(self, address: str, denom: str, amount: int) -> None:
        if amount < 0:
            raise ValueError("negative balance")
        self.store.set(self._key(address, denom), amount.to_bytes(16, "big"))

    def send(self, sender: str, recipient: str, amount: int, denom: str = BOND_DENOM) -> None:
        bal = self.balance(sender, denom)
        if bal < amount:
            raise ValueError(
                f"insufficient funds: {sender} has {bal}{denom}, needs {amount}"
            )
        self._set_balance(sender, denom, bal - amount)
        self._set_balance(recipient, denom, self.balance(recipient, denom) + amount)

    def mint(self, recipient: str, amount: int, denom: str = BOND_DENOM) -> None:
        self._set_balance(recipient, denom, self.balance(recipient, denom) + amount)
        self._set_supply(denom, self.supply(denom) + amount)

    def burn(self, holder: str, amount: int, denom: str = BOND_DENOM) -> None:
        bal = self.balance(holder, denom)
        if bal < amount:
            raise ValueError("burn exceeds balance")
        self._set_balance(holder, denom, bal - amount)
        self._set_supply(denom, self.supply(denom) - amount)

    def supply(self, denom: str = BOND_DENOM) -> int:
        raw = self.store.get(_SUPPLY_KEY + denom.encode())
        return int.from_bytes(raw, "big") if raw else 0

    def _set_supply(self, denom: str, amount: int) -> None:
        self.store.set(_SUPPLY_KEY + denom.encode(), amount.to_bytes(16, "big"))

    def balances(self) -> dict[tuple[str, str], int]:
        """(address, denom) -> amount over all accounts — the x/crisis
        supply invariant walks this.

        Split at the FIRST '/': bech32 addresses cannot contain one, but
        IBC voucher denoms do ("port/channel/denom") — an rsplit parsed
        "addr/transfer/channel-0/uatom" as address "addr/transfer/
        channel-0" holding "uatom", corrupting the supply walk."""
        out = {}
        for key, val in self.store.iterate(_BAL_PREFIX):
            addr, denom = key[len(_BAL_PREFIX):].split(b"/", 1)
            out[(addr.decode(), denom.decode())] = int.from_bytes(val, "big")
        return out


def assert_spendable(
    auth: AuthKeeper, bank: BankKeeper, sender: str, amount: int, time_ns: int
) -> None:
    """Raise unless `sender` can part with `amount` without dipping into
    still-vesting tokens (sdk LockedCoins).  Module accounts have no
    Account record and no lock."""
    acc = auth.get_account(sender)
    locked = acc.locked(time_ns) if acc is not None else 0
    if locked:
        bal = bank.balance(sender)
        if bal - amount < locked:
            raise ValueError(
                f"insufficient spendable funds: {sender} has {bal}utia with "
                f"{locked}utia still vesting, cannot send {amount}"
            )


def send_spendable(
    auth: AuthKeeper, bank: BankKeeper, sender: str, recipient: str,
    amount: int, time_ns: int,
) -> None:
    """A transfer that respects the sender's vesting lock: spendable =
    balance - locked (sdk bank SendCoins via LockedCoins)."""
    assert_spendable(auth, bank, sender, amount, time_ns)
    bank.send(sender, recipient, amount)
