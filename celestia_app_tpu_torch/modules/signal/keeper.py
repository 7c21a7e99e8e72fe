"""x/signal: validator-signaled rolling upgrades (v2+).

Behavioral parity with reference x/signal/keeper.go: validators signal an
app version; MsgTryUpgrade tallies power and, on a 5/6 quorum, schedules the
upgrade DefaultUpgradeHeightDelay blocks out.  The app's EndBlocker consumes
ShouldUpgrade (app/app.go:472-477).
"""

from __future__ import annotations

from dataclasses import dataclass

from celestia_app_tpu_torch.state.store import KVStore

# 7 days at 12s blocks (x/signal/keeper.go:18).
DEFAULT_UPGRADE_HEIGHT_DELAY = 7 * 24 * 60 * 60 // 12  # 50,400
THRESHOLD_NUM, THRESHOLD_DEN = 5, 6

_SIGNAL_PREFIX = b"signal/vote/"
_UPGRADE_KEY = b"signal/upgrade"


class SignalError(ValueError):
    pass


@dataclass(frozen=True)
class Upgrade:
    app_version: int
    upgrade_height: int


class SignalKeeper:
    def __init__(self, store: KVStore, staking):
        self.store = store
        self.staking = staking  # needs: get_power(addr) -> int, total_power() -> int, has_validator(addr) -> bool

    # --- msg handlers -----------------------------------------------------
    def signal_version(self, validator: str, version: int, current_version: int) -> None:
        if self.pending_upgrade() is not None:
            raise SignalError("upgrade pending: cannot signal")
        if version < current_version:
            raise SignalError(
                f"signalled version {version} < current version {current_version}"
            )
        if not self.staking.has_validator(validator):
            raise SignalError(f"no validator {validator}")
        self.store.set(_SIGNAL_PREFIX + validator.encode(), version.to_bytes(8, "big"))

    def try_upgrade(self, height: int, current_version: int) -> Upgrade | None:
        if self.pending_upgrade() is not None:
            raise SignalError("upgrade pending: cannot try upgrade")
        has_quorum, version = self.tally()
        if not has_quorum:
            return None
        if version <= current_version:
            raise SignalError(
                f"cannot upgrade to {version} <= current version {current_version}"
            )
        up = Upgrade(version, height + DEFAULT_UPGRADE_HEIGHT_DELAY)
        self.store.set(
            _UPGRADE_KEY,
            up.app_version.to_bytes(8, "big") + up.upgrade_height.to_bytes(8, "big"),
        )
        return up

    # --- tally ------------------------------------------------------------
    def version_tally(self, version: int) -> tuple[int, int, int]:
        """(signalled_power, threshold_power, total_power) for a version."""
        total = self.staking.total_power()
        power = 0
        for key, val in self.store.iterate(_SIGNAL_PREFIX):
            addr = key[len(_SIGNAL_PREFIX) :].decode()
            if int.from_bytes(val, "big") == version:
                power += self.staking.get_power(addr)
        threshold = -(-(total * THRESHOLD_NUM) // THRESHOLD_DEN)  # ceil(5/6 total)
        return power, threshold, total

    def tally(self) -> tuple[bool, int]:
        """Highest version with quorum, if any."""
        versions = {
            int.from_bytes(v, "big") for _, v in self.store.iterate(_SIGNAL_PREFIX)
        }
        for version in sorted(versions, reverse=True):
            power, threshold, _ = self.version_tally(version)
            if power >= threshold:
                return True, version
        return False, 0

    # --- upgrade lifecycle ------------------------------------------------
    def pending_upgrade(self) -> Upgrade | None:
        raw = self.store.get(_UPGRADE_KEY)
        if raw is None:
            return None
        return Upgrade(
            int.from_bytes(raw[:8], "big"), int.from_bytes(raw[8:], "big")
        )

    def should_upgrade(self, height: int) -> Upgrade | None:
        up = self.pending_upgrade()
        if up is not None and height >= up.upgrade_height:
            return up
        return None

    def reset_tally(self) -> None:
        for key, _ in self.store.iterate(_SIGNAL_PREFIX):
            self.store.delete(key)
        self.store.delete(_UPGRADE_KEY)
