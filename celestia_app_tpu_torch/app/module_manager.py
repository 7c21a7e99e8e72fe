"""Versioned module manager (reference app/module/manager.go).

Every module declares the app-version range it is active in
(app/modules.go:96-189 VersionedModule list); when the signal-driven
upgrade bumps the app version, RunMigrations (manager.go:222) runs each
newly-active module's migration so state appears/disappears atomically with
the version change.  The reference's v1->v2 delta: x/signal and x/minfee
come alive, x/blobstream goes dormant (app/app.go:465-469).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from celestia_app_tpu_torch.modules.minfee import MinFeeKeeper


@dataclass(frozen=True)
class VersionedModule:
    name: str
    from_version: int
    to_version: int  # inclusive
    # migrate(ctx, from_v, to_v) runs when the module becomes active or its
    # consensus version advances across an upgrade.
    migrate: Callable | None = None


def _migrate_minfee(ctx, from_v: int, to_v: int) -> None:
    # v2 introduces the on-chain network min gas price with its default
    # (x/minfee/params.go:20-26).
    keeper = MinFeeKeeper(ctx.store)
    keeper.set_network_min_gas_price(keeper.network_min_gas_price())


DEFAULT_MODULES = (
    VersionedModule("auth", 1, 99),
    VersionedModule("bank", 1, 99),
    VersionedModule("staking", 1, 99),
    VersionedModule("mint", 1, 99),
    VersionedModule("blob", 1, 99),
    VersionedModule("paramfilter", 1, 99),
    VersionedModule("tokenfilter", 1, 99),
    VersionedModule("blobstream", 1, 1),  # v1 only
    VersionedModule("signal", 2, 99),
    VersionedModule("minfee", 2, 99, migrate=_migrate_minfee),
)


class ModuleManager:
    def __init__(self, modules: tuple[VersionedModule, ...] = DEFAULT_MODULES):
        by_name: dict[str, VersionedModule] = {}
        for m in modules:
            if m.from_version > m.to_version:
                raise ValueError(f"module {m.name}: bad version range")
            if m.name in by_name:
                raise ValueError(f"duplicate module {m.name}")
            by_name[m.name] = m
        self.modules = modules

    def active(self, app_version: int) -> list[str]:
        return [
            m.name
            for m in self.modules
            if m.from_version <= app_version <= m.to_version
        ]

    def is_active(self, name: str, app_version: int) -> bool:
        return name in self.active(app_version)

    def run_migrations(self, ctx, from_version: int, to_version: int) -> list[str]:
        """Run migrations for modules newly active in (from, to]; returns
        the migrated module names (RunMigrations, manager.go:222)."""
        migrated = []
        for m in self.modules:
            newly_active = (
                m.from_version > from_version and m.from_version <= to_version
            )
            if newly_active and m.migrate is not None:
                m.migrate(ctx, from_version, to_version)
            if newly_active:
                migrated.append(m.name)
        return migrated
