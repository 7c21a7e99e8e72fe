"""Chaos seams + graceful degradation (see chaos/spec.py, chaos/degrade.py).

Hot paths call the module-level seam helpers below; with no chaos
configured each is one cached-injector check (no env parse, no RNG draw),
so the seams cost nothing in production.

Activation, in precedence order:
  * `install(spec_str)` — programmatic (tests, scripts/chaos_soak.py);
  * `$CELESTIA_CHAOS`    — the env spec, re-parsed when the string changes
    so a test flipping the env mid-process takes effect.

`uninstall()` drops a programmatic install.

The port's copy of celestia_app_tpu/chaos/__init__.py, whole, and
chaos/degrade.py (the breaker, the ladder, `guarded_dispatch`,
`reset_for_tests`) with it.  Wired seams: `device_dispatch` (da/eds,
parallel/pipeline, da/repair through guarded_dispatch, and mid-panel in
kernels/panel and kernels/panel_sharded), `device_upload`
(parallel/pipeline), `extend_shard` (kernels/panel_sharded),
`mempool_insert` (mempool.py), `gossip_send` (rpc/transport.py),
`wal_torn_tail` (consensus/wal.py), `rpc_handle` (rpc/server.py) and the
proof seams: `proof_serve` (serve/sampler) and `proof_verify`
(serve/verify) retried on the card (degrade.retry_on_card), then a
device.DeviceFault; `proof_shard` (serve/shard) down to the single-device
read on the same card.  `active_adversary()` is the protocol adversary
(chaos/adversary.py) of the spec's adversary keys.
"""

from __future__ import annotations

import os

from celestia_app_tpu_torch.chaos.spec import (  # noqa: F401  (public surface)
    SEAMS,
    ChaosInjected,
    ChaosInjector,
    parse_spec,
    validate_params,
)

_INSTALLED: ChaosInjector | None = None
# (raw env string, injector-or-None) — the parse cache for the env path.
_ENV_CACHE: tuple[str, ChaosInjector | None] = ("", None)


def install(spec: str | dict) -> ChaosInjector:
    """Install a chaos spec for this process (overrides $CELESTIA_CHAOS)."""
    global _INSTALLED
    # Both activation shapes get key validation — a typo'd fault name in
    # a dict must fail as loudly as one in the env string.
    params = (
        parse_spec(spec) if isinstance(spec, str)
        else validate_params(dict(spec))
    )
    _INSTALLED = ChaosInjector(
        params, raw=spec if isinstance(spec, str) else ""
    )
    return _INSTALLED


def uninstall() -> None:
    global _INSTALLED
    _INSTALLED = None


def injector() -> ChaosInjector | None:
    """The active injector, or None when no chaos is configured."""
    global _ENV_CACHE
    if _INSTALLED is not None:
        return _INSTALLED
    raw = os.environ.get("CELESTIA_CHAOS", "")
    cached_raw, cached = _ENV_CACHE
    if raw == cached_raw:
        return cached
    inj = ChaosInjector(parse_spec(raw), raw=raw) if raw.strip() else None
    _ENV_CACHE = (raw, inj)
    return inj


# --- seam helpers (the names hot paths import) ------------------------------

def device_dispatch(mode: str) -> None:
    inj = injector()
    if inj is not None:
        inj.device_dispatch(mode)


def device_upload() -> None:
    inj = injector()
    if inj is not None:
        inj.device_upload()


def gossip_send() -> dict:
    inj = injector()
    return inj.gossip_send() if inj is not None else {}


def wal_torn_tail() -> bytes | None:
    inj = injector()
    return inj.wal_torn_tail() if inj is not None else None


def rpc_handle() -> None:
    inj = injector()
    if inj is not None:
        inj.rpc_handle()


def mempool_insert(shard: int | None = None) -> bool:
    inj = injector()
    return inj.mempool_insert(shard=shard) if inj is not None else False


def proof_serve() -> None:
    inj = injector()
    if inj is not None:
        inj.proof_serve()


def proof_verify() -> None:
    inj = injector()
    if inj is not None:
        inj.proof_verify()


def proof_shard() -> None:
    inj = injector()
    if inj is not None:
        inj.proof_shard()


def extend_shard() -> None:
    inj = injector()
    if inj is not None:
        inj.extend_shard()


def active_adversary():
    """The active protocol adversary (chaos/adversary.Adversary), or
    None — honest paths and specs with every adversary key at 0 both
    land here.  (Named to avoid shadowing by the chaos.adversary
    submodule attribute once that module is imported.)"""
    inj = injector()
    return inj.adversary() if inj is not None else None
