"""Device-attribution ledger: the owner registry.

The big resident-bytes holders report the bytes they own, either through a
live `register_owner(name, callback)` or by `note_owned_bytes(owner, key,
nbytes)` at allocation time; `reconcile()` sums them by owner.  The mempool
registers its shards at import (mempool.py).

A partial copy of celestia_app_tpu/trace/device_ledger.py: the owner
registry and the owned-bytes sum of its `reconcile`, with the same names
and semantics.  The rest of the JAX ledger waits for the port's fault and
device plane (ROADMAP, queue 1 item 3), where it is to be built on
`torch.cuda.memory_stats`: the program ledger (`track`, compile and
dispatch seconds), the measured high-water and its unattributed residual,
the leak trigger of the flight recorder, the gauges and the /device
payload.
"""

from __future__ import annotations

import threading

__all__ = [
    "register_owner",
    "unregister_owner",
    "note_owned_bytes",
    "forget_owned_bytes",
    "reconcile",
    "_reset_for_tests",
]

_LOCK = threading.Lock()

#: owner name -> zero-arg callable returning currently owned bytes.
_OWNER_CALLBACKS: dict[str, object] = {}

#: owner name -> {key: nbytes} for allocation-time accounting
#: (note_owned_bytes) where no live object can answer a callback.
_OWNED_KEYED: dict[str, dict] = {}


def register_owner(name: str, callback) -> None:
    """Mount `callback()` -> currently-owned bytes under `name` in the
    ownership ledger.  Last registration per name wins (the health-
    provider convention); a callback that raises reports 0 for that
    reconciliation."""
    with _LOCK:
        _OWNER_CALLBACKS[str(name)] = callback


def unregister_owner(name: str) -> None:
    with _LOCK:
        _OWNER_CALLBACKS.pop(str(name), None)


def note_owned_bytes(owner: str, key, nbytes: int) -> None:
    """Allocation-time accounting for caches with no natural callback
    object: record that `owner` holds `nbytes` under `key`; re-noting a key
    replaces its figure."""
    with _LOCK:
        _OWNED_KEYED.setdefault(str(owner), {})[key] = max(0, int(nbytes))


def forget_owned_bytes(owner: str, key=None) -> None:
    """Drop one key's figure (or the whole owner with key=None) — the
    eviction half of note_owned_bytes."""
    with _LOCK:
        if key is None:
            _OWNED_KEYED.pop(str(owner), None)
        else:
            _OWNED_KEYED.get(str(owner), {}).pop(key, None)


def reconcile() -> dict:
    """Every owner's bytes and their sum: the `owners` and `owned_bytes`
    of the JAX ledger's reconciliation."""
    with _LOCK:
        callbacks = dict(_OWNER_CALLBACKS)
        keyed = {o: sum(d.values()) for o, d in _OWNED_KEYED.items()}
    owners: dict[str, int] = {}
    for name, cb in callbacks.items():
        try:
            owners[name] = max(0, int(cb()))
        except Exception:  # noqa: BLE001 — one bad owner must not hide the rest
            owners[name] = 0
    for name, total in keyed.items():
        owners[name] = owners.get(name, 0) + total
    return {
        "owners": {k: owners[k] for k in sorted(owners)},
        "owned_bytes": sum(owners.values()),
    }


def _reset_for_tests() -> None:
    """Drop every owner (test isolation); module-import-time registrations
    (the mempool's) must be re-registered by the test that needs them."""
    with _LOCK:
        _OWNER_CALLBACKS.clear()
        _OWNED_KEYED.clear()
