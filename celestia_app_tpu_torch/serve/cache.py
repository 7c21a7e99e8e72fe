"""ForestCache: the EDS and both NMT forests of recent heights, on the device.

At admission one forest build (kernels/fused.forest: one leaf-hash launch
and one node launch per level and axis) turns the retained EDS into two
flat (N, 90) tensors holding every node of every row and column tree,
indexable by (tree, level, index) through forest_level_layout; a batch of
DAS sample proofs is then two gathers (serve/sampler.py) and no hashing.
At k=512 one height holds the 537 MB EDS and two 188.6 MB forests
(2k * (4k - 1) * 90 B each).

Tiers, all bounded:

  device  the last $CELESTIA_SERVE_HEIGHTS heights, LRU;
  host    the next $CELESTIA_SERVE_SPILL evicted heights as CPU tensors
          (the same bytes; the gathers run on the host);
  gone    beyond that the entry drops.

Under $CELESTIA_SERVE_SHARDS > 1 admission goes through serve/shard.py:
both forests are row-partitioned over a serve mesh and gathers read each
row on its shard; an EDS that arrives row-sharded (the sharded extend
lowerings) stays so, and share reads go to the owning shard.

Admissions, re-admissions (`readmit`, the healing loop's: serve/heal.py)
and the heights they push down a tier write `forest_cache` trace rows (the
height timeline's retention signal); evictions tick
celestia_serve_cache_evictions_total{tier}, residency is the gauge
celestia_serve_cache_resident{tier}, lookups tick
celestia_serve_cache_{hits,misses}_total, and the device-tier bytes of every
live cache are the device ledger's owner `serve_forest_cache`.

The port of celestia_app_tpu/serve/cache.py, whole.  `readmit` waits for its
forest build on the card before it publishes the entry, since the healing
loop builds on its own thread while the block path extends.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import OrderedDict

import numpy as np
import torch

from celestia_app_tpu_torch import merkle
from celestia_app_tpu_torch.constants import SHARE_SIZE
from celestia_app_tpu_torch.device import resolve_device
# `forest` is read from here by serve/shard.build_entry, the admission seam.
from celestia_app_tpu_torch.kernels.fused import forest, forest_level_layout  # noqa: F401
from celestia_app_tpu_torch.trace.device_ledger import register_owner as _register_owner


def serve_heights() -> int:
    """$CELESTIA_SERVE_HEIGHTS: heights kept on the device (LRU size); 0
    disables retention."""
    try:
        return int(os.environ.get("CELESTIA_SERVE_HEIGHTS", "4") or "4")
    except ValueError:
        return 4


def spill_heights() -> int:
    """$CELESTIA_SERVE_SPILL: heights kept on the host after eviction from
    the device tier; default twice the device tier."""
    try:
        raw = os.environ.get("CELESTIA_SERVE_SPILL", "")
        return int(raw) if raw else 2 * serve_heights()
    except ValueError:
        return 2 * serve_heights()


def _nbytes(t) -> int:
    """Bytes of a tensor, or of every block of a row-sharded one."""
    return sum(int(b.numel()) * b.element_size() for b in getattr(t, "blocks", (t,)))


def _caches_owned_bytes() -> int:
    """Device-tier bytes held by every live ForestCache: the retained EDS
    and both flat forests of each resident height.  Spilled (host-tier)
    entries are host memory, reported elsewhere."""
    total = 0
    for cache in list(_ALL_CACHES):
        with cache._lock:
            entries = list(cache._device.values())
        for e in entries:
            try:
                total += _nbytes(e.eds._eds) + _nbytes(e.row_flat) + _nbytes(e.col_flat)
            except Exception:  # chaos-ok: entry mid-spill or deleted
                continue
    return total


_ALL_CACHES: "weakref.WeakSet[ForestCache]" = weakref.WeakSet()

_register_owner("serve_forest_cache", _caches_owned_bytes)


class _ForestLineTree:
    """The `levels()` surface of one row or column tree, backed by the flat
    forest: what eds.row_tree returns while a forest is attached, so
    nmt.proof.prove_range_from_levels assembles proofs by indexing."""

    def __init__(self, forest: "CachedForest", axis: str, index: int):
        self._forest = forest
        self._axis = axis
        self._index = index
        self._levels: list[list[bytes]] | None = None

    def levels(self) -> list[list[bytes]]:
        if self._levels is None:
            self._levels = self._forest.line_levels(self._axis, self._index)
        return self._levels

    def root(self) -> bytes:
        return self.levels()[-1][0]


def _take(t: torch.Tensor, idx) -> np.ndarray:
    """Rows `idx` of a 2-D tensor, gathered where it lies, as host bytes."""
    index = torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(t.device)
    return t.index_select(0, index).cpu().numpy()


class CachedForest:
    """One height's retained proof state: the EDS handle, both flat forests,
    the host root lists and the memoized data-root tree levels (so RowProof
    audit paths are indexing too).  `spill()` moves the tensors to the
    host; every accessor returns the same bytes on either tier."""

    def __init__(self, height: int, eds, row_flat: torch.Tensor, col_flat: torch.Tensor):
        self.height = height
        self.k = eds.k
        self.eds = eds
        self.device_resident = True
        # Provenance for the healing loop (serve/heal.py): `owner` is the
        # admitting ForestCache (a detection goes to the engine whose
        # cache owns the sampled entry); `healed` marks a height recovered
        # by repair and root-verified here, served without the adversary's
        # withholding and tampering (the adversary sits between this node
        # and the network, not between the node and its verified store).
        self.owner = None
        self.healed = False
        self.row_flat = row_flat  # (N, 90): every row-tree level, flat
        self.col_flat = col_flat
        # Share sharding: an EDS that arrived row-sharded over an extend
        # mesh is kept as it is, and share reads go to the owning shard.
        from celestia_app_tpu_torch.serve.shard import eds_share_layout

        layout = eds_share_layout(eds._eds)
        self.share_shards = layout[2] if layout is not None else 0
        self.widths, self.offsets = forest_level_layout(self.k)
        self.row_roots = eds.row_roots()
        self.col_roots = eds.col_roots()
        self.data_root = eds.data_root()
        self.root_levels = merkle.levels_from_leaves(self.row_roots + self.col_roots)
        eds.attach_forest(self)

    def flat_index(self, tree: int, level: int, index: int) -> int:
        """Flat row of node (tree, level, index): forest_level_layout's
        contract, shared with the sampler's index plan."""
        return self.offsets[level] + tree * self.widths[level] + index

    def gather(self, axis: str, flat_indices) -> np.ndarray:
        """(len(flat_indices), 90) node bytes in one gather."""
        return _take(self.row_flat if axis == "row" else self.col_flat, flat_indices)

    def gather_device(self, axis: str, flat_indices) -> torch.Tensor:
        """The rows of `gather`, left where the forest lies (the healing
        loop's survivor check compares them on the card)."""
        flat = self.row_flat if axis == "row" else self.col_flat
        index = torch.as_tensor(np.asarray(flat_indices, dtype=np.int64)).to(flat.device)
        return flat.index_select(0, index)

    def gather_shares(self, coords) -> np.ndarray:
        """(B, SHARE_SIZE) shares of [(row, col), ...] in one gather.  A
        row-sharded EDS (the sharded extend lowerings') answers with each
        coordinate read on the shard that owns its row, never gathered onto
        one device (serve/shard.sharded_share_gather)."""
        from celestia_app_tpu_torch.serve.shard import sharded_share_gather

        n = 2 * self.k
        buf = self.eds._eds
        out = sharded_share_gather(buf, coords)
        if out is not None:
            return out
        return _take(buf.reshape(n * n, SHARE_SIZE), [r * n + c for r, c in coords])

    def line_levels(self, axis: str, index: int) -> list[list[bytes]]:
        """Every digest level of one tree, as host bytes (one gather)."""
        idx = [self.flat_index(index, lvl, i) for lvl, w in enumerate(self.widths)
               for i in range(w)]
        blob = self.gather(axis, idx).tobytes()
        levels: list[list[bytes]] = []
        pos = 0
        for w in self.widths:
            levels.append([blob[(pos + i) * 90:(pos + i + 1) * 90] for i in range(w)])
            pos += w
        return levels

    def line_tree(self, axis: str, index: int) -> _ForestLineTree:
        return _ForestLineTree(self, axis, index)

    def spill(self) -> None:
        """Device -> host: the EDS and both forests become CPU tensors (the
        proofs keep serving; the gathers run in host memory)."""
        if not self.device_resident:
            return
        self.row_flat = self.row_flat.cpu()
        self.col_flat = self.col_flat.cpu()
        self.eds._eds = self.eds._eds.cpu()
        self.device_resident = False
        self.share_shards = 0  # the host copy is one tensor, unsharded


class ForestCache:
    """LRU over heights with a device and a host tier; thread-safe.  Forests
    are built on `device` (default CUDA; raises without a card), and laid
    out over `mesh` when one is given (serve/shard.build_entry), else over
    the $CELESTIA_SERVE_SHARDS mesh."""

    def __init__(self, heights: int | None = None, spill: int | None = None, device=None,
                 mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self._heights = heights
        self._spill = spill
        self._lock = threading.Lock()
        self._device: OrderedDict[int, CachedForest] = OrderedDict()
        self._host: OrderedDict[int, CachedForest] = OrderedDict()
        self._hits = {"device": 0, "host": 0}
        self._misses = 0
        self._last_eviction: int | None = None
        # One build per height: concurrent puts of one height wait for the
        # first instead of each building (and holding) a forest.
        self._building: dict[int, threading.Lock] = {}
        _ALL_CACHES.add(self)

    def _capacity(self) -> tuple[int, int]:
        return (self._heights if self._heights is not None else serve_heights(),
                self._spill if self._spill is not None else spill_heights())

    def _build(self, height: int, eds) -> tuple[CachedForest, float]:
        """(entry, build ms): serve/shard.build_entry, owned by this cache."""
        from celestia_app_tpu_torch.serve.shard import build_entry

        t0 = time.perf_counter()
        entry = build_entry(height, eds, self.device, self.mesh)
        entry.owner = self
        return entry, (time.perf_counter() - t0) * 1e3

    def put(self, height: int, eds) -> CachedForest | None:
        """Retain one height: build its forest (serve/shard.build_entry:
        row-partitioned over the serve mesh under $CELESTIA_SERVE_SHARDS > 1)
        and admit it to the device tier, pushing the oldest down the tiers.
        None when retention is disabled ($CELESTIA_SERVE_HEIGHTS=0)."""
        cap, spill_cap = self._capacity()
        if cap <= 0:
            return None
        with self._lock:
            existing = self._device.get(height)
            if existing is not None:
                self._device.move_to_end(height)
                return existing
            gate = self._building.setdefault(height, threading.Lock())
        try:
            with gate:
                with self._lock:
                    existing = self._device.get(height)
                    if existing is not None:  # a concurrent put built it
                        self._device.move_to_end(height)
                        return existing
                entry, build_ms = self._build(height, eds)
                # Admitted inside the gate: the next put through it must
                # find the entry resident.
                spilled, dropped = self._admit(entry, cap, spill_cap)
        finally:
            with self._lock:
                self._building.pop(height, None)
        self._settle("admit", height, build_ms, spilled, dropped)
        return entry

    def _admit(self, entry: CachedForest, cap: int, spill_cap: int
               ) -> tuple[list[int], list[int]]:
        """Insert `entry` at the device tier's MRU end (replacing a resident
        entry of its height), spill device overflow to the host tier and
        drop host overflow; returns (spilled heights, dropped heights)."""
        spilled: list[int] = []
        dropped: list[int] = []
        with self._lock:
            self._host.pop(entry.height, None)
            self._device[entry.height] = entry
            self._device.move_to_end(entry.height)
            while len(self._device) > cap:
                h, old = self._device.popitem(last=False)
                self._last_eviction = h
                old.spill()
                self._host[h] = old
                spilled.append(h)
            while len(self._host) > spill_cap:
                h, _old = self._host.popitem(last=False)
                dropped.append(h)
        return spilled, dropped

    def _settle(self, event: str, height: int, build_ms: float, spilled: list[int],
                dropped: list[int]) -> None:
        """What every (re-)admission does after it: trace rows, eviction
        counts, the residency gauge, and the adversary's memo of the
        height dropped."""
        self._trace_admission(event, height, build_ms, spilled, dropped)
        self._count_evictions(len(spilled), len(dropped))
        self._publish_residency()
        self._invalidate_tamper_memo(height)

    def readmit(self, height: int, eds, *, healed: bool = True) -> CachedForest | None:
        """Repair-driven re-admission: install the RECOVERED (already
        root-verified: serve/heal.py's verify phase gates this call) square
        of a height, replacing whatever is resident.

        Rides the same per-height gate as `put`, so a heal racing a rebuild
        on a miss coalesces: when the gate opens on an entry already serving
        the same data root, that entry is KEPT (one forest build in all; its
        retention pins untouched) and only marked healed.  Either way the
        adversary's tampered view of the height is dropped, so the recovery
        shows on the next request.  The forest build is waited for on the
        card before the entry is published."""
        cap, spill_cap = self._capacity()
        if cap <= 0:  # retention disabled: nothing to re-admit into
            self._invalidate_tamper_memo(height)
            return None
        with self._lock:
            gate = self._building.setdefault(height, threading.Lock())
        root = eds.data_root()
        try:
            with gate:
                with self._lock:
                    existing = self._device.get(height) or self._host.get(height)
                if existing is not None and existing.data_root == root:
                    entry = existing
                    entry.healed = entry.healed or healed
                    spilled, dropped = [], []
                    build_ms = 0.0
                    with self._lock:
                        for store in (self._device, self._host):
                            if height in store:
                                store.move_to_end(height)
                else:
                    entry, build_ms = self._build(height, eds)
                    _synchronize(self.device)
                    entry.healed = healed
                    spilled, dropped = self._admit(entry, cap, spill_cap)
        finally:
            with self._lock:
                self._building.pop(height, None)
        self._settle("readmit", height, build_ms, spilled, dropped)
        return entry

    @staticmethod
    def _invalidate_tamper_memo(height: int) -> None:
        """Every (re-)admission drops the adversary's memoized tampered view
        of the height: a re-admitted square is new state, and serving the
        stale view would hide the recovery.  Never raises."""
        try:
            from celestia_app_tpu_torch import chaos

            adv = chaos.active_adversary()
            if adv is not None:
                adv.invalidate_tampered(height)
        except Exception:  # chaos-ok: admission must not depend on chaos state
            pass

    @staticmethod
    def _trace_admission(event: str, height: int, build_ms: float,
                         spilled: list[int], dropped: list[int]) -> None:
        """One `forest_cache` row per admission (with the forest build's
        ms) and one per height it pushed down a tier: the height timeline's
        retention signal (trace/timeline.py)."""
        from celestia_app_tpu_torch.trace.tracer import traced

        tracer = traced()
        tracer.write("forest_cache", event=event, height=height,
                     forest_build_ms=round(build_ms, 3))
        for h in spilled:
            tracer.write("forest_cache", event="spill", height=h)
        for h in dropped:
            tracer.write("forest_cache", event="drop", height=h)

    def _count_evictions(self, spilled: int, dropped: int) -> None:
        if not (spilled or dropped):
            return
        from celestia_app_tpu_torch.trace.metrics import registry

        ev = registry().counter(
            "celestia_serve_cache_evictions_total",
            "serve-cache evictions by destination tier "
            "(device->host spill; host->dropped)",
        )
        if spilled:
            ev.inc(spilled, tier="host")
        if dropped:
            ev.inc(dropped, tier="dropped")

    def _publish_residency(self) -> None:
        from celestia_app_tpu_torch.trace.metrics import registry

        gauge = registry().gauge(
            "celestia_serve_cache_resident",
            "heights resident in the serve cache, by tier",
        )
        with self._lock:
            gauge.set(len(self._device), tier="device")
            gauge.set(len(self._host), tier="host")

    def get(self, height: int) -> tuple[CachedForest | None, str]:
        """(entry, tier) where tier is "device", "host" or "miss"."""
        from celestia_app_tpu_torch.trace.metrics import registry

        entry, tier = None, "miss"
        with self._lock:
            for name, store in (("device", self._device), ("host", self._host)):
                entry = store.get(height)
                if entry is not None:
                    store.move_to_end(height)
                    self._hits[name] += 1
                    tier = name
                    break
            else:
                self._misses += 1
        if entry is not None:
            registry().counter(
                "celestia_serve_cache_hits_total",
                "serve-cache lookups answered, by tier",
            ).inc(tier=tier)
        else:
            registry().counter(
                "celestia_serve_cache_misses_total",
                "serve-cache lookups that fell through to a rebuild",
            ).inc()
        return entry, tier

    def contains(self, height: int) -> bool:
        """Residency on any tier, without touching the hit counts (the
        healing engine's "is this height mine" check)."""
        with self._lock:
            return height in self._device or height in self._host

    def stats(self) -> dict:
        """Residency, hits, misses, hit ratio, the last eviction and, under
        $CELESTIA_SERVE_SHARDS > 1, the "mesh" view (serve/shard.mesh_stats:
        shard count, axis, per-shard resident forest bytes; else None)."""
        from celestia_app_tpu_torch.serve.shard import mesh_stats

        with self._lock:
            hits = dict(self._hits)
            total = hits["device"] + hits["host"] + self._misses
            entries = list(self._device.values())
            out = {
                "device_heights": sorted(self._device),
                "host_heights": sorted(self._host),
                "hits": hits,
                "misses": self._misses,
                "hit_ratio": (round((hits["device"] + hits["host"]) / total, 4)
                              if total else None),
                "last_eviction": self._last_eviction,
            }
        out["mesh"] = mesh_stats(entries)
        return out

    def reset_for_tests(self) -> None:
        with self._lock:
            self._device.clear()
            self._host.clear()
            self._hits = {"device": 0, "host": 0}
            self._misses = 0
            self._last_eviction = None


def _synchronize(device: torch.device) -> None:
    """Wait for the work queued on `device` (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
