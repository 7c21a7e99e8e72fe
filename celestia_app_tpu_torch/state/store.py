"""Deterministic versioned KV store (the multistore analog).

Replaces the reference's IAVL-backed CommitMultiStore (app/app.go:435,
LoadHeight :592) with a dict-backed store whose commitment is a merkleized
trie (state/smt.py), preserving the contracts the app relies on:

  * deterministic app hash over committed state (consensus determinism,
    pinned by the reference's TestConsistentAppHash,
    app/test/consistent_apphash_test.go:47) — here the root of a
    path-compressed merkle trie, maintained incrementally: a commit
    re-hashes O(delta * log n) nodes, never the whole state;
  * key existence / non-existence proofs against the committed app hash
    (`CommitStore.proof`, verified by `state.smt.verify`);
  * branch/write-back semantics (CacheContext) for proposal handling and
    per-tx atomicity — branches are copy-on-write overlays, so taking one
    per tx costs O(writes in the tx), not O(state);
  * per-height committed versions for restart/rollback/export
    (checkpoint/resume, SURVEY §5). The per-height snapshot is one shallow
    dict copy per *block* (off the per-tx path).
"""

from __future__ import annotations

from celestia_app_tpu_torch.state import smt

_TOMBSTONE = None  # overlay marker for deletes


class KVStore:
    """A string->bytes map with copy-on-write branches and a merkle root.

    A root store owns the data dict and an incrementally-maintained merkle
    trie; `branch()` returns an overlay recording only its own writes.
    """

    def __init__(self, data: dict[bytes, bytes] | None = None, parent: "KVStore | None" = None):
        self._parent = parent
        if parent is None:
            self._data: dict[bytes, bytes] = dict(data) if data else {}
            self._trie = None
            self._dirty: set[bytes] = set(self._data)
            self._root_cache: bytes | None = None
        else:
            assert data is None
            self._writes: dict[bytes, bytes | None] = {}

    # --- reads ------------------------------------------------------------
    def get(self, key: bytes) -> bytes | None:
        node = self
        while node._parent is not None:
            if key in node._writes:
                return node._writes[key]
            node = node._parent
        return node._data.get(key)

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def iterate(self, prefix: bytes) -> list[tuple[bytes, bytes]]:
        """Deterministic (sorted) iteration over a key prefix."""
        merged: dict[bytes, bytes | None] = {}
        chain = []
        node = self
        while node._parent is not None:
            chain.append(node)
            node = node._parent
        for k, v in node._data.items():
            if k.startswith(prefix):
                merged[k] = v
        for overlay in reversed(chain):  # oldest overlay first, self last
            for k, v in overlay._writes.items():
                if k.startswith(prefix):
                    merged[k] = v
        return sorted((k, v) for k, v in merged.items() if v is not _TOMBSTONE)

    # --- writes -----------------------------------------------------------
    def set(self, key: bytes, value: bytes) -> None:
        if not isinstance(value, bytes):
            raise TypeError("store values must be bytes")
        if self._parent is not None:
            self._writes[key] = value
        else:
            self._data[key] = value
            self._dirty.add(key)
            self._root_cache = None

    def delete(self, key: bytes) -> None:
        if self._parent is not None:
            self._writes[key] = _TOMBSTONE
        else:
            self._data.pop(key, None)
            self._dirty.add(key)
            self._root_cache = None

    # --- branching --------------------------------------------------------
    def branch(self) -> "KVStore":
        """A copy-on-write overlay; apply back with `write_back`."""
        return KVStore(parent=self)

    def write_back(self, branch: "KVStore") -> None:
        """Apply an overlay's writes to this store (its direct parent)."""
        assert branch._parent is self, "write_back target must be the branch's parent"
        for k, v in branch._writes.items():
            if v is _TOMBSTONE:
                self.delete(k)
            else:
                self.set(k, v)
        branch._writes = {}

    def snapshot(self) -> dict[bytes, bytes]:
        if self._parent is None:
            return dict(self._data)
        snap = self._parent.snapshot()
        for k, v in self._writes.items():
            if v is _TOMBSTONE:
                snap.pop(k, None)
            else:
                snap[k] = v
        return snap

    # --- commitment -------------------------------------------------------
    def hash(self) -> bytes:
        """Merkle root of the contents (incremental on a root store)."""
        if self._parent is not None:
            return KVStore(self.snapshot()).hash()
        if self._root_cache is None:
            for k in self._dirty:
                v = self._data.get(k)
                kh = smt.key_hash(k)
                if v is None:
                    self._trie = smt.delete(self._trie, kh)
                else:
                    self._trie = smt.insert(self._trie, kh, smt.value_hash(v))
            self._dirty.clear()
            self._root_cache = smt.root_hash(self._trie)
        return self._root_cache

    def proof(self, key: bytes) -> smt.StateProof:
        """Existence/non-existence proof against this store's `hash()`."""
        if self._parent is not None:
            raise ValueError("proofs are served by root stores only")
        self.hash()  # flush dirty keys into the trie
        return smt.prove(self._trie, key, self._data.get(key))


class CommitStore:
    """Height-versioned commits of a KVStore (restart / rollback / export)."""

    def __init__(self):
        self.working = KVStore()
        self._committed: dict[int, dict[bytes, bytes]] = {}
        # height -> app hash, recorded at commit (historical queries);
        # height -> read-only KVStore view, memoized lazily — rebuilding
        # the SMT from a snapshot is O(state), so one view serves all of a
        # height's proofs.
        self._app_hashes: dict[int, bytes] = {}
        self._views: dict[int, KVStore] = {}
        self.last_height = 0
        self.last_app_hash = b"\x00" * 32

    def commit(self, height: int) -> bytes:
        self._committed[height] = self.working.snapshot()
        self.last_height = height
        self.last_app_hash = self.working.hash()
        self._app_hashes[height] = self.last_app_hash
        return self.last_app_hash

    def proof(self, key: bytes) -> smt.StateProof:
        """State proof for `key` against `last_app_hash` (call post-commit)."""
        return self.working.proof(key)

    def _view(self, height: int) -> KVStore:
        """Memoized read-only store over a committed snapshot."""
        view = self._views.get(height)
        if view is None:
            if height not in self._committed:
                raise KeyError(f"no committed state at height {height}")
            view = KVStore(self._committed[height])
            self._views[height] = view
            for h in sorted(self._views)[:-8]:  # bound the cache
                del self._views[h]
        return view

    def app_hash_at(self, height: int) -> bytes:
        """The app hash of a past committed height (recomputed from the
        snapshot for stores restored from disk)."""
        got = self._app_hashes.get(height)
        if got is None:
            got = self._app_hashes[height] = self._view(height).hash()
        return got

    def proof_at(self, key: bytes, height: int) -> smt.StateProof:
        """State proof for `key` against the app hash of a PAST committed
        height (IBC relayers prove at the height a light-client consensus
        state pins, which trails the chain tip)."""
        return self._view(height).proof(key)

    def load_height(self, height: int) -> None:
        if height == 0:
            self.working = KVStore()
        else:
            if height not in self._committed:
                raise KeyError(f"no committed state at height {height}")
            self.working = KVStore(self._committed[height])
        self.last_height = height
        self.last_app_hash = self.working.hash() if height else b"\x00" * 32

    def rollback(self) -> int:
        """Drop the latest committed height (server rollback command)."""
        if self.last_height == 0:
            raise ValueError("nothing to roll back")
        self._committed.pop(self.last_height, None)
        self._app_hashes.pop(self.last_height, None)
        self._views.pop(self.last_height, None)
        self.load_height(self.last_height - 1) if self.last_height > 1 else self.load_height(0)
        return self.last_height

    def prune(self, keep_recent: int) -> None:
        cutoff = self.last_height - keep_recent
        for h in [h for h in self._committed if h < cutoff]:
            del self._committed[h]
            self._app_hashes.pop(h, None)
            self._views.pop(h, None)

    def export(self, height: int | None = None) -> dict[bytes, bytes]:
        if height is None:
            height = self.last_height
        return dict(self._committed[height])

    # --- disk persistence (restart/resume, reference LoadHeight app/app.go:592)
    def save(self, path: str, keep_recent: int = 2) -> None:
        """Write the most recent committed heights to disk.

        Two heights are kept so one `rollback` still works after a restart
        (the sdk server's rollback command rolls back exactly one height).
        """
        import json
        import os
        import tempfile

        heights = sorted(self._committed)[-keep_recent:]
        state = {
            "height": self.last_height,
            "versions": [
                {
                    "height": h,
                    "kv": {k.hex(): v.hex() for k, v in self._committed[h].items()},
                }
                for h in heights
            ],
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
        with os.fdopen(fd, "w") as f:
            json.dump(state, f)
        os.replace(tmp, path)  # atomic: a crash never corrupts the snapshot

    @classmethod
    def load(cls, path: str) -> "CommitStore":
        import json

        with open(path) as f:
            state = json.load(f)
        cs = cls()
        for version in state["versions"]:
            cs._committed[version["height"]] = {
                bytes.fromhex(k): bytes.fromhex(v) for k, v in version["kv"].items()
            }
        cs.load_height(state["height"])
        return cs
