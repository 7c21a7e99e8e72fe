"""Host Namespaced Merkle Tree (oracle and proof engine).

Push-ordered, retaining every level, so inclusion proofs are array
indexing.  The sampler's host lowering builds
one of these per sampled line; the batched lowering reads the same levels
out of the device forest (serve/cache.py).
"""

from __future__ import annotations

from celestia_app_tpu_torch.constants import NAMESPACE_SIZE
from celestia_app_tpu_torch.nmt.hasher import NmtHasher


class NamespacedMerkleTree:
    """An NMT built by pushing namespaced leaves in namespace order."""

    def __init__(self) -> None:
        self._leaves: list[bytes] = []  # raw ndata = ns || data
        self._levels: list[list[bytes]] | None = None

    def push(self, ndata: bytes) -> None:
        """Push ns(29)-prefixed leaf data. Namespaces must be non-decreasing."""
        if self._levels is not None:
            raise RuntimeError("tree already finalized")
        ns = ndata[:NAMESPACE_SIZE]
        if self._leaves and ns < self._leaves[-1][:NAMESPACE_SIZE]:
            raise ValueError("leaves must be pushed in namespace order")
        self._leaves.append(bytes(ndata))

    def __len__(self) -> int:
        return len(self._leaves)

    def _build(self) -> list[list[bytes]]:
        """Levels bottom-up: levels[0] = leaf digests, levels[-1] = [root]."""
        if self._levels is not None:
            return self._levels
        level = [NmtHasher.hash_leaf(leaf) for leaf in self._leaves]
        levels = [level]
        while len(level) > 1:
            nxt = [NmtHasher.hash_node(level[i], level[i + 1])
                   for i in range(0, len(level) - 1, 2)]
            if len(level) % 2:
                # An odd node is promoted (every tree of a square has a
                # power-of-two leaf count; this serves ad-hoc host uses).
                nxt.append(level[-1])
            levels.append(nxt)
            level = nxt
        self._levels = levels
        return levels

    def root(self) -> bytes:
        if not self._leaves:
            return NmtHasher.empty_root()
        return self._build()[-1][0]

    def levels(self) -> list[list[bytes]]:
        """All digest levels (leaf level first). Finalizes the tree."""
        return self._build()

    def leaf_digests(self) -> list[bytes]:
        return self._build()[0]

    def subtree_root(self, start: int, end: int) -> bytes:
        """Root of the complete subtree over leaves [start, end).

        The range must be aligned: end-start a power of two dividing start.
        This is the cached-inner-node lookup of the reference's
        EDSSubTreeRootCacher.walk (pkg/inclusion/nmt_caching.go:52).
        """
        size = end - start
        if size <= 0 or size & (size - 1) or start % size:
            raise ValueError(f"unaligned subtree range [{start},{end})")
        if end > len(self._leaves):
            raise ValueError(f"subtree range [{start},{end}) exceeds {len(self._leaves)} leaves")
        height = size.bit_length() - 1
        return self._build()[height][start // size]
