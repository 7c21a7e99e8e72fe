"""A sample of a window's outputs drawn from the seed, uniform over however
many the window turns out to produce (reservoir sampling, algorithm R)."""

from __future__ import annotations

import numpy as np


class Reservoir:
    def __init__(self, size: int, seed: int, stream: int):
        self.size = size
        self.rng = np.random.default_rng([seed, stream])
        self.seen = 0
        self.kept: dict[int, object] = {}  # slot -> (key, value)

    def slot(self) -> int | None:
        """Offer the next output: the slot it takes, or None.  The caller
        stores it with `keep` only then, so outputs not kept cost nothing."""
        self.seen += 1
        if self.seen <= self.size:
            return self.seen - 1
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.size else None

    def keep(self, slot: int, key, value) -> None:
        self.kept[slot] = (key, value)

    def items(self) -> list:
        return sorted(self.kept.values(), key=lambda kv: kv[0])
