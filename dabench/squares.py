"""The one traffic generator: original data squares (ODS) laid out as a
block's are, made from the seed.

A square, in row-major order: the transaction namespace's and the
PayForBlob namespace's compact shares, then blobs whose share counts follow
a Pareto tail, each under its own v0 namespace, the namespaces rising, then
tail padding up to k*k shares.  Share bodies are random bytes.  Sizes and
tails come from the mix's `layout`:

  compact_fraction [lo, hi]  share of the square in compact shares
  pfb_fraction               of those, the PayForBlob namespace's share
  fill [lo, hi]              share of the square in compact and blob shares
  blob_alpha                 Pareto exponent of a blob's share count
  blob_max_fraction          cap of one blob, as a share of the square

`stamp` writes a height into 8 body bytes of the first blob share, so
that every square a window submits differs from every other.
"""

from __future__ import annotations

import numpy as np
import torch

SHARE_SIZE = 512
NS = 29
STAMP_BYTES = 8


def _v0(ids: np.ndarray) -> np.ndarray:
    """(n, 10) id bytes -> (n, 29) version-0 namespaces."""
    ns = np.zeros((len(ids), NS), dtype=np.uint8)
    ns[:, NS - 10:] = ids
    return ns


def _reserved(last: int, version: int = 0) -> np.ndarray:
    ns = np.zeros(NS, dtype=np.uint8) if version == 0 else np.full(NS, 0xFF, dtype=np.uint8)
    ns[0] = version
    ns[-1] = last
    return ns


TX_NS = _reserved(0x01)
PFB_NS = _reserved(0x04)
TAIL_PADDING_NS = _reserved(0xFE, version=0xFF)


def layout(k: int, rng: np.random.Generator, spec: dict) -> tuple[np.ndarray, int]:
    """((k*k, 29) namespaces in row-major order, index of the stamped share)."""
    total = k * k
    compact = max(1, int(total * rng.uniform(*spec["compact_fraction"])))
    pfb = int(compact * spec["pfb_fraction"])
    budget = max(0, int(total * rng.uniform(*spec["fill"])) - compact)
    cap = max(1, int(total * spec["blob_max_fraction"]))
    sizes = []
    while budget > 0:
        size = min(cap, budget, int(rng.pareto(spec["blob_alpha"])) + 1)
        sizes.append(size)
        budget -= size
    ids = rng.integers(0, 256, (len(sizes), 10), dtype=np.uint8)
    ids[:, 0] |= 0x01  # above every reserved id
    ids = ids[np.lexsort(ids.T[::-1])]
    ns = np.empty((total, NS), dtype=np.uint8)
    ns[: compact - pfb] = TX_NS
    ns[compact - pfb: compact] = PFB_NS
    at = compact
    for blob_ns, size in zip(_v0(ids), sizes):
        ns[at: at + size] = blob_ns
        at += size
    ns[at:] = TAIL_PADDING_NS
    return ns, compact if sizes else compact - 1


def pool(k: int, count: int, seed: int, spec: dict, device) -> tuple[list[np.ndarray], list[int]]:
    """`count` distinct squares from `seed`: the bodies drawn on `device` by
    one torch.Generator call, the layouts by numpy; returned as host arrays
    (k, k, 512) and each square's stamped share index."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    bodies = torch.randint(0, 256, (count, k * k, SHARE_SIZE), generator=gen, device=device,
                           dtype=torch.uint8)
    rng = np.random.default_rng([seed, k, count])
    stamped = []
    for i in range(count):
        ns, at = layout(k, rng, spec)
        bodies[i, :, :NS] = torch.from_numpy(ns).to(device)
        stamped.append(at)
    host = bodies.cpu().numpy()
    return [host[i].reshape(k, k, SHARE_SIZE) for i in range(count)], stamped


def stamp(square: np.ndarray, at: int, height: int) -> np.ndarray:
    """Write `height` into the last 8 bytes of share `at` (row-major), in place."""
    k = square.shape[0]
    square[at // k, at % k, SHARE_SIZE - STAMP_BYTES:] = np.frombuffer(
        int(height).to_bytes(STAMP_BYTES, "little"), dtype=np.uint8)
    return square
