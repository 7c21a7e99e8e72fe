"""Device-batched share commitments (the port's counterpart of
celestia_app_tpu/inclusion/batched.py).

ProcessProposal's hot loop (3) (SURVEY §3.3: inclusion.CreateCommitment per
blob inside ValidateBlobTx, x/blob/types/blob_tx.go:98) recomputes every
blob's commitment every block on every validator.  Here ALL blobs' MMR
chunks are hashed together: chunks are grouped by size, each group is ONE
batched NMT-forest call on `device` (kernels/nmt.tree_roots: one
`sha256_leaves` launch, then one `sha256_batch` launch per level), and only
the tiny merkle-over-peaks step stays on the host.  The JAX version pads
each group's count to a power of two to bound its jit cache; nothing here
is compiled per shape, so the groups go as they are.
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np
import torch

from celestia_app_tpu_torch.constants import (
    NAMESPACE_SIZE,
    SHARE_SIZE,
    SUBTREE_ROOT_THRESHOLD,
)
from celestia_app_tpu_torch.device import resolve_device, upload
from celestia_app_tpu_torch.inclusion.commitment import merkle_mountain_range_sizes
from celestia_app_tpu_torch.kernels.nmt import tree_roots
from celestia_app_tpu_torch.merkle import hash_from_byte_slices
from celestia_app_tpu_torch.shares.sparse import Blob, blob_share_array
from celestia_app_tpu_torch.square.layout import subtree_width

# Commitment memo: a commitment is a pure function of (namespace, data,
# share_version, threshold), and the SAME blob is validated up to three
# times per inclusion (CheckTx admission, PrepareProposal filter,
# ProcessProposal validation — x/blob/types/blob_tx.go:98 runs each time).
# Keying on the blob's content hash collapses those to one device pass.
# Bounded FIFO so a flood of distinct blobs cannot grow it unboundedly.
_COMMIT_MEMO: dict[tuple, bytes] = {}
_COMMIT_MEMO_MAX = 2048
# The memo is shared across every node in the process (in-process
# clusters validate concurrently from several threads): all reads,
# evictions and the hit/miss counts change under this lock.  Device
# hashing for misses runs OUTSIDE it, so two threads may compute the same
# missing key; the insert loop keeps the first.
_COMMIT_MEMO_LOCK = threading.Lock()
_MEMO_COUNTS = {"hits": 0, "misses": 0}


def memo_stats() -> dict:
    """Entries in the memo, and the blobs looked up in it that hit and
    missed since the process started."""
    with _COMMIT_MEMO_LOCK:
        return {"entries": len(_COMMIT_MEMO), **_MEMO_COUNTS}


def _memo_key(blob: Blob, threshold: int) -> tuple:
    return (
        blob.namespace.to_bytes(),
        hashlib.sha256(blob.data).digest(),
        blob.share_version,
        threshold,
    )


def create_commitments_batched(
    blobs: list[Blob], subtree_root_threshold: int = SUBTREE_ROOT_THRESHOLD,
    device=None,
) -> list[bytes]:
    """Commitments for many blobs with all hashing batched on `device`
    (default CUDA; raises without a card; "cpu" runs the plain versions).

    Bit-identical to inclusion.create_commitment per blob (tested), just
    scheduled as one device call per distinct chunk size. Results are
    memoized by blob content, so revalidation of an already-seen blob
    (Prepare/Process after CheckTx) costs one sha256 of its data.
    """
    dev = resolve_device(device)
    if not blobs:
        return []

    keys = [_memo_key(b, subtree_root_threshold) for b in blobs]
    with _COMMIT_MEMO_LOCK:
        have = {k: _COMMIT_MEMO[k] for k in keys if k in _COMMIT_MEMO}
        missing = [i for i, k in enumerate(keys) if k not in have]
        _MEMO_COUNTS["hits"] += len(keys) - len(missing)
        _MEMO_COUNTS["misses"] += len(missing)
    if not missing:
        return [have[k] for k in keys]
    fresh = _create_commitments_uncached(
        [blobs[i] for i in missing], subtree_root_threshold, dev
    )
    with _COMMIT_MEMO_LOCK:
        for i, c in zip(missing, fresh):
            have[keys[i]] = c
            # FIFO-evict one per insert, so the memo can NEVER exceed its
            # bound (a bulk pre-eviction would empty the whole dict when
            # len(missing) > _COMMIT_MEMO_MAX and then insert past the cap).
            if keys[i] in _COMMIT_MEMO:
                continue
            while len(_COMMIT_MEMO) >= _COMMIT_MEMO_MAX:
                _COMMIT_MEMO.pop(next(iter(_COMMIT_MEMO)))
            _COMMIT_MEMO[keys[i]] = c
    return [have[k] for k in keys]


def _create_commitments_uncached(
    blobs: list[Blob], subtree_root_threshold: int, device: torch.device
) -> list[bytes]:
    # Chunk every blob: chunks_by_size[size] = [(blob_idx, chunk_order, start)].
    blob_shares: list[np.ndarray] = []
    chunks_by_size: dict[int, list[tuple[int, int, int]]] = {}
    chunk_counts: list[int] = []
    for bi, blob in enumerate(blobs):
        shares = blob_share_array(blob)  # (n, SHARE_SIZE), split_blob's bytes
        blob_shares.append(shares)
        width = subtree_width(len(shares), subtree_root_threshold)
        sizes = merkle_mountain_range_sizes(len(shares), width)
        chunk_counts.append(len(sizes))
        cursor = 0
        for ci, size in enumerate(sizes):
            chunks_by_size.setdefault(size, []).append((bi, ci, cursor))
            cursor += size

    # One batched NMT-forest call per distinct chunk size, all enqueued
    # before the one copy back.  The shares reach the card through pinned
    # staging (device.upload); each leaf's namespace is its share's first
    # 29 bytes (every sparse share starts with its blob's namespace), a
    # view of the uploaded bytes.
    order: list[tuple[int, int]] = []
    outs: list[torch.Tensor] = []
    for size, items in chunks_by_size.items():
        data = np.concatenate(
            [blob_shares[bi][start : start + size] for bi, _ci, start in items]
        ).reshape(len(items), size, SHARE_SIZE)
        data_dev, _ = upload(data, device)
        outs.append(tree_roots(data_dev[:, :, :NAMESPACE_SIZE], data_dev))
        order += [(bi, ci) for bi, ci, _start in items]
    flat = torch.cat(outs).cpu().numpy()  # (chunks, 90)
    roots = {key: flat[slot].tobytes() for slot, key in enumerate(order)}

    # Merkle over each blob's peaks (host; a handful of 90-byte leaves).
    return [
        hash_from_byte_slices([roots[(bi, ci)] for ci in range(chunk_counts[bi])])
        for bi in range(len(blobs))
    ]
