"""Batched proof verification: a whole queue of share proofs decided on the
device (kernels/verify.py), the verify twin of the sampler.

    * `verify_proofs(proofs, data_root)` -> accept/reject list, identical to
      `[p.verify(root) for p in proofs]` on every input: canonical
      single-share samples are decided on the device, bucketed by tree
      shape; anything else (multi-row inclusion proofs, malformed shapes an
      attacker could send) goes to the host verifier, whose verdict the
      batched path matches by definition.  That routing is part of the
      semantics; a fault of the batched path raises.
    * $CELESTIA_VERIFY_MODE=host runs the host verifier for the whole queue.
    * `leaf_digests(ns, shares)` hashes a batch of NMT leaves in one launch
      (the healing loop's survivor check), from host bytes or from tensors
      already on the device.
    * The chaos seam `proof.verify` (verify_fail=<p>) fails the batched
      dispatch; the dispatch is retried on the card (chaos/degrade.
      retry_on_card, each retry ticking celestia_recoveries_total{seam=
      "proof.verify", outcome="retried"}) and raises device.DeviceFault
      past the last.  The JAX package re-decides the whole queue on the
      host instead; the port answers no fault of the card from the CPU.
    * celestia_verified_samples_total{mode} counts the samples decided.

The index plans come from the same `range_proof_node_coords` DFS plan the
sampler serves proofs with, so the batched and host verdicts agree by
construction.  The port of celestia_app_tpu/serve/verify.py.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from celestia_app_tpu_torch import chaos
from celestia_app_tpu_torch.chaos.degrade import retry_on_card
from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, NMT_NODE_SIZE, SHARE_SIZE
from celestia_app_tpu_torch.device import resolve_device
from celestia_app_tpu_torch.kernels.verify import (
    fold_row_roots,
    nmt_leaf_digests,
    verify_nmt_samples,
)
from celestia_app_tpu_torch.nmt.hasher import NmtHasher
from celestia_app_tpu_torch.nmt.proof import range_proof_node_coords


def verify_mode() -> str:
    """$CELESTIA_VERIFY_MODE: "batched" (default) or "host"."""
    mode = os.environ.get("CELESTIA_VERIFY_MODE", "batched").strip().lower()
    return mode if mode in ("batched", "host") else "batched"


def _verified_counter():
    from celestia_app_tpu_torch.trace.metrics import registry

    return registry().counter(
        "celestia_verified_samples_total",
        "DAS samples verified, by verifier mode",
    )


@functools.lru_cache(maxsize=8192)
def _sibling_perm(total: int, start: int) -> tuple[int, ...]:
    """DFS position of each level's sibling in a single-leaf proof: entry
    `lvl` is where `prove_range` emitted the level-`lvl` sibling (subtree
    (start >> lvl) ^ 1), so the fold consumes the node the host walk does."""
    pos = {c: j for j, c in enumerate(range_proof_node_coords(total, start, start + 1))}
    return tuple(pos[(lvl, (start >> lvl) ^ 1)] for lvl in range(total.bit_length() - 1))


class _Bucket:
    """Assembly state of one (NMT levels, data-root levels) tree shape."""

    def __init__(self):
        self.idxs: list[int] = []
        self.ns: list[bytes] = []
        self.shares: list[bytes] = []
        self.sibs: list[bytes] = []
        self.starts: list[int] = []
        self.row_roots: list[bytes] = []
        self.slots: list[int] = []
        self.row_slots: dict = {}
        self.row_parts: list[bytes] = []
        self.row_paths: list[bytes] = []
        self.row_indices: list[int] = []
        self.row_data_roots: list[bytes] = []


def _rows(parts: list[bytes], *shape: int, device) -> torch.Tensor:
    """Concatenated byte strings -> a (len(parts), *shape) uint8 tensor."""
    raw = np.frombuffer(b"".join(parts), dtype=np.uint8).reshape(len(parts), *shape)
    return torch.tensor(raw, device=device)


def _bit_flags(indices: list[int], levels: int, device) -> torch.Tensor:
    """(len(indices), levels) bool: bit `lvl` of each index, set where the
    running digest is the right child (the sibling folds from the left)."""
    arr = np.asarray(indices, dtype=np.int64)
    return torch.tensor(((arr[:, None] >> np.arange(levels)) & 1).astype(bool), device=device)


def _canonical(proof, root):
    """The device inputs of a canonical DAS sample (one 512-byte share, one
    row, power-of-two trees, exact node and path counts): ((NMT levels,
    data-root levels), namespace, share, siblings in level order, row root,
    audit path).  Raises
    ValueError, or the TypeError / AttributeError of a malformed object,
    otherwise: the batched program assumes fixed sizes, and a malformed
    proof is attacker input."""
    data, nmts, rp = proof.data, proof.share_proofs, proof.row_proof
    if len(data) != 1 or len(nmts) != 1:
        raise ValueError
    nmt = nmts[0]
    total, start, nodes = nmt.total, nmt.start, nmt.nodes
    ln = total.bit_length() - 1
    if (len(data[0]) != SHARE_SIZE or len(proof.namespace) != NAMESPACE_SIZE
            or total < 2 or total & (total - 1) or nmt.end - start != 1
            or not 0 <= start < total or len(nodes) != ln
            or any(len(nd) != NMT_NODE_SIZE for nd in nodes)):
        raise ValueError
    rtotal, row = rp.total, rp.start_row
    lr = rtotal.bit_length() - 1
    if (len(rp.row_roots) != 1 or len(rp.proofs) != 1 or rp.end_row - row != 1
            or len(rp.row_roots[0]) != NMT_NODE_SIZE or rtotal < 2 or rtotal & (rtotal - 1)
            or not 0 <= row < rtotal or len(rp.proofs[0]) != lr
            or any(len(h) != 32 for h in rp.proofs[0]) or len(root) != 32):
        raise ValueError
    sibs = b"".join(bytes(nodes[j]) for j in _sibling_perm(total, start))
    return ((ln, lr), bytes(proof.namespace), bytes(data[0]), sibs, bytes(rp.row_roots[0]),
            b"".join(bytes(h) for h in rp.proofs[0]))


def _verify_canonical(proofs, roots, out: np.ndarray, device) -> list[int]:
    """Batched verdicts of every canonical sample of the queue, written into
    `out`; returns the queue positions that are not canonical, for the host
    verifier.  One NMT fold per tree-shape bucket over its samples, and one
    data-root fold over the bucket's unique (row root, audit path, index,
    data root): the samples of one height share few row roots."""
    rest: list[int] = []
    buckets: dict[tuple[int, int], _Bucket] = {}
    for i, proof in enumerate(proofs):
        try:
            shape, ns, share, sibs, row_root, path = _canonical(proof, roots[i])
        except (TypeError, AttributeError, ValueError):
            rest.append(i)
            continue
        bk = buckets.setdefault(shape, _Bucket())
        row = proof.row_proof.start_row
        bk.idxs.append(i)
        bk.ns.append(ns)
        bk.shares.append(share)
        bk.sibs.append(sibs)
        bk.starts.append(proof.share_proofs[0].start)
        bk.row_roots.append(row_root)
        key = (row_root, path, row, roots[i])
        slot = bk.row_slots.get(key)
        if slot is None:
            slot = bk.row_slots[key] = len(bk.row_parts)
            bk.row_parts.append(row_root)
            bk.row_paths.append(path)
            bk.row_indices.append(row)
            bk.row_data_roots.append(roots[i])
        bk.slots.append(slot)

    for (ln, lr), bk in buckets.items():
        nmt_ok = verify_nmt_samples(
            _rows(bk.ns, NAMESPACE_SIZE, device=device),
            _rows(bk.shares, SHARE_SIZE, device=device),
            _rows(bk.sibs, ln, NMT_NODE_SIZE, device=device),
            _bit_flags(bk.starts, ln, device),
            _rows(bk.row_roots, NMT_NODE_SIZE, device=device),
        ).cpu().numpy()
        row_ok = fold_row_roots(
            _rows(bk.row_parts, NMT_NODE_SIZE, device=device),
            _rows(bk.row_paths, lr, 32, device=device),
            _bit_flags(bk.row_indices, lr, device),
            _rows(bk.row_data_roots, 32, device=device),
        ).cpu().numpy()
        out[bk.idxs] = nmt_ok & row_ok[bk.slots]
    return rest


def _verify_host(proofs, roots) -> list[bool]:
    verdicts = [bool(p.verify(r)) for p, r in zip(proofs, roots)]
    _verified_counter().inc(len(proofs), mode="host")
    return verdicts


def verify_proofs(proofs, data_root, device=None) -> list[bool]:
    """Accept/reject list of a queue of ShareProofs, decided on `device`
    (default CUDA; raises without a card).

    `data_root` is one 32-byte root for the whole queue or one per proof
    (mixed-height queues).  Identical to `[p.verify(root) for p in proofs]`
    on every input."""
    dev = resolve_device(device)
    proofs = list(proofs)
    if not proofs:
        return []
    if isinstance(data_root, (bytes, bytearray)):
        roots = [bytes(data_root)] * len(proofs)
    else:
        roots = [bytes(r) for r in data_root]
    if len(roots) != len(proofs):
        raise ValueError(f"{len(roots)} data roots for {len(proofs)} proofs")
    if verify_mode() == "host":
        return _verify_host(proofs, roots)

    def batched():
        chaos.proof_verify()
        accept = np.zeros(len(proofs), dtype=bool)
        return accept, _verify_canonical(proofs, roots, accept, dev)

    accept, rest = retry_on_card("proof.verify", batched)
    if len(rest) < len(proofs):
        _verified_counter().inc(len(proofs) - len(rest), mode="batched")
    verdicts = accept.tolist()
    if rest:
        host = _verify_host([proofs[i] for i in rest], [roots[i] for i in rest])
        for i, ok in zip(rest, host):
            verdicts[i] = ok
    return verdicts


def verify_share_proof(proof, data_root: bytes, device=None) -> bool:
    """Single-proof convenience over `verify_proofs`."""
    return verify_proofs([proof], data_root, device)[0]


def leaf_digests(ns, shares, device=None):
    """(N, 29) x (N, D) uint8 -> (N, 90) NMT leaf digests in one launch on
    `device` (default CUDA; raises without a card), retried on the card
    under the `proof.verify` seam; NmtHasher.hash_leaf under
    $CELESTIA_VERIFY_MODE=host.  Numpy in, numpy out; tensors in, a tensor
    out on their device (`device` is then theirs), so the healing loop's
    survivor check never moves a square through host memory."""
    if isinstance(ns, torch.Tensor):
        dev = shares.device
        if len(ns) == 0:
            return torch.zeros((0, NMT_NODE_SIZE), dtype=torch.uint8, device=dev)
        if verify_mode() == "host":
            host = _leaf_digests_host(ns.cpu().numpy(), shares.cpu().numpy())
            return torch.from_numpy(host).to(dev)

        def batched():
            chaos.proof_verify()
            return nmt_leaf_digests(ns.contiguous(), shares.contiguous())

        return retry_on_card("proof.verify", batched)
    dev = resolve_device(device)
    ns = np.ascontiguousarray(ns, dtype=np.uint8)
    shares = np.ascontiguousarray(shares, dtype=np.uint8)
    if len(ns) == 0:
        return np.zeros((0, NMT_NODE_SIZE), dtype=np.uint8)
    if verify_mode() == "host":
        return _leaf_digests_host(ns, shares)

    def batched():
        chaos.proof_verify()
        return nmt_leaf_digests(torch.tensor(ns, device=dev),
                                torch.tensor(shares, device=dev)).cpu().numpy()

    return retry_on_card("proof.verify", batched)


def _leaf_digests_host(ns: np.ndarray, shares: np.ndarray) -> np.ndarray:
    digests = [NmtHasher.hash_leaf(ns[i].tobytes() + shares[i].tobytes())
               for i in range(len(ns))]
    return np.frombuffer(b"".join(digests), dtype=np.uint8).reshape(len(ns), NMT_NODE_SIZE)
