"""ProofSampler: queued DAS sample requests, answered a whole batch at a time.

Two lowerings of "prove share (row, col) against the committed data root",
pinned byte-identical:

  batched (default)  the index plan of every request is host integer math
                     (range_proof_node_coords); the batch's proof nodes and
                     shares then come off the cached forest in one gather
                     each (serve/cache.CachedForest.gather), and the
                     RowProof audit paths are indexed out of the memoized
                     data-root tree levels.  No hashing per request.
  host               rebuild the sampled line's NMT from the retained shares
                     (eds.row_tree(host=True)) and derive the audit path
                     recursively (merkle.proof): no forest, no gather.

$CELESTIA_SERVE_MODE=host selects the host lowering; a fault of the batched
path raises.  Queueing: concurrent `share_proof` callers park on a shared
queue; the first arrival leads, waits $CELESTIA_SERVE_BATCH_MS (default 0:
drains what queued) and answers everyone with one batch per (height, axis).
$CELESTIA_SERVE_VERIFY=1 arms a gate that verifies every assembled proof
against the committed data root on the device before it leaves the sampler
(BadProofDetected otherwise).

The port of celestia_app_tpu/serve/sampler.py; its withholding intercept,
QoS gate, latency histograms and adversary hooks are not ported yet.
"""

from __future__ import annotations

import os
import threading
import time
from functools import lru_cache

from celestia_app_tpu_torch import merkle
from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, NMT_NODE_SIZE, PARITY_NAMESPACE_BYTES
from celestia_app_tpu_torch.device import resolve_device
from celestia_app_tpu_torch.nmt.proof import (
    NmtRangeProof,
    prove_range_from_levels,
    range_proof_node_coords,
)
from celestia_app_tpu_torch.proof.share_proof import RowProof, ShareProof


class ShareWithheld(LookupError):
    """The sampled share is withheld from the serve path (a data-withholding
    attack detected by this very sample)."""

    def __init__(self, height: int, row: int, col: int):
        super().__init__(f"share ({row},{col}) at height {height} is withheld "
                         "(data-availability attack detected)")
        self.height = height
        self.row = row
        self.col = col


class BadProofDetected(ValueError):
    """An assembled proof failed verification against the committed data
    root: a malformed square or a wrong root, caught before any client saw
    the proof."""


def serve_mode() -> str:
    """$CELESTIA_SERVE_MODE: "batched" (default) or "host"."""
    return "host" if os.environ.get("CELESTIA_SERVE_MODE", "") == "host" else "batched"


def batch_window_s() -> float:
    """$CELESTIA_SERVE_BATCH_MS: how long the batch leader waits for more
    requests before serving (0: drain what queued)."""
    try:
        return max(float(os.environ.get("CELESTIA_SERVE_BATCH_MS", "0") or 0), 0.0) / 1e3
    except ValueError:
        return 0.0


@lru_cache(maxsize=4096)
def _sample_coords(total: int, leaf: int) -> tuple[tuple[int, int], ...]:
    """(level, index) plan of the single-leaf range [leaf, leaf + 1), shared
    by every request that samples that leaf position."""
    return tuple(range_proof_node_coords(total, leaf, leaf + 1))


class _Pending:
    __slots__ = ("entry", "row", "col", "axis", "event", "proof", "error")

    def __init__(self, entry, row: int, col: int, axis: str):
        self.entry = entry
        self.row = row
        self.col = col
        self.axis = axis
        self.event = threading.Event()
        self.proof: ShareProof | None = None
        self.error: Exception | None = None


def _namespace(entry, row: int, col: int, share: bytes) -> bytes:
    return share[:NAMESPACE_SIZE] if row < entry.k and col < entry.k else PARITY_NAMESPACE_BYTES


class ProofSampler:
    """Batching sampler over ForestCache entries (serve/cache.py).  The
    verification gate runs on `device` (default CUDA; raises without a
    card); the gathers run where each entry's tensors lie."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._queue: list[_Pending] = []
        self._leader_active = False
        # Host seconds of the last batched answer's two halves.
        self.last_batch_s = {"gather": 0.0, "assemble": 0.0}

    def share_proof(self, entry, row: int, col: int, axis: str = "row",
                    timeout_s: float = 30.0) -> ShareProof:
        """One sample through the batch queue: enqueue, then either lead the
        next batch or wait until a leader answers."""
        p = _Pending(entry, row, col, axis)
        with self._lock:
            self._queue.append(p)
            lead = not self._leader_active
            if lead:
                self._leader_active = True
        if lead:
            window = batch_window_s()
            if window:
                time.sleep(window)
            with self._lock:
                batch, self._queue = self._queue, []
                self._leader_active = False
            self._serve_batch(batch)
        elif not p.event.wait(timeout_s):
            raise TimeoutError(f"proof sample ({row},{col}) not served within {timeout_s}s")
        if p.error is not None:
            raise p.error
        return p.proof

    def _serve_batch(self, batch: list[_Pending]) -> None:
        groups: dict[tuple, list[_Pending]] = {}
        for p in batch:
            groups.setdefault((id(p.entry), p.axis), []).append(p)
        for group in groups.values():
            try:
                proofs = self.sample_batch(group[0].entry, [(p.row, p.col) for p in group],
                                           axis=group[0].axis)
                for p, proof in zip(group, proofs):
                    p.proof = proof
            except Exception as e:  # noqa: BLE001 -- handed to each parked caller, who raises it
                for p in group:
                    p.error = e
            finally:
                for p in group:
                    p.event.set()

    def sample_batch(self, entry, coords, axis: str = "row") -> list[ShareProof]:
        """Answer [(row, col), ...] against one cached height on one sampling
        axis, in the lowering $CELESTIA_SERVE_MODE selects."""
        n = 2 * entry.k
        if axis not in ("row", "col"):
            raise ValueError(f"axis must be 'row' or 'col', got {axis!r}")
        for row, col in coords:
            if not (0 <= row < n and 0 <= col < n):
                raise ValueError(f"coordinate ({row},{col}) outside {n}x{n}")
        if serve_mode() == "host":
            return self._gate(entry, self._host_batch(entry, coords, axis))
        return self._gate(entry, self._batched(entry, coords, axis))

    def _gate(self, entry, proofs: list[ShareProof]) -> list[ShareProof]:
        """Under $CELESTIA_SERVE_VERIFY=1 every proof must verify against the
        entry's committed data root (one batched verification) before it
        leaves the sampler."""
        if os.environ.get("CELESTIA_SERVE_VERIFY", "") != "1":
            return proofs
        from celestia_app_tpu_torch.serve.verify import verify_proofs

        if not all(verify_proofs(proofs, entry.data_root, self.device)):
            raise BadProofDetected(
                "assembled proof does not verify against the committed data root at "
                f"height {entry.height} (malformed square or wrong root)")
        return proofs

    def _batched(self, entry, coords, axis: str = "row") -> list[ShareProof]:
        n = 2 * entry.k
        # Row sampling proves leaf `col` of tree `row`; column sampling leaf
        # `row` of column tree `col`, whose root is data-root leaf 2k + col.
        if axis == "col":
            plans = [_sample_coords(n, row) for row, _ in coords]
            trees = [col for _, col in coords]
        else:
            plans = [_sample_coords(n, col) for _, col in coords]
            trees = [row for row, _ in coords]
        node_idx = [entry.flat_index(tree, lvl, i)
                    for tree, plan in zip(trees, plans) for lvl, i in plan]
        t0 = time.perf_counter()
        nodes = entry.gather(axis, node_idx).tobytes()
        shares = entry.gather_shares(coords)
        t1 = time.perf_counter()

        all_roots = entry.row_roots + entry.col_roots
        out: list[ShareProof] = []
        pos = 0
        for (row, col), plan, share_row in zip(coords, plans, shares):
            share = share_row.tobytes()
            nmt_nodes = tuple(nodes[(pos + i) * NMT_NODE_SIZE:(pos + i + 1) * NMT_NODE_SIZE]
                              for i in range(len(plan)))
            pos += len(plan)
            leaf, root_index = (row, n + col) if axis == "col" else (col, row)
            out.append(ShareProof(
                data=(share,),
                share_proofs=(NmtRangeProof(leaf, leaf + 1, nmt_nodes, n),),
                namespace=_namespace(entry, row, col, share),
                row_proof=RowProof(
                    row_roots=(all_roots[root_index],),
                    proofs=(tuple(merkle.path_from_levels(entry.root_levels, root_index)),),
                    start_row=root_index,
                    end_row=root_index + 1,
                    total=2 * n,
                ),
            ))
        self.last_batch_s = {"gather": t1 - t0, "assemble": time.perf_counter() - t1}
        return out

    def _host_batch(self, entry, coords, axis: str = "row") -> list[ShareProof]:
        return [self.host_proof(entry, row, col, axis) for row, col in coords]

    @staticmethod
    def host_proof(entry, row: int, col: int, axis: str = "row") -> ShareProof:
        """The host lowering: rebuild the line's tree from the shares and
        derive the data-root audit path recursively.  Byte-identical to
        `_batched`."""
        eds = entry.eds
        n = 2 * entry.k
        share = eds._eds[row, col].cpu().numpy().tobytes()
        if axis == "col":
            proof = prove_range_from_levels(eds.col_tree(col, host=True).levels(), row, row + 1)
            root_index = n + col
        else:
            proof = prove_range_from_levels(eds.row_tree(row, host=True).levels(), col, col + 1)
            root_index = row
        all_roots = entry.row_roots + entry.col_roots
        return ShareProof(
            data=(share,),
            share_proofs=(proof,),
            namespace=_namespace(entry, row, col, share),
            row_proof=RowProof(
                row_roots=(all_roots[root_index],),
                proofs=(tuple(merkle.proof(all_roots, root_index)),),
                start_row=root_index,
                end_row=root_index + 1,
                total=len(all_roots),
            ),
        )
