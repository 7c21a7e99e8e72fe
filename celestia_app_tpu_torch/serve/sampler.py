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

$CELESTIA_SERVE_MODE=host selects the host lowering, as the caller's own
choice.  The chaos seam `proof.serve` ($CELESTIA_CHAOS proof_fail /
proof_slow_ms) fails or stalls the batched dispatch, which is retried on the
card (chaos/degrade.retry_on_card: celestia_recoveries_total{seam=
"proof.serve", outcome="retried"} per retry) and raises device.DeviceFault
past the last retry.  The JAX package answers such a batch on the host
instead; the port answers no fault of the card from the CPU.

Queueing: concurrent `share_proof` callers park on a shared queue; the first
arrival leads, waits $CELESTIA_SERVE_BATCH_MS (default 0: drains what
queued) and answers everyone with one batch per (height, axis), writing one
`proof_serve` trace row per group.  Latency lands on
celestia_proof_latency_seconds{phase}: queue_wait and total per sample (with
the served share's capped namespace and its shard), gather and assemble per
batch.

Adversary detection (chaos/adversary.py):

  * a sample landing on a share the withholding proposer hid raises
    ShareWithheld (celestia_da_detections_total{kind="withheld"}, the
    `withholding_detected` flight trigger, and a heal enqueued:
    serve/heal.note_detection);
  * when an adversary tampers with the served square (malform_shares /
    wrong_root), or under $CELESTIA_SERVE_VERIFY=1, every assembled proof
    passes a verification gate on the device against the committed data
    root before it leaves the sampler: a proof that does not verify raises
    BadProofDetected (kind="bad_proof", the `root_mismatch` trigger, a heal
    enqueued).
  * the read path's per-tenant proof rate ($CELESTIA_QOS <tenant>.
    proof_rate) is charged before the gather, on the sampled share's own
    namespace, read once per handle (eds.ods_namespaces).

The port of celestia_app_tpu/serve/sampler.py; the one difference is the
seam's card retry above.
"""

from __future__ import annotations

import os
import threading
import time
from functools import lru_cache

from celestia_app_tpu_torch import chaos, merkle
from celestia_app_tpu_torch.chaos.degrade import retry_on_card
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


def _latency():
    from celestia_app_tpu_torch.trace.metrics import DEVICE_SECONDS_BUCKETS, registry

    return registry().histogram(
        "celestia_proof_latency_seconds",
        "DAS proof serving latency by phase (queue_wait/gather/assemble "
        "per the sampler; total is per served sample, labeled with the "
        "served share's capped namespace)",
        buckets=DEVICE_SECONDS_BUCKETS,
    )


def _shard_label(p: "_Pending") -> str:
    """Bounded `shard` label of one sample: the serve shard owning the
    sampled coordinate's leaf node; "0" on the single-device plane."""
    leaf_shard = getattr(p.entry, "leaf_shard", None)
    if leaf_shard is None:
        return "0"
    return str(leaf_shard(p.row, p.col, p.axis))


def _proof_namespace_label(proof) -> str:
    """Capped per-tenant label of one served proof (parity shares and
    failed samples fold into the reserved `other` bucket)."""
    from celestia_app_tpu_torch.trace.square_journal import (
        OTHER_LABEL,
        capped_namespace_label,
        namespace_label,
    )

    ns = getattr(proof, "namespace", None)
    if not isinstance(ns, bytes) or ns == PARITY_NAMESPACE_BYTES:
        return OTHER_LABEL
    return capped_namespace_label(namespace_label(ns))


class _Pending:
    __slots__ = ("entry", "row", "col", "axis", "event", "proof", "error", "t_submit")

    def __init__(self, entry, row: int, col: int, axis: str):
        self.entry = entry
        self.row = row
        self.col = col
        self.axis = axis
        self.event = threading.Event()
        self.proof: ShareProof | None = None
        self.error: Exception | None = None
        self.t_submit = time.perf_counter()


def _check_withheld(entry, coords) -> None:
    """The withholding intercept: raise ShareWithheld on the FIRST sampled
    coordinate the adversary hides, ticking the detection counter, firing
    the rate-limited `withholding_detected` trigger and enqueueing a heal.
    No adversary configured: one injector read."""
    adv = chaos.active_adversary()
    if adv is None or adv.withhold_frac <= 0:
        return
    if getattr(entry, "healed", False):
        # A healed height serves from this node's own recovered,
        # root-verified store (serve/heal.py).
        return
    height = getattr(entry, "height", 0)
    n = 2 * entry.k
    for row, col in coords:
        if adv.withholds(height, n, row, col):
            from celestia_app_tpu_torch.chaos.adversary import detections
            from celestia_app_tpu_torch.serve import heal
            from celestia_app_tpu_torch.trace.flight_recorder import note_trigger

            adv.count_injection("adversary.withhold", "withhold_frac")
            detections().inc(kind="withheld")
            note_trigger("withholding_detected", height=height, row=int(row), col=int(col),
                         withhold_frac=adv.withhold_frac)
            # The detect -> act wire: a registered HealingEngine turns this
            # detection into a repair and a re-admission; the failed sample
            # still answers the terminal refusal.
            heal.note_detection("withheld", height, entry=entry)
            raise ShareWithheld(height, int(row), int(col))


def _qos_gate_sample(entry, row: int, col: int) -> None:
    """The read path's per-tenant proof-rate gate (qos.py), on the sampled
    coordinate's own namespace, before the gather.  One cached env compare
    when enforcement is off; parity quadrants carry no tenant."""
    from celestia_app_tpu_torch import qos

    enf = qos.enforcer()
    if enf is None or row >= entry.k or col >= entry.k:
        return
    # One memoized device read per handle (ods_namespaces), then a host
    # index per request: refusing a tenant must cost less than the gather.
    ns = bytes(entry.eds.ods_namespaces()[row * entry.k + col].tobytes())
    if ns == PARITY_NAMESPACE_BYTES:
        return
    from celestia_app_tpu_torch.trace.square_journal import (
        capped_namespace_label,
        namespace_label,
    )

    enf.admit_proof(capped_namespace_label(namespace_label(ns)))


def _verify_gate_armed(entry) -> bool:
    """Proof verification before serving: armed when an adversary tampers
    with served state, or unconditionally under $CELESTIA_SERVE_VERIFY=1."""
    if os.environ.get("CELESTIA_SERVE_VERIFY", "") == "1":
        return True
    adv = chaos.active_adversary()
    return adv is not None and adv.tampers()


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
        # Per sample, before the queue: one caller's withheld coordinate
        # fails that caller, never its batch-mates, and an over-limit
        # tenant is refused before the gather it would cost.
        _check_withheld(entry, [(row, col)])
        _qos_gate_sample(entry, row, col)
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
        lat = _latency()
        t0 = time.perf_counter()
        for p in batch:
            lat.observe(t0 - p.t_submit, phase="queue_wait")
        groups: dict[tuple, list[_Pending]] = {}
        for p in batch:
            groups.setdefault((id(p.entry), p.axis), []).append(p)
        from celestia_app_tpu_torch.trace.tracer import traced

        # One row per (entry, axis) group, stamped with its height (the
        # height timeline's serve signal); `heights` is the batch's group
        # count.  The forest mesh and the extend's share partition are
        # both on the row.
        tracer = traced()
        for group in groups.values():
            entry = group[0].entry
            tracer.write("proof_serve", batch=len(group), heights=len(groups),
                         height=getattr(entry, "height", None), mode=serve_mode(),
                         shards=getattr(entry, "shards", 0),
                         share_shards=getattr(entry, "share_shards", 0))
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
                    lat.observe(time.perf_counter() - p.t_submit, phase="total",
                                namespace=_proof_namespace_label(p.proof),
                                shard=_shard_label(p))
                    p.event.set()

    def sample_batch(self, entry, coords, axis: str = "row") -> list[ShareProof]:
        """Answer [(row, col), ...] against one cached height on one sampling
        axis, in the lowering $CELESTIA_SERVE_MODE selects; a fault of the
        batched path is retried on the card, then raises DeviceFault."""
        n = 2 * entry.k
        if axis not in ("row", "col"):
            raise ValueError(f"axis must be 'row' or 'col', got {axis!r}")
        for row, col in coords:
            if not (0 <= row < n and 0 <= col < n):
                raise ValueError(f"coordinate ({row},{col}) outside {n}x{n}")
        # Direct callers get the withholding intercept the queue applies.
        _check_withheld(entry, coords)
        if serve_mode() == "host":
            return self._gate(entry, self._host_batch(entry, coords, axis))

        def batched():
            chaos.proof_serve()
            return self._batched(entry, coords, axis)

        return self._gate(entry, retry_on_card("proof.serve", batched))

    def _gate(self, entry, proofs: list[ShareProof]) -> list[ShareProof]:
        """The verification gate: when armed (an adversary tampering, or
        $CELESTIA_SERVE_VERIFY=1), every proof must verify against the
        entry's committed data root (one batched verification on the
        device) before it leaves the sampler.  A failure is an attack
        detection: counted, black-boxed, a heal enqueued, and raised."""
        if not _verify_gate_armed(entry):
            return proofs
        from celestia_app_tpu_torch.serve.verify import verify_proofs

        for ok in verify_proofs(proofs, entry.data_root, self.device):
            if ok:
                continue
            from celestia_app_tpu_torch.chaos.adversary import detections
            from celestia_app_tpu_torch.serve import heal
            from celestia_app_tpu_torch.trace.flight_recorder import note_trigger

            height = getattr(entry, "height", 0)
            detections().inc(kind="bad_proof")
            note_trigger("root_mismatch", reason="serve_verification", height=height)
            heal.note_detection("bad_proof", getattr(entry, "height", None), entry=entry)
            raise BadProofDetected(
                "assembled proof does not verify against the committed data root at "
                f"height {height} (malformed square or wrong root)")
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
        lat = _latency()
        t0 = time.perf_counter()
        nodes = entry.gather(axis, node_idx).tobytes()
        shares = entry.gather_shares(coords)
        t1 = time.perf_counter()
        lat.observe(t1 - t0, phase="gather")

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
        lat.observe(self.last_batch_s["assemble"], phase="assemble")
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
