"""DasProvider: the ONE payload builder every serving plane answers with.

Byte-equal responses are structural when all planes call one renderer,
never a test invariant to chase.  The JSON-RPC POST methods of
rpc/server.py (GetShareProof, GetSharesByNamespace, GetAttestation) carry
these payload dicts, and the GET /das/* routes of trace/exposition.py serve
the same `render()` bytes (the REST gateway and the gRPC plane come with
their planes, ROADMAP queue 1).

Payloads are a pure function of chain state (height, coordinates, the
committed proofs) — cache tier, timing, and plane never leak in, so two
scrapes of the same request on different planes are identical bytes.
Every served proof verifies against the height's committed DAH data root
via ShareProof.verify (clients reconstruct the dataclasses with
rpc/codec.share_proof_from_json, an attestation's with
rpc/codec.share_proofs_from_attestation).

Also here: the per-height DAS coverage map (which coordinates were served,
verified, withheld or tampered; `coverage_response` is the body of
`GET /das/coverage`), `count_served` (which closes the height timeline's
record on a height's first answer) and the attestation sample parser.

The port's copy of celestia_app_tpu/serve/api.py.  `DasProvider` takes a
`device` for the cache and sampler it builds when none is given (default
CUDA; raises without a card); the mid-heal gate, the adversary's tamper seam
and the single-flight rebuild are the JAX package's.  A coverage map counts
its decided cells as it ticks them, where the JAX one scans every cell for
the ratio on each served payload; the ratio is the same number.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict

from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, PARITY_NAMESPACE_BYTES


def render(payload: dict) -> bytes:
    """Canonical response bytes (sorted keys, compact separators) — the
    byte-identity unit shared by the GET routes and the gRPC service."""
    return json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()


def payload_namespace_label(payload) -> str:
    """The CAPPED per-tenant label of a served payload (the namespace
    accounting plane's cardinality contract): the proved share's
    namespace for share_proof payloads, the queried namespace for
    shares payloads, the reserved `other` bucket when the payload
    carries none (parity shares, errors, absent payloads)."""
    from celestia_app_tpu_torch.trace.square_journal import (
        OTHER_LABEL,
        capped_namespace_label,
        namespace_label,
    )

    ns_hex = None
    if isinstance(payload, dict):
        ns_hex = payload.get("namespace")
        if ns_hex is None and isinstance(payload.get("proof"), dict):
            ns_hex = payload["proof"].get("namespace")
    if not isinstance(ns_hex, str) or not ns_hex:
        return OTHER_LABEL
    try:
        ns = bytes.fromhex(ns_hex)
    except ValueError:
        return OTHER_LABEL
    if ns == PARITY_NAMESPACE_BYTES:
        # Parity shares are not a tenant (the sampler's twin
        # _proof_namespace_label applies the same fold): 3/4 of uniform
        # DAS coordinates would otherwise burn a capped-cardinality slot
        # on 0xff..ff and split this counter from the latency histogram.
        return OTHER_LABEL
    return capped_namespace_label(namespace_label(ns))


def payload_shard_label(payload) -> str:
    """Bounded `shard` label of one served payload: the serve shard
    owning the sampled coordinate's leaf node (serve/shard.py's routing
    math on the payload's own row/col/square_size), "0" whenever the
    plane is unsharded or the payload carries no coordinate (namespace
    queries, errors).  One env read on the single-device plane."""
    from celestia_app_tpu_torch.serve.shard import leaf_shard_of, serve_shards

    if not isinstance(payload, dict):
        return "0"
    try:
        shards = serve_shards()
    except RuntimeError:  # shards asked of a process without a card: no shard label
        return "0"
    if shards <= 1:
        return "0"
    k, row, col = (
        payload.get("square_size"), payload.get("row"), payload.get("col")
    )
    if not all(isinstance(v, int) for v in (k, row, col)):
        return "0"
    return str(leaf_shard_of(k, shards, row, col, payload.get("axis", "row")))


def count_served(plane: str, kind: str, payload=None) -> None:
    """One served DAS response: per-plane, per-kind, per-tenant (capped
    namespace label, the namespace accounting plane), and — when the serve
    plane is sharded — per owning shard (bounded by the shard count)."""
    from celestia_app_tpu_torch.trace.metrics import registry

    registry().counter(
        "celestia_proofs_served_total",
        "DAS proofs served, by serving plane, query kind, (capped) "
        "namespace, and owning serve shard",
    ).inc(
        plane=plane, kind=kind,
        namespace=payload_namespace_label(payload),
        shard=payload_shard_label(payload),
    )
    # The height timeline's closing event: the FIRST served answer for a
    # height finalizes its record and observes the critical-path
    # histograms (trace/timeline.py); later serves just bump the count.
    if isinstance(payload, dict) and payload.get("height") is not None:
        from celestia_app_tpu_torch.trace.timeline import timeline

        timeline().note_first_serve(payload.get("height"), plane, kind)


class UnknownHeight(KeyError):
    """No cached, spilled, or rebuildable square at this height (a 404)."""


# --- DAS coverage map ---------------------------------------------------------
#
# Which coordinates of a retained height have actually been DECIDED by the
# serving plane — the observable both PCMT papers' P(detect|s) curves are
# a function of.  A cell is ticked where a payload is decided: a served
# share_proof / namespace range / attestation set marks its coordinates
# `sampled` (or `verified` when the verification gate was armed and the
# proofs chained to the committed root), and the terminal refusals mark
# them with DISTINCT states — `withheld` (410: the proposer hid the
# share) and `tampered` (502: the served view contradicts the committed
# root) — so the map separates "nobody asked" from "asked and refused".
# Precedence is refusal > verified > sampled > unseen: a cell never
# forgets the worst thing it proved.

COVERAGE_STATES = ("sampled", "verified", "withheld", "tampered")
_STATE_RANK = {"sampled": 1, "verified": 2, "withheld": 3, "tampered": 4}
_RANK_NAME = ("unseen",) + COVERAGE_STATES
_RANK_CHAR = ".svwt"
#: Retained coverage maps (per height); oldest evicted — matches the
#: serve cache's "last N heights" retention shape without coupling to it.
COVERAGE_RETAIN = 64
#: Bitmaps render inline on /das/coverage only up to this edge (cells =
#: edge^2); larger squares serve counts + ratio with map_omitted=true.
MAX_COVERAGE_MAP_EDGE = 64

_COVERAGE_LOCK = threading.Lock()
_COVERAGE: OrderedDict[int, "CoverageMap"] = OrderedDict()


class CoverageMap:
    """Per-height coordinate state grid over the EXTENDED square (2k x
    2k), one byte per cell holding the state rank."""

    def __init__(self, height: int, k: int):
        self.height = height
        self.k = k
        self.cells = bytearray((2 * k) * (2 * k))
        # Cells with any decision, kept by `tick`: `ratio` is read on every
        # served payload, and scanning the (2k)^2 cells for it (as the JAX
        # package does) made a k=512 payload take ~15 ms instead of ~0.35
        # ms on the host of an H100 machine (chip_smoke.phase_serve).
        self.decided = 0

    def tick(self, coords, state: str) -> None:
        rank = _STATE_RANK[state]
        n = 2 * self.k
        for row, col in coords:
            if 0 <= row < n and 0 <= col < n:
                i = row * n + col
                if rank > self.cells[i]:
                    self.decided += self.cells[i] == 0
                    self.cells[i] = rank

    def counts(self) -> dict[str, int]:
        by_rank = [0] * len(_RANK_NAME)
        for c in self.cells:
            by_rank[c] += 1
        return {name: by_rank[i] for i, name in enumerate(_RANK_NAME)}

    def ratio(self) -> float:
        """Fraction of coordinates with ANY decision (served or refused)
        — refused cells count as covered: a refusal IS a detection
        datapoint, not a gap in sampling."""
        total = len(self.cells)
        if not total:
            return 0.0
        return self.decided / total

    def payload(self) -> dict:
        n = 2 * self.k
        out: dict = {
            "height": self.height,
            "square_size": self.k,
            "ratio": self.ratio(),
            "counts": self.counts(),
        }
        if n <= MAX_COVERAGE_MAP_EDGE:
            out["map"] = [
                "".join(_RANK_CHAR[c] for c in self.cells[r * n:(r + 1) * n])
                for r in range(n)
            ]
            out["map_omitted"] = False
        else:
            out["map_omitted"] = True
        return out


def coverage_tick(height: int, k: int, coords, state: str) -> None:
    """Record one payload decision on the height's coverage map and
    refresh `celestia_das_coverage_ratio{k}` (the gauge tracks the most
    recently ticked height per square size; per-height detail lives on
    GET /das/coverage)."""
    from celestia_app_tpu_torch.trace.metrics import registry

    with _COVERAGE_LOCK:
        cov = _COVERAGE.get(height)
        if cov is None or cov.k != k:
            cov = _COVERAGE[height] = CoverageMap(height, k)
        _COVERAGE.move_to_end(height)
        while len(_COVERAGE) > COVERAGE_RETAIN:
            _COVERAGE.popitem(last=False)
        cov.tick(coords, state)
        ratio = cov.ratio()
    registry().gauge(
        "celestia_das_coverage_ratio",
        "fraction of the most recently sampled height's extended-square "
        "coordinates with a decided DAS payload (served or refused), "
        "per square size",
    ).set(ratio, k=str(k))


def coverage_payload(height: int) -> dict | None:
    with _COVERAGE_LOCK:
        cov = _COVERAGE.get(height)
        return cov.payload() if cov is not None else None


def coverage_snapshot() -> dict:
    """Summary of every retained height's coverage (no bitmaps) — the
    flight-recorder bundle block and the /das/coverage height listing."""
    with _COVERAGE_LOCK:
        return {
            str(h): {
                "square_size": cov.k,
                "ratio": cov.ratio(),
                "counts": cov.counts(),
            }
            for h, cov in sorted(_COVERAGE.items())
        }


def coverage_response(query_params: dict):
    """GET /das/coverage -> (status, content_type, bytes): per-height
    bitmap with ?height=, the retained-heights summary without — a pure
    function of coverage state, byte-identical on every plane."""
    raw = query_params.get("height")
    if raw is None:
        return 200, "application/json", render({"heights": coverage_snapshot()})
    try:
        height = int(raw)
    except ValueError:
        return 400, "application/json", json.dumps(
            {"error": f"height must be an integer, got {raw!r}"}
        ).encode()
    payload = coverage_payload(height)
    if payload is None:
        return 404, "application/json", json.dumps(
            {"error": f"no coverage recorded at height {height}"}
        ).encode()
    return 200, "application/json", render(payload)


def _reset_coverage_for_tests() -> None:
    with _COVERAGE_LOCK:
        _COVERAGE.clear()


#: Hard cap on samples per attestation request: bounds the gather, the
#: multiproof assembly, and the response body a single query can demand.
MAX_ATTESTATION_SAMPLES = 4096


def parse_attestation_samples(spec: str) -> list[tuple[int, int, str]]:
    """Parse an attestation sample spec — comma-joined `row:col[:axis]`
    items (axis defaults to "row") — into the CANONICAL sample list:
    sorted by (axis, tree, leaf), duplicates dropped.  Every plane parses
    the same spec through this one function, so the canonical order (and
    with it the payload bytes) is structural, not per-plane."""
    out: set[tuple[int, int, str]] = set()
    if not spec.strip():
        raise ValueError("samples spec is empty (want row:col[:axis],...)")
    for item in spec.split(","):
        parts = item.strip().split(":")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"bad sample {item!r} (want row:col or row:col:axis)"
            )
        axis = parts[2] if len(parts) == 3 else "row"
        if axis not in ("row", "col"):
            raise ValueError(f"axis must be 'row' or 'col', got {axis!r}")
        try:
            row, col = int(parts[0]), int(parts[1])
        except ValueError as e:
            raise ValueError(f"bad sample {item!r}: {e}") from e
        if row < 0 or col < 0:
            raise ValueError(f"bad sample {item!r}: negative coordinate")
        out.add((row, col, axis))
    if len(out) > MAX_ATTESTATION_SAMPLES:
        raise ValueError(
            f"{len(out)} samples exceed the per-request cap "
            f"{MAX_ATTESTATION_SAMPLES}"
        )
    # Canonical order: by (axis, tree index, leaf index) — the grouping
    # the multiproof assembly walks, so tree order and range order in the
    # payload are the sort order, never insertion order.
    def key(s):
        row, col, axis = s
        tree, leaf = (row, col) if axis == "row" else (col, row)
        return (axis, tree, leaf)

    return sorted(out, key=key)


def _attestation_latency():
    from celestia_app_tpu_torch.trace.metrics import DEVICE_SECONDS_BUCKETS, registry

    return registry().histogram(
        "celestia_attestation_latency_seconds",
        "attestation build latency by phase (parse/gather/assemble/verify)",
        buckets=DEVICE_SECONDS_BUCKETS,
    )


class DasProvider:
    """Binds a ForestCache + ProofSampler + an optional rebuild source.

    `rebuild(height)` returns an ExtendedDataSquare for a height the
    cache no longer holds (a ServingNode reconstructs it from the block
    store's raw txs — the querier path), or None when the height is
    genuinely unknown; the rebuilt square is re-admitted so the next
    sample is a hit.
    """

    def __init__(self, cache=None, sampler=None, rebuild=None, device=None):
        from celestia_app_tpu_torch.serve.cache import ForestCache
        from celestia_app_tpu_torch.serve.sampler import ProofSampler

        self.cache = cache if cache is not None else ForestCache(device=device)
        self.sampler = (sampler if sampler is not None
                        else ProofSampler(device=self.cache.device))
        self.rebuild = rebuild
        # The node's HealingEngine (serve/heal.py), when one is wired:
        # heights mid-heal answer retryable statuses instead of the
        # terminal detection errors.
        self.healer = None
        # Serializes the miss path: N concurrent requests for one evicted
        # height must cost ONE square rebuild + forest build, not N.
        self._rebuild_lock = threading.Lock()

    def entry(self, height: int):
        healer = self.healer
        if healer is not None and healer.healing(height):
            from celestia_app_tpu_torch.serve.heal import HealingInProgress

            # Mid-heal is RETRYABLE (503 + Retry-After / UNAVAILABLE),
            # never the terminal 410/502: the detection that started the
            # heal already got its terminal status, and the client that
            # backs off lands on the healed height.
            raise HealingInProgress(height, healer.retry_after_s)
        return self.serve_view(height)

    def serve_view(self, height: int):
        """The (possibly adversary-filtered) view of a height, WITHOUT
        the mid-heal gate — what the network answers this node.  The
        healing engine gathers from this view (and trusts none of it
        unverified); `entry()` adds the gate for external samplers."""
        entry = self._honest_entry(height)
        if getattr(entry, "healed", False):
            # A height recovered by repair and root-verified locally is
            # served from this node's own store: the withholding /
            # tampering proposer sits between the node and the network,
            # not between the node and its verified bytes.
            return entry
        # The adversary seam: a tampering proposer (malform_shares /
        # wrong_root in $CELESTIA_CHAOS) serves a corrupted VIEW of the
        # height — same object every request, honest cache untouched —
        # which the sampler's verification gate then detects.
        from celestia_app_tpu_torch import chaos

        adv = chaos.active_adversary()
        if adv is not None and adv.tampers():
            return adv.tamper_entry(entry)
        return entry

    def _honest_entry(self, height: int):
        entry, tier = self.cache.get(height)
        if entry is not None:
            return entry
        with self._rebuild_lock:
            entry, tier = self.cache.get(height)  # a peer may have rebuilt
            if entry is not None:
                return entry
            eds = self.rebuild(height) if self.rebuild is not None else None
            if eds is None:
                raise UnknownHeight(f"no square known at height {height}")
            entry = self.cache.put(height, eds)
        if entry is None:  # retention disabled: serve without admitting
            from celestia_app_tpu_torch.serve.shard import build_entry

            entry = build_entry(height, eds, self.cache.device, self.cache.mesh)
        return entry

    # --- payload builders ---------------------------------------------------
    def share_proof_payload(
        self, height: int, row: int, col: int, axis: str = "row"
    ) -> dict:
        from celestia_app_tpu_torch.rpc.codec import to_jsonable
        from celestia_app_tpu_torch.serve.sampler import (
            BadProofDetected,
            ShareWithheld,
            _verify_gate_armed,
        )

        entry = self.entry(height)
        try:
            proof = self.sampler.share_proof(entry, row, col, axis=axis)
        except ShareWithheld:
            coverage_tick(height, entry.k, [(row, col)], "withheld")
            raise
        except BadProofDetected:
            coverage_tick(height, entry.k, [(row, col)], "tampered")
            raise
        coverage_tick(
            height, entry.k, [(row, col)],
            "verified" if _verify_gate_armed(entry) else "sampled",
        )
        return {
            "height": height,
            "row": row,
            "col": col,
            "axis": axis,
            "square_size": entry.k,
            "proof": to_jsonable(proof),
            "data_root": entry.data_root.hex(),
        }

    def shares_payload(self, height: int, namespace_hex: str) -> dict:
        from celestia_app_tpu_torch.proof.share_proof import ods_namespace_range
        from celestia_app_tpu_torch.rpc.codec import to_jsonable

        try:
            namespace = bytes.fromhex(namespace_hex)
        except ValueError as e:
            raise ValueError(f"namespace must be hex: {e}") from e
        if len(namespace) != NAMESPACE_SIZE:
            raise ValueError(
                f"namespace must be {NAMESPACE_SIZE} bytes, "
                f"got {len(namespace)}"
            )
        # Read-path QoS: a namespace query names its tenant up front, so
        # the proof-rate gate runs BEFORE any gather work (the sampler's
        # share_proof twin charges the served share's label instead).
        from celestia_app_tpu_torch import qos
        from celestia_app_tpu_torch.trace.square_journal import (
            capped_namespace_label,
            namespace_label,
        )

        enf = qos.enforcer()
        if enf is not None:
            enf.admit_proof(capped_namespace_label(namespace_label(namespace)))
        entry = self.entry(height)
        rng = ods_namespace_range(entry.eds, namespace)
        payload: dict = {
            "height": height,
            "namespace": namespace_hex.lower(),
            "square_size": entry.k,
            "data_root": entry.data_root.hex(),
        }
        if rng is None:
            payload.update({"found": False, "shares": 0, "proof": None})
            return payload
        from celestia_app_tpu_torch.proof.share_proof import new_share_inclusion_proof

        proof = new_share_inclusion_proof(entry.eds, rng[0], rng[1])
        # The same verification gate the sampler applies to share_proof:
        # under a tampering adversary (or $CELESTIA_SERVE_VERIFY=1) a
        # namespace payload built from the served view must chain to the
        # committed root before it leaves — BadProofDetected (502 /
        # DATA_LOSS on the planes) instead of a 200 endorsing forged
        # state.  The found=False branch serves no proof, so there is
        # nothing to endorse there.
        from celestia_app_tpu_torch.serve.sampler import (
            BadProofDetected,
            _verify_gate_armed,
        )

        coords = [(i // entry.k, i % entry.k) for i in range(rng[0], rng[1])]
        try:
            self.sampler._gate(entry, [proof])
        except BadProofDetected:
            coverage_tick(height, entry.k, coords, "tampered")
            raise
        coverage_tick(
            height, entry.k, coords,
            "verified" if _verify_gate_armed(entry) else "sampled",
        )
        payload.update({
            "found": True,
            "start": rng[0],
            "end": rng[1],
            "shares": rng[1] - rng[0],
            "proof": to_jsonable(proof),
        })
        return payload

    def attestation_payload(self, height: int, samples: str) -> dict:
        """One deduped multiproof attestation for a SET of samples.

        s independent `share_proof` responses repeat the upper tree nodes
        of every shared row/column; this payload serializes each NMT node
        ONCE per tree (nmt/proof.multiproof) and each data-root audit
        node once per (level, sibling) coordinate, so the wire cost grows
        ~log instead of ~s x log.  Per-sample ShareProofs reconstruct
        byte-identically from the tables (rpc/codec.
        share_proofs_from_attestation), which is also how the verify gate
        here decides the payload — the gate verifies EXACTLY the bytes a
        client would.

        Same refusal semantics as share_proof: withheld coordinates raise
        ShareWithheld (410), a tampered view fails the verification gate
        with BadProofDetected (502), mid-heal heights answer 503."""
        import time

        from celestia_app_tpu_torch import merkle
        from celestia_app_tpu_torch.nmt.proof import multiproof_from_levels
        from celestia_app_tpu_torch.serve.sampler import (
            ShareWithheld,
            _check_withheld,
            _qos_gate_sample,
        )
        from celestia_app_tpu_torch.trace.metrics import registry

        lat = _attestation_latency()
        t0 = time.perf_counter()
        sample_list = parse_attestation_samples(samples)
        entry = self.entry(height)
        n = 2 * entry.k
        for row, col, _axis in sample_list:
            if not (row < n and col < n):
                raise ValueError(f"coordinate ({row},{col}) outside {n}x{n}")
        coords = [(row, col) for row, col, _axis in sample_list]
        # The same per-sample refusals the share_proof path applies, in
        # canonical order: the FIRST withheld coordinate fails the
        # request (410); every data-quadrant sample pays its tenant's
        # proof-rate token before any gather work.  A withheld set is a
        # DETECTION over the whole requested set — the coverage map
        # records every asked coordinate under the refusal state.
        try:
            _check_withheld(entry, coords)
        except ShareWithheld:
            coverage_tick(height, entry.k, coords, "withheld")
            raise
        for row, col, _axis in sample_list:
            _qos_gate_sample(entry, row, col)
        lat.observe(time.perf_counter() - t0, phase="parse")

        t1 = time.perf_counter()
        shares = entry.gather_shares(coords)  # ONE gather for the set
        lat.observe(time.perf_counter() - t1, phase="gather")

        t2 = time.perf_counter()
        by_tree: dict = {}  # (axis, tree) -> [leaf, ...]  (sorted already)
        for row, col, axis in sample_list:
            tree, leaf = (row, col) if axis == "row" else (col, row)
            by_tree.setdefault((axis, tree), []).append(leaf)
        nodes: list[bytes] = []
        root_nodes: list[bytes] = []
        root_table: dict[tuple[int, int], int] = {}
        trees: list[dict] = []
        all_roots = entry.row_roots + entry.col_roots
        for (axis, tree), leaves in by_tree.items():
            mp = multiproof_from_levels(
                entry.line_levels(axis, tree),
                [(leaf, leaf + 1) for leaf in leaves],
            )
            offset = len(nodes)
            nodes.extend(mp.nodes)
            root_index = tree if axis == "row" else n + tree
            path = merkle.path_from_levels(entry.root_levels, root_index)
            refs: list[int] = []
            for lvl, sib in enumerate(path):
                coord = (lvl, (root_index >> lvl) ^ 1)
                j = root_table.get(coord)
                if j is None:
                    j = root_table[coord] = len(root_nodes)
                    root_nodes.append(sib)
                refs.append(j)
            trees.append({
                "axis": axis,
                "index": tree,
                "total": mp.total,
                "root": all_roots[root_index].hex(),
                "ranges": [[s, e] for s, e in mp.ranges],
                "node_refs": [
                    [j + offset for j in rr] for rr in mp.node_refs
                ],
                "root_index": root_index,
                "root_total": len(all_roots),
                "root_path_refs": refs,
            })
        payload = {
            "height": height,
            "square_size": entry.k,
            "data_root": entry.data_root.hex(),
            "samples": [
                {"row": row, "col": col, "axis": axis}
                for row, col, axis in sample_list
            ],
            "shares": [bytes(s.tobytes()).hex() for s in shares],
            "trees": trees,
            "nodes": [nd.hex() for nd in nodes],
            "root_nodes": [nd.hex() for nd in root_nodes],
        }
        lat.observe(time.perf_counter() - t2, phase="assemble")

        # The verification gate decides the reconstructed per-sample
        # proofs — the exact dataclasses a light client rebuilds from
        # these bytes — through the batched verifier (sampler._gate ->
        # serve/verify.verify_proofs): a tampered view or forged root is
        # a BadProofDetected (502), never a served attestation.
        t3 = time.perf_counter()
        from celestia_app_tpu_torch.rpc.codec import share_proofs_from_attestation
        from celestia_app_tpu_torch.serve.sampler import (
            BadProofDetected,
            _verify_gate_armed,
        )

        armed = _verify_gate_armed(entry)
        if armed:
            try:
                self.sampler._gate(
                    entry, share_proofs_from_attestation(payload)
                )
            except BadProofDetected:
                coverage_tick(height, entry.k, coords, "tampered")
                raise
        coverage_tick(
            height, entry.k, coords, "verified" if armed else "sampled"
        )
        lat.observe(time.perf_counter() - t3, phase="verify")

        registry().counter(
            "celestia_attestation_bytes_total",
            "attestation response bytes built (canonical render), the "
            "numerator of bytes-per-verified-sample",
        ).inc(float(len(render(payload))))
        registry().counter(
            "celestia_attestation_samples_total",
            "samples covered by built attestations",
        ).inc(float(len(sample_list)))
        return payload
