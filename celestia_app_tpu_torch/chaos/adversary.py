"""Protocol adversaries: the chaos layer's attack model.

chaos/spec.py injects INFRASTRUCTURE faults — stalls, drops, torn writes.
This module injects ADVERSARIES: deterministic, seeded misbehaviour shaped
after the availability-attack model of the Polar Coded Merkle Tree papers
(arXiv 2301.08295 / 2201.07287 — a malicious block producer who commits a
root and then denies or corrupts the data behind it).  Three adversaries,
each behind its own $CELESTIA_CHAOS key:

    withhold_frac=<f>    the WITHHOLDING PROPOSER: commits the honest DAH
                         but hides a uniform-random fraction f of the EDS
                         shares from the serve path.  A DAS sample landing
                         on a withheld coordinate cannot be answered —
                         that failed sample IS the light client's
                         detection signal (serve/sampler.ShareWithheld),
                         and P(detect | s samples) = 1 - (1-f)^s is the
                         curve the JAX package's chaos soak measures.
    malform_shares=<n>   MALFORMED-SQUARE INJECTION: after commit, n
                         share's bytes in the served square are corrupted
                         while the committed root stays honest.  Every
                         proof assembled over a corrupted share fails the
                         sampler's verification gate — detected, never
                         served as valid.
    wrong_root=1         WRONG-ROOT INJECTION: the served DAH data root
                         does not match the square.  No honest proof can
                         chain to it (sampler verification), and a repair
                         against it raises RootMismatch.

Determinism contract (stronger than the ordinal-draw seams): each
adversary derives its RNG from (spec seed, its own seam name, height,
square width) — `adversary.withhold`, `adversary.malform`,
`adversary.root` — so the withheld/corrupted coordinate set for a given
height is a pure function of the spec, independent of request order,
thread interleaving, or how many samples were already served.  The same
spec over the same chain withholds the same shares; the soak's honest leg
(every adversary key at 0) is bit-identical to no chaos at all.

Detections land on ONE family, `celestia_da_detections_total{kind}`
(kinds: withheld / bad_proof / root_mismatch), and each adversary event
black-boxes through its flight-recorder trigger (`withholding_detected`,
`root_mismatch`) — rate-limited, so a drill fires each exactly once.

The port's copy of celestia_app_tpu/chaos/adversary.py: the same spec gives
the same withheld and malformed sets and the same corrupted bytes.  One
difference: `tamper_entry` corrupts a clone of the entry's EDS tensor where
it lies (on the card for a device-tier entry), at the positions
`corrupt_square` draws, instead of copying the square through host memory.
"""

from __future__ import annotations

import hashlib
import random
import threading

import numpy as np

#: The $CELESTIA_CHAOS keys this module owns (chaos/spec.py admits them).
ADVERSARY_KEYS = ("withhold_frac", "malform_shares", "wrong_root")


def detections():
    """THE adversary-detection counter — repair and the serve plane both
    register through here so the family cannot fork."""
    from celestia_app_tpu_torch.trace.metrics import registry

    return registry().counter(
        "celestia_da_detections_total",
        "data-availability attacks detected, by kind (root_mismatch: "
        "repair rejected an inconsistent survivor set or a wrong DAH; "
        "withheld / bad_proof: serve-plane sampler detections)",
    )


class Adversary:
    """The live adversary for one parsed chaos spec.

    Stateless between calls except for per-height memos (the tampered
    view of a square must be the SAME bytes on every request — a real
    attacker serves one corrupted square, not a fresh one per sample).
    """

    def __init__(self, seed: int, withhold_frac: float,
                 malform_shares: int, wrong_root: bool):
        self.seed = seed
        self.withhold_frac = min(max(withhold_frac, 0.0), 1.0)
        self.malform_shares = max(int(malform_shares), 0)
        self.wrong_root = bool(wrong_root)
        self._lock = threading.Lock()
        self._withheld: dict[tuple[int, int], frozenset] = {}
        self._malformed: dict[tuple[int, int], tuple] = {}
        self._tampered: dict[int, object] = {}

    @classmethod
    def from_params(cls, params: dict) -> "Adversary | None":
        """None when no adversary key is set — the fast path every
        honest request takes."""
        f = float(params.get("withhold_frac", 0.0))
        n = int(float(params.get("malform_shares", 0.0)))
        w = float(params.get("wrong_root", 0.0)) > 0
        if f <= 0 and n <= 0 and not w:
            return None
        return cls(int(params.get("seed", 0)), f, n, w)

    def _rng(self, seam: str, height: int, n: int) -> random.Random:
        """Per-seam, per-(height, width) RNG: the spec contract's
        interleaving independence, strengthened to request-order
        independence (the coordinate sets are pure functions)."""
        return random.Random(
            f"celestia-chaos:{self.seed}:{seam}:{height}:{n}"
        )

    # --- withholding proposer ----------------------------------------------
    def withheld_set(self, height: int, n: int) -> frozenset:
        """The withheld (row, col) set for one height's n x n EDS:
        floor(withhold_frac * n^2) coordinates drawn without
        replacement."""
        if self.withhold_frac <= 0:
            return frozenset()
        key = (height, n)
        with self._lock:
            cached = self._withheld.get(key)
            if cached is not None:
                return cached
        rng = self._rng("adversary.withhold", height, n)
        count = int(self.withhold_frac * n * n)
        flat = rng.sample(range(n * n), count)
        out = frozenset((i // n, i % n) for i in flat)
        with self._lock:
            self._withheld[key] = out
        return out

    def withholds(self, height: int, n: int, row: int, col: int) -> bool:
        return (row, col) in self.withheld_set(height, n)

    # --- malformed square ---------------------------------------------------
    def malformed_coords(self, height: int, n: int) -> tuple:
        if self.malform_shares <= 0:
            return ()
        key = (height, n)
        with self._lock:
            cached = self._malformed.get(key)
            if cached is not None:
                return cached
        rng = self._rng("adversary.malform", height, n)
        count = min(self.malform_shares, n * n)
        flat = rng.sample(range(n * n), count)
        out = tuple((i // n, i % n) for i in flat)
        with self._lock:
            self._malformed[key] = out
        return out

    def _corruptions(self, height: int, n: int, width: int) -> list:
        """[(row, col, byte position), ...] of the malformed shares of one
        n x n square of `width`-byte shares, in the draw order of
        corrupt_square (a fresh stream of the malform seam, one draw per
        malformed coordinate)."""
        rng = self._rng("adversary.malform", height, n)
        return [(row, col, rng.randrange(width))
                for row, col in self.malformed_coords(height, n)]

    def corrupt_square(self, height: int, eds_bytes: np.ndarray) -> np.ndarray:
        """A corrupted COPY of the (n, n, S) share array: one byte of
        each malformed share XOR-flipped (deterministic position), the
        rest untouched."""
        out = np.array(eds_bytes, copy=True)
        for row, col, pos in self._corruptions(height, out.shape[0], out.shape[-1]):
            out[row, col, pos] ^= 0xFF
        return out

    def corrupt_tensor(self, height: int, eds):
        """corrupt_square's bytes on a clone of the (n, n, S) EDS where it
        lies: a tensor, or a row-sharded EDS (parallel/mesh.RowSharded)
        cloned block by block on each block's device."""
        import torch

        from celestia_app_tpu_torch.parallel.mesh import RowSharded

        n, width = int(eds.shape[0]), int(eds.shape[-1])
        hits = self._corruptions(height, n, width)
        if isinstance(eds, RowSharded):
            blocks = [b.clone() for b in eds.blocks]
            for row, col, pos in hits:
                b, local = eds.locate(row)
                blocks[b][local, col, pos] ^= 0xFF
            return RowSharded(eds.mesh, blocks, eds.owners)
        out = eds.clone()
        if hits:
            rows, cols, pos = (torch.tensor(v, dtype=torch.int64, device=out.device)
                               for v in zip(*hits))
            out[rows, cols, pos] ^= 0xFF
        return out

    # --- wrong root ---------------------------------------------------------
    def forged_root(self, honest_root: bytes) -> bytes:
        """A deterministic root that is NOT the square's: committed by
        the adversarial proposer in place of the honest one."""
        return hashlib.sha256(
            b"celestia-adversary-wrong-root:" + honest_root
        ).digest()

    # --- serve-path tampering ----------------------------------------------
    def tampers(self) -> bool:
        return self.malform_shares > 0 or self.wrong_root

    def tamper_entry(self, entry):
        """The adversarial VIEW of one cached serve entry: corrupted
        share bytes (malform_shares) and/or a forged committed root
        (wrong_root), with the honest forests left in place — exactly
        the state a malicious proposer creates, where the committed
        structure and the served bytes disagree.  Memoized per height so
        every sample sees the same attack."""
        if not self.tampers():
            return entry
        with self._lock:
            cached = self._tampered.get(entry.height)
            if cached is not None:
                return cached
        import copy

        tampered = copy.copy(entry)
        if self.malform_shares > 0:
            self.count_injection("adversary.malform", "malform_shares")
        if self.wrong_root:
            self.count_injection("adversary.root", "wrong_root")
        if self.malform_shares > 0:
            eds_view = copy.copy(entry.eds)
            eds_view._eds = self.corrupt_tensor(entry.height, entry.eds._eds)
            # Never share the honest entry's memoized trees: the host
            # lowering must rebuild from the corrupted bytes.
            eds_view._tree_memo = {}
            tampered.eds = eds_view
        if self.wrong_root:
            tampered.data_root = self.forged_root(entry.data_root)
        with self._lock:
            self._tampered[entry.height] = tampered
        return tampered

    def invalidate_tampered(self, height: int) -> None:
        """Drop the memoized tampered view of one height.

        The memo's contract is "one attack serves ONE corrupted square",
        which holds only while the underlying height is the same state:
        after a repair-driven re-admission (serve/cache.ForestCache.put /
        readmit call this) the stale tampered copy would keep serving the
        PRE-heal bytes and hide the recovery until a restart.  The
        withheld/malformed coordinate SETS stay memoized — they are pure
        functions of the spec, and a still-active adversary re-tampers a
        freshly fetched square with exactly the same coordinates."""
        with self._lock:
            self._tampered.pop(height, None)

    def count_injection(self, seam: str, fault: str) -> None:
        """Adversary events ride the same injection accounting as the
        infrastructure seams (celestia_chaos_injections_total + the
        chaos_injection trace row)."""
        from celestia_app_tpu_torch.trace.metrics import registry
        from celestia_app_tpu_torch.trace.tracer import traced

        registry().counter(
            "celestia_chaos_injections_total",
            "chaos faults injected, by seam",
        ).inc(seam=seam)
        traced().write("chaos_injection", seam=seam, fault=fault)
