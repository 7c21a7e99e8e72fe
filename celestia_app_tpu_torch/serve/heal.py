"""HealingEngine: the detect -> repair -> re-serve control loop.

Every leg existed in isolation before this module — the sampling plane
DETECTS (ShareWithheld / BadProofDetected), `da/repair` rebuilds a
square from >= 25% survivors at device speed, and ForestCache re-admits —
but a detection ended at an HTTP 410/502 and a flight bundle.  This is
the ACeD-style availability-oracle loop (arXiv 2011.00102): the node that
notices a gap CLOSES it, so downstream consumers never see one.

One heal, five measured phases (`celestia_heal_seconds{phase}`):

  detect    detection-signal latency: first detection note -> heal start
            (the queue wait; the sampling-side time-to-first-detection is
            the drill's separate detect_ms, per arXiv 2201.07287's
            P(detect | s samples) model)
  gather    collect the surviving shares for the height: withheld
            coordinates never answer, and every fetched share is
            verified against the node's COMMITTED NMT leaf digests (the
            retained forest's level-0 nodes chain to the DAH this node
            signed) — tampered bytes can never enter the repair as
            "survivors"
  repair    batched device repair (da/repair.py), riding
            chaos/degrade.guarded_dispatch: an injected dispatch fault
            mid-repair walks the ladder, never wedges the node
  verify    the recovered square's roots are re-derived and compared
            bit-for-bit against the committed DAH BEFORE anything else
            can see the bytes — a heal that cannot prove itself is a
            failed attempt, never a served square
  readmit   re-admission into ForestCache through the single-flight
            gate (ForestCache.readmit: coalesces with a concurrent
            rebuild, evicts any adversary-tampered per-height memo) and
            the entry is marked `healed`, so the previously-withheld
            coordinates serve from the node's own verified store

plus `total` (detection note -> re-admitted).  Outcomes land on
`celestia_heal_total{outcome}`:

  healed        the height serves again, root-verified
  irrecoverable the survivor set is below the k-survivor threshold
                (da/repair.IrrecoverableSquare) — no retry can help
  quarantined   bounded retry/backoff exhausted without a verified
                recovery

Failed heights enter QUARANTINE: their detections stay terminal
(410/502), no heal storm re-enqueues them, and the state is visible in
the /healthz "heal" block and `GET /heal`.  Heights mid-heal are
RETRYABLE: `DasProvider.entry` raises HealingInProgress, which the HTTP
planes map to 503 + Retry-After and the gRPC Das service to UNAVAILABLE
— a client that backs off lands on the healed height.

Both terminal transitions black-box: `heal_completed` /
`heal_quarantined` flight-recorder triggers carry the node name, height,
outcome, per-phase latencies, and attempt count.

Wiring: construct a HealingEngine over a DasProvider (it registers
itself module-wide and as `provider.healer`); the detection sites
(serve/sampler, da/repair) publish through `note_detection`, which is
one registry walk and never raises.  `$CELESTIA_HEAL=1` makes a
NodeServer wire and start one automatically (rpc/server.py).

The port's copy of celestia_app_tpu/serve/heal.py.  `heal_payload` and
`heal_health_block` are the bodies of `GET /heal` and the /healthz "heal"
block of the port's exposition (trace/exposition.py).  Two
differences:

  * The gather stays on the card: the served square's tensor, the
    committed level-0 digests read from the forest
    (CachedForest.gather_device), one `sha256_leaves` launch over every
    coordinate that answered (serve/verify.leaf_digests) and the
    comparison; only the (2k, 2k) survivor mask comes to the host.  The
    repair runs on the provider's cache's device.
  * A device fault is not a quarantine.  A fault of the card past the
    ladder's floor (device.DeviceFault, from the survivor check, the
    repair or the re-admission's forest build) is not a verdict on the
    data: `_heal_one` does not catch it, the height leaves the mid-heal
    state, no quarantine or healed record is written and
    celestia_heal_total is not ticked.  `process_pending` raises it; the
    worker thread prints it to stderr and goes on, and a later detection
    enqueues the height again.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from contextlib import contextmanager

from celestia_app_tpu_torch.device import DeviceFault

#: Heal outcomes (the `celestia_heal_total{outcome}` label values).
HEAL_OUTCOMES = ("healed", "quarantined", "irrecoverable")

#: Measured phases of one heal (`celestia_heal_seconds{phase}`).
HEAL_PHASES = ("detect", "gather", "repair", "verify", "readmit", "total")


class HealingInProgress(RuntimeError):
    """The height is being healed right now: retryable (HTTP 503 +
    Retry-After / gRPC UNAVAILABLE), never the terminal 410/502 — the
    client that backs off and retries lands on the healed height."""

    def __init__(self, height: int, retry_after_s: float):
        super().__init__(
            f"height {height} is being healed (detected attack under "
            f"repair); retry in {retry_after_s:g}s"
        )
        self.height = height
        self.retry_after_s = retry_after_s


def heal_enabled() -> bool:
    """$CELESTIA_HEAL=1: a ServingNode wires and starts a HealingEngine
    over its DasProvider automatically (default off: detection without
    reaction)."""
    import os

    return os.environ.get("CELESTIA_HEAL", "") == "1"


def heal_seconds():
    from celestia_app_tpu_torch.trace.metrics import DEVICE_SECONDS_BUCKETS, registry

    return registry().histogram(
        "celestia_heal_seconds",
        "self-healing loop latency by phase (detect = detection note to "
        "heal start; gather/repair/verify/readmit per attempt; total = "
        "detection note to re-admitted)",
        buckets=DEVICE_SECONDS_BUCKETS,
    )


def heal_total():
    from celestia_app_tpu_torch.trace.metrics import registry

    return registry().counter(
        "celestia_heal_total",
        "heal attempts resolved, by outcome "
        "(healed / quarantined / irrecoverable)",
    )


# --- the engine registry (how detection sites find their engine) ------------

_REG_LOCK = threading.Lock()
_ENGINES: list["HealingEngine"] = []


def register(engine: "HealingEngine") -> None:
    with _REG_LOCK:
        if engine not in _ENGINES:
            _ENGINES.append(engine)


def unregister(engine: "HealingEngine") -> None:
    with _REG_LOCK:
        if engine in _ENGINES:
            _ENGINES.remove(engine)


def engines() -> tuple["HealingEngine", ...]:
    with _REG_LOCK:
        return tuple(_ENGINES)


def _reset_for_tests() -> None:
    with _REG_LOCK:
        _ENGINES.clear()


def note_detection(kind: str, height, entry=None) -> None:
    """Publish one detection signal (withheld / bad_proof / root_mismatch)
    to whichever registered engine owns the height.  The hot-path face of
    the subscription: no engine registered = one tuple read; NEVER raises
    (a heal trigger that takes down the detection path is worse than no
    healing at all)."""
    if height is None:
        return
    for eng in engines():
        try:
            eng.note(kind, int(height), entry=entry)
        except Exception:  # chaos-ok: healing must never break detection
            pass


def heal_health_block():
    """The /healthz "heal" block: None when no engine is registered, one
    engine's state directly, or {name: state} for a multi-node process."""
    engs = engines()
    if not engs:
        return None
    if len(engs) == 1:
        return engs[0].state()
    return {e.name: e.state() for e in engs}


def heal_payload() -> dict:
    """GET /heal: every registered engine's state, keyed by engine name —
    a pure function of engine state, so all planes serve identical
    bytes."""
    return {"engines": {e.name: e.state() for e in engines()}}


def default_survivors(height: int, view, honest):
    """The default gather: (shares (n, n, S) uint8 tensor, present (n, n)
    bool numpy).

    `view` is the adversary-filtered serve view (what the network answers
    this node); `honest` is the node's retained proof state, whose forest
    level-0 leaf digests chain to the DAH the node committed.  Two rules:

      * a coordinate the adversary withholds never answers — the
        simulation's fetch failure (chaos.active_adversary's withheld
        set IS the model's ground truth of "nobody served this");
      * every share that DOES answer is verified against the committed
        leaf digest before it may count as a survivor — a malformed
        share hashes to the wrong leaf and is excluded, so tampered
        bytes cannot poison the repair (the survivors stay authoritative
        inside da/repair, so this gate must hold at the door).

    The shares stay where the view's square lies (never modified: repair
    works on a copy); the check runs there in one leaf-hash launch, and
    only the mask comes to the host.
    """
    import numpy as np
    import torch

    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, PARITY_NAMESPACE_BYTES
    from celestia_app_tpu_torch.serve.verify import leaf_digests

    k = view.k
    n = 2 * k
    present = np.ones((n, n), dtype=bool)
    adv = chaos.active_adversary()
    if adv is not None and adv.withhold_frac > 0:
        for (r, c) in adv.withheld_set(height, n):
            present[r, c] = False
    with _on_card("the survivor check"):
        shares = _one_tensor(view.eds._eds)
        dev = shares.device
        # ONE gather of every committed level-0 digest (offsets[0] == 0:
        # node (row, 0, col) is flat row row * n + col), then ONE leaf-hash
        # launch over every coordinate that answered.
        expect = honest.gather_device("row", np.arange(n * n)).to(dev)
        flat = torch.from_numpy(np.flatnonzero(present)).to(dev)
        if flat.numel():
            cells = shares.reshape(n * n, -1).index_select(0, flat)
            ns = cells[:, :NAMESPACE_SIZE].clone()
            rows, cols = flat // n, flat % n
            parity = (rows >= k) | (cols >= k)
            ns[parity] = torch.frombuffer(bytearray(PARITY_NAMESPACE_BYTES),
                                          dtype=torch.uint8).to(dev)
            got = leaf_digests(ns, cells)
            bad = flat[~(got == expect.index_select(0, flat)).all(dim=1)]
            present.reshape(-1)[bad.cpu().numpy()] = False
    return shares, present


def _one_tensor(buf):
    """The square as one tensor on its (first) device: a row-sharded EDS
    (parallel/mesh.RowSharded) is gathered onto its first block's device."""
    import torch

    blocks = getattr(buf, "blocks", None)
    if blocks is None:
        return buf
    return torch.cat([b.to(blocks[0].device) for b in blocks])


@contextmanager
def _on_card(what: str):
    """Raise a fault of the body's device work as DeviceFault, and let the
    verdicts on the data (IrrecoverableSquare, RootMismatch) through."""
    from celestia_app_tpu_torch.da.repair import IrrecoverableSquare, RootMismatch

    try:
        yield
    except (DeviceFault, IrrecoverableSquare, RootMismatch):
        raise
    except Exception as e:
        raise DeviceFault(f"heal: {what} failed on the device: {e!r}") from e


class HealingEngine:
    """The per-node heal loop over one DasProvider.

    Detection notes enqueue a height and mark it mid-heal (samples get
    the retryable status immediately); `start()` runs a worker thread,
    `process_pending()` drains synchronously (drills, tests).  Bounded
    retry with exponential backoff per height; terminal failures land in
    quarantine, never in a retry storm.
    """

    def __init__(self, provider, *, name: str = "node",
                 committed_dah=None, survivors=None,
                 max_attempts: int = 3, backoff_s: float = 0.02,
                 retry_after_s: float = 1.0, sleep=time.sleep):
        self.provider = provider
        self.name = name
        self.max_attempts = max(int(max_attempts), 1)
        self.backoff_s = backoff_s
        self.retry_after_s = retry_after_s
        self._committed = committed_dah  # callable(height) -> DAH override
        self._survivors = survivors or default_survivors
        self._sleep = sleep
        self._cv = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._healing: dict[int, dict] = {}
        # Bounded (oldest evicted): a long-lived node under sustained
        # attack must not grow its health payload or RSS with chain
        # height.  An ancient evicted quarantine record means that
        # height would be re-attempted on a fresh detection — by then
        # the world has usually changed; terminal-forever is not worth
        # an unbounded map.
        self._quarantined: collections.OrderedDict = collections.OrderedDict()
        self._healed: collections.OrderedDict = collections.OrderedDict()
        self._healed_count = 0
        self._last: dict | None = None
        self._thread: threading.Thread | None = None
        self._stop_flag = False
        provider.healer = self
        register(self)

    #: Retained terminal records (memory bound, not a semantic window).
    MAX_RECORDS = 1024
    #: Quarantined heights serialized into state() (the health payload
    #: must stay bounded like /namespaces' top-N cap).
    STATE_QUARANTINED = 16

    # --- subscription -------------------------------------------------------
    def note(self, kind: str, height: int, entry=None) -> bool:
        """One detection signal.  Returns True when the height was
        enqueued for healing; False when it is not this engine's (the
        entry's owning cache is another node's), already mid-heal (the
        healer's own repair hitting RootMismatch must not recurse), or
        quarantined (terminal: no heal storm)."""
        if entry is not None:
            if getattr(entry, "owner", None) is not self.provider.cache:
                return False
        elif not self.provider.cache.contains(height):
            return False
        with self._cv:
            if height in self._healing or height in self._quarantined:
                return False
            self._healing[height] = {
                "kind": kind,
                "t0": time.perf_counter(),
                "t0_ns": time.time_ns(),
            }
            self._queue.append(height)
            self._cv.notify()
        return True

    def healing(self, height: int) -> bool:
        with self._cv:
            return height in self._healing

    def is_quarantined(self, height: int) -> bool:
        with self._cv:
            return height in self._quarantined

    # --- processing ---------------------------------------------------------
    def start(self) -> "HealingEngine":
        with self._cv:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop_flag = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"healer-{self.name}"
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop_flag:
                    self._cv.wait()
                if not self._queue and self._stop_flag:
                    return
                height = self._queue.popleft()
            try:
                self._heal_one(height)
            except DeviceFault as e:
                # The card failed, not the data: no verdict was recorded,
                # and a later detection enqueues the height again.
                print(f"heal of height {height} on {self.name}: {e}", file=sys.stderr)
            except Exception:  # chaos-ok: a dead worker = permanent 503s
                # _heal_one guards its own bookkeeping; this is the
                # belt-and-braces floor — whatever slipped through must
                # not kill the drain loop, or every later detection
                # would mark its height mid-heal forever with nobody
                # left to heal it.
                pass

    def process_pending(self) -> list[tuple[int, str]]:
        """Drain the queue synchronously (drills / tests / a node with no
        worker thread); returns [(height, outcome)].  A DeviceFault of a
        heal raises out of it, the heights after it still queued."""
        out: list[tuple[int, str]] = []
        while True:
            with self._cv:
                if not self._queue:
                    return out
                height = self._queue.popleft()
            out.append((height, self._heal_one(height)))

    def close(self, timeout_s: float = 10.0) -> None:
        with self._cv:
            self._stop_flag = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout_s)
        unregister(self)
        if getattr(self.provider, "healer", None) is self:
            self.provider.healer = None

    # --- one heal -----------------------------------------------------------
    def _heal_one(self, height: int) -> str:
        from celestia_app_tpu_torch.da.repair import IrrecoverableSquare
        from celestia_app_tpu_torch.trace.flight_recorder import note_trigger
        from celestia_app_tpu_torch.trace.tracer import traced

        with self._cv:
            info = self._healing.get(height)
        if info is None:  # raced a concurrent resolution
            return "skipped"
        outcome = "quarantined"
        detail = None
        phases_ms: dict[str, float] = {}
        attempt = 0
        fault = None
        try:
            lat = heal_seconds()
            lat.observe(time.perf_counter() - info["t0"], phase="detect")
            for attempt in range(1, self.max_attempts + 1):
                try:
                    phases_ms = self._attempt(height, lat)
                    outcome = "healed"
                    break
                except IrrecoverableSquare as e:
                    # Below the k-survivor threshold: retrying cannot
                    # mint shares that do not exist.
                    outcome, detail = "irrecoverable", f"{e}"
                    break
                except DeviceFault as e:
                    # The card, not the data: no verdict (module docstring).
                    fault = e
                    raise
                except Exception as e:  # chaos-ok: bounded retry, then quarantine
                    detail = f"{type(e).__name__}: {e}"
                    if attempt < self.max_attempts:
                        self._sleep(
                            min(self.backoff_s * 2 ** (attempt - 1), 1.0)
                        )
        finally:
            # The height LEAVES the mid-heal state no matter what raised
            # above — a stranded _healing entry would answer 503 forever
            # with nobody left to heal it.
            total_s = time.perf_counter() - info["t0"]
            rec = {
                "height": height,
                "kind": info["kind"],
                "outcome": outcome,
                "attempts": attempt,
                "total_ms": round(total_s * 1e3, 3),
                "phases_ms": phases_ms,
                "detail": detail,
            }
            with self._cv:
                self._healing.pop(height, None)
                if fault is None:
                    self._last = rec
                    if outcome == "healed":
                        self._healed[height] = rec
                        self._healed_count += 1
                        while len(self._healed) > self.MAX_RECORDS:
                            self._healed.popitem(last=False)
                    else:
                        self._quarantined[height] = rec
                        while len(self._quarantined) > self.MAX_RECORDS:
                            self._quarantined.popitem(last=False)
        lat.observe(total_s, phase="total")
        heal_total().inc(outcome=outcome)
        from celestia_app_tpu_torch.trace.context import current_context

        ctx = current_context()
        traced().write(
            "heal", node=self.name, height=height, kind=info["kind"],
            outcome=outcome, attempts=attempt, total_ms=rec["total_ms"],
            # The per-phase split and (when the heal runs under a request
            # trace, e.g. a detection on the serve path) the trace_id:
            # the height timeline stitches this row's anatomy from them.
            phases_ms=phases_ms,
            trace_id=ctx.trace_id if ctx is not None else None,
        )
        note_trigger(
            "heal_completed" if outcome == "healed" else "heal_quarantined",
            node=self.name, height=height, kind=info["kind"],
            outcome=outcome, attempts=attempt, total_ms=rec["total_ms"],
            phases_ms=phases_ms, detail=detail,
        )
        return outcome

    def _attempt(self, height: int, lat) -> dict[str, float]:
        """gather -> repair -> verify -> readmit, each timed; raises on
        any failed leg (the retry/quarantine policy lives in the
        caller)."""
        from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader
        from celestia_app_tpu_torch.da.repair import RootMismatch, repair

        provider = self.provider
        t = time.perf_counter()
        honest = provider._honest_entry(height)
        view = provider.serve_view(height)
        shares, present = self._survivors(height, view, honest)
        gather_s = time.perf_counter() - t
        lat.observe(gather_s, phase="gather")

        committed = (
            self._committed(height)
            if self._committed is not None
            else DataAvailabilityHeader(
                row_roots=list(honest.row_roots),
                column_roots=list(honest.col_roots),
            )
        )
        t = time.perf_counter()
        # The sweep and re-extension ride guarded_dispatch inside repair:
        # a chaos dispatch_fail here walks the ladder, never wedges us;
        # past the ladder's floor the fault is the card's (DeviceFault).
        with _on_card("the repair"):
            recovered = repair(shares, present, height=height, device=provider.cache.device)
        repair_s = time.perf_counter() - t
        lat.observe(repair_s, phase="repair")

        t = time.perf_counter()
        got = DataAvailabilityHeader.from_eds(recovered)
        if not got.equals(committed) or (
            recovered.data_root() != committed.hash()
        ):
            # Root-verify BEFORE anything can see the bytes: a recovery
            # that cannot prove itself is a failed attempt, not a served
            # square.
            raise RootMismatch(
                f"healed square at height {height} does not reproduce "
                "the committed DAH"
            )
        verify_s = time.perf_counter() - t
        lat.observe(verify_s, phase="verify")

        t = time.perf_counter()
        with _on_card("the re-admission"):
            provider.cache.readmit(height, recovered, healed=True)
        readmit_s = time.perf_counter() - t
        lat.observe(readmit_s, phase="readmit")
        return {
            "gather": round(gather_s * 1e3, 3),
            "repair": round(repair_s * 1e3, 3),
            "verify": round(verify_s * 1e3, 3),
            "readmit": round(readmit_s * 1e3, 3),
        }

    # --- introspection ------------------------------------------------------
    def state(self) -> dict:
        """The /healthz "heal" block / GET /heal unit: bounded, JSON-safe
        (only the newest STATE_QUARANTINED quarantine records serialize —
        the /namespaces top-N discipline; `quarantined_total` keeps the
        full count honest)."""
        with self._cv:
            newest = sorted(self._quarantined)[-self.STATE_QUARANTINED:]
            return {
                "healing": sorted(self._healing),
                "quarantined": {
                    str(h): {
                        "outcome": self._quarantined[h]["outcome"],
                        "kind": self._quarantined[h]["kind"],
                        "attempts": self._quarantined[h]["attempts"],
                        "detail": self._quarantined[h]["detail"],
                    }
                    for h in newest
                },
                "quarantined_total": len(self._quarantined),
                "healed": self._healed_count,
                "last": dict(self._last) if self._last else None,
            }
