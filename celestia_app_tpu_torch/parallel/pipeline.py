"""Pipelined block streaming: the port of celestia_app_tpu/parallel/pipeline.py.

Consecutive squares stream through the card with three overlaps:

  * an uploader thread copies square h+1 into a pinned staging slot and
    sends it to the card on a copy stream while square h computes;
  * a dispatcher thread launches the kernels on a compute stream of its
    own, so upload and compute run on different streams and the copy
    engine works beside the kernels;
  * the caller's drain consumes square h-1 meanwhile.

Cross-height batching: with `batch` (or $CELESTIA_PIPE_BATCH) above 1 the
uploader coalesces queued same-k squares into one (B, k, k, S) slot and
the dispatcher runs them as one batch (da/eds._batched_pipeline_for_mode:
each launch widened B times, where the JAX package vmaps one program).

Persistent staging: a ring of depth+1 pinned host slots (`_BufferRing`) is
allocated once.  A slot frees only after its batch's drain has seen the
batch's done event, so the copy engine has read it; a slot whose square the
serve cache retained (serve/cache.ForestCache.put -> attach_forest -> pin)
is swapped for a fresh buffer on its next acquire, as in the JAX package.

Streams and memory: the upload's device tensor is allocated on the copy
stream and recorded on the compute stream; the compute stream waits on the
upload's event; the outputs, made on the compute stream, are handed to the
caller's current stream in `_materialize` (it waits on the done event and
records them there), so the caching allocator never gives their memory
back to the dispatcher while the caller still reads it.  Every pipeline
the stream can run is built, and the card synchronized once, before either
thread starts, so no generator upload is still in flight on the caller's
stream when a side stream reads it.

Giant squares: where $CELESTIA_PIPE_PANEL engages at k (kernels/panel.py),
the batch is forced to 1 and the uploader only copies the ODS into its
pinned slot; the dispatcher hands the slot to the panel runner, which
uploads one row panel at a time on the compute stream, so the card never
holds the whole ODS beside the pipeline's working set.  Under
$CELESTIA_EXTEND_SHARDS (kernels/panel_sharded.py) the sharded runner takes
the slot the same way, each shard uploading its own panels on its stream
after the compute stream's queued work, and the compute stream waits on
every shard before the batch's done event.

Every drained block writes one "stream" row to the block journal
(trace/journal.py) with the JAX field names (`panels` on panel rows,
`shards` on sharded ones).

Faults, as in the JAX package.  Every dispatch rides
chaos/degrade.guarded_dispatch: a fault is retried within its rung, a
streak of them steps the process-wide ladder, and `_resolve_pipe` swaps the
dispatcher's lowering when the ladder moves mid-stream (journal rows carry
the rung each square ran on).  A batched fault falls to one guarded
dispatch per square, each re-staged from the ring's host slot
(`celestia_recoveries_total{outcome="unbatched"}`).  The upload retries
`_UPLOAD_RETRIES` times behind the chaos seam device.upload.  CUDA reports
an execution fault at a later sync: here the drain's wait on the batch's
done event, where `note_async_device_failure` feeds it to the breaker
before it raises.  A stage that dies writes a `worker_death` flight bundle
after its death sentinel is delivered; `submit()` and `drain()` raise with
the cause chained.  Past the ladder's floor the fault raises out of
`drain()` (and `submit()`); no rung runs on the CPU.

Gauges (the JAX names): `celestia_pipeline_queue_depth{queue}`,
`celestia_pipeline_ring_occupancy{state}`,
`celestia_pipeline_batch_size{k}` (one observation per dispatch),
`celestia_pipeline_close_leaked_total{stage}`; the live rings' staging
bytes are the ledger owner `pipeline_buffer_ring`.

On `device="cpu"`, which the caller asks for, the slots are plain host
memory and there are no streams or events.
"""

from __future__ import annotations

import contextlib
import os
import queue
import sys
import threading
import time
import weakref
from dataclasses import dataclass, field

import torch

from celestia_app_tpu_torch import chaos
from celestia_app_tpu_torch.chaos.degrade import (
    guarded_dispatch,
    note_async_device_failure,
    recoveries,
)
from celestia_app_tpu_torch.constants import SHARE_SIZE
from celestia_app_tpu_torch.da.eds import (
    ExtendedDataSquare,
    _check_square,
    _panel_fields,
    _pipeline_and_state,
    _staged_input,
    batched_pipeline_for_mode,
)
from celestia_app_tpu_torch.device import _host_tensor, hand_over, resolve_device, upload
from celestia_app_tpu_torch.gf.rs import active_construction
from celestia_app_tpu_torch.kernels.fused import (
    env_base_mode_for_k,
    pipeline_mode,
    pipeline_mode_for_k,
)
from celestia_app_tpu_torch.kernels.panel import panel_rows
from celestia_app_tpu_torch.trace import journal
from celestia_app_tpu_torch.trace.device_ledger import register_owner

_SENTINEL = object()

#: Transient-upload retry budget (chaos upload_fail, a flaky copy): attempts
#: per batch after the first before the pipeline declares the feeder dead.
_UPLOAD_RETRIES = 2

#: Poll interval of the deadline-aware queue waits: every bounded put/get
#: wakes this often to check worker liveness, so a dead stage is reported
#: instead of wedging the caller.
_POLL_S = 0.1
#: close()'s inactivity window before a still-alive worker is declared
#: wedged: long enough for a first launch that builds the kernels.
_CLOSE_STALL_S = 60.0
#: The coalescing ceiling $CELESTIA_PIPE_BATCH=auto resolves to when the
#: square journal's occupancy signal says traffic is producing small,
#: under-filled squares (the regime where launch overhead dominates).
_AUTO_BATCH = 4
#: Occupancy below which `auto` batching engages: a square less than half
#: full at the current k means the proposer is cutting small squares.
_AUTO_OCCUPANCY = 0.5


def env_batch() -> int:
    """$CELESTIA_PIPE_BATCH: how many queued same-k squares one dispatch may
    coalesce.  ""/unset/"0"/"1"/"off" = 1; an integer N > 1 = up to N;
    "auto" = consult the square journal's occupancy signal
    (trace/square_journal.last_square): when the last built square ran
    under 50 % occupancy (an empty square very much included), traffic is
    producing many small squares and the dispatcher batches up to 4,
    otherwise (or with no square built yet) it stays unbatched."""
    val = os.environ.get("CELESTIA_PIPE_BATCH", "").strip().lower()
    if val in ("", "0", "1", "off"):
        return 1
    if val == "auto":
        from celestia_app_tpu_torch.trace.square_journal import last_square

        last = last_square()
        if last is None:
            return 1  # no traffic signal yet: stay unbatched
        occupancy = last.get("occupancy")
        if occupancy is not None and occupancy < _AUTO_OCCUPANCY:
            return _AUTO_BATCH
        return 1
    try:
        return max(1, int(val))
    except ValueError:
        return 1


def env_batch_cap() -> int:
    """The ceiling $CELESTIA_PIPE_BATCH may ever resolve to: "auto" may
    later batch up to _AUTO_BATCH, anything else is env_batch()."""
    val = os.environ.get("CELESTIA_PIPE_BATCH", "").strip().lower()
    return _AUTO_BATCH if val == "auto" else env_batch()


def _queue_depth_gauge():
    from celestia_app_tpu_torch.trace.metrics import registry

    return registry().gauge(
        "celestia_pipeline_queue_depth",
        "blocks resident per block-pipeline hand-off queue",
    )


def _close_leak_counter():
    from celestia_app_tpu_torch.trace.metrics import registry

    return registry().counter(
        "celestia_pipeline_close_leaked_total",
        "pipeline worker threads still alive after close()'s join timeout",
    )


def _ring_occupancy_gauge():
    from celestia_app_tpu_torch.trace.metrics import registry

    return registry().gauge(
        "celestia_pipeline_ring_occupancy",
        "buffer-ring slots by state (free / in_use / pinned-for-swap)",
    )


def _batch_size_histogram():
    from celestia_app_tpu_torch.trace.metrics import registry

    return registry().histogram(
        "celestia_pipeline_batch_size",
        "same-k squares coalesced into one pipeline dispatch",
        buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0),
    )


def _rings_owned_bytes() -> int:
    """Staging bytes held by every live buffer ring's CURRENT slots.  A
    pinned slot swapped for a fresh buffer stops counting here: its old
    bytes live exactly as long as the retained square."""
    return sum(int(h.numel()) for ring in list(_ALL_RINGS) for h in ring._hosts)


_ALL_RINGS: "weakref.WeakSet[_BufferRing]" = weakref.WeakSet()

register_owner("pipeline_buffer_ring", _rings_owned_bytes)


class _BufferRing:
    """Persistent staging buffers recycled across blocks.

    `slots` host tensors of shape (batch, k, k, SHARE_SIZE), pinned when
    `pinned` (the card's path: the copy engine reads them directly),
    allocated once.  Recycling contract, as in the JAX package:

      * a slot frees only when its batch's drain has seen the batch done
        (`release` after the last square of the batch materialized), so a
        copy still reading it is never overwritten;
      * a slot whose square was retained downstream (`pin`) is swapped for
        a fresh buffer on its next acquire; the old buffer lives as long as
        anything still references it.  No output of the port aliases a
        staging slot (the pipelines copy their input), so the pin guards a
        future zero-copy path; `pin` takes the generation the square was
        staged under and counts a pin that arrives after the slot was
        acquired again on `late_pins`.
    """

    def __init__(self, k: int, slots: int, batch: int, *, pinned: bool = False):
        self.k = k
        self.batch = batch
        self._pinned_memory = pinned
        self._cond = threading.Condition()
        self._hosts = [self._fresh() for _ in range(slots)]
        self._free: list[int] = list(range(slots))
        self._pinned: set[int] = set()
        self._gen = [0] * slots  # bumped per acquire: late-pin detection
        self.swaps = 0  # pinned slots replaced with a fresh buffer
        self.late_pins = 0  # pins that arrived after the slot was reused
        _ALL_RINGS.add(self)

    def _fresh(self) -> torch.Tensor:
        return torch.empty((self.batch, self.k, self.k, SHARE_SIZE), dtype=torch.uint8,
                           pin_memory=self._pinned_memory)

    def acquire(self, timeout_s: float) -> int | None:
        """A free slot id, or None on timeout so the caller can re-check
        liveness; a pinned slot gets a fresh buffer here."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while not self._free:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)
            sid = self._free.pop()
            if sid in self._pinned:
                self._hosts[sid] = self._fresh()
                self._pinned.discard(sid)
                self.swaps += 1
            self._gen[sid] += 1
            return sid

    def generation(self, sid: int) -> int:
        with self._cond:
            return self._gen[sid]

    def host(self, sid: int) -> torch.Tensor:
        return self._hosts[sid]

    def release(self, sid: int) -> None:
        with self._cond:
            self._free.append(sid)
            self._cond.notify()

    def pin(self, sid: int, gen: int | None = None) -> None:
        """Mark a slot's current buffer as retained downstream: swapped, not
        overwritten, on its next acquire.  A pin under an older generation
        than the slot's is counted on `late_pins` and still pins forward."""
        with self._cond:
            if gen is not None and self._gen[sid] != gen:
                self.late_pins += 1
            self._pinned.add(sid)

    def states(self) -> dict[str, int]:
        with self._cond:
            free = len(self._free)
            pinned = len(self._pinned)
        return {"free": free, "in_use": len(self._hosts) - free, "pinned": pinned}


@dataclass
class _InFlight:
    tag: object
    outputs: tuple  # (eds, row_roots, col_roots, droot) on the device
    k: int
    meta: dict = field(default_factory=dict)  # stage timings for the journal
    mode: str | None = None  # the lowering this square ran
    slot: tuple | None = None  # (ring, sid, refcount-list, generation)
    done: torch.cuda.Event | None = None  # recorded after the batch's launches

    def release_slot(self) -> None:
        if self.slot is None:
            return
        ring, sid, ref, _gen = self.slot
        ref[0] -= 1
        if ref[0] == 0:
            ring.release(sid)
        self.slot = None


class BlockPipeline:
    """Bounded-depth square pipeline: an uploader thread on a copy stream and
    a dispatcher thread on a compute stream, optionally coalescing queued
    same-k squares into one batch (`batch` / $CELESTIA_PIPE_BATCH), on
    `device` (default CUDA; raises without a card)."""

    def __init__(self, k: int, depth: int = 2, batch: int | None = None, device=None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        _check_square(k)
        self.device = resolve_device(device)
        self.k = k
        self.depth = depth
        self.batch = max(1, batch if batch is not None else env_batch())
        # Panel streaming, sharded or not: giant squares never coalesce (a
        # batch would hold B whole squares), and the slot goes to the runner
        # panel by panel.
        self._panel = panel_rows(k)
        if self._panel:
            self.batch = 1
        # Bound to the construction and RS core active at creation: every
        # block it streams uses them.  The lowering starts as the one
        # active at creation and follows the degradation ladder from there
        # (_resolve_pipe).
        self.construction = active_construction()
        self._mode = pipeline_mode_for_k(k, self.device)
        self._pipe_mode = self._mode
        self._pipe, self._compile_state = _pipeline_and_state(k, self.construction, self._mode,
                                                              self.device)
        for n in range(2, self.batch + 1):
            batched_pipeline_for_mode(pipeline_mode(), k, n, self.construction, self.device)
        cuda = self.device.type == "cuda"
        if cuda:
            self._copy_stream = torch.cuda.Stream(self.device)
            self._compute_stream = torch.cuda.Stream(self.device)
            torch.cuda.synchronize(self.device)  # the generators are on the card
        else:
            self._copy_stream = self._compute_stream = None
        self._ring = _BufferRing(k, slots=depth + 1, batch=self.batch, pinned=cuda)
        # submit -> _tasks -> [uploader: stage + copy] -> _staged
        #        -> [dispatcher: launches] -> _done -> drain
        # _staged is a single-slot hand-off: one uploaded, not yet launched
        # batch is all the overlap needs, and the device holds at most
        # `depth` batches of outputs plus one upload.
        self._tasks: queue.Queue = queue.Queue(maxsize=max(depth, self.batch))
        self._staged: queue.Queue = queue.Queue(maxsize=1)
        self._done: queue.Queue = queue.Queue(maxsize=depth * self.batch)
        self._error: BaseException | None = None
        self._stopping = False
        self._closed = False
        self._finished = False  # a _done sentinel has been consumed
        self._uploader = threading.Thread(target=self._upload, daemon=True,
                                          name="block-pipeline-uploader")
        self._dispatcher = threading.Thread(target=self._dispatch, daemon=True,
                                            name="block-pipeline-dispatcher")
        self._uploader.start()
        self._dispatcher.start()

    # --- uploader ------------------------------------------------------------

    def _upload(self) -> None:
        """Uploader thread body.  The loop stores per-block faults and
        forwards the sentinel; this wrap catches what escapes the loop, so
        submit()/drain() raise the stored error instead of hanging."""
        try:
            self._upload_loop()
        except BaseException as e:  # chaos-ok: worker death must be loud
            if self._error is None:
                self._error = e
            self._force_sentinel(self._staged)
            self._note_death("uploader", e)

    def _coalesce(self, first) -> tuple[list, bool]:
        """`first` plus up to batch-1 more queued tasks, without waiting:
        the batch closes the moment the intake runs dry.  Returns (items,
        sentinel_seen)."""
        items = [first]
        sentinel_seen = False
        while len(items) < self.batch:
            try:
                nxt = self._tasks.get_nowait()
            except queue.Empty:
                break
            if nxt is _SENTINEL:
                sentinel_seen = True
                break
            items.append(nxt)
        return items, sentinel_seen

    def _upload_loop(self) -> None:
        failed = False
        while True:
            item = self._tasks.get()
            if item is _SENTINEL:
                self._staged.put(_SENTINEL)
                return
            if failed or self._stopping:
                continue  # keep consuming so no producer blocks forever
            items, sentinel_seen = self._coalesce(item)
            try:
                t0 = time.perf_counter()
                # A free slot, waited for in bounded steps so a stopping or
                # dying pipeline never parks this thread on a ring nobody
                # drains.  close() in progress discards the batch; a dead
                # dispatcher is a failure to report.
                while True:
                    sid = self._ring.acquire(_POLL_S)
                    if sid is not None or self._stopping:
                        break
                    if not self._dispatcher.is_alive():
                        raise RuntimeError("dispatcher died; no staging slot will free")
                if sid is None:
                    if sentinel_seen:
                        self._staged.put(_SENTINEL)
                        return
                    continue
                for attempt in range(_UPLOAD_RETRIES + 1):
                    try:
                        chaos.device_upload()  # injected stall or failure
                        if self._panel:
                            # Staged into the pinned slot only: the runner
                            # uploads it one panel at a time on the compute
                            # stream.
                            x, uploaded = self._ring.host(sid), None
                            x[0].copy_(_host_tensor(items[0][0]))
                        else:
                            x, uploaded = upload([ods for ods, _tag, _t in items], self.device,
                                                 pinned=self._ring.host(sid),
                                                 stream=self._copy_stream,
                                                 consumer=self._compute_stream)
                        break
                    except Exception:  # chaos-ok: bounded upload retry
                        if attempt == _UPLOAD_RETRIES:
                            raise
                        time.sleep(0.002 * (2 ** attempt))
                if attempt:
                    recoveries().inc(seam="device.upload", outcome="retried")
                t1 = time.perf_counter()
            except Exception as e:  # chaos-ok: stored, surfaced on the next drain
                self._error = e
                self._staged.put(_SENTINEL)
                self._note_death("uploader", e)
                failed = True
                continue
            meta = {
                "upload_ms": (t1 - t0) * 1e3,
                # How long the batch's oldest block sat in the intake.
                "intake_wait_ms": max(0.0, (t0 - min(t for _o, _g, t in items)) * 1e3),
            }
            self._staged.put((x, uploaded, [tag for _o, tag, _t in items], meta, sid))
            # Written after the hand-off returns; the row reads it a drain later.
            meta["upload_stall_ms"] = (time.perf_counter() - t1) * 1e3
            if sentinel_seen:
                self._staged.put(_SENTINEL)
                return

    # --- dispatcher ----------------------------------------------------------

    def _dispatch(self) -> None:
        try:
            self._dispatch_loop()
        except BaseException as e:  # chaos-ok: worker death must be loud
            if self._error is None:
                self._error = e
            self._force_sentinel(self._done)
            self._note_death("dispatcher", e)

    def _note_death(self, stage: str, err: BaseException) -> None:
        """Black-box a pipeline-fatal stage failure: the journal rows around
        the death are the forensic record.  Always called after the death
        sentinel is delivered, so a consumer blocked on the queue does not
        wait behind forensics.  note_trigger rate-limits and never raises."""
        from celestia_app_tpu_torch.trace.flight_recorder import note_trigger

        note_trigger("worker_death", stage=stage, k=self.k, depth=self.depth,
                     mode=self._mode, error=f"{type(err).__name__}: {err}"[:300])

    @staticmethod
    def _force_sentinel(q: queue.Queue) -> None:
        """Deliver a death sentinel even into a full queue, evicting one
        item per lap: results past a failure are void, and a lost sentinel
        would wedge the consumer."""
        while True:
            try:
                q.put(_SENTINEL, timeout=0.5)
                return
            except queue.Full:
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass

    def _release_staged(self, sid: int, uploaded) -> None:
        """Free the slot of a batch that will not run, once its copy has
        read it (a panel runner's copies run on the compute stream)."""
        if uploaded is not None:
            uploaded.synchronize()
        elif self._panel and self._compute_stream is not None:
            self._compute_stream.synchronize()
        self._ring.release(sid)

    def _resolve_pipe(self, mode: str):
        """The pipeline of `mode` fed its input as that lowering takes it,
        swapping lowerings when the degradation ladder moved mid-stream
        (journal rows from then on carry the mode blocks actually ran).  A
        pipeline built here uploads its tables on the compute stream, which
        is synchronized once so no other stream reads them early."""
        if mode != self._pipe_mode:
            self._pipe = _pipeline_and_state(self.k, self.construction, mode, self.device)[0]
            self._pipe_mode = self._mode = mode
            if self._compute_stream is not None:
                self._compute_stream.synchronize()
        pipe, dev = self._pipe, self.device
        return lambda x: pipe(_staged_input(x, mode, dev))

    def _dispatch_batched(self, x, sid: int, n: int) -> list[tuple[str, tuple]]:
        """One batched dispatch for n coalesced squares; any batched fault
        falls to n unbatched dispatches through the normal guarded ladder,
        each square re-staged from the ring's host slot, so a fault in the
        batching costs latency, never a block.  Returns [(mode, (eds, rr,
        cr, droot)), ...] per square, in order, each square's EDS in
        storage of its own (a retained square keeps only itself alive)."""
        mode = pipeline_mode()
        try:
            chaos.device_dispatch(mode)
            out = batched_pipeline_for_mode(mode, self.k, n, self.construction, self.device)(x)
            # The batched lowering of fused_epi is the fused body.
            ran = "fused" if mode == "fused_epi" else mode
            return [(ran, (out[0][b].clone(), out[1][b], out[2][b], out[3][b]))
                    for b in range(n)]
        except Exception:  # chaos-ok: batched fault -> unbatched rung
            recoveries().inc(seam="device.dispatch", outcome="unbatched")
            host = self._ring.host(sid)
            return [guarded_dispatch(self._resolve_pipe,
                                     host[b].to(self.device, non_blocking=True),
                                     k=self.k, device=self.device)
                    for b in range(n)]

    def _dispatch_loop(self) -> None:
        # The current stream is per thread: this thread's launches (every
        # kernel enqueues on the current stream) go to the compute stream.
        stream_ctx = (torch.cuda.stream(self._compute_stream)
                      if self._compute_stream is not None else contextlib.nullcontext())
        failed = False
        with stream_ctx:
            while True:
                t0 = time.perf_counter()
                item = self._staged.get()
                starve_ms = (time.perf_counter() - t0) * 1e3
                if item is _SENTINEL:
                    self._done.put(_SENTINEL)
                    return
                x, uploaded, tags, meta, sid = item
                del item  # the batch's memory goes with x and out below
                if failed or self._stopping:
                    self._release_staged(sid, uploaded)
                    continue
                n = len(tags)
                try:
                    t1 = time.perf_counter()
                    done = None
                    if uploaded is not None:
                        self._compute_stream.wait_event(uploaded)
                    if n == 1:
                        per_square = [guarded_dispatch(self._resolve_pipe, x[0], k=self.k,
                                                       device=self.device)]
                    else:
                        per_square = self._dispatch_batched(x, sid, n)
                    if self._compute_stream is not None:
                        done = torch.cuda.Event()
                        done.record(self._compute_stream)
                    del x  # before a put that may block on a full _done
                    meta["dispatch_ms"] = (time.perf_counter() - t1) * 1e3
                    meta["dispatch_starve_ms"] = starve_ms
                    meta["batch_size"] = n
                    # One owner for the panel and sharded extras
                    # (da/eds._panel_fields), so this row cannot disagree
                    # with compute's for the same dispatch.
                    meta.update(_panel_fields(per_square[0][0], self.k, self.device))
                    _batch_size_histogram().observe(float(n), k=str(self.k))
                except Exception as e:  # chaos-ok: stored, surfaced on the next drain
                    self._error = e
                    self._release_staged(sid, uploaded)
                    self._done.put(_SENTINEL)
                    self._note_death("dispatcher", e)
                    failed = True
                    continue
                ref = [n]  # the slot recycles when the whole batch drained
                gen = self._ring.generation(sid)
                for tag, (mode, outs) in zip(tags, per_square):
                    self._done.put(_InFlight(tag, outs, self.k, meta, mode=mode,
                                             slot=(self._ring, sid, ref, gen), done=done))

    # --- caller side ---------------------------------------------------------

    @staticmethod
    def _await(inflight: _InFlight) -> None:
        """The pipeline's one host sync: wait for the batch's launches (on
        the CPU, which computed synchronously, nothing to wait for)."""
        if inflight.done is not None:
            inflight.done.synchronize()

    def _materialize(self, inflight: _InFlight) -> tuple[object, ExtendedDataSquare]:
        t0 = time.perf_counter()
        try:
            self._await(inflight)
        except Exception:  # chaos-ok: deferred fault -> breaker, then surface
            # Launches are asynchronous, so a real execution fault surfaces
            # at THIS sync, past guarded_dispatch's reach: this block is
            # lost (the caller sees the error), but the breaker still
            # learns, so a persistent fault steps the ladder for the
            # blocks after it.
            inflight.release_slot()
            note_async_device_failure(inflight.mode or self._mode,
                                      base=env_base_mode_for_k(self.k, self.device))
            raise
        if inflight.done is not None:
            hand_over(inflight.outputs, inflight.done)
        meta = inflight.meta
        journal.record(
            "stream", inflight.k, mode=inflight.mode, compile=self._compile_state,
            tag=str(inflight.tag), depth=self.depth, batch_size=meta.get("batch_size", 1),
            **{key: meta[key] for key in ("panels", "shards") if key in meta},
            intake_wait_ms=meta.get("intake_wait_ms", 0.0),
            upload_ms=meta.get("upload_ms", 0.0),
            upload_stall_ms=meta.get("upload_stall_ms", 0.0),
            dispatch_ms=meta.get("dispatch_ms", 0.0),
            dispatch_starve_ms=meta.get("dispatch_starve_ms", 0.0),
            drain_ms=(time.perf_counter() - t0) * 1e3,
        )
        self._compile_state = "hit"  # paid (or confirmed) on the first row
        result = ExtendedDataSquare(*inflight.outputs, inflight.k)
        if inflight.slot is not None:
            # Retention by the serve cache pins the feeding slot, under the
            # generation the square was staged in.
            ring, sid, _ref, gen = inflight.slot
            result._retain_cb = lambda: ring.pin(sid, gen)
        inflight.release_slot()
        gauge = _queue_depth_gauge()
        for name, q in (("tasks", self._tasks), ("staged", self._staged), ("done", self._done)):
            gauge.set(q.qsize(), queue=name)
        ring_gauge = _ring_occupancy_gauge()
        for state, count in self._ring.states().items():
            ring_gauge.set(count, state=state)
        return inflight.tag, result

    def _raise_worker_death(self, stage: str) -> None:
        msg = f"pipeline {stage} thread died"
        if self._error is not None:
            raise RuntimeError(msg) from self._error
        raise RuntimeError(msg)

    def submit(self, ods, tag: object = None, timeout_s: float | None = None) -> None:
        """Enqueue one (k, k, 512) uint8 ODS; blocks only when the intake is
        full (back-pressure).  A dead uploader raises its stored error here;
        with `timeout_s`, back-pressure past the deadline raises
        TimeoutError."""
        if self._closed:
            raise RuntimeError("pipeline already closed")
        if self._error is not None:
            raise RuntimeError("pipeline feeder failed") from self._error
        if tuple(ods.shape) != (self.k, self.k, SHARE_SIZE):
            raise ValueError(f"ODS must be ({self.k}, {self.k}, {SHARE_SIZE}), "
                             f"got {tuple(ods.shape)}")
        deadline = time.monotonic() + timeout_s if timeout_s is not None else None
        while True:
            try:
                self._tasks.put((ods, tag, time.perf_counter()), timeout=_POLL_S)
                return
            except queue.Full:
                if self._error is not None:
                    raise RuntimeError("pipeline feeder failed") from self._error
                if not self._uploader.is_alive():
                    self._raise_worker_death("uploader")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"pipeline back-pressure: no intake slot within "
                                       f"{timeout_s}s (depth={self.depth})") from None

    def _get_done(self):
        """One _done item, with the wedge check: a dispatcher that died
        without forwarding a sentinel leaves the queue silent forever."""
        while True:
            try:
                return self._done.get(timeout=_POLL_S)
            except queue.Empty:
                if not self._dispatcher.is_alive() and self._done.empty():
                    self._raise_worker_death("dispatcher")

    def _drain_one(self) -> tuple[object, ExtendedDataSquare]:
        inflight = self._get_done()
        if inflight is _SENTINEL:
            self._finished = True
            if self._error is not None:
                raise RuntimeError("pipeline feeder failed") from self._error
            raise RuntimeError("pipeline is closed")
        return self._materialize(inflight)

    def drain(self):
        """Close the intake and yield (tag, ExtendedDataSquare) for every
        remaining block, in order.  Blocks computed before a failure still
        come out; the stored error raises at the failure point."""
        self._closed = True
        # With either worker dead the intake may never free, so the
        # sentinel is offered in bounded steps (the death wrappers already
        # forced the downstream sentinel that _get_done will surface).
        while True:
            try:
                self._tasks.put(_SENTINEL, timeout=_POLL_S)
                break
            except queue.Full:
                if not self._uploader.is_alive() or not self._dispatcher.is_alive():
                    break
        while True:
            inflight = self._get_done()
            if inflight is _SENTINEL:
                self._finished = True
                if self._error is not None:
                    raise RuntimeError("pipeline feeder failed") from self._error
                return
            yield self._materialize(inflight)

    def close(self) -> None:
        """Abandon the pipeline: stop both stages and drop pending results.

        Keyed on _finished, not _closed: a drain() abandoned mid-stream
        leaves results queued, and returning early would strand the
        dispatcher on a full _done.  The wait is bounded by inactivity
        (re-armed on every drained item); a stage still alive after its
        join is reported on stderr."""
        if self._finished:
            return
        self._stopping = True  # stages discard anything still queued
        sentinel_needed = not self._closed
        self._closed = True
        deadline = time.monotonic() + _CLOSE_STALL_S
        while time.monotonic() < deadline:
            if sentinel_needed:
                try:
                    self._tasks.put_nowait(_SENTINEL)
                    sentinel_needed = False
                except queue.Full:
                    pass  # a drain below frees the chain; retry next lap
            try:
                item = self._done.get(timeout=_POLL_S)
            except queue.Empty:
                if not sentinel_needed and not self._dispatcher.is_alive():
                    break
                continue
            if item is _SENTINEL:
                break
            if item.done is not None:
                item.done.synchronize()  # its slot may still feed a copy
            item.release_slot()  # keep the ring whole for the workers
            deadline = time.monotonic() + _CLOSE_STALL_S
        self._finished = True
        self._uploader.join(timeout=5)
        self._dispatcher.join(timeout=5)
        for stage, thread in (("uploader", self._uploader), ("dispatcher", self._dispatcher)):
            if thread.is_alive():
                print(f"BlockPipeline.close: {stage} thread leaked past join timeout "
                      f"(k={self.k})", file=sys.stderr)
                _close_leak_counter().inc(stage=stage)


def stream_blocks(ods_iter, k: int, depth: int = 2, batch: int | None = None, device=None):
    """Stream (tag, ods) pairs through the card with `depth`-deep overlap.

    Yields (tag, ExtendedDataSquare) in submission order, each
    byte-identical to ExtendedDataSquare.compute of the same ODS.  `batch`
    (default $CELESTIA_PIPE_BATCH) lets the dispatcher coalesce queued
    squares; `device` defaults to CUDA and raises without a card.
    Abandoning the generator early stops the stages and joins them."""
    pipe = BlockPipeline(k, depth, batch=batch, device=device)
    finished = False
    try:
        submitted = drained = 0
        window = max(depth, pipe.batch)
        for tag, ods in ods_iter:
            # Keep the intake primed without over-filling the card: drain
            # once more than a window is outstanding (the window widens
            # with the batch so coalescing has squares to merge).
            while submitted - drained > window:
                yield pipe._drain_one()
                drained += 1
            pipe.submit(ods, tag)
            submitted += 1
        yield from pipe.drain()
        finished = True
    finally:
        if not finished:
            pipe.close()
