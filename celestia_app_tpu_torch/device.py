"""The device an entry point runs on, and how host bytes reach it.

Entry points run on the card unless the caller asks for the CPU, where every
kernel is replaced by its plain PyTorch version.  There is no quiet fallback:
asking for CUDA on a machine without it raises.

`upload` is the one host-to-device path of the block and repair inputs: the
one-shot calls and the streaming ring (parallel/pipeline.py) both stage
through pinned memory and copy with `non_blocking=True` on a stream the
caller names.  `hand_over` is its other end for results made on a side
stream and read on the caller's.

`on_device` marks the calls whose faults belong to the card rather than to
their input: whatever such a call raises comes out as `DeviceFault`, which
callers that judge input (ProcessProposal, app/app.py) let through instead
of reading it as a verdict on that input.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch

#: Bytes per host-to-device chunk: the memcpy of chunk i+1 into pinned
#: memory runs on the host while the copy engine moves chunk i.
CHUNK_BYTES = 32 << 20


class DeviceFault(RuntimeError):
    """A call on the device failed: a kernel that did not build or launch,
    a CUDA error, device memory exhausted.  The original error is the
    cause."""


@contextmanager
def on_device(what: str):
    """Re-raise anything the body raises as a DeviceFault naming `what`."""
    try:
        yield
    except DeviceFault:
        raise
    except Exception as e:
        raise DeviceFault(f"{what} failed on the device: {e!r}") from e


def resolve_device(device: str | torch.device | None) -> torch.device:
    """None means "cuda"; a CUDA request without a usable card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def upload(parts, device: torch.device, *, pinned: torch.Tensor | None = None,
           stream=None, consumer=None):
    """Host uint8 bytes -> a tensor on `device`, and the event to wait on.

    `parts` is one numpy array, or a list of same-shape arrays that land
    stacked along a new leading axis (the streaming ring's batch).  On CUDA
    the bytes are copied, in chunks of CHUNK_BYTES, into `pinned` (a
    caller-owned pinned buffer with room for them, such as a ring slot) or
    into a buffer of PyTorch's caching host allocator, which hands the same
    block back to the next upload of that size once this copy has finished;
    the host copy is a torch `copy_`, which runs on the intra-op threads
    without the interpreter lock (a numpy assignment runs on one thread,
    and staging through it loses to a pageable copy: chip_smoke.py's
    upload phase times the three).  Each chunk goes to the card with
    `copy_(non_blocking=True)` on `stream` (default: the current stream),
    and the returned event is recorded on `stream` after the last.  The
    result is allocated on `stream`; when `consumer` is another stream it
    is also recorded there (`record_stream`), so the caching allocator does
    not give its memory back to `stream` while `consumer` still reads it.
    The caller must make `consumer` wait on the event before reading.

    On the CPU, which the caller asked for, there is no pinning and no
    stream: the bytes are copied into `pinned` or a fresh tensor, and the
    event is None."""
    single = isinstance(parts, np.ndarray)
    arrays = [parts] if single else list(parts)
    shape = tuple(arrays[0].shape)
    if any(tuple(a.shape) != shape for a in arrays):
        raise ValueError(f"parts of unequal shapes {[tuple(a.shape) for a in arrays]}")
    n = len(arrays)
    if pinned is not None and (tuple(pinned.shape[1:]) != shape or pinned.shape[0] < n
                               or pinned.dtype != torch.uint8):
        raise ValueError(f"staging buffer {pinned.dtype} {tuple(pinned.shape)} cannot hold "
                         f"{n} x {shape} bytes")
    sources = [_host_tensor(a) for a in arrays]
    if device.type == "cpu":
        out = torch.empty((n, *shape), dtype=torch.uint8) if pinned is None else pinned[:n]
        for i, src in enumerate(sources):
            out[i].copy_(src)
        return (out[0] if single else out), None

    stream = torch.cuda.current_stream(device) if stream is None else stream
    staging = (torch.empty((n, *shape), dtype=torch.uint8, pin_memory=True)
               if pinned is None else pinned[:n])
    rows = max(1, CHUNK_BYTES // max(1, math.prod(shape[1:])))
    with torch.cuda.stream(stream):
        out = torch.empty((n, *shape), dtype=torch.uint8, device=device)
        for i, src in enumerate(sources):
            for lo in range(0, shape[0], rows):
                hi = lo + rows
                staging[i, lo:hi].copy_(src[lo:hi])
                out[i, lo:hi].copy_(staging[i, lo:hi], non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    if consumer is not None and consumer != stream:
        out.record_stream(consumer)
    return (out[0] if single else out), done


def _host_tensor(a) -> torch.Tensor:
    """A CPU tensor over the numpy array `a` (copied only when it is
    read-only or has negative strides, which torch tensors cannot view)."""
    a = np.asarray(a)
    if not a.flags.writeable or any(s < 0 for s in a.strides):
        a = np.array(a)
    return torch.from_numpy(a)


def hand_over(tensors, done) -> None:
    """Make the calling thread's current stream wait on `done`, recorded on
    the side stream that wrote `tensors`, and record the tensors on the
    current stream, so the caching allocator keeps their memory from the
    side stream until the current stream's reads are done.  A row-sharded
    output (parallel/mesh.RowSharded) is handed over block by block, on
    each block's device.  Nothing to do on the CPU (`done` is None)."""
    if done is None:
        return
    for t in tensors:
        for part in getattr(t, "blocks", (t,)):
            current = torch.cuda.current_stream(part.device)
            current.wait_event(done)
            part.record_stream(current)
