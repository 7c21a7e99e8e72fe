"""The device mesh of the multi-device plane, its copy collectives, and the
row-sharded array that the sharded extend, repair and serving share.

The port of celestia_app_tpu/parallel/mesh.py.  The JAX plane is one
process driving a `Mesh` of local devices through `shard_map`; so is this
one, without a process group:

  * a `Mesh` is a named axis over a tuple of devices, each shard with a
    CUDA stream of its own.  `device_mesh(n)` takes the first n distinct
    cards; a mesh built from a tuple that repeats one card runs n logical
    shards on it (the counterpart of the JAX tests' forced host devices,
    which torch lacks), each with its own buffers and stream;
  * the collectives (`all_to_all`, `gather`, `all_gather`, `xor_allreduce`)
    are explicit copies: the destination shard's stream waits on an event
    recorded on the source's, then copies into a tensor allocated on the
    destination (`copy_(non_blocking=True)`; across cards torch issues the
    peer copy).  An output never aliases an input, even on one card, where
    `.to()` would hand back the same buffer.  NCCL has no XOR reduction,
    and refuses two ranks on one card: there is none here;
  * `RowSharded` is the counterpart of a jax.Array under `row_sharding3` /
    `row_sharding`: equal contiguous row blocks, each on its owning shard.
    Reads of rows and flat gathers go to the owning block; nothing on the
    compute path concatenates the blocks onto one device.

On the CPU, which only a caller asks for, every shard is the CPU and the
collectives are plain copies; `CPU_SHARDS` stands in for the card count, so
the environment clamps agree with the JAX tests' 8 forced host devices.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache

import numpy as np
import torch

from celestia_app_tpu_torch.device import resolve_device

SERVE_AXIS = "serve"
#: The extend plane's axis (kernels/panel_sharded.py), a name of its own so
#: a serve mesh and an extend mesh can differ in one process.
EXTEND_AXIS = "extend"
#: Shards a CPU mesh offers: the JAX tests' forced host device count.
CPU_SHARDS = 8


class Mesh:
    """A 1-D mesh: `axis` over `devices`, one stream per shard on CUDA.

    Shard i runs its work under `on(i)` (its device and stream).  A caller
    brackets a program with `enter()` (every shard stream waits on the
    caller's current stream) and `leave(outputs)` (the caller's current
    streams wait on every shard, and the outputs are recorded on them)."""

    def __init__(self, devices, axis: str = SERVE_AXIS):
        # "cuda" without an index is the current card, named by its index so
        # that shards on one card compare equal.
        self.devices = tuple(
            torch.device("cuda", torch.cuda.current_device())
            if torch.device(d).type == "cuda" and torch.device(d).index is None
            else torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis
        self.streams = tuple(torch.cuda.Stream(d) if d.type == "cuda" else None
                             for d in self.devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: self.size}

    def __repr__(self) -> str:
        return f"Mesh({self.axis!r}, {[str(d) for d in self.devices]})"

    def on(self, i: int):
        """The context of shard i: its device and its stream (nothing on the
        CPU)."""
        stream = self.streams[i]
        if stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(stream)

    def _caller_streams(self):
        return {d: torch.cuda.current_stream(d) for d in set(self.devices) if d.type == "cuda"}

    def enter(self) -> None:
        """Order every shard's stream after the work the caller has queued."""
        callers = self._caller_streams()
        for d, s in zip(self.devices, self.streams):
            if s is not None:
                s.wait_stream(callers[d])

    def leave(self, outputs=()) -> None:
        """Order the caller's current stream of every mesh device after all
        the shards' queued work, and record `outputs` (tensors or
        RowSharded) on those streams, so the caching allocator keeps their
        memory from the shard streams until the caller's reads are done."""
        callers = self._caller_streams()
        for caller in callers.values():
            for s in self.streams:
                caller.wait_stream(s)
        for t in outputs:
            for part in getattr(t, "blocks", (t,)):
                if part.device.type == "cuda":
                    part.record_stream(callers[part.device])

    def synchronize(self) -> None:
        for s in self.streams:
            if s is not None:
                s.synchronize()

    def launches(self) -> list[dict[str, int]]:
        """Per shard, the kernel launches its stream took since the last
        kernels/_build.reset_launches()."""
        from celestia_app_tpu_torch.kernels import _build

        out = []
        for s in self.streams:
            handle = s.cuda_stream if s is not None else None
            out.append({name: _build.STREAM_LAUNCHES.get((name, handle), 0)
                        for name in _build.LAUNCHES})
        return out


def device_count(device) -> int:
    """Shards a mesh over `device`'s type can have: the card count on CUDA,
    CPU_SHARDS on the CPU."""
    return torch.cuda.device_count() if resolve_device(device).type == "cuda" else CPU_SHARDS


@lru_cache(maxsize=None)
def _device_mesh(n: int, axis: str, kind: str) -> Mesh:
    have = torch.cuda.device_count() if kind == "cuda" else CPU_SHARDS
    if n < 1 or n > have:
        raise ValueError(f"mesh wants {n} devices, {have} available")
    if kind == "cuda":
        return Mesh([torch.device("cuda", i) for i in range(n)], axis)
    return Mesh([torch.device("cpu")] * n, axis)


def device_mesh(n: int, axis: str = SERVE_AXIS, device=None) -> Mesh:
    """1-D mesh over the first n distinct cards (default CUDA; raises
    without a card), ValueError when there are fewer; over n CPU shards
    when the caller asks for the CPU.  Cached: one Mesh per (n, axis,
    device type), since meshes key the pipeline caches."""
    return _device_mesh(n, axis, resolve_device(device).type)


def padded_rows(rows: int, shards: int) -> int:
    """Smallest multiple of `shards` >= rows (row-wise partition needs
    equal blocks; the pad rows are gathered only as ignored fill)."""
    return ((rows + shards - 1) // shards) * shards


def shard_of_row(flat_row: int, rows_per_shard: int) -> int:
    """Owning shard of one flat row (contiguous equal blocks)."""
    return flat_row // rows_per_shard


def bucket_pow2(n: int) -> int:
    """Next power of two >= n (>= 1): per-shard gather slots are bucketed
    as in the JAX package, whose jit cache this bounds."""
    return 1 << max(0, (max(1, n) - 1).bit_length())


def route_to_shards(flat_indices, shards: int, rows_per_shard: int):
    """Host-side routing of one batch of flat gather rows (numpy, no
    per-index Python).

    Returns (local_idx (shards, bucket) int32, (shard, slot) index arrays
    locating each original row in the gathered output, counts per shard).
    Pad slots point at local row 0: valid rows gathered as ignored fill."""
    idx = np.asarray(flat_indices, dtype=np.int64)
    shard = idx // rows_per_shard
    counts = np.bincount(shard, minlength=shards) if idx.size else (
        np.zeros(shards, dtype=np.int64)
    )
    bucket = bucket_pow2(int(counts.max()) if idx.size else 1)
    # Slot of each row within its shard, in encounter order: positions in
    # the stable shard-sorted order, minus each shard's block start.
    order = np.argsort(shard, kind="stable")
    starts = np.cumsum(counts) - counts
    slot = np.empty(idx.size, dtype=np.int64)
    slot[order] = np.arange(idx.size) - np.repeat(starts, counts)
    local = np.zeros((shards, bucket), dtype=np.int32)
    local[shard, slot] = idx - shard * rows_per_shard
    return local, (shard, slot), counts


# --- the copy collectives ----------------------------------------------------


def send(mesh: Mesh, src_tensor: torch.Tensor, src: int, dst: int,
         out: torch.Tensor) -> torch.Tensor:
    """Copy `src_tensor`, produced on shard `src`'s stream, into `out`, a
    tensor (or view) on shard `dst`'s device, on `dst`'s stream after the
    work queued on `src`'s.  Returns `out`.  Across cards the copy runs on
    the source stream, which torch fences against the destination's."""
    s_src, s_dst = mesh.streams[src], mesh.streams[dst]
    if s_src is None:
        out.copy_(src_tensor)
        return out
    s_dst.wait_stream(s_src)
    if mesh.devices[src] == mesh.devices[dst]:
        with torch.cuda.stream(s_dst):
            out.copy_(src_tensor, non_blocking=True)
        # Read on the destination's stream: keep its memory from the source
        # stream's next allocations until the copy has run.
        src_tensor.record_stream(s_dst)
    else:
        with torch.cuda.stream(s_src), torch.cuda.stream(s_dst):
            out.copy_(src_tensor, non_blocking=True)
    return out


def _empty_on(mesh: Mesh, i: int, shape, like: torch.Tensor) -> torch.Tensor:
    with mesh.on(i):
        return torch.empty(shape, dtype=like.dtype, device=mesh.devices[i])


def all_to_all(mesh: Mesh, blocks, split_dim: int, concat_dim: int, out=None) -> list:
    """The tiled all_to_all of `lax.all_to_all(x, axis, split_dim,
    concat_dim, tiled=True)`: block i is cut into n equal chunks along
    `split_dim`, and shard j receives chunk j of every block, concatenated
    along `concat_dim` in shard order.  `out` (per shard, optional) are the
    tensors to write into."""
    n = mesh.size
    if len(blocks) != n:
        raise ValueError(f"{len(blocks)} blocks for a mesh of {n}")
    width = blocks[0].shape[split_dim]
    if width % n:
        raise ValueError(f"split dimension {width} does not divide over {n} shards")
    chunk = width // n
    results = []
    for j in range(n):
        shape = list(blocks[0].shape)
        shape[split_dim] = chunk
        part = shape[concat_dim]
        shape[concat_dim] = part * n
        dst = out[j] if out is not None else _empty_on(mesh, j, shape, blocks[0])
        if tuple(dst.shape) != tuple(shape):
            raise ValueError(f"all_to_all output {tuple(dst.shape)} != {tuple(shape)}")
        for i in range(n):
            send(mesh, blocks[i].narrow(split_dim, j * chunk, chunk), i, j,
                 dst.narrow(concat_dim, i * part, part))
        results.append(dst)
    return results


def gather(mesh: Mesh, blocks, dim: int, dst: int = 0) -> torch.Tensor:
    """Every shard's block concatenated along `dim`, in shard order, on
    shard `dst`."""
    sizes = [b.shape[dim] for b in blocks]
    shape = list(blocks[0].shape)
    shape[dim] = sum(sizes)
    out = _empty_on(mesh, dst, shape, blocks[0])
    off = 0
    for i, (b, size) in enumerate(zip(blocks, sizes)):
        send(mesh, b, i, dst, out.narrow(dim, off, size))
        off += size
    return out


def all_gather(mesh: Mesh, blocks, dim: int) -> list:
    """`gather` onto every shard: shard j's output is its own buffer."""
    return [gather(mesh, blocks, dim, dst=j) for j in range(mesh.size)]


def xor_allreduce(mesh: Mesh, blocks) -> list:
    """Bitwise-XOR all-reduce of equal-shape integer blocks: every shard
    gathers all n blocks and folds them locally, which gives the bytes of
    the JAX ppermute butterfly (XOR is associative and commutative).  A
    power-of-two mesh only, as in JAX."""
    n = mesh.size
    if n & (n - 1):
        raise ValueError(f"xor_allreduce needs a power-of-two axis, got {n}")
    stacked = all_gather(mesh, [b.unsqueeze(0) for b in blocks], dim=0)
    results = []
    for j, g in enumerate(stacked):
        with mesh.on(j):
            acc = g[0].clone()
            for i in range(1, n):
                acc.bitwise_xor_(g[i])
        results.append(acc)
    return results


def place_rows(mesh: Mesh, x, rows: int) -> list:
    """Rows [i*rows, (i+1)*rows) of `x` (a host array or tensor) on shard i,
    each its own buffer, copied on the shard's stream (a host array
    through device.upload's pinned staging)."""
    from celestia_app_tpu_torch.device import upload

    out = []
    for i, dev in enumerate(mesh.devices):
        part = x[i * rows:(i + 1) * rows]
        with mesh.on(i):
            if isinstance(part, torch.Tensor):
                buf = torch.empty(part.shape, dtype=part.dtype, device=dev)
                buf.copy_(part, non_blocking=part.device.type == "cpu" and part.is_pinned())
                if part.device == dev and dev.type == "cuda":
                    # Read on the shard's stream: keep its memory from the
                    # caller's stream until the copy has run.
                    part.record_stream(mesh.streams[i])
            else:
                buf = upload(np.ascontiguousarray(part), dev, stream=mesh.streams[i])[0]
        out.append(buf)
    return out


# --- the row-sharded array ---------------------------------------------------


class RowSharded:
    """A (rows, *tail) array held as equal contiguous row blocks: block b is
    rows [b*R, (b+1)*R), a tensor on shard owners[b] of `mesh` (default:
    block i on shard i).  The counterpart of a jax.Array under the
    committed row sharding; a shard may own several blocks (the sharded
    panel runner keeps a top and a bottom slab per shard).

    Reads go to the owning block: `x[r]`, `x[r, c]`, ... are views on the
    owner's device; an index whose rows span blocks is a host read, as are
    `cpu()` and `numpy()`; `take` gathers flat rows where they lie."""

    def __init__(self, mesh: Mesh, blocks, owners=None):
        blocks = tuple(blocks)
        owners = tuple(range(len(blocks)) if owners is None else owners)
        if not blocks or len(owners) != len(blocks):
            raise ValueError(f"{len(blocks)} blocks, {len(owners)} owners")
        tail, dtype = tuple(blocks[0].shape[1:]), blocks[0].dtype
        rows = blocks[0].shape[0]
        for b, o in zip(blocks, owners):
            if tuple(b.shape) != (rows, *tail) or b.dtype != dtype:
                raise ValueError(f"unequal blocks {tuple(b.shape)} vs {(rows, *tail)}")
            if b.device != mesh.devices[o]:
                raise ValueError(f"block on {b.device}, its shard {o} is on {mesh.devices[o]}")
        self.mesh = mesh
        self.blocks = blocks
        self.owners = owners
        self.rows_per_block = rows
        self.shape = torch.Size((rows * len(blocks), *tail))
        self.dtype = dtype

    @property
    def shards(self) -> int:
        return self.mesh.size

    def locate(self, row: int) -> tuple[int, int]:
        """(block, local row) of a global row."""
        if not 0 <= row < self.shape[0]:
            raise IndexError(f"row {row} out of range for {self.shape[0]} rows")
        return divmod(row, self.rows_per_block)

    def owner_of_row(self, row: int) -> int:
        return self.owners[self.locate(row)[0]]

    def __getitem__(self, index):
        index = index if isinstance(index, tuple) else (index,)
        first, rest = index[0], index[1:]
        if isinstance(first, (int, np.integer)):
            b, local = self.locate(int(first) + (self.shape[0] if first < 0 else 0))
            return self.blocks[b][(local, *rest)]
        if not isinstance(first, slice):
            raise TypeError(f"RowSharded rows take an int or a slice, got {type(first)}")
        start, stop, step = first.indices(self.shape[0])
        if step != 1:
            raise ValueError("RowSharded row slices take step 1")
        parts = []
        r = self.rows_per_block
        for b in range(start // r, -(-stop // r)):
            lo, hi = max(start, b * r) - b * r, min(stop, (b + 1) * r) - b * r
            if hi > lo:
                parts.append(self.blocks[b][(slice(lo, hi), *rest)])
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.cpu() for p in parts]) if parts else \
            torch.empty((0, *self.shape[1:]), dtype=self.dtype)[(slice(None), *rest)]

    def cpu(self) -> torch.Tensor:
        """The whole array on the host, read block by block."""
        return torch.cat([b.cpu() for b in self.blocks])

    def numpy(self) -> np.ndarray:
        return self.cpu().numpy()

    def take(self, flat_indices) -> np.ndarray:
        """Rows `flat_indices` of the (N, shape[-1]) flattening, gathered on
        each owning block's device (routed by route_to_shards over the
        blocks), as host bytes in the order asked."""
        width = self.shape[-1]
        per_block = self.rows_per_block * (int(np.prod(self.shape[1:-1])) if len(self.shape) > 2
                                           else 1)
        local, (block, slot), counts = route_to_shards(flat_indices, len(self.blocks), per_block)
        out = np.empty((len(self.blocks), local.shape[1], width), dtype=np.uint8)
        for b, t in enumerate(self.blocks):
            if counts[b]:
                idx = torch.from_numpy(local[b].astype(np.int64)).to(t.device)
                out[b] = t.reshape(per_block, width).index_select(0, idx).cpu().numpy()
        return out[block, slot]
