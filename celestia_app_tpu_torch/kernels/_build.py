"""Build, load and launch the port's CUDA kernels.

Each source in celestia_app_tpu_torch/csrc/*.cu is compiled at first use by
`nvcc` for sm_90a into a shared library with a plain C interface, written to
celestia_app_tpu_torch/build/ (git-ignored) under a name that carries the
digest of its sources and flags, and loaded with ctypes.  Every C entry
point launches on the stream it is given (by default the current stream of
the device its tensors lie on) and returns cudaGetLastError(); a non-zero
code raises here.  Nothing falls back to a plain version.

`LAUNCHES` counts, per kernel, the launches made through `launch`, so a run
can show that its main path went through the kernels, and
`STREAM_LAUNCHES` the same per stream.  The streaming pipeline launches
from its dispatcher thread while the caller may launch too, so the counts
change under a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# library -> (source, {entry point: argtypes})
LIBRARIES: dict[str, tuple[str, dict[str, list]]] = {
    "sha256": ("sha256.cu", {
        "sha256_batch": [_P, _L, _I, _P, _P],
        "sha256_leaves": [_P, _P, _L, _P, _P],
    }),
    "rs_dense": ("rs_dense.cu", {
        "rs_dense_mod2": [_P, _L, _P, _L, _P, _L, _I, _I, _L, _P],
        "rs_dense_info": [_P],
    }),
    "rs_xor": ("rs_xor.cu", {
        "rs_xor_mod2": [_P, _L, _P, _L, _P, _L, _I, _I, _L, _P],
        "rs_xor_info": [_P],
    }),
    "rs_xor_probe": ("rs_xor_probe.cu", {
        "rs_xor_probe": [_I, _I, _I, _P, _P],
        "rs_xor_probe_info": [_P],
    }),
    "rs_dense_leaf": ("rs_dense_leaf.cu", {
        "rs_dense_leaf": [_P, _L, _P, _L, _P, _P, _I, _I, _I, _I, _P],
        "rs_dense_leaf_info": [_I, _P],
    }),
}

# kernel name -> launches since the last reset_launches()
LAUNCHES: dict[str, int] = {
    "sha256": 0, "sha256_leaf": 0, "rs_dense": 0, "rs_xor": 0, "rs_dense_leaf": 0,
}

# (kernel name, CUDA stream handle) -> launches since the last
# reset_launches(): a mesh (parallel/mesh.py) gives each shard a stream of
# its own, so this splits the counts by shard even when shards share a card.
STREAM_LAUNCHES: dict[tuple[str, int], int] = {}

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        STREAM_LAUNCHES.clear()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def _library_path(lib: str) -> Path:
    source = LIBRARIES[lib][0]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [source, *sorted(p.name for p in CSRC.glob("*.cuh"))]:
        h.update(f.encode())
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{lib}-{h.hexdigest()[:16]}.so"


def _nvcc_command(lib: str, target: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(target), str(CSRC / LIBRARIES[lib][0])]


def build(libs: list[str] | None = None) -> dict[str, float]:
    """Compile the named libraries (default: all) that are not built yet,
    one nvcc process per source, all started together.  Returns the
    seconds each build took; ptxas' register and shared-memory report is
    kept beside each library as <name>.log."""
    libs = list(LIBRARIES) if libs is None else libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    failed = []
    try:
        for lib in libs:
            target = _library_path(lib)
            if target.exists():
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = _nvcc_command(lib, tmp)
            with open(BUILD_DIR / f"{lib}.log", "w") as log:
                proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
            procs[lib] = (proc, tmp, target, time.perf_counter())
    finally:
        # Every started nvcc is waited for, even when a later start failed.
        for lib, (proc, tmp, target, t0) in procs.items():
            rc = proc.wait()
            seconds[lib] = time.perf_counter() - t0
            if rc != 0:
                failed.append(lib)
            else:
                os.replace(tmp, target)
    if failed:
        logs = "\n".join((BUILD_DIR / f"{lib}.log").read_text() for lib in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return seconds


def library(lib: str) -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    with _LOCK:
        handle = _LOADED.get(lib)
        if handle is None:
            build([lib])
            handle = ctypes.CDLL(str(_library_path(lib)))
            for fn, argtypes in LIBRARIES[lib][1].items():
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = ctypes.c_int
            _LOADED[lib] = handle
        return handle


def launch(kernel: str, lib: str, fn: str, *args, stream=None) -> None:
    """Call one C entry point on the device of its tensor arguments and count
    the launch.

    The tensors must all lie on one CUDA device; the call runs under that
    device's guard (the kernels' per-device set-up reads the current device)
    on `stream`, by default that device's current stream, never another
    device's.  Tensor arguments pass as their device pointers; the caller
    keeps them alive until the call returns (the launch is enqueued by then,
    and the caching allocator keeps the memory for the stream)."""
    devices = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"{fn}: tensor arguments on {sorted(map(str, devices))}, "
                         "want one CUDA device")
    dev = devices.pop()
    if dev.type != "cuda":
        raise ValueError(f"{fn}: tensor arguments on {dev}, want a CUDA device")
    call = getattr(library(lib), fn)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev) if stream is None else stream
        if stream.device != dev:
            raise ValueError(f"{fn}: stream on {stream.device}, tensors on {dev}")
        rc = call(*ptrs, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {rc}")
    with _COUNT_LOCK:
        LAUNCHES[kernel] += 1
        key = (kernel, stream.cuda_stream)
        STREAM_LAUNCHES[key] = STREAM_LAUNCHES.get(key, 0) + 1
