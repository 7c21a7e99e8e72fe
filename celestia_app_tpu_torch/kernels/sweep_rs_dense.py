"""Time build variants of the RS kernels on the card.

    python -m celestia_app_tpu_torch.kernels.sweep_rs_dense

Each variant is a kernel's source (csrc/rs_dense.cu, csrc/rs_dense_leaf.cu
or csrc/rs_xor.cu, with the shared csrc/rs_dense.cuh) with one compile-time
constant or line replaced.  Dense kernel: ring slots, generator bands walked
together, and "no_mma" (the wgmma issue removed: the loads and the bit
expansion alone, which shows whether the tensor work or the data path
holds the kernel back).  Leaf-hash epilogue kernel: where the hash runs
(on producer warps 1-3, built in, or on the consumers after each item),
the GF(2^16) input read in share order or as a byte-plane copy, ring
slots, the hash removed ("leaf_no_hash": the product and the stores
alone) and the wgmma removed.  XOR kernel (csrc/rs_xor.cu, on
rs_dense.cuh's ring): ring slots, raster groups, and "xor_no_mma" (the
binary wgmma removed: the loads and the A fragments alone).  All
variants build in parallel into the package's build directory.  The dense kernel runs at two main-path shapes
(the k=512 row phase, GF(2^16), cols 131,072; the k=128 column phase,
GF(2^8), cols 131,072), the epilogue kernel at the fused_epi column phase
of k=512 and k=128, the XOR kernel at the k=512 row and column phases and
the k=128 column phase.  Each line gives the mean of CUDA-event timed
launches and the share of the int8 operations bound (XOR: of the
bit-products at the binary wgmma rate that kernels/rs_xor.pipe_rates
measures in the same run); the variants that compute the
whole function are checked byte for byte against the built-in kernel.
Needs an NVIDIA card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from celestia_app_tpu_torch.kernels import _build, rs_dense, rs_xor
from celestia_app_tpu_torch.kernels.rs import generator_tensor, generator_words

INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8 peak (data sheet, 700 W)

STAGES = "constexpr int STAGES = 4;"
GROUP = "constexpr int GROUP_M = 8;"
MMA = "wgmma_s8(d, a[kk], db + 2 * kk, (kb > 0 || kk > 0) ? 1 : 0);"
MODE = "constexpr int kHashMode = 1;"
ORDER = "constexpr bool kShareOrder = true;"
HASH = "for (int blk = 0; blk < kSha; ++blk) leaf_block(st, row, blk);"
XOR_MMA = "wgmma_b1(d, a[kk], db + 2 * kk, (kb > 0 || kk > 0) ? 1 : 0);"

# kernel library -> {variant: [(text, replacement)]}; the variants whose
# name ends in "no_mma" or "no_hash" skip a part of the function.
VARIANTS = {
    "rs_dense": {
        "stages4_group8": [],
        "stages3": [(STAGES, "constexpr int STAGES = 3;")],
        "stages5": [(STAGES, "constexpr int STAGES = 5;")],
        "stages6": [(STAGES, "constexpr int STAGES = 6;")],
        "group4": [(GROUP, "constexpr int GROUP_M = 4;")],
        "group16": [(GROUP, "constexpr int GROUP_M = 16;")],
        "no_mma": [(MMA, "")],
    },
    "rs_dense_leaf": {
        "leaf": [],
        "leaf_hash_after_item": [(MODE, "constexpr int kHashMode = 0;")],
        "leaf_planes": [(ORDER, "constexpr bool kShareOrder = false;")],
        "leaf_stages3": [(STAGES, "constexpr int STAGES = 3;")],
        "leaf_stages5": [(STAGES, "constexpr int STAGES = 5;")],
        "leaf_no_hash": [(HASH, "")],
        "leaf_no_mma": [(MMA, "")],
    },
    "rs_xor": {
        "xor": [],
        "xor_stages3": [(STAGES, "constexpr int STAGES = 3;")],
        "xor_group4": [(GROUP, "constexpr int GROUP_M = 4;")],
        "xor_group16": [(GROUP, "constexpr int GROUP_M = 16;")],
        "xor_no_mma": [(XOR_MMA, ";")],
    },
}


def _partial(name: str) -> bool:
    return name.endswith(("no_mma", "no_hash"))


def build_variants() -> dict[str, ctypes.CDLL]:
    """Every variant of VARIANTS built (all nvcc processes at once) and
    loaded; each in a directory of its own with its copies of the headers."""
    out = _build.BUILD_DIR / "sweep"
    headers = {p.name: p.read_text() for p in _build.CSRC.glob("*.cuh")}
    procs = {}
    for lib, variants in VARIANTS.items():
        source = _build.LIBRARIES[lib][0]
        for name, subs in variants.items():
            texts = {**headers, source: (_build.CSRC / source).read_text()}
            for old, new in subs:
                hits = [f for f, text in texts.items() if old in text]
                if len(hits) != 1:
                    raise RuntimeError(f"variant {name}: {old!r} is in {hits}, want one file")
                texts[hits[0]] = texts[hits[0]].replace(old, new)
            d = out / name
            d.mkdir(parents=True, exist_ok=True)
            for f, text in texts.items():
                (d / f).write_text(text)
            so = d / f"lib{name}.so"
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(d / source)]
            procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (lib, proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
        handle = ctypes.CDLL(str(so))
        for fn, argtypes in _build.LIBRARIES[lib][1].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
        libs[name] = handle
    return libs


def _time(call, reps: int) -> float:
    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _launcher(name: str, fn, *args):
    def call():
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"variant {name} failed to launch: {rc}")
    return call


def sweep_dense(libs, card: str, dev, rng) -> None:
    for k, axis, shape in ((512, 1, (512, 512, 512)), (128, 0, (128, 256, 512))):
        m, G = generator_tensor(k, "vandermonde", dev)
        Pm, nm = G.shape
        data = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        x = data.movedim(axis, 0)
        n, batch, S = x.shape
        bps = m // 8
        planes = x.reshape(n, batch, S // bps, bps).movedim(3, 1).reshape(n * bps, -1).contiguous()
        cols = planes.shape[1]
        want = rs_dense.mod2_matmul_planes(G, planes.view(n, bps, cols), m).reshape(Pm // 8, cols)
        bound_ms = 2.0 * Pm * nm * cols / INT8_OPS_PER_S * 1e3
        for name in VARIANTS["rs_dense"]:
            out = torch.empty((Pm // 8, cols), dtype=torch.uint8, device=dev)
            call = _launcher(name, libs[name].rs_dense_mod2, G, G.stride(0), planes,
                             planes.stride(0), out, out.stride(0), Pm, nm, cols)
            call()
            torch.cuda.synchronize()
            if not _partial(name) and not torch.equal(out, want):
                raise AssertionError(f"variant {name} != the built-in kernel at k={k}")
            ms = _time(call, 5 if k == 512 else 20)
            print(f"[{card}] rs_dense k={k} m={m} axis={axis} cols={cols} {name}: {ms:.3f} ms, "
                  f"{100 * bound_ms / ms:.1f}% of the {bound_ms:.3f} ms bound"
                  f"{'' if _partial(name) else ', equal'}", flush=True)


def sweep_leaf(libs, card: str, dev, rng) -> None:
    for k in (512, 128):
        m, G_bits = generator_tensor(k, "vandermonde", dev)
        bps = m // 8
        Pm, nm = G_bits.shape
        n2 = 2 * k
        top = torch.from_numpy(rng.integers(0, 256, (k, n2, 512), dtype=np.uint8)).to(dev)
        want = rs_xor.extend_leaf_digests(top, G_bits, m)
        G, rows = rs_xor.leaf_operands(top, G_bits, m)

        def to_planes():
            x = top.reshape(k, n2, 512 // bps, bps).movedim(3, 1)
            return x.reshape(k * bps, -1).contiguous()

        planes = to_planes()
        copy_ms = _time(to_planes, 5)
        cols = n2 * 4096 // m
        bound_ms = 2.0 * Pm * nm * cols / INT8_OPS_PER_S * 1e3
        for name in VARIANTS["rs_dense_leaf"]:
            lib = libs[name]
            info = (ctypes.c_int * 12)()
            lib.rs_dense_leaf_info(m, info)
            x = rows if info[10] or m == 8 else planes  # share order, else byte planes
            bottom = torch.empty_like(want[0])
            hashes = torch.empty_like(want[1])
            call = _launcher(name, lib.rs_dense_leaf, G, G.stride(0), x, x.stride(0), bottom,
                             hashes, Pm, nm, n2, m)
            call()
            torch.cuda.synchronize()
            equal = torch.equal(bottom, want[0]) and torch.equal(hashes, want[1])
            if not _partial(name) and not equal:
                raise AssertionError(f"variant {name} != the built-in kernel at k={k}")
            ms = _time(call, 5 if k == 512 else 20)
            note = f" (+ {copy_ms:.3f} ms for the plane copy it needs)" if x is planes else ""
            print(f"[{card}] rs_dense_leaf k={k} m={m} cols={cols} {name}: {ms:.3f} ms{note}, "
                  f"{100 * bound_ms / ms:.1f}% of the {bound_ms:.3f} ms int8 bound"
                  f"{'' if _partial(name) else ', equal'}", flush=True)
        del top, planes, rows, want
        torch.cuda.empty_cache()


def sweep_xor(libs, card: str, dev, rng) -> None:
    rate = rs_xor.pipe_rates(dev)["wgmma_b1"]
    print(f"[{card}] binary wgmma .b1 and.popc: {rate:.4e} bit-products/s", flush=True)
    for k, axis, shape in ((512, 1, (512, 512, 512)), (512, 0, (512, 1024, 512)),
                           (128, 0, (128, 256, 512))):
        m, G = generator_words(k, "vandermonde", dev)
        nw, Pm = G.shape
        data = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        x = data.movedim(axis, 0)
        n, batch, S = x.shape
        bps = m // 8
        planes = x.reshape(n, batch, S // bps, bps).movedim(3, 1).reshape(n, bps, -1)
        planes = planes.contiguous()
        cols = planes.shape[2]
        want = rs_xor.mod2_matmul_planes_xor(G, planes, m).reshape(Pm // 8, cols)
        Gk, B = rs_xor.kernel_operands(G, planes)
        bound_ms = 32.0 * Pm * nw * cols / rate * 1e3
        for name in VARIANTS["rs_xor"]:
            out = torch.empty((Pm // 8, cols), dtype=torch.uint8, device=dev)
            call = _launcher(name, libs[name].rs_xor_mod2, Gk, Gk.stride(0), B, 4 * B.stride(0),
                             out, out.stride(0), Pm, nw, cols)
            call()
            torch.cuda.synchronize()
            if not _partial(name) and not torch.equal(out, want):
                raise AssertionError(f"variant {name} != the built-in kernel at k={k}")
            ms = _time(call, 5 if k == 512 else 20)
            print(f"[{card}] rs_xor k={k} m={m} axis={axis} cols={cols} {name}: {ms:.3f} ms, "
                  f"{100 * bound_ms / ms:.1f}% of the {bound_ms:.3f} ms binary wgmma bound"
                  f"{'' if _partial(name) else ', equal'}", flush=True)
        del data, planes, Gk, B, want
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_rs_dense: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    libs = build_variants()
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    sweep_dense(libs, card, dev, rng)
    sweep_leaf(libs, card, dev, rng)
    sweep_xor(libs, card, dev, rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
