"""Time build variants of the dense RS kernel on the card.

    python -m celestia_app_tpu_torch.kernels.sweep_rs_dense

Each variant is csrc/rs_dense.cu with one or two compile-time constants
replaced (ring slots, generator bands walked together) or with the wgmma
issue removed ("no_mma": the loads, the transpose and the bit expansion
alone, which shows whether the tensor work or the data path holds the
kernel back).  All variants build in parallel into the package's build
directory and run at two main-path shapes: the k=512 row phase (GF(2^16),
cols 131,072) and the k=128 column phase (GF(2^8), cols 131,072).  Each
line gives the mean of CUDA-event timed launches and the share of the int8
operations bound; the variants that keep the wgmma are checked byte for
byte against the built-in kernel.  Needs an NVIDIA card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from celestia_app_tpu_torch.convert import codec_tensors
from celestia_app_tpu_torch.gf.rs import codec_for_width
from celestia_app_tpu_torch.kernels import _build, rs_dense

INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8 peak (data sheet, 700 W)

STAGES = "constexpr int STAGES = 4;"
GROUP = "constexpr int GROUP_M = 8;"
MMA = "wgmma_s8(d, a[kk], db + 2 * kk, (kb > 0 || kk > 0) ? 1 : 0);"

VARIANTS = {
    "stages4_group8": [],
    "stages3": [(STAGES, "constexpr int STAGES = 3;")],
    "stages5": [(STAGES, "constexpr int STAGES = 5;")],
    "stages6": [(STAGES, "constexpr int STAGES = 6;")],
    "group4": [(GROUP, "constexpr int GROUP_M = 4;")],
    "group16": [(GROUP, "constexpr int GROUP_M = 16;")],
    "no_mma": [(MMA, "")],
}


def build_variants() -> dict[str, ctypes.CDLL]:
    source = (_build.CSRC / "rs_dense.cu").read_text()
    out = _build.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in rs_dense.cu")
            text = text.replace(old, new)
        cu, so = out / f"{name}.cu", out / f"lib{name}.so"
        cu.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.rs_dense_mod2.argtypes = _build.LIBRARIES["rs_dense"][1]["rs_dense_mod2"]
        lib.rs_dense_mod2.restype = ctypes.c_int
        libs[name] = lib
    return libs


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
    for k, axis, shape in ((512, 1, (512, 512, 512)), (128, 0, (128, 256, 512))):
        codec = codec_for_width(k, "vandermonde")
        m = codec.field.m
        G = codec_tensors(codec.generator_bits(), m, dev)["G_bits"]
        Pm, nm = G.shape
        data = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        x = data.movedim(axis, 0)
        n, batch, S = x.shape
        bps = m // 8
        planes = x.reshape(n, batch, S // bps, bps).movedim(3, 1).reshape(n * bps, -1).contiguous()
        cols = planes.shape[1]
        want = rs_dense.mod2_matmul_planes(G, planes.view(n, bps, cols), m).reshape(Pm // 8, cols)
        bound_ms = 2.0 * Pm * nm * cols / INT8_OPS_PER_S * 1e3
        stream = torch.cuda.current_stream().cuda_stream
        for name, lib in libs.items():
            out = torch.empty((Pm // 8, cols), dtype=torch.uint8, device=dev)

            def call():
                rc = lib.rs_dense_mod2(G.data_ptr(), G.stride(0), planes.data_ptr(),
                                       planes.stride(0), out.data_ptr(), out.stride(0), Pm, nm,
                                       cols, stream)
                if rc:
                    raise RuntimeError(f"variant {name} failed to launch: {rc}")

            call()
            torch.cuda.synchronize()
            equal = torch.equal(out, want)
            if name != "no_mma" and not equal:
                raise AssertionError(f"variant {name} != the built-in kernel at k={k}")
            reps = 5 if k == 512 else 20
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                call()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / reps
            print(f"[{card}] k={k} m={m} axis={axis} cols={cols} {name}: {ms:.3f} ms, "
                  f"{100 * bound_ms / ms:.1f}% of the {bound_ms:.3f} ms bound"
                  f"{'' if name == 'no_mma' else ', equal'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
