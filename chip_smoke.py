#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the block path on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. build   every CUDA kernel from celestia_app_tpu_torch/csrc (one nvcc per
             source, started together), print the build seconds, the ptxas
             register and spill lines, and the card;
  2. kernels each kernel against its plain PyTorch version on the card at the
             shapes the main path gives it; every byte must agree;
  3. goldens extend_shares on the card reproduces the reference DAH hashes
             (MinDAH, k=2, k=128), under the fused and the fused_epi
             ($CELESTIA_PIPE_FUSED=epi) lowerings;
  4. full    k=512 in GF(2^16) and k=128 leopard on random squares: one data
             root and one EDS through the dense RS kernel, the XOR RS kernel
             and the epilogue kernel (fused_epi on either row-phase seat),
             sampled parity shares == the host RSCodec, sampled leaf digests
             == hashlib, end-to-end times; the launch counters show that each
             path ran through its kernels;
  5. block   extend_block on a k=128 block of txs and BlobTxs: one data root
             under the fused, staged and fused_epi lowerings, equal to
             extend_shares of the constructed square; an empty block is None.
Then one JSON line per kernel table, the card's name and power limit, and
last the result line {"ok": true, "device": {...}}.  Needs no network and no
argument; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
# int32 pipes: the data sheet's 67 TFLOP/s float32 counts two operations
# per FMA on 128 lanes per SM; the int32 pipe has 64 lanes per SM and one
# operation per lane and clock, a quarter of that.
INT32_OPS_PER_S = 67e12 / 4
# Least 32-bit integer operations of one SHA-256 compression with 3-input
# logic (LOP3) and adds (IADD3) and one funnel shift per rotation: 64 rounds
# x 14, 48 schedule words x 10, 8 final adds.
SHA_OPS_PER_COMPRESSION = 64 * 14 + 48 * 10 + 8

MIN_DAH_HASH = "3d96b7d238e7e0456f6af8e7cdf0a67bd6cf9c2089ecb559c659dcaa1f880353"
K2_HASH = "b56e4d251ac266f4b91cc5464b3fc7efcbdc888064647496d13133f0dc65ac25"
K128_HASH = "0bd3abeeacfbb0b92dfbdac4a154868e3c4e79666f7fcf6c620bb90dd3a0dcf0"

KERNELS = {
    "sha256": {
        "route": "cuda", "source": "celestia_app_tpu_torch/csrc/sha256.cu",
        "replaces": "celestia_app_tpu/kernels/sha256.py:207",
    },
    "sha256_leaf": {
        "route": "cuda", "source": "celestia_app_tpu_torch/csrc/sha256.cu",
        "replaces": "celestia_app_tpu/kernels/sha256.py:332",
    },
    "rs_dense": {
        "route": "cuda", "source": "celestia_app_tpu_torch/csrc/rs_dense.cu",
        "replaces": "celestia_app_tpu/kernels/rs_pallas.py:80",
    },
    "rs_xor": {
        "route": "cuda", "source": "celestia_app_tpu_torch/csrc/rs_xor.cu",
        "replaces": "celestia_app_tpu/kernels/rs_xor.py:159",
    },
    "rs_xor_leaf": {
        "route": "cuda", "source": "celestia_app_tpu_torch/csrc/rs_xor_leaf.cu",
        "replaces": "celestia_app_tpu/kernels/rs_xor.py:272",
    },
}

# Per pipeline: (environment, the kernel of the column phase).
PATHS = {
    "dense": ({"CELESTIA_RS_XOR": "off", "CELESTIA_PIPE_FUSED": "on"}, "rs_dense"),
    "xor": ({"CELESTIA_RS_XOR": "on", "CELESTIA_PIPE_FUSED": "on"}, "rs_xor"),
    "epi": ({"CELESTIA_RS_XOR": "off", "CELESTIA_PIPE_FUSED": "epi"}, "rs_xor_leaf"),
    "epi_xor": ({"CELESTIA_RS_XOR": "on", "CELESTIA_PIPE_FUSED": "epi"}, "rs_xor_leaf"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def environment(values: dict):
    """Set environment variables for the block, then restore them."""
    old = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, val in old.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warm: bool = True) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA events)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.int() - b.int()).abs().max().item()) if a.numel() else 0


def bound(bytes_moved: float, ops: float, ops_rate: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / ops_rate
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


class Table:
    """Per-kernel numbers at the main-path shapes, summed over the calls
    that make up one k=512 extend where a kernel runs more than once."""

    def __init__(self):
        self.rows = {name: {"name": name, **meta, "launches": 0, "max_abs_err": 0,
                            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                            "bound_by": None, "library_ms": None}
                     for name, meta in KERNELS.items()}

    def err(self, name: str, e: int) -> None:
        self.rows[name]["max_abs_err"] = max(self.rows[name]["max_abs_err"], e)

    def add(self, name, ms, plain_ms, bound_ms, bound_by, library_ms=None):
        row = self.rows[name]
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bound_ms"] += bound_ms
        row["bound_by"] = bound_by
        if library_ms is not None:
            row["library_ms"] = (row["library_ms"] or 0.0) + library_ms


def phase_kernels(torch, table: Table, card: str) -> None:
    from celestia_app_tpu_torch.gf.rs import codec_for_width
    from celestia_app_tpu_torch.convert import codec_tensors
    from celestia_app_tpu_torch.kernels import rs_dense, rs_xor, sha256 as sha
    from celestia_app_tpu_torch.kernels.rs import _encode_with

    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)

    def rand_bytes(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    # Generic SHA-256: the four message lengths of the path, a lone message,
    # a ragged batch, all NMT nodes of a k=512 square as one batch, and the
    # first node level of one axis at k=512 (the path's largest call).
    main_node_shape = (2 * 512 * 512, 181)
    shapes = [(n, L) for L in (65, 91, 181, 542) for n in (1, 4097)]
    shapes += [(2 * 512 * (2 * 512 - 1), 181), main_node_shape]
    for n, L in shapes:
        msgs = rand_bytes(n, L)
        got = sha.sha256(msgs)
        want = sha.sha256_plain(msgs)
        e = max_abs_err(got, want)
        table.err("sha256", e)
        if e:
            raise AssertionError(f"sha256 kernel != plain at N={n} L={L}")
        if n > 1:
            cpu = msgs[:3].cpu().numpy()
            for i in range(3):
                if got[i].cpu().numpy().tobytes() != hashlib.sha256(cpu[i].tobytes()).digest():
                    raise AssertionError(f"sha256 kernel != hashlib at N={n} L={L}")
        ms = cuda_ms(torch, lambda: sha.sha256(msgs), reps=5)
        plain_ms = cuda_ms(torch, lambda: sha.sha256_plain(msgs), reps=1, warm=False)
        nb = (L + 9 + 63) // 64
        b_ms, b_by = bound(n * (L + 32), n * nb * SHA_OPS_PER_COMPRESSION, INT32_OPS_PER_S)
        log(f"[{card}] sha256 N={n} L={L}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), equal")
        if (n, L) == main_node_shape:
            table.add("sha256", ms, plain_ms, b_ms, b_by)
        del msgs, got, want

    # Fused-leaf SHA-256: every leaf of a k=128 and of a k=512 square.
    for k in (128, 512):
        n = 4 * k * k
        ns, shares = rand_bytes(n, 29), rand_bytes(n, 512)
        got = sha.sha256_leaves(ns, shares)
        want = sha.sha256_leaves_plain(ns, shares)
        e = max_abs_err(got, want)
        table.err("sha256_leaf", e)
        if e:
            raise AssertionError(f"leaf kernel != plain at N={n}")
        ms = cuda_ms(torch, lambda: sha.sha256_leaves(ns, shares), reps=5)
        plain_ms = cuda_ms(torch, lambda: sha.sha256_leaves_plain(ns, shares), reps=1,
                           warm=False)
        b_ms, b_by = bound(n * (29 + 512 + 32), n * 9 * SHA_OPS_PER_COMPRESSION,
                           INT32_OPS_PER_S)
        log(f"[{card}] sha256_leaf N={n}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), equal")
        if k == 512:
            table.add("sha256_leaf", ms, plain_ms, b_ms, b_by)
        del ns, shares, got, want

    # RS encodes at the main path's shapes: the row phase contracts axis 1
    # of the ODS (k, k, 512), the column phase axis 0 of the top half
    # (k, 2k, 512).
    for k in (128, 512):
        codec = codec_for_width(k, "vandermonde")
        m = codec.field.m
        t = codec_tensors(codec.generator_bits(), m, dev)
        G_bits, G_words = t["G_bits"], t["G_words"]
        Pm, nm = G_bits.shape
        nw = G_words.shape[0]
        for axis, data_shape in ((1, (k, k, 512)), (0, (k, 2 * k, 512))):
            data = rand_bytes(*data_shape)
            want = _encode_with(rs_dense.mod2_matmul_planes_plain, data, G_bits, m, axis)
            for name, core, plain, G in (
                ("rs_dense", rs_dense.mod2_matmul_planes,
                 rs_dense.mod2_matmul_planes_plain, G_bits),
                ("rs_xor", rs_xor.mod2_matmul_planes_xor,
                 rs_xor.mod2_matmul_planes_xor_plain, G_words),
            ):
                got = _encode_with(core, data, G, m, axis)
                e = max_abs_err(got, want)
                if name == "rs_xor":  # the XOR plain version must agree too
                    e = max(e, max_abs_err(
                        _encode_with(plain, data, G, m, axis), want))
                table.err(name, e)
                if e:
                    raise AssertionError(f"{name} != plain at k={k} axis={axis}")
                del got
                x = data.movedim(axis, 0)
                n_, batch, S = x.shape
                bps = m // 8
                planes = x.reshape(n_, batch, S // bps, bps).movedim(3, 1).reshape(
                    n_, bps, -1).contiguous()
                cols = planes.shape[2]
                ms = cuda_ms(torch, lambda: core(G, planes, m), reps=3)
                plain_ms = cuda_ms(torch, lambda: plain(G, planes, m), reps=1, warm=False)
                lib_ms = None
                if name == "rs_dense":
                    bits = rs_dense._unpack_bits(planes)
                    lib_ms = cuda_ms(torch, lambda: torch._int_mm(G_bits, bits), reps=3)
                    del bits
                    b_ms, b_by = bound(Pm * nm + nm // 8 * cols + Pm // 8 * cols,
                                       2.0 * Pm * nm * cols, INT8_OPS_PER_S)
                else:
                    b_ms, b_by = bound(4 * nw * Pm + 4 * nw * cols + Pm // 8 * cols,
                                       float(Pm) * nw * cols, INT32_OPS_PER_S)
                lib = f", torch._int_mm {lib_ms:.3f} ms" if lib_ms is not None else ""
                log(f"[{card}] {name} k={k} m={m} axis={axis} cols={cols}: kernel "
                    f"{ms:.3f} ms, plain {plain_ms:.3f} ms{lib}, bound {b_ms:.3f} ms "
                    f"({b_by}), equal")
                if k == 512:
                    table.add(name, ms, plain_ms, b_ms, b_by, lib_ms)
                del planes
                torch.cuda.empty_cache()
            del data, want
        del G_bits, G_words, t
        torch.cuda.empty_cache()

    # The fused extend + leaf-hash epilogue on the fused_epi column phase's
    # input, the top half (k, 2k, 512): GF(2^8) at k = 1, 2, 128 and
    # GF(2^16) at k = 256, 512.
    for k in (1, 2, 128, 256, 512):
        codec = codec_for_width(k, "vandermonde")
        m = codec.field.m
        G_words = codec_tensors(codec.generator_bits(), m, dev)["G_words"]
        nw, Pm = G_words.shape
        top = rand_bytes(k, 2 * k, 512)
        bottom, hashes = rs_xor.extend_leaf_digests(top, G_words, m)
        want_bottom, want_hashes = rs_xor.extend_leaf_digests_plain(top, G_words, m)
        e = max(max_abs_err(bottom, want_bottom), max_abs_err(hashes, want_hashes))
        table.err("rs_xor_leaf", e)
        if e:
            raise AssertionError(f"rs_xor_leaf != plain at k={k} m={m}")
        n_leaves = k * 2 * k
        for idx in rng.choice(n_leaves, min(64, n_leaves), replace=False):
            i, j = divmod(int(idx), 2 * k)
            msg = b"\x00" + b"\xff" * 29 + bottom[i, j].cpu().numpy().tobytes()
            if hashes[i, j].cpu().numpy().tobytes() != hashlib.sha256(msg).digest():
                raise AssertionError(f"rs_xor_leaf digest ({i}, {j}) != hashlib at k={k}")
        del want_bottom, want_hashes
        ms = cuda_ms(torch, lambda: rs_xor.extend_leaf_digests(top, G_words, m), reps=3)
        plain_ms = cuda_ms(torch, lambda: rs_xor.extend_leaf_digests_plain(top, G_words, m),
                           reps=1, warm=False)
        cols = 2 * k * (512 * 8 // m)
        b_ms, b_by = bound(top.numel() + 4 * nw * Pm + bottom.numel() + hashes.numel(),
                           float(Pm) * nw * cols + n_leaves * 9 * SHA_OPS_PER_COMPRESSION,
                           INT32_OPS_PER_S)
        log(f"[{card}] rs_xor_leaf k={k} m={m} NW={nw} cols={cols}: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), equal; "
            f"{min(64, n_leaves)} digests == hashlib")
        if k == 512:
            table.add("rs_xor_leaf", ms, plain_ms, b_ms, b_by)
        del top, bottom, hashes, G_words
        torch.cuda.empty_cache()


def golden_share() -> bytes:
    ns = bytes([0x00]) + bytes(18) + bytes([0x01]) * 10
    return ns + b"\xff" * (512 - 29)


def phase_goldens(card: str) -> None:
    from celestia_app_tpu_torch.da import (
        DataAvailabilityHeader, extend_shares, min_data_availability_header,
    )

    for fused in ("on", "epi"):
        with environment({"CELESTIA_PIPE_FUSED": fused}):
            got = min_data_availability_header().hash().hex()
            if got != MIN_DAH_HASH:
                raise AssertionError(f"MinDAH {got} != {MIN_DAH_HASH} (CELESTIA_PIPE_FUSED={fused})")
            for k, want in ((2, K2_HASH), (128, K128_HASH)):
                t0 = time.perf_counter()
                eds = extend_shares([golden_share()] * (k * k))
                got = DataAvailabilityHeader.from_eds(eds).hash().hex()
                if got != want or eds.data_root().hex() != want:
                    raise AssertionError(f"k={k} golden {got} != {want} "
                                         f"(CELESTIA_PIPE_FUSED={fused})")
                log(f"[{card}] golden k={k} CELESTIA_PIPE_FUSED={fused}: {got} "
                    f"({time.perf_counter() - t0:.3f} s, first call)")
        log(f"golden MinDAH, k=2, k=128 under CELESTIA_PIPE_FUSED={fused}: equal")


def device_breakdown(torch, fn, card: str, label: str) -> None:
    """Device time by kernel over one call of `fn` (torch.profiler), and the
    share of the call's wall time in which the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        log(f"[{card}] {label}: device time not measured (the profiler saw no device events)")
        return
    by_name: dict[str, float] = {}
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    busy, last = 0.0, None
    for start, end, _ in sorted(spans):
        if last is None or start > last:
            busy += end - start
            last = end
        elif end > last:
            busy += end - last
            last = end
    log(f"[{card}] {label} under the profiler: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% of wall, idle "
        f"{100 - 100 * busy / wall_us:.1f}%)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {us / 1e3:9.3f} ms  {name[:100]}")


def random_square(k: int, seed: int) -> np.ndarray:
    """(k, k, 512) shares whose v0 namespaces rise in row-major order, as in
    a real square; the share bodies are random."""
    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, (k * k, 512), dtype=np.uint8)
    ids = np.sort(rng.integers(0, 2**63, k * k, dtype=np.int64)).astype(">u8")
    ods[:, :21] = 0  # version 0, 18 zero prefix bytes, 2 zero id bytes
    ods[:, 21:29] = ids.view(np.uint8).reshape(k * k, 8)
    return ods.reshape(k, k, 512)


def phase_full(torch, k: int, construction: str, card: str, seed: int):
    """Returns the launch counts of one extend_shares on each path of PATHS."""
    from celestia_app_tpu_torch.da import extend_shares
    from celestia_app_tpu_torch.da.eds import leaf_namespaces
    from celestia_app_tpu_torch.gf.rs import codec_for_width
    from celestia_app_tpu_torch.kernels import _build
    from celestia_app_tpu_torch.kernels.nmt import leaf_digests

    ods = random_square(k, seed)
    shares = [row.tobytes() for row in ods.reshape(k * k, 512)]
    codec_for_width(k, construction).generator_bits()  # host set-up, once

    def run(path: str):
        with environment(PATHS[path][0]):
            eds = extend_shares(shares, construction)
            root = eds.data_root()  # copies to the host: the device work is done
        return eds, root

    for path in PATHS:  # first calls: codec tensors on the card, allocator warm-up
        run(path)
    counts, roots = {}, {}
    eds = None
    for path in PATHS:
        _build.reset_launches()
        other, roots[path] = run(path)
        counts[path] = dict(_build.LAUNCHES)
        if eds is None:
            eds = other
        elif not torch.equal(eds._eds, other._eds):
            raise AssertionError(f"k={k} {construction}: {path} EDS != dense EDS")
        del other
    if len(set(roots.values())) != 1:
        raise AssertionError(f"k={k} {construction}: data roots differ across paths: "
                             f"{ {p: r.hex() for p, r in roots.items()} }")
    for path, row_kernel in (("epi", "rs_dense"), ("epi_xor", "rs_xor")):
        got = {n: counts[path][n] for n in ("rs_xor_leaf", "sha256_leaf", row_kernel)}
        if set(got.values()) != {1}:
            raise AssertionError(f"k={k} {path}: launches per extend {got}, want 1 each")

    e2e = {}
    for path in PATHS:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(path)
            times.append((time.perf_counter() - t0) * 1e3)
        e2e[path] = (float(np.median(times)), times)
        if k == 512:
            device_breakdown(torch, lambda: run(path), card,
                             f"k={k} {construction} {path} path")

    # 96 parity shares against the host codec: 32 in Q1 from 4 rows, 32 in
    # Q2 from 4 ODS columns, 32 in Q3 from 4 Q1 columns.
    rng = np.random.default_rng(seed + 1)
    codec = codec_for_width(k, construction)
    picks = min(k, 8)
    for i in rng.choice(k, 4, replace=False):
        parity = codec.encode(ods[i])
        for p in rng.choice(k, picks, replace=False):
            if eds._eds[i, k + p].cpu().numpy().tobytes() != parity[p].tobytes():
                raise AssertionError(f"Q1 share ({i}, {k + p}) != host RSCodec")
    for j in rng.choice(2 * k, 8, replace=False):
        parity = codec.encode(eds._eds[:k, j].cpu().numpy())
        for p in rng.choice(k, picks, replace=False):
            if eds._eds[k + p, j].cpu().numpy().tobytes() != parity[p].tobytes():
                quadrant = "Q2" if j < k else "Q3"
                raise AssertionError(f"{quadrant} share ({k + p}, {j}) != host RSCodec")

    # 64 leaf digests of the whole EDS against hashlib.
    row_ns, _ = leaf_namespaces(eds._eds, k)
    _, _, hashes = leaf_digests(row_ns, eds._eds)
    for _ in range(64):
        i, j = (int(v) for v in rng.integers(0, 2 * k, 2))
        msg = b"\x00" + row_ns[i, j].cpu().numpy().tobytes() + eds._eds[i, j].cpu().numpy().tobytes()
        if hashes[i, j].cpu().numpy().tobytes() != hashlib.sha256(msg).digest():
            raise AssertionError(f"leaf digest ({i}, {j}) != hashlib")

    log(f"[{card}] full k={k} {construction}: data root {roots['dense'].hex()} and EDS equal "
        f"on paths {list(PATHS)}; {12 * picks} Q1/Q2/Q3 parity shares == host RSCodec; "
        f"64 leaf digests == hashlib")
    for path, (ms, times) in e2e.items():
        log(f"[{card}] extend_shares k={k} {construction} {path} path end to end: "
            f"{ms:.3f} ms (median of {times})")
    for path in PATHS:
        log(f"launches k={k} {construction} {path} path: {counts[path]}")
    return counts


def block_txs(seed: int, n_txs: int, n_blob_txs: int, max_blob_shares: int) -> list[bytes]:
    """A block's raw txs: normal txs of 100-1000 B, then BlobTxs of one to
    three blobs each under 32 v0 namespaces, blob sizes spread from one
    share to `max_blob_shares` shares."""
    from celestia_app_tpu_torch.constants import (
        CONTINUATION_SPARSE_SHARE_CONTENT_SIZE as CONT,
        FIRST_SPARSE_SHARE_CONTENT_SIZE as FIRST,
    )
    from celestia_app_tpu_torch.shares import Blob, Namespace
    from celestia_app_tpu_torch.tx.envelopes import BlobTx

    rng = np.random.default_rng(seed)
    namespaces = [Namespace.v0(rng.bytes(10)) for _ in range(32)]
    txs = [rng.bytes(int(rng.integers(100, 1000))) for _ in range(n_txs)]
    for _ in range(n_blob_txs):
        blobs = []
        for _ in range(int(rng.integers(1, 4))):
            n = int(rng.integers(1, max_blob_shares + 1))
            size = (int(rng.integers(1, FIRST + 1)) if n == 1
                    else FIRST + (n - 2) * CONT + int(rng.integers(1, CONT + 1)))
            blobs.append(Blob(namespaces[int(rng.integers(32))], rng.bytes(size)))
        txs.append(BlobTx(rng.bytes(int(rng.integers(150, 400))), tuple(blobs)).marshal())
    return txs


def phase_block(card: str) -> None:
    """extend_block, the consensus entry point, on a k=128 block."""
    from celestia_app_tpu_torch.app import extend_block
    from celestia_app_tpu_torch.da import extend_shares
    from celestia_app_tpu_torch.square import construct

    txs = block_txs(128, 200, 300, 40)
    construct_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        sq = construct(txs, 128)
        construct_ms.append((time.perf_counter() - t0) * 1e3)
    if sq.size != 128:
        raise AssertionError(f"the block builds a k={sq.size} square, want 128")
    shares = sq.share_bytes()
    want = extend_shares(shares).data_root()
    extend_ms, block_ms = {}, {}
    for fused in ("on", "off", "epi"):
        with environment({"CELESTIA_PIPE_FUSED": fused}):
            extend_block(txs)  # first call of this lowering
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                root = extend_block(txs).data_root()
                times.append((time.perf_counter() - t0) * 1e3)
                if root != want:
                    raise AssertionError(f"extend_block root {root.hex()} != extend_shares "
                                         f"root {want.hex()} (CELESTIA_PIPE_FUSED={fused})")
            block_ms[fused] = times
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                extend_shares(shares).data_root()
                times.append((time.perf_counter() - t0) * 1e3)
            extend_ms[fused] = times
    if extend_block([]) is not None:
        raise AssertionError("extend_block of an empty block is not None")
    small = block_txs(4, 6, 3, 3)
    on_card, on_cpu = extend_block(small), extend_block(small, device="cpu")
    if on_card.data_root() != on_cpu.data_root():
        raise AssertionError(f"k={on_card.k} block: card root != CPU root")
    log(f"[{card}] block: {len(txs)} txs -> k={sq.size}, {sq.accounting.used_shares} shares "
        f"used; data root {want.hex()} under CELESTIA_PIPE_FUSED=on/off/epi == "
        f"extend_shares; empty block -> None; k={on_card.k} block card == CPU")
    log(f"[{card}] block: host construct {float(np.median(construct_ms)):.3f} ms "
        f"(median of {construct_ms})")
    for fused in block_ms:
        log(f"[{card}] block CELESTIA_PIPE_FUSED={fused}: extend_shares of the square "
            f"{float(np.median(extend_ms[fused])):.3f} ms (median of {extend_ms[fused]}); "
            f"extend_block {float(np.median(block_ms[fused])):.3f} ms "
            f"(median of {block_ms[fused]})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        from celestia_app_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    card = card_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    seconds = _build.build()
    log(f"[{card}] build: {time.perf_counter() - t0:.2f} s for all kernels "
        f"({ {k: round(v, 2) for k, v in seconds.items()} })")
    for lib in _build.LIBRARIES:
        path = _build.BUILD_DIR / f"{lib}.log"
        if path.exists():
            for line in path.read_text().splitlines():
                if "entry function" in line or "registers" in line or "spill" in line:
                    log(f"ptxas {lib}: {line.strip()}")

    table = Table()
    phase_kernels(torch, table, card)
    phase_goldens(card)
    counts = phase_full(torch, 512, "vandermonde", card, seed=512)
    phase_full(torch, 128, "leopard", card, seed=128)
    phase_block(card)

    # Each kernel's launches on the k=512 path that runs it: the column
    # phase's kernel names the path, the hashing kernels run on every path.
    for name in KERNELS:
        path = next((p for p, (_, col) in PATHS.items() if col == name), "dense")
        table.rows[name]["launches"] = counts[path][name]
    missing = [n for n, r in table.rows.items() if r["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on their path: {missing}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(table.rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
