#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the block path on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. build   every CUDA kernel from celestia_app_tpu_torch/csrc (one nvcc per
             source, started together), print the build seconds, the ptxas
             register and spill lines, the two tensor-core kernels'
             registers per warpgroup role, tiling and shared memory, and the
             card;
  2. kernels each kernel against its plain PyTorch version on the card at the
             shapes the main path gives it (the RS kernels and the epilogue
             at k = 1, 2, 16, 128, 256, 512, the dense one and the epilogue
             also on random 0/1 generators at ragged shapes); every byte
             must agree; times beside the bound and torch._int_mm, the
             library call for the RS product, and for the epilogue the
             unfused pair that computes the same function;
  3. goldens extend_shares on the card reproduces the reference DAH hashes
             (MinDAH, k=2, k=128), under the fused and the fused_epi
             ($CELESTIA_PIPE_FUSED=epi) lowerings;
  4. full    k=512 in GF(2^16) and k=128 leopard on random squares: one data
             root and one EDS through the dense RS kernel, the XOR RS kernel
             and the epilogue kernel (fused_epi on either row-phase seat),
             sampled parity shares == the host RSCodec, sampled leaf digests
             == hashlib, end-to-end times, device time by kernel under the
             profiler (every path at k=512, the dense one at k=128 too); the
             launch counters show that each path ran through its kernels;
  5. block   extend_block on a k=128 block of txs and BlobTxs: one data root
             under the fused, staged and fused_epi lowerings, equal to
             extend_shares of the constructed square; an empty block is None;
  6. repair  da.repair at k=512 (GF(2^16)) on the dense and the fused_epi
             paths: Q3 withheld (no decode, one re-extension) and Q0 withheld
             (one decode sweep through rs_dense with the recover matrix as
             the generator, then the re-extension), a random erasure at the
             25 % threshold at k=64 under both $CELESTIA_REPAIR_SWEEP values,
             and a corrupted survivor, which must raise RootMismatch; the
             repaired EDS equals the original byte for byte, the DAH matches,
             and the RS launch counts are those of the path;
  7. das     the read side at k=512: the forest of one square (checked level
             by level against kernels/nmt.tree_levels_from_digests), 4096
             random samples on each axis through ProofSampler.sample_batch
             (32 held byte-equal to the host lowering), and verify_proofs on
             all of them and on a queue with 64 tampered proofs, exactly
             those rejected;
  8. serve   the DAS serving plane: a DasProvider over the k=512 square
             (share proofs on both axes, namespace shares and an
             attestation, each == the host lowering and verified), the
             adversary's withheld / malformed / wrong-root refusals, heals
             (tampered shares, irrecoverable, a dispatch fault mid-repair,
             a fault past the ladder's floor: no verdict), proof_fail
             retried on the card, and a k=128 ServingNode's three DAS RPCs
             over HTTP with its healer repairing a withheld height;
  9. ops     the node's operator plane: the HTTP GET surface over the k=512
             square (/das bodies over HTTP == the host lowering, /device
             from device_memory_stats, /healthz, /metrics, a device fault
             answered 500), state sync of a k=128 chain to a joiner on the
             card (its catch-up through rs_dense and both SHA-256 kernels,
             app hash == the source's == a CPU replay), the fleet over the
             two nodes and a stopped URL, and a 3-process devnet on the card
             (the phase's docstring says what it checks);
 10. uploads the one-shot calls' staged (pinned) host-to-device copy against a
             pageable one, in turns: the upload alone and extend_shares at
             k=128 and 512, and the k=512 repair;
 11. stream  stream_blocks at k=128 (leopard, 32 squares, batch 1 and 4) and
             k=512 (vandermonde, 8 squares, batch 1), depth 2: every data root
             equal to a one-shot compute, squares per second beside the
             one-shot time, launches per dispatch (counted per batch from the
             journal rows), the journal's stage medians, the device idle
             share and the copy/kernel overlap under the profiler; the
             epilogue and the XOR core through the stream once each; forests
             built on the default stream while the pipeline runs, equal to
             the one-shot forests; a speculation hit and a discard; the
             ring's swap of a pinned slot;
 12. faults  the device fault plane (chaos/degrade.py): the degradation
             ladder walked rung by rung at k=512 under $CELESTIA_CHAOS specs
             (fused_epi -> fused -> staged -> host, each rung's journal row
             and launches, on the dense and the XOR core), real launch
             faults retried or walked to the floor, the panel and
             sharded-panel rungs, the stream's, repair's and the parity
             sentinel's drills, warm-up's cold and warm first calls, the
             device ledger and the bridge backend's fall-back (the phase's
             docstring says what it checks);
 13. commitments, 14. app, 15. chain, 16. node, 17. consensus, 18. querier,
 19. bridge: the consensus-side entry points, the ABCI App's CheckTx /
             PrepareProposal / ProcessProposal among them, two k=128
             heights of Prepare -> Process -> FinalizeBlock -> Commit, the
             in-process node (TestNode, Network, txsim) broadcasting two
             k=128 blocks' worth of txs into its sharded pool and producing
             two heights, and Tendermint consensus: 3 live ServingNodes of
             4 validators gossiping over localhost HTTP through 3 heights,
             one with a dead proposer and one with an injected launch fault
             that outlasts the ladder (each phase's docstring says what it
             checks);
 20. giant   k=1024 and k=2048 (GF(2^16)): the materializing fused, epi and
             XOR lowerings and the panel-streamed one ($CELESTIA_PIPE_PANEL:
             64-row panels, 48-row panels at k=1024, the FFT column leg):
             one data root and one EDS per k, the roots-only twins, 64
             parity shares per k == the host additive FFT, launches per
             lowering as counted from the code, wall and device time and
             peak memory per lowering, a k=1024 BlockPipeline under panel
             mode (batch 1, 16 panels per square);
 21. mesh    the multi-device plane on 4 logical shards of cuda:0, each with
             its own stream (and again over the real cards where there are
             two or more): the k=512 sharded extend over 2 and 4 shards and
             its DAH-only twin == single-card compute, sharded repair with
             Q3 withheld, 4096 samples per axis from forests over a 4-shard
             serve mesh == the single-card sampler; the k=2048 sharded panel
             square (64-row panels) and its roots-only twin == phase_giant's
             data root, with wall, device busy and idle, peak memory and
             launches per shard, a share gather from its row-sharded EDS;
             rs_dense == plain on one owner's column contraction; the k=1024
             FFT leg's root.
Then one JSON line per kernel table, the card's name and power limit, and
last the result line {"ok": true, "device": {...}}.  Needs no network and no
argument; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
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
    "rs_dense_leaf": {
        "route": "cuda", "source": "celestia_app_tpu_torch/csrc/rs_dense_leaf.cu",
        "replaces": "celestia_app_tpu/kernels/rs_xor.py:272",
    },
}

# Per pipeline: (environment, the kernel of the column phase).
PATHS = {
    "dense": ({"CELESTIA_RS_XOR": "off", "CELESTIA_PIPE_FUSED": "on"}, "rs_dense"),
    "xor": ({"CELESTIA_RS_XOR": "on", "CELESTIA_PIPE_FUSED": "on"}, "rs_xor"),
    "epi": ({"CELESTIA_RS_XOR": "off", "CELESTIA_PIPE_FUSED": "epi"}, "rs_dense_leaf"),
    "epi_xor": ({"CELESTIA_RS_XOR": "on", "CELESTIA_PIPE_FUSED": "epi"}, "rs_dense_leaf"),
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


def rs_dense_roles(_build) -> str:
    """The dense kernel's tiling and its registers per warpgroup role: ptxas
    allocates one count for the launch, setmaxnreg moves registers from the
    producer to the consumers at run time."""
    import ctypes

    v = (ctypes.c_int * 8)()
    _build.library("rs_dense").rs_dense_info(v)
    rows, cols, bk, stages, prod, cons, smem, threads = list(v)
    return (f"rs_dense: {threads} threads, tiles of {rows} generator rows x {cols} columns, "
            f"{bk}-bit stages, {stages}-slot ring, {smem} B dynamic shared memory; "
            f"consumer warpgroups (2: packed-tile reads, bit expansion, wgmma) {cons} registers, "
            f"producer warpgroup (TMA on one thread) {prod} registers (setmaxnreg)")


def rs_dense_leaf_roles(_build) -> str:
    """The epilogue kernel's tiling, shared memory and registers per role
    at both symbol widths (its main loop is the dense kernel's)."""
    import ctypes

    parts = []
    for m in (8, 16):
        v = (ctypes.c_int * 12)()
        if _build.library("rs_dense_leaf").rs_dense_leaf_info(m, v):
            raise RuntimeError(f"rs_dense_leaf_info({m}) failed")
        rows, cols, bk, stages, prod, cons, smem, threads, shares, tiles, order, mode = list(v)
        parts.append(f"m={m}: items of {rows} generator rows ({shares} shares) x {tiles} column "
                     f"tiles of {cols}, {smem} B dynamic shared memory, input "
                     f"{'in share order' if order else 'as byte planes'}")
    where = {0: "the consumers after each item",
             1: "producer warps 1-3 beside the next item"}[mode]
    return (f"rs_dense_leaf: {threads} threads, {bk}-bit stages, {stages}-slot ring, consumer "
            f"warpgroups (2: packed-tile reads, bit expansion, wgmma, share-tile scatter) {cons} "
            f"registers, producer warpgroup (TMA on one thread) {prod} (setmaxnreg); stores and "
            f"hash on {where}; " + "; ".join(parts))


def max_abs_err(a, b) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.int() - b.int()).abs().max().item()) if a.numel() else 0


def bound(bytes_moved: float, *work: tuple[float, float]) -> tuple[float, str]:
    """The least time in ms of a kernel that moves `bytes_moved` and does
    each (operations, peak rate) of `work` on its own pipe: the pipes and
    the memory run concurrently, so the largest of their times."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(ops / rate for ops, rate in work)
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
        b_ms, b_by = bound(n * (L + 32), (n * nb * SHA_OPS_PER_COMPRESSION, INT32_OPS_PER_S))
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
        b_ms, b_by = bound(n * (29 + 512 + 32), (n * 9 * SHA_OPS_PER_COMPRESSION,
                                                 INT32_OPS_PER_S))
        log(f"[{card}] sha256_leaf N={n}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), equal")
        if k == 512:
            table.add("sha256_leaf", ms, plain_ms, b_ms, b_by)
        del ns, shares, got, want

    # RS encodes at the main path's shapes: the row phase contracts axis 1
    # of the ODS (k, k, 512), the column phase axis 0 of the top half
    # (k, 2k, 512).  Both kernels against the plain version at every k of
    # the path's two fields; timed at k = 128 (GF(2^8)) and 512 (GF(2^16)),
    # beside torch._int_mm on the unpacked bits, which computes the same
    # product and is the library yardstick of both rows.
    for k in (1, 2, 16, 128, 256, 512):
        codec = codec_for_width(k, "vandermonde")
        m = codec.field.m
        t = codec_tensors(codec.generator_bits(), m, dev)
        G_bits, G_words = t["G_bits"], t["G_words"]
        Pm, nm = G_bits.shape
        nw = G_words.shape[0]
        cores = (
            ("rs_dense", rs_dense.mod2_matmul_planes, rs_dense.mod2_matmul_planes_plain, G_bits),
            ("rs_xor", rs_xor.mod2_matmul_planes_xor, rs_xor.mod2_matmul_planes_xor_plain,
             G_words),
        )
        for axis, data_shape in ((1, (k, k, 512)), (0, (k, 2 * k, 512))):
            data = rand_bytes(*data_shape)
            want = _encode_with(rs_dense.mod2_matmul_planes_plain, data, G_bits, m, axis)
            for name, core, plain, G in cores:
                got = _encode_with(core, data, G, m, axis)
                e = max_abs_err(got, want)
                if name == "rs_xor":  # the XOR plain version must agree too
                    e = max(e, max_abs_err(_encode_with(plain, data, G, m, axis), want))
                table.err(name, e)
                if e:
                    raise AssertionError(f"{name} != plain at k={k} axis={axis}")
                del got
            if k not in (128, 512):
                log(f"[{card}] rs_dense, rs_xor k={k} m={m} axis={axis}: equal to plain")
                del data, want
                continue
            x = data.movedim(axis, 0)
            n_, batch, S = x.shape
            bps = m // 8
            planes = x.reshape(n_, batch, S // bps, bps).movedim(3, 1).reshape(
                n_, bps, -1).contiguous()
            cols = planes.shape[2]
            bits = rs_dense._unpack_bits(planes)
            G_dense = G_bits.contiguous()
            lib_ms = cuda_ms(torch, lambda: torch._int_mm(G_dense, bits), reps=3)
            del bits, G_dense
            for name, core, plain, G in cores:
                ms = cuda_ms(torch, lambda: core(G, planes, m), reps=3)
                plain_ms = cuda_ms(torch, lambda: plain(G, planes, m), reps=1, warm=False)
                if name == "rs_dense":
                    b_ms, b_by = bound(Pm * nm + nm // 8 * cols + Pm // 8 * cols,
                                       (2.0 * Pm * nm * cols, INT8_OPS_PER_S))
                else:
                    b_ms, b_by = bound(4 * nw * Pm + 4 * nw * cols + Pm // 8 * cols,
                                       (float(Pm) * nw * cols, INT32_OPS_PER_S))
                log(f"[{card}] {name} k={k} m={m} axis={axis} cols={cols}: kernel "
                    f"{ms:.3f} ms ({100 * b_ms / ms:.1f}% of bound), plain {plain_ms:.3f} ms, "
                    f"torch._int_mm {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), equal")
                if k == 512:
                    table.add(name, ms, plain_ms, b_ms, b_by, lib_ms)
            del planes, data, want
            torch.cuda.empty_cache()
        del G_bits, G_words, t
        torch.cuda.empty_cache()

    # The dense kernel on random 0/1 generators (not RS ones) at ragged Pm,
    # nm and cols, whose tiles cut through every edge of its 128 x 256 x 128
    # tiling; contiguous operands, so the wrapper pads their row strides.
    for Pm, nm, m in ((24, 40, 8), (32, 48, 16), (136, 264, 8)):
        G = torch.from_numpy(rng.integers(0, 2, (Pm, nm), dtype=np.int8)).to(dev)
        for cols in (1, 120, 257, 1000):
            x = rand_bytes(nm // m, m // 8, cols)
            e = max_abs_err(rs_dense.mod2_matmul_planes(G, x, m),
                            rs_dense.mod2_matmul_planes_plain(G, x, m))
            table.err("rs_dense", e)
            if e:
                raise AssertionError(f"rs_dense != plain on a random generator "
                                     f"Pm={Pm} nm={nm} m={m} cols={cols}")
    log(f"[{card}] rs_dense on random generators (Pm, nm) = (24, 40), (32, 48), (136, 264) "
        f"x cols 1, 120, 257, 1000: equal to plain")

    # The fused extend + leaf-hash epilogue on the fused_epi column phase's
    # input, the top half (k, 2k, 512): GF(2^8) at k = 1, 2, 16, 128 (and
    # k=128 leopard), GF(2^16) at k = 256, 512.  Timed at k = 128 and 512
    # beside its bound (int8 tensor operations of the product and int32
    # operations of the hashes, on pipes that run side by side, and the
    # bytes) and beside the unfused pair that computes the same function on
    # the fused path: the rs_dense column phase with its plane copy and
    # regroup, then sha256_leaves on the bottom half.  The two are timed in
    # turns (kernel, pair, pair, kernel).
    from celestia_app_tpu_torch.kernels.nmt import parity_namespaces

    for k, construction in ((1, "vandermonde"), (2, "vandermonde"), (16, "vandermonde"),
                            (128, "vandermonde"), (128, "leopard"), (256, "vandermonde"),
                            (512, "vandermonde")):
        codec = codec_for_width(k, construction)
        m = codec.field.m
        G_bits = codec_tensors(codec.generator_bits(), m, dev)["G_bits"]
        Pm, nm = G_bits.shape
        top = rand_bytes(k, 2 * k, 512)
        bottom, hashes = rs_xor.extend_leaf_digests(top, G_bits, m)
        want_bottom, want_hashes = rs_xor.extend_leaf_digests_plain(top, G_bits, m)
        e = max(max_abs_err(bottom, want_bottom), max_abs_err(hashes, want_hashes))
        table.err("rs_dense_leaf", e)
        if e:
            raise AssertionError(f"rs_dense_leaf != plain at k={k} {construction}")
        n_leaves = k * 2 * k
        for idx in rng.choice(n_leaves, min(64, n_leaves), replace=False):
            i, j = divmod(int(idx), 2 * k)
            msg = b"\x00" + b"\xff" * 29 + bottom[i, j].cpu().numpy().tobytes()
            if hashes[i, j].cpu().numpy().tobytes() != hashlib.sha256(msg).digest():
                raise AssertionError(f"rs_dense_leaf digest ({i}, {j}) != hashlib at k={k}")
        del want_bottom, want_hashes
        if k not in (128, 512) or construction != "vandermonde":
            log(f"[{card}] rs_dense_leaf k={k} m={m} {construction}: equal to plain; "
                f"{min(64, n_leaves)} digests == hashlib")
            del top, bottom, hashes, G_bits
            continue
        par_ns = parity_namespaces((n_leaves,), dev)

        def leaf():
            rs_xor.extend_leaf_digests(top, G_bits, m)

        def pair():
            b = _encode_with(rs_dense.mod2_matmul_planes, top, G_bits, m, 0)
            sha.sha256_leaves(par_ns, b.reshape(n_leaves, 512))

        reps = 5
        t_leaf = [round(cuda_ms(torch, leaf, reps), 3)]
        t_pair = [round(cuda_ms(torch, pair, reps), 3) for _ in range(2)]
        t_leaf.append(round(cuda_ms(torch, leaf, reps), 3))
        ms, pair_ms = float(np.mean(t_leaf)), float(np.mean(t_pair))
        plain_ms = cuda_ms(torch, lambda: rs_xor.extend_leaf_digests_plain(top, G_bits, m),
                           reps=1, warm=False)
        cols = 2 * k * (512 * 8 // m)
        b_ms, b_by = bound(top.numel() + Pm * nm + bottom.numel() + hashes.numel(),
                           (2.0 * Pm * nm * cols, INT8_OPS_PER_S),
                           (n_leaves * 9.0 * SHA_OPS_PER_COMPRESSION, INT32_OPS_PER_S))
        log(f"[{card}] rs_dense_leaf k={k} m={m} Pm={Pm} nm={nm} cols={cols}: kernel "
            f"{ms:.3f} ms {t_leaf} ({100 * b_ms / ms:.1f}% of bound), unfused pair (rs_dense "
            f"column phase + regroup + sha256_leaves) {pair_ms:.3f} ms {t_pair}, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}: int8 tensor operations), "
            f"equal; {min(64, n_leaves)} digests == hashlib")
        if k == 512:
            table.add("rs_dense_leaf", ms, plain_ms, b_ms, b_by)
        del top, bottom, hashes, G_bits
        torch.cuda.empty_cache()

    # The epilogue on random 0/1 generators with P != n (bands that end
    # inside a share tile, contraction stages past n, any batch-column
    # count); contiguous generators, so the wrapper pads their row strides.
    for m in (8, 16):
        for n, P, n2 in ((3, 5, 7), (17, 9, 3), (40, 24, 5)):
            G = torch.from_numpy(rng.integers(0, 2, (P * m, n * m), dtype=np.int8)).to(dev)
            top = rand_bytes(n, n2, 512)
            got = rs_xor.extend_leaf_digests(top, G, m)
            want = rs_xor.extend_leaf_digests_plain(top, G, m)
            e = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
            table.err("rs_dense_leaf", e)
            if e:
                raise AssertionError(f"rs_dense_leaf != plain on a random generator "
                                     f"n={n} P={P} n2={n2} m={m}")
    log(f"[{card}] rs_dense_leaf on random generators (n, P, 2k) = (3, 5, 7), (17, 9, 3), "
        f"(40, 24, 5) at m = 8, 16: equal to plain")


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


def profiled_spans(torch, fn, host: bool = True):
    """(wall µs, [(start µs, end µs, name)] of the device events) of one
    call of `fn` under torch.profiler, ended by a synchronize; `host=False`
    records the device activity alone (cheaper for long runs)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return wall_us, [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]


def merged(spans) -> list[tuple[float, float]]:
    """The union of [start, end) intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for start, end, *_ in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def device_breakdown(torch, fn, card: str, label: str) -> tuple[float, float] | None:
    """Device time by kernel over one call of `fn` (torch.profiler), and the
    share of the call's wall time in which the device was busy; returns the
    device busy ms and the idle share in percent (None when the profiler saw
    no device events)."""
    wall_us, spans = profiled_spans(torch, fn)
    if not spans:
        log(f"[{card}] {label}: device time not measured (the profiler saw no device events)")
        return None
    by_name: dict[str, float] = {}
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    busy = sum(b - a for a, b in merged(spans))
    log(f"[{card}] {label} under the profiler: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% of wall, idle "
        f"{100 - 100 * busy / wall_us:.1f}%)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {us / 1e3:9.3f} ms  {name[:100]}")
    return busy / 1e3, 100 - 100 * busy / wall_us


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
    for path, core in (("dense", "rs_dense"), ("xor", "rs_xor")):
        if counts[path][core] != 2:  # the row and the column phase
            raise AssertionError(f"k={k} {path}: {counts[path][core]} {core} launches per "
                                 f"extend, want 2")
    for path, row_kernel, other in (("epi", "rs_dense", "rs_xor"),
                                    ("epi_xor", "rs_xor", "rs_dense")):
        # One RS launch, the row phase's: the column phase is the epilogue's.
        got = {n: counts[path][n] for n in ("rs_dense_leaf", "sha256_leaf", row_kernel, other)}
        if got != {"rs_dense_leaf": 1, "sha256_leaf": 1, row_kernel: 1, other: 0}:
            raise AssertionError(f"k={k} {path}: launches per extend {got}, want 1 each "
                                 f"and no {other}")

    e2e = {}
    for path in PATHS:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(path)
            times.append((time.perf_counter() - t0) * 1e3)
        e2e[path] = (float(np.median(times)), times)
        if k == 512 or path == "dense":
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


def timed_calls(torch, fn, reps: int = 3) -> list[float]:
    """ms of `reps` calls of `fn`, each ended by a synchronize: host and
    device time together."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def check_launches(label: str, got: dict, want: dict) -> None:
    """Fail unless each kernel of `want` was launched that many times
    (None: at least once)."""
    for name, n in want.items():
        if (got[name] == 0) if n is None else (got[name] != n):
            raise AssertionError(f"{label}: {got[name]} {name} launches, want "
                                 f"{'at least 1' if n is None else n} ({got})")


def read_side_square(k: int):
    """The k=512 square of the read-side phases, extended on the dense path."""
    from celestia_app_tpu_torch.da import extend_shares

    ods = random_square(k, seed=k + 1)
    with environment({"CELESTIA_PIPE_FUSED": "on", "CELESTIA_RS_XOR": "off"}):
        return extend_shares([row.tobytes() for row in ods.reshape(k * k, 512)], "vandermonde")


def phase_repair(torch, eds, card: str) -> None:
    """da.repair on the card: k=512 quadrant erasures on the dense and epi
    paths, a k=64 random erasure at the threshold under both sweep modes,
    and a corrupted survivor."""
    from celestia_app_tpu_torch.da import (
        DataAvailabilityHeader, RootMismatch, extend_shares, repair,
    )
    from celestia_app_tpu_torch.kernels import _build

    k = eds.k
    n = 2 * k
    full = eds.squared()
    dah = DataAvailabilityHeader.from_eds(eds)
    base = {"CELESTIA_RS_CONSTRUCTION": "vandermonde", "CELESTIA_RS_XOR": "off"}
    # Per path and withheld quadrant: (rs_dense, rs_dense_leaf) launches of one
    # repair.  Q0: one decode sweep of k rows, then the re-extension.
    cases = (("dense", "on", "Q3", 2, 0), ("dense", "on", "Q0", 3, 0),
             ("epi", "epi", "Q3", 1, 1), ("epi", "epi", "Q0", 2, 1))
    for path, fused, quadrant, n_dense, n_leaf in cases:
        present = np.ones((n, n), dtype=bool)
        q = slice(0, k) if quadrant == "Q0" else slice(k, n)
        present[q, q] = False
        damaged = full.copy()
        damaged[q, q] = 0
        label = f"repair k={k} {quadrant} withheld, {path} path"
        with environment({**base, "CELESTIA_PIPE_FUSED": fused}):
            _build.reset_launches()
            t0 = time.perf_counter()
            out = repair(damaged, present, dah)
            torch.cuda.synchronize()
            first = (time.perf_counter() - t0) * 1e3
            counts = dict(_build.LAUNCHES)
            check_launches(label, counts, {"rs_dense": n_dense, "rs_dense_leaf": n_leaf,
                                           "rs_xor": 0, "sha256_leaf": 1, "sha256": None})
            if not torch.equal(out._eds, eds._eds):
                raise AssertionError(f"{label}: repaired EDS != original")
            if not DataAvailabilityHeader.from_eds(out).equals(dah):
                raise AssertionError(f"{label}: DAH mismatch")
            times = timed_calls(torch, lambda: repair(damaged, present, dah))
            log(f"[{card}] {label}: EDS and DAH equal; first call {first:.3f} ms (the host "
                f"solve of a new pattern included), cached {float(np.median(times)):.3f} ms (median of "
                f"{[round(t, 3) for t in times]}); launches {counts}")
            device_breakdown(torch, lambda: repair(damaged, present, dah), card, label)
        del damaged, out

    # A corrupted survivor: the recomputed codeword cannot reproduce it.
    present = np.ones((n, n), dtype=bool)
    present[k:, k:] = False
    damaged = full.copy()
    damaged[k:, k:] = 0
    damaged[0, 0, 100] ^= 0xFF
    with environment({**base, "CELESTIA_PIPE_FUSED": "on"}):
        try:
            repair(damaged, present, dah)
        except RootMismatch as e:
            log(f"[{card}] repair k={k} with a corrupted survivor: RootMismatch ({e})")
        else:
            raise AssertionError("a corrupted survivor was not rejected")
    del damaged, full

    # A random erasure at the 25 % threshold at k=64: k random rows keep k
    # random shares each (k*k of the 4k^2), so each kept row is a pattern
    # group of its own; the columns decode from those rows.  Under both
    # sweep algorithms.
    k = 64
    n = 2 * k
    ods = random_square(k, seed=64)
    with environment({**base, "CELESTIA_PIPE_FUSED": "on"}):
        small = extend_shares([row.tobytes() for row in ods.reshape(k * k, 512)], "vandermonde")
        small_dah = DataAvailabilityHeader.from_eds(small)
        rng = np.random.default_rng(64)
        present = np.zeros((n, n), dtype=bool)
        for r in rng.choice(n, k, replace=False):
            present[r, rng.choice(n, k, replace=False)] = True
        damaged = np.where(present[..., None], small.squared(), 0).astype(np.uint8)
        outs = {}
        for sweep in ("batched", "grouped"):
            with environment({"CELESTIA_REPAIR_SWEEP": sweep}):
                _build.reset_launches()
                t0 = time.perf_counter()
                outs[sweep] = repair(damaged, present, small_dah)
                torch.cuda.synchronize()
                first = (time.perf_counter() - t0) * 1e3
                counts = dict(_build.LAUNCHES)
                check_launches(f"repair k={k} random {sweep}", counts,
                               {"rs_dense": None, "sha256_leaf": 1, "sha256": None})
                times = timed_calls(torch, lambda: repair(damaged, present, small_dah))
            if not torch.equal(outs[sweep]._eds, small._eds):
                raise AssertionError(f"repair k={k} random {sweep}: EDS != original")
            log(f"[{card}] repair k={k} random erasure at the threshold "
                f"({int((~present).sum())} of {n * n} shares missing), "
                f"CELESTIA_REPAIR_SWEEP={sweep}: EDS and DAH equal; first call {first:.3f} ms, "
                f"cached {float(np.median(times)):.3f} ms (median of "
                f"{[round(t, 3) for t in times]}); {counts['rs_dense']} rs_dense launches")
        if not torch.equal(outs["batched"]._eds, outs["grouped"]._eds):
            raise AssertionError(f"repair k={k}: batched != grouped")


def _tampered(proof, what: str, rng):
    """`proof` with one byte changed in its share, its first sibling or its
    row root."""
    import dataclasses

    def flip(b: bytes, lo: int) -> bytes:
        raw = bytearray(b)
        raw[int(rng.integers(lo, len(raw)))] ^= 0xFF
        return bytes(raw)

    if what == "share":
        return dataclasses.replace(proof, data=(flip(proof.data[0], 0),))
    if what == "sibling":
        nmt = proof.share_proofs[0]
        nodes = (flip(nmt.nodes[0], 58),) + nmt.nodes[1:]  # the digest bytes
        return dataclasses.replace(proof, share_proofs=(dataclasses.replace(nmt, nodes=nodes),))
    rp = proof.row_proof
    return dataclasses.replace(
        proof, row_proof=dataclasses.replace(rp, row_roots=(flip(rp.row_roots[0], 0),)))


def phase_das(torch, eds, card: str) -> None:
    """The read side at k=512: forest, samples, verification."""
    from celestia_app_tpu_torch.kernels import _build
    from celestia_app_tpu_torch.kernels.fused import forest_level_layout, leaf_namespaces
    from celestia_app_tpu_torch.kernels.nmt import leaf_digests, tree_levels_from_digests
    from celestia_app_tpu_torch.serve import ForestCache, ProofSampler
    from celestia_app_tpu_torch.serve.verify import verify_proofs

    k = eds.k
    n = 2 * k
    cache = ForestCache(heights=1, spill=1)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    entry = cache.put(1, eds)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    forest_counts = dict(_build.LAUNCHES)
    levels = n.bit_length() - 1
    check_launches("forest build", forest_counts,
                   {"sha256_leaf": 1, "sha256": 2 * levels, "rs_dense": 0})
    forest_bytes = entry.row_flat.numel() + entry.col_flat.numel()

    # Both flat forests, level by level, against tree_levels_from_digests.
    widths, offsets = forest_level_layout(k)
    mins, maxs, hashes = leaf_digests(leaf_namespaces(eds._eds, k), eds._eds)
    axes = (("row", entry.row_flat, (mins, maxs, hashes), eds._row_roots),
            ("col", entry.col_flat, [t.transpose(0, 1).contiguous() for t in (mins, maxs, hashes)],
             eds._col_roots))
    for axis, flat, digests, roots in axes:
        for h, (m, x, hh) in enumerate(tree_levels_from_digests(*digests)):
            level = flat[offsets[h]:offsets[h] + n * widths[h]].view(n, widths[h], 90)
            if not torch.equal(level, torch.cat([m, x, hh], dim=2)):
                raise AssertionError(f"{axis} forest level {h} != tree_levels_from_digests")
        if not torch.equal(flat[offsets[-1]:], roots):
            raise AssertionError(f"{axis} forest roots != the square's roots")
    del mins, maxs, hashes, axes
    log(f"[{card}] forest k={k}: build {build_ms:.3f} ms (one put, synchronized), "
        f"{forest_bytes / 1e6:.1f} MB for both axes; every level of both forests == "
        f"tree_levels_from_digests; launches {forest_counts}")
    times = timed_calls(torch, lambda: ForestCache(heights=1, spill=1).put(2, eds))
    log(f"[{card}] forest k={k}: later puts {[round(t, 3) for t in times]} ms")
    device_breakdown(torch, lambda: ForestCache(heights=1, spill=1).put(3, eds), card,
                     f"forest put k={k}")

    sampler = ProofSampler()
    rng = np.random.default_rng(4096)
    proofs, coords_by_axis = {}, {}
    for axis in ("row", "col"):
        coords = [tuple(int(v) for v in c) for c in rng.integers(0, n, (4096, 2))]
        coords_by_axis[axis] = coords
        times = []
        for _ in range(2):  # the first fills the index-plan cache
            t0 = time.perf_counter()
            proofs[axis] = sampler.sample_batch(entry, coords, axis=axis)
            times.append(((time.perf_counter() - t0) * 1e3, dict(sampler.last_batch_s)))
        for i, (ms, parts) in enumerate(times):
            log(f"[{card}] sample_batch k={k} axis={axis} 4096 samples, call {i + 1}: "
                f"{ms:.3f} ms (gather {parts['gather'] * 1e3:.3f} ms, assemble "
                f"{parts['assemble'] * 1e3:.3f} ms)")
        for j in rng.choice(4096, 16, replace=False):
            row, col = coords[j]
            if proofs[axis][j] != sampler.host_proof(entry, row, col, axis):
                raise AssertionError(f"sample ({row}, {col}) axis={axis} != host_proof")
    queue = proofs["row"] + proofs["col"]
    log(f"[{card}] 32 of the {len(queue)} samples == host_proof byte for byte")
    device_breakdown(torch, lambda: sampler.sample_batch(entry, coords_by_axis["row"]), card,
                     f"sample_batch k={k} 4096 samples")

    for axis in ("row", "col"):
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        verdicts = verify_proofs(proofs[axis], entry.data_root)
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(_build.LAUNCHES)
        check_launches(f"verify_proofs axis={axis}", counts,
                       {"sha256_leaf": 1, "sha256": levels + 1 + levels + 1})
        if not all(verdicts):
            raise AssertionError(f"verify_proofs rejected {verdicts.count(False)} honest "
                                 f"axis={axis} samples")
        log(f"[{card}] verify_proofs 4096 axis={axis} samples: {ms:.3f} ms, all true; "
            f"launches {counts}")
    device_breakdown(torch, lambda: verify_proofs(proofs["row"], entry.data_root), card,
                     "verify_proofs 4096 samples")
    roots = [entry.data_root] * len(queue)
    bad = rng.choice(len(queue), 64, replace=False)
    for j, what in zip(bad, ("share", "sibling", "row_root", "data_root") * 16):
        if what == "data_root":
            roots[j] = bytes(32)
        else:
            queue[j] = _tampered(queue[j], what, rng)
    t0 = time.perf_counter()
    verdicts = verify_proofs(queue, roots)
    ms = (time.perf_counter() - t0) * 1e3
    rejected = sorted(i for i, ok in enumerate(verdicts) if not ok)
    if rejected != sorted(int(j) for j in bad):
        raise AssertionError(f"verify_proofs rejected {rejected[:8]}..., tampered "
                             f"{sorted(int(j) for j in bad)[:8]}...")
    log(f"[{card}] verify_proofs {len(queue)} samples with 64 tampered (16 shares, 16 "
        f"siblings, 16 row roots, 16 data roots): exactly those 64 false; {ms:.3f} ms")


def malform_seed_outside_q0(height: int, k: int, count: int) -> int:
    """The least chaos seed whose `count` malformed shares at `height` all lie
    outside the k x k data quadrant: the heal then decodes nothing and runs
    the survivor check, the re-extension and the root check only (a decode
    at k=512 solves one O(k^3) recover matrix per erasure pattern on the
    host)."""
    from celestia_app_tpu_torch.chaos.adversary import Adversary

    for seed in range(100_000):
        adv = Adversary.from_params({"seed": seed, "malform_shares": count})
        if all(r >= k or c >= k for r, c in adv.malformed_coords(height, 2 * k)):
            return seed
    raise AssertionError("no seed keeps the malformed shares out of Q0")


SERVE_SAMPLES = 256
SERVE_ATTESTATION = 64


def phase_serve(torch, eds, card: str) -> dict:
    """The DAS serving plane on the card (serve/api.py, serve/heal.py):
      1. a DasProvider over phase_das's k=512 square: SERVE_SAMPLES
         share_proof payloads per axis, 2 namespace payloads and one
         SERVE_ATTESTATION-sample attestation, each == the host lowering's
         bytes (sampler.host_proof, host trees) and verifying against the
         root (verify_proofs on the card);
      2. the adversary's drills: a withheld sample and an attestation over it
         raise ShareWithheld; malformed shares and a wrong root raise
         BadProofDetected from the verification gate, whose launches are
         counted;
      3. heals at k=512 (counts set to 0 just before each, read just after):
         malformed shares outside Q0 (the survivor check excludes them,
         repair re-extends, the root check passes, the entry is re-admitted
         healed; rs_dense, sha256_leaf and sha256 each launched; phases, peak
         memory, the malformed coordinate then served == the honest payload),
         withhold_frac=0.95 (irrecoverable, quarantined), dispatch_fail=1.0
         mid-repair (the ladder walks down and the heal completes), and a
         fault on every rung (DeviceFault past the floor: no quarantine, no
         record, the height not mid-heal); proof_fail retried twice then the
         same bytes, and on every try a DeviceFault;
      4. a k=128 ServingNode (APP_BLOCK's block) served over HTTP with
         $CELESTIA_HEAL=1: get_share_proof, get_shares_by_namespace and
         get_attestation through RemoteNode == the provider's payloads; a
         withheld sample (withhold_frac=0.25) refused with "ShareWithheld:",
         healed by the server's healer thread (one recover matrix per
         erasure pattern, on the host, then rs_dense per group), and then
         served == the honest payload.
    Returns the launches of one gated payload, one attestation and each
    heal."""
    import copy

    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.chaos import degrade
    from celestia_app_tpu_torch.device import DeviceFault
    from celestia_app_tpu_torch.kernels import _build
    from celestia_app_tpu_torch.proof.share_proof import (
        new_share_inclusion_proof,
        ods_namespace_range,
    )
    from celestia_app_tpu_torch.rpc.client import RemoteNode, RPCError
    from celestia_app_tpu_torch.rpc.codec import (
        share_proof_from_json,
        share_proofs_from_attestation,
        to_jsonable,
    )
    from celestia_app_tpu_torch.rpc.server import ServingNode, serve
    from celestia_app_tpu_torch.serve import ForestCache, heal
    from celestia_app_tpu_torch.serve.api import DasProvider, render
    from celestia_app_tpu_torch.serve.sampler import BadProofDetected, ShareWithheld
    from celestia_app_tpu_torch.serve.verify import verify_proofs

    k = eds.k
    n = 2 * k
    out: dict = {}

    def provider(height: int) -> DasProvider:
        p = DasProvider(cache=ForestCache(heights=2, spill=1))
        p.cache.put(height, eds)
        return p

    def host_payload(p, height, row, col, axis="row") -> bytes:
        entry = p._honest_entry(height)
        return render({"height": height, "row": row, "col": col, "axis": axis, "square_size": k,
                       "proof": to_jsonable(p.sampler.host_proof(entry, row, col, axis)),
                       "data_root": entry.data_root.hex()})

    # 1. Payloads == the host lowering's bytes, and verifying on the card.
    prov = provider(1)
    entry = prov.entry(1)
    root = entry.data_root
    rng = np.random.default_rng(515)
    for axis in ("row", "col"):
        coords = [tuple(int(v) for v in c) for c in rng.integers(0, n, (SERVE_SAMPLES, 2))]
        _build.reset_launches()
        t0 = time.perf_counter()
        payloads = [prov.share_proof_payload(1, r, c, axis=axis) for r, c in coords]
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(_build.LAUNCHES)
        for (r, c), payload in zip(coords, payloads):
            if render(payload) != host_payload(prov, 1, r, c, axis):
                raise AssertionError(f"share_proof ({r}, {c}) axis={axis} != the host lowering")
        proofs = [share_proof_from_json(p["proof"]) for p in payloads]
        if not all(verify_proofs(proofs, root)):
            raise AssertionError(f"a served axis={axis} share_proof does not verify")
        log(f"[{card}] serve k={k}: {SERVE_SAMPLES} share_proof payloads axis={axis} in "
            f"{ms:.3f} ms ({ms / SERVE_SAMPLES:.3f} ms each, ungated: launches {counts}); each "
            f"== the host lowering's bytes, all verify on the card")
    ods_ns = eds.ods_namespaces()
    for i in (3 * k + 5, (k - 7) * k + 17 % k):
        ns = ods_ns[i].tobytes()
        payload = prov.shares_payload(1, ns.hex())
        lo, hi = ods_namespace_range(eds, ns)
        host_eds = copy.copy(eds)  # no forest: the proof from host trees
        host_eds._forest, host_eds._tree_memo = None, {}
        want = to_jsonable(new_share_inclusion_proof(host_eds, lo, hi))
        if not payload["found"] or payload["proof"] != want or \
                not share_proof_from_json(payload["proof"]).verify(root):
            raise AssertionError(f"namespace {ns.hex()} payload != the host lowering or unverified")
    log(f"[{card}] serve k={k}: 2 namespace payloads == the host trees' proofs, verified")
    samples = sorted({(int(r), int(c), str(a)) for (r, c), a in zip(
        rng.integers(0, n, (SERVE_ATTESTATION, 2)), rng.choice(["row", "col"], SERVE_ATTESTATION))})
    spec = ",".join(f"{r}:{c}:{a}" for r, c, a in samples)
    _build.reset_launches()
    t0 = time.perf_counter()
    att = prov.attestation_payload(1, spec)
    ms = (time.perf_counter() - t0) * 1e3
    rebuilt = share_proofs_from_attestation(att)
    for s, proof in zip(att["samples"], rebuilt):
        if proof != prov.sampler.host_proof(entry, s["row"], s["col"], s["axis"]):
            raise AssertionError(f"attestation sample {s} != the host lowering")
    if len(rebuilt) != len(samples) or not all(verify_proofs(rebuilt, root)):
        raise AssertionError("the attestation's proofs do not verify")
    with environment({"CELESTIA_SERVE_VERIFY": "1"}):  # the gate armed on honest state
        _build.reset_launches()
        prov.share_proof_payload(1, 3, n - 5)
        out["gated payload"] = dict(_build.LAUNCHES)
        _build.reset_launches()
        t1 = time.perf_counter()
        prov.attestation_payload(1, spec)
        gated_ms = (time.perf_counter() - t1) * 1e3
        out["gated attestation"] = dict(_build.LAUNCHES)
    check_launches("gated share_proof", out["gated payload"], {"sha256_leaf": 1, "sha256": None})
    check_launches("gated attestation", out["gated attestation"],
                   {"sha256_leaf": None, "sha256": None})
    log(f"[{card}] serve k={k}: under CELESTIA_SERVE_VERIFY=1 a share_proof launches "
        f"{out['gated payload']}, the attestation {out['gated attestation']} in {gated_ms:.3f} ms")
    log(f"[{card}] serve k={k}: attestation of {len(samples)} samples in {ms:.3f} ms, "
        f"{len(render(att))} bytes (the {len(samples)} share_proof payloads: "
        f"{sum(len(host_payload(prov, 1, s['row'], s['col'], s['axis'])) for s in att['samples'])}"
        f" bytes); each sample == the host lowering, all verify")

    # 2. The adversary's refusals and the gate's launches.
    try:
        chaos.install("seed=31,withhold_frac=0.25")
        r, c = sorted(chaos.active_adversary().withheld_set(1, n))[0]
        for call in (lambda: prov.share_proof_payload(1, r, c),
                     lambda: prov.attestation_payload(1, f"0:0,{r}:{c}")):
            try:
                call()
            except ShareWithheld:
                continue
            raise AssertionError(f"withheld ({r}, {c}) was served")
        for spec_ in (f"seed={malform_seed_outside_q0(1, k, 4)},malform_shares=4",
                      "seed=13,wrong_root=1"):
            chaos.install(spec_)
            adv = chaos.active_adversary()
            target = (adv.malformed_coords(1, n) or [(5, 7)])[0]
            _build.reset_launches()
            try:
                prov.share_proof_payload(1, *target)
            except BadProofDetected:
                counts = dict(_build.LAUNCHES)
            else:
                raise AssertionError(f"{spec_}: a tampered payload was served")
            check_launches(f"verification gate ({spec_})", counts,
                           {"sha256_leaf": 1, "sha256": None})
            log(f"[{card}] serve k={k}: {spec_}: the gate refused the payload "
                f"(BadProofDetected), launches {counts}")
        log(f"[{card}] serve k={k}: withheld sample and attestation refused (ShareWithheld)")
    finally:
        chaos.uninstall()

    # 3. Heals at k=512.
    def heal_drill(label: str, spec_: str, height: int, want: str, expect=None):
        p = provider(height)
        engine = heal.HealingEngine(p, name=f"serve-{height}", backoff_s=0.0)
        try:
            chaos.install(spec_)
            adv = chaos.active_adversary()
            target = (sorted(adv.withheld_set(height, n))[0] if adv.withhold_frac
                      else adv.malformed_coords(height, n)[0])
            honest = host_payload(p, height, *target)
            try:
                p.share_proof_payload(height, *target)
            except (ShareWithheld, BadProofDetected):
                pass
            else:
                raise AssertionError(f"{label}: the attacked sample was served")
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            t0 = time.perf_counter()
            try:
                result = engine.process_pending()
            except DeviceFault as e:
                result = [(height, "DeviceFault")]
                log(f"[{card}] {label}: DeviceFault out of process_pending ({str(e)[:120]})")
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counts = dict(_build.LAUNCHES)
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            state = engine.state()
            if result != [(height, want)]:
                raise AssertionError(f"{label}: {result}, want {want} ({state})")
            if expect is not None:
                check_launches(label, counts, expect)
            chaos.uninstall()
            if want == "healed":
                served = render(p.share_proof_payload(height, *target))
                if served != honest:
                    raise AssertionError(f"{label}: the healed coordinate != the honest payload")
            elif want == "DeviceFault":
                if state["healing"] or state["quarantined_total"] or state["last"] is not None:
                    raise AssertionError(f"{label}: a device fault left a verdict: {state}")
            elif not engine.is_quarantined(height):
                raise AssertionError(f"{label}: not quarantined ({state})")
            last = state["last"] or {}
            log(f"[{card}] {label}: {want} in {wall:.3f} ms (phases {last.get('phases_ms')}, "
                f"attempts {last.get('attempts')}); launches {counts}; peak "
                f"{peak:.3f} GB above the {base / 1e9:.3f} GB allocated; ladder "
                f"{degrade.degraded_state()}")
            return counts
        finally:
            chaos.uninstall()
            engine.close()
            degrade.reset_for_tests()

    tamper = f"seed={malform_seed_outside_q0(2, k, 4)},malform_shares=4"
    out[f"heal k={k}"] = heal_drill(
        f"heal k={k}, 4 malformed shares outside Q0", tamper, 2, "healed",
        {"rs_dense": None, "sha256_leaf": None, "sha256": None})
    heal_drill(f"heal k={k}, withhold_frac=0.95", "seed=7,withhold_frac=0.95", 3,
               "irrecoverable", {"rs_dense": 0})
    heal_drill(f"heal k={k} with dispatch_fail=1.0 mid-repair",
               f"seed={malform_seed_outside_q0(4, k, 4)},malform_shares=4,dispatch_fail=1.0", 4,
               "healed", {"rs_dense": None, "sha256_leaf": None, "sha256": None})
    heal_drill(f"heal k={k} with a fault on every rung",
               f"seed={malform_seed_outside_q0(5, k, 4)},malform_shares=4,dispatch_fail=1.0,"
               f"dispatch_fail_all=1", 5, "DeviceFault")
    # proof_fail: two failed tries, then the same bytes; on every try a fault.
    seam_seed = trip_once_seed("proof.serve", 2)
    r, c = 9, n - 3
    honest = render(prov.share_proof_payload(1, r, c))
    retried0 = counter_value("celestia_recoveries_total", seam="proof.serve", outcome="retried")
    try:
        chaos.install(f"seed={seam_seed},proof_fail=0.5")
        if render(prov.share_proof_payload(1, r, c)) != honest:
            raise AssertionError("a retried share_proof != the honest payload")
        retried = counter_value("celestia_recoveries_total", seam="proof.serve",
                                outcome="retried") - retried0
        chaos.install("seed=1,proof_fail=1.0")
        try:
            prov.share_proof_payload(1, r, c)
        except DeviceFault:
            pass
        else:
            raise AssertionError("proof_fail=1.0 was answered")
    finally:
        chaos.uninstall()
    log(f"[{card}] serve k={k}: proof_fail retried {retried:g} times then == the honest "
        f"payload; on every try DeviceFault after {degrade.DEFAULT_THRESHOLD} retries")
    del prov, entry

    # 4. A k=128 ServingNode over HTTP with its healer.
    from celestia_app_tpu_torch.testutil import deterministic_genesis, funded_keys
    from celestia_app_tpu_torch.testutil.blocks import block_txs

    keys = funded_keys(APP_BLOCK["n_keys"])
    genesis = deterministic_genesis(keys, n_validators=1, gov_max_square_size=APP_K)
    txs = block_txs(keys, genesis.chain_id, seed=APP_BLOCK["seed"], sends=APP_BLOCK["sends"],
                    pfbs=APP_BLOCK["pfbs"], blob_shares=APP_BLOCK["blob_shares"])
    node = ServingNode(genesis=genesis, keys=keys, n_validators=1)
    t0 = time.perf_counter()
    for raw in txs:
        node.broadcast(raw, relay=False)
    node.produce_block()
    log(f"[{card}] serve node: {len(txs)} txs broadcast and one height produced in "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    with environment({"CELESTIA_HEAL": "1"}):
        server = serve(node, port=0, block_interval_s=None)
    try:
        remote = RemoteNode(server.url)
        nprov = node.das_provider()
        nk = nprov.entry(1).k
        if nk != APP_K:
            raise AssertionError(f"the node's block is k={nk}, want {APP_K}")
        nn = 2 * nk
        ns = nprov.entry(1).eds.ods_namespaces()[nk * nk // 2].tobytes().hex()
        att_spec = ",".join(f"{i}:{(7 * i) % nn}:{'col' if i % 2 else 'row'}" for i in range(16))
        calls = (("get_share_proof", {"height": 1, "row": 3, "col": nn - 2, "axis": "col"},
                  lambda: nprov.share_proof_payload(1, 3, nn - 2, axis="col")),
                 ("get_shares_by_namespace", {"height": 1, "namespace": ns},
                  lambda: nprov.shares_payload(1, ns)),
                 ("get_attestation", {"height": 1, "samples": att_spec},
                  lambda: nprov.attestation_payload(1, att_spec)))
        for method, params, direct in calls:
            t0 = time.perf_counter()
            got = remote.call(method, **params)
            ms = (time.perf_counter() - t0) * 1e3
            if render(got) != render(direct()):
                raise AssertionError(f"{method} over HTTP != the provider's payload")
            log(f"[{card}] serve node k={nk}: {method} over HTTP {ms:.3f} ms, == the provider")
        chaos.install("seed=31,withhold_frac=0.25")
        r, c = sorted(chaos.active_adversary().withheld_set(1, nn))[0]
        engine = server._healer
        _build.reset_launches()
        t0 = time.perf_counter()
        try:
            remote.call("get_share_proof", height=1, row=r, col=c)
        except RPCError as e:
            if not str(e).startswith("ShareWithheld: "):
                raise
        else:
            raise AssertionError("a withheld sample was served over HTTP")
        deadline = time.monotonic() + 120
        while engine.state()["healed"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        heal_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(_build.LAUNCHES)
        state = engine.state()
        if state["healed"] != 1:
            raise AssertionError(f"the node's healer did not heal: {state}")
        check_launches(f"node heal k={nk}", counts,
                       {"rs_dense": None, "sha256_leaf": None, "sha256": None})
        out[f"heal k={nk}, withhold_frac=0.25"] = counts
        healed = remote.call("get_share_proof", height=1, row=r, col=c)
        chaos.uninstall()
        nprov.cache.reset_for_tests()  # the next answer is rebuilt from the block store
        honest_payload = remote.call("get_share_proof", height=1, row=r, col=c)
        if render(healed) != render(honest_payload):
            raise AssertionError("the healed coordinate != the honest payload")
        log(f"[{card}] serve node k={nk}: withheld ({r}, {c}) refused over HTTP, healed by the "
            f"server's healer in {heal_ms:.3f} ms from the detection (phases "
            f"{state['last']['phases_ms']}), launches {counts}; then served == the honest "
            f"payload")
    finally:
        chaos.uninstall()
        server.stop()
        degrade.reset_for_tests()
    if heal.engines():
        raise AssertionError(f"a healer outlived its server: {heal.engines()}")
    return out


OPS_SAMPLES = 64
OPS_ATTESTATION = 64
OPS_SNAPSHOT_INTERVAL = 4
OPS_HEIGHTS = 10
OPS_LAST_SNAPSHOT = OPS_HEIGHTS // OPS_SNAPSHOT_INTERVAL * OPS_SNAPSHOT_INTERVAL
OPS_DEVNET = 3
OPS_DEVNET_HEIGHT = 3


def http_get(url: str) -> tuple[int, dict, bytes]:
    """(status, headers, body) of one GET; an HTTP error status is returned,
    not raised."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def ops_chain_txs(node, keys, height: int) -> list[bytes]:
    """The txs of `node`'s next height: none at odd heights; at even ones
    APP_BLOCK's sends, with its PFBs too (a k=128 block, as phase_chain
    builds them) only past the last snapshot, where the catch-up runs it."""
    from celestia_app_tpu_torch.testutil.blocks import block_txs, next_sequences

    if height % 2:
        return []
    return block_txs(keys, node.app.chain_id, seed=APP_BLOCK["seed"] + height,
                     sends=APP_BLOCK["sends"],
                     pfbs=APP_BLOCK["pfbs"] if height > OPS_LAST_SNAPSHOT else 0,
                     blob_shares=APP_BLOCK["blob_shares"],
                     sequences=next_sequences(node.app, keys))


def phase_ops(torch, eds, card: str) -> dict:
    """The node's operator plane on the card (trace/exposition.py,
    trace/fleet.py, rpc/server.py's GET face and state sync, rpc/devnet.py):
      1. the GET surface at k=512: a DasProvider over phase_das's square,
         registered with the exposition and mounted by serve_observability;
         OPS_SAMPLES GET /das/share_proof per axis, 2 GET /das/shares and one
         OPS_ATTESTATION-sample GET /das/attestation over HTTP, each body ==
         render() of the provider's payload and == the host lowering's bytes,
         verifying against the root on the card; ms per GET; the launches of
         one gated GET ($CELESTIA_SERVE_VERIFY=1); /device reads
         device_memory_stats with a nonzero peak and the serve_forest_cache
         owner, /healthz says SERVING, /metrics parses through
         fleet.parse_prometheus_text and counts the GETs; under proof_fail=1.0
         a GET answers 500 naming DeviceFault;
      2. state sync at k=APP_K: a source ServingNode on the card with
         snapshot_interval=OPS_SNAPSHOT_INTERVAL commits OPS_HEIGHTS heights
         on APP_BLOCK's 256-key genesis, sends at the even heights, the even
         ones past the last snapshot APP_BLOCK's k=128 blocks; with its serve
         cache emptied and every rung faulted, GET /das of height 2 (not
         the App's last square, so the GET extends it again) over its HTTP
         answers 500 naming DeviceFault and /healthz then says DEGRADED; a joiner on the card syncs (fetch, restore, verify,
         catch-up timed apart; the rest is the metadata check) and its
         catch-up launches rs_dense, sha256_leaf and sha256 (counted per tail
         block); its app hash == the source's == a CPU TestNode's replay; it
         produces one more height, which the source applies to the same app
         hash; a tampered chunk and a forged minter are refused;
      3. the fleet: GET /fleet over the source, the joiner and a stopped URL:
         2 reachable hosts, each with a device block (device_memory_stats),
         the dead one marked;
      4. the devnet: spawn_devnet(OPS_DEVNET) validator processes on the card
         after the parent's one build, run to height >= OPS_DEVNET_HEIGHT,
         then a send broadcast to validator 0 and committed: equal blocks
         and Commit-attested app hashes across the three, each child's
         /device from device_memory_stats, /fleet over them 3 reachable
         hosts; each child's own launches across the send's height (from
         the reports in its log) include rs_dense, sha256_leaf and sha256; a
         child that dies fails the phase with its log.
    Returns the launches of one gated GET, per catch-up block and, per
    child, across the devnet height that holds the send."""
    import copy
    import urllib.parse

    from celestia_app_tpu_torch import chaos, consensus
    from celestia_app_tpu_torch.chaos import degrade
    from celestia_app_tpu_torch.kernels import _build
    from celestia_app_tpu_torch.proof.share_proof import (
        new_share_inclusion_proof,
        ods_namespace_range,
    )
    from celestia_app_tpu_torch.rpc import devnet
    from celestia_app_tpu_torch.rpc.client import RemoteNode
    from celestia_app_tpu_torch.rpc.codec import (
        share_proof_from_json,
        share_proofs_from_attestation,
        to_jsonable,
    )
    from celestia_app_tpu_torch.rpc.server import ServingNode, serve
    from celestia_app_tpu_torch.serve import ForestCache
    from celestia_app_tpu_torch.serve.api import DasProvider, render
    from celestia_app_tpu_torch.serve.verify import verify_proofs
    from celestia_app_tpu_torch.state.store import CommitStore
    from celestia_app_tpu_torch.testutil import TestNode, deterministic_genesis, funded_keys
    from celestia_app_tpu_torch.testutil.blocks import block_txs
    from celestia_app_tpu_torch.trace import exposition, fleet
    from celestia_app_tpu_torch.tx import tx_hash

    k = eds.k
    n = 2 * k
    out: dict = {}

    # 1. The GET surface at k=512.
    prov = DasProvider(cache=ForestCache(heights=2, spill=1))
    prov.cache.put(1, eds)
    entry = prov.entry(1)
    root = entry.data_root
    exposition.register_das_provider(prov)
    obs = exposition.serve_observability(node_id="ops")
    try:
        def host_payload(row, col, axis):
            return render({"height": 1, "row": row, "col": col, "axis": axis, "square_size": k,
                           "proof": to_jsonable(prov.sampler.host_proof(entry, row, col, axis)),
                           "data_root": root.hex()})

        rng = np.random.default_rng(516)
        served = 0
        for axis in ("row", "col"):
            coords = [tuple(int(v) for v in c) for c in rng.integers(0, n, (OPS_SAMPLES, 2))]
            bodies, ms = [], []
            for r, c in coords:
                t0 = time.perf_counter()
                status, _, body = http_get(
                    f"{obs.url}/das/share_proof?height=1&row={r}&col={c}&axis={axis}")
                ms.append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    raise AssertionError(f"GET share_proof ({r}, {c}) {axis}: {status} {body[:200]}")
                bodies.append(body)
            served += len(coords)
            for (r, c), body in zip(coords, bodies):
                if body != render(prov.share_proof_payload(1, r, c, axis=axis)) or \
                        body != host_payload(r, c, axis):
                    raise AssertionError(f"GET share_proof ({r}, {c}) axis={axis} != the "
                                         f"provider's render or the host lowering")
            proofs = [share_proof_from_json(json.loads(b)["proof"]) for b in bodies]
            if not all(verify_proofs(proofs, root)):
                raise AssertionError(f"a GET share_proof axis={axis} does not verify")
            log(f"[{card}] ops k={k}: {OPS_SAMPLES} GET /das/share_proof axis={axis} over HTTP, "
                f"median {float(np.median(ms)):.3f} ms, min {min(ms):.3f}, max {max(ms):.3f} "
                f"ms per GET; each body == the provider's render == the host lowering's bytes, "
                f"all verify on the card")
        ods_ns = eds.ods_namespaces()
        for i in (3 * k + 5, (k - 7) * k + 17):
            ns = ods_ns[i].tobytes()
            t0 = time.perf_counter()
            status, _, body = http_get(f"{obs.url}/das/shares?height=1&namespace={ns.hex()}")
            ms = (time.perf_counter() - t0) * 1e3
            served += 1
            payload = json.loads(body)
            lo, hi = ods_namespace_range(eds, ns)
            host_eds = copy.copy(eds)  # no forest: the proof from host trees
            host_eds._forest, host_eds._tree_memo = None, {}
            if status != 200 or body != render(prov.shares_payload(1, ns.hex())) or \
                    payload["proof"] != to_jsonable(new_share_inclusion_proof(host_eds, lo, hi)) \
                    or not share_proof_from_json(payload["proof"]).verify(root):
                raise AssertionError(f"GET /das/shares {ns.hex()}: {status}, != the host trees' "
                                     f"proof or unverified")
            log(f"[{card}] ops k={k}: GET /das/shares {len(body)} bytes in {ms:.3f} ms == the "
                f"host trees' proof, verified")
        samples = sorted({(int(r), int(c), str(a)) for (r, c), a in zip(
            rng.integers(0, n, (OPS_ATTESTATION, 2)),
            rng.choice(["row", "col"], OPS_ATTESTATION))})
        spec = ",".join(f"{r}:{c}:{a}" for r, c, a in samples)
        t0 = time.perf_counter()
        status, _, body = http_get(f"{obs.url}/das/attestation?height=1&"
                                   f"samples={urllib.parse.quote(spec)}")
        ms = (time.perf_counter() - t0) * 1e3
        served += 1
        att = json.loads(body)
        rebuilt = share_proofs_from_attestation(att)
        if status != 200 or body != render(prov.attestation_payload(1, spec)):
            raise AssertionError(f"GET /das/attestation: {status}, != the provider's render")
        for s, proof in zip(att["samples"], rebuilt):
            if proof != prov.sampler.host_proof(entry, s["row"], s["col"], s["axis"]):
                raise AssertionError(f"GET /das/attestation sample {s} != the host lowering")
        if len(rebuilt) != len(samples) or not all(verify_proofs(rebuilt, root)):
            raise AssertionError("the GET attestation's proofs do not verify")
        log(f"[{card}] ops k={k}: GET /das/attestation of {len(samples)} samples, "
            f"{len(body)} bytes in {ms:.3f} ms; each sample == the host lowering, all verify")
        with environment({"CELESTIA_SERVE_VERIFY": "1"}):
            gated = []
            for r, c in ((3, n - 5), (n - 9, 11), (k, k)):
                _build.reset_launches()
                t0 = time.perf_counter()
                status, _, body = http_get(f"{obs.url}/das/share_proof?height=1&row={r}&col={c}")
                gated.append((time.perf_counter() - t0) * 1e3)
                served += 1
                out["gated GET"] = dict(_build.LAUNCHES)
                if status != 200 or body != host_payload(r, c, "row"):
                    raise AssertionError(f"gated GET ({r}, {c}): {status}, != the host lowering")
                check_launches("gated GET", out["gated GET"], {"sha256_leaf": 1, "sha256": None})
        log(f"[{card}] ops k={k}: under CELESTIA_SERVE_VERIFY=1 a GET /das/share_proof launches "
            f"{out['gated GET']} in {[round(v, 3) for v in gated]} ms")
        status, _, body = http_get(f"{obs.url}/device")
        dev = json.loads(body)
        own = dev["ownership"]
        if status != 200 or own["measured_source"] != "device_memory_stats" or \
                own["measured_bytes"] <= 0 or "serve_forest_cache" not in own["owners"]:
            raise AssertionError(f"GET /device: {status} {own}")
        status, _, body = http_get(f"{obs.url}/healthz")
        if status != 200 or json.loads(body)["status"] != "SERVING":
            raise AssertionError(f"GET /healthz: {status} {body[:300]}")
        status, headers, body = http_get(f"{obs.url}/metrics")
        kinds, scalars, _ = fleet.parse_prometheus_text(body.decode())
        counted = sum(v for key, v in scalars.get("celestia_proofs_served_total", {}).items()
                      if dict(key).get("plane") == "rest")
        if status != 200 or kinds.get("celestia_proofs_served_total") != "counter" or \
                counted < served:
            raise AssertionError(f"GET /metrics: {status}, {counted} proofs counted on the "
                                 f"rest plane for {served} GETs")
        log(f"[{card}] ops: GET /device measured_source device_memory_stats, peak "
            f"{own['measured_bytes'] / 1e9:.3f} GB, owners {own['owners']}; /healthz SERVING; "
            f"/metrics {len(body)} bytes, {len(kinds)} families, {counted:g} proofs served")
        try:
            chaos.install("seed=1,proof_fail=1.0")
            status, _, body = http_get(f"{obs.url}/das/share_proof?height=1&row=9&col={n - 3}")
        finally:
            chaos.uninstall()
        if status != 500 or not json.loads(body)["error"].startswith("DeviceFault: "):
            raise AssertionError(f"GET under proof_fail=1.0: {status} {body[:200]}")
        log(f"[{card}] ops: under proof_fail=1.0 GET /das/share_proof answers {status} "
            f"({json.loads(body)['error'][:100]}...)")
    finally:
        obs.stop()
        exposition.unregister_das_provider(prov)
    del prov, entry

    # 2. State sync at k=APP_K.
    keys = funded_keys(APP_BLOCK["n_keys"])
    genesis = deterministic_genesis(keys, n_validators=1, gov_max_square_size=APP_K)
    source = ServingNode(genesis=genesis, keys=keys, snapshot_interval=OPS_SNAPSHOT_INTERVAL)
    src_server = serve(source, port=0, block_interval_s=None)
    servers = [src_server]
    try:
        t0 = time.perf_counter()
        for h in range(1, OPS_HEIGHTS + 1):
            for raw in ops_chain_txs(source, keys, h):
                source.broadcast(raw, relay=False)
            data, results = source.produce_block()
            big = h % 2 == 0 and h > OPS_LAST_SNAPSHOT
            if (data.square_size == APP_K) != big or any(r.code for r in results):
                raise AssertionError(f"source height {h}: k={data.square_size}, codes "
                                     f"{sorted({r.code for r in results})}")
        log(f"[{card}] ops: source chain of {OPS_HEIGHTS} heights (sends at the even ones, "
            f"k={APP_K} at the even ones past {OPS_LAST_SNAPSHOT}) "
            f"in {time.perf_counter() - t0:.3f} s; snapshots at "
            f"{[m['height'] for m in source.rpc_snapshots()]}")
        # A rebuild under a fault on every rung: 500 naming DeviceFault, and
        # the probe shows the stepped-down ladder.
        source.das_provider().cache.reset_for_tests()
        try:
            chaos.install("seed=1,dispatch_fail=1.0,dispatch_fail_all=1")
            status, _, body = http_get(f"{src_server.url}/das/share_proof?height=2&row=0&col=0")
            health = json.loads(http_get(f"{src_server.url}/healthz")[2])
        finally:
            chaos.uninstall()
            degrade.reset_for_tests()
        if status != 500 or not json.loads(body)["error"].startswith("DeviceFault: ") or \
                health["status"] != "DEGRADED":
            raise AssertionError(f"GET rebuild under dispatch_fail_all: {status} {body[:200]}, "
                                 f"/healthz {health.get('status')} {health.get('degraded')}")
        log(f"[{card}] ops: a GET rebuild with every rung faulted answers 500 (DeviceFault), "
            f"then /healthz {health['status']} {health['degraded']}")
        meta = source.rpc_snapshots()[-1]
        snap_bytes = sum(len(c) for c in source._snapshots[meta["height"]]["chunks"])

        joiner = ServingNode(genesis=genesis, keys=keys)
        split = Split([(RemoteNode, "snapshots", "fetch"), (RemoteNode, "snapshot_chunk", "fetch"),
                       (CommitStore, "load_height", "restore"),
                       (consensus, "verify_commit", "verify"),
                       (ServingNode, "_catch_up", "catch-up")])
        per_block: dict = {}
        apply_block = ServingNode.apply_block

        def counted_apply(self, height, *args, **kwargs):
            torch.cuda.synchronize()
            before = dict(_build.LAUNCHES)
            try:
                return apply_block(self, height, *args, **kwargs)
            finally:
                torch.cuda.synchronize()
                per_block[height] = {name: _build.LAUNCHES[name] - before[name] for name in before}

        torch.cuda.synchronize()
        _build.reset_launches()
        with split.timing(), swapped(ServingNode, "apply_block", counted_apply):
            t0 = time.perf_counter()
            joined = joiner.state_sync_from(src_server.url)
            torch.cuda.synchronize()
            sync_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(_build.LAUNCHES)
        check_launches("state-sync catch-up", counts,
                       {"rs_dense": None, "sha256_leaf": None, "sha256": None})
        tall = [h for h in per_block if h % 2 == 0]
        for h in tall:
            check_launches(f"catch-up block {h}", per_block[h],
                           {"rs_dense": None, "sha256_leaf": None, "sha256": None})
        out["catch-up block"] = per_block[tall[0]]
        if joined != meta["height"] or joiner.app.height != source.app.height or \
                joiner.app.cms.last_app_hash != source.app.cms.last_app_hash:
            raise AssertionError(f"joiner: joined {joined}, height {joiner.app.height}, app hash "
                                 f"{joiner.app.cms.last_app_hash.hex()} != the source's "
                                 f"{source.app.cms.last_app_hash.hex()}")
        t0 = time.perf_counter()
        replay = TestNode(genesis, keys, device="cpu")
        replayed = replay_heights(replay, source, source.app.height, ServingNode._parse_evidence)
        replay_s = time.perf_counter() - t0
        if replayed[-1] != joiner.app.cms.last_app_hash:
            raise AssertionError(f"the CPU replay's app hash {replayed[-1].hex()} != the joiner's")
        check_ms = sync_ms - sum(split.ms.values())
        log(f"[{card}] ops: snapshot at {meta['height']}: {snap_bytes} bytes in "
            f"{len(meta['chunk_hashes'])} chunks; a joiner on the card synced in {sync_ms:.3f} ms "
            f"({', '.join(f'{key} {v:.3f}' for key, v in split.ms.items())}, the metadata check "
            f"{check_ms:.3f} ms) to height "
            f"{joiner.app.height}, app hash {joiner.app.cms.last_app_hash.hex()} == the source's "
            f"== a CPU TestNode's replay ({replay_s:.3f} s); catch-up launches {counts}, per "
            f"block {per_block}")
        joiner.produce_block()
        if joiner.app.height != OPS_HEIGHTS + 1 or source.app.height != OPS_HEIGHTS + 1 or \
                joiner.app.cms.last_app_hash != source.app.cms.last_app_hash:
            raise AssertionError(f"the joiner's own height: joiner {joiner.app.height}, source "
                                 f"{source.app.height}, app hashes differ")
        def forge_minter(snap):
            snap["minter"]["annual_provisions"] = str(2 * int(snap["minter"]["annual_provisions"]))

        def tamper_chunk(snap):
            snap["chunks"][0] = b'{"deadbeef":"ff"}'

        for what, tamper, error, message in (
                ("a tampered chunk", tamper_chunk, ValueError, "chunk 0 hash mismatch"),
                ("a forged minter", forge_minter, consensus.ConsensusError, "does not attest height")):
            with source.lock:
                saved = copy.deepcopy(source._snapshots)
                tamper(source._snapshots[meta["height"]])
            try:
                ServingNode(genesis=genesis, keys=keys).state_sync_from(src_server.url)
            except error as e:
                if message not in str(e):
                    raise
            else:
                raise AssertionError(f"{what} was restored")
            finally:
                with source.lock:
                    source._snapshots = saved
        log(f"[{card}] ops: the joiner produced height {joiner.app.height}, applied by the source "
            f"to the same app hash; a tampered chunk refused (chunk 0 hash mismatch), a forged "
            f"minter refused (the Commit two heights past the snapshot)")

        # 3. The fleet over the source, the joiner and a stopped URL.
        servers.append(serve(joiner, port=0, block_interval_s=None))
        dead = f"http://127.0.0.1:{devnet.free_ports(1)[0]}"
        urls = [src_server.url, servers[1].url, dead]
        fleet.configure(urls, interval_s=3600)
        try:
            t0 = time.perf_counter()
            status, _, body = http_get(f"{servers[1].url}/fleet")
            fleet_ms = (time.perf_counter() - t0) * 1e3
        finally:
            fleet._reset_for_tests()
        merged = json.loads(body)
        hosts = merged["hosts"]
        if status != 200 or merged["fleet"]["hosts_reachable"] != 2 or \
                not hosts[dead]["peer_unreachable"] or \
                any(hosts[u].get("device", {}).get("measured_bytes", 0) <= 0 for u in urls[:2]):
            raise AssertionError(f"GET /fleet: {status} {body[:400]}")
        for u in urls[:2]:
            src = json.loads(http_get(f"{u}/device")[2])["ownership"]["measured_source"]
            if src != "device_memory_stats":
                raise AssertionError(f"{u}/device measured_source {src}")
        log(f"[{card}] ops: GET /fleet over 3 URLs in {fleet_ms:.3f} ms: 2 reachable, each "
            f"device block from device_memory_stats ({hosts[urls[0]]['device']}); the stopped "
            f"one marked ({hosts[dead]['error'][:80]})")
    finally:
        for s in servers:
            s.stop()
        degrade.reset_for_tests()

    # 4. The devnet: validator processes on the card.
    t0 = time.perf_counter()
    net = devnet.spawn_devnet(OPS_DEVNET, block_interval_ms=300, wait_s=300)
    up_s = time.perf_counter() - t0
    try:
        deadline = time.monotonic() + 120
        while True:
            net.check()
            heights = [net.client(i).status()["height"] for i in range(OPS_DEVNET)]
            if min(heights) >= OPS_DEVNET_HEIGHT:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"devnet heights {heights}")
            time.sleep(0.2)
        run_s = time.perf_counter() - t0 - up_s
        # One send, so that a devnet height holds a square of its own: each
        # child's launches across that height, from the reports in its log.
        dkeys = funded_keys(4)
        raw = block_txs(dkeys, net.client(0).chain_id, seed=OPS_DEVNET, sends=1, pfbs=0)[0]
        if net.client(0).broadcast(raw).code != 0:
            raise AssertionError("the devnet refused the send")
        landed = net.client(0).wait_tx(tx_hash(raw), timeout_s=60)
        if landed is None or landed[1] != 0:
            raise AssertionError(f"the devnet's send: {landed}")
        h_tx = landed[0]
        deadline = time.monotonic() + 60
        while True:
            net.check()
            reports = [net.launches(i) for i in range(OPS_DEVNET)]
            if all(r and r[-1][0] >= h_tx for r in reports):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"devnet launch reports short of height {h_tx}")
            time.sleep(0.2)
        spans = [net.launches_across(i, h_tx) for i in range(OPS_DEVNET)]
        for i, (lo, hi, counts) in enumerate(spans):
            check_launches(f"devnet validator {i}, heights {lo}..{hi}", counts,
                           {"rs_dense": None, "sha256_leaf": None, "sha256": None})
        out["devnet height"] = [counts for _, _, counts in spans]
        top = min(net.client(i).status()["height"] for i in range(OPS_DEVNET))
        clients = [net.client(i) for i in range(OPS_DEVNET)]
        blocks = [[c.block(h)["data_hash"] for h in range(1, top + 1)] for c in clients]
        attested = [[c.commit(h + 1).prev_app_hash.hex() for h in range(1, top)]
                    for c in clients]
        if any(b != blocks[0] for b in blocks) or any(a != attested[0] for a in attested):
            raise AssertionError(f"devnet blocks or app hashes differ: {attested}")
        for u in net.urls:
            src = json.loads(http_get(f"{u}/device")[2])["ownership"]["measured_source"]
            if src != "device_memory_stats":
                raise AssertionError(f"devnet {u}/device measured_source {src}")
        fleet.configure(net.urls, interval_s=3600)
        try:
            merged = json.loads(exposition.handle_observability_get("/fleet")[2])
        finally:
            fleet._reset_for_tests()
        if merged["fleet"]["hosts_reachable"] != OPS_DEVNET or any(
                h.get("device", {}).get("measured_bytes", 0) <= 0 for h in merged["hosts"].values()):
            raise AssertionError(f"/fleet over the devnet: {merged['fleet']}")
        net.check()
    except Exception:
        for i in range(OPS_DEVNET):
            log(f"devnet validator {i} log:\n{net.log(i)[-3000:]}")
        raise
    finally:
        net.stop()
    log(f"[{card}] ops: devnet of {OPS_DEVNET} validator processes on the card up in "
        f"{up_s:.3f} s, height {OPS_DEVNET_HEIGHT} after {run_s:.3f} s more; a send landed at "
        f"height {h_tx}; blocks and attested app hashes equal across the three up to {top} "
        f"({attested[0][-1][:16]}...); each child's /device from device_memory_stats; /fleet 3 "
        f"reachable hosts; each child's own launches across the send's height "
        f"{[(lo, hi, counts) for lo, hi, counts in spans]}")
    return out


@contextlib.contextmanager
def swapped(module, name: str, value):
    """Replace module.name for the block, then restore it."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def phase_uploads(torch, eds, card: str) -> None:
    """The one-shot calls' host-to-device copy, staged through pinned memory
    (device.upload, what the calls run) against a pageable copy of the same
    array, in turns (staged, pageable, pageable, staged): the upload alone
    and extend_shares at k=128 and 512, and the k=512 repair (Q3
    withheld, dense path) with its 537 MB damaged square.  The upload alone
    also against staging whose host copy is a numpy assignment."""
    import importlib
    import warnings

    from celestia_app_tpu_torch.da import DataAvailabilityHeader, extend_shares, repair
    from celestia_app_tpu_torch.device import upload

    eds_mod = importlib.import_module("celestia_app_tpu_torch.da.eds")
    repair_mod = importlib.import_module("celestia_app_tpu_torch.da.repair")
    dev = torch.device("cuda")

    def pageable(parts, device, **_kw):
        with warnings.catch_warnings():  # a read-only array is only read
            warnings.simplefilter("ignore")
            return torch.from_numpy(np.ascontiguousarray(parts)).to(device), None

    def numpy_staged(a):
        staging = torch.empty(a.shape, dtype=torch.uint8, pin_memory=True)
        staging.numpy()[...] = a
        return staging.to(dev, non_blocking=True)

    k = eds.k
    present = np.ones((2 * k, 2 * k), dtype=bool)
    present[k:, k:] = False
    damaged = eds.squared()
    damaged[k:, k:] = 0
    dah = DataAvailabilityHeader.from_eds(eds)
    cases = []
    for kk in (128, 512):
        ods = random_square(kk, seed=900 + kk)
        shares = [row.tobytes() for row in ods.reshape(kk * kk, 512)]
        cases.append((f"upload alone k={kk} ({ods.nbytes / 1e6:.1f} MB)", None, {
            "staged": lambda ods=ods: upload(ods, dev),
            "pageable": lambda ods=ods: pageable(ods, dev),
            "staged with a numpy host copy": lambda ods=ods: numpy_staged(ods)}))
        call = lambda shares=shares: extend_shares(shares, "vandermonde").data_root()  # noqa: E731
        cases.append((f"extend_shares k={kk}", eds_mod, {"staged": call, "pageable": call}))
    call = lambda: repair(damaged, present, dah)  # noqa: E731
    cases.append((f"repair k={k} Q3 withheld ({damaged.nbytes / 1e6:.1f} MB upload)", repair_mod,
                  {"staged": call, "pageable": call}))
    with environment({"CELESTIA_PIPE_FUSED": "on", "CELESTIA_RS_XOR": "off",
                      "CELESTIA_RS_CONSTRUCTION": "vandermonde"}):
        for label, module, fns in cases:
            times: dict[str, list[float]] = {name: [] for name in fns}
            first = None
            for name in [*fns, *reversed(fns)]:  # in turns, each variant twice
                ctx = (swapped(module, "upload", pageable if name == "pageable" else upload)
                       if module is not None else contextlib.nullcontext())
                with ctx:
                    if first is None:  # the first staged call pays the pinned allocation
                        first = timed_calls(torch, fns[name], reps=1)[0]
                    times[name] += timed_calls(torch, fns[name], reps=3)
            med = {name: float(np.median(v)) for name, v in times.items()}
            parts = ", ".join(f"{name} {med[name]:.3f} ms {[round(t, 3) for t in times[name]]}"
                              for name in fns)
            log(f"[{card}] {label}: {parts} (first staged call {first:.3f} ms); faster: "
                f"{min(med, key=med.get)}")


def expected_stream_launches(k: int, rows: list[dict], path: str) -> tuple[int, dict]:
    """(dispatches, launches) that a stream's journal rows account for: per
    dispatch two launches of the path's RS core (the epilogue path: one
    rs_dense and one rs_dense_leaf) and one sha256_leaves; sha256_batch once
    per tree level of each axis for one square (both axes together in a
    batch), then once per level of the data-root trees."""
    levels = (2 * k).bit_length() - 1
    root_levels = (4 * k).bit_length()
    singles = sum(1 for r in rows if r["batch_size"] == 1)
    batches = round(sum(1 / r["batch_size"] for r in rows if r["batch_size"] > 1))
    dispatches = singles + batches
    want = {"sha256_leaf": dispatches,
            "sha256": singles * (2 * levels + root_levels) + batches * (levels + root_levels)}
    core = {"dense": {"rs_dense": 2, "rs_xor": 0, "rs_dense_leaf": 0},
            "xor": {"rs_dense": 0, "rs_xor": 2, "rs_dense_leaf": 0},
            "epi": {"rs_dense": 1, "rs_xor": 0, "rs_dense_leaf": 1}}[path]
    if path == "epi" and batches:
        raise ValueError("the epilogue runs unbatched only")
    want.update({name: n * dispatches for name, n in core.items()})
    return dispatches, want


def stream_overlap(torch, fn, card: str, label: str) -> None:
    """Device idle share of one stream under torch.profiler, and how much of
    its host-to-device copy time overlapped kernels."""
    wall_us, spans = profiled_spans(torch, fn, host=False)
    if not spans:
        log(f"[{card}] {label}: device idle share not measured (no device events)")
        return
    busy = sum(b - a for a, b in merged(spans))
    copies = [sp for sp in spans if "HtoD" in sp[2]]
    kernels = merged([sp for sp in spans if not sp[2].startswith(("Memcpy", "Memset"))])
    copy_us = sum(e - s for s, e, _ in copies)
    overlap_us = sum(max(0.0, min(e, b) - max(s, a)) for s, e, _ in copies for a, b in kernels)
    log(f"[{card}] {label} under the profiler: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms, idle {100 - 100 * busy / wall_us:.1f}%; {len(copies)} "
        f"host-to-device copies {copy_us / 1e3:.3f} ms, {overlap_us / 1e3:.3f} ms of them "
        f"({100 * overlap_us / max(copy_us, 1e-9):.1f}%) beside kernels")


STREAM_STAGES = ("intake_wait_ms", "upload_ms", "upload_stall_ms", "dispatch_ms",
                 "dispatch_starve_ms", "drain_ms")


def phase_stream(torch, card: str) -> None:
    """Block streaming on the card: stream_blocks at k=128 (leopard, batch 1
    and 4, 32 squares) and k=512 (vandermonde, batch 1, 8 squares), depth 2,
    every data root equal to a one-shot compute of the same ODS; the
    epilogue and the XOR core through the stream once each; forests built
    on the default stream while the pipeline runs; a speculation hit and a
    discard; the ring's swap of a pinned slot."""
    from celestia_app_tpu_torch.da import ExtendedDataSquare
    from celestia_app_tpu_torch.da.eds import speculator
    from celestia_app_tpu_torch.kernels import _build
    from celestia_app_tpu_torch.kernels.fused import forest
    from celestia_app_tpu_torch.parallel import BlockPipeline, stream_blocks
    from celestia_app_tpu_torch.parallel.pipeline import _BufferRing
    from celestia_app_tpu_torch.trace import journal

    dense = {"CELESTIA_PIPE_FUSED": "on", "CELESTIA_RS_XOR": "off"}
    squares = {}
    for k, construction, n in ((128, "leopard", 32), (512, "vandermonde", 8)):
        with environment({**dense, "CELESTIA_RS_CONSTRUCTION": construction}):
            blocks = [(i, random_square(k, seed=7000 + 10 * k + i)) for i in range(n)]
            want, one_ms = [], []
            for _, ods in blocks:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want.append(ExtendedDataSquare.compute(ods).data_root())
                one_ms.append((time.perf_counter() - t0) * 1e3)
            squares[k] = (construction, blocks, want, one_ms)

    def run(k: int, batch: int, path: str, env: dict, n: int | None = None) -> None:
        construction, blocks, want, one_ms = squares[k]
        blocks, want = blocks[:n], want[:n]
        label = (f"stream k={k} {construction} {path} path, depth 2, batch {batch}, "
                 f"{len(blocks)} squares")
        with environment({**env, "CELESTIA_RS_CONSTRUCTION": construction}):
            t0 = time.perf_counter()
            BlockPipeline(k, depth=2, batch=batch).close()
            setup_ms = (time.perf_counter() - t0) * 1e3
            # First launches of this stream's pipelines and its steady-state
            # device memory (depth batches in flight).
            for _ in stream_blocks(iter(blocks[:max(4, 2 * batch)]), k, depth=2, batch=batch):
                pass
            walls, rows, per_batch = [], [], None
            for _ in range(3):
                before = len(journal.rows("stream"))
                _build.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = [(t, e.data_root()) for t, e in stream_blocks(iter(blocks), k, depth=2,
                                                                     batch=batch)]
                walls.append((time.perf_counter() - t0) * 1e3)
                launches = dict(_build.LAUNCHES)
                run_rows = journal.rows("stream")[before:]
                if [t for t, _ in got] != list(range(len(blocks))) or \
                        [r for _, r in got] != want:
                    raise AssertionError(f"{label}: streamed data roots != one-shot roots")
                dispatches, want_launches = expected_stream_launches(k, run_rows, path)
                check_launches(label, launches, want_launches)
                per_batch = per_batch or {name: round(c / dispatches, 2)
                                          for name, c in launches.items()}
                rows += run_rows
            wall = float(np.median(walls))
            med = {name: round(float(np.median([r[name] for r in rows])), 3)
                   for name in STREAM_STAGES}
            sizes = [r["batch_size"] for r in rows]
            log(f"[{card}] {label}: every data root == one-shot compute in 3 streams; wall "
                f"{wall:.3f} ms (median of {[round(w, 3) for w in walls]}), "
                f"{1e3 * len(blocks) / wall:.2f} squares/s, {wall / len(blocks):.3f} ms per "
                f"square (one-shot compute + data_root {float(np.median(one_ms)):.3f} ms median "
                f"of {len(one_ms)}); {round(sum(1 / b for b in sizes)) / 3:.1f} dispatches per "
                f"stream, launches per dispatch {per_batch}; journal medians {med}; a first "
                f"pipeline's set-up (threads, streams, {3 * batch * k * k * 512 / 1e6:.1f} MB "
                f"of pinned slots) {setup_ms:.3f} ms")
            if path == "dense":
                stream_overlap(torch, lambda: [e.data_root() for _, e in stream_blocks(
                    iter(blocks), k, depth=2, batch=batch)], card, label)

    run(128, 1, "dense", dense)
    run(128, 4, "dense", dense)
    run(512, 1, "dense", dense)
    run(128, 1, "epi", {"CELESTIA_PIPE_FUSED": "epi", "CELESTIA_RS_XOR": "off"}, n=8)
    run(128, 2, "xor", {"CELESTIA_PIPE_FUSED": "on", "CELESTIA_RS_XOR": "on"}, n=8)

    # Forests built on the default stream from streamed squares, each
    # square dropped as soon as its forest launches are enqueued, while
    # the pipeline keeps allocating on its own streams.
    construction, blocks, _, _ = squares[128]
    build = forest(128)
    with environment({**dense, "CELESTIA_RS_CONSTRUCTION": construction}):
        pipe = BlockPipeline(128, depth=2, batch=2)
        forests = {}
        try:
            for i, (tag, ods) in enumerate(blocks[:12], start=1):
                pipe.submit(ods, tag)
                if i > 2:
                    t, e = pipe._drain_one()
                    forests[t] = build(e._eds)
                    del e
            for t, e in pipe.drain():
                forests[t] = build(e._eds)
                del e
        finally:
            pipe.close()
        for tag, ods in blocks[:12]:
            row_flat, col_flat = build(ExtendedDataSquare.compute(ods)._eds)
            if not (torch.equal(forests[tag][0], row_flat) and torch.equal(forests[tag][1], col_flat)):
                raise AssertionError(f"forest of streamed square {tag} != its one-shot forest")
    log(f"[{card}] forests of 12 streamed k=128 squares, built on the default stream while "
        f"the pipeline ran: equal to the one-shot forests")

    # Speculation: a hit claimed by compute() and a discard on another square.
    with environment({**dense, "CELESTIA_RS_CONSTRUCTION": construction,
                      "CELESTIA_PIPE_SPECULATE": "on"}):
        (_, a), (_, b) = blocks[0], blocks[1]
        sp = speculator()
        sp.discard()
        ref = ExtendedDataSquare.compute(a)
        hits, discards = sp.outcomes["hit"], sp.outcomes["discard"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp.speculate(a, height=1, round_=0)
        t1 = time.perf_counter()
        got = ExtendedDataSquare.compute(a)
        root = got.data_root()
        t2 = time.perf_counter()
        if sp.outcomes["hit"] != hits + 1 or not torch.equal(got._eds, ref._eds) \
                or root != ref.data_root() or got.row_roots() != ref.row_roots():
            raise AssertionError("speculation: the claimed square != the computed one")
        sp.speculate(a, height=2, round_=0)
        other = ExtendedDataSquare.compute(b)
        if sp.outcomes["discard"] != discards + 1 or sp.pending() \
                or other.data_root() != squares[128][2][1]:
            raise AssertionError("speculation: a different square did not discard")
        log(f"[{card}] speculation k=128: hit equal to the computed square (speculate "
            f"{(t1 - t0) * 1e3:.3f} ms, claim + data_root {(t2 - t1) * 1e3:.3f} ms); a "
            f"different square discarded it and computed its own root")

    # The ring's swap of a pinned slot allocates fresh pinned memory.
    for k, batch in ((128, 4), (512, 1)):
        ring = _BufferRing(k, slots=1, batch=batch, pinned=True)
        sid = ring.acquire(1.0)
        ring.pin(sid)
        ring.release(sid)
        t0 = time.perf_counter()
        ring.acquire(1.0)
        log(f"[{card}] ring swap of a pinned ({batch}, {k}, {k}, 512) slot "
            f"({batch * k * k * 512 / 1e6:.1f} MB): {(time.perf_counter() - t0) * 1e3:.3f} ms")


# --- the device fault plane: the ladder, the sentinel, warm-up, the bridge ---

#: Square sizes of phase_faults: the ladder walk, the panel drills, repair and
#: the sentinel at the main path's k=512 (GF(2^16)); real launch faults, the
#: stream, warm-up's small size and the bridge at k=128.
FAULT_K = 512
FAULT_SMALL_K = 128


def rung_launches(k: int, mode: str, core: str = "rs_dense") -> dict:
    """Launches of one extend + DAH at square size k on one rung of the
    ladder: two RS launches of the core on fused, staged and host (the
    port's host rung is the staged pipeline on the card), the row phase's
    and one rs_dense_leaf on fused_epi; one sha256_leaves and the tree
    levels' sha256 everywhere (the epilogue hashes the bottom half)."""
    levels = (2 * k).bit_length() - 1
    want = {"rs_dense": 0, "rs_xor": 0, "rs_dense_leaf": 0, "sha256_leaf": 1,
            "sha256": 2 * levels + levels + 2}
    if mode == "fused_epi":
        want[core] += 1
        want["rs_dense_leaf"] = 1
    else:
        want[core] += 2
    return want


def trip_once_seed(seam: str, threshold: int, p: float = 0.5, pattern=None) -> int:
    """The least chaos seed whose draws at `seam` with probability p give
    `pattern` (default: `threshold` failures, then a pass): with
    CELESTIA_CHAOS=seed=<it>,<fault>=<p>, exactly one rung trips and the
    next one runs (chaos/spec.py draws random.Random(
    "celestia-chaos:<seed>:<seam>") once per seam call)."""
    import random

    pattern = pattern or [True] * threshold + [False]
    for seed in range(100_000):
        rng = random.Random(f"celestia-chaos:{seed}:{seam}")
        if all((rng.random() < p) == want for want in pattern):
            return seed
    raise AssertionError(f"no seed gives {pattern} at {seam}")


def counter_value(name: str, **labels) -> float:
    from celestia_app_tpu_torch.trace.metrics import registry

    fam = registry().get(name)
    if fam is None:
        return 0.0
    return sum(v for key, v in fam.samples() if all(key.get(a) == b for a, b in labels.items()))


def roots_of(eds) -> tuple:
    return (eds.data_root(), tuple(eds.row_roots()), tuple(eds.col_roots()))


class LaunchFault:
    """In place of kernels/_build.launch: raise an injected fault on the
    first `shots` launches (None: on every launch) of the kernels named
    (None: any); otherwise launch."""

    def __init__(self, inner, shots=1, kernels=None):
        self.inner, self.shots, self.kernels = inner, shots, kernels
        self.fired = 0
        self.lock = threading.Lock()

    def __call__(self, kernel, *args, **kwargs):
        if self.kernels is None or kernel in self.kernels:
            with self.lock:
                fire = self.shots is None or self.fired < self.shots
                if fire:
                    self.fired += 1
            if fire:
                raise RuntimeError(f"injected launch fault in {kernel}")
        return self.inner(kernel, *args, **kwargs)


def flight_bundles(flight_dir: str, trigger: str) -> list[dict]:
    out = []
    for name in sorted(os.listdir(flight_dir)):
        if name.startswith(f"flight-{trigger}-") and name.endswith(".json"):
            with open(os.path.join(flight_dir, name)) as f:
                out.append(json.load(f))
    return out


_WARM_PROBE = r"""
import json, sys, time
import numpy as np
import torch
from celestia_app_tpu_torch.da import eds as eds_mod
from celestia_app_tpu_torch.da import extend_shares
from celestia_app_tpu_torch.trace import journal

warm = sys.argv[1] == "warm"
sizes = [int(k) for k in sys.argv[2].split(",")]
out = {}
if warm:
    t0 = time.perf_counter()
    eds_mod.warmup(sizes)
    out["warmup_s"] = time.perf_counter() - t0
    out["warmup_rows"] = [{key: r[key] for key in ("k", "mode", "compile", "warm_ms")}
                          for r in journal.rows("warmup")]
for k in sizes:
    rng = np.random.default_rng(k)
    ods = rng.integers(0, 256, (k * k, 512), dtype=np.uint8)
    ods[:, :29] = 0
    shares = [r.tobytes() for r in ods]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    root = extend_shares(shares).data_root()
    torch.cuda.synchronize()
    row = journal.rows("compute")[-1]
    out[str(k)] = {"first_ms": (time.perf_counter() - t0) * 1e3, "compile": row["compile"],
                   "mode": row["mode"], "root": root.hex()}
print(json.dumps(out))
"""


def warm_probe(mode: str, sizes: str) -> dict:
    """Run _WARM_PROBE in a fresh interpreter from the repo root: the first
    extend_shares of each size, cold or after da.eds.warmup."""
    out = subprocess.run([sys.executable, "-c", _WARM_PROBE, mode, sizes],
                         capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    if out.returncode != 0:
        raise AssertionError(f"warm-up probe ({mode}) exited {out.returncode}:\n"
                             f"{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase_faults(torch, card: str) -> dict:
    """The device fault plane on the card (chaos/degrade.py and the seams
    around it), each drill against golden roots computed on a clean rung:

      1. the ladder walk at k=512 (GF(2^16)) from $CELESTIA_PIPE_FUSED=epi:
         a $CELESTIA_CHAOS spec per step trips exactly one rung (chaos seeds
         chosen from the seam's draws), fused_epi -> fused -> staged ->
         host, each compute's journal row naming the rung and its launches
         the rung's (rs_dense_leaf only on fused_epi); degraded_state, the
         celestia_degraded gauge, recoveries{degraded}, a breaker_trip
         bundle with its degraded and device sections; a spec that fails
         every rung raises past the floor; again under $CELESTIA_RS_XOR=on;
      2. real launch faults at k=128 through kernels/_build.launch: a
         one-shot fault is retried (recoveries{retried} +1, the ladder
         unmoved, the same roots); a persistent one walks to the floor and
         the original error raises (a DeviceFault through device.on_device);
      3. a mid-panel fault at k=512 under $CELESTIA_PIPE_PANEL=auto steps
         panel -> the materializing base; extend_shard_fail steps
         sharded_panel -> panel over 4 logical shards of cuda:0;
      4. the stream at k=128 (batch 4, depth 2): a batched fault falls to
         unbatched dispatches, a failed upload is retried, a deferred fault
         at the drain's sync feeds the breaker, a dispatcher death writes a
         worker_death bundle and submit / drain raise with the cause;
      5. repair at k=512 with Q0 withheld: a sweep fault is retried; a
         corrupted survivor raises RootMismatch and writes its bundle;
      6. the parity sentinel at every block on fused and fused_epi: 8
         squares at k=512 each "match"; a forced staged mismatch gives
         "mismatch", a trace row and a bundle;
      7. warm-up: in fresh interpreters the first extend_shares at k=128
         and 512, cold and after warmup([128, 512]) (compile "hit");
      8. the device ledger: reconcile() on device_memory_stats, owners,
         the unattributed residual, the programs' calls and build seconds;
      9. the bridge backend at k=128: roots == in-process, the worker
         killed -> one call on the in-process path with the stderr line,
         the next call respawns the worker.
    The ladder is re-armed (reset_for_tests) between drills and left
    healthy.  Returns the figures PERF.md quotes."""
    import io
    import tempfile

    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.chaos import degrade
    from celestia_app_tpu_torch.da import ExtendedDataSquare, extend_shares, repair
    from celestia_app_tpu_torch.da import eds as eds_mod
    from celestia_app_tpu_torch.da.repair import RootMismatch
    from celestia_app_tpu_torch.device import DeviceFault, on_device
    from celestia_app_tpu_torch.kernels import _build, panel_sharded
    from celestia_app_tpu_torch.kernels.panel import panel_rows
    from celestia_app_tpu_torch.parallel import BlockPipeline, stream_blocks
    from celestia_app_tpu_torch.parallel import pipeline as pipeline_mod
    from celestia_app_tpu_torch.parallel.mesh import EXTEND_AXIS, Mesh
    from celestia_app_tpu_torch.trace import device_ledger, journal
    from celestia_app_tpu_torch.trace.tracer import traced

    t_phase = time.perf_counter()
    flight_dir = tempfile.mkdtemp(prefix="flight-")
    figures: dict = {}
    threshold = degrade.DEVICE_BREAKER.threshold
    big = random_square(FAULT_K, seed=14_000 + FAULT_K)
    small = random_square(FAULT_SMALL_K, seed=14_000 + FAULT_SMALL_K)
    dense = {"CELESTIA_PIPE_FUSED": "on", "CELESTIA_RS_XOR": "off", "CELESTIA_PIPE_PANEL": "off",
             "CELESTIA_RS_CONSTRUCTION": "vandermonde", "CELESTIA_FLIGHT_DIR": flight_dir,
             "CELESTIA_FLIGHT_MIN_INTERVAL_S": "0", "CELESTIA_CHAOS": ""}

    def compute(ods, **env):
        """One compute under `env`: (roots, its journal row, its launches, ms)."""
        with environment(env):
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            eds = ExtendedDataSquare.compute(ods)
            got = roots_of(eds)
            ms = (time.perf_counter() - t0) * 1e3
            return got, journal.rows("compute")[-1], dict(_build.LAUNCHES), ms

    degrade.reset_for_tests()
    chaos.uninstall()
    with environment(dense):
        golden_big = compute(big)[0]
        golden_small = compute(small)[0]

        # 1. The ladder walk, rung by rung, on the dense and the XOR core.
        seed = trip_once_seed("device.dispatch", threshold)
        steps = (("fused", f"seed={seed},dispatch_fail=0.5"),
                 ("staged", f"seed={seed},dispatch_fail=1.0"),
                 ("host", f"seed={seed},dispatch_fail=0.5,dispatch_fail_all=1"))
        walk = {}
        for core, xor in (("rs_dense", "off"), ("rs_xor", "on")):
            degrade.reset_for_tests()
            env = {"CELESTIA_PIPE_FUSED": "epi", "CELESTIA_RS_XOR": xor}
            got, row, launches, ms = compute(big, **env)
            rows = [("fused_epi", row, launches, ms, got)]
            for rung, spec in steps:
                degraded0 = counter_value("celestia_recoveries_total", seam="device.dispatch",
                                          outcome="degraded")
                got, row, launches, ms = compute(big, **env, CELESTIA_CHAOS=spec)
                stepped = counter_value("celestia_recoveries_total", seam="device.dispatch",
                                        outcome="degraded") - degraded0
                if (degrade.degraded_state() != {"device": rung} or stepped != 1
                        or counter_value("celestia_degraded", layer="device", mode=rung) != 1.0):
                    raise AssertionError(f"ladder step to {rung} under {spec!r}: state "
                                         f"{degrade.degraded_state()}, degraded +{stepped}")
                rows.append((rung, row, launches, ms, got))
            for rung, row, launches, ms, got in rows:
                if got != golden_big or row["mode"] != rung:
                    raise AssertionError(f"ladder walk ({core}) on {rung}: journal mode "
                                         f"{row['mode']}, roots equal {got == golden_big}")
                check_launches(f"ladder walk ({core}) on {rung}", launches,
                               rung_launches(FAULT_K, rung, core))
            try:
                compute(big, **env, CELESTIA_CHAOS=f"seed={seed},dispatch_fail=1.0,"
                                                   "dispatch_fail_all=1")
            except chaos.ChaosInjected as e:
                floor_err = repr(e)
            else:
                raise AssertionError("a spec failing every rung did not raise past the floor")
            walk[core] = {rung: round(ms, 3) for rung, _, _, ms, _ in rows}
            log(f"[{card}] ladder walk k={FAULT_K} ({core} core) from CELESTIA_PIPE_FUSED=epi, "
                f"breaker threshold {threshold}, chaos seed {seed}: "
                + "; ".join(f"{rung} {ms:.3f} ms, launches "
                            f"{ {n: c for n, c in launches.items() if c} }"
                            for rung, _, launches, ms, _ in rows)
                + f"; every rung's roots == golden, its journal row names it; past the floor "
                  f"{floor_err}")
        trips = flight_bundles(flight_dir, "breaker_trip")
        last = trips[-1] if trips else {}
        if not trips or last.get("degraded") != {"device": "host"} or \
                not last.get("device", {}).get("programs") or \
                "measured_source" not in last["device"].get("ownership", {}):
            raise AssertionError(f"breaker_trip bundles {len(trips)}: last degraded "
                                 f"{last.get('degraded')}, device section "
                                 f"{sorted(last.get('device', {}))}")
        log(f"[{card}] ladder: {len(trips)} breaker_trip bundles, the last with degraded "
            f"{last['degraded']} and a device section of {len(last['device']['programs'])} "
            f"programs, ownership measured by {last['device']['ownership']['measured_source']}")
        figures["walk_ms"] = walk
        degrade.reset_for_tests()

        # 2. Real launch faults through kernels/_build.launch.
        retried0 = counter_value("celestia_recoveries_total", seam="device.dispatch",
                                 outcome="retried")
        clean_ms = compute(small)[3]
        fault = LaunchFault(_build.launch, shots=1)
        with swapped(_build, "launch", fault):
            got, row, _, retry_ms = compute(small)
        retried = counter_value("celestia_recoveries_total", seam="device.dispatch",
                                outcome="retried") - retried0
        if got != golden_small or retried != 1 or degrade.degraded_state() is not None \
                or row["mode"] != "fused" or fault.fired != 1:
            raise AssertionError(f"one-shot launch fault: retried +{retried}, state "
                                 f"{degrade.degraded_state()}, mode {row['mode']}")
        fault = LaunchFault(_build.launch, shots=None)
        t0 = time.perf_counter()
        try:
            with swapped(_build, "launch", fault), on_device("extend + DAH"):
                compute(small)
        except DeviceFault as e:
            walk_ms = (time.perf_counter() - t0) * 1e3
            if "injected launch fault" not in repr(e.__cause__):
                raise AssertionError(f"past the floor: not the injected fault: {e!r}") from e
            floor = repr(e)[:120]
        else:
            raise AssertionError("a persistent launch fault did not raise past the floor")
        if degrade.degraded_state() != {"device": "host"} or fault.fired != 3 * threshold:
            raise AssertionError(f"persistent fault: state {degrade.degraded_state()}, "
                                 f"{fault.fired} faulted launches")
        degrade.reset_for_tests()
        figures.update(clean_ms=clean_ms, retry_ms=retry_ms, walk_to_floor_ms=walk_ms)
        log(f"[{card}] launch faults k={FAULT_SMALL_K}: clean {clean_ms:.3f} ms; a one-shot "
            f"fault retried once ({retry_ms:.3f} ms, the ladder unmoved, roots == golden); a "
            f"persistent fault: {fault.fired} failed attempts down fused -> staged -> host in "
            f"{walk_ms:.3f} ms, then {floor}")

        # 3. The panel and sharded-panel rungs.
        panel_env = {"CELESTIA_PIPE_PANEL": "auto"}
        # Per panel attempt: guarded_dispatch's seam passes, the first
        # panel's passes, the second panel's fails; then fused's passes.
        pseed = trip_once_seed("device.dispatch", threshold,
                               pattern=[False, False, True] * threshold + [False])
        got, row, launches, ms = compute(big, **panel_env,
                                         CELESTIA_CHAOS=f"seed={pseed},dispatch_fail=0.5")
        if got != golden_big or row["mode"] != "fused" or \
                degrade.degraded_state() != {"device": "fused"}:
            raise AssertionError(f"mid-panel fault: mode {row['mode']}, state "
                                 f"{degrade.degraded_state()}")
        check_launches("after the mid-panel walk", launches, {
            **{n: c for n, c in rung_launches(FAULT_K, "fused").items()},
            # Each failed attempt ran its first panel: a row phase and a
            # column partial (2 rs_dense) and its leaves (1 sha256_leaves).
            "rs_dense": 2 + 2 * threshold, "sha256_leaf": 1 + threshold})
        degrade.reset_for_tests()
        with environment(panel_env):
            height = panel_rows(FAULT_K)
        log(f"[{card}] panel rung k={FAULT_K} ({height}-row panels): a fault in "
            f"the second panel of "
            f"each of {threshold} attempts (chaos seed {pseed}) stepped panel -> fused, roots "
            f"== golden, {ms:.3f} ms, launches {launches}")
        logical = Mesh([torch.device("cuda", 0)] * 4, EXTEND_AXIS)
        with swapped(panel_sharded, "device_count", lambda device=None: 4), \
                swapped(panel_sharded, "extend_mesh", lambda shards, device=None: logical):
            sharded_env = {**panel_env, "CELESTIA_EXTEND_SHARDS": "4"}
            first_sharded_ms = compute(big, **sharded_env)[3]  # builds the shard slices
            got, row, _, clean_sharded_ms = compute(big, **sharded_env)
            if got != golden_big or row["mode"] != "sharded_panel" or row.get("shards") != 4:
                raise AssertionError(f"sharded panel: mode {row['mode']}, row {row}")
            got, row, launches, ms = compute(big, **sharded_env,
                                             CELESTIA_CHAOS="seed=4,extend_shard_fail=1.0")
        if got != golden_big or row["mode"] != "panel" or \
                degrade.degraded_state() != {"device": "panel"}:
            raise AssertionError(f"extend_shard_fail: mode {row['mode']}, state "
                                 f"{degrade.degraded_state()}")
        degrade.reset_for_tests()
        log(f"[{card}] sharded rung k={FAULT_K} over 4 logical shards of cuda:0: first call "
            f"{first_sharded_ms:.3f} ms, clean {clean_sharded_ms:.3f} ms; extend_shard_fail=1.0 "
            f"stepped sharded_panel -> panel "
            f"({row['panels']} panels), roots == golden, {ms:.3f} ms")

        # 4. The stream.
        stream_odss = [(i, random_square(FAULT_SMALL_K, seed=14_200 + i)) for i in range(12)]
        want = [ExtendedDataSquare.compute(o).data_root() for _, o in stream_odss]

        def stream(label, **kw):
            before = len(journal.rows("stream"))
            got = [(t, e.data_root()) for t, e in stream_blocks(
                iter(stream_odss), FAULT_SMALL_K, depth=2, batch=4, **kw)]
            if got != list(zip(range(len(want)), want)):
                raise AssertionError(f"stream ({label}): roots != one-shot")
            return journal.rows("stream")[before:]

        inner_batched = pipeline_mod.batched_pipeline_for_mode
        failed_batches = []

        def faulty_batched(mode, k, n, *args, **kwargs):
            run = inner_batched(mode, k, n, *args, **kwargs)
            if threading.current_thread().name != "block-pipeline-dispatcher" or failed_batches:
                return run

            def fail(x):
                failed_batches.append(n)
                raise RuntimeError("injected batched launch fault")
            return fail

        unbatched0 = counter_value("celestia_recoveries_total", seam="device.dispatch",
                                   outcome="unbatched")
        with swapped(pipeline_mod, "batched_pipeline_for_mode", faulty_batched):
            rows = stream("batched fault")
        unbatched = counter_value("celestia_recoveries_total", seam="device.dispatch",
                                  outcome="unbatched") - unbatched0
        if failed_batches and unbatched != 1:
            raise AssertionError(f"batched fault: unbatched +{unbatched}")
        if not failed_batches:
            raise AssertionError(f"no batched dispatch in the stream: batch sizes "
                                 f"{[r['batch_size'] for r in rows]}")
        useed = trip_once_seed("device.upload", 3, p=0.3,
                               pattern=[True, False] + [False] * 11)
        upload0 = counter_value("celestia_recoveries_total", seam="device.upload",
                                outcome="retried")
        with environment({"CELESTIA_CHAOS": f"seed={useed},upload_fail=0.3"}):
            stream("upload retry")
        uploads = counter_value("celestia_recoveries_total", seam="device.upload",
                                outcome="retried") - upload0
        if uploads < 1:
            raise AssertionError("no upload retry under upload_fail")
        # Every dispatch done before the first drain: a success between two
        # deferred faults would reset the breaker's streak.
        pipe = BlockPipeline(FAULT_SMALL_K, depth=threshold + 1, batch=1)
        inner_await, deferred = pipe._await, []

        def deferred_fault(inflight):
            inner_await(inflight)
            if len(deferred) < threshold:
                deferred.append(inflight.tag)
                raise RuntimeError("injected deferred device fault at the drain's sync")

        pipe._await = deferred_fault
        try:
            for tag, ods in stream_odss[:threshold + 1]:
                pipe.submit(ods, tag)
            deadline = time.monotonic() + 60
            while pipe._done.qsize() < threshold + 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            for _ in range(threshold):
                try:
                    pipe._drain_one()
                except RuntimeError as e:
                    if "deferred" not in str(e):
                        raise
                else:
                    raise AssertionError("a deferred fault did not raise out of the drain")
            last_tag, last_eds = pipe._drain_one()
        finally:
            pipe.close()
        if degrade.degraded_state() != {"device": "staged"} or \
                last_eds.data_root() != want[last_tag]:
            raise AssertionError(f"deferred faults: state {degrade.degraded_state()}")
        degrade.reset_for_tests()
        deaths0 = len(flight_bundles(flight_dir, "worker_death"))
        pipe = BlockPipeline(FAULT_SMALL_K, depth=1, batch=1)

        def dead_rung(mode):
            def fail(x):
                raise RuntimeError(f"injected dispatcher fault on {mode}")
            return fail

        pipe._resolve_pipe = dead_rung
        try:
            pipe.submit(stream_odss[0][1], 0)
            deadline = time.monotonic() + 30
            while pipe._error is None and time.monotonic() < deadline:
                time.sleep(0.01)
            errors = []
            for call in (lambda: pipe.submit(stream_odss[1][1], 1), lambda: list(pipe.drain())):
                try:
                    call()
                except RuntimeError as e:
                    errors.append(e)
        finally:
            pipe.close()
        pipe._dispatcher.join(30)  # its bundle is written after the death sentinel
        deaths = flight_bundles(flight_dir, "worker_death")[deaths0:]
        if len(errors) != 2 or any("injected dispatcher fault" not in repr(e.__cause__)
                                   for e in errors) or not deaths:
            raise AssertionError(f"dispatcher death: errors {errors}, {len(deaths)} bundles")
        degrade.reset_for_tests()
        log(f"[{card}] stream k={FAULT_SMALL_K} batch 4 depth 2, {len(stream_odss)} squares, "
            f"roots == one-shot in each: a batched fault (batch of {failed_batches[0]}) fell to "
            f"unbatched dispatches (unbatched +{unbatched}); upload_fail=0.3 (seed {useed}) "
            f"retried {uploads:.0f} upload(s); {threshold} deferred faults at the drain's sync "
            f"stepped the ladder to staged; a dead dispatcher wrote {len(deaths)} worker_death "
            f"bundle(s), submit and drain raised {errors[0]!r} from {errors[0].__cause__!r}")

        # 5. Repair with Q0 withheld.
        full = ExtendedDataSquare.compute(big)
        shares = full.squared()
        present = np.ones((2 * FAULT_K, 2 * FAULT_K), dtype=bool)
        present[:FAULT_K, :FAULT_K] = False
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        repair(shares, present)  # builds the pattern's recover matrix, unless cached
        torch.cuda.synchronize()
        first_repair_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        repair(shares, present)
        torch.cuda.synchronize()
        clean_repair_ms = (time.perf_counter() - t0) * 1e3
        retried0 = counter_value("celestia_recoveries_total", seam="device.dispatch",
                                 outcome="retried")
        fault = LaunchFault(_build.launch, shots=1, kernels={"rs_dense"})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with swapped(_build, "launch", fault):
            fixed = repair(shares, present)
        torch.cuda.synchronize()
        repair_ms = (time.perf_counter() - t0) * 1e3
        retried = counter_value("celestia_recoveries_total", seam="device.dispatch",
                                outcome="retried") - retried0
        if roots_of(fixed) != golden_big or retried != 1 or degrade.degraded_state() is not None:
            raise AssertionError(f"repair sweep fault: retried +{retried}")
        bad = shares.copy()
        bad[FAULT_K + 3, 5, 100] ^= 1
        mismatches0 = len(flight_bundles(flight_dir, "root_mismatch"))
        detections0 = counter_value("celestia_da_detections_total", kind="root_mismatch")
        try:
            repair(bad, present)
        except RootMismatch as e:
            rejected = repr(e)
        else:
            raise AssertionError("a corrupted survivor was accepted")
        if len(flight_bundles(flight_dir, "root_mismatch")) != mismatches0 + 1 or \
                counter_value("celestia_da_detections_total", kind="root_mismatch") != \
                detections0 + 1:
            raise AssertionError("RootMismatch wrote no root_mismatch bundle or detection")
        log(f"[{card}] repair k={FAULT_K} Q0 withheld: first {first_repair_ms:.3f} ms (the "
            f"pattern's recover matrix, unless an earlier phase built it), clean "
            f"{clean_repair_ms:.3f} ms; a one-shot rs_dense fault in the "
            f"sweep retried once ({repair_ms:.3f} ms), repaired roots == golden; a corrupted survivor "
            f"raised {rejected} and wrote a root_mismatch bundle")

        # 6. The parity sentinel at every block.
        def checks(result: str) -> float:
            return counter_value("celestia_parity_checks_total", result=result)

        sentinel = {}
        for mode_env in ("on", "epi"):
            squares = [random_square(FAULT_K, seed=14_300 + i) for i in range(4)]
            with environment({"CELESTIA_PIPE_FUSED": mode_env}):
                off = [compute(o)[3] for o in squares]
                match0 = checks("match")
                t0 = time.perf_counter()
                with environment({"CELESTIA_PARITY_SENTINEL": "1"}):
                    on = [compute(o)[3] for o in squares]
                    eds_mod.drain_parity_checks(120)
                total_ms = (time.perf_counter() - t0) * 1e3
            matched = checks("match") - match0
            if matched != len(squares):
                raise AssertionError(f"sentinel on {mode_env}: {matched} matches of "
                                     f"{len(squares)}, errors {checks('error')}")
            sentinel[mode_env] = (float(np.median(off)), float(np.median(on)), total_ms)
        mismatch0 = checks("mismatch")
        rows0 = len(traced().table("parity_mismatch"))
        bundles0 = len(flight_bundles(flight_dir, "parity_mismatch"))
        flipped = lambda *a: bytes(32)  # noqa: E731
        with swapped(eds_mod, "_staged_root", flipped), \
                environment({"CELESTIA_PARITY_SENTINEL": "1"}):
            compute(big)
            eds_mod.drain_parity_checks(120)
        if checks("mismatch") != mismatch0 + 1 or \
                len(traced().table("parity_mismatch")) != rows0 + 1 or \
                len(flight_bundles(flight_dir, "parity_mismatch")) != bundles0 + 1:
            raise AssertionError("a forced staged mismatch was not reported")
        figures["sentinel"] = sentinel
        log(f"[{card}] parity sentinel k={FAULT_K}, every block: "
            + "; ".join(f"{'fused' if m == 'on' else 'fused_epi'}: 4 squares each match, "
                        f"compute median {a:.3f} ms unarmed, {b:.3f} ms armed, 4 armed + their "
                        f"checks {c:.3f} ms" for m, (a, b, c) in sentinel.items())
            + "; a forced staged mismatch: result mismatch, a parity_mismatch row and bundle")

    # 7. Warm-up, in fresh interpreters (the flight dir and chaos off).
    sizes = f"{FAULT_SMALL_K},{FAULT_K}"
    with environment({key: val for key, val in dense.items()
                      if not key.startswith("CELESTIA_FLIGHT")}):
        cold = warm_probe("cold", sizes)
        warm = warm_probe("warm", sizes)
    for k in (FAULT_SMALL_K, FAULT_K):
        if cold[str(k)]["root"] != warm[str(k)]["root"] or warm[str(k)]["compile"] != "hit":
            raise AssertionError(f"warm-up k={k}: cold {cold[str(k)]}, warm {warm[str(k)]}")
    figures["warmup"] = {"cold": cold, "warm": warm}
    log(f"[{card}] warm-up (fresh interpreters): first extend_shares cold "
        + ", ".join(f"k={k} {cold[str(k)]['first_ms']:.3f} ms ({cold[str(k)]['compile']})"
                    for k in (FAULT_SMALL_K, FAULT_K))
        + f"; warmup([{sizes}]) {warm['warmup_s']:.3f} s (rows "
        + ", ".join(f"k={r['k']} {r['mode']} {r['warm_ms']:.3f} ms" for r in warm["warmup_rows"])
        + "), then first extend_shares "
        + ", ".join(f"k={k} {warm[str(k)]['first_ms']:.3f} ms ({warm[str(k)]['compile']})"
                    for k in (FAULT_SMALL_K, FAULT_K)))

    # 8. The device ledger after the phase.
    torch.cuda.synchronize()
    snap = device_ledger.snapshot(device="cuda")
    own = snap["ownership"]
    if own["measured_source"] != "device_memory_stats" or not snap["programs"]:
        raise AssertionError(f"ledger: {own}")
    figures["ledger"] = own
    log(f"[{card}] device ledger: measured {own['measured_bytes'] / 1e9:.3f} GB "
        f"({own['measured_source']}), owned {own['owned_bytes'] / 1e9:.3f} GB by "
        f"{ {n: round(b / 1e6, 3) for n, b in own['owners'].items() if b} } MB, unattributed "
        f"residual {own['unattributed_residual'] / 1e9:.3f} GB; programs (family k mode: calls, "
        f"first-call s): "
        + "; ".join(f"{p['family']} {p['k']} {p['mode'] or '-'}"
                    f"{'/' + str(p['batch']) if p['batch'] else ''}: {p['dispatches']}, "
                    f"{p['compile_s']:.3f}" for p in snap["programs"] if p["dispatches"]))

    # 9. The bridge backend at k=128.
    lib, _ = build_bridge()
    shares_small = [row.tobytes() for row in small.reshape(-1, 512)]
    bridge_env = {**{k: v for k, v in dense.items() if not k.startswith("CELESTIA_FLIGHT")},
                  "CELESTIA_SQUARE_BACKEND": "bridge", "CELESTIA_BRIDGE_LIB": lib}
    with environment(bridge_env), watchdog(240, "the bridge backend drill"):
        try:
            t0 = time.perf_counter()
            first = extend_shares(shares_small)
            spawn_ms = (time.perf_counter() - t0) * 1e3
            pids = bridge_workers()
            t0 = time.perf_counter()
            second = extend_shares(shares_small)
            trip_ms = (time.perf_counter() - t0) * 1e3
            if roots_of(first) != golden_small or roots_of(second) != golden_small or \
                    len(pids) != 1 or eds_mod._BRIDGE_CLIENT is None:
                raise AssertionError(f"bridge backend: workers {pids}, roots equal "
                                     f"{roots_of(first) == golden_small}")
            os.kill(pids[0], signal.SIGKILL)
            os.waitpid(pids[0], 0)
            err = io.StringIO()
            rows0 = len(journal.rows("compute"))
            with contextlib.redirect_stderr(err):
                fallback = extend_shares(shares_small)
            line = err.getvalue().strip()
            if roots_of(fallback) != golden_small or "falling back to device pipeline" not in line \
                    or len(journal.rows("compute")) != rows0 + 1 or eds_mod._BRIDGE_CLIENT:
                raise AssertionError(f"bridge fallback: {line!r}")
            respawned = extend_shares(shares_small)
            new_pids = bridge_workers()
            if roots_of(respawned) != golden_small or len(new_pids) != 1 or new_pids == pids:
                raise AssertionError(f"bridge respawn: workers {pids} -> {new_pids}")
        finally:
            eds_mod._reset_bridge()
    log(f"[{card}] bridge backend k={FAULT_SMALL_K}: first call (worker spawn) "
        f"{spawn_ms:.3f} ms, a round trip {trip_ms:.3f} ms, roots == in-process; the worker "
        f"SIGKILLed -> one call on the in-process path ({line!r}); the next call respawned "
        f"worker {new_pids[0]}")
    shutil.rmtree(flight_dir, ignore_errors=True)
    degrade.reset_for_tests()
    chaos.uninstall()
    log(f"[{card}] faults: the phase {time.perf_counter() - t_phase:.1f} s")
    return figures


# --- consensus-side entry points: commitments, the proof querier, the bridge ---


def share_payload(rng, n: int) -> bytes:
    """Random blob bytes that need exactly `n` sparse shares."""
    from celestia_app_tpu_torch.constants import (
        CONTINUATION_SPARSE_SHARE_CONTENT_SIZE as CONT,
        FIRST_SPARSE_SHARE_CONTENT_SIZE as FIRST,
    )

    size = (int(rng.integers(1, FIRST + 1)) if n == 1
            else FIRST + (n - 2) * CONT + int(rng.integers(1, CONT + 1)))
    return rng.bytes(size)


def commitment_blobs(seed: int, budget: int = 15_500, n_random: int = 113) -> list:
    """One k=128 square's worth of blobs under 32 v0 namespaces: one blob of
    each subtree width 1, 2, 4, ..., 32 (a share count drawn in that
    width's range at threshold 64), a 1.97 MB blob (4,088 shares, width 64),
    a 5,000-share blob (width 128), then `n_random` blobs whose share counts
    are drawn log-uniform between 1 (478 B) and 4,088 (1.97 MB), each draw
    capped so that all blobs together need `budget` shares at most."""
    from celestia_app_tpu_torch.shares import Blob, Namespace

    rng = np.random.default_rng(seed)
    namespaces = [Namespace.v0(rng.bytes(10)) for _ in range(32)]
    counts = [int(rng.integers(1, 65))]
    counts += [int(rng.integers(32 * w + 1, 64 * w + 1)) for w in (2, 4, 8, 16, 32)]
    counts += [4088, 5000]
    for i in range(n_random):
        room = budget - sum(counts) - (n_random - i - 1)
        hi = max(1, min(4088, room))
        counts.append(min(hi, max(1, int(np.exp(rng.uniform(0.0, np.log(hi)))))))
    return [Blob(namespaces[int(rng.integers(32))], share_payload(rng, n)) for n in counts]


def expected_commitment_launches(blobs) -> dict:
    """One sha256_leaves launch per distinct chunk size of the batch and one
    sha256_batch launch per tree level of each (log2 of the size)."""
    from celestia_app_tpu_torch.inclusion import merkle_mountain_range_sizes
    from celestia_app_tpu_torch.shares import sparse_shares_needed
    from celestia_app_tpu_torch.square import subtree_width

    sizes = set()
    for b in blobs:
        n = sparse_shares_needed(len(b.data))
        sizes.update(merkle_mountain_range_sizes(n, subtree_width(n, 64)))
    return {"sha256_leaf": len(sizes), "sha256": sum(s.bit_length() - 1 for s in sizes),
            "rs_dense": 0}


def host_breakdown(torch, fn, card: str, label: str, top: int = 8) -> None:
    """The host functions that take the most time of their own in one call
    of `fn` (cProfile; it slows each Python call, so the shares, not the
    sum, are what to read)."""
    import cProfile

    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    prof.create_stats()
    rows = sorted(prof.stats.items(), key=lambda kv: -kv[1][2])[:top]
    total = sum(v[2] for v in prof.stats.values())
    log(f"[{card}] {label} under cProfile: {total * 1e3:.3f} ms of Python; most of their own:")
    for (path, line, name), (_, calls, own, _cum, _) in rows:
        log(f"    {own * 1e3:9.3f} ms  {calls:6d} calls  {name} ({os.path.basename(path)}:{line})")


def phase_commitments(torch, card: str) -> dict:
    """create_commitments_batched on the card for one k=128 square's worth of
    blobs: equal to the host oracle, a memo hit on the second call, four
    threads at once, and equal to the commitments re-derived from the row
    trees of a k=128 square the builder made of them and the card extended.
    Returns the launches of one batch."""
    from celestia_app_tpu_torch.da import extend_shares
    from celestia_app_tpu_torch.inclusion import (
        batched,
        commitment_from_row_trees,
        create_commitment,
        create_commitments_batched,
    )
    from celestia_app_tpu_torch.kernels import _build
    from celestia_app_tpu_torch.shares import sparse_shares_needed
    from celestia_app_tpu_torch.square import Builder, subtree_width
    from celestia_app_tpu_torch.tx.envelopes import BlobTx

    blobs = commitment_blobs(1970)
    shares = [sparse_shares_needed(len(b.data)) for b in blobs]
    t0 = time.perf_counter()
    want = [create_commitment(b) for b in blobs]
    host_ms = (time.perf_counter() - t0) * 1e3
    log(f"[{card}] commitments: {len(blobs)} blobs, {sum(shares)} shares, "
        f"{sum(len(b.data) for b in blobs) / 1e6:.3f} MB (largest {max(shares)} shares); "
        f"host create_commitment (hashlib) {host_ms:.3f} ms for all")

    def batch():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = create_commitments_batched(blobs)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    batched._COMMIT_MEMO.clear()
    _build.reset_launches()
    first, first_ms = batch()
    counts = dict(_build.LAUNCHES)
    if first != want:
        bad = [i for i, (a, b) in enumerate(zip(first, want)) if a != b]
        raise AssertionError(f"batched commitments differ from create_commitment at {bad[:8]}")
    check_launches("commitment batch", counts, expected_commitment_launches(blobs))
    before = batched.memo_stats()
    _build.reset_launches()
    again, hit_ms = batch()
    after = batched.memo_stats()
    if again != want or after["misses"] != before["misses"] or \
            after["hits"] - before["hits"] != len(blobs) or any(_build.LAUNCHES.values()):
        raise AssertionError(f"the second call missed the memo: {before} -> {after}, "
                             f"launches {_build.LAUNCHES}")
    miss_ms = []
    for _ in range(3):
        batched._COMMIT_MEMO.clear()
        miss_ms.append(batch()[1])
    log(f"[{card}] commitments == create_commitment for all {len(blobs)}; launches {counts}; "
        f"first call {first_ms:.3f} ms, later misses {[round(t, 3) for t in miss_ms]} ms, "
        f"memo hit {hit_ms:.3f} ms (misses +0, hits +{len(blobs)})")

    def miss():
        batched._COMMIT_MEMO.clear()
        create_commitments_batched(blobs)

    device_breakdown(torch, miss, card, f"commitments, {len(blobs)} blobs, memo miss")
    host_breakdown(torch, miss, card, f"commitments, {len(blobs)} blobs, memo miss")
    device_breakdown(torch, lambda: create_commitments_batched(blobs), card,
                     f"commitments, {len(blobs)} blobs, memo hit")

    # Four threads at once on overlapping windows of the set, memo empty.
    batched._COMMIT_MEMO.clear()
    windows = [range(t * 20, t * 20 + 60) for t in range(4)]
    results, errors = {}, []

    def run(t: int) -> None:
        try:
            results[t] = create_commitments_batched([blobs[i] for i in windows[t]])
        except BaseException as e:  # raised below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in range(4)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    threads_ms = (time.perf_counter() - t0) * 1e3
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"threaded commitments failed: {errors}")
    for t, w in enumerate(windows):
        if results[t] != [want[i] for i in w]:
            raise AssertionError(f"thread {t}: commitments differ from create_commitment")
    log(f"[{card}] commitments from 4 threads at once (overlapping windows of 60 blobs): "
        f"all equal, {threads_ms:.3f} ms, memo {batched.memo_stats()}")

    # The square check: the builder places what fits in k=128, the card
    # extends it, the row trees give each placed blob's commitment back.
    rng = np.random.default_rng(128)
    builder, placed = Builder(128), []
    for i, b in enumerate(blobs):
        if builder.append_blob_tx(BlobTx(rng.bytes(200), (b,))):
            placed.append(i)
    sq = builder.export()
    if sq.size != 128 or 2 * len(placed) < len(blobs):
        raise AssertionError(f"the builder placed {len(placed)} of {len(blobs)} blobs in a "
                             f"k={sq.size} square")
    eds = extend_shares(sq.share_bytes())
    rows = {(p.start + i) // 128 for p in sq.placements for i in (0, p.share_count - 1)}
    rows = range(min(rows), max(rows) + 1)
    t0 = time.perf_counter()
    trees = {r: eds.row_tree(r, host=True) for r in rows}
    widths = set()
    for p in sq.placements:
        i = placed[p.pfb_index]
        got = commitment_from_row_trees(trees, p.start, p.share_count, 128)
        if got != first[i]:
            raise AssertionError(f"blob {i} ({p.share_count} shares at {p.start}): the row "
                                 f"trees' commitment != the batched one")
        widths.add(subtree_width(p.share_count, 64))
    if not {64, 128} <= widths:
        raise AssertionError(f"no placed blob of width 64 and 128 (widths {sorted(widths)})")
    log(f"[{card}] commitments: the builder placed {len(placed)} of {len(blobs)} blobs "
        f"({sum(p.share_count for p in sq.placements)} shares, subtree widths "
        f"{sorted(widths)}) in a k={sq.size} square; for every placed blob "
        f"commitment_from_row_trees(card EDS row trees) == the batched commitment "
        f"({(time.perf_counter() - t0) * 1e3:.3f} ms on the host for {len(rows)} rows)")
    return counts


# phase_app's chains (testutil.deterministic_genesis) and blocks
# (testutil.blocks.block_txs): a small golden block whose data root
# tests/test_torch_app.py pins from the JAX App, a k=128 block (the v3 cap)
# and a k=512 block under the big-block override.
APP_GOLDEN_HASH = "8791374a3d404fe00ebe222e097227c221505eaaf67ce4334c7280a00986c643"
APP_GOLDEN = {"n_keys": 4, "seed": 10, "sends": 3, "pfbs": 3, "blob_shares": (1, 4)}
APP_K = 128
APP_BLOCK = {"n_keys": 256, "seed": 128, "sends": 200, "pfbs": 320, "blob_shares": (20, 60)}
APP_BIG_K = 512
APP_BIG = {"n_keys": 256, "seed": 512, "sends": 100, "pfbs": 600, "blob_shares": (100, 150)}


def app_chain(spec: dict, gov_max_square_size: int):
    """(genesis, raw txs): a deterministic chain and one block of it."""
    from celestia_app_tpu_torch.testutil import deterministic_genesis, funded_keys
    from celestia_app_tpu_torch.testutil.blocks import block_txs

    keys = funded_keys(spec["n_keys"])
    genesis = deterministic_genesis(keys, gov_max_square_size=gov_max_square_size)
    txs = block_txs(keys, genesis.chain_id, seed=spec["seed"], sends=spec["sends"],
                    pfbs=spec["pfbs"], blob_shares=spec["blob_shares"])
    return genesis, txs


def fresh_app(genesis, **kwargs):
    from celestia_app_tpu_torch.app import App

    app = App(**kwargs)
    app.init_chain(genesis)
    return app


class Split:
    """Host ms spent inside named callables while `timing` is active (each
    replaced by a timing wrapper, then restored)."""

    def __init__(self, targets):
        self.targets = targets  # (owner, attribute, label)
        self.ms: dict[str, float] = {}

    def _timed(self, fn, label: str):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.ms[label] = self.ms.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
        return timed

    @contextlib.contextmanager
    def timing(self):
        with contextlib.ExitStack() as stack:
            for owner, name, label in self.targets:
                stack.enter_context(swapped(owner, name, self._timed(getattr(owner, name), label)))
            yield self


def app_split():
    from celestia_app_tpu_torch.app import app as app_mod
    from celestia_app_tpu_torch.crypto.keys import PublicKey
    from celestia_app_tpu_torch.square import builder

    return Split([
        (app_mod, "run_ante", "ante"),
        (PublicKey, "verify", "of which signature verify"),
        (app_mod, "validate_blob_tx", "blob validation"),
        (app_mod, "validate_blob_txs_batched", "blob validation"),
        (builder, "build", "square build"),
        (builder, "construct", "square build"),
        (app_mod.App, "_square_root", "extend + DAH (+ memo key)"),
    ])


def app_call(torch, fn):
    """(result, wall ms, launches, split ms) of one `fn()` with the
    commitment memo cleared first, ended by a synchronize."""
    from celestia_app_tpu_torch.inclusion import batched
    from celestia_app_tpu_torch.kernels import _build

    batched._COMMIT_MEMO.clear()
    split = app_split()
    torch.cuda.synchronize()
    _build.reset_launches()
    with split.timing():
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    return out, ms, dict(_build.LAUNCHES), split.ms


def describe_split(wall: float, split: dict) -> str:
    known = sum(v for k, v in split.items() if not k.startswith("of which"))
    parts = [f"{k} {v:.3f}" for k, v in split.items()]
    return f"{', '.join(parts)}, other (decode, classify) {wall - known:.3f} ms"


def block_blobs(txs) -> list:
    from celestia_app_tpu_torch.tx.envelopes import unmarshal_blob_tx

    return [b for t in txs if (btx := unmarshal_blob_tx(t)) is not None for b in btx.blobs]


def phase_app(torch, card: str) -> dict:
    """The ABCI proposal path: App.check_tx / prepare_proposal /
    process_proposal on the card, the chain built by the port's testutil.
    The golden block's data root == the JAX App's (pinned); the k=128 block:
    check_tx admits every tx, the card's BlockData == App(device="cpu")'s
    and its hash == the CPU extend_shares root, a non-proposer App accepts
    it and rejects a flipped blob byte, a wrong hash and a wrong square
    size; launches per Prepare and per non-proposer Process == one
    commitment batch + one extend (memo cleared); wall (median of 3) and its
    split, device busy and idle; one Prepare under CELESTIA_PIPE_FUSED=epi;
    an injected launch fault on every launch raises DeviceFault out of
    process_proposal (in the commitments; then in the extend, after the
    degradation ladder walked to its floor); a k=512 block under
    square_size_upper_bound=512.  Returns the launches per Prepare and per
    Process."""
    from celestia_app_tpu_torch.app import BlockData
    from celestia_app_tpu_torch.chaos import degrade
    from celestia_app_tpu_torch.da import extend_shares
    from celestia_app_tpu_torch.device import DeviceFault
    from celestia_app_tpu_torch.kernels import _build
    from celestia_app_tpu_torch.shares import Blob
    from celestia_app_tpu_torch.square import builder
    from celestia_app_tpu_torch.tx.envelopes import BlobTx, unmarshal_blob_tx

    def same(a, b) -> bool:
        return (a.txs, a.square_size, a.hash) == (b.txs, b.square_size, b.hash)

    # 1. The golden block.
    genesis, txs = app_chain(APP_GOLDEN, 64)
    got = fresh_app(genesis).prepare_proposal(txs)
    on_cpu = fresh_app(genesis, device="cpu").prepare_proposal(txs)
    if got.hash.hex() != APP_GOLDEN_HASH or len(got.txs) != len(txs) or not same(got, on_cpu):
        raise AssertionError(f"golden block: {got.hash.hex()} k={got.square_size} "
                             f"{len(got.txs)} txs, want {APP_GOLDEN_HASH} ({len(txs)} txs); "
                             f"CPU {on_cpu.hash.hex()}")
    log(f"[{card}] app golden block: {len(txs)} txs, k={got.square_size}, data root "
        f"{got.hash.hex()} == the pinned JAX App root == App(device='cpu')")

    # 2. The k=128 block.
    t0 = time.perf_counter()
    genesis, txs = app_chain(APP_BLOCK, APP_K)
    blobs = block_blobs(txs)
    n_pfbs = sum(unmarshal_blob_tx(t) is not None for t in txs)
    log(f"[{card}] app k={APP_K} block: {len(txs) - n_pfbs} sends + {n_pfbs} PFBs "
        f"({len(blobs)} blobs, {sum(len(b.data) for b in blobs) / 1e6:.3f} MB), "
        f"{APP_BLOCK['n_keys']} keys; keys, signatures and host commitments "
        f"{time.perf_counter() - t0:.3f} s")

    check = []
    for _ in range(3):
        app = fresh_app(genesis)
        per_tx, codes = [], []

        def admit_all():
            for t in txs:
                t1 = time.perf_counter()
                codes.append(app.check_tx(t).code)
                per_tx.append((time.perf_counter() - t1) * 1e3)
        _, ms, _, split = app_call(torch, admit_all)
        if any(codes):
            bad = [(i, c) for i, c in enumerate(codes) if c]
            raise AssertionError(f"check_tx rejected {len(bad)} txs: {bad[:8]}")
        is_pfb = [unmarshal_blob_tx(t) is not None for t in txs]
        check.append((ms, float(np.median([m for m, p in zip(per_tx, is_pfb) if not p])),
                      float(np.median([m for m, p in zip(per_tx, is_pfb) if p])), split))
    check.sort(key=lambda c: c[0])
    ms, send_ms, pfb_ms, split = check[1]
    log(f"[{card}] app check_tx: all {len(txs)} admitted; {ms:.3f} ms for all (median of "
        f"{[round(c[0], 3) for c in check]}), {ms / len(txs):.3f} ms per tx, median "
        f"{send_ms:.3f} ms per send, {pfb_ms:.3f} ms per PFB (commitment memo cleared "
        f"before each run); split: {describe_split(ms, split)}")

    prepares = [app_call(torch, (lambda a=fresh_app(genesis): a.prepare_proposal(txs)))
                for _ in range(3)]
    data = prepares[0][0]
    for p in prepares:
        if not same(p[0], data):
            raise AssertionError("two Prepares of one block differ")
    if data.square_size != APP_K or len(data.txs) != len(txs):
        raise AssertionError(f"Prepare kept {len(data.txs)} of {len(txs)} txs in a "
                             f"k={data.square_size} square, want all in k={APP_K}")
    t0 = time.perf_counter()
    on_cpu = fresh_app(genesis, device="cpu").prepare_proposal(txs)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    sq = builder.construct(list(data.txs), APP_K)
    cpu_root = extend_shares(sq.share_bytes(), device="cpu").data_root()
    if not same(on_cpu, data) or cpu_root != data.hash:
        raise AssertionError(f"k={APP_K} Prepare: card {data.hash.hex()}, App(device='cpu') "
                             f"{on_cpu.hash.hex()}, CPU extend_shares {cpu_root.hex()}")
    _build.reset_launches()
    extend_shares(sq.share_bytes()).data_root()
    want = {name: n + dict(_build.LAUNCHES)[name]
            for name, n in expected_commitment_launches(blobs).items()}
    for name in ("rs_xor", "rs_dense_leaf"):
        want[name] = 0
    check_launches(f"Prepare k={APP_K}", prepares[0][2], want)
    prepares.sort(key=lambda p: p[1])
    _, ms, launches, split = prepares[1]
    log(f"[{card}] app Prepare k={APP_K}: BlockData == App(device='cpu') ({cpu_ms:.3f} ms "
        f"on the CPU), hash {data.hash.hex()} == CPU extend_shares; {ms:.3f} ms (median of "
        f"{[round(p[1], 3) for p in prepares]}); split: {describe_split(ms, split)}; "
        f"launches {launches} == one commitment batch + one extend")

    processes = [app_call(torch, (lambda a=fresh_app(genesis): a.process_proposal(data)))
                 for _ in range(3)]
    if not all(p[0] is True for p in processes):
        raise AssertionError(f"a non-proposer rejected the k={APP_K} proposal")
    check_launches(f"non-proposer Process k={APP_K}", processes[0][2], want)
    processes.sort(key=lambda p: p[1])
    _, ms, launches, split = processes[1]
    log(f"[{card}] app non-proposer Process k={APP_K}: accepted; {ms:.3f} ms (median of "
        f"{[round(p[1], 3) for p in processes]}); split: {describe_split(ms, split)}; "
        f"launches {launches}")

    # Three tampered proposals, on a non-proposer that accepted the block.
    validator = fresh_app(genesis)
    if not validator.process_proposal(data):
        raise AssertionError("the validator rejected the honest proposal")
    i = next(i for i, t in enumerate(data.txs) if unmarshal_blob_tx(t) is not None)
    btx = unmarshal_blob_tx(data.txs[i])
    blob = btx.blobs[0]
    flipped = Blob(blob.namespace, blob.data[:-1] + bytes([blob.data[-1] ^ 1]), blob.share_version)
    evil = BlobTx(btx.tx, (flipped,) + tuple(btx.blobs[1:])).marshal()
    tampered = {
        "a blob byte flipped": BlockData(data.txs[:i] + (evil,) + data.txs[i + 1:],
                                         data.square_size, data.hash),
        "a wrong hash": BlockData(data.txs, data.square_size,
                                  bytes([data.hash[0] ^ 1]) + data.hash[1:]),
        "a wrong square size": BlockData(data.txs, 2 * data.square_size, data.hash),
    }
    for what, bad in tampered.items():
        if validator.process_proposal(bad) is not False:
            raise AssertionError(f"the validator accepted a proposal with {what}")
    log(f"[{card}] app: the non-proposer rejects {', '.join(tampered)}")

    # Device busy and idle, and the host's functions, over one call each.
    from celestia_app_tpu_torch.inclusion import batched

    for label, make in (("Prepare", lambda a: (lambda: a.prepare_proposal(txs))),
                        ("non-proposer Process", lambda a: (lambda: a.process_proposal(data)))):
        batched._COMMIT_MEMO.clear()
        device_breakdown(torch, make(fresh_app(genesis)), card, f"app {label} k={APP_K}")
    batched._COMMIT_MEMO.clear()
    host_breakdown(torch, (lambda a=fresh_app(genesis): a.prepare_proposal(txs)), card,
                   f"app Prepare k={APP_K}", top=12)

    # One Prepare under the epilogue lowering.
    with environment({"CELESTIA_PIPE_FUSED": "epi"}):
        epi, epi_ms, epi_launches, _ = app_call(
            torch, (lambda a=fresh_app(genesis): a.prepare_proposal(txs)))
    if not same(epi, data) or epi_launches["rs_dense_leaf"] < 1:
        raise AssertionError(f"Prepare under CELESTIA_PIPE_FUSED=epi: {epi.hash.hex()}, "
                             f"launches {epi_launches}")
    log(f"[{card}] app Prepare k={APP_K} under CELESTIA_PIPE_FUSED=epi: the same BlockData, "
        f"{epi_ms:.3f} ms, launches {epi_launches}")

    # An injected launch fault, on every launch for the whole call, raises
    # out of process_proposal: first in the commitments (memo cleared; no
    # ladder under them, as in the JAX package), then in the extend (memo
    # warm), whose guarded dispatch first walks the degradation ladder to
    # its floor (chaos/degrade.py); the ladder is re-armed after.
    def failing_launch(kernel, *args, **kwargs):
        raise RuntimeError(f"injected launch fault in {kernel}")

    for where, memo_warm, names, ladder in (
            ("the commitments", False, "blob share commitments", None),
            ("the extend", True, "extend + DAH", {"device": "host"})):
        app = fresh_app(genesis)
        batched._COMMIT_MEMO.clear()
        if memo_warm:
            batched.create_commitments_batched(blobs)
        try:
            with swapped(_build, "launch", failing_launch):
                verdict = app.process_proposal(data)
        except DeviceFault as e:
            state = degrade.degraded_state()
            degrade.reset_for_tests()
            if "injected launch fault" not in repr(e.__cause__) or names not in str(e) \
                    or state != ladder:
                raise AssertionError(f"not the injected fault in {where}, or the ladder at "
                                     f"{state}: {e!r}") from e
            log(f"[{card}] app: an injected launch fault in {where} raises {e!r}; the ladder "
                f"{'walked to ' + state['device'] + ' first' if state else 'did not move'}")
        else:
            raise AssertionError(f"process_proposal returned {verdict} on a launch fault "
                                 f"in {where}")

    # The big-block override: k=512.
    t0 = time.perf_counter()
    big_genesis, big_txs = app_chain(APP_BIG, APP_BIG_K)
    made_s = time.perf_counter() - t0
    big, big_ms, big_launches, big_split = app_call(
        torch, (lambda a=fresh_app(big_genesis, square_size_upper_bound=APP_BIG_K):
                a.prepare_proposal(big_txs)))
    if big.square_size != APP_BIG_K or len(big.txs) != len(big_txs):
        raise AssertionError(f"k={APP_BIG_K} Prepare kept {len(big.txs)} of {len(big_txs)} "
                             f"txs in a k={big.square_size} square")
    big_sq = builder.construct(list(big.txs), APP_BIG_K)
    big_root = extend_shares(big_sq.share_bytes(), device="cpu").data_root()
    accepted, big_process_ms, big_process_launches, big_process_split = app_call(
        torch, (lambda a=fresh_app(big_genesis, square_size_upper_bound=APP_BIG_K):
                a.process_proposal(big)))
    if big_root != big.hash or accepted is not True:
        raise AssertionError(f"k={APP_BIG_K}: card {big.hash.hex()}, CPU extend_shares "
                             f"{big_root.hex()}, non-proposer verdict {accepted}")
    log(f"[{card}] app k={APP_BIG_K} block (square_size_upper_bound={APP_BIG_K}): "
        f"{len(big_txs)} txs ({made_s:.3f} s to make), {big_sq.accounting.used_shares} shares "
        f"used; hash == CPU extend_shares; Prepare {big_ms:.3f} ms ({describe_split(big_ms, big_split)}), "
        f"launches {big_launches}; non-proposer Process accepted, {big_process_ms:.3f} ms "
        f"({describe_split(big_process_ms, big_process_split)}), launches {big_process_launches}")
    for label, n in (("Prepare", big_launches), ("Process", big_process_launches)):
        check_launches(f"{label} k={APP_BIG_K}", n,
                       {"sha256_leaf": None, "sha256": None, "rs_dense": None})
    return {"prepare": prepares[1][2], "process": processes[1][2]}


# phase_chain: the app hash after the golden chain's first block (APP_GOLDEN's
# txs through Prepare and Process, finalized at GENESIS_TIME_NS +
# BLOCK_INTERVAL_NS with every genesis validator in the last commit), which
# tests/test_torch_finalize.py pins from the JAX App; and the k=128 chain's
# height count (APP_BLOCK's chain; height 2 is a new block of the same spec,
# signed at the sequences the chain's state holds; two heights, not three, to
# leave the script's time for phase_node).
CHAIN_GOLDEN_APP_HASH = "cd64aec07f3f4f72bc51d3677d4a95f45494792d9c76e6ce690bd9e04f98092d"
CHAIN_HEIGHTS = 2


def chain_split():
    """FinalizeBlock's host time by part: the ante chain (and the signature
    verifies inside it), the message handlers, the begin and end blockers."""
    from celestia_app_tpu_torch.app import App
    from celestia_app_tpu_torch.app import app as app_mod
    from celestia_app_tpu_torch.crypto.keys import PublicKey

    return Split([
        (app_mod, "run_ante", "ante"),
        (PublicKey, "verify", "of which signature verify"),
        (App, "_handle_msg", "message execution"),
        (App, "_begin_block", "begin + end block"),
        (App, "_end_block", "begin + end block"),
    ])


CHAIN_PARTS = ("ante", "of which signature verify", "message execution", "begin + end block")


def describe_parts(parts: dict) -> str:
    return ", ".join(f"{k} {parts.get(k, 0.0):.3f}" for k in CHAIN_PARTS)


def tx_results(results) -> list[tuple]:
    return [(r.code, r.log, r.gas_wanted, r.gas_used, r.events) for r in results]


def phase_chain(torch, card: str) -> dict:
    """Block execution on the card: a chain of Prepare -> Process ->
    FinalizeBlock -> Commit, height after height.  The golden chain's first
    block gives the app hash pinned from the JAX App.  Then CHAIN_HEIGHTS
    k=128 heights (APP_BLOCK's chain, 256 keys, 200 sends + 320 PFBs each):
    a proposer App on the card prepares, a second card App accepts (the
    commitment memo cleared before each, as on two nodes), and both run
    finalize_block with every validator in the last commit, then commit.
    Both card Apps give the same TxResults (code, log, gas, events; every
    tx code 0) and app hash, and so does an App(device="cpu") that
    finalizes the same txs; no kernel launches across Finalize + Commit;
    after the commit check_tx refuses a tx at a committed sequence, and
    simulate_tx of a new PFB gives the CPU App's gas.  Logs Finalize (median
    of the heights, split into ante, signature verify, message execution,
    begin + end block), Commit, the height's wall and its device idle share
    (torch.profiler, device activity only).  Returns one height's launches
    per Prepare, Process, Finalize and Commit."""
    from celestia_app_tpu_torch.inclusion import batched
    from celestia_app_tpu_torch.kernels import _build
    from celestia_app_tpu_torch.testutil import BLOCK_INTERVAL_NS, GENESIS_TIME_NS, funded_keys
    from celestia_app_tpu_torch.testutil.blocks import block_txs, next_sequences
    from celestia_app_tpu_torch.tx.envelopes import unmarshal_blob_tx

    # 1. The golden chain's first block.
    genesis, txs = app_chain(APP_GOLDEN, 64)
    signers = {v.address for v in genesis.validators}
    app = fresh_app(genesis)
    data = app.prepare_proposal(txs)
    if data.txs != tuple(txs) or fresh_app(genesis).process_proposal(data) is not True:
        raise AssertionError(f"golden chain: Prepare kept {len(data.txs)} of {len(txs)} txs "
                             f"or the second App rejected it")
    results = app.finalize_block(GENESIS_TIME_NS + BLOCK_INTERVAL_NS, list(data.txs),
                                 last_commit_signers=signers)
    golden = app.commit().hex()
    if golden != CHAIN_GOLDEN_APP_HASH or any(r.code for r in results):
        raise AssertionError(f"golden chain: app hash {golden}, codes "
                             f"{[r.code for r in results]}; want {CHAIN_GOLDEN_APP_HASH}")
    log(f"[{card}] chain golden block: {len(txs)} txs all code 0, app hash {golden} == the "
        f"pinned JAX App hash")

    # 2. The k=128 chain.
    t0 = time.perf_counter()
    keys = funded_keys(APP_BLOCK["n_keys"])
    genesis, first = app_chain(APP_BLOCK, APP_K)
    signers = {v.address for v in genesis.validators}
    proposer, validator = fresh_app(genesis), fresh_app(genesis)
    on_cpu = fresh_app(genesis, device="cpu")
    log(f"[{card}] chain k={APP_K}: genesis of {len(keys)} keys, three Apps "
        f"({time.perf_counter() - t0:.3f} s)")
    rows = []
    for h in range(1, CHAIN_HEIGHTS + 1):
        t0 = time.perf_counter()
        txs = first if h == 1 else block_txs(
            keys, genesis.chain_id, seed=APP_BLOCK["seed"] + h, sends=APP_BLOCK["sends"],
            pfbs=APP_BLOCK["pfbs"], blob_shares=APP_BLOCK["blob_shares"],
            sequences=next_sequences(proposer, keys))
        made_s = time.perf_counter() - t0
        time_ns = proposer.last_block_time_ns + BLOCK_INTERVAL_NS
        row: dict = {"height": h, "made_s": made_s}

        def timed(label: str, fn):
            torch.cuda.synchronize()
            _build.reset_launches()
            t1 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            row[label] = ((time.perf_counter() - t1) * 1e3, dict(_build.LAUNCHES))
            return out

        def height():
            batched._COMMIT_MEMO.clear()
            data = timed("prepare", lambda: proposer.prepare_proposal(txs))
            batched._COMMIT_MEMO.clear()
            row["accepted"] = timed("process", lambda: validator.process_proposal(data))
            row["data"] = data
            for name, app in (("proposer", proposer), ("validator", validator)):
                split = chain_split()
                with split.timing():
                    row[f"results {name}"] = timed(f"finalize {name}", lambda a=app: a.finalize_block(
                        time_ns, list(data.txs), last_commit_signers=signers))
                row[f"split {name}"] = split.ms
                row[f"hash {name}"] = timed(f"commit {name}", app.commit)

        wall_us, spans = profiled_spans(torch, height, host=False)
        busy_us = sum(b - a for a, b in merged(spans))
        row["wall_ms"], row["busy_ms"] = wall_us / 1e3, busy_us / 1e3
        row["idle"] = 100 - 100 * busy_us / wall_us if spans else None
        data = row["data"]
        if row["accepted"] is not True or data.square_size != APP_K or len(data.txs) != len(txs):
            raise AssertionError(f"height {h}: Prepare kept {len(data.txs)} of {len(txs)} txs "
                                 f"in k={data.square_size}; the second App's verdict "
                                 f"{row['accepted']}")
        t0 = time.perf_counter()
        cpu_results = on_cpu.finalize_block(time_ns, list(data.txs), last_commit_signers=signers)
        cpu_hash = on_cpu.commit()
        row["cpu_ms"] = (time.perf_counter() - t0) * 1e3
        want = tx_results(cpu_results)
        for name in ("proposer", "validator"):
            got = tx_results(row[f"results {name}"])
            if got != want or row[f"hash {name}"] != cpu_hash:
                bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
                raise AssertionError(f"height {h}: the {name}'s TxResults differ from "
                                     f"App(device='cpu')'s at {bad[:8]} or its app hash "
                                     f"{row[f'hash {name}'].hex()} != {cpu_hash.hex()}")
            for step in ("finalize", "commit"):
                check_launches(f"height {h} {step} ({name})", row[f"{step} {name}"][1],
                               {kernel: 0 for kernel in KERNELS})
        codes = [r[0] for r in want]
        if any(codes):
            raise AssertionError(f"height {h}: codes {[(i, c) for i, c in enumerate(codes) if c][:8]}")
        for step in ("prepare", "process"):
            check_launches(f"height {h} {step}", row[step][1],
                           {"sha256_leaf": None, "sha256": None, "rs_dense": 2})
        refused = proposer.check_tx(data.txs[0])
        if refused.code == 0:
            raise AssertionError(f"height {h}: check_tx admitted a tx at a committed sequence")
        probe = block_txs(keys, genesis.chain_id, seed=10_000 + h, sends=0, pfbs=1,
                          blob_shares=APP_BLOCK["blob_shares"],
                          sequences=next_sequences(proposer, keys))[0]
        simulated = [a.simulate_tx(probe) for a in (proposer, on_cpu)]
        if (tx_results(simulated[:1]) != tx_results(simulated[1:]) or simulated[0].code
                or simulated[0].gas_used <= 0 or unmarshal_blob_tx(probe) is None):
            raise AssertionError(f"height {h}: simulate_tx of a PFB on the card "
                                 f"{tx_results(simulated[:1])}, on the CPU {tx_results(simulated[1:])}")
        row["simulated_gas"] = simulated[0].gas_used
        rows.append(row)
        split = row["split proposer"]
        idle = "not measured" if row["idle"] is None else f"{row['idle']:.2f} %"
        log(f"[{card}] chain height {h}: {len(data.txs)} txs all code 0 ({made_s:.3f} s to sign); "
            f"app hash {cpu_hash.hex()} on both card Apps == App(device='cpu') (finalize + "
            f"commit {row['cpu_ms']:.3f} ms); Prepare {row['prepare'][0]:.3f} ms, Process "
            f"{row['process'][0]:.3f} ms, Finalize {row['finalize proposer'][0]:.3f} / "
            f"{row['finalize validator'][0]:.3f} ms (proposer / validator; "
            f"{describe_parts(split)}), Commit "
            f"{row['commit proposer'][0]:.3f} / {row['commit validator'][0]:.3f} ms; height "
            f"{row['wall_ms']:.3f} ms, device busy {row['busy_ms']:.3f} ms, idle "
            f"{idle}; "
            f"check_tx refuses a committed sequence (code {refused.code}); simulate_tx of a PFB "
            f"gas_used {row['simulated_gas']} == the CPU App's")

    def median(values):
        return float(np.median(values))

    fin = [r["finalize proposer"][0] for r in rows]
    parts = {k: median([r["split proposer"].get(k, 0.0) for r in rows]) for k in CHAIN_PARTS}
    log(f"[{card}] chain k={APP_K} over {CHAIN_HEIGHTS} heights (median): Finalize "
        f"{median(fin):.3f} ms of {[round(v, 3) for v in fin]} ("
        f"{describe_parts(parts)}); Commit "
        f"{median([r['commit proposer'][0] for r in rows]):.3f} ms; Prepare "
        f"{median([r['prepare'][0] for r in rows]):.3f} ms; Process "
        f"{median([r['process'][0] for r in rows]):.3f} ms; height "
        f"{median([r['wall_ms'] for r in rows]):.3f} ms, idle "
        f"{[None if r['idle'] is None else round(r['idle'], 3) for r in rows]} %")
    last = rows[-1]
    return {step: last[key][1] for step, key in (
        ("prepare", "prepare"), ("process", "process"),
        ("finalize", "finalize proposer"), ("commit", "commit proposer"))}


# phase_node: a short txsim load on a TestNode (NODE_GOLDEN's keys, seed and
# blocks; the sequences of node_golden_run), whose final app hash and tx index
# digest tests/test_torch_node.py pins from the JAX TestNode.
NODE_GOLDEN = {"n_keys": 4, "seed": 12, "blocks": 4}
NODE_GOLDEN_APP_HASH = "bd13fbc7c479edc82bf50c7e081e72edb5735fad7576e8559b5eace9c3ed6555"
NODE_GOLDEN_INDEX = "b2bc4053ff7533706b87d69bccf1f7e4cba636ccee15fe5ec1df030439c5e0af"


def node_golden_run(node, keys, txsim) -> dict:
    """NODE_GOLDEN's txsim load on `node`; `txsim` is the txsim.run module of
    either package."""
    sequences = [txsim.BlobSequence(blobs_per_pfb=(1, 2), blob_size=(100, 2500)),
                 txsim.SendSequence(), txsim.StakeSequence(initial_stake=500_000)]
    return txsim.run(node, keys, sequences, blocks=NODE_GOLDEN["blocks"],
                     seed=NODE_GOLDEN["seed"])


def index_digest(tx_index: dict) -> str:
    """sha256 of a node's tx index, (hash hex, height, code, log) sorted."""
    rows = sorted((h.hex(), height, code, log) for h, (height, code, log) in tx_index.items())
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def node_txs(keys, chain_id: str) -> list[bytes]:
    """Two blocks' worth of APP_BLOCK's txs for a fresh chain: the second
    block's signed at the sequences that follow the first's."""
    from celestia_app_tpu_torch.testutil.blocks import block_txs

    spec = APP_BLOCK
    n = spec["sends"] + spec["pfbs"]
    after = [len(range(i, n, len(keys))) for i in range(len(keys))]
    return [t for seed, seqs in ((spec["seed"], None), (spec["seed"] + 1, after))
            for t in block_txs(keys, chain_id, seed=seed, sends=spec["sends"],
                               pfbs=spec["pfbs"], blob_shares=spec["blob_shares"],
                               sequences=seqs)]


def node_split(node):
    """produce_block's host time by part (the mempool's reap, the four ABCI
    calls, the pool's update; CheckTx inside produce_block is the recheck),
    and broadcast's (CheckTx, then the admission into the pool)."""
    return Split([
        (node.mempool, "reap", "reap"),
        (node.app, "prepare_proposal", "Prepare"),
        (node.app, "process_proposal", "Process"),
        (node.app, "finalize_block", "Finalize"),
        (node.app, "commit", "Commit"),
        (node.mempool, "update", "update"),
        (node.app, "check_tx", "CheckTx"),
        (node.mempool, "insert", "admission"),
    ])


NODE_PARTS = ("reap", "Prepare", "Process", "Finalize", "Commit", "update", "recheck")
# The namespace label cap of phase_node ($CELESTIA_NAMESPACE_TOP_N).  The cap
# is process-wide, first come first admitted, and the squares of the earlier
# phases (phase_block's alone hold hundreds of namespaces) fill its default
# of 20; the DRR reap takes turns by capped label, so with room for every
# label the process sees, this phase's blocks do not depend on which phases
# ran before it.
NODE_TOP_N = 1 << 16


def phase_node(torch, card: str) -> dict:
    """The in-process node on the card: TxClient / txsim -> TestNode.broadcast
    (CheckTx, then admission to the sharded pool) -> produce_block (reap under
    Block.MaxBytes, Prepare, Process, Finalize, Commit, the pool's update and
    recheck, the tx index).
      1. NODE_GOLDEN's txsim load on a card TestNode: its app hash and tx
         index digest == the JAX TestNode's (pinned).
      2. APP_BLOCK's chain (256 keys, k=128): two blocks' worth of txs
         (node_txs) broadcast to a card TestNode and a TestNode(device="cpu");
         every CheckTx code 0 on both, the same pool; two heights, the
         first a k=128 one with the reap budget binding (DRR across
         namespaces): BlockData, TxResults and app hash card == CPU, the
         pool after each height too.
         The global pool ($CELESTIA_MEMPOOL_SHARDS=0) fed the same admissions
         reaps the same txs on both, and a card App and a CPU App prepare
         the same block of them.
      3. Network(3) on the card for one k=128 height of APP_BLOCK's first
         block: the three app hashes agree and equal a CPU Network(1)'s (one
         CPU App: the height's block and app hash do not depend on how many
         Apps replicate it, and the CPU's are the slow ones).
      4. qos.install of a spec that blocks one tenant: the card node and the
         CPU node raise QosThrottled on the same broadcast, same payload.
      5. An injected launch fault during a broadcast raises DeviceFault and
         leaves the pool as it was.
    Logs broadcast ms per tx (CheckTx, admission), each height's
    produce_block split (reap, Prepare, Process, Finalize, Commit, update,
    recheck), launches per height and per recheck, the device idle share of
    a height (torch.profiler, device activity only).  Returns one height's
    launches and its recheck's."""
    with environment({"CELESTIA_NAMESPACE_TOP_N": str(NODE_TOP_N)}):
        return _phase_node(torch, card)


def _phase_node(torch, card: str) -> dict:
    import importlib

    from celestia_app_tpu_torch import qos
    from celestia_app_tpu_torch.device import DeviceFault
    from celestia_app_tpu_torch.inclusion import batched
    from celestia_app_tpu_torch.kernels import _build
    from celestia_app_tpu_torch.mempool import PriorityMempool
    from celestia_app_tpu_torch.state.dec import Dec
    from celestia_app_tpu_torch.testutil import TestNode, deterministic_genesis, funded_keys
    from celestia_app_tpu_torch.testutil.blocks import block_txs, next_sequences
    from celestia_app_tpu_torch.testutil.network import Network
    from celestia_app_tpu_torch.testutil.testnode import NODE_MIN_GAS_PRICE
    from celestia_app_tpu_torch.trace.square_journal import (
        capped_namespace_label,
        namespace_top_n,
        namespaces_payload,
        tx_namespace_label,
    )

    txsim = importlib.import_module("celestia_app_tpu_torch.txsim.run")

    def same(a, b) -> bool:
        return (a.txs, a.square_size, a.hash) == (b.txs, b.square_size, b.hash)

    log(f"[{card}] node: {namespaces_payload()['admitted']} namespace labels admitted by "
        f"the earlier phases, cap {namespace_top_n()}")

    # 1. The golden txsim load.
    t0 = time.perf_counter()
    keys = funded_keys(NODE_GOLDEN["n_keys"])
    node = TestNode(deterministic_genesis(keys), keys)
    stats = node_golden_run(node, keys, txsim)
    got, digest = node.app.cms.last_app_hash.hex(), index_digest(node.tx_index)
    if (got, digest) != (NODE_GOLDEN_APP_HASH, NODE_GOLDEN_INDEX) or stats["failed"]:
        raise AssertionError(f"node golden: app hash {got}, index {digest}, {stats}; want "
                             f"{NODE_GOLDEN_APP_HASH}, {NODE_GOLDEN_INDEX}")
    log(f"[{card}] node golden: txsim {stats} over {len(node.blocks)} blocks (k="
        f"{[b.square_size for b in node.blocks]}), app hash {got} and tx index digest "
        f"{digest} == the pinned JAX TestNode's ({time.perf_counter() - t0:.3f} s)")

    # 2. Two blocks' worth of txs on a card node and a CPU node.
    t0 = time.perf_counter()
    keys = funded_keys(APP_BLOCK["n_keys"])
    genesis = deterministic_genesis(keys, gov_max_square_size=APP_K)
    txs = node_txs(keys, genesis.chain_id)
    made_s = time.perf_counter() - t0
    on_card, on_cpu = TestNode(genesis, keys), TestNode(genesis, keys, device="cpu")
    splits = {"card": node_split(on_card), "cpu": node_split(on_cpu)}
    checked: dict = {}
    per_tx = []
    blobs = block_blobs(txs)
    for name, node in (("card", on_card), ("cpu", on_cpu)):
        batched._COMMIT_MEMO.clear()
        if name == "cpu":
            # The nodes of one process share the commitment memo: fill it
            # on the CPU in one batch, held equal to what the card node's
            # CheckTx computed, instead of one plain call per blob.
            t0 = time.perf_counter()
            cpu_commitments = batched.create_commitments_batched(blobs, device="cpu")
            commit_s = time.perf_counter() - t0
            if cpu_commitments != card_commitments:
                raise AssertionError("the card node's blob commitments differ from the CPU's")
        torch.cuda.synchronize()
        with splits[name].timing():
            t0 = time.perf_counter()
            checked[name] = [node.broadcast(t) for t in txs]
            torch.cuda.synchronize()
            per_tx.append((time.perf_counter() - t0) * 1e3 / len(txs))
        if name == "card":
            card_commitments = batched.create_commitments_batched(blobs)  # memo hits
    codes = {name: [r.code for r in res] for name, res in checked.items()}
    if codes["card"] != codes["cpu"] or any(codes["card"]):
        bad = [(i, c) for i, c in enumerate(codes["card"]) if c]
        raise AssertionError(f"broadcast: card codes {bad[:8]}, CPU equal {codes['card'] == codes['cpu']}")
    if on_card.mempool.resident_txs() != on_cpu.mempool.resident_txs():
        raise AssertionError("broadcast: the card node's pool differs from the CPU node's")
    bcast = splits["card"].ms
    n_pfbs = sum(tx_namespace_label(t) is not None for t in txs)
    resident = on_card.mempool.size_bytes()
    log(f"[{card}] node broadcast: {len(txs)} txs ({len(txs) - n_pfbs} sends + {n_pfbs} PFBs, "
        f"{resident / 1e6:.3f} MB resident against a reap budget of "
        f"{on_card.block_max_bytes() / 1e6:.3f} MB; {made_s:.3f} s to sign), all admitted on "
        f"both; {per_tx[0]:.3f} ms per tx on the card node (CheckTx "
        f"{bcast['CheckTx'] / len(txs):.3f}, admission {bcast['admission'] / len(txs):.4f}), "
        f"{per_tx[1]:.3f} ms on the CPU node (its {len(blobs)} blob commitments made on the "
        f"CPU in one batch first, {commit_s:.3f} s, == the card node's); the pools are equal "
        f"({len(on_card.mempool)} txs in {on_card.mempool.shards} shards)")

    heights = []
    for h in (1, 2):
        rows = {}
        for name, node in (("card", on_card), ("cpu", on_cpu)):
            split = node_split(node)
            marks = {}
            inner = node.mempool.resident_txs

            def resident_txs(inner=inner, marks=marks):
                marks["recheck"] = (time.perf_counter(), dict(_build.LAUNCHES))
                return inner()

            torch.cuda.synchronize()
            _build.reset_launches()
            with split.timing(), swapped(node.mempool, "resident_txs", resident_txs):
                t0 = time.perf_counter()
                if name == "card" and h == 1:
                    out = {}
                    wall_us, spans = profiled_spans(
                        torch, lambda: out.setdefault("r", node.produce_block()), host=False)
                    data, results = out["r"]
                    busy = sum(b - a for a, b in merged(spans))
                    idle = 100 - 100 * busy / wall_us if spans else None
                    wall = wall_us / 1e3  # the profiler's start-up left out
                else:
                    data, results = node.produce_block()
                    busy = idle = None
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
            end = dict(_build.LAUNCHES)
            ms = dict(split.ms)
            ms["recheck"] = ms.pop("CheckTx", 0.0)
            rows[name] = {
                "data": data, "results": tx_results(results), "hash": node.app.cms.last_app_hash,
                "wall": wall, "ms": ms, "busy": busy, "idle": idle,
                "launches": end,
                "recheck_launches": {k: end[k] - marks["recheck"][1][k] for k in end},
                "pool": node.mempool.resident_txs(),
            }
        c, p = rows["card"], rows["cpu"]
        if not same(c["data"], p["data"]) or c["results"] != p["results"] or c["hash"] != p["hash"]:
            raise AssertionError(f"height {h}: card BlockData / TxResults / app hash differ from "
                                 f"the CPU node's ({c['hash'].hex()} vs {p['hash'].hex()})")
        if c["pool"] != p["pool"]:
            raise AssertionError(f"height {h}: the card node's pool differs from the CPU node's")
        if (h == 1 and c["data"].square_size != APP_K) or any(r[0] for r in c["results"]):
            raise AssertionError(f"height {h}: k={c['data'].square_size}, codes "
                                 f"{[r[0] for r in c['results'] if r[0]][:8]}")
        check_launches(f"node height {h}", c["launches"],
                       {"sha256_leaf": None, "sha256": None, "rs_dense": 2})
        heights.append(c)
        parts, cpu_parts = (", ".join(f"{k} {r['ms'].get(k, 0.0):.3f}" for k in NODE_PARTS)
                            for r in (c, p))
        device = ("device busy not measured" if c["idle"] is None else
                  f"device busy {c['busy'] / 1e3:.3f} ms, idle {c['idle']:.3f} %")
        log(f"[{card}] node height {h}: {len(c['data'].txs)} txs, k={c['data'].square_size}, "
            f"all code 0; BlockData, TxResults and app hash {c['hash'].hex()} == the CPU "
            f"node's; pool after: {len(c['pool'])} txs == the CPU node's; produce_block "
            f"{c['wall']:.3f} ms ({parts}; CPU node {p['wall']:.3f} ms: {cpu_parts}); launches "
            f"{c['launches']}, of them the recheck's {c['recheck_launches']}; {device}")
    first_reap = list(heights[0]["data"].txs)

    # The global pool: the same admissions, the same reap on card and CPU.
    with environment({"CELESTIA_MEMPOOL_SHARDS": "0"}):
        pools = [PriorityMempool(), PriorityMempool()]
    budget = on_card.block_max_bytes()
    for t, res in zip(txs, checked["card"]):
        prio = next(e[1] for e in res.events if e[0] == "priority")
        for pool in pools:
            pool.insert(t, prio, 0)
    reaps = [pool.reap(budget) for pool in pools]
    if pools[0].shards != 0 or reaps[0] != reaps[1]:
        raise AssertionError(f"global pool: shards {pools[0].shards}, reaps differ")
    blocks = [fresh_app(genesis, node_min_gas_price=Dec.from_str(NODE_MIN_GAS_PRICE),
                        **kw).prepare_proposal(reaps[0]) for kw in ({}, {"device": "cpu"})]
    if not same(*blocks):
        raise AssertionError("global pool: the card App's block differs from the CPU App's")
    log(f"[{card}] node under CELESTIA_MEMPOOL_SHARDS=0: {len(reaps[0])} txs reaped in pure "
        f"priority order, the same on two pools; card Prepare == CPU Prepare: "
        f"{len(blocks[0].txs)} txs, k={blocks[0].square_size}, {blocks[0].hash.hex()} (the "
        f"sharded node's DRR reap gave a block of {len(first_reap)} txs)")

    # 3. Network(3) on the card for one k=128 height.
    first = txs[:APP_BLOCK["sends"] + APP_BLOCK["pfbs"]]
    nets = {}
    for name, n, kw in (("card", 3, {}), ("cpu", 1, {"device": "cpu"})):
        net = Network(n, genesis, keys, **kw)
        if any(net.broadcast(t).code for t in first):
            raise AssertionError(f"Network ({name}): a broadcast was rejected")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data, results = net.produce_block()
        torch.cuda.synchronize()
        nets[name] = (data, tx_results(results), [n.cms.last_app_hash for n in net.nodes],
                      (time.perf_counter() - t0) * 1e3)
    (cd, cr, ch, cms), (pd, pr, ph, pms) = nets["card"], nets["cpu"]
    if len(set(ch)) != 1 or set(ch) != set(ph) or not same(cd, pd) or cr != pr \
            or len(cd.txs) != len(first):
        raise AssertionError(f"Network(3): card hashes {[h.hex()[:16] for h in ch]}, CPU "
                             f"{[h.hex()[:16] for h in ph]}, {len(cd.txs)} of {len(first)} txs")
    log(f"[{card}] node Network(3): one k={cd.square_size} height of {len(cd.txs)} txs, the "
        f"three card app hashes {ch[0].hex()} agree and == the CPU Network(1)'s; {cms:.3f} ms "
        f"on the card, {pms:.3f} ms on the CPU")

    # 4. QoS: one tenant blocked, on a fresh card node and CPU node.  The
    # seed is APP_BLOCK's, so the blobs' namespaces are tenants the label cap
    # has admitted already (trace/square_journal.py).
    small = funded_keys(4)
    small_genesis = deterministic_genesis(small)
    offered = block_txs(small, small_genesis.chain_id, seed=APP_BLOCK["seed"], sends=2,
                        pfbs=6, blob_shares=(1, 4))
    tenant = capped_namespace_label(tx_namespace_label(offered[-1]))
    outcomes = []
    try:
        qos.install(f"{tenant}.tx_rate=0")
        for kw in ({}, {"device": "cpu"}):
            node, seen = TestNode(small_genesis, small, **kw), []
            for t in offered:
                try:
                    seen.append(node.broadcast(t).code)
                except qos.QosThrottled as e:
                    seen.append(qos.throttle_body(e))
            outcomes.append((seen, node.mempool.resident_txs()))
    finally:
        qos.uninstall()
    refused = [o for o in outcomes[0][0] if isinstance(o, bytes)]
    if outcomes[0] != outcomes[1] or not refused or 0 not in outcomes[0][0]:
        raise AssertionError(f"QoS: card {outcomes[0][0]} vs CPU {outcomes[1][0]}")
    log(f"[{card}] node QoS: tenant {tenant} at tx_rate=0: {len(refused)} of {len(offered)} "
        f"broadcasts refused on the card node and the same on the CPU node, the same pools; "
        f"{refused[0].decode()}")

    # 5. An injected launch fault during a broadcast.
    def failing_launch(kernel, *args, **kwargs):
        raise RuntimeError(f"injected launch fault in {kernel}")

    fresh = block_txs(keys, genesis.chain_id, seed=9_001, sends=0, pfbs=1,
                      blob_shares=APP_BLOCK["blob_shares"],
                      sequences=next_sequences(on_card.app, keys))[0]
    before = on_card.mempool.resident_txs()
    batched._COMMIT_MEMO.clear()
    try:
        with swapped(_build, "launch", failing_launch):
            on_card.broadcast(fresh)
    except DeviceFault as e:
        if "injected launch fault" not in repr(e.__cause__):
            raise AssertionError(f"broadcast: not the injected fault: {e!r}") from e
        log(f"[{card}] node: an injected launch fault in a broadcast raises {e!r}")
    else:
        raise AssertionError("broadcast admitted a tx through a launch fault")
    if on_card.mempool.resident_txs() != before:
        raise AssertionError("broadcast: the pool changed on a device fault")
    last = heights[-1]
    return {"height": last["launches"], "recheck": last["recheck_launches"]}


#: phase_consensus: a 4-validator genesis, 3 validators live.  Validator 3,
#: the round-0 proposer of height 3 in the rotation (addresses sorted,
#: shifted by height - 1: validators 2, 1, 3, 0), is the dead one; validator
#: 0's first check call of height 1's first proposal takes an injected fault
#: on every launch it makes, so that the fault outlasts the degradation
#: ladder (a one-shot fault is retried).  The txs go to validator 1, not
#: height 1's proposer.
CONSENSUS_DEAD = 3
CONSENSUS_DEAD_HEIGHT = 3
CONSENSUS_VICTIM = 0
CONSENSUS_FAULT_HEIGHT = 1
CONSENSUS_ENTRY = 1
CONSENSUS_HEIGHTS = 3
#: The App calls of a proposal's check, and those that extend a square.
CHECK_PARTS = ("speculate", "Process")
EXTEND_PARTS = ("Prepare",) + CHECK_PARTS


def extend_launches(k: int, mode: str = "fused") -> dict:
    """Launches of one extend + DAH on the dense core at square size k, on
    the ladder rung `mode` (rung_launches; fused, staged and host alike):
    the row and column RS phases, the leaf digests, and sha256 for each
    level of the row and the column trees, then for the leaves and each
    level of the tree over the 4k roots (the data root)."""
    return {name: n for name, n in rung_launches(k, mode).items() if n}


def forest_launches(k: int) -> dict:
    """Launches of one retained forest (serve/cache.py) at square size k:
    the leaf digests, then each level of the row and the column trees."""
    return {"sha256_leaf": 1, "sha256": 2 * ((2 * k).bit_length() - 1)}


class Attribution:
    """What each validator of an in-process cluster did on the card, per
    height: its App calls and its serve retention run tagged (validator,
    height, part) on their thread; `launch` (in place of _build.launch)
    counts each launch under the caller's tag and `pipelines` (in place of
    da.eds._cached_pipeline) each extend with its square size and the ladder
    rung it ran on.  One fault can be armed for a (validator, height,
    parts): the first such App call then raises an injected fault on every
    launch it makes, so its guarded extends walk the ladder to the floor,
    and the ladder is re-armed when the height commits."""

    def __init__(self):
        self.tls = threading.local()
        self.lock = threading.Lock()
        self.launches: dict = {}   # (who, height, part) -> {kernel: n}
        self.extends: dict = {}    # (who, height, part) -> [k, ...]
        self.ms: dict = {}         # (who, height, part) -> host ms
        self.commits: dict = {}    # (who, height) -> (perf_counter, WAL fsync ms so far)
        self.votes: dict = {}      # who -> [own votes broadcast]
        self.handled: dict = {}    # who -> [DeviceFault reprs out of ConsensusDriver.handle]
        self.armed = None          # (who, height, parts)
        self.faults: list = []     # (who, height, part) of the faulted call
        self.fault_launches = 0    # launches that raised the injected fault
        self.ladder_at_commit = None  # degraded_state() when the faulted height committed

    def tagged(self, who: int, part: str, height_of, fn):
        def call(*args, **kwargs):
            prev = getattr(self.tls, "tag", None)
            prev_firing = getattr(self.tls, "firing", False)
            tag = self.tls.tag = (who, height_of(*args), part)
            with self.lock:
                armed = self.armed
                fire = armed is not None and tag[:2] == armed[:2] and tag[2] in armed[2]
                if fire:
                    self.armed = None
                    self.faults.append(tag)
            self.tls.firing = fire or prev_firing
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with self.lock:
                    self.ms[tag] = self.ms.get(tag, 0.0) + (time.perf_counter() - t0) * 1e3
                self.tls.tag = prev
                self.tls.firing = prev_firing
        return call

    def launch(self, inner):
        def launch(kernel, *args, **kwargs):
            tag = getattr(self.tls, "tag", None)
            if getattr(self.tls, "firing", False):
                with self.lock:
                    self.fault_launches += 1
                raise RuntimeError(f"injected launch fault in {kernel}")
            inner(kernel, *args, **kwargs)
            if tag is not None:
                with self.lock:
                    counts = self.launches.setdefault(tag, {})
                    counts[kernel] = counts.get(kernel, 0) + 1
        return launch

    def pipelines(self, inner):
        def cached(k, construction, config, mode, device):
            run = inner(k, construction, config, mode, device)

            def counted(*a, **kw):
                tag = getattr(self.tls, "tag", None)
                out = run(*a, **kw)  # an extend that raised (the injected fault) is not counted
                if tag is not None:
                    with self.lock:
                        self.extends.setdefault(tag, []).append((k, mode))
                return out
            return counted
        cached.cache_info = inner.cache_info
        return cached

    def attach(self, who: int, node, stop_at: int) -> None:
        """Tag `node`'s App calls and retention, time its commits, record its
        own votes and the DeviceFaults out of its driver's handle, and let
        its driver start no height after `stop_at`."""
        from celestia_app_tpu_torch.chaos import degrade
        from celestia_app_tpu_torch.device import DeviceFault
        from celestia_app_tpu_torch.rpc.gossip import BroadcastVote

        app, driver = node.app, node.consensus_driver
        # finalize_block moves app.height to the block's height; Commit and
        # the recheck's CheckTx run after it.
        following = lambda *a: app.height + 1  # noqa: E731
        finalized = lambda *a: app.height  # noqa: E731
        for name, part, height_of in (
                ("check_tx", "CheckTx", finalized), ("prepare_proposal", "Prepare", following),
                ("speculate_proposal", "speculate", following),
                ("process_proposal", "Process", following),
                ("finalize_block", "Finalize", following), ("commit", "Commit", finalized)):
            setattr(app, name, self.tagged(who, part, height_of, getattr(app, name)))
        node._retain_for_serving = self.tagged(who, "retain", lambda h, data: h,
                                               node._retain_for_serving)
        inner_commit, inner_handle = node._commit_block_data, driver.handle
        inner_execute = driver._execute_locked
        self.votes[who], self.handled[who] = [], []

        def commit_block(*args, **kwargs):
            try:
                return inner_commit(*args, **kwargs)
            finally:
                with self.lock:
                    self.commits[(who, app.height)] = (time.perf_counter(),
                                                       driver.wal.fsync_ms_total)
                    first_commit = self.faults and app.height == self.faults[0][1] and \
                        sum(1 for (_, h) in self.commits if h == app.height) == 1
                    if first_commit:
                        # The ladder is process-wide and one-way: re-arm it
                        # once the faulted height is decided.
                        self.ladder_at_commit = degrade.degraded_state()
                        degrade.reset_for_tests()
                if app.height >= stop_at:
                    driver._stopped = True  # the run ends here: no next height

        def handle(msg):
            try:
                return inner_handle(msg)
            except DeviceFault as e:
                self.handled[who].append(repr(e))
                raise

        def execute(effects, outbox):
            self.votes[who] += [e.vote for e in effects if isinstance(e, BroadcastVote)]
            return inner_execute(effects, outbox)

        node._commit_block_data, driver.handle = commit_block, handle
        driver._execute_locked = execute

    def launches_at(self, who: int, h: int) -> dict:
        """All of validator `who`'s launches tagged with height `h`."""
        out: dict = {}
        for (w, height, _), counts in self.launches.items():
            if (w, height) == (who, h):
                for name, n in counts.items():
                    out[name] = out.get(name, 0) + n
        return out


def consensus_timeouts(prepare_s: float) -> dict:
    """Round timeouts (base, per-round delta) sized to a measured k=128
    Prepare: a non-proposer's verdict comes after the proposer's Prepare and
    Process and its own speculation and Process, three validators taking
    turns on one interpreter, so the propose timeout is five Prepares (on
    an H100's host a k=128 proposal of 520 txs took longer than four)."""
    step = round(max(2.0, prepare_s), 3)
    return {"propose": (round(max(6.0, 5 * prepare_s), 3), 0.5),
            "prevote": (step, 0.5), "precommit": (step, 0.5)}


def phase_consensus(torch, card: str) -> dict:
    """Tendermint consensus on the card: 3 live ServingNodes of a 4-validator
    genesis, each with a ConsensusDriver (round machine, vote WAL, round
    journal) and gossip over localhost HTTP, $CELESTIA_PIPE_SPECULATE=on.
    A k=128 block's worth of APP_BLOCK's txs is broadcast to validator 1,
    relayed to the others, and the cluster commits CONSENSUS_HEIGHTS
    heights under a Block.MaxBytes of half those txs' bytes, so the first
    two heights carry them: at height 1 validator 0's first proposal check
    call takes an injected fault on every launch it makes, and height 3's
    round-0 proposer is the dead validator.  The fault outlasts the
    degradation ladder: the victim's guarded extends walk it to the floor
    before the DeviceFault, other validators' extends may run on lower rungs
    meanwhile (the same bytes and, on the dense core, the same launches), and
    the ladder is re-armed once the height commits.  Checks: both heights
    decide in round >= 1, the victim raised
    DeviceFault out of its driver's handle and prevoted nothing but nil in
    that round; every live node holds the same BlockData and app hash at
    every height, == a TestNode(device="cpu") replaying the blocks; every
    Commit record verifies; the round_journal rows name each height's
    deciding round; speculation hits > 0; the retained forests serve share
    proofs that verify against each data root; each validator's launches
    per height == 2 rs_dense, 1 sha256_leaf and 2·log2(2k)+log2(4k)+1
    sha256 per extend it ran, on the rung the extend ran on, plus 1
    sha256_leaf and 2·log2(2k) sha256 per retained forest.  Logs per height the wall time, the round, each
    validator's Prepare / Process / Finalize / Commit ms and WAL fsync ms,
    the speculation outcomes and the device busy time and idle share.
    Returns each validator's launches per height."""
    with environment({"CELESTIA_NAMESPACE_TOP_N": str(NODE_TOP_N),
                      "CELESTIA_PIPE_SPECULATE": "on"}):
        return _phase_consensus(torch, card)


def _phase_consensus(torch, card: str) -> dict:
    import dataclasses
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from celestia_app_tpu_torch.consensus import PREVOTE, verify_commit
    from celestia_app_tpu_torch.crypto import PrivateKey
    from celestia_app_tpu_torch.da import eds as eds_mod
    from celestia_app_tpu_torch.da.eds import speculator
    from celestia_app_tpu_torch.kernels import _build
    from celestia_app_tpu_torch.rpc.server import ServingNode, serve
    from celestia_app_tpu_torch.serve import ProofSampler
    from celestia_app_tpu_torch.state.dec import Dec
    from celestia_app_tpu_torch.testutil import TestNode, deterministic_genesis, funded_keys
    from celestia_app_tpu_torch.testutil.testnode import NODE_MIN_GAS_PRICE
    from celestia_app_tpu_torch.trace.round_journal import RoundJournal
    from celestia_app_tpu_torch.trace.tracer import traced

    t_phase = time.perf_counter()
    keys = funded_keys(APP_BLOCK["n_keys"])
    genesis = deterministic_genesis(keys, n_validators=4, gov_max_square_size=APP_K)
    txs = node_txs(keys, genesis.chain_id)[:APP_BLOCK["sends"] + APP_BLOCK["pfbs"]]
    genesis = dataclasses.replace(genesis, block_max_bytes=sum(map(len, txs)) // 2)
    order = sorted(PrivateKey.from_seed(f"validator-{i}".encode()).public_key().address()
                   for i in range(4))
    dead = PrivateKey.from_seed(f"validator-{CONSENSUS_DEAD}".encode()).public_key().address()
    if order[(CONSENSUS_DEAD_HEIGHT - 1) % 4] != dead:
        raise AssertionError("the dead validator is not height "
                             f"{CONSENSUS_DEAD_HEIGHT}'s round-0 proposer")
    t0 = time.perf_counter()
    probe = fresh_app(genesis, node_min_gas_price=Dec.from_str(NODE_MIN_GAS_PRICE))
    probe.prepare_proposal(txs)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    del probe
    timeouts = consensus_timeouts(prepare_s)

    live = [i for i in range(4) if i != CONSENSUS_DEAD]
    acct = Attribution()
    wal_dir = tempfile.mkdtemp(prefix="consensus-wal-")
    makers = [lambda i=i: (ServingNode(genesis=genesis, keys=keys, validator_index=i,
                                       n_validators=4), serve) for i in live]
    nodes, servers = gossip_cluster(makers, timeouts=timeouts, wal_dir=wal_dir)
    by_index = dict(zip(live, nodes))
    try:
        for i, node in by_index.items():
            acct.attach(i, node, CONSENSUS_HEIGHTS)
        if len({id(n.app._own_roots) for n in nodes}) != len(nodes):
            raise AssertionError("two validators share an own-root memo")
        # The txs at validator CONSENSUS_ENTRY; relay takes them to the
        # others.  Tx i is key i % n's
        # sequence i // n: a wave of one sequence reaches every pool before
        # the next is sent, since the relay's sends run in parallel and a
        # peer's CheckTx refuses a sequence that overtook its predecessor.
        t0 = time.perf_counter()
        wave = len(keys)
        for lo in range(0, len(txs), wave):
            codes = [by_index[CONSENSUS_ENTRY].broadcast(t).code for t in txs[lo:lo + wave]]
            if any(codes):
                raise AssertionError(f"broadcast: codes {[c for c in codes if c][:8]}")
            want, deadline = min(lo + wave, len(txs)), time.monotonic() + 120
            while any(len(n.mempool) < want for n in nodes):
                if time.monotonic() > deadline:
                    raise AssertionError(f"relay: pools {[len(n.mempool) for n in nodes]} of {want}")
                time.sleep(0.02)
        relay_s = time.perf_counter() - t0
        log(f"[{card}] consensus: {len(txs)} txs broadcast to validator {CONSENSUS_ENTRY} and relayed to "
            f"validators {live} in {relay_s:.3f} s; a k={APP_K} Prepare measured {prepare_s:.3f} s, "
            f"round timeouts {timeouts}")

        acct.armed = (CONSENSUS_VICTIM, CONSENSUS_FAULT_HEIGHT, CHECK_PARTS)
        spec_before = dict(speculator().outcomes)
        rows_before = len(traced().table(RoundJournal.TABLE))
        torch.cuda.synchronize()
        _build.reset_launches()
        with swapped(_build, "launch", acct.launch(_build.launch)), \
                swapped(eds_mod, "_cached_pipeline", acct.pipelines(eds_mod._cached_pipeline)), \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            t_run = time.perf_counter()
            for n in nodes:
                n.consensus_driver.start()
            wait_heights(nodes, CONSENSUS_HEIGHTS, timeout_s=300)
            # The commit hook (recheck, retention) ends after the height moves.
            deadline = time.monotonic() + 60
            while any((i, CONSENSUS_HEIGHTS) not in acct.commits for i in live):
                if time.monotonic() > deadline:
                    raise AssertionError("a validator's last commit did not end")
                time.sleep(0.02)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t_run
        launches = dict(_build.LAUNCHES)
    finally:
        for s in servers:
            s.stop()
        shutil.rmtree(wal_dir, ignore_errors=True)
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    spec = {k: speculator().outcomes[k] - spec_before[k] for k in spec_before}
    rows = traced().table(RoundJournal.TABLE)[rows_before:]
    ref = nodes[0]
    heights = range(1, CONSENSUS_HEIGHTS + 1)
    hashes = [ref.app.cms.app_hash_at(h) for h in heights]
    rounds = {h: ref._commits[h].round for h in heights}

    # Launches per validator and height, and what its extends and its
    # retained forest account for.
    per_validator: dict = {}
    accounted: dict = {}
    for i, node in by_index.items():
        for h in heights:
            data = node._blocks_by_height[h][0]
            want: dict = {}
            for part in EXTEND_PARTS + ("retain",):
                for k, mode in acct.extends.get((i, h, part), []):
                    for name, n in extend_launches(k, mode).items():
                        want[name] = want.get(name, 0) + n
            if data.txs:
                for name, n in forest_launches(data.square_size).items():
                    want[name] = want.get(name, 0) + n
            per_validator.setdefault(i, {})[h] = acct.launches_at(i, h)
            accounted[(i, h)] = want

    # The per-height log, before any check, so that a failing run shows it.
    starts = {0: 0.0}
    for h in heights:
        starts[h] = min(acct.commits[(i, h)][0] for i in live) - t_run
    busy_all = sum(b - a for a, b in merged(spans))
    for h in heights:
        lo, hi = starts[h - 1] * 1e6, starts[h] * 1e6
        busy = sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged(spans))
        data = ref._blocks_by_height[h][0]
        parts = []
        for i in live:
            ms = {p: acct.ms.get((i, h, p), 0.0) for p in ("Prepare", "speculate", "Process",
                                                            "Finalize", "Commit", "retain")}
            prev = acct.commits.get((i, h - 1), (0.0, 0.0))[1] if h > 1 else 0.0
            fsync = acct.commits[(i, h)][1] - prev
            extends = {p: acct.extends[(i, h, p)] for p in EXTEND_PARTS + ("retain",)
                       if (i, h, p) in acct.extends}
            parts.append(f"v{i}: " + ", ".join(f"{p} {v:.3f}" for p, v in ms.items())
                         + f", WAL fsync {fsync:.3f} ms; extends {extends}; launches "
                         f"{per_validator[i][h]}")
        journal = "; ".join(
            f"r{r['round']} {r['result']} after {r['total_ms']:.0f} ms, prevote step at "
            + ("-" if r["propose_ms"] is None else f"{r['propose_ms']:.0f}")
            + f" ms, timeouts {r['timeouts']}" for r in rows if r["height"] == h)
        log(f"[{card}] consensus height {h} round_journal rows (3 validators): {journal}")
        log(f"[{card}] consensus height {h}: round {rounds[h]}, {len(data.txs)} txs, "
            f"k={data.square_size}, app hash {hashes[h - 1].hex()[:16]}; wall "
            f"{(starts[h] - starts[h - 1]) * 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
            f"idle {100 - 100 * busy / max(hi - lo, 1e-9):.3f} %; " + "; ".join(parts))

    # Agreement, the CPU replay and the Commit records.
    def block(node, h):
        data, time_ns, signers, evidence = node._blocks_by_height[h]
        return data.txs, data.square_size, data.hash, time_ns, signers, evidence

    for node in nodes[1:]:
        if [node.app.cms.app_hash_at(h) for h in heights] != hashes or any(
                block(node, h) != block(ref, h) for h in heights):
            raise AssertionError("the live validators' blocks or app hashes differ")
    t0 = time.perf_counter()
    replay = TestNode(genesis, keys, device="cpu")
    replayed = replay_heights(replay, ref, CONSENSUS_HEIGHTS, ServingNode._parse_evidence)
    replay_s = time.perf_counter() - t0
    if replayed != hashes:
        raise AssertionError("a CPU TestNode replaying the committed blocks gives other app hashes")
    for node in nodes:
        for h in heights:
            rec = node._commits[h]
            if not verify_commit(node._valsets_by_height[h], node.chain_id, rec) or \
                    rec.data_root != node._blocks_by_height[h][0].hash:
                raise AssertionError(f"height {h}: a Commit record does not verify")
    if rounds[CONSENSUS_DEAD_HEIGHT] < 1 or rounds[CONSENSUS_FAULT_HEIGHT] < 1:
        raise AssertionError(f"rounds {rounds}: the dead proposer's height and the faulted "
                             "height must decide in round >= 1")
    for h in heights:
        decided = [r for r in rows if r["height"] == h and r["result"] == "decided"]
        if len(decided) < 2 or {r["round"] for r in decided} != {rounds[h]}:
            raise AssertionError(f"height {h}: round_journal decided rows "
                                 f"{[(r['round'], r['proposer'][:12]) for r in decided]}, "
                                 f"commit round {rounds[h]}")
    if spec["hit"] <= 0:
        raise AssertionError(f"no speculation hit: {spec}")

    # The injected fault: a DeviceFault out of the victim's handle, no verdict.
    if len(acct.faults) != 1 or not acct.handled[CONSENSUS_VICTIM]:
        raise AssertionError(f"fault {acct.faults}, handled {acct.handled}")
    fault_prevotes = [v for v in acct.votes[CONSENSUS_VICTIM]
                      if (v.height, v.round, v.vote_type) == (CONSENSUS_FAULT_HEIGHT, 0, PREVOTE)]
    if any(not v.is_nil for v in fault_prevotes):
        raise AssertionError("the faulted validator prevoted a block it never judged")

    # The retained forests serve proofs against the committed data roots.
    sampler = ProofSampler()
    served = 0
    for node in nodes:
        for h in heights:
            data = node._blocks_by_height[h][0]
            if not data.txs:
                continue
            entry, tier = node.serve_cache.get(h)
            if entry is None:
                raise AssertionError(f"height {h} is not retained ({tier})")
            n = 2 * data.square_size
            coords = [(0, 0), (n - 1, n - 1), (data.square_size, 3 % n)]
            for axis in ("row", "col"):
                proofs = sampler.sample_batch(entry, coords, axis=axis)
                if not all(p.verify(data.hash) for p in proofs):
                    raise AssertionError(f"height {h}: a retained share proof does not verify")
                served += len(proofs)

    for (i, h), want in accounted.items():
        got = per_validator[i][h]
        if {k: v for k, v in got.items() if v} != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"validator {i} height {h}: launches {got}, want {want}")
    log(f"[{card}] consensus: {CONSENSUS_HEIGHTS} heights in {run_s:.3f} s (rounds {rounds}); "
        f"the live app hashes and BlockData agree and == a CPU TestNode's replay "
        f"({replay_s:.3f} s); every Commit record verifies; the round_journal's decided rows "
        f"name each height's round; speculation {spec}; the injected fault on every launch "
        f"of {acct.faults[0]} ({acct.fault_launches} launches raised it; the ladder "
        f"{acct.ladder_at_commit} when the height committed, then re-armed) raised "
        f"{acct.handled[CONSENSUS_VICTIM][0][:80]} out of validator "
        f"{CONSENSUS_VICTIM}'s handle, its prevotes in that round "
        f"{['nil' if v.is_nil else v.block_hash.hex()[:8] for v in fault_prevotes]}; "
        f"{served} share proofs from the retained forests verify; each validator's launches "
        f"per height == its extends' and its forest's; device busy {busy_all / 1e3:.3f} ms of "
        f"the run, idle {100 - 100 * busy_all / (run_s * 1e6):.3f} %; launches in the run "
        f"{launches}; the phase {time.perf_counter() - t_phase:.1f} s")
    if any(launches[k] <= 0 for k in ("rs_dense", "sha256_leaf", "sha256")):
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    return {"validators": per_validator, "launches": launches}


#: Round timeouts (base, per-round delta, seconds) of the port's gossip
#: clusters on the CPU.  The plain SHA-256 makes an empty block's Prepare and
#: Process take about 0.4 s each there, and the validators of one process
#: take turns on the interpreter, so a non-proposer's verdict can come 2 s
#: after its round opened: past rpc/gossip.FAST_TIMEOUTS' propose timeout.
CPU_CLUSTER_TIMEOUTS = {"propose": (4.0, 0.5), "prevote": (1.0, 0.5), "precommit": (1.0, 0.5)}


def gossip_cluster(makers, *, timeouts, topology=None, wal_dir=None,
                   interval_s: float = 0.1) -> tuple[list, list]:
    """Served gossip validators: `makers[i]()` gives validator i's
    (ServingNode, serve function), so one cluster may mix the packages.
    Each gets a ConsensusDriver with `timeouts` (and a WAL under `wal_dir`)
    and an HTTP server on a free localhost port; peers are the full mesh or
    `topology[i]`.  Returns (nodes, servers), the drivers not started."""
    nodes, servers = [], []
    for i, make in enumerate(makers):
        node, serve = make()
        wal = None if wal_dir is None else os.path.join(str(wal_dir), f"validator-{i}.wal")
        node.enable_gossip_consensus(timeouts=timeouts, interval_s=interval_s, wal_path=wal)
        servers.append(serve(node, port=0, block_interval_s=None))
        nodes.append(node)
    for i, node in enumerate(nodes):
        peers = topology[i] if topology is not None else [j for j in range(len(nodes)) if j != i]
        node.peer_urls = [servers[j].url for j in peers]
    return nodes, servers


def wait_heights(nodes, height: int, timeout_s: float) -> None:
    """Until every node has committed `height`; TimeoutError after
    `timeout_s`."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if all(n.app.height >= height for n in nodes):
            return
        time.sleep(0.02)
    raise TimeoutError(f"heights {[n.app.height for n in nodes]} never all reached {height}")


def replay_heights(node, source, upto: int, parse_evidence) -> list[bytes]:
    """Commit `source`'s blocks up to `upto`, in order, on `node` (a TestNode
    of either package): each height's BlockData, time, LastCommit signers
    and evidence from the block store.  Returns `node`'s app hash after each
    height it committed."""
    out = []
    for h in range(node.app.height + 1, upto + 1):
        data, time_ns, signers, evidence = source._blocks_by_height[h]
        node._commit_block_data(data, time_ns,
                                last_commit_signers=None if signers is None else set(signers),
                                evidence=parse_evidence(evidence))
        out.append(node.app.cms.last_app_hash)
    return out


class StubApp:
    """The querier's view of the app: the square size cap."""

    def max_effective_square_size(self) -> int:
        return 128


def querier_txs(seed: int) -> list[bytes]:
    """24 normal txs of 100-1000 B and 12 BlobTxs of one blob each, 240-480
    shares, under 4 namespaces: more than 4,096 shares, a k=128 square."""
    from celestia_app_tpu_torch.shares import Blob, Namespace
    from celestia_app_tpu_torch.tx.envelopes import BlobTx

    rng = np.random.default_rng(seed)
    namespaces = [Namespace.v0(rng.bytes(10)) for _ in range(4)]
    txs = [rng.bytes(int(rng.integers(100, 1000))) for _ in range(24)]
    for i in range(12):
        blob = Blob(namespaces[i % 4], share_payload(rng, int(rng.integers(240, 481))))
        txs.append(BlobTx(rng.bytes(int(rng.integers(150, 400))), (blob,)).marshal())
    return txs


def phase_querier(torch, card: str) -> dict:
    """The ABCI proof querier on a k=128 square of txs and BlobTxs: a tx
    inclusion proof for every tx, share proofs for a few ranges (one across
    a row boundary), both routes of handle_query; every proof verifies
    against the card's data root and a tampered one does not.  Returns the
    launches of one query."""
    import dataclasses
    import json

    from celestia_app_tpu_torch.da import extend_shares
    from celestia_app_tpu_torch.kernels import _build
    from celestia_app_tpu_torch.proof import querier
    from celestia_app_tpu_torch.square import construct

    txs = querier_txs(4242)
    sq = construct(txs, 128)
    if sq.size != 128:
        raise AssertionError(f"the querier's block builds a k={sq.size} square, want 128")
    _build.reset_launches()
    root = extend_shares(sq.share_bytes()).data_root()
    extend_counts = dict(_build.LAUNCHES)

    proofs, tx_ms = [], []
    for i in range(len(txs)):
        _build.reset_launches()
        t0 = time.perf_counter()
        proofs.append(querier.query_tx_inclusion_proof(txs, i, 128))
        tx_ms.append((time.perf_counter() - t0) * 1e3)
        if dict(_build.LAUNCHES) != extend_counts:
            raise AssertionError(f"tx query {i}: launches {_build.LAUNCHES}, want one "
                                 f"extend's {extend_counts}")
    # One-namespace ranges: txs, PFBs, and a blob's shares across a row end.
    crossing = next(p for p in sq.placements
                    if p.start // 128 != (p.start + p.share_count - 1) // 128)
    edge = (crossing.start // 128 + 1) * 128
    across = (max(crossing.start, edge - 5), min(crossing.start + crossing.share_count, edge + 7))
    ranges = [(0, 1), (2, min(9, sq.tx_share_range[1])), sq.pfb_share_range, across]
    share_ms = []
    for lo, hi in ranges:
        t0 = time.perf_counter()
        proofs.append(querier.query_share_inclusion_proof(txs, lo, hi, 128))
        share_ms.append((time.perf_counter() - t0) * 1e3)
    data = json.dumps({"txs": [t.hex() for t in txs]}).encode()
    routed = [querier.handle_query(StubApp(), f"{querier.TX_INCLUSION_ROUTE}/30", data),
              querier.handle_query(StubApp(), f"{querier.SHARE_INCLUSION_ROUTE}/"
                                   f"{across[0]}/{across[1]}", data)]
    if routed != [proofs[30], proofs[len(txs) + 3]]:
        raise AssertionError("handle_query's proofs differ from the direct queries'")
    proofs += routed
    if not all(p.verify(root) for p in proofs):
        raise AssertionError("a querier proof does not verify against the data root")
    victim = proofs[len(txs) + 3]
    body = bytearray(victim.data[0])
    body[200] ^= 1
    tampered = dataclasses.replace(victim, data=(bytes(body),) + victim.data[1:])
    if tampered.verify(root):
        raise AssertionError("a tampered share proof verifies")
    rows = [p.row_proof.end_row - p.row_proof.start_row for p in proofs]
    log(f"[{card}] querier k=128: {len(txs)} tx proofs, {len(ranges)} share-range proofs "
        f"(one across the row end at share {edge}), 2 through handle_query; all {len(proofs)} "
        f"verify against the card's data root, the tampered one does not; rows per proof "
        f"{min(rows)}-{max(rows)}; launches per query {extend_counts} (one extend)")
    log(f"[{card}] querier k=128: query_tx_inclusion_proof {float(np.median(tx_ms)):.3f} ms "
        f"per query (median of {len(tx_ms)}, {min(tx_ms):.3f}-{max(tx_ms):.3f}), "
        f"query_share_inclusion_proof {[round(t, 3) for t in share_ms]} ms")
    return extend_counts


def build_bridge() -> tuple[str, float]:
    """Compile bridge/celestia_square_bridge.cpp into the port's (git-ignored)
    build directory, with cmake or, where it is absent, the C++ compiler
    alone; never into the tracked bridge/build/."""
    from celestia_app_tpu_torch.kernels import _build

    out = _build.BUILD_DIR / "bridge"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    if shutil.which("cmake"):
        for cmd in (["cmake", "-S", "bridge", "-B", str(out)], ["cmake", "--build", str(out)]):
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    else:
        subprocess.run(["c++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", "-o",
                        str(out / "libcelestia_square_bridge.so"),
                        "bridge/celestia_square_bridge.cpp"],
                       check=True, capture_output=True, timeout=300)
    return str(out / "libcelestia_square_bridge.so"), time.perf_counter() - t0


def bridge_workers() -> list[int]:
    """Pids of this process's children that run the port's bridge worker."""
    pids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmdline = f.read()
        except OSError:
            continue
        if ppid == os.getpid() and b"celestia_app_tpu_torch.bridge.worker" in cmdline:
            pids.append(int(entry))
    return pids


@contextlib.contextmanager
def watchdog(seconds: float, what: str):
    """Kill the bridge worker if the block outlasts `seconds`: the C side's
    reads have no time limit, and a dead worker makes them fail."""
    fired = []

    def fire():
        fired.append(True)
        for pid in bridge_workers():
            os.kill(pid, signal.SIGKILL)

    timer = threading.Timer(seconds, fire)
    timer.start()
    try:
        yield
    finally:
        timer.cancel()
    if fired:
        raise AssertionError(f"{what} outlasted {seconds} s; the worker was killed")


def phase_bridge(torch, card: str) -> dict:
    """The C ABI with the port's worker behind it: build the bridge library,
    start the worker through BridgeClient with warmup at k=128 and 512, round
    trips at both sizes byte-equal to an in-process compute, a failed
    extend, shutdown, and the worker's own report of its device and
    launches.  Returns the worker's launch counts."""
    from celestia_app_tpu_torch.bridge.client import BridgeClient
    from celestia_app_tpu_torch.da import ExtendedDataSquare
    from celestia_app_tpu_torch.kernels import _build

    lib, build_s = build_bridge()
    log(f"bridge: built {lib} in {build_s:.2f} s")
    log_path = _build.BUILD_DIR / "bridge-worker.log"
    reps = 3
    construction = {"CELESTIA_RS_CONSTRUCTION": "leopard"}
    with environment(construction), watchdog(600, "the bridge phase"):
        # The worker inherits fd 2 at fork: point it at the log for the call.
        sys.stderr.flush()
        saved = os.dup(2)
        with open(log_path, "wb") as f:
            os.dup2(f.fileno(), 2)
        try:
            t0 = time.perf_counter()
            client = BridgeClient(lib, warmup_ks=[128, 512])
            init_s = time.perf_counter() - t0
        finally:
            os.dup2(saved, 2)
            os.close(saved)
        extends = 2  # the warmups
        try:
            if not client.ping():
                raise AssertionError("bridge ping failed")
            log(f"[{card}] bridge: cstpu_init with warmup k=128, 512 (worker start, kernels "
                f"already built, one extend at each k) {init_s:.3f} s")
            for k in (128, 512):
                ods = random_square(k, seed=9000 + k)
                trip_ms, local_ms = [], []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    eds, rows, cols, root = client.extend_and_dah(ods)
                    trip_ms.append((time.perf_counter() - t0) * 1e3)
                    extends += 1
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    local = ExtendedDataSquare.compute(ods, "leopard")
                    want = (local.squared(), b"".join(local.row_roots()),
                            b"".join(local.col_roots()), local.data_root())
                    local_ms.append((time.perf_counter() - t0) * 1e3)
                    if not (np.array_equal(eds, want[0]) and rows.tobytes() == want[1]
                            and cols.tobytes() == want[2] and root == want[3]):
                        raise AssertionError(f"bridge k={k}: EDS or roots != in-process compute")
                moved = (k * k + 4 * k * k) * 512 / 1e6
                trip, here = float(np.median(trip_ms)), float(np.median(local_ms))
                log(f"[{card}] bridge k={k} leopard: round trip {trip:.3f} ms (median of "
                    f"{[round(t, 3) for t in trip_ms]}), in-process compute + copy back "
                    f"{here:.3f} ms ({[round(t, 3) for t in local_ms]}); the rest, "
                    f"{trip - here:.3f} ms, is the pipe and the worker's Python for "
                    f"{moved:.1f} MB ({k * k * 512 / 1e6:.1f} in, {4 * k * k * 512 / 1e6:.1f} "
                    f"out); EDS, row and column roots and data root == in-process")
            try:
                client.extend_and_dah(np.zeros((3, 3, 512), dtype=np.uint8))
            except RuntimeError as e:
                log(f"bridge: a k=3 square answers status 1: RuntimeError({e})")
            else:
                raise AssertionError("bridge: a k=3 square did not fail")
            if not client.ping():
                raise AssertionError("bridge ping failed after the failed extend")
        finally:
            client.shutdown()
    text = log_path.read_text()
    line = next((x for x in text.splitlines() if x.startswith("bridge worker exit: ")), None)
    if line is None:
        raise AssertionError(f"the worker wrote no exit report:\n{text[-2000:]}")
    report = json.loads(line.removeprefix("bridge worker exit: "))
    want_launches = {"rs_dense": 2 * extends, "sha256_leaf": extends, "sha256": None}
    if report["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"the worker ran on {report['device']!r}")
    check_launches("bridge worker", report["launches"], want_launches)
    if "invalid square size 3" not in text:
        raise AssertionError("the worker's stderr lacks the failed extend's cause")
    log(f"[{card}] bridge worker stderr: {line}")
    return report["launches"]


# --- giant squares: k=1024 and k=2048, materializing and panel-streamed ---

# The square sizes of phase_giant; the first also runs the 48-row panels and
# the stream.
GIANT_KS = (1024, 2048)
# The environment of each lowering of phase_giant: every seam it reads set.
GIANT_BASE = {"CELESTIA_PIPE_FUSED": "on", "CELESTIA_RS_XOR": "off", "CELESTIA_PIPE_PANEL": "off",
              "CELESTIA_RS_FFT": "auto", "CELESTIA_RS_FFT_MD": "0",
              "CELESTIA_RS_CONSTRUCTION": "vandermonde"}
GIANT_LOWERINGS = {
    "fused": {},
    "epi": {"CELESTIA_PIPE_FUSED": "epi"},
    "xor": {"CELESTIA_RS_XOR": "on"},
    "panel auto": {"CELESTIA_PIPE_PANEL": "auto"},
    "panel 48": {"CELESTIA_PIPE_PANEL": "48"},
    "panel auto fft": {"CELESTIA_PIPE_PANEL": "auto", "CELESTIA_RS_FFT": "on"},
}


def fft_parity(codec, data: np.ndarray) -> np.ndarray:
    """(k, 512) data shares -> their k parity shares by the host additive
    FFT (gf/fft.encode_fft, O(k log k); the generator is not used)."""
    from celestia_app_tpu_torch.gf.fft import encode_fft

    return codec.from_symbols(encode_fft(codec, codec.to_symbols(data)))


def check_parity_fft(eds, ods: np.ndarray, codec, rng) -> int:
    """64 parity shares of the (2k, 2k, 512) `eds` tensor against the host
    FFT of their row or column: 22 in Q1 from 2 ODS rows, 22 in Q2 from 2
    ODS columns, 20 in Q3 from 2 Q1 columns.  Returns the count checked."""
    k = codec.k
    checked = 0
    lines = ([("Q1", ods[i], lambda p, i=i: eds[i, k + p], 11)
              for i in rng.choice(k, 2, replace=False)]
             + [("Q2", ods[:, j], lambda p, j=j: eds[k + p, j], 11)
                for j in rng.choice(k, 2, replace=False)]
             + [("Q3", eds[:k, j].cpu().numpy(), lambda p, j=j: eds[k + p, j], 10)
                for j in k + rng.choice(k, 2, replace=False)])
    for quadrant, data, cell, n in lines:
        parity = fft_parity(codec, data)
        for p in rng.choice(k, n, replace=False):
            if not np.array_equal(cell(int(p)).cpu().numpy(), parity[p]):
                raise AssertionError(f"{quadrant} parity share {p} != the host FFT encode")
            checked += 1
    return checked


def giant_launches(k: int, lowering: str, panels: int = 0, blocks: int = 0) -> dict:
    """Kernel launches of one extend + DAH of size k, as the code makes
    them: sha256_batch once per tree level of each axis and of the data
    root's tree (its leaf level included) on every lowering; per panel
    rs_dense twice (row phase, column partial) and sha256_leaves twice (the
    panel's leaves, its bottom rows' leaves); the FFT leg runs no rs_dense,
    and hashes each panel's leaves and each column block's parity leaves."""
    want = {"sha256": 2 * ((2 * k).bit_length() - 1) + (4 * k).bit_length(),
            "rs_dense": 0, "rs_xor": 0, "rs_dense_leaf": 0, "sha256_leaf": 1}
    if lowering == "fused":
        want["rs_dense"] = 2
    elif lowering == "xor":
        want["rs_xor"] = 2
    elif lowering == "epi":
        want.update(rs_dense=1, rs_dense_leaf=1)
    elif lowering.endswith("fft"):
        want["sha256_leaf"] = panels + blocks
    else:
        want.update(rs_dense=2 * panels, sha256_leaf=2 * panels)
    return want


def giant_leg(torch, card: str, label: str, fn, want: dict, reps: int = 3) -> tuple:
    """One lowering: a first call, `reps` timed calls (launch counters and
    the allocator's peak reset just before the first of them), then one
    under the profiler.  Returns (the first timed call's result, record)."""
    from celestia_app_tpu_torch.kernels import _build

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    walls, out = [], None
    for rep in range(reps):
        if rep == 0:
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if rep == 0:
            launches = dict(_build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            out = res
        del res
    check_launches(label, launches, want)
    profiled = device_breakdown(torch, fn, card, label)
    busy, idle = profiled if profiled else (None, None)
    rec = {"wall_ms": float(np.median(walls)), "walls": [round(w, 3) for w in walls],
           "busy_ms": busy, "idle": idle, "peak_gb": peak / 1e9,
           "resident_gb": resident / 1e9, "launches": launches, "first_s": first_s}
    log(f"[{card}] {label}: wall {rec['wall_ms']:.3f} ms (median of {rec['walls']}), first "
        f"call {first_s:.3f} s; peak allocated {peak / 1e9:.3f} GB ({(peak - resident) / 1e9:.3f} "
        f"GB above the {resident / 1e9:.3f} GB resident before it); launches {launches} "
        f"(== {want})")
    return out, rec


def phase_giant(torch, card: str) -> dict:
    """Giant squares on the card (GF(2^16), vandermonde), at k=1024 and 2048.

    k=1024: the materializing fused, epi and XOR lowerings and the panel
    lowering at 64-row panels, 48-row panels (a short last panel) and
    64-row panels on the FFT leg: one data root and one EDS, the roots-only
    twin's roots too; 64 parity shares == the host FFT encode; launches
    per lowering as giant_launches counts them; BlockPipeline under panel
    auto (4 squares, depth 2, batch asked 4): roots == one-shot compute,
    journal rows of batch 1 and 16 panels.  k=2048: fused, epi, XOR, panel
    auto and the panel FFT leg (column-blocked), one root, 64 shares ==
    the host FFT.  Beside them: the generator's host build, wall and
    device time, peak memory per lowering, the column phase dense against
    column-blocked FFT, the panel column partial's layout moves and XOR
    against its rs_dense launch, and rs_dense == its plain version on
    column slices of the giant shapes.  Returns the records."""
    from celestia_app_tpu_torch.da import ExtendedDataSquare
    from celestia_app_tpu_torch.device import resolve_device
    from celestia_app_tpu_torch.gf.rs import codec_for_width
    from celestia_app_tpu_torch.kernels import _build, panel, rs_dense
    from celestia_app_tpu_torch.kernels.fft import col_block_encode_fn
    from celestia_app_tpu_torch.kernels.rs import _codec_tensors, encode_axis, encode_fn
    from celestia_app_tpu_torch.parallel import stream_blocks
    from celestia_app_tpu_torch.trace import journal

    dev = resolve_device(None)
    records = {}
    for k in GIANT_KS:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        codec = codec_for_width(k, "vandermonde")
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        g_bits = codec.generator_bits()
        bits_s = time.perf_counter() - t0
        log(f"giant k={k}: host generator (FFT encode of the identity) {gen_s:.3f} s, "
            f"bit expansion {bits_s:.3f} s ({g_bits.nbytes / 1e9:.3f} GB)")
        records[k] = {"generator_s": gen_s, "bits_s": bits_s}
        ods = random_square(k, seed=k + 7)
        rows = panel._AUTO_PANEL_ROWS
        n_panels = {"panel auto": k // rows, "panel 48": -(-k // 48),
                    "panel auto fft": k // rows}
        lowerings = list(GIANT_LOWERINGS) if k == GIANT_KS[0] else \
            ["fused", "epi", "xor", "panel auto", "panel auto fft"]
        ref = None
        for name in lowerings:
            env = {**GIANT_BASE, **GIANT_LOWERINGS[name]}
            want = giant_launches(k, name, n_panels.get(name, 0),
                                  -(-2 * k // min(2 * rows, 2 * k)))

            def run():
                e = ExtendedDataSquare.compute(ods)
                e.data_root()
                return e

            with environment(env):
                eds, rec = giant_leg(torch, card, f"giant k={k} {name}", run, want)
                if name.startswith("panel"):
                    row = journal.rows("compute")[-1]
                    if row["mode"] != "panel" or row["panels"] != n_panels[name]:
                        raise AssertionError(f"giant k={k} {name}: journal row {row}")
                    twin_run = panel.panel_pipeline(k, roots_only=True)
                    torch.cuda.synchronize()
                    resident = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    _build.reset_launches()
                    t0 = time.perf_counter()
                    twin = twin_run(ods)
                    twin[2].cpu()
                    twin_ms = (time.perf_counter() - t0) * 1e3
                    twin_peak = torch.cuda.max_memory_allocated() - resident
                    check_launches(f"giant k={k} {name} roots only", dict(_build.LAUNCHES), want)
                    if not all(torch.equal(a, b) for a, b in zip(
                            twin, (eds._row_roots, eds._col_roots, eds._data_root))):
                        raise AssertionError(f"giant k={k} {name}: roots-only twin != its roots")
                    rec.update(twin_ms=twin_ms, twin_gb=twin_peak / 1e9)
                    log(f"[{card}] giant k={k} {name} roots only: {twin_ms:.3f} ms, peak "
                        f"{twin_peak / 1e9:.3f} GB above the resident; roots == the EDS's")
                    del twin
            records[k][name] = rec
            if ref is None:
                ref = eds
                checked = check_parity_fft(ref._eds, ods, codec, np.random.default_rng(k))
                log(f"[{card}] giant k={k}: {checked} Q1/Q2/Q3 parity shares of the fused EDS "
                    f"== the host FFT encode of their row or column")
            elif not (torch.equal(eds._eds, ref._eds) and torch.equal(eds._row_roots, ref._row_roots)
                      and torch.equal(eds._col_roots, ref._col_roots)
                      and torch.equal(eds._data_root, ref._data_root)):
                raise AssertionError(f"giant k={k} {name}: EDS or roots != the fused lowering's")
            del eds
        records[k]["data_root"] = ref.data_root().hex()
        log(f"[{card}] giant k={k}: data root {ref.data_root().hex()} and EDS equal on "
            f"{lowerings} (+ the roots-only twins of the panel lowerings)")

        # The column phase, dense against the column-blocked FFT of the
        # panel path's FFT leg, on the fused EDS's top half.
        top = ref._eds[:k]
        with environment(GIANT_BASE):
            dense = encode_fn(k, "vandermonde")
            block = col_block_encode_fn(k, "vandermonde", md=False)
            width = min(2 * rows, 2 * k)
            dense_ms = cuda_ms(torch, lambda: dense(top, 0), reps=1)
            fft_ms = cuda_ms(torch, lambda: [block(top[:, c:c + width])
                                             for c in range(0, 2 * k, width)], reps=1)
            if not torch.equal(block(top[:, :width]), ref._eds[k:, :width]):
                raise AssertionError(f"giant k={k}: a column block's FFT != the EDS")
        records[k]["col_dense_ms"], records[k]["col_fft_ms"] = dense_ms, fft_ms
        log(f"[{card}] giant k={k}: column phase on the card, dense (rs_dense) {dense_ms:.3f} ms "
            f"against the additive FFT in blocks of {width} columns (float16 bmm) {fft_ms:.3f} ms")

        # The panel column partial of one 64-row panel: its rs_dense launch,
        # the layout moves around it, and the XOR into the accumulator.
        m = codec.field.m
        bps = m // 8
        bounds = panel.panel_bounds(k, rows)
        g = panel._col_generator_slices(k, "vandermonde", bounds, dev)[0]
        ext = ref._eds[:rows]
        planes = ext.reshape(rows, 2 * k, 512 // bps, bps).movedim(3, 1)
        planes = planes.reshape(rows, bps, -1).contiguous()
        part = encode_axis(ext, g, m, contract_axis=0)
        acc = torch.zeros_like(part)
        kernel_ms = cuda_ms(torch, lambda: rs_dense.mod2_matmul_planes(g, planes, m), reps=3)
        part_ms = cuda_ms(torch, lambda: encode_axis(ext, g, m, contract_axis=0), reps=3)
        xor_ms = cuda_ms(torch, lambda: acc.bitwise_xor_(part), reps=3)
        n = len(bounds)
        records[k]["partial"] = {"kernel_ms": kernel_ms, "partial_ms": part_ms, "xor_ms": xor_ms,
                                 "panels": n}
        log(f"[{card}] giant k={k}: one {rows}-row panel's column partial: rs_dense "
            f"{kernel_ms:.3f} ms, encode_axis (rs_dense + layout moves) {part_ms:.3f} ms, XOR "
            f"into the accumulator {xor_ms:.3f} ms; per square ({n} panels) the moves + XOR "
            f"{n * (part_ms - kernel_ms + xor_ms):.3f} ms; partial product {part.nbytes / 1e9:.3f} "
            f"GB")
        # rs_dense == its plain version on column slices of the two giant
        # shapes (the plain int32 product of the whole is too large).
        cols = 4096
        G = _codec_tensors(k, "vandermonde", dev)[1]["G_bits"]
        row_planes = torch.from_numpy(
            ods[:16].transpose(1, 0, 2).reshape(k, 16, 512 // bps, bps))
        row_planes = row_planes.to(dev).movedim(3, 1).reshape(k, bps, -1)[..., :cols]
        row_planes = row_planes.contiguous()
        for label, gm, x in (("column partial", g, planes[..., :cols].contiguous()),
                             ("row phase", G, row_planes)):
            got = rs_dense.mod2_matmul_planes(gm, x, m)
            e = max_abs_err(got, rs_dense.mod2_matmul_planes_plain(gm, x, m))
            if e:
                raise AssertionError(f"giant k={k}: rs_dense {label} != plain (max err {e})")
            log(f"giant k={k}: rs_dense == plain on the {label} shape G {tuple(gm.shape)}, "
                f"x {tuple(x.shape)} (first {cols} columns)")
        del part, acc, planes, ext, top, g, G, row_planes

        if k == GIANT_KS[0]:
            with environment({**GIANT_BASE, "CELESTIA_PIPE_PANEL": "auto"}):
                blocks = [(i, random_square(k, seed=60 + i)) for i in range(4)]
                want_roots = [ExtendedDataSquare.compute(o).data_root() for _, o in blocks]
                before = len(journal.rows("stream"))
                _build.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = [(t, e.data_root()) for t, e in stream_blocks(iter(blocks), k, depth=2,
                                                                     batch=4)]
                wall = (time.perf_counter() - t0) * 1e3
                stream_rows = journal.rows("stream")[before:]
                if got != list(zip(range(4), want_roots)):
                    raise AssertionError("giant stream: roots != one-shot compute")
                if [(r["batch_size"], r["panels"], r["mode"]) for r in stream_rows] != \
                        [(1, k // rows, "panel")] * 4:
                    raise AssertionError(f"giant stream: journal rows {stream_rows}")
                check_launches("giant stream", dict(_build.LAUNCHES),
                               {n: 4 * c for n, c in
                                giant_launches(k, "panel auto", k // rows).items()})
                med = {name: round(float(np.median([r[name] for r in stream_rows])), 3)
                       for name in STREAM_STAGES}
                records[k]["stream_ms"] = wall
                log(f"[{card}] giant stream k={k} panel auto, depth 2, batch asked 4, 4 squares: "
                    f"roots == one-shot compute; journal rows batch 1, {k // rows} panels; wall "
                    f"{wall:.3f} ms ({wall / 4:.3f} ms per square); journal medians {med}")
                del blocks
        del ref, ods
        torch.cuda.empty_cache()
    log(f"giant records: {json.dumps(records)}")
    return records


# --- the multi-device plane: sharded extend, panel, repair and serving ---

# Shards of the mesh phase_mesh runs on one card (and the widest mesh it
# takes on a machine with several); its square sizes: the sharded extend,
# repair and serving, the sharded panel square (phase_giant's largest) and
# the FFT leg's (phase_giant's smallest).
MESH_SHARDS = 4
MESH_K = 512


def mesh_launches(k: int, n: int, rows: int = 0) -> list[dict]:
    """Kernel launches per shard of one sharded extend + DAH of size k over
    n shards, as the code makes them: the sharded extend (rows=0) runs per
    shard rs_dense twice (row phase, column phase), sha256_leaves once, and
    sha256_batch once per level of its column trees (log2 2k) and of its
    row subtrees (log2 2k/n); the sharded panel lowering (rows per panel)
    per step rs_dense twice (row phase, the owner's column contraction) and
    sha256_leaves once, then once for the parity slab, and sha256_batch
    once per level of its row trees (log2 2k) and of its column subtrees
    (log2 k/n).  Shard 0 adds the top levels (log2 n, or log2 2n for the
    panel's two slabs per shard) and the data root's tree (log2 4k + 1)."""
    log2 = lambda v: v.bit_length() - 1  # noqa: E731
    if rows:
        steps = -(-(k // n) // rows)
        per = {"rs_dense": 2 * steps, "sha256_leaf": steps + 1,
               "sha256": log2(2 * k) + log2(k // n)}
        top = log2(2 * n)
    else:
        per = {"rs_dense": 2, "sha256_leaf": 1, "sha256": log2(2 * k) + log2(2 * k // n)}
        top = log2(n)
    out = [dict(per, rs_xor=0, rs_dense_leaf=0) for _ in range(n)]
    out[0]["sha256"] += top + (4 * k).bit_length()
    return out


def check_shard_launches(label: str, mesh, want: list[dict]) -> list[dict]:
    """The launches each shard's stream took, held to `want` per shard."""
    got = mesh.launches()
    for i, (g, w) in enumerate(zip(got, want)):
        check_launches(f"{label} shard {i}", g, w)
    return got


def mesh_meshes(torch):
    """(label, make(n, axis), width) of each mesh phase_mesh runs: 4 logical
    shards on cuda:0, each with its own stream, and on a machine with two
    or more cards the first power-of-two count of them (up to 4)."""
    from celestia_app_tpu_torch.parallel.mesh import Mesh, device_mesh

    meshes = [(f"{MESH_SHARDS} logical shards on cuda:0",
               lambda n, axis: Mesh([torch.device("cuda", 0)] * n, axis), MESH_SHARDS)]
    count = torch.cuda.device_count()
    if count >= 2:
        width = min(MESH_SHARDS, 1 << (count.bit_length() - 1))
        meshes.append((f"{width} cards", lambda n, axis: device_mesh(n, axis), width))
    return meshes


def phase_mesh(torch, card: str, giant: dict) -> dict:
    """The multi-device plane at full width, on 4 logical shards of cuda:0
    (and again over the real cards where there are two or more):

    k=512 (GF(2^16), vandermonde): the sharded extend over 2 and 4 shards,
    roots, data root and the EDS read back to the host == a single-card
    ExtendedDataSquare.compute, the DAH-only twin's roots too, launches per
    shard as mesh_launches counts them; sharded repair of the square with
    Q3 withheld == the original EDS and roots; a serve mesh of 4 shards:
    4096 samples per axis == the single-card ProofSampler's bytes.  k=2048
    under $CELESTIA_PIPE_PANEL=auto, 4 shards: the sharded panel square's
    data root == phase_giant's, its roots-only twin's too, wall, device busy
    and idle under the profiler, peak allocated above the resident,
    launches per shard; a share gather from its row-sharded EDS == the host
    bytes of the rows; sha256_leaves and sha256_batch == their plain
    versions at one shard's shapes, rs_dense on one owner's column
    contraction shape, and its time there against the bound.  k=1024, the
    FFT column leg: one data root == phase_giant's.  Returns the records."""
    from celestia_app_tpu_torch.da import DataAvailabilityHeader, ExtendedDataSquare
    from celestia_app_tpu_torch.gf.rs import codec_for_width
    from celestia_app_tpu_torch.kernels import _build, panel, rs_dense
    from celestia_app_tpu_torch.kernels import sha256 as sha
    from celestia_app_tpu_torch.kernels.panel_sharded import (
        _owner_generator_slices,
        sharded_panel_pipeline,
    )
    from celestia_app_tpu_torch.parallel import sharded_eds
    from celestia_app_tpu_torch.parallel.sharded_repair import sharded_repair
    from celestia_app_tpu_torch.serve import ForestCache, ProofSampler
    from celestia_app_tpu_torch.serve.shard import ShardedCachedForest, sharded_share_gather

    records = {}
    meshes = mesh_meshes(torch)
    for label, make, width in meshes:
        rec = records[label] = {}
        with environment(GIANT_BASE):
            k = MESH_K
            ods = random_square(k, seed=k + 3)
            ref = ExtendedDataSquare.compute(ods)
            ref_host = ref.squared()
            ref_roots = (ref._row_roots, ref._col_roots, ref._data_root)
            for n in (2, 4):
                if n > width:
                    continue
                mesh = make(n, "data")
                sharded_eds.sharded_extend_and_dah(ods, mesh)  # builds and warms
                torch.cuda.synchronize()
                _build.reset_launches()
                t0 = time.perf_counter()
                eds, rr, cr, droot = sharded_eds.sharded_extend_and_dah(ods, mesh)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                per_shard = check_shard_launches(f"mesh {label} k={k} extend n={n}", mesh,
                                                 mesh_launches(k, n))
                if not all(torch.equal(a, b) for a, b in zip((rr, cr, droot), ref_roots)):
                    raise AssertionError(f"mesh {label} k={k} n={n}: roots != single card")
                if not np.array_equal(eds.numpy(), ref_host):
                    raise AssertionError(f"mesh {label} k={k} n={n}: EDS != single card")
                twin = sharded_eds.make_sharded_dah_pipeline(k, mesh)(ods)
                if not all(torch.equal(a, b) for a, b in zip(twin, ref_roots)):
                    raise AssertionError(f"mesh {label} k={k} n={n}: DAH-only twin != roots")
                rec[f"extend_{n}"] = {"wall_ms": wall, "launches_per_shard": per_shard}
                log(f"[{card}] mesh {label}: k={k} sharded extend over {n} shards: roots, data "
                    f"root and EDS (read back) == single-card compute, DAH-only twin's roots "
                    f"too; {wall:.3f} ms (warm, synchronized); launches per shard {per_shard}")
                del eds, rr, cr, droot, twin

            mesh = make(width, "data")
            present = np.ones((2 * k, 2 * k), dtype=bool)
            present[k:, k:] = False
            damaged = np.where(present[..., None], ref_host, 0).astype(np.uint8)
            dah = DataAvailabilityHeader.from_eds(ref)
            _build.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fixed = sharded_repair(damaged, present, mesh, dah)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            per_shard = mesh.launches()
            if not (np.array_equal(fixed.squared(), ref_host)
                    and all(torch.equal(a, b) for a, b in zip(
                        (fixed._row_roots, fixed._col_roots, fixed._data_root), ref_roots))):
                raise AssertionError(f"mesh {label}: sharded repair != the original square")
            check_launches(f"mesh {label} repair", {n: sum(c[n] for c in per_shard)
                                                    for n in per_shard[0]},
                           {"rs_dense": 3 * width})
            rec["repair_ms"] = wall
            log(f"[{card}] mesh {label}: k={k} sharded repair, Q3 withheld, {width} shards: "
                f"== the original EDS and roots; {wall:.3f} ms (first call: recover matrix "
                f"and replicas); launches per shard {per_shard}")
            del fixed, damaged

            smesh = make(width, "serve")
            sharded = ForestCache(heights=1, spill=1, mesh=smesh).put(1, ref)
            if not isinstance(sharded, ShardedCachedForest):
                raise AssertionError(f"mesh {label}: the serve mesh gave {type(sharded)}")
            single = ForestCache(heights=1, spill=1).put(2, ref)
            sampler = ProofSampler()
            rng = np.random.default_rng(4099)
            for axis in ("row", "col"):
                coords = [tuple(int(v) for v in c) for c in rng.integers(0, 2 * k, (4096, 2))]
                t0 = time.perf_counter()
                got = sampler.sample_batch(sharded, coords, axis=axis)
                ms = (time.perf_counter() - t0) * 1e3
                if got != sampler.sample_batch(single, coords, axis=axis):
                    raise AssertionError(f"mesh {label}: sharded samples axis={axis} != "
                                         "the single-card sampler's")
                rec[f"samples_{axis}_ms"] = ms
                log(f"[{card}] mesh {label}: 4096 samples axis={axis} from forests over "
                    f"{width} serve shards == the single-card ProofSampler's; {ms:.3f} ms")
            del sharded, single, ref

        with environment({**GIANT_BASE, "CELESTIA_PIPE_PANEL": "auto"}):
            k = GIANT_KS[-1]
            ods = random_square(k, seed=k + 7)  # phase_giant's square of this k
            want_root = giant[k]["data_root"]
            mesh = make(width, "extend")
            run = sharded_panel_pipeline(k, mesh=mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first = run(ods)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            if first[3].cpu().numpy().tobytes().hex() != want_root:
                raise AssertionError(f"mesh {label}: k={k} sharded panel root != phase_giant's")
            del first
            torch.cuda.empty_cache()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            t0 = time.perf_counter()
            eds, rr, cr, droot = run(ods)
            got_root = droot.cpu().numpy().tobytes().hex()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() - resident
            rows = panel._AUTO_PANEL_ROWS
            per_shard = check_shard_launches(f"mesh {label} k={k} panel", mesh,
                                             mesh_launches(k, width, rows))
            if got_root != want_root:
                raise AssertionError(f"mesh {label}: k={k} sharded panel root != phase_giant's")
            profiled = device_breakdown(torch, lambda: run(ods)[3].cpu(), card,
                                        f"mesh {label} k={k} sharded panel")
            busy, idle = profiled if profiled else (None, None)
            # A share gather from the row-sharded EDS against the host bytes
            # of the rows it reads (Q0 also against the ODS).
            rng = np.random.default_rng(k)
            lines = rng.choice(2 * k, 64, replace=False)
            coords = [(int(r), int(c)) for r in lines for c in rng.choice(2 * k, 8, replace=False)]
            shares = sharded_share_gather(eds, coords)
            host_rows = {int(r): eds[int(r)].cpu().numpy() for r in lines}
            for (r, c), share in zip(coords, shares):
                if not np.array_equal(share, host_rows[r][c]) or (
                        r < k and c < k and not np.array_equal(share, ods[r, c])):
                    raise AssertionError(f"mesh {label}: share ({r}, {c}) != the host bytes")
            # The hashing kernels at one shard's shapes: the leaves of one
            # panel, and the first level of its 2*slab row trees.
            ext = eds.blocks[1 % width][:rows]
            ns = torch.where((torch.arange(2 * k, device=ext.device) < k)[None, :, None],
                             ext[..., :29], torch.full((29,), 0xFF, dtype=torch.uint8,
                                                       device=ext.device))
            leaves = (ns.reshape(-1, 29), ext.reshape(-1, 512))
            e = max_abs_err(sha.sha256_leaves(*leaves), sha.sha256_leaves_plain(*leaves))
            msgs = torch.from_numpy(rng.integers(0, 256, (2 * (k // width) * k, 181),
                                                 dtype=np.uint8)).to(ext.device)
            e = max(e, max_abs_err(sha.sha256(msgs), sha.sha256_plain(msgs)))
            if e:
                raise AssertionError(f"mesh {label}: a hashing kernel != plain (max err {e})")
            log(f"[{card}] mesh {label}: sha256_leaves == plain on one panel's "
                f"{leaves[1].shape[0]} leaves, sha256_batch == plain on {msgs.shape[0]} 181-byte "
                f"messages (one shard's first row-tree level)")
            del eds, rr, cr, droot, host_rows, ext, ns, leaves, msgs
            torch.cuda.empty_cache()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            twin = sharded_panel_pipeline(k, roots_only=True, mesh=mesh)(ods)
            twin_root = twin[2].cpu().numpy().tobytes().hex()
            twin_ms = (time.perf_counter() - t0) * 1e3
            twin_peak = torch.cuda.max_memory_allocated() - resident
            if twin_root != want_root:
                raise AssertionError(f"mesh {label}: k={k} roots-only twin root != phase_giant's")
            del twin

            # rs_dense on one owner's column contraction: the gathered step
            # panels (n*h rows) against its generator rows of the step.
            codec = codec_for_width(k, "vandermonde")
            m = codec.field.m
            bps = m // 8
            slab = k // width
            bounds = panel.panel_bounds(slab, min(rows, slab))
            g = _owner_generator_slices(k, "vandermonde", mesh.devices, bounds)[0][1 % width]
            top = torch.from_numpy(ods[:width * rows]).to(mesh.devices[0])
            panels = torch.cat([top, top], dim=1)  # (n*h, 2k, S): the contraction's operand shape
            planes = panels.reshape(width * rows, 2 * k, 512 // bps, bps).movedim(3, 1)
            planes = planes.reshape(width * rows, bps, -1).contiguous()
            cols = 4096
            x = planes[..., :cols].contiguous()
            e = max_abs_err(rs_dense.mod2_matmul_planes(g, x, m),
                            rs_dense.mod2_matmul_planes_plain(g, x, m))
            if e:
                raise AssertionError(f"mesh {label}: rs_dense != plain on the owner's column "
                                     f"contraction (max err {e})")
            kernel_ms = cuda_ms(torch, lambda: rs_dense.mod2_matmul_planes(g, planes, m), reps=3)
            Pm, nm = g.shape
            total_cols = planes.shape[2]
            bound_ms, bound_by = bound(Pm * nm + planes.numel() + Pm // 8 * total_cols,
                                       (2.0 * Pm * nm * total_cols, INT8_OPS_PER_S))
            log(f"[{card}] mesh {label}: rs_dense == plain on one owner's column contraction, G "
                f"{tuple(g.shape)}, x {tuple(x.shape)} (first {cols} columns); at the full "
                f"{tuple(planes.shape)}: {kernel_ms:.3f} ms per launch, bound {bound_ms:.3f} ms "
                f"({bound_by}), {100 * bound_ms / kernel_ms:.0f} % of it")
            del top, panels, planes, x
            rec["panel_2048"] = {
                "first_s": first_s, "wall_ms": wall, "busy_ms": busy, "idle": idle,
                "peak_gb": peak / 1e9, "resident_gb": resident / 1e9, "twin_ms": twin_ms,
                "twin_gb": twin_peak / 1e9, "launches_per_shard": per_shard,
                "owner_rs_dense_ms": kernel_ms, "owner_rs_dense_bound_ms": bound_ms}
            log(f"[{card}] mesh {label}: k={k} sharded panel ({width} shards, {rows}-row panels): "
                f"data root == phase_giant's, roots-only twin too; first call {first_s:.3f} s; "
                f"wall {wall:.3f} ms, peak allocated {peak / 1e9:.3f} GB above the resident "
                f"(roots only: {twin_ms:.3f} ms, {twin_peak / 1e9:.3f} GB); launches per shard "
                f"{per_shard}; 512 shares of its row-sharded EDS == the host bytes")

        with environment({**GIANT_BASE, "CELESTIA_PIPE_PANEL": "auto", "CELESTIA_RS_FFT": "on"}):
            k = GIANT_KS[0]
            t0 = time.perf_counter()
            rr, cr, droot = sharded_panel_pipeline(k, roots_only=True, mesh=make(width, "extend"))(
                random_square(k, seed=k + 7))
            fft_root = droot.cpu().numpy().tobytes().hex()
            rec["fft_1024_s"] = time.perf_counter() - t0
            if fft_root != giant[k]["data_root"]:
                raise AssertionError(f"mesh {label}: k={k} FFT leg root != phase_giant's")
            log(f"[{card}] mesh {label}: k={k} sharded panel on the FFT column leg (all_to_all "
                f"to column blocks and back): data root == phase_giant's "
                f"({rec['fft_1024_s']:.3f} s, first call)")
        torch.cuda.empty_cache()
    log(f"mesh: ran {[label for label, _, _ in meshes]}; on one card every collective is a "
        f"copy inside the card (the interconnect is not measured)")
    log(f"mesh records: {json.dumps(records)}")
    return records


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
    log(rs_dense_roles(_build))
    log(rs_dense_leaf_roles(_build))

    table = Table()
    t0 = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t0
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

    phase_kernels(torch, table, card)
    phase_done("kernels")
    phase_goldens(card)
    phase_done("goldens")
    counts = phase_full(torch, 512, "vandermonde", card, seed=512)
    phase_full(torch, 128, "leopard", card, seed=128)
    phase_done("full")
    phase_block(card)
    phase_done("block")
    eds = read_side_square(512)
    phase_repair(torch, eds, card)
    phase_done("repair")
    phase_das(torch, eds, card)
    phase_done("das")
    serve_counts = phase_serve(torch, eds, card)
    phase_done("serve")
    ops_counts = phase_ops(torch, eds, card)
    phase_done("ops")
    phase_uploads(torch, eds, card)
    phase_done("uploads")
    del eds
    phase_stream(torch, card)
    phase_done("stream")
    phase_faults(torch, card)
    phase_done("faults")
    commit_counts = phase_commitments(torch, card)
    phase_done("commitments")
    app_counts = phase_app(torch, card)
    phase_done("app")
    chain_counts = phase_chain(torch, card)
    phase_done("chain")
    node_counts = phase_node(torch, card)
    phase_done("node")
    consensus = phase_consensus(torch, card)
    phase_done("consensus")
    query_counts = phase_querier(torch, card)
    phase_done("querier")
    bridge_counts = phase_bridge(torch, card)
    phase_done("bridge")
    giant = phase_giant(torch, card)
    phase_done("giant")
    phase_mesh(torch, card, giant)
    phase_done("mesh")
    log(f"launches: per commitment batch {commit_counts}; per k={APP_K} Prepare "
        f"{app_counts['prepare']} and non-proposer Process {app_counts['process']}; per k={APP_K} "
        f"chain height's Prepare, Process, Finalize and Commit {chain_counts}; per k={APP_K} "
        f"node height {node_counts['height']}, of them its recheck's {node_counts['recheck']}; "
        f"per gossip height and validator {consensus['validators']}; per proof "
        f"query {query_counts}; in the bridge worker over its run {bridge_counts}; per DAS "
        f"payload and heal {serve_counts}; per gated GET, state-sync catch-up block and, per "
        f"child, devnet height {ops_counts}")

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
