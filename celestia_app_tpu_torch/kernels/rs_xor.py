"""Bitsliced XOR RS encode core: the dense map with the contraction packed
32 bits to a word.

    acc[i, c]    = XOR_w ( G_words[w, i] & B_words[w, c] )
    parity[i, c] = parity of acc[i, c]'s 32 bits

On a CUDA tensor `mod2_matmul_planes_xor` launches csrc/rs_xor.cu (the
counterpart of celestia_app_tpu/kernels/rs_xor.py::mod2_matmul_planes_xor),
which runs the AND and the parity on the binary tensor cores (the low bit
of wgmma .b1.and.popc) over `kernel_operands`; on a CPU tensor it runs the
plain version below.  Words are int32 tensors holding the uint32 bit
patterns.

`extend_leaf_digests` is the fused leaf-hash epilogue of the `fused_epi`
pipeline: the column-phase extend of the top half and the NMT leaf digests
of the bottom half it produces, in one launch of csrc/rs_dense_leaf.cu (the
counterpart of celestia_app_tpu/kernels/rs_xor.py::extend_leaf_digests).
The name and place are the JAX module's; the kernel computes the product
on int8 tensor cores (the dense kernel's main loop), not with XOR words.
"""

from __future__ import annotations

import torch

from celestia_app_tpu_torch.constants import SHARE_SIZE
from celestia_app_tpu_torch.device import resolve_device
from celestia_app_tpu_torch.kernels import _build
from celestia_app_tpu_torch.kernels.nmt import leaf_digests, parity_namespaces
from celestia_app_tpu_torch.kernels.rs_dense import (
    _check as _check_dense,
    _pack_bits,
    check_aligned,
    mod2_matmul_planes_plain,
    padded_width,
    tma_rows,
)
from celestia_app_tpu_torch.kernels.sha256 import sha256_leaves_plain


def pack_data_words(x: torch.Tensor) -> torch.Tensor:
    """(n, bps, cols) uint8 byte planes -> (NW, cols) int32 words.

    Contraction row j*m + 8*b + t (share j, byte b, bit t) lands on bit
    8*q + t of word w where the flat byte row j*bps + b = 4*w + q: four
    consecutive byte rows little-endian per word, zero-padded to a multiple
    of 4 — the bit order convert.pack_generator_words uses.  The rows' stride
    is cols rounded up to 4 words (a TMA row stride); the columns past cols
    are not written.
    """
    n, bps, cols = x.shape
    rows = n * bps
    flat = x.reshape(rows, cols)
    pad = (-rows) % 4
    if pad:
        flat = torch.cat(
            [flat, torch.zeros((pad, cols), dtype=torch.uint8, device=x.device)]
        )
    nw = (rows + pad) // 4
    ld = -(-cols // 4) * 4
    buf = torch.empty((nw, ld), dtype=torch.int32, device=x.device)
    buf.view(torch.uint8).view(nw, ld, 4)[:, :cols].copy_(
        flat.reshape(nw, 4, cols).permute(0, 2, 1))
    return buf[:, :cols]


def _check(G_words: torch.Tensor, x: torch.Tensor, m: int) -> None:
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise ValueError(f"x must be (n, bps, cols) uint8, got {x.dtype} {tuple(x.shape)}")
    n, bps, _ = x.shape
    nw, Pm = G_words.shape
    if (G_words.dtype != torch.int32 or nw != (n * m + 31) // 32 or bps * 8 != m
            or Pm % m):
        raise ValueError(f"G_words {G_words.dtype} {tuple(G_words.shape)} does not fit "
                         f"x {tuple(x.shape)} at m={m}")
    if G_words.device != x.device:
        raise ValueError("G_words and x must be on one device")


def mod2_matmul_planes_xor_plain(
    G_words: torch.Tensor, x: torch.Tensor, m: int
) -> torch.Tensor:
    """The plain PyTorch version of the XOR kernel."""
    _check(G_words, x, m)
    _, bps, cols = x.shape
    B = pack_data_words(x)
    nw, Pm = G_words.shape
    acc = torch.zeros((Pm, cols), dtype=torch.int32, device=x.device)
    step = torch.empty_like(acc)
    for w in range(nw):
        torch.bitwise_and(G_words[w][:, None], B[w][None, :], out=step)
        acc ^= step
    # Fold the 32 bits to bit 0.  The shifts are arithmetic on int32, but
    # each fold reads only bits that the earlier folds left exact.
    for s in (16, 8, 4, 2, 1):
        acc ^= acc >> s
    bits = acc.bitwise_and_(1).to(torch.uint8)
    return _pack_bits(bits, Pm // m, bps)


def mod2_matmul_planes_xor(
    G_words: torch.Tensor, x: torch.Tensor, m: int
) -> torch.Tensor:
    """G_words (NW, P*m) int32, x (n, bps, cols) uint8 byte planes ->
    (P, bps, cols) uint8 parity planes."""
    if x.device.type == "cpu":
        return mod2_matmul_planes_xor_plain(G_words, x, m)
    _check(G_words, x, m)
    _, bps, cols = x.shape
    nw, Pm = G_words.shape
    # (Pm/8, cols) output rows at a padded stride, as rs_dense's.
    out = torch.empty((Pm // 8, padded_width(cols)), dtype=torch.uint8,
                      device=x.device)[:, :cols]
    if cols:
        G, B = kernel_operands(G_words, x)
        check_aligned(G, B, out)
        _build.launch("rs_xor", "rs_xor", "rs_xor_mod2", G, G.stride(0), B, 4 * B.stride(0),
                      out, out.stride(0), Pm, nw, cols)
    return out.view(Pm // m, bps, cols)


def kernel_operands(G_words: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's two inputs: the generator transposed to (Pm, 4*NW)
    bytes, row r's contraction bits LSB first (the bytes of row r of
    np.packbits(G_bits, axis=1, bitorder="little"), zero-padded to whole
    words), K-major as a wgmma B operand must be, at a TMA row stride; and
    the data words of pack_data_words."""
    nw, Pm = G_words.shape
    rows = torch.empty((Pm, nw), dtype=torch.int32, device=G_words.device)
    rows.copy_(G_words.t())
    return tma_rows(rows.view(torch.uint8)), pack_data_words(x)


def pipe_rates(device=None) -> dict:
    """The pipes the XOR kernel's inner product could run on, measured on
    the card by csrc/rs_xor_probe.cu on every SM at once: "mma_b1" for the
    binary tensor cores through mma.sync m16n8k256 .b1 and.popc, "lop3" for
    the int32 pipes (acc ^= g & b), "wgmma_b1" for the binary tensor cores
    through wgmma m64n256k256 .b1 and.popc (the kernel's), in bit-products
    per second, with each launch's mean time in ms under "<pipe>_ms".  No
    path calls it: chip_smoke.py prints it, and "wgmma_b1" is the bound
    basis of the kernel there and in kernels/sweep_rs_dense.py."""
    import ctypes

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the pipe probe runs on a CUDA device, not {dev}")
    lib = _build.library("rs_xor_probe")
    v = (ctypes.c_int * 7)()
    lib.rs_xor_probe_info(v)
    threads, mma_chains, mma_bits, lop_chains, lop_bits, wg_mmas, wg_bits = list(v)
    blocks = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    rates = {}
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        for mode, pipe, iters, per_trip in (
                (0, "mma_b1", 1 << 14, threads // 32 * mma_chains * mma_bits),
                (1, "lop3", 1 << 16, threads * lop_chains * lop_bits),
                (2, "wgmma_b1", 1 << 12, threads // 128 * wg_mmas * wg_bits)):
            def call(mode=mode, iters=iters):
                rc = lib.rs_xor_probe(mode, blocks, iters, out.data_ptr(), stream.cuda_stream)
                if rc:
                    raise RuntimeError(f"rs_xor_probe mode {mode} failed to launch: "
                                       f"CUDA error {rc}")

            call()  # warm
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(3):
                call()
            end.record(stream)
            end.synchronize()
            ms = start.elapsed_time(end) / 3
            rates[pipe] = blocks * iters * per_trip / (ms * 1e-3)
            rates[f"{pipe}_ms"] = ms
    return rates


# --------------------------------------------------------------------------
# Fused leaf-hash epilogue
# --------------------------------------------------------------------------


def _check_top(top: torch.Tensor, m: int) -> None:
    if top.dtype != torch.uint8 or top.dim() != 3 or top.shape[2] != SHARE_SIZE:
        raise ValueError(f"top must be (k, 2k, {SHARE_SIZE}) uint8, got "
                         f"{top.dtype} {tuple(top.shape)}")
    if m not in (8, 16):
        raise ValueError(f"the epilogue takes GF(2^8) or GF(2^16) symbols, got m={m}")


def extend_leaf_digests_plain(
    top: torch.Tensor, G_bits: torch.Tensor, m: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the epilogue kernel: the column-phase
    dense encode of `top`, then sha256(0x00 || 0xFF^29 || share) per share."""
    from celestia_app_tpu_torch.kernels.rs import _encode_with  # rs imports this module

    _check_top(top, m)
    bottom = _encode_with(mod2_matmul_planes_plain, top, G_bits, m, 0)
    P, n2, S = bottom.shape
    flat = bottom.reshape(P * n2, S)
    hashes = sha256_leaves_plain(parity_namespaces((P * n2,), top.device), flat)
    return bottom, hashes.reshape(P, n2, 32)


def leaf_operands(
    top: torch.Tensor, G_bits: torch.Tensor, m: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The epilogue kernel's two inputs: the generator with a TMA row stride
    (rs_dense.tma_rows) and the half square as (n, n2*512) rows of shares.

    The kernel reads the shares as they lie.  Row j of the second is byte
    row j of the byte planes at m=8; at m=16 its bytes 2c and 2c + 1 are
    byte rows 2j and 2j + 1 of plane column c, which the kernel's consumer
    threads de-interleave as they read them (rs_dense.cuh, kXBps = 2)."""
    _check_top(top, m)
    n, n2, S = top.shape
    bps = m // 8
    _check_dense(G_bits, top.reshape(n, bps, -1), m)
    rows = top.contiguous().view(n, n2 * S)
    return tma_rows(G_bits), rows


def extend_leaf_digests(
    top: torch.Tensor, G_bits: torch.Tensor, m: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Column-phase extend + bottom-half NMT leaf digests in one launch.

    top: (n, n2, 512) uint8, the row-extended top half ((k, 2k, 512) on the
    main path); the contraction runs over axis 0.  G_bits: (P*m, n*m) int8
    {0,1}.  Returns bottom (P, n2, 512) uint8, equal to encode(top, 0), and
    hashes (P, n2, 32) uint8, equal to sha256(0x00 || 0xFF^29 || share) for
    each bottom share."""
    if top.device.type == "cpu":
        return extend_leaf_digests_plain(top, G_bits, m)
    G, rows = leaf_operands(top, G_bits, m)
    _, n2, S = top.shape
    Pm, nm = G_bits.shape
    bottom = torch.empty((Pm // m, n2, S), dtype=torch.uint8, device=top.device)
    hashes = torch.empty((Pm // m, n2, 32), dtype=torch.uint8, device=top.device)
    if bottom.numel():
        check_aligned(G, rows, bottom, hashes)
        _build.launch("rs_dense_leaf", "rs_dense_leaf", "rs_dense_leaf", G, G.stride(0), rows,
                      rows.stride(0), bottom, hashes, Pm, nm, n2, m)
    return bottom, hashes


def bottom_leaf_fn(k: int, construction: str | None = None, *, fallback_encode,
                   device=None):
    """f(top) -> (bottom, leaf_hashes) for the fused_epi pipeline.

    On CUDA: the epilogue kernel under every $CELESTIA_RS_XOR value, as
    the TPU branch of celestia_app_tpu/kernels/rs_xor.py::bottom_leaf_fn
    ignores the RS seat.  On the CPU: the
    seated encode `fallback_encode` (required: the caller built it, and
    the epilogue must not fork the RS seat there), then the leaf digests
    under the parity namespace.  Both give the same bytes."""
    from celestia_app_tpu_torch.gf.rs import active_construction
    from celestia_app_tpu_torch.kernels.rs import generator_tensor  # rs imports this module

    dev = resolve_device(device)
    if dev.type == "cuda":
        m, G_bits = generator_tensor(k, construction or active_construction(), dev)

        def fn(top: torch.Tensor):
            return extend_leaf_digests(top, G_bits, m)

        return fn

    par_ns = parity_namespaces((k, 2 * k), dev)

    def fn(top: torch.Tensor):
        bottom = fallback_encode(top, 0)
        _, _, hashes = leaf_digests(par_ns, bottom)
        return bottom, hashes

    return fn
