"""Bitsliced XOR RS encode core: the dense map with the contraction packed
32 bits to a word.

    acc[i, c]    = XOR_w ( G_words[w, i] & B_words[w, c] )
    parity[i, c] = parity of acc[i, c]'s 32 bits

On a CUDA tensor `mod2_matmul_planes_xor` launches csrc/rs_xor.cu (the
counterpart of celestia_app_tpu/kernels/rs_xor.py::mod2_matmul_planes_xor);
on a CPU tensor it runs the plain version below.  Words are int32 tensors
holding the uint32 bit patterns.

`extend_leaf_digests` is the fused leaf-hash epilogue of the `fused_epi`
pipeline: the column-phase extend of the top half and the NMT leaf digests
of the bottom half it produces, in one launch of csrc/rs_xor_leaf.cu (the
counterpart of celestia_app_tpu/kernels/rs_xor.py::extend_leaf_digests).
"""

from __future__ import annotations

import torch

from celestia_app_tpu_torch.constants import SHARE_SIZE
from celestia_app_tpu_torch.device import resolve_device
from celestia_app_tpu_torch.kernels import _build
from celestia_app_tpu_torch.kernels.nmt import leaf_digests, parity_namespaces
from celestia_app_tpu_torch.kernels.rs_dense import _pack_bits
from celestia_app_tpu_torch.kernels.sha256 import sha256_leaves_plain


def pack_data_words(x: torch.Tensor) -> torch.Tensor:
    """(n, bps, cols) uint8 byte planes -> (NW, cols) int32 words.

    Contraction row j*m + 8*b + t (share j, byte b, bit t) lands on bit
    8*q + t of word w where the flat byte row j*bps + b = 4*w + q: four
    consecutive byte rows little-endian per word, zero-padded to a multiple
    of 4 — the bit order convert.pack_generator_words uses.
    """
    n, bps, cols = x.shape
    rows = n * bps
    flat = x.reshape(rows, cols)
    pad = (-rows) % 4
    if pad:
        flat = torch.cat(
            [flat, torch.zeros((pad, cols), dtype=torch.uint8, device=x.device)]
        )
    by = flat.reshape(-1, 4, cols).permute(0, 2, 1).contiguous()  # (NW, cols, 4)
    return by.view(torch.int32).reshape(-1, cols)


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
    B = pack_data_words(x)
    G_words = G_words.contiguous()
    out = torch.empty((Pm // m, bps, cols), dtype=torch.uint8, device=x.device)
    if cols:
        _build.launch("rs_xor", "rs_xor", "rs_xor_mod2", G_words, B, out, nw, Pm, cols)
    return out


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
    top: torch.Tensor, G_words: torch.Tensor, m: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the epilogue kernel: the column-phase
    XOR encode of `top`, then sha256(0x00 || 0xFF^29 || share) per share."""
    from celestia_app_tpu_torch.kernels.rs import _encode_with  # rs imports this module

    _check_top(top, m)
    bottom = _encode_with(mod2_matmul_planes_xor_plain, top, G_words, m, 0)
    P, n2, S = bottom.shape
    flat = bottom.reshape(P * n2, S)
    hashes = sha256_leaves_plain(parity_namespaces((P * n2,), top.device), flat)
    return bottom, hashes.reshape(P, n2, 32)


def extend_leaf_digests(
    top: torch.Tensor, G_words: torch.Tensor, m: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Column-phase extend + bottom-half NMT leaf digests in one launch.

    top: (k, 2k, 512) uint8, the row-extended top half; the contraction
    runs over axis 0.  G_words: (NW, P*m) int32.  Returns bottom (P, 2k,
    512) uint8, equal to encode(top, 0), and hashes (P, 2k, 32) uint8,
    equal to sha256(0x00 || 0xFF^29 || share) for each bottom share."""
    if top.device.type == "cpu":
        return extend_leaf_digests_plain(top, G_words, m)
    _check_top(top, m)
    k, n2, S = top.shape
    bps = m // 8
    nsym = S // bps
    # Column b*nsym + sym of the planes holds symbol sym of batch column b.
    planes = top.reshape(k, n2, nsym, bps).movedim(3, 1).reshape(k, bps, n2 * nsym)
    _check(G_words, planes, m)
    nw, Pm = G_words.shape
    B = pack_data_words(planes)
    G_words = G_words.contiguous()
    bottom = torch.empty((Pm // m, n2, S), dtype=torch.uint8, device=top.device)
    hashes = torch.empty((Pm // m, n2, 32), dtype=torch.uint8, device=top.device)
    if bottom.numel():
        _build.launch("rs_xor_leaf", "rs_xor_leaf", "rs_xor_leaf", G_words, B, bottom,
                      hashes, nw, Pm, n2, m)
    return bottom, hashes


def bottom_leaf_fn(k: int, construction: str | None = None, *, fallback_encode,
                   device=None):
    """f(top) -> (bottom, leaf_hashes) for the fused_epi pipeline.

    On CUDA: the epilogue kernel, always on the XOR schedule (the
    counterpart of the TPU branch of
    celestia_app_tpu/kernels/rs_xor.py::bottom_leaf_fn).  On the CPU: the
    seated encode `fallback_encode` (required: the caller built it, and
    the epilogue must not fork the RS seat there), then the leaf digests
    under the parity namespace.  Both give the same bytes."""
    from celestia_app_tpu_torch.gf.rs import active_construction
    from celestia_app_tpu_torch.kernels.rs import _codec_tensors  # rs imports this module

    dev = resolve_device(device)
    if dev.type == "cuda":
        m, tensors = _codec_tensors(k, construction or active_construction(), dev)
        G_words = tensors["G_words"]

        def fn(top: torch.Tensor):
            return extend_leaf_digests(top, G_words, m)

        return fn

    par_ns = parity_namespaces((k, 2 * k), dev)

    def fn(top: torch.Tensor):
        bottom = fallback_encode(top, 0)
        _, _, hashes = leaf_digests(par_ns, bottom)
        return bottom, hashes

    return fn
