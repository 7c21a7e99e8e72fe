"""Dense RS encode core: (G_bits x bits(x)) mod 2 on byte planes.

On a CUDA tensor `mod2_matmul_planes` launches csrc/rs_dense.cu (the
counterpart of celestia_app_tpu/kernels/rs_pallas.py and of the XLA dense
path kernels/rs._mod2_matmul_planes); on a CPU tensor it runs the plain
version: unpack to bits, int32 matmul, `& 1`, repack LSB-first.

The kernel reads and writes through TMA, which needs each row stride to be
a multiple of 16 bytes and each base 16-byte aligned.  `tma_rows` gives a
tensor that already is so back unchanged (the main path:
convert.expand_bits_tensor pads the generator's rows once, and its column counts are multiples of 256) and
copies any other into a zero-padded row stride at an aligned base.
"""

from __future__ import annotations

import torch

from celestia_app_tpu_torch.kernels import _build


def _check(G_bits: torch.Tensor, x: torch.Tensor, m: int) -> None:
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise ValueError(f"x must be (n, bps, cols) uint8, got {x.dtype} {tuple(x.shape)}")
    n, bps, _ = x.shape
    Pm, nm = G_bits.shape
    if G_bits.dtype != torch.int8 or nm != n * m or bps * 8 != m or Pm % m:
        raise ValueError(f"G_bits {G_bits.dtype} {tuple(G_bits.shape)} does not fit "
                         f"x {tuple(x.shape)} at m={m}")
    if G_bits.device != x.device:
        raise ValueError("G_bits and x must be on one device")


TMA_ALIGN = 16


def padded_width(width: int) -> int:
    """`width` bytes rounded up to a TMA row stride."""
    return -(-width // TMA_ALIGN) * TMA_ALIGN


def tma_rows(t: torch.Tensor) -> torch.Tensor:
    """A 2-D byte tensor with unit column stride, a row stride that is a
    multiple of 16 bytes and a 16-byte aligned base, equal to `t`: `t`
    itself when it is so already, else a view of a copy with zero-padded
    rows (a column slice of a generator can start mid-stride)."""
    rows, width = t.shape
    if (t.stride(1) == 1 and t.stride(0) % TMA_ALIGN == 0 and t.stride(0) >= width
            and t.data_ptr() % TMA_ALIGN == 0):
        return t
    buf = torch.zeros((rows, padded_width(width)), dtype=t.dtype, device=t.device)
    buf[:, :width] = t
    return buf[:, :width]


def check_aligned(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (TMA's rule)."""
    for t in tensors:
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"tensor at {t.data_ptr():#x} is not {TMA_ALIGN}-byte aligned")


def _unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """(n, bps, cols) bytes -> (n*bps*8, cols) int8 bits, LSB first."""
    n, bps, cols = x.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)[None, None, :, None]
    return ((x[:, :, None, :] >> shifts) & 1).reshape(n * bps * 8, cols).to(torch.int8)


def _pack_bits(bits: torch.Tensor, P: int, bps: int) -> torch.Tensor:
    """(P*bps*8, cols) 0/1 uint8 -> (P, bps, cols) bytes, LSB first."""
    cols = bits.shape[1]
    planes = bits.reshape(P, bps, 8, cols)
    out = torch.zeros((P, bps, cols), dtype=torch.uint8, device=bits.device)
    for t in range(8):
        out |= planes[:, :, t] << t
    return out


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x (K, N) -> int32 (M, N) through torch._int_mm, zero-padded
    to multiples of 32 (cuBLASLt refuses a contraction of 8, as at k=1).
    Used by the plain version only."""
    M, K = a.shape
    N = b.shape[1]
    Mp, Kp, Np = (-(-v // 32) * 32 for v in (M, K, N))
    if (Mp, Kp) != (M, K):
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        b = torch.nn.functional.pad(b, (0, Np - N, 0, Kp - K))
    return torch._int_mm(a.contiguous(), b.contiguous())[:M, :N]


def mod2_matmul_planes_plain(G_bits: torch.Tensor, x: torch.Tensor, m: int) -> torch.Tensor:
    """The plain PyTorch version of the dense kernel."""
    _check(G_bits, x, m)
    _, bps, _ = x.shape
    acc = int_mm(G_bits, _unpack_bits(x))  # (P*m, cols) int32
    bits = acc.bitwise_and_(1).to(torch.uint8)
    return _pack_bits(bits, G_bits.shape[0] // m, bps)


def mod2_matmul_planes(G_bits: torch.Tensor, x: torch.Tensor, m: int) -> torch.Tensor:
    """G_bits (P*m, n*m) int8 {0,1}, x (n, bps, cols) uint8 byte planes ->
    (P, bps, cols) uint8 parity planes."""
    if x.device.type == "cpu":
        return mod2_matmul_planes_plain(G_bits, x, m)
    _check(G_bits, x, m)
    n, bps, cols = x.shape
    Pm, nm = G_bits.shape
    # (Pm/8, cols) output rows at a padded stride; a plain contiguous tensor
    # whenever cols is a multiple of 16.
    out = torch.empty((Pm // 8, padded_width(cols)), dtype=torch.uint8,
                      device=x.device)[:, :cols]
    if cols:
        G = tma_rows(G_bits)
        planes = tma_rows(x.reshape(n * bps, cols))
        check_aligned(G, planes, out)
        _build.launch("rs_dense", "rs_dense", "rs_dense_mod2", G, G.stride(0),
                      planes, planes.stride(0), out, out.stride(0), Pm, nm, cols)
    return out.view(Pm // m, bps, cols)
