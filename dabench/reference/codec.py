"""The reference extension: ODS -> EDS as a 0/1 matrix product in plain
PyTorch.

Each line of k shares is a column of k symbols per symbol position; its
parity is G times that column over GF(2^m), which over GF(2) is
`generator_bits` (k*m, k*m) times the column's k*m bits.  The product runs
as a floating-point matrix multiplication of 0/1 values, summed exactly in
float32 (TF32 off: the sums stay below 2^24, so every parity bit is the
sum's lowest bit), and reduced mod 2.  `dtype=torch.bfloat16` runs the
same product with its sums rounded to bfloat16's 8 significant bits: the
control, which has to fail the comparison.

GF(2^16) symbols are little-endian byte pairs of a share.  The EDS is
[[Q0, Q1], [Q2, Q3]]: Q1 extends Q0's rows, Q2 and Q3 extend the columns
of Q0 and Q1.
"""

from __future__ import annotations

import contextlib

import torch

from dabench.reference.field import field_bits, generator_bits

SHARE_SIZE = 512
#: Columns of the bit matrix per product: bounds the float32 operands of
#: one multiplication to ~0.5 GiB at k=512.
_CHUNK_COLUMNS = 1 << 14


@contextlib.contextmanager
def exact_float32():
    """float32 products without TF32 (restored on exit)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


class Codec:
    """G over GF(2) for one (k, construction), on `device`, in `dtype`;
    with `recover`, the map from a line's parity half back to its data."""

    def __init__(self, k: int, construction: str, device, dtype=torch.float32,
                 recover: bool = False):
        self.k, self.m = k, field_bits(k)
        self.dtype = dtype
        self.g_bits = torch.from_numpy(generator_bits(k, construction, recover)).to(device, dtype)

    def _bits(self, lines: torch.Tensor) -> torch.Tensor:
        """(L, k, S) uint8 -> (k*m, L*nsym) 0/1 in the product's dtype."""
        L, k, _ = lines.shape
        x = lines.to(torch.int64)
        if self.m == 16:
            x = x[..., 0::2] | (x[..., 1::2] << 8)
        t = torch.arange(self.m, device=lines.device)
        bits = (x[..., None] >> t) & 1  # (L, k, nsym, m)
        return bits.permute(1, 3, 0, 2).reshape(k * self.m, -1).to(self.dtype)

    def _symbols_to_bytes(self, bits: torch.Tensor, L: int) -> torch.Tensor:
        """(k*m, L*nsym) 0/1 int64 -> (L, k, S) uint8."""
        k, m = self.k, self.m
        b = bits.reshape(k, m, L, -1).permute(2, 0, 3, 1)  # (L, k, nsym, m)
        sym = (b << torch.arange(m, device=bits.device)).sum(dim=-1)
        if m == 16:
            sym = torch.stack([sym & 0xFF, sym >> 8], dim=-1).reshape(L, k, -1)
        return sym.to(torch.uint8)

    def parity(self, lines: torch.Tensor) -> torch.Tensor:
        """(L, k, S) data shares per line -> (L, k, S) parity shares (with
        `recover`: parity shares -> data shares)."""
        L = lines.shape[0]
        nsym = SHARE_SIZE * 8 // self.m
        per = max(1, _CHUNK_COLUMNS // nsym)
        out = []
        with exact_float32():
            for lo in range(0, L, per):
                part = lines[lo:lo + per]
                prod = self.g_bits @ self._bits(part)
                bits = prod.float().round().to(torch.int64) & 1
                out.append(self._symbols_to_bytes(bits, part.shape[0]))
        return torch.cat(out)

    def extend(self, ods: torch.Tensor) -> torch.Tensor:
        """(k, k, S) uint8 -> (2k, 2k, S) uint8."""
        q1 = self.parity(ods)  # row r's parity over its columns
        top = torch.cat([ods, q1], dim=1)  # (k, 2k, S)
        bottom = self.parity(top.transpose(0, 1)).transpose(0, 1)  # columns' parity
        return torch.cat([top, bottom], dim=0)
