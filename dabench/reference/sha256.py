"""SHA-256 (FIPS 180-4) of many equal-length messages at once, in plain
PyTorch: one elementwise operation per step of the algorithm over all
messages, on whatever device the messages lie.  Words live in int64 and are
masked to 32 bits after every sum, so no operation depends on how a device
wraps signed overflow.  Tests hold it to hashlib.
"""

from __future__ import annotations

import torch

_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4,
    0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE,
    0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F,
    0x4A7484AA, 0x5CB0A9DC, 0x76F988DA, 0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC,
    0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070, 0x19A4C116,
    0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7,
    0xC67178F2,
)
_H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB,
       0x5BE0CD19)
_M = 0xFFFFFFFF


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M


def _pad(msgs: torch.Tensor) -> torch.Tensor:
    """(N, L) uint8 -> (N, 64 * blocks) uint8, padded."""
    n, length = msgs.shape
    total = (length + 9 + 63) // 64 * 64
    buf = torch.zeros((n, total), dtype=torch.uint8, device=msgs.device)
    buf[:, :length] = msgs
    buf[:, length] = 0x80
    bit_len = length * 8
    buf[:, total - 8:] = torch.tensor(list(bit_len.to_bytes(8, "big")), dtype=torch.uint8,
                                      device=msgs.device)
    return buf


def _words(block: torch.Tensor) -> list[torch.Tensor]:
    """(N, 64) uint8 -> 16 big-endian words, each (N,) int64."""
    b = block.to(torch.int64).view(-1, 16, 4)
    words = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    return list(words.unbind(1))


def sha256(msgs: torch.Tensor) -> torch.Tensor:
    """(N, L) uint8 messages -> (N, 32) uint8 digests."""
    buf = _pad(msgs)
    n = buf.shape[0]
    h = [torch.full((n,), v, dtype=torch.int64, device=msgs.device) for v in _H0]
    for blk in range(buf.shape[1] // 64):
        w = _words(buf[:, 64 * blk:64 * (blk + 1)])
        for i in range(16, 64):
            s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
            s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
            w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M)
        a, b, c, d, e, f, g, hh = h
        for i in range(64):
            s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ ((e ^ _M) & g)
            t1 = (hh + s1 + ch + _K[i] + w[i]) & _M
            s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            t2 = s0 + maj
            hh, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M, c, b, a, (t1 + t2) & _M
        h = [(x + y) & _M for x, y in zip(h, (a, b, c, d, e, f, g, hh))]
    state = torch.stack(h, dim=1)  # (N, 8)
    shifts = torch.tensor([24, 16, 8, 0], device=msgs.device)
    return ((state[..., None] >> shifts) & 0xFF).to(torch.uint8).reshape(n, 32)
