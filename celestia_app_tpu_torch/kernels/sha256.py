"""Batched fixed-length SHA-256: (N, L) uint8 -> (N, 32) uint8.

Every hash of the block-square path goes through here, each a batch of
same-length messages:

    NMT leaf    0x00 || ns(29) || share(512)   = 542 B -> 9 blocks
    NMT node    0x01 || left(90) || right(90)  = 181 B -> 3 blocks
    merkle leaf 0x00 || row-or-col root(90)    =  91 B -> 2 blocks
    merkle node 0x01 || h(32) || h(32)         =  65 B -> 2 blocks

On a CUDA tensor `sha256` and `sha256_leaves` launch the kernels of
csrc/sha256.cu (counterparts of celestia_app_tpu/kernels/sha256.py's
_sha256_pallas and sha256_leaves_pallas); on a CPU tensor they run the plain
versions below, which compute in int64 masked to 32 bits because torch on
the CPU has no shifts or adds for uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, SHARE_SIZE
from celestia_app_tpu_torch.kernels import _build

_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)
_H0 = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)
_M32 = 0xFFFFFFFF

LEAF_LEN = 1 + NAMESPACE_SIZE + SHARE_SIZE  # 542


def _pad_tail(length: int) -> np.ndarray:
    """The constant SHA-256 padding appended to every length-`length` message."""
    padded = ((length + 9 + 63) // 64) * 64
    tail = np.zeros(padded - length, dtype=np.uint8)
    tail[0] = 0x80
    tail[-8:] = np.frombuffer((length * 8).to_bytes(8, "big"), dtype=np.uint8)
    return tail


def _message_words(msgs: torch.Tensor) -> torch.Tensor:
    """(N, L) uint8 -> (N, nblocks, 16) big-endian words as int64."""
    n, length = msgs.shape
    tail = torch.from_numpy(_pad_tail(length)).to(msgs.device)
    full = torch.cat([msgs, tail.expand(n, -1)], dim=1)
    w = full.reshape(n, full.shape[1] // 64, 16, 4).to(torch.int64)
    return (w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8) | w[..., 3]


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M32


def _compress(state: list[torch.Tensor], block: torch.Tensor) -> list[torch.Tensor]:
    """One compression of (N, 16) words into eight (N,) state words."""
    ws = [block[:, r] for r in range(16)]
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        if i >= 16:
            x15, x2 = ws[(i + 1) % 16], ws[(i + 14) % 16]
            s0 = _rotr(x15, 7) ^ _rotr(x15, 18) ^ (x15 >> 3)
            s1 = _rotr(x2, 17) ^ _rotr(x2, 19) ^ (x2 >> 10)
            ws[i % 16] = (ws[i % 16] + s0 + ws[(i + 9) % 16] + s1) & _M32
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ _M32) & g)
        t1 = (h + S1 + ch + _K[i] + ws[i % 16]) & _M32
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = S0 + maj
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + t2) & _M32
    return [(s + v) & _M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def _digest_bytes(state: list[torch.Tensor]) -> torch.Tensor:
    """Eight (N,) state words -> (N, 32) big-endian digest bytes."""
    words = torch.stack(state, dim=1)  # (N, 8)
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=words.device)
    by = (words[..., None] >> shifts) & 0xFF
    return by.to(torch.uint8).reshape(words.shape[0], 32)


def sha256_plain(msgs: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the generic kernel."""
    n = msgs.shape[0]
    words = _message_words(msgs)
    state = [torch.full((n,), v, dtype=torch.int64, device=msgs.device) for v in _H0]
    for blk in range(words.shape[1]):
        state = _compress(state, words[:, blk])
    return _digest_bytes(state)


def sha256_leaves_plain(ns: torch.Tensor, shares: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the fused-leaf kernel."""
    prefix = torch.zeros((shares.shape[0], 1), dtype=torch.uint8, device=shares.device)
    return sha256_plain(torch.cat([prefix, ns, shares], dim=1))


def _check_bytes(name: str, t: torch.Tensor, width: int | None = None) -> None:
    if t.dtype != torch.uint8 or t.dim() != 2:
        raise ValueError(f"{name} must be a 2-D uint8 tensor, got {t.dtype} {tuple(t.shape)}")
    if width is not None and t.shape[1] != width:
        raise ValueError(f"{name} rows must be {width} bytes, got {t.shape[1]}")


def sha256(msgs: torch.Tensor) -> torch.Tensor:
    """Batched SHA-256 over same-length messages: (N, L) uint8 -> (N, 32)."""
    _check_bytes("msgs", msgs)
    if msgs.device.type == "cpu":
        return sha256_plain(msgs)
    msgs = msgs.contiguous()
    n, length = msgs.shape
    out = torch.empty((n, 32), dtype=torch.uint8, device=msgs.device)
    if n:
        _build.launch("sha256", "sha256", "sha256_batch", msgs, n, length, out)
    return out


def sha256_leaves(ns: torch.Tensor, shares: torch.Tensor) -> torch.Tensor:
    """NMT leaf digests sha256(0x00 || ns || share): ns (N, 29) and shares
    (N, 512) uint8 -> (N, 32), the message assembled inside the kernel."""
    _check_bytes("ns", ns, NAMESPACE_SIZE)
    _check_bytes("shares", shares, SHARE_SIZE)
    if ns.shape[0] != shares.shape[0] or ns.device != shares.device:
        raise ValueError("ns and shares must have the same rows on one device")
    if shares.device.type == "cpu":
        return sha256_leaves_plain(ns, shares)
    ns, shares = ns.contiguous(), shares.contiguous()
    n = shares.shape[0]
    out = torch.empty((n, 32), dtype=torch.uint8, device=shares.device)
    if n:
        _build.launch("sha256_leaf", "sha256", "sha256_leaves", ns, shares, n, out)
    return out


def sha256_bytes(data: bytes, device=None) -> bytes:
    """One message's digest through the batched path on `device` (default
    CUDA; raises without a card): a host convenience for tests and tools,
    not the hot path."""
    from celestia_app_tpu_torch.device import resolve_device

    msg = torch.tensor(np.frombuffer(bytes(data), dtype=np.uint8)).reshape(1, -1)
    return bytes(sha256(msg.to(resolve_device(device))).cpu().numpy()[0])
