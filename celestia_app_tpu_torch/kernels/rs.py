"""Reed-Solomon square extension as GF(2) bit products.

Multiplying by a field constant is GF(2)-linear on a symbol's bits, so the
systematic generator G (gf/rs.py) bit-expands to a 0/1 matrix G_bits and

    parity_bits = (G_bits @ data_bits) mod 2

is one product per axis phase.  `encode_axis` contracts over a chosen axis
of (A, B, S) share bytes, so the column phase of the square extension
consumes the row-extended top half with no transpose and its parity lands
as the bottom rows.  The byte moves are those of
celestia_app_tpu/kernels/rs.py:73-91; the core is the dense kernel
(kernels/rs_dense.py), with $CELESTIA_RS_XOR=on the bitsliced XOR kernel
(kernels/rs_xor.py), or the additive-FFT butterflies (kernels/fft.py)
where `_fft_choice` picks them.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache

import numpy as np
import torch

from celestia_app_tpu_torch.convert import expand_bits_tensor, pack_generator_words
from celestia_app_tpu_torch.device import resolve_device
from celestia_app_tpu_torch.gf.rs import active_construction, codec_for_width
from celestia_app_tpu_torch.kernels.rs_dense import mod2_matmul_planes
from celestia_app_tpu_torch.kernels.rs_xor import mod2_matmul_planes_xor
from celestia_app_tpu_torch.trace.device_ledger import releasable


def use_xor() -> bool:
    """$CELESTIA_RS_XOR: "on" selects the bitsliced XOR encode, anything
    else the dense one (the variable the JAX package reads too)."""
    return os.environ.get("CELESTIA_RS_XOR", "off") == "on"


def _fft_choice(k: int, device: torch.device) -> tuple[bool, bool | None]:
    """(use_fft, force_md) for size k on `device`, the rules of
    celestia_app_tpu/kernels/rs._fft_choice.

    $CELESTIA_RS_FFT: "on" forces the FFT (force_md None: $CELESTIA_RS_FFT_MD
    decides the lowering); "auto" (the default) picks the md FFT only on
    the CPU at k >= 512, where the dense encode's O(k^3) products overwhelm
    a CPU, and the dense encode everywhere else, so the card stays dense;
    anything else is dense.  Every choice gives the same bytes."""
    mode = os.environ.get("CELESTIA_RS_FFT", "auto")
    if mode == "on":
        return True, None
    if mode == "auto" and device.type == "cpu" and k >= 512:
        return True, True
    return False, None


def encode_core(k: int, device: torch.device) -> tuple:
    """The RS core the environment selects for size k on `device`, in the
    JAX precedence fft > xor > dense: ("fft", md), ("xor",) or ("dense",).
    Pipelines cache on it: they fix their core when built."""
    use_fft, force_md = _fft_choice(k, device)
    if use_fft:
        md = os.environ.get("CELESTIA_RS_FFT_MD") == "1" if force_md is None else force_md
        return ("fft", md)
    return ("xor",) if use_xor() else ("dense",)


def _encode_with(core, data: torch.Tensor, G: torch.Tensor, m: int,
                 contract_axis: int) -> torch.Tensor:
    # Every axis but the contracted one and the share bytes is batch: B
    # stacked squares widen the one launch B times.
    bps = m // 8
    x = data.movedim(contract_axis, 0)  # (n, *lines, S)
    n, lines, S = x.shape[0], x.shape[1:-1], x.shape[-1]
    batch = math.prod(lines)
    nsym = S // bps
    planes = x.reshape(n, batch, nsym, bps).movedim(3, 1)  # (n, bps, batch, nsym)
    out = core(G, planes.reshape(n, bps, batch * nsym), m)
    P = out.shape[0]
    by = out.reshape(P, bps, batch, nsym).movedim(1, 3)  # (P, batch, nsym, bps)
    return by.reshape(P, *lines, S).movedim(0, contract_axis)


def encode_axis(data: torch.Tensor, G_bits: torch.Tensor, m: int,
                contract_axis: int = 1) -> torch.Tensor:
    """Systematic encode of (..., S) bytes over `contract_axis` (dense core),
    all other axes but S batched into one launch.

    Returns parity with the contracted axis replaced by P = G rows / m at
    the same position; the other axes are untouched."""
    return _encode_with(mod2_matmul_planes, data, G_bits, m, contract_axis)


def xor_encode_into(acc: torch.Tensor, data: torch.Tensor, G_bits: torch.Tensor,
                    m: int) -> None:
    """acc ^= encode_axis(data, G_bits, m, contract_axis=0), in place.

    The kernel's parity planes XOR straight into a strided view of `acc`
    (contiguous, (P, ..., S)) instead of being regrouped into the byte
    layout first: a panel's column partial at k=4096 is 17.2 GB, and the
    regrouped copy would be another 17.2 GB on the card."""
    bps = m // 8
    n, lines, S = data.shape[0], data.shape[1:-1], data.shape[-1]
    batch, nsym = math.prod(lines), S // bps
    planes = data.reshape(n, batch, nsym, bps).movedim(3, 1).reshape(n, bps, batch * nsym)
    out = mod2_matmul_planes(G_bits, planes, m)  # (P, bps, batch * nsym)
    P = out.shape[0]
    if tuple(acc.shape) != (P, *lines, S):
        raise ValueError(f"accumulator {tuple(acc.shape)} != parity ({P}, *{tuple(lines)}, {S})")
    acc.view(P, batch, nsym, bps).movedim(3, 1).bitwise_xor_(out.view(P, bps, batch, nsym))


def encode_axis_xor(data: torch.Tensor, G_words: torch.Tensor, m: int,
                    contract_axis: int = 1) -> torch.Tensor:
    """encode_axis with the bitsliced XOR core (same byte moves)."""
    return _encode_with(mod2_matmul_planes_xor, data, G_words, m, contract_axis)


def _device_key(device) -> torch.device:
    """`device` with its CUDA index filled in: "cuda" and "cuda:0" name one
    card, and must find one cache entry (a second copy of k=4096's
    generator is another 4.3 GB)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def generator_tensor(k: int, construction: str, device):
    """(m, G_bits) of one codec on `device`, resident for the process: the
    int8 (k*m, k*m) bit-expanded generator the dense kernel reads, at a
    16-byte row stride, bit-expanded there from the (k, k) generator
    (convert.expand_bits_tensor; no host copy of the bits).  The device
    ledger's owner `codec_tensors` (the JAX package bakes its generators
    into each compiled program instead)."""
    return _generator_tensor(k, construction, _device_key(device))


@lru_cache(maxsize=None)
def _generator_tensor(k: int, construction: str, device: torch.device):
    from celestia_app_tpu_torch.trace.device_ledger import note_owned_bytes

    codec = codec_for_width(k, construction)
    G_bits = expand_bits_tensor(codec.field, codec.generator, device)
    note_owned_bytes("codec_tensors", (k, construction, str(device), "G_bits"),
                     int(G_bits.untyped_storage().nbytes()))
    return codec.field.m, G_bits


releasable(_generator_tensor, "codec_tensors")


def generator_words(k: int, construction: str, device):
    """(m, G_words) of one codec on `device`: the XOR core's packed
    generator (convert.pack_generator_words of the host bit expansion, as
    int32), built the first time that core runs at this size."""
    return _generator_words(k, construction, _device_key(device))


@lru_cache(maxsize=None)
def _generator_words(k: int, construction: str, device: torch.device):
    from celestia_app_tpu_torch.trace.device_ledger import note_owned_bytes

    codec = codec_for_width(k, construction)
    words = pack_generator_words(codec.generator_bits())
    G_words = torch.from_numpy(words.view(np.int32)).to(device)
    note_owned_bytes("codec_tensors", (k, construction, str(device), "G_words"),
                     int(G_words.untyped_storage().nbytes()))
    return codec.field.m, G_words


releasable(_generator_words, "codec_tensors")


def encode_fn(k: int, construction: str | None = None, device=None):
    """f(data, contract_axis) -> parity shares for square size k.

    The construction and the core (encode_core) are resolved when f is
    built; the generator is carried to `device` once per (k, construction)."""
    dev = resolve_device(device)
    construction = construction or active_construction()
    core = encode_core(k, dev)
    if core[0] == "fft":
        from celestia_app_tpu_torch.kernels.fft import encode_axis_fft

        md = core[1]

        def encode(data: torch.Tensor, contract_axis: int = 1) -> torch.Tensor:
            return encode_axis_fft(data, k, construction, contract_axis, md=md)

        return encode
    if core[0] == "xor":
        m, G_words = generator_words(k, construction, dev)

        def encode(data: torch.Tensor, contract_axis: int = 1) -> torch.Tensor:
            return encode_axis_xor(data, G_words, m, contract_axis)
    else:
        m, G_bits = generator_tensor(k, construction, dev)

        def encode(data: torch.Tensor, contract_axis: int = 1) -> torch.Tensor:
            return encode_axis(data, G_bits, m, contract_axis)

    return encode


def extend_square_fn(k: int, construction: str | None = None, device=None):
    """eds = f(ods): (..., k, k, S) uint8 -> (..., 2k, 2k, S) with quadrants
    [[Q0, Q1], [Q2, Q3]] (row parity right, column parity below); leading
    axes are a batch of squares, each phase one launch for all of them."""
    encode = encode_fn(k, construction, device)

    def extend(ods: torch.Tensor) -> torch.Tensor:
        top = torch.cat([ods, encode(ods, -2)], dim=-2)  # (..., k, 2k, S)
        # Row and column encodes commute: the column phase contracts over
        # the row axis of the top half and yields Q2 and Q3 directly.
        return torch.cat([top, encode(top, -3)], dim=-3)

    return extend


def extend_square(ods, device=None):
    """Host convenience: a (k, k, S) uint8 ODS (numpy) -> its (2k, 2k, S)
    EDS as numpy, extended on `device` (default CUDA; raises without a
    card)."""
    import numpy as np

    from celestia_app_tpu_torch.device import upload

    k = ods.shape[0]
    if ods.shape[1] != k:
        raise ValueError(f"ODS must be square, got {tuple(ods.shape)}")
    dev = resolve_device(device)
    x, _ = upload(np.ascontiguousarray(ods, dtype=np.uint8), dev)
    return extend_square_fn(k, device=dev)(x).cpu().numpy()


def decode_axis_fn(k: int, construction: str | None = None):
    """Erasure decode along an axis as a constant product.

    Returns f(known, R_bits): known (R, k, S) holds each line's k known
    shares (already gathered), R_bits is a bit-expanded recover matrix
    (rows*m, k*m) from RSCodec.recover_matrix on the same device, carried
    there by convert.expand_bits_tensor; the result is (R, rows, S).  With the
    full (2k*m, k*m) matrix it is the whole codeword."""
    m = codec_for_width(k, construction).field.m

    def decode(known: torch.Tensor, R_bits: torch.Tensor) -> torch.Tensor:
        return encode_axis(known, R_bits, m, contract_axis=1)

    return decode
