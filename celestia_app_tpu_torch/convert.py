"""What the port carries over from elsewhere: the codec's constant
generator onto a device, and a chain's state into an App.

The block-square path has no trained state: its only constant is the RS
generator (and repair's recover matrices), bit-expanded as
gf/field.expand_bit_matrix does it (symbol-major rows and columns, bit t of
byte b of a symbol LSB-first).  `expand_bits_tensor` builds that 0/1 matrix
on the device in the dense kernel's padded layout; `pack_generator_words`
packs the host expansion into the XOR kernel's words.

The App's state is plain bytes: `app_from_export` starts a port App from the
(key, value) pairs a committed store exports (the JAX package's
`CommitStore.export()`), plus the x/mint state and the options the App holds
outside its store, so both packages can go on from one state.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_generator_words(G_bits: np.ndarray) -> np.ndarray:
    """(P*m, n*m) 0/1 generator -> (NW, P*m) uint32, contraction packed.

    Word w of output row i holds contraction bits [32w, 32w+32) of G's row
    i, LSB first, and the contraction axis is zero-padded to a multiple of
    32 (an AND with a 0 bit adds nothing to a parity).  Transposed so that
    one word index is one contiguous row.  The same packing as
    celestia_app_tpu/kernels/rs_xor.pack_generator_words.
    """
    Pm, nm = G_bits.shape
    nw = -(-nm // 32)
    # Bits LSB first into bytes, four bytes little-endian into a word.
    packed = np.zeros((Pm, 4 * nw), dtype=np.uint8)
    packed[:, : -(-nm // 8)] = np.packbits(np.asarray(G_bits, dtype=np.uint8), axis=1,
                                            bitorder="little")
    words = packed.view("<u4")  # (Pm, NW)
    return np.ascontiguousarray(words.T).astype(np.uint32)  # (NW, Pm)


def expand_bits_tensor(field, A: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """field.expand_bit_matrix(A) as int8 on `device`, built there from the
    (n, k) GF matrix A: a view of a buffer whose rows are k*m rounded up to
    16 bytes (zero-filled), the row stride the dense kernel's TMA loads
    need (at k=1, k*m is 8), paid once when the matrix is cached.  No host
    bit array (4.29 GB at k=4096, 256 strided numpy passes) is made.

    Column b of block (i, j) is bits(A[i, j] * x^b); the products by x^b
    come from A by b shift-and-reduce steps (multiplication by x in the
    field's polynomial basis), all on the device."""
    A = np.asarray(A)
    m = field.m
    if A.ndim != 2:
        raise ValueError(f"a GF matrix is 2-D, not of shape {A.shape}")
    if A.size and (A.min() < 0 or A.max() >= 1 << m):
        raise ValueError(f"entries of a GF(2^{m}) matrix lie in [0, {1 << m})")
    n, k = A.shape
    cols = k * m
    buf = torch.zeros((n * m, -(-cols // 16) * 16), dtype=torch.int8, device=device)
    out = buf[:, :cols]
    blocks = out.view(n, m, k, m)  # [i, r, j, b]: bit r of A[i, j] * x^b
    shifts = torch.arange(m, dtype=torch.int32, device=device)[None, :, None]
    prod = torch.from_numpy(A.astype(np.int32)).to(device)
    for b in range(m):
        blocks[:, :, :, b] = ((prod[:, None, :] >> shifts) & 1).to(torch.int8)
        prod = (prod << 1) ^ torch.where((prod >> (m - 1)) & 1 == 1, field.poly, 0)
    return out


def app_from_export(items, *, chain_id: str, app_version: int, height: int,
                    genesis_time_ns: int, last_block_time_ns: int, minter=None,
                    v2_upgrade_height: int | None = None, ibc_token_filter: bool = True,
                    device=None):
    """A port App (app/app.App on `device`, default CUDA) whose working store
    holds the (key, value) byte pairs `items` (a dict or an iterable of
    pairs), committed at `height`, with the chain's coordinates set as the
    exporting app had them; its next block is height + 1.

    The x/mint state lives on the App, not in the store, so it comes apart:
    `minter` is a dict of the exporting App's `minter.inflation_rate` and
    `minter.annual_provisions` (each as its Dec's `raw` integer, 1e18-scaled)
    and `minter.previous_block_time_ns` (None before the first block).
    Without it the App starts from Minter.default(), as a fresh chain does,
    and its first block mints another provision than the exporter's would.
    `v2_upgrade_height` and `ibc_token_filter` are the App options of the
    same names."""
    from celestia_app_tpu_torch.app import App
    from celestia_app_tpu_torch.modules.mint.minter import Minter
    from celestia_app_tpu_torch.state.dec import Dec
    from celestia_app_tpu_torch.state.store import KVStore

    app = App(v2_upgrade_height=v2_upgrade_height, ibc_token_filter=ibc_token_filter,
              device=device)
    pairs = items.items() if isinstance(items, dict) else items
    app.cms.working = KVStore({bytes(k): bytes(v) for k, v in pairs})
    app.cms.commit(height)
    app.chain_id = chain_id
    app.app_version = app_version
    app.height = height
    app.genesis_time_ns = genesis_time_ns
    app.last_block_time_ns = last_block_time_ns
    if minter is not None:
        app.minter = Minter(
            Dec(int(minter["inflation_rate"])),
            Dec(int(minter["annual_provisions"])),
            previous_block_time_ns=minter["previous_block_time_ns"],
        )
    return app
