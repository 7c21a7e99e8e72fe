"""What the port carries over from elsewhere: the codec's constant
generator onto a device, and a chain's state into an App.

The block-square path has no trained state: its only constant is the RS
generator, bit-expanded by gf/field.expand_bit_matrix (symbol-major rows and
columns, bit t of byte b of a symbol LSB-first).  `codec_tensors` turns that
(P*m, n*m) 0/1 matrix into the two forms the RS kernels read.

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


def codec_tensors(
    generator_bits: np.ndarray, m: int, device: str | torch.device
) -> dict[str, torch.Tensor]:
    """{"G_bits": int8 (P*m, n*m), "G_words": int32 (NW, P*m)} on `device`.

    G_bits is a view of a buffer whose rows are n*m rounded up to 16 bytes,
    zero-filled past n*m: the dense kernel's TMA loads need a row stride
    that is a multiple of 16 (at k=1, n*m is 8), and padding here, once per
    codec, keeps the per-call path free of copies.

    G_words holds the uint32 words of pack_generator_words bit for bit
    (int32 because torch has no uint32 arithmetic on every device; the
    kernels read the bits, never the sign).
    """
    G = np.asarray(generator_bits)
    if G.ndim != 2 or G.shape[0] % m or G.shape[1] % m or m % 8:
        raise ValueError(f"generator of shape {G.shape} is not bit-expanded for m={m}")
    if G.size and G.max() > 1:
        raise ValueError("generator_bits must hold only 0 and 1")
    words = pack_generator_words(G.astype(np.uint8))
    return {
        "G_bits": bits_tensor(G, device),
        "G_words": torch.from_numpy(words.view(np.int32)).to(device),
    }


def bits_tensor(bits: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """A (rows, cols) 0/1 matrix as int8 on `device`, a view of a buffer whose
    rows are cols rounded up to 16 bytes (zero-filled): the row stride the
    dense kernel's TMA loads need, paid once when the matrix is cached."""
    rows, cols = bits.shape
    padded = np.zeros((rows, -(-cols // 16) * 16), dtype=np.int8)
    padded[:, :cols] = bits
    return torch.from_numpy(padded).to(device)[:, :cols]


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
