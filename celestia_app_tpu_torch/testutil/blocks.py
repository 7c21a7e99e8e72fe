"""Deterministic blocks of signed txs for a chain from `deterministic_genesis`.

`block_txs` signs MsgSends and PayForBlobs BlobTxs with the genesis keys,
so that a fresh App admits every one of them in order: the signers take
turns, each account's sequence counts up from 0 (sends first, then blob
txs, the order FilterTxs executes them in), and every fee covers the gas at
the node's default minimum price.  Blob payloads and sizes come from
`np.random.default_rng(seed)`; the signatures are RFC 6979, so the same
arguments give the same bytes on every machine.  A chain's later heights
pass `sequences=next_sequences(app, keys)`, each account's next sequence in
the App's committed state.
"""

from __future__ import annotations

import numpy as np

from celestia_app_tpu_torch.constants import (
    CONTINUATION_SPARSE_SHARE_CONTENT_SIZE,
    FIRST_SPARSE_SHARE_CONTENT_SIZE,
)
from celestia_app_tpu_torch.crypto import PrivateKey
from celestia_app_tpu_torch.modules.blob.types import estimate_gas, new_msg_pay_for_blobs
from celestia_app_tpu_torch.shares import Blob, Namespace
from celestia_app_tpu_torch.state.accounts import AuthKeeper
from celestia_app_tpu_torch.tx.envelopes import BlobTx
from celestia_app_tpu_torch.tx.messages import Coin, MsgSend
from celestia_app_tpu_torch.tx.sign import Fee, build_and_sign

SEND_GAS = 100_000
SEND_FEE = 20_000  # utia: 0.2 utia per gas, above the 0.002 node minimum


def blob_size(shares: int, rng: np.random.Generator) -> int:
    """A blob length in bytes that takes exactly `shares` sparse shares."""
    if shares == 1:
        return int(rng.integers(1, FIRST_SPARSE_SHARE_CONTENT_SIZE + 1))
    return (FIRST_SPARSE_SHARE_CONTENT_SIZE
            + (shares - 2) * CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
            + int(rng.integers(1, CONTINUATION_SPARSE_SHARE_CONTENT_SIZE + 1)))


NAMESPACES = 8


def block_txs(keys: list[PrivateKey], chain_id: str, *, seed: int, sends: int,
              pfbs: int, blob_shares: tuple[int, int] = (1, 8),
              sequences: list[int] | None = None) -> list[bytes]:
    """`sends` MsgSends (5 utia each to the next key), then `pfbs` BlobTxs of
    one blob each, of a share count drawn from `blob_shares` (inclusive),
    under one of NAMESPACES v0 namespaces.  `keys` are the genesis accounts
    in order, so key i has account number i; `sequences` gives each
    account's next sequence (default all 0, a fresh chain)."""
    rng = np.random.default_rng(seed)
    spaces = [Namespace.v0(bytes([1 + i]) + rng.bytes(9)) for i in range(NAMESPACES)]
    sequence = list(sequences) if sequences is not None else [0] * len(keys)
    addresses = [k.public_key().address() for k in keys]
    txs = []

    def signer(i: int) -> int:
        n = i % len(keys)
        sequence[n] += 1
        return n

    for i in range(sends):
        n = signer(i)
        msg = MsgSend(addresses[n], addresses[(n + 1) % len(keys)], (Coin("utia", 5),))
        txs.append(build_and_sign([msg], keys[n], chain_id, n, sequence[n] - 1,
                                  Fee((Coin("utia", SEND_FEE),), SEND_GAS)))
    for i in range(sends, sends + pfbs):
        n = signer(i)
        size = blob_size(int(rng.integers(blob_shares[0], blob_shares[1] + 1)), rng)
        blob = Blob(spaces[int(rng.integers(NAMESPACES))], rng.bytes(size))
        msg = new_msg_pay_for_blobs(addresses[n], [blob])
        gas = estimate_gas([len(blob.data)])
        raw = build_and_sign([msg], keys[n], chain_id, n, sequence[n] - 1,
                             Fee((Coin("utia", gas),), gas))
        txs.append(BlobTx(raw, (blob,)).marshal())
    return txs


def next_sequences(app, keys: list[PrivateKey]) -> list[int]:
    """Each key's next sequence in `app`'s committed state (0 for an address
    the chain holds no account for): block_txs' `sequences` for the chain's
    next height."""
    auth = AuthKeeper(app.cms.working)
    accounts = [auth.get_account(k.public_key().address()) for k in keys]
    return [a.sequence if a is not None else 0 for a in accounts]
