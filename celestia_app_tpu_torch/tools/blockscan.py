"""blockscan: decode and summarize blocks (reference tools/blockscan).

Walks produced blocks, classifying every tx (normal / BlobTx), decoding
messages, and reporting square stats — the debugging lens the reference
points at a live RPC (tools/blockscan/main.go:19), here pointed at an
in-process node or a list of BlockData.

The port's copy of celestia_app_tpu/tools/blockscan.py.
"""

from __future__ import annotations

from celestia_app_tpu_torch.tx.envelopes import unmarshal_blob_tx
from celestia_app_tpu_torch.tx.sign import Tx


def scan_block(data) -> dict:
    """Summarize one BlockData."""
    txs = []
    n_blobs = 0
    blob_bytes = 0
    for raw in data.txs:
        btx = unmarshal_blob_tx(raw)
        if btx is not None:
            n_blobs += len(btx.blobs)
            blob_bytes += sum(len(b.data) for b in btx.blobs)
            kind = "blob"
            inner = btx.tx
        else:
            kind = "normal"
            inner = raw
        try:
            msgs = [type(m).__name__ for m in Tx.unmarshal(inner).msgs()]
        except ValueError:
            msgs = ["<undecodable>"]
        txs.append({"kind": kind, "msgs": msgs, "bytes": len(raw)})
    return {
        "square_size": data.square_size,
        "data_root": data.hash.hex(),
        "n_txs": len(data.txs),
        "n_blobs": n_blobs,
        "blob_bytes": blob_bytes,
        "txs": txs,
    }


def scan(blocks) -> list[dict]:
    return [scan_block(b) for b in blocks]
