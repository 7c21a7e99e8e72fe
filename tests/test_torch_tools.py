"""The port's tools (tools/blockscan.py, tools/blocktime.py), held against
the JAX package's on the same inputs: the blocks of a port TestNode
(device="cpu") with sends, PFBs of one and two blobs, an undecodable tx
and an empty block, scanned by both packages' `scan_block` / `scan`; and
block-time windows (none, one, even, ragged) through both
`interval_stats`.
"""

from __future__ import annotations

import numpy as np
import pytest

from celestia_app_tpu.tools import blockscan as jax_blockscan
from celestia_app_tpu.tools import blocktime as jax_blocktime
from celestia_app_tpu_torch.app import BlockData
from celestia_app_tpu_torch.testutil import TestNode, deterministic_genesis, funded_keys
from celestia_app_tpu_torch.testutil.blocks import block_txs
from celestia_app_tpu_torch.tools import blockscan, blocktime


@pytest.fixture(scope="module")
def blocks():
    keys = funded_keys(3)
    node = TestNode(deterministic_genesis(keys), keys, device="cpu")
    for raw in block_txs(keys, node.chain_id, seed=5, sends=3, pfbs=4, blob_shares=(1, 4)):
        assert node.broadcast(raw).code == 0
    node.produce_block()
    node.produce_block()  # empty
    data = node.blocks[0]
    garbage = BlockData(data.txs[:2] + (b"\x0a\x03bad",), data.square_size, data.hash)
    return node, [*node.blocks, garbage]


def test_scan_block_equal_jax(blocks):
    _, scanned = blocks
    for data in scanned:
        assert blockscan.scan_block(data) == jax_blockscan.scan_block(data)
    assert blockscan.scan(scanned) == jax_blockscan.scan(scanned)
    first = blockscan.scan_block(scanned[0])
    assert {t["kind"] for t in first["txs"]} == {"normal", "blob"}
    assert first["n_blobs"] == 4 and first["blob_bytes"] > 0
    assert blockscan.scan_block(scanned[1])["n_txs"] == 0
    assert blockscan.scan_block(scanned[2])["txs"][-1]["msgs"] == ["<undecodable>"]


@pytest.mark.parametrize("window", ["node", "none", "one", "even", "ragged"])
def test_interval_stats_equal_jax(blocks, window):
    node, _ = blocks
    t0 = 1_700_000_000 * 10**9
    rng = np.random.default_rng(3)
    times = {
        "node": [node.block_times[h] for h in sorted(node.block_times)],
        "none": [],
        "one": [t0],
        "even": [t0 + 15 * 10**9 * i for i in range(21)],
        "ragged": sorted(int(v) for v in t0 + rng.integers(0, 10**12, 40)),
    }[window]
    got = blocktime.interval_stats(times)
    assert got == jax_blocktime.interval_stats(times)
    assert got["blocks"] == len(times)
    if window == "even":
        assert got["mean_s"] == got["p95_s"] == 15.0
