"""The port's throughput harness (testutil/benchmark.py), held against the
JAX package's: `run_throughput` at the same seed on a port TestNode
(device="cpu") and a JAX TestNode, both at gov max square 4, gives the same
per-block fills and block bytes, the same proposals (txs, square size and
data root, recorded from each App's `prepare_proposal`), the same app
hashes and the same `throughput` trace rows, seconds aside.  The reference's
criterion `sustained(0.9)` is judged the same way in both.
"""

from __future__ import annotations

import gc

import jax
import pytest

from celestia_app_tpu.testutil import TestNode as JaxTestNode
from celestia_app_tpu.testutil import deterministic_genesis as jax_genesis
from celestia_app_tpu.testutil import funded_keys as jax_keys
from celestia_app_tpu.testutil import benchmark as jax_benchmark
from celestia_app_tpu.trace import traced as jax_traced
from celestia_app_tpu_torch.app import extend_block
from celestia_app_tpu_torch.da import DataAvailabilityHeader
from celestia_app_tpu_torch.testutil import TestNode, benchmark, deterministic_genesis, funded_keys
from celestia_app_tpu_torch.trace import traced

GOV = 4
RUN = {"blocks": 3, "blob_size": 1_500, "target_fill": 0.5, "seed": 11}


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran, when it ends
    (each loaded XLA:CPU executable holds many memory mappings)."""
    yield
    jax.clear_caches()
    gc.collect()


def recorded(node) -> list:
    """Wrap the node's App's prepare_proposal on the instance; returns the
    list each proposal's (txs, square size, data root) is appended to."""
    proposals = []
    prepare = node.app.prepare_proposal

    def recording(txs):
        data = prepare(txs)
        proposals.append((data.txs, data.square_size, data.hash))
        return data

    node.app.prepare_proposal = recording
    return proposals


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, node, harness, tracer in (
        ("jax", JaxTestNode(jax_genesis(jax_keys(2), gov_max_square_size=GOV), jax_keys(2)),
         jax_benchmark, jax_traced()),
        ("port", TestNode(deterministic_genesis(funded_keys(2), gov_max_square_size=GOV),
                          funded_keys(2), device="cpu"), benchmark, traced()),
    ):
        proposals = recorded(node)
        before = len(tracer.table("throughput"))
        result = harness.run_throughput(node, **RUN)
        rows = [{k: v for k, v in row.items() if k in ("height", "block_bytes", "fill")}
                for row in tracer.table("throughput")[before:]]
        hashes = [node.app.cms.app_hash_at(h) for h in range(1, node.app.height + 1)]
        out[name] = (result, proposals, rows, hashes)
    return out


def test_fills_and_block_bytes_equal_jax(runs):
    (result, _, rows, _), (want, _, want_rows, _) = runs["port"], runs["jax"]
    assert result.blocks == want.blocks == RUN["blocks"]
    assert result.fills == want.fills
    assert result.mean_fill == want.mean_fill and result.mean_block_bytes == want.mean_block_bytes
    assert rows == want_rows and len(rows) == RUN["blocks"]
    assert result.mean_block_bytes <= benchmark.max_block_bytes(GOV)
    assert benchmark.max_block_bytes(GOV) == jax_benchmark.max_block_bytes(GOV)
    for ratio in (0.5, 0.8, 0.9):
        assert result.sustained(ratio) == want.sustained(ratio)
        assert result.passing_blocks(ratio) == want.passing_blocks(ratio)
    assert result.sustained(0.5)


def test_proposals_and_app_hashes_equal_jax(runs):
    (_, proposals, _, hashes), (_, want, _, want_hashes) = runs["port"], runs["jax"]
    assert proposals == want and len(proposals) == RUN["blocks"]
    assert hashes == want_hashes
    assert {size for _, size, _ in proposals} == {GOV}


def test_data_roots_equal_extend_block(runs):
    """Each proposal's data root is extend_block's over the same txs."""
    for txs, size, root in runs["port"][1]:
        eds = extend_block(list(txs), gov_max_square_size=GOV, device="cpu")
        assert DataAvailabilityHeader.from_eds(eds).hash() == root and eds.k == size
