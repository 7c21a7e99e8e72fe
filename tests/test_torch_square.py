"""The port's block format and `extend_block` on the CPU, byte-identical to
the JAX package: the copies of encoding/proto, shares, tx/envelopes and
square (construct and build: share bytes, kept txs, placements) on random
blocks, and the DAH of `extend_block` under each pipeline mode.
"""

from __future__ import annotations

import gc
from dataclasses import astuple

import jax
import numpy as np
import pytest

from celestia_app_tpu.app.extend_block import extend_block as jax_extend_block
from celestia_app_tpu.shares.namespace import Namespace as JaxNamespace
from celestia_app_tpu.shares.sparse import Blob as JaxBlob
from celestia_app_tpu.shares.sparse import split_blob as jax_split_blob
from celestia_app_tpu.square import builder as jax_square
from celestia_app_tpu.tx import envelopes as jax_env
from celestia_app_tpu_torch.app import extend_block, is_empty_block
from celestia_app_tpu_torch.constants import (
    CONTINUATION_SPARSE_SHARE_CONTENT_SIZE,
    FIRST_SPARSE_SHARE_CONTENT_SIZE,
    SUBTREE_ROOT_THRESHOLD,
)
from celestia_app_tpu_torch.da import extend_shares
from celestia_app_tpu_torch.encoding import proto
from celestia_app_tpu_torch.shares import Blob, Namespace, parse_compact_shares, split_blob
from celestia_app_tpu_torch.square import SquareOverflow, build, construct
from celestia_app_tpu_torch.tx import envelopes as env


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran, when it ends:
    each loaded XLA:CPU executable holds hundreds to thousands of memory
    mappings, and a test worker that keeps every module's programs can
    reach the kernel's per-process map limit, where the next compile
    aborts."""
    yield
    jax.clear_caches()
    gc.collect()



def _blob_size(rng, shares: int) -> int:
    """A payload that needs exactly `shares` sparse shares."""
    if shares == 1:
        return int(rng.integers(1, FIRST_SPARSE_SHARE_CONTENT_SIZE + 1))
    lo = FIRST_SPARSE_SHARE_CONTENT_SIZE + (shares - 2) * CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
    return int(rng.integers(lo + 1, lo + CONTINUATION_SPARSE_SHARE_CONTENT_SIZE + 1))


def random_block(seed: int, n_txs: int, n_blob_txs: int, max_blob_shares: int,
                 n_namespaces: int) -> list[bytes]:
    """Normal txs, then BlobTxs of one to three blobs each, under a few v0
    namespaces, with blob sizes spread from one share to `max_blob_shares`;
    marshalled by the JAX package's envelopes."""
    rng = np.random.default_rng(seed)
    namespaces = [JaxNamespace.v0(rng.bytes(10)) for _ in range(n_namespaces)]
    txs = [rng.bytes(int(rng.integers(20, 700))) for _ in range(n_txs)]
    for _ in range(n_blob_txs):
        blobs = tuple(
            JaxBlob(namespaces[int(rng.integers(n_namespaces))],
                    rng.bytes(_blob_size(rng, int(rng.integers(1, max_blob_shares + 1)))))
            for _ in range(int(rng.integers(1, 4)))
        )
        txs.append(jax_env.BlobTx(rng.bytes(int(rng.integers(40, 300))), blobs).marshal())
    return txs


BLOCKS = {
    "normal-only": (1, 12, 0, 1, 1),
    "one-blob": (2, 0, 1, 1, 1),
    "mixed": (3, 30, 12, 6, 4),
    "many-namespaces": (4, 5, 40, 3, 16),
    "big-blobs": (5, 8, 6, 40, 3),
}


def _same_square(sq, want) -> None:
    assert sq.size == want.size
    assert sq.share_bytes() == want.share_bytes()
    assert [astuple(p) for p in sq.placements] == [astuple(p) for p in want.placements]
    assert sq.wrapped_pfb_txs() == want.wrapped_pfb_txs()
    assert (sq.tx_share_range, sq.pfb_share_range) == (want.tx_share_range, want.pfb_share_range)
    assert astuple(sq.accounting) == astuple(want.accounting)


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_construct_and_build_equal_jax(block):
    txs = random_block(*BLOCKS[block])
    _same_square(construct(txs, 128), jax_square.construct(txs, 128))
    for cap in (128, 8):  # at 8 the builder drops what does not fit
        sq, kept = build(txs, cap)
        want_sq, want_kept = jax_square.build(txs, cap)
        _same_square(sq, want_sq)
        assert kept == want_kept
    for i in range(min(len(txs), 4)):
        assert construct(txs, 128).find_tx_share_range(i) == \
            jax_square.construct(txs, 128).find_tx_share_range(i)


def test_overflow_raises_like_jax():
    txs = random_block(6, 4, 20, 30, 3)
    for builder in (construct, jax_square.construct):
        with pytest.raises(ValueError, match="overflow"):
            builder(txs, 4)
    with pytest.raises(SquareOverflow):
        construct(txs, 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_envelopes_round_trip_and_equal_jax(seed):
    rng = np.random.default_rng(seed)
    sub = rng.bytes(10)
    data = [rng.bytes(_blob_size(rng, s)) for s in (1, 2, 5)]
    tx = rng.bytes(120)
    blobs = tuple(Blob(Namespace.v0(sub), d) for d in data)
    jax_blobs = tuple(JaxBlob(JaxNamespace.v0(sub), d) for d in data)
    raw = env.BlobTx(tx, blobs).marshal()
    assert raw == jax_env.BlobTx(tx, jax_blobs).marshal()
    assert env.unmarshal_blob_tx(raw) == env.BlobTx(tx, blobs)
    assert env.unmarshal_blob_tx(b"\x0a\x02hi") is None  # no BLOB type id
    assert env.tx_hash(raw) == jax_env.tx_hash(raw)
    for b, jb in zip(blobs, jax_blobs):
        assert env.marshal_blob(b) == jax_env.marshal_blob(jb)
        assert env.unmarshal_blob(env.marshal_blob(b)) == b
        assert [s.raw for s in split_blob(b)] == [s.raw for s in jax_split_blob(jb)]
    indexes = tuple(int(v) for v in rng.integers(0, 2**20, 3))
    wrapped = env.IndexWrapper(tx, indexes).marshal()
    assert wrapped == jax_env.IndexWrapper(tx, indexes).marshal()
    assert env.unmarshal_index_wrapper(wrapped) == env.IndexWrapper(tx, indexes)
    assert env.unmarshal_index_wrapper(env.BlobTx(tx, ()).marshal()) is None
    assert proto.encode_uvarint(300) == b"\xac\x02" and proto.read_uvarint(b"\xac\x02", 0)[0] == 300


def test_compact_shares_parse_back():
    txs = random_block(7, 25, 0, 1, 1)
    sq = construct(txs, 128)
    lo, hi = sq.tx_share_range
    assert parse_compact_shares(sq.shares[lo:hi]) == txs
    assert SUBTREE_ROOT_THRESHOLD == jax_square.SUBTREE_ROOT_THRESHOLD


# Blocks whose squares are k = 1, 2, 4, 8 and 16, each under one value of
# $CELESTIA_PIPE_FUSED for the JAX package; the port runs all three modes.
EXTEND_BLOCKS = [
    ((11, 1, 0, 1, 1), None),
    ((12, 2, 0, 1, 1), "off"),
    ((12, 2, 1, 1, 1), "epi"),
    ((13, 10, 4, 2, 2), None),
    ((14, 20, 10, 4, 3), "epi"),
    ((15, 30, 12, 6, 4), "off"),
]


@pytest.mark.parametrize("spec,jax_mode", EXTEND_BLOCKS)
def test_extend_block_equals_jax(spec, jax_mode, monkeypatch):
    monkeypatch.delenv("CELESTIA_RS_XOR", raising=False)
    txs = random_block(*spec)
    k = construct(txs, 128).size
    assert k <= 16
    if jax_mode is None:
        monkeypatch.delenv("CELESTIA_PIPE_FUSED", raising=False)
    else:
        monkeypatch.setenv("CELESTIA_PIPE_FUSED", jax_mode)
    want = jax_extend_block(txs)
    for mode in ("on", "off", "epi"):
        monkeypatch.setenv("CELESTIA_PIPE_FUSED", mode)
        eds = extend_block(txs, device="cpu")
        assert eds.k == k
        assert eds.row_roots() == want.row_roots()
        assert eds.col_roots() == want.col_roots()
        assert eds.data_root() == want.data_root()
    direct = extend_shares(construct(txs, 128).share_bytes(), device="cpu")
    assert direct.data_root() == want.data_root()


def test_extend_block_of_an_empty_block_is_none():
    assert is_empty_block([]) and not is_empty_block([b"x"])
    assert extend_block([], device="cpu") is None
    assert extend_block([]) is None  # no square, so no device is asked for
    assert jax_extend_block([]) is None
