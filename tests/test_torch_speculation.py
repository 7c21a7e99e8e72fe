"""Speculative extend in the port ($CELESTIA_PIPE_SPECULATE): a claim hits
only on exactly the speculated bytes and construction, anything else
discards, and the claimed square is byte-identical to a computed one and to
the JAX package's (tests/test_continuous_batching.py, TestSpeculativeExtend,
is the JAX twin).  On the CPU, with device="cpu".
"""

from __future__ import annotations

import gc

import jax
import numpy as np
import pytest
import torch

from celestia_app_tpu.da.eds import ExtendedDataSquare as JaxEDS
from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, SHARE_SIZE
from celestia_app_tpu_torch.da import DataAvailabilityHeader
from celestia_app_tpu_torch.da.eds import (
    ExtendedDataSquare,
    SpeculativeExtender,
    speculation_enabled,
    speculator,
)
from celestia_app_tpu_torch.trace import journal


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


K2_HASH = "b56e4d251ac266f4b91cc5464b3fc7efcbdc888064647496d13133f0dc65ac25"


def random_ods(k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, (k * k, SHARE_SIZE), dtype=np.uint8)
    ods[:, :NAMESPACE_SIZE] = 0
    ods[:, NAMESPACE_SIZE - 1] = np.sort(rng.integers(0, 128, k * k)).astype(np.uint8)
    return ods.reshape(k, k, SHARE_SIZE)


@pytest.fixture
def armed(monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_SPECULATE", "on")
    speculator().discard()  # isolate from any earlier test's entry
    yield speculator()
    speculator().discard()


def _assert_same(got: ExtendedDataSquare, want) -> None:
    assert got.data_root() == want.data_root()
    assert got.row_roots() == want.row_roots()
    assert got.col_roots() == want.col_roots()
    assert np.array_equal(got.squared(), np.asarray(want.squared()))


def test_disabled_by_default(monkeypatch):
    monkeypatch.delenv("CELESTIA_PIPE_SPECULATE", raising=False)
    assert not speculation_enabled()
    sp = SpeculativeExtender()
    assert not sp.speculate(random_ods(2, 1), device="cpu")
    assert not sp.pending()
    for raw, on in (("on", True), ("1", True), ("TRUE", True), ("off", False), ("yes", False)):
        monkeypatch.setenv("CELESTIA_PIPE_SPECULATE", raw)
        assert speculation_enabled() is on, raw


@pytest.mark.parametrize("k,construction", [(2, "vandermonde"), (2, "leopard"),
                                            (8, "vandermonde")])
def test_hit_returns_identical_square(k, construction, monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_SPECULATE", "on")
    sp = SpeculativeExtender()
    ods = random_ods(k, seed=500 + k)
    ref = ExtendedDataSquare.compute(ods.copy(), construction, device="cpu")
    assert sp.speculate(ods, height=9, round_=0, construction=construction, device="cpu")
    assert sp.pending()
    claimed = sp.claim(ods, construction, device="cpu")
    assert claimed is not None
    eds, mode = claimed
    assert mode == "fused"
    _assert_same(eds, ref)
    _assert_same(eds, JaxEDS.compute(ods, construction))
    assert not sp.pending()
    assert sp.outcomes == {"hit": 1, "discard": 0}


def test_compute_claims_the_speculation(armed):
    """The golden k=2 square through a claim inside compute()."""
    k = 2
    share = bytes([0x00]) + bytes(18) + bytes([0x01]) * 10
    share += b"\xff" * (SHARE_SIZE - NAMESPACE_SIZE)
    ods = np.frombuffer(share * (k * k), dtype=np.uint8).reshape(k, k, SHARE_SIZE)
    hits = armed.outcomes["hit"]
    assert armed.speculate(ods.copy(), height=1, round_=0, device="cpu")
    eds = ExtendedDataSquare.compute(ods, device="cpu")
    assert armed.outcomes["hit"] == hits + 1
    assert DataAvailabilityHeader.from_eds(eds).hash().hex() == K2_HASH


def test_round_change_discards_and_recompute_is_identical(armed):
    a, b = random_ods(2, seed=21), random_ods(2, seed=22)
    discards = armed.outcomes["discard"]
    assert armed.speculate(a, height=3, round_=0, device="cpu")
    got = ExtendedDataSquare.compute(torch.from_numpy(b.copy()), device="cpu")  # b adopted
    _assert_same(got, JaxEDS.compute(b))
    assert not armed.pending()
    assert armed.outcomes["discard"] == discards + 1


def test_construction_mismatch_discards(monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_SPECULATE", "on")
    sp = SpeculativeExtender()
    ods = random_ods(2, seed=31)
    assert sp.speculate(ods, construction="vandermonde", device="cpu")
    assert sp.claim(ods, construction="leopard", device="cpu") is None
    assert not sp.pending()
    got = ExtendedDataSquare.compute(ods, "leopard", device="cpu")
    _assert_same(got, JaxEDS.compute(ods, "leopard"))


def test_explicit_discard_counts(monkeypatch):
    monkeypatch.setenv("CELESTIA_PIPE_SPECULATE", "on")
    sp = SpeculativeExtender()
    assert sp.speculate(random_ods(2, seed=51), device="cpu")
    assert sp.discard()
    assert not sp.discard()  # idempotent: nothing left to drop
    assert sp.speculate(random_ods(2, seed=52), device="cpu")
    assert sp.speculate(random_ods(2, seed=53), device="cpu")  # replaces the pending one
    assert sp.outcomes == {"hit": 0, "discard": 2}


def test_compute_journals_speculation_outcome(armed):
    ods = random_ods(2, seed=41)
    armed.speculate(ods, height=1, round_=0, device="cpu")
    before = len(journal.rows("compute"))
    ExtendedDataSquare.compute(ods, device="cpu")
    rows = journal.rows("compute")[before:]
    assert [r.get("speculation") for r in rows] == ["hit"]
    armed.speculate(ods, height=2, round_=0, device="cpu")
    before = len(journal.rows("compute"))
    ExtendedDataSquare.compute(random_ods(2, seed=42), device="cpu")
    rows = journal.rows("compute")[before:]
    assert [r.get("speculation") for r in rows] == ["discard"]
    assert rows[0]["mode"] == "fused" and rows[0]["upload_ms"] >= 0.0
    before = len(journal.rows("compute"))
    ExtendedDataSquare.compute(ods, device="cpu")  # nothing pending: no field
    assert "speculation" not in journal.rows("compute")[before]


def test_speculate_default_device_is_cuda_and_raises_without_it(armed, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        armed.speculate(random_ods(2, seed=61))
    assert not armed.pending()
