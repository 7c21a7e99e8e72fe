"""The public host helpers the port had lacked, each held byte-equal to the
JAX package's: `DataAvailabilityHeader.marshal` / `unmarshal` (the proto
wire form, with the DAH case of tests/test_proto_wire.py and a k=8 round
trip), `kernels/rs.extend_square` and `kernels/sha256.sha256_bytes`, on the
CPU; with no device given each asks for CUDA and raises here."""

from __future__ import annotations

import gc
import hashlib

import jax
import numpy as np
import pytest
import torch

from celestia_app_tpu.da.dah import DataAvailabilityHeader as JaxDAH
from celestia_app_tpu.da.eds import ExtendedDataSquare as JaxEDS
from celestia_app_tpu.kernels import rs as jax_rs
from celestia_app_tpu.kernels import sha256 as jax_sha256
from celestia_app_tpu_torch.da.dah import DataAvailabilityHeader
from celestia_app_tpu_torch.da.eds import ExtendedDataSquare
from celestia_app_tpu_torch.kernels import rs, sha256
from celestia_app_tpu_torch.scripts.common import deterministic_square



@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran, when it ends
    (each loaded XLA:CPU executable holds many memory mappings)."""
    yield
    jax.clear_caches()
    gc.collect()


def test_marshal_of_the_proto_wire_case_equals_jax():
    rows, cols = (b"\x01" * 90, b"\x02" * 90), (b"\x03" * 90,)
    port = DataAvailabilityHeader(rows, cols)
    assert port.marshal() == JaxDAH(rows, cols).marshal()
    back = DataAvailabilityHeader.unmarshal(port.marshal())
    assert back.row_roots == list(rows) and back.column_roots == list(cols)


def test_k8_dah_round_trip_equals_jax():
    ods = deterministic_square(8, 515)
    port = DataAvailabilityHeader.from_eds(ExtendedDataSquare.compute(ods, device="cpu"))
    ref = JaxDAH.from_eds(JaxEDS.compute(ods))
    wire = port.marshal()
    assert wire == ref.marshal()
    back = DataAvailabilityHeader.unmarshal(wire)
    assert back.equals(port) and back.hash() == ref.hash()
    assert JaxDAH.unmarshal(wire).equals(ref)
    assert DataAvailabilityHeader.unmarshal(b"").row_roots == []


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_extend_square_equals_jax(k):
    ods = deterministic_square(k, 40 + k)
    got = rs.extend_square(ods, device="cpu")
    assert got.dtype == np.uint8 and got.shape == (2 * k, 2 * k, 512)
    assert np.array_equal(got, jax_rs.extend_square(ods))


def test_sha256_bytes_equals_jax_and_hashlib():
    rng = np.random.default_rng(5)
    for n in (0, 1, 55, 56, 64, 181, 542, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        want = hashlib.sha256(data).digest()
        assert sha256.sha256_bytes(data, device="cpu") == want
        assert jax_sha256.sha256_bytes(data) == want


def test_helpers_ask_for_cuda_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal of a machine with no card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs.extend_square(deterministic_square(2, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sha256.sha256_bytes(b"abc")
