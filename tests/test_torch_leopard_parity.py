"""The port's leopard-parity tool (celestia_app_tpu_torch/scripts/
verify_leopard_parity.py) beside the JAX tool it copies (scripts/
verify_leopard_parity.py, loaded by path with the environment and sys.path
it sets at import restored afterwards), on the same inputs on the CPU:

  * the self-test reports the same legs;
  * a corrupted encode vector gives the same first mismatch and the same
    failed basis search;
  * block evidence of k=4 and k=8 squares under both constructions, and of
    a k=4 square with a tampered parity root, gives the same result for
    both constructions;
  * a basis search with a small budget finds the same foreign basis;
  * `main` prints the same JSON line for an evidence file;
  * the tool asks for CUDA when given no device, and so raises here.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
from functools import lru_cache

import jax
import numpy as np
import pytest

from celestia_app_tpu_torch.gf import leopard as port_leopard
from celestia_app_tpu_torch.gf.rs import RSCodec
from celestia_app_tpu_torch.scripts import verify_leopard_parity as port_tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tool():
    env, path = dict(os.environ), list(sys.path)
    spec = importlib.util.spec_from_file_location(
        "jax_verify_leopard_parity", os.path.join(ROOT, "scripts", "verify_leopard_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    yield mod
    jax.clear_caches()
    gc.collect()


def _square(k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ods = rng.integers(0, 256, (k, k, 512), dtype=np.uint8)
    ods[:, :, :29] = 0
    ods[:, :, 28] = np.sort(rng.integers(0, 64, k * k).astype(np.uint8)).reshape(k, k)
    return ods


@lru_cache(maxsize=None)
def _evidence(k: int, construction: str) -> str:
    """Block evidence of the seed-k square extended under `construction`
    on the CPU, as JSON (each test decodes its own copy)."""
    return json.dumps(port_tool.block_evidence(_square(k, seed=k), construction, device="cpu"))


def _vectors(data: np.ndarray, parity: np.ndarray, **extra) -> dict:
    return {"kind": "encode_vectors", "field": 8, **extra,
            "data": [d.tobytes().hex() for d in data],
            "parity": [p.tobytes().hex() for p in parity]}


def test_selftest_equals_the_jax_tool(jax_tool):
    got = port_tool.selftest(device="cpu")
    assert got == jax_tool.selftest()
    assert set(got["selftest"].values()) == {"ok"}


def test_corrupted_vector_reports_the_same_mismatch(jax_tool):
    rng = np.random.default_rng(11)
    k = 4
    data = rng.integers(0, 256, (k, 32), dtype=np.uint8)
    parity = RSCodec(k, "leopard").encode(data)
    parity[2, 5] ^= 0xFF
    ev = _vectors(data, parity, search_budget=8)
    got = port_tool.check_encode_vectors(ev)
    assert got == jax_tool.check_encode_vectors(ev)
    assert got["results"]["leopard"]["first_mismatch"] == {
        "shard": 2, "byte": 5, "got": int(parity[2, 5] ^ 0xFF), "want": int(parity[2, 5])}
    assert got["basis_search"]["hit"] is False


@pytest.mark.parametrize("construction", ["leopard", "vandermonde"])
@pytest.mark.parametrize("k", [4, 8])
def test_block_evidence_verdicts_equal(jax_tool, k, construction):
    ev = json.loads(_evidence(k, construction))
    got = port_tool.check_block(ev, device="cpu")
    assert got == jax_tool.check_block(ev)
    other = "vandermonde" if construction == "leopard" else "leopard"
    assert got["results"][construction] == {"match": True}
    assert got["results"][other]["match"] is False


def test_tampered_parity_root_is_localised_alike(jax_tool):
    """A parity row's root flipped: the ODS rows still match, and both
    tools name the same first mismatching row."""
    k = 4
    ev = json.loads(_evidence(k, "leopard"))
    root = bytearray.fromhex(ev["row_roots"][k + 1])
    root[-1] ^= 1
    ev["row_roots"][k + 1] = root.hex()
    got = port_tool.check_block(ev, device="cpu")
    assert got == jax_tool.check_block(ev)
    assert got["results"]["leopard"] == {"match": False, "first_row_mismatch": k + 1,
                                         "first_col_mismatch": None}


def test_small_budget_search_finds_the_same_basis(jax_tool):
    """Parity under a foreign Cantor chain (the root choice flipped at step
    2, which the 2k=8 grid uses): both searches find it within 16 tries."""
    chain = list(port_leopard.cantor_basis(8))
    chain[2] ^= 1
    f8 = port_leopard.leopard_field(8)
    for j in range(3, 8):
        chain[j] = port_leopard._solve_artin_schreier(f8, chain[j - 1])
    rng = np.random.default_rng(5)
    k = 4
    data = rng.integers(0, 256, (k, 48), dtype=np.uint8)
    old = port_leopard.FORCED_CANTOR_BASIS[8]
    port_leopard.FORCED_CANTOR_BASIS[8] = tuple(chain)
    port_leopard.cantor_basis.cache_clear()
    try:
        parity = RSCodec(k, "leopard").encode(data)
    finally:
        port_leopard.FORCED_CANTOR_BASIS[8] = old
        port_leopard.cantor_basis.cache_clear()
    ev = _vectors(data, parity, search_budget=16)
    got = port_tool._search_leopard_constants(ev, data, parity, 8)
    assert got == jax_tool._search_leopard_constants(ev, data, parity, 8)
    assert got["hit"] and got["cantor_basis"] == chain[:3]
    assert port_tool.check_encode_vectors(ev) == jax_tool.check_encode_vectors(ev)


@pytest.mark.parametrize("kind", ["encode_vectors", "block"])
def test_main_prints_the_jax_line(jax_tool, kind, tmp_path, capsys, monkeypatch):
    if kind == "block":
        ev = json.loads(_evidence(4, "leopard"))
    else:
        data = np.random.default_rng(9).integers(0, 256, (8, 16), dtype=np.uint8)
        ev = _vectors(data, RSCodec(8, "vandermonde").encode(data), search_budget=4)
    path = tmp_path / "evidence.json"
    path.write_text(json.dumps(ev))
    assert port_tool.main([str(path), "--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["verify_leopard_parity.py", str(path)])
    assert jax_tool.main() == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want
    assert json.loads(got)["verdict"].startswith(
        "PARITY CLOSED" if kind == "block" else "vandermonde construction matches")


def test_main_usage_and_default_device(monkeypatch, capsys):
    assert port_tool.main([]) == 2
    assert "Leopard RS parity closure tool" in capsys.readouterr().err
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_tool.main(["--selftest"])
