"""The port's malicious proposer (testutil/malicious.py), held against the
JAX package's: for each behaviour the JAX and the port `MaliciousApp`
(device="cpu") build the same bad proposal from the same PFBs; the honest
JAX App and the honest port App both reject it, both accept the honest
proposal, and the verdicts on the JAX proposal and the port's are the same.
Before `start_height` the port's misbehaving App proposes honestly, as the
JAX one does.
"""

from __future__ import annotations

import gc

import jax
import numpy as np
import pytest

from celestia_app_tpu.app import App as JaxApp
from celestia_app_tpu.state.dec import Dec as JaxDec
from celestia_app_tpu.testutil import deterministic_genesis as jax_genesis
from celestia_app_tpu.testutil import funded_keys as jax_keys
from celestia_app_tpu.testutil import malicious as jax_malicious
from celestia_app_tpu_torch.app import App
from celestia_app_tpu_torch.modules.blob.types import estimate_gas
from celestia_app_tpu_torch.shares.namespace import Namespace
from celestia_app_tpu_torch.shares.sparse import Blob
from celestia_app_tpu_torch.state.dec import Dec
from celestia_app_tpu_torch.testutil import deterministic_genesis, funded_keys
from celestia_app_tpu_torch.testutil import malicious
from celestia_app_tpu_torch.user import Signer

PRICE = "0.000001"


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran, when it ends
    (each loaded XLA:CPU executable holds many memory mappings)."""
    yield
    jax.clear_caches()
    gc.collect()


def pfbs() -> list[bytes]:
    """Two PFBs of one small blob each, under two namespaces (a k=2
    square)."""
    rng = np.random.default_rng(3)
    keys = funded_keys(2)
    signer = Signer("tpu-test-chain")
    for i, key in enumerate(keys):
        signer.add_account(key, i, 0)
    addr = signer.addresses()[0]
    txs = []
    for tag, size in ((10, 300), (20, 400)):
        blob = Blob(Namespace.v0(bytes([tag]) * 10), rng.integers(0, 256, size, np.uint8).tobytes())
        gas = estimate_gas([size])
        txs.append(signer.create_pay_for_blobs(addr, [blob], gas, gas))
        signer.increment_sequence(addr)
    return txs


def honest(pkg: str):
    if pkg == "jax":
        app = JaxApp(node_min_gas_price=JaxDec.from_str(PRICE))
        app.init_chain(jax_genesis(jax_keys(2)))
    else:
        app = App(node_min_gas_price=Dec.from_str(PRICE), device="cpu")
        app.init_chain(deterministic_genesis(funded_keys(2)))
    return app


def evil(pkg: str, behavior: str, **kwargs):
    if pkg == "jax":
        app = jax_malicious.MaliciousApp(behavior=behavior,
                                         node_min_gas_price=JaxDec.from_str(PRICE), **kwargs)
        app.init_chain(jax_genesis(jax_keys(2)))
    else:
        app = malicious.MaliciousApp(behavior=behavior, node_min_gas_price=Dec.from_str(PRICE),
                                     device="cpu", **kwargs)
        app.init_chain(deterministic_genesis(funded_keys(2)))
    return app


@pytest.fixture(scope="module")
def apps():
    return {"jax": honest("jax"), "port": honest("port")}


def as_tuple(data) -> tuple:
    return tuple(data.txs), data.square_size, data.hash


@pytest.mark.parametrize("behavior", [malicious.OUT_OF_ORDER, malicious.WRONG_ROOT])
def test_malicious_proposal_rejected_by_both(apps, behavior):
    assert (malicious.OUT_OF_ORDER, malicious.WRONG_ROOT) == \
        (jax_malicious.OUT_OF_ORDER, jax_malicious.WRONG_ROOT)
    txs = pfbs()
    bad = {pkg: evil(pkg, behavior).prepare_proposal(txs) for pkg in ("jax", "port")}
    assert as_tuple(bad["port"]) == as_tuple(bad["jax"])
    verdicts = {(judge, pkg): apps[judge].process_proposal(bad[pkg])
                for judge in ("jax", "port") for pkg in ("jax", "port")}
    assert verdicts == dict.fromkeys(verdicts, False)
    good = {pkg: apps[pkg].prepare_proposal(txs) for pkg in ("jax", "port")}
    assert as_tuple(good["port"]) == as_tuple(good["jax"]) and good["port"].square_size == 2
    assert as_tuple(good["port"]) != as_tuple(bad["port"])
    assert all(apps[judge].process_proposal(good[pkg]) for judge in apps for pkg in good)


@pytest.mark.parametrize("behavior", [malicious.OUT_OF_ORDER, malicious.WRONG_ROOT])
def test_honest_before_start_height(apps, behavior):
    txs = pfbs()
    early = evil("port", behavior, start_height=2).prepare_proposal(txs)
    assert as_tuple(early) == as_tuple(apps["port"].prepare_proposal(txs))
    assert apps["jax"].process_proposal(early) and apps["port"].process_proposal(early)


def test_unknown_behavior_refused():
    for mod in (malicious, jax_malicious):
        with pytest.raises(ValueError, match="unknown behavior"):
            mod.MaliciousApp(behavior="lazy", device="cpu") if mod is malicious else \
                mod.MaliciousApp(behavior="lazy")
