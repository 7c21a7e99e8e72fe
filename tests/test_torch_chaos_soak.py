"""The port's chaos soak (celestia_app_tpu_torch/scripts/chaos_soak.py),
held against the JAX script (scripts/chaos_soak.py, loaded by path as
tests/test_chaos.py loads it) on the CPU with the plain kernel versions.

One run of the port's `main` at the JAX tests' small sizes gives every
drill's result; each must be `ok`.  The WAL tear and gossip drills return
the JAX summaries key by key, timings apart (the device soak's comparison
is in tests/test_torch_scripts.py, which has the room); the sampling
drill's chaos-on proofs are the JAX host lowering's bytes; main's
--adv-out record loads through the JAX scripts/bench_trend.py.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import io
import json
import os

import jax
import pytest

from celestia_app_tpu import chaos as jax_chaos
from celestia_app_tpu.chaos import degrade as jax_degrade
from celestia_app_tpu_torch import chaos
from celestia_app_tpu_torch.chaos import degrade
from celestia_app_tpu_torch.scripts import chaos_soak

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = ("seed=5,dispatch_fail=0.2,upload_stall_ms=1,upload_fail=0.1,"
        "gossip_drop=0.25,gossip_dup=0.15,wal_torn_tail=2")
DRILLS = ("device_soak", "wal_tear", "sampling", "shard_fault", "extend_shard",
          "speculation", "batched_fault", "attestation", "qos", "withholding",
          "adversary", "healing", "quorum_heal", "gossip", "breaker_epi", "breaker")


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran, when it ends
    (each loaded XLA:CPU executable holds many memory mappings)."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _clean_chaos():
    for c, d in ((chaos, degrade), (jax_chaos, jax_degrade)):
        c.uninstall()
        d.reset_for_tests()
    yield
    for c, d in ((chaos, degrade), (jax_chaos, jax_degrade)):
        c.uninstall()
        d.reset_for_tests()


@pytest.fixture(scope="module")
def jax_soak():
    spec = importlib.util.spec_from_file_location(
        "chaos_soak", os.path.join(ROOT, "scripts", "chaos_soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def main_run(tmp_path_factory):
    """The port's main at the JAX smoke's knobs (tests/test_chaos.py
    test_soak_main_smoke), k=2, with its flight recorder in a temp dir."""
    tmp = tmp_path_factory.mktemp("soak")
    summary = tmp / "summary.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CELESTIA_FLIGHT_DIR", str(tmp / "flight"))
        before = {k: v for k, v in os.environ.items() if k.startswith("CELESTIA_")}
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = chaos_soak.main([
                "--device", "cpu", "--blocks", "3", "--k", "2",
                "--adv-trials", "20", "--summary-out", str(summary),
                "--adv-out", str(tmp / "ADV_r97.json"),
                "--spec", "seed=9,dispatch_fail=0.3,gossip_drop=0.2,wal_torn_tail=1",
            ])
        after = {k: v for k, v in os.environ.items() if k.startswith("CELESTIA_")}
    return {"rc": rc, "out": out.getvalue(), "env_kept": before == after,
            "summary": json.loads(summary.read_text()), "adv": tmp / "ADV_r97.json"}


def test_main_exits_zero_and_prints_its_tables(main_run):
    assert main_run["rc"] == 0, main_run["out"]
    out = main_run["out"]
    assert "chaos_soak: OK" in out
    assert "celestia_chaos_injections_total" in out
    assert "time-to-detection per drill" in out
    assert "withholding drill" in out
    assert main_run["env_kept"], "main left CELESTIA_* variables changed"
    assert main_run["summary"]["device"] == "cpu"
    assert chaos._INSTALLED is None
    assert degrade.degraded_state() is None


def test_adv_round_passes_bench_trend(main_run):
    """The --adv-out record (schema adv-v2) loads through the JAX
    scripts/bench_trend.py, with the heal legs and the CPU named."""
    spec = importlib.util.spec_from_file_location(
        "bench_trend", os.path.join(ROOT, "scripts", "bench_trend.py"))
    bench_trend = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_trend)
    loaded = bench_trend.load_adv_round(str(main_run["adv"]))
    assert loaded["round"] == 97 and loaded["platform"] == "cpu"
    assert loaded["heal"]["single"]["healed"] and loaded["heal"]["quorum"]["healed"]
    assert all(loaded["adversaries_detected"].values())


@pytest.mark.parametrize("drill", DRILLS)
def test_every_drill_of_main_is_ok(main_run, drill):
    result = main_run["summary"]["drills"][drill]
    ok = result["roots_identical"] if drill == "device_soak" else result["ok"]
    assert ok, result


def test_sharded_drills_engage_their_shards(main_run):
    drills = main_run["summary"]["drills"]
    assert drills["shard_fault"]["sharded"] and drills["shard_fault"]["shards"] == 8
    # k=2: the extend mesh clamps to the square, as in JAX.
    assert drills["extend_shard"]["eds_device_shards"] == drills["extend_shard"]["shards"] == 2
    fault = drills["shard_fault"]["legs"]["device_fault"]
    assert fault["device_faults"] == fault["batches"] and fault["served"] == 0


def _without_timing(summary: dict) -> dict:
    out = dict(summary)
    det = out.pop("detection", None)
    out["detected_by"] = det and det.get("by")
    return out


def test_wal_tear_drill_equals_jax(jax_soak, tmp_path):
    port = chaos_soak.run_wal_tear_drill(SPEC, wal_dir=str(tmp_path / "port"),
                                         device="cpu")
    ref = jax_soak.run_wal_tear_drill(SPEC, wal_dir=str(tmp_path / "jax"))
    assert _without_timing(port) == _without_timing(ref)
    assert port["ok"] and port["torn_on_disk"] and port["salvaged_bytes"] > 0


def test_gossip_drill_equals_jax(jax_soak):
    port = chaos_soak.run_gossip_drill(SPEC, n_msgs=20, device="cpu")
    ref = jax_soak.run_gossip_drill(SPEC, n_msgs=20)
    assert port == ref
    assert port["ok"]


def test_sampling_drill_bytes_equal_the_jax_host_lowering(jax_soak, monkeypatch):
    """The chaos-on proofs (retried on the card, never answered on the
    host) are the bytes the JAX host lowering gives for the same plan."""
    import numpy as np

    from celestia_app_tpu.da.eds import ExtendedDataSquare as JaxEDS
    from celestia_app_tpu.rpc.codec import to_jsonable as jax_to_jsonable
    from celestia_app_tpu.serve.api import render as jax_render
    from celestia_app_tpu.serve.cache import ForestCache as JaxForestCache
    from celestia_app_tpu.serve.sampler import ProofSampler as JaxSampler

    k, samples = 4, 64
    proofs: list = []
    result = chaos_soak.run_sampling_drill(k=k, samples=samples, device="cpu",
                                           proofs_out=proofs)
    assert result["ok"], result
    assert result["retries"] >= 1 and result["device_faults"] == 0
    _, ods = jax_soak._deterministic_blocks(1, k, seed=515)[0]
    monkeypatch.setenv("CELESTIA_SERVE_MODE", "host")
    entry = JaxForestCache(heights=2, spill=2).put(1, JaxEDS.compute(ods))
    rng = np.random.default_rng(99)
    coords = [(int(rng.integers(0, 2 * k)), int(rng.integers(0, 2 * k)))
              for _ in range(samples)]
    want = [jax_render(jax_to_jsonable(p))
            for p in JaxSampler().sample_batch(entry, coords)]
    assert proofs == want


def test_a_drill_gives_back_the_process_state():
    os.environ.pop("CELESTIA_PIPE_FUSED", None)
    chaos.install("seed=1,gossip_drop=0.0")
    installed = chaos._INSTALLED
    chaos_soak.run_breaker_drill(k=2, base_env="epi", device="cpu")
    assert chaos._INSTALLED is installed
    assert "CELESTIA_PIPE_FUSED" not in os.environ
    assert degrade.degraded_state() is None
