"""The port's DAS load generator (celestia_app_tpu_torch/scripts/
das_loadgen.py), held against the JAX script (scripts/das_loadgen.py,
loaded by path as tests/test_serve.py loads it) on the CPU with the plain
kernel versions, at the JAX tests' small sizes.

The swarm plan, the tenant statistics, the percentile and the pass
statistics are the JAX script's on the same inputs; every mode runs end to
end (closed loop, withholding with heal, swarm with a shard sweep, QoS,
attestation, a `--serve` child sampled over `--url`, two of them over
`--urls`), and each record it writes passes the JAX scripts/bench_trend.py
shape check.  Sample counts are small and only a few proofs are verified:
the plain SHA-256 costs milliseconds per call on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from celestia_app_tpu_torch import chaos, qos
from celestia_app_tpu_torch.chaos import degrade
from celestia_app_tpu_torch.scripts import common, das_loadgen
from celestia_app_tpu_torch.trace import square_journal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_loadgen():
    return _load("das_loadgen")


@pytest.fixture(scope="module")
def bench_trend():
    return _load("bench_trend")


@pytest.fixture(autouse=True)
def _clean():
    chaos.uninstall()
    qos.uninstall()
    degrade.reset_for_tests()
    square_journal._reset_for_tests()
    yield
    chaos.uninstall()
    qos.uninstall()
    degrade.reset_for_tests()


def _main(argv) -> tuple[int, dict]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = das_loadgen.main(["--device", "cpu", *argv])
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    return rc, json.loads(lines[-1])


def _swarm_args(**kw) -> argparse.Namespace:
    base = dict(seed=42, k=4, heights=3, historical=2, samples=200, rate=300.0,
                clients=500, hot_frac=0.7, historical_frac=0.02, tenants=5)
    base.update(kw)
    return argparse.Namespace(**base)


def test_swarm_plan_equals_jax(jax_loadgen):
    args = _swarm_args()
    squares = {h: common.tenant_square(args.k, args.seed + h, args.tenants)
               for h in range(1, args.heights + args.historical + 1)}
    jax_squares = {h: jax_loadgen.tenant_square(args.k, args.seed + h, args.tenants)
                   for h in squares}
    for h in squares:
        assert (squares[h][0] == jax_squares[h][0]).all()
        assert squares[h][1] == jax_squares[h][1]
    crng = np.random.default_rng(args.seed)
    client_tenant = crng.choice(args.tenants, size=args.clients)
    plan = das_loadgen.build_swarm_plan(args, squares, client_tenant)
    assert plan == jax_loadgen.build_swarm_plan(args, jax_squares, client_tenant)
    assert len(plan) == args.samples


def test_tenant_stats_percentile_and_pass_stats_equal_jax(jax_loadgen):
    rng = np.random.default_rng(3)
    errs = [None] * 6 + [das_loadgen._THROTTLED, "(1,2,3): DeviceFault: x"]
    results = [(int(rng.integers(0, 4)), float(rng.exponential(0.1)),
                errs[int(rng.integers(0, len(errs)))]) for _ in range(400)]
    for slo_ms in (50.0, 250.0):
        assert das_loadgen._tenant_stats(results, slo_ms) == \
            jax_loadgen._tenant_stats(results, slo_ms)
    lat = sorted(float(v) for v in rng.exponential(3.0, 97))
    for p in (0.0, 0.5, 0.99, 1.0):
        assert das_loadgen._percentile(lat, p) == jax_loadgen._percentile(lat, p)
    assert das_loadgen._percentile([], 0.5) is None
    for wall in (0.0, 1.25):
        assert das_loadgen._pass_stats(lat, wall) == jax_loadgen._pass_stats(lat, wall)


def test_closed_loop_round_and_metrics(tmp_path, bench_trend):
    rnd = tmp_path / "DAS_r91.json"
    rc, summary = _main(["--heights", "2", "--k", "4", "--samples", "40", "--threads", "2",
                         "--verify", "4", "--metrics-out", str(tmp_path / "m"),
                         "--round-out", str(rnd)])
    assert rc == 0, summary
    assert summary["samples"] == 40 and summary["verified"] == 4
    assert summary["platform"] == "cpu" and not summary["failures"]
    bench_trend.load_das_round(str(rnd))
    assert json.loads(rnd.read_text())["n"] == 91
    prom = (tmp_path / "m" / "das_loadgen.prom").read_text()
    assert "celestia_proof_latency_seconds" in prom


def test_withholding_with_heal(tmp_path):
    rc, summary = _main(["--heights", "1", "--k", "4", "--samples", "30", "--threads", "2",
                         "--verify", "2", "--withhold-frac", "0.2", "--heal"])
    assert rc == 0, summary
    assert summary["withheld_hits"] > 0
    heal = summary["heal"]
    assert heal["heights_healed"] == [1] and heal["post_heal_withheld_hits"] == 0
    assert heal["post_heal"]["samples"] == 30
    assert chaos._INSTALLED is None


def test_swarm_sweep_round_passes_bench_trend(tmp_path, bench_trend):
    rnd = tmp_path / "DAS_r92.json"
    rc, summary = _main(["--clients", "300", "--tenants", "4", "--rate", "400",
                         "--samples", "40", "--k", "2", "--heights", "2",
                         "--historical", "1", "--threads", "2", "--verify", "1",
                         "--shard-sweep", "1,8", "--round-out", str(rnd)])
    assert rc == 0, summary
    assert [leg["shards"] for leg in summary["sweep"]] == [1, 8]
    assert summary["headline_shards"] == 8
    bench_trend.load_das_round(str(rnd))
    record = json.loads(rnd.read_text())
    assert record["n"] == 92
    assert record["schema"] == "das-v2" and record["platform"] == "cpu"


def test_qos_round_passes_bench_trend(tmp_path, bench_trend):
    rnd = tmp_path / "QOS_r93.json"
    # The spammer's limit sits far below what the plain kernels serve on the
    # CPU (~170 proofs/s here), so its bucket cannot refill as fast as it
    # is drained: 10/s against 100 spam arrivals a second for 1.2 s.
    rc, summary = _main(["--clients", "300", "--tenants", "4", "--rate", "100",
                         "--samples", "120", "--k", "2", "--heights", "2",
                         "--historical", "0", "--threads", "2", "--verify", "1",
                         "--proof-rate-limit", "10", "--qos-out", str(rnd)])
    assert rc == 0, summary
    spam = summary["legs"]["spam"]["tenants"][summary["spam_tenant"]]
    assert spam["throttled"] > 0 and spam["failed"] == 0
    for tenant, cols in summary["legs"]["spam"]["tenants"].items():
        if tenant != summary["spam_tenant"]:
            assert cols["throttled"] == 0, tenant
    bench_trend.load_qos_round(str(rnd))
    assert json.loads(rnd.read_text())["n"] == 93
    assert qos.enforcer() is None


def test_attestation_legs(tmp_path, bench_trend):
    rnd = tmp_path / "DAS_r94.json"
    rc, summary = _main(["--heights", "1", "--k", "2", "--samples", "16", "--threads", "1",
                         "--verify", "1", "--attest", "8", "--round-out", str(rnd)])
    assert rc == 0, summary
    verify = summary["verify"]
    assert verify["queue"] == 16 and not verify["failures"]
    assert verify["bytes_ratio"] < 1
    assert "verify" in json.loads(rnd.read_text())
    bench_trend.load_das_round(str(rnd))


def test_serve_children_over_url_and_urls(tmp_path, bench_trend):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs, urls = [], []
    try:
        for name in ("node-a", "node-b"):
            proc = subprocess.Popen(
                [sys.executable, "-m", "celestia_app_tpu_torch.scripts.das_loadgen",
                 "--serve", "--device", "cpu", "--k", "2", "--heights", "2"],
                cwd=ROOT, env={**env, "CELESTIA_NODE_ID": name},
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
            procs.append(proc)
        for proc in procs:
            ready = json.loads(proc.stdout.readline())
            assert ready["device"] == "cpu" and ready["k"] == 2
            urls.append(ready["serving"])
        rc, summary = _main(["--url", urls[0], "--samples", "12", "--verify", "3"])
        assert rc == 0, summary
        assert summary["mode"] == "url" and summary["verified"] == 3
        rnd = tmp_path / "DAS_r95.json"
        rc, summary = _main(["--urls", ",".join(urls), "--samples", "24", "--rate", "400",
                             "--threads", "2", "--round-out", str(rnd)])
        assert rc == 0, summary
        fleet = summary["fleet"]
        assert [h["url"] for h in fleet["hosts"]] == urls
        assert all(h["proofs_per_s"] > 0 for h in fleet["hosts"])
        assert 0 < fleet["coverage_ratio"] <= 1
        assert json.loads(rnd.read_text())["workload"] == "fleet"
        bench_trend.load_das_round(str(rnd))
    finally:
        for proc in procs:
            proc.kill()
            proc.wait(timeout=30)
