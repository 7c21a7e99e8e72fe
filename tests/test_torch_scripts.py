"""The port's operator drivers beside the JAX scripts they copy
(celestia_app_tpu_torch/scripts/ against scripts/, loaded by path):

  * the shared helpers give the JAX scripts' bytes for the same seeds;
  * block_anatomy's waterfall, phase budget and budget table render a
    timeline record of the port's streamed run line for line as the JAX
    script renders it, and its round record passes the JAX
    scripts/bench_trend.py shape check;
  * the port's trace_lint passes on the port and fails on a planted
    malformed metric name;
  * devnet_smoke's Commit checks hold on a Commit signed in process over a
    port Network's block and refuse a tampered one (the multi-process
    spawn itself is tests/test_torch_devnet.py's, and the whole script's
    on the card);
  * the unchanged JAX scripts/slo_report.py renders a flight bundle of the
    port's breaker drill as it renders the JAX drill's, stamps apart;
  * chaos_soak's device soak equals the JAX drill's, its roots the JAX
    `extend_shares` roots, and its two sharded drills pass over 4 logical
    shards of one device, the path a one-card machine takes;
  * every driver's entry point asks for CUDA when given no device, and so
    raises here.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import io
import json
import os
import re

import jax
import pytest
import torch

from celestia_app_tpu_torch import chaos
from celestia_app_tpu_torch.chaos import degrade
from celestia_app_tpu_torch.scripts import (
    block_anatomy,
    chaos_soak,
    common,
    das_loadgen,
    devnet_smoke,
    trace_lint,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran, when it ends
    (each loaded XLA:CPU executable holds many memory mappings)."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _clean():
    chaos.uninstall()
    degrade.reset_for_tests()
    yield
    chaos.uninstall()
    degrade.reset_for_tests()


@pytest.mark.parametrize("n,k,seed", [(3, 4, 1234), (1, 8, 515), (6, 2, 777)])
def test_deterministic_blocks_equal_the_jax_soak(n, k, seed):
    ref = _load("chaos_soak")._deterministic_blocks(n, k, seed)
    got = common.deterministic_blocks(n, k, seed)
    assert [t for t, _ in got] == [t for t, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        assert a.dtype == b.dtype and (a == b).all()


def test_squares_equal_the_jax_loadgen_and_anatomy():
    loadgen, anatomy = _load("das_loadgen"), _load("block_anatomy")
    for k, seed in ((2, 43), (8, 44), (16, 7)):
        square = common.deterministic_square(k, seed)
        assert (square == loadgen.deterministic_square(k, seed)).all()
        assert (square == anatomy.deterministic_square(k, seed)).all()
    for k, seed, tenants in ((4, 45, 4), (8, 46, 8), (2, 47, 1)):
        ods, ranges = common.tenant_square(k, seed, tenants)
        ref_ods, ref_ranges = loadgen.tenant_square(k, seed, tenants)
        assert (ods == ref_ods).all() and ranges == ref_ranges
    with pytest.raises(ValueError):
        common.tenant_square(2, 1, 256)


@pytest.fixture(scope="module")
def anatomy_records():
    from celestia_app_tpu_torch.trace import timeline

    timeline._reset_for_tests()
    try:
        return block_anatomy.run_stream(3, 2, 7, device="cpu")
    finally:
        timeline._reset_for_tests()


def test_block_anatomy_renders_as_the_jax_script(anatomy_records):
    ref = _load("block_anatomy")
    assert sorted(anatomy_records) == [1, 2, 3]
    for rec in anatomy_records.values():
        assert rec["finalized"] and rec["phases"] and rec["trace_ids"]
        assert block_anatomy.waterfall(rec) == ref.waterfall(rec)
    budget = block_anatomy.phase_budget(anatomy_records)
    assert budget == ref.phase_budget(anatomy_records)
    assert block_anatomy.budget_table(budget) == ref.budget_table(budget)
    summary = {h: {k: v for k, v in r.items() if k != "intervals"}
               for h, r in anatomy_records.items()}
    assert block_anatomy.waterfall(summary[3]) == ref.waterfall(summary[3])


def test_block_anatomy_main_round_and_bundle(tmp_path, anatomy_records):
    bench_trend = _load("bench_trend")
    rnd = tmp_path / "TL_r97.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert block_anatomy.main(["--device", "cpu", "--blocks", "2", "--k", "2",
                                   "--round-out", str(rnd)]) == 0
    assert "phase budget over" in out.getvalue()
    record = json.loads(rnd.read_text())
    assert record["platform"] == "cpu" and record["schema"] == "tl-v1"
    bench_trend.load_tl_round(str(rnd))
    bundle = tmp_path / "flight.json"
    latest = anatomy_records[3]
    bundle.write_text(json.dumps({"timeline": {
        "latest": latest, "records": list(anatomy_records.values())}}))
    assert block_anatomy.from_bundle(str(bundle)) == _load("block_anatomy").from_bundle(str(bundle))


def test_trace_lint_passes_on_the_port():
    trees = trace_lint._parse_package()
    regs = trace_lint.collect_registrations(trees=trees)
    assert any(rel.startswith("celestia_app_tpu_torch/") for rel, *_ in regs)
    assert trace_lint.collect_routed_paths(trees=trees), "the port's router was not found"
    assert trace_lint.collect_fleet_routes(trees=trees)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert trace_lint.main() == 0
    assert "trace_lint: OK" in out.getvalue()


def test_trace_lint_fails_on_a_planted_malformed_name(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(
        "from x import registry\n"
        "registry().counter('celestia_Bad-Name', 'planted')\n"
        "registry().gauge('celestia_not_in_the_readme_at_all', 'planted')\n")
    problems = trace_lint.lint(package_dir=str(pkg))
    assert any("celestia_Bad-Name" in p and "does not match" in p for p in problems)
    assert any("celestia_not_in_the_readme_at_all" in p and "missing" in p
               for p in problems)


def _signed_commit(data_root: bytes, prev_app_hash: bytes, height: int, time_ns: int,
                   chain_id: str, signers: range, round_: int = 0):
    from celestia_app_tpu_torch.consensus import Commit, block_id
    from celestia_app_tpu_torch.consensus.votes import PRECOMMIT, Vote
    from celestia_app_tpu_torch.crypto.keys import PrivateKey

    bid = block_id(data_root, prev_app_hash, time_ns)
    votes = tuple(Vote.sign(PrivateKey.from_seed(f"validator-{i}".encode()), chain_id,
                            height, PRECOMMIT, bid, round=round_) for i in signers)
    return Commit(height, bid, votes, data_root, prev_app_hash, round_, time_ns)


class _Commits:
    def __init__(self, records: dict):
        self.records = records

    def commit(self, height: int):
        return self.records.get(height)


def test_devnet_smoke_checks_a_commit_over_a_port_network():
    import dataclasses

    from celestia_app_tpu_torch.testutil.network import Network

    net = Network(4, device="cpu")
    prev = b"\0" * 32
    data, _ = net.produce_block()
    chain_id = net.chain_id
    vals = devnet_smoke.validator_set(4)
    time_ns = net.nodes[0].last_block_time_ns
    rec = _signed_commit(data.hash, prev, 1, time_ns, chain_id, range(3))
    assert devnet_smoke.check_commit(_Commits({1: rec}), chain_id, 1, vals) is rec
    forged = dataclasses.replace(rec, time_ns=time_ns + 1)
    with pytest.raises(AssertionError):
        devnet_smoke.check_commit(_Commits({1: forged}), chain_id, 1, vals)
    short = _signed_commit(data.hash, prev, 1, time_ns, chain_id, range(2))
    with pytest.raises(AssertionError):
        devnet_smoke.check_commit(_Commits({1: short}), chain_id, 1, vals)


def test_devnet_smoke_post_kill_rule():
    vals = devnet_smoke.validator_set(4)
    order = sorted(vals)
    dead = order[0]
    dead_index = list(vals).index(dead)  # vals is keyed in validator order

    def records(dead_round: int) -> _Commits:
        out = {}
        for h in range(3, 9):
            round_ = dead_round if order[(h - 1) % 4] == dead else 0
            signers = [i for i in range(4) if i != dead_index]
            out[h] = _signed_commit(b"\1" * 32, b"\2" * 32, h, 10 + h, "c", signers, round_)
        return _Commits(out)

    rounds, heights = devnet_smoke.check_post_kill(records(1), vals, dead, 3, 8)
    assert heights == [5] and rounds == [0, 1]
    with pytest.raises(AssertionError, match="dead round-0 proposer"):
        devnet_smoke.check_post_kill(records(0), vals, dead, 3, 8)


def test_device_soak_equals_jax_and_its_roots():
    """The soak's summary equals the JAX drill's key by key (its detection
    time apart), and its chaos-on roots are the JAX `extend_shares` roots
    of the same blocks (tests/test_chaos.py's spec and sizes)."""
    from celestia_app_tpu.da.eds import extend_shares as jax_extend_shares

    spec = ("seed=5,dispatch_fail=0.2,upload_stall_ms=1,upload_fail=0.1,"
            "gossip_drop=0.25,gossip_dup=0.15,wal_torn_tail=2")
    jax_soak = _load("chaos_soak")
    roots: dict = {}
    port = chaos_soak.run_device_soak(5, 4, spec, device="cpu", roots_out=roots)
    ref = jax_soak.run_device_soak(5, 4, spec)
    detected = [(r.pop("detection") or {}).get("by") for r in (port, ref)]
    assert detected[0] == detected[1]
    assert port == ref and port["roots_identical"]
    for tag, ods in jax_soak._deterministic_blocks(5, 4):
        shares = [ods[r, c].tobytes() for r in range(4) for c in range(4)]
        assert roots[tag] == jax_extend_shares(shares).data_root(), tag


@pytest.mark.parametrize("drill,kwargs", [
    ("run_shard_fault_drill", {"k": 4}),
    ("run_extend_shard_drill", {"k": 4}),
])
def test_sharded_drills_over_logical_shards(drill, kwargs):
    """The one-card path: 4 logical shards of one device."""
    with chaos_soak.logical_shards(4, "cpu"):
        result = getattr(chaos_soak, drill)(**kwargs, device="cpu")
    assert result["ok"], result
    assert result["shards"] == 4


def _normalized(text: str) -> list[str]:
    text = re.sub(r"/[^\s\"]*/flight-", "<dir>/flight-", text)
    text = re.sub(r"flight-([a-z_]+)-[^\s\"]+\.json", r"flight-\1-<stamp>.json", text)
    text = re.sub(r"captured=[^U]*UTC", "captured=<time>", text)
    text = re.sub(r"evaluated=\d+", "evaluated=<ms>", text)
    text = re.sub(r"\"(ts_ns|dispatch_ms|upload_ms)\": [0-9.e+-]+", r'"\1": <n>', text)
    # First builds are billed once per process: whether this drill pays
    # any, and whether its first square hits a built pipeline, depends on
    # what the process built before it.
    text = re.sub(r"compile_bill\(\d+\), ", "", text)
    text = re.sub(r"\"compile\": \"(hit|miss)\"", '"compile": <state>', text)
    return text.splitlines()


def test_slo_report_renders_a_port_bundle_as_a_jax_one(tmp_path, monkeypatch):
    report = _load("slo_report")
    jax_soak = _load("chaos_soak")
    rendered = {}
    for name, root, run in (
            ("jax", "celestia_app_tpu", lambda: jax_soak.run_breaker_drill(k=2)),
            ("port", "celestia_app_tpu_torch",
             lambda: chaos_soak.run_breaker_drill(k=2, device="cpu"))):
        def trace(module: str):
            return importlib.import_module(f"{root}.trace.{module}")

        # The same fresh process-wide state in both packages: registry,
        # tracer tables, height timeline, namespace journal, ledger streak,
        # bundle sequence (bundle paths in the rows are cut at 240 chars).
        monkeypatch.setattr(trace("metrics"), "_REGISTRY", trace("metrics").Registry())
        fresh = trace("tracer").Tracer()
        monkeypatch.setattr(trace("tracer"), "_default", fresh)
        monkeypatch.setattr(trace("tracer"), "_TIMELINE_INSTALLED", True)
        monkeypatch.setattr(trace("timeline"), "_TIMELINE", trace("timeline").HeightTimeline())
        trace("timeline").install(fresh)
        trace("square_journal")._reset_for_tests()
        monkeypatch.setattr(trace("device_ledger"), "_RESIDUAL_STREAK", 0)
        monkeypatch.setattr(trace("device_ledger"), "_LAST_RESIDUAL", None)
        monkeypatch.setattr(trace("flight_recorder"), "_SEQ", 0)
        flight = tmp_path / f"{name:_<4}"  # equal lengths: rows are cut at 240
        monkeypatch.setenv("CELESTIA_FLIGHT_DIR", str(flight))
        assert run()["ok"]
        bundle = next(p for p in sorted(os.listdir(flight)) if "slo_fast_burn" in p)
        with open(flight / bundle) as f:
            rendered[name] = _normalized(report.render(json.load(f)))
    assert rendered["port"] == rendered["jax"]
    assert any("PAGING" in line for line in rendered["port"])


ENTRY_POINTS = [
    ("chaos_soak.main", lambda: chaos_soak.main(["--blocks", "1", "--k", "2"])),
    ("chaos_soak.run_device_soak", lambda: chaos_soak.run_device_soak(1, 2, "")),
    ("chaos_soak.run_wal_tear_drill", lambda: chaos_soak.run_wal_tear_drill("")),
    ("chaos_soak.run_gossip_drill", lambda: chaos_soak.run_gossip_drill("")),
    ("chaos_soak.run_breaker_drill", lambda: chaos_soak.run_breaker_drill(k=2)),
    ("chaos_soak.run_sampling_drill", lambda: chaos_soak.run_sampling_drill(k=2)),
    ("chaos_soak.run_shard_fault_drill", lambda: chaos_soak.run_shard_fault_drill(k=2)),
    ("chaos_soak.run_extend_shard_drill", lambda: chaos_soak.run_extend_shard_drill(k=2)),
    ("chaos_soak.run_speculation_drill", lambda: chaos_soak.run_speculation_drill(k=2)),
    ("chaos_soak.run_batched_fault_drill", lambda: chaos_soak.run_batched_fault_drill(k=2)),
    ("chaos_soak.run_attestation_drill", lambda: chaos_soak.run_attestation_drill(k=2)),
    ("chaos_soak.run_qos_drill", lambda: chaos_soak.run_qos_drill()),
    ("chaos_soak.run_withholding_drill", lambda: chaos_soak.run_withholding_drill(k=2)),
    ("chaos_soak.run_adversary_detection_drill",
     lambda: chaos_soak.run_adversary_detection_drill(k=2)),
    ("chaos_soak.run_healing_drill", lambda: chaos_soak.run_healing_drill(k=2)),
    ("chaos_soak.run_quorum_heal_drill", lambda: chaos_soak.run_quorum_heal_drill(k=2)),
    ("chaos_soak.write_adv_round", lambda: chaos_soak.write_adv_round("/dev/null", {}, {}, 0)),
    ("das_loadgen.main", lambda: das_loadgen.main(["--k", "2", "--samples", "1"])),
    ("das_loadgen.main --serve", lambda: das_loadgen.main(["--serve"])),
    ("das_loadgen.build_cache", lambda: das_loadgen.build_cache(1, 2, 1)),
    ("block_anatomy.main", lambda: block_anatomy.main(["--blocks", "1", "--k", "2"])),
    ("block_anatomy.run_stream", lambda: block_anatomy.run_stream(1, 2, 1)),
    ("devnet_smoke.main", lambda: devnet_smoke.main([])),
]


@pytest.mark.parametrize("name,call", ENTRY_POINTS, ids=[n for n, _ in ENTRY_POINTS])
def test_entry_points_ask_for_cuda_without_a_device(name, call):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal of a machine with no card")
    env = {k: v for k, v in os.environ.items() if k.startswith("CELESTIA_")}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert {k: v for k, v in os.environ.items() if k.startswith("CELESTIA_")} == env
