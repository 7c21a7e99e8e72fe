"""BENCHMARK.json against the benchmark's contract, and the harness finding
every configuration, mix, layer map and reader by name alone."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from dabench.spec import Bench, load_module

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
ROOT = Path(__file__).resolve().parents[2]
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def bench():
    return Bench(ROOT)


def test_top_level_keys_and_limits(bench):
    d = bench.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert d["paths"] == ["dabench"] and 1 <= d["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in d["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = 2 + 14 * 24
    assert cells * (d["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_one_line_texts(bench):
    d = bench.data
    entries = d["configs"] + d["workloads"] + d["end_to_end"] + d["per_layer"]
    names = [e["name"] for e in entries]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in d[group]]
        assert len(group_names) == len(set(group_names))
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in entries:
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_cells_configs_and_metrics_fit_together(bench):
    d = bench.data
    configs = {c["name"] for c in d["configs"]}
    cells = {w["name"] for w in d["workloads"]}
    assert {w["config"] for w in d["workloads"]} == configs  # every config has a cell
    assert len({(w["config"], w["traffic"]) for w in d["workloads"]}) == len(cells)
    assert all(w["chips"] == 1 for w in d["workloads"])
    e2e = {m["name"]: m for m in d["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in d["end_to_end"])
    assert all(m["source"] in ("host_clock", "device_trace") for m in d["end_to_end"])
    for cell in d["workloads"]:
        reported = bench.end_to_end(cell)
        assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)
        assert bench.per_layer(cell)
    for m in d["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for cell in m["workloads"]:  # each cell of the metric reports what it moves
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        assert m["layer"] in bench.layers, m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_name_has_its_file(bench):
    for cell in bench.data["workloads"]:
        config = bench.config(cell)
        assert config["name"] == cell["config"]
        assert config["reduced"] == []
        traffic = bench.traffic(cell)
        assert hasattr(bench.entry(traffic), "measure")
    for c in bench.data["configs"]:
        assert c["file"].startswith("dabench/configs/") and (ROOT / c["file"]).is_file()
    for m in bench.data["per_layer"]:
        assert callable(bench.reader(m).read)


def test_roofline_names_carry_their_unit(bench):
    for m in bench.data["per_layer"]:
        if "roofline" in m["name"] or "idle_pct" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("kind", ["config", "traffic", "layer", "metric"])
def test_adding_a_file_needs_no_edit(tmp_path, kind):
    """A dummy of each kind, added as a new file in a copy of the
    benchmark, is found by its name with no existing file changed."""
    shutil.copytree(ROOT / "dabench", tmp_path / "dabench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "dabench").rglob("*") if p.is_file()}
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    pkg = tmp_path / "dabench"
    cell = dict(data["workloads"][0])
    if kind == "config":
        cfg = json.loads((ROOT / data["configs"][0]["file"]).read_text())
        cfg["name"] = "dummy-k64"
        cfg["square_size"] = 64
        (pkg / "configs" / "dummy-k64.json").write_text(json.dumps(cfg))
        data["configs"].append({**data["configs"][0], "name": "dummy-k64",
                                "file": "dabench/configs/dummy-k64.json"})
        cell.update(name="dummy-cell", config="dummy-k64")
    elif kind == "traffic":
        (pkg / "traffic" / "dummy-mix.json").write_text(
            (pkg / "traffic" / f"{cell['traffic']}.json").read_text())
        cell.update(name="dummy-cell", traffic="dummy-mix")
    elif kind == "layer":
        (pkg / "layers" / "dummy.json").write_text(
            json.dumps({"layer": "dummy layer", "kernels": ["dummy_kernel"]}))
    else:
        (pkg / "layer_metrics" / "dummy.metric.replay.py").write_text(
            "def read(view):\n    return 42.0\n")
        data["per_layer"].append({**data["per_layer"][0], "name": "dummy.metric.replay"})
    if cell["name"] == "dummy-cell":
        data["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    for c in data["configs"]:
        if not (tmp_path / c["file"]).exists():
            (tmp_path / c["file"]).write_text((ROOT / c["file"]).read_text())
    bench = Bench(tmp_path, pkg)
    if kind == "config":
        assert bench.config(bench.cell("dummy-cell"))["square_size"] == 64
    elif kind == "traffic":
        assert bench.traffic(bench.cell("dummy-cell")) == bench.traffic(data["workloads"][0])
    elif kind == "layer":
        assert bench.layers["dummy layer"].owns("void dummy_kernel<16>(int)")
    else:
        metric = next(m for m in bench.data["per_layer"] if m["name"] == "dummy.metric.replay")
        assert bench.reader(metric).read(None) == 42.0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_load_module_takes_dotted_file_names(tmp_path):
    (tmp_path / "pkg").mkdir()
    path = tmp_path / "pkg" / "a.b.c.py"
    path.write_text("X = 7\n")
    assert load_module(path).X == 7
