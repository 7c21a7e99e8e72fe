"""What the benchmark may import: nothing under dabench/ names jax, jaxlib,
flax or the JAX package (top-level names compared whole: the program's
celestia_app_tpu_torch is not celestia_app_tpu), and the reference imports
nothing of the program either."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from dabench import run

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


SOURCES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_anywhere(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "celestia_app_tpu"}


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"celestia_app_tpu_torch", "celestia_app_tpu"}
    assert all(name in {"__future__", "contextlib", "functools", "numpy", "torch", "dabench"}
               for name in _imports(path)), _imports(path)


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "celestia_app_tpu_torch_fake", object())
    assert "celestia_app_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "celestia_app_tpu.fake", object())
    assert "celestia_app_tpu" in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert "jaxlib" in run.forbidden_modules()


def test_a_harness_run_loads_no_jax():
    """The harness and the program, imported in a fresh interpreter, bring
    in no JAX module."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import dabench.harness, dabench.control, dabench.reference.eds\n"
            "from dabench.spec import Bench\n"
            "bench = Bench(%r)\n"
            "for cell in bench.data['workloads']:\n"
            "    bench.entry(bench.traffic(cell))\n"
            "for metric in bench.data['per_layer']:\n"
            "    bench.reader(metric)\n"
            "import celestia_app_tpu_torch.parallel, celestia_app_tpu_torch.da.repair\n"
            "from dabench.run import forbidden_modules\n"
            "print(forbidden_modules())" % (str(ROOT), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_run_prints_nothing():
    out = subprocess.run([sys.executable, "-m", "dabench.run", "--workload", "replay-k512",
                          "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""
