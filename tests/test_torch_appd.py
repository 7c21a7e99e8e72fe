"""The port's daemon (cmd/appd.py) and its config (cmd/config.py), held
against the JAX package's.

Config: the files `write_default_configs` writes, what `load_configs` reads
back from an edited file, the CLI > CELESTIA_* env > file > default
resolution, and the min gas price parse (errors included) are the same in
both packages.  Daemon: the JAX `main(argv)` and the port's (`--device
cpu`) run the same command sequence in process, with each module's clock
patched to the same sequence of nanoseconds (genesis time, block times):
init, start with snapshots, status, rollback, export, start again,
snapshot create / list / restore and check-invariants give the same stdout
JSON and the same home files byte for byte.  A home written by either
daemon loads in the other at the same height and app hash, and the next
block either daemon commits on it is the same.  Without `--device`, the
port's daemon asks for CUDA and raises here.  One test runs the module
entry, `python -m celestia_app_tpu_torch.cmd.appd --device cpu`, in a
subprocess; its `launches` lines are all zero on the CPU.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax
import pytest

from celestia_app_tpu.cmd import appd as jax_appd
from celestia_app_tpu.cmd import config as jax_config
from celestia_app_tpu_torch.cmd import appd, config

ROOT = Path(__file__).resolve().parent.parent
T0_NS = 1_700_000_000 * 10**9
CHAIN = "appd-chain"


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Free the JAX programs compiled while this module ran, when it ends
    (each loaded XLA:CPU executable holds many memory mappings)."""
    yield
    jax.clear_caches()
    gc.collect()


# --- config ----------------------------------------------------------------


def test_default_config_files_equal_jax(tmp_path):
    paths = [config.write_default_configs(str(tmp_path / "port")),
             jax_config.write_default_configs(str(tmp_path / "jax"))]
    for mine, theirs in zip(*paths):
        assert Path(mine).read_bytes() == Path(theirs).read_bytes()
    for home in ("port", "jax"):
        path = tmp_path / home / "config" / "app.toml"
        path.write_text(path.read_text().replace("snapshot_interval = 1500",
                                                 "snapshot_interval = 77")
                        .replace('"0.002utia"', '"0.5uatom,0.004utia"'))
    got = [tuple(c.__dict__ for c in config.load_configs(str(tmp_path / "port")))]
    want = [tuple(c.__dict__ for c in jax_config.load_configs(str(tmp_path / "jax")))]
    assert repr(got) == repr(want)
    _, app_cfg = config.load_configs(str(tmp_path / "port"))
    assert app_cfg.statesync.snapshot_interval == 77


@pytest.mark.parametrize("cli,env,file", [(5, "7", 9), (None, "7", 9), (None, None, 9),
                                          (None, None, None)])
def test_option_resolution_equal_jax(monkeypatch, cli, env, file):
    """CLI > CELESTIA_<key> env > config file > default, in both."""
    if env is None:
        monkeypatch.delenv("CELESTIA_SNAPSHOT_INTERVAL", raising=False)
    else:
        monkeypatch.setenv("CELESTIA_SNAPSHOT_INTERVAL", env)
    got = config.resolve_option(cli, "SNAPSHOT_INTERVAL", file, 1500, cast=int)
    assert got == jax_config.resolve_option(cli, "SNAPSHOT_INTERVAL", file, 1500, cast=int)
    assert got == next(v for v in (cli, env and int(env), file, 1500) if v is not None)


@pytest.mark.parametrize("prices", ["0.002utia", "1uatom, 0.25utia", "utia", "1e3utia",
                                    "0.1uatom"])
def test_min_gas_price_equal_jax(prices):
    def parse(mod):
        try:
            return mod.min_gas_price_from_config(mod.AppTomlConfig(min_gas_prices=prices)).raw
        except ValueError as e:
            return str(e)

    assert parse(config) == parse(jax_config)


# --- the daemon in process ---------------------------------------------------


class Clock:
    """The `time` a daemon module sees: time_ns walks T0_NS in 15 s steps,
    every other attribute is the real module's."""

    def __init__(self):
        self.ns = T0_NS

    def time_ns(self) -> int:
        self.ns += 15 * 10**9
        return self.ns

    def __getattr__(self, name):
        return getattr(time, name)


def run(mod, home, *argv) -> tuple[int, str]:
    """(exit code, stdout) of `mod.main` on `home`; the port's on the CPU."""
    device = ("--device", "cpu") if mod is appd else ()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = mod.main(["--home", str(home), *device, *argv])
    return code, out.getvalue()


def home_files(home: Path) -> dict:
    return {str(p.relative_to(home)): p.read_bytes() for p in sorted(home.rglob("*"))
            if p.is_file()}


SEQUENCE = (
    ("init", CHAIN, "--gov-max-square-size", "4"),
    ("start", "--blocks", "4", "--no-sleep", "--warmup", "none", "--snapshot-interval", "2"),
    ("status",),
    ("rollback",),
    ("status",),
    ("export",),
    ("start", "--blocks", "2", "--no-sleep", "--warmup", "none", "--snapshot-interval", "3"),
    ("snapshot", "create"),
    ("snapshot", "list"),
    ("snapshot", "restore", "--height", "4"),
    ("status",),
    ("check-invariants",),
    ("query-balance", "celestia1none"),
)


@pytest.fixture(scope="module")
def homes(tmp_path_factory):
    """The JAX and the port home after SEQUENCE, each step's exit code and
    stdout."""
    base = tmp_path_factory.mktemp("appd")
    mp = pytest.MonkeyPatch()
    out = {}
    for name, mod in (("jax", jax_appd), ("port", appd)):
        mp.setattr(mod, "time", Clock())
        home = base / name
        steps = [run(mod, home, *argv) for argv in SEQUENCE]
        out[name] = (home, steps)
    mp.undo()
    return out


@pytest.mark.parametrize("step", range(len(SEQUENCE)),
                         ids=[" ".join(argv[:2]) for argv in SEQUENCE])
def test_command_equal_jax(homes, step):
    (jax_home, jax_steps), (home, steps) = homes["jax"], homes["port"]
    (code, stdout), (jax_code, jax_stdout) = steps[step], jax_steps[step]
    assert code == jax_code == 0
    mine = [line for line in stdout.splitlines() if not line.startswith("launches ")]
    assert [line.replace(str(home), "H") for line in mine] == \
        [line.replace(str(jax_home), "H") for line in jax_stdout.splitlines()]


def test_homes_equal_jax(homes):
    (jax_home, _), (home, steps) = homes["jax"], homes["port"]
    files = home_files(home)
    assert files == home_files(jax_home)
    assert {"config/genesis.json", "config/config.toml", "config/app.toml", "data/state.json",
            "data/app_meta.json", "data/snapshots/4.json", "data/snapshots/5.json"} <= set(files)
    assert json.loads(files["data/app_meta.json"])["height"] == 4
    launches = [json.loads(line.split(" ", 1)[1]) for _, stdout in steps
                for line in stdout.splitlines() if line.startswith("launches ")]
    assert len(launches) == 6 and all(v == 0 for row in launches for v in row.values())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_home_loads_in_the_other_package(tmp_path, writer):
    """A home written by one daemon resumes in the other at the same height
    and app hash, and the next block is the same from either daemon."""
    write, other = (jax_appd, appd) if writer == "jax" else (appd, jax_appd)
    mp = pytest.MonkeyPatch()
    try:
        clocks = {}
        for mod in (jax_appd, appd):
            clocks[mod] = Clock()
            mp.setattr(mod, "time", clocks[mod])
        home = tmp_path / "home"
        assert run(write, home, "init", CHAIN)[0] == 0
        assert run(write, home, "start", "--blocks", "2", "--no-sleep", "--warmup", "none")[0] == 0
        loaded = (appd.load_app(str(home), device="cpu") if other is appd
                  else jax_appd.load_app(str(home)))
        source = (appd.load_app(str(home), device="cpu") if write is appd
                  else jax_appd.load_app(str(home)))
        assert (loaded.height, loaded.cms.last_app_hash, loaded.last_block_time_ns) == \
            (source.height, source.cms.last_app_hash, source.last_block_time_ns) and \
            loaded.height == 2
        copy = tmp_path / "copy"
        shutil.copytree(home, copy)
        clocks[other].ns = clocks[write].ns
        assert run(write, home, "start", "--blocks", "1", "--no-sleep", "--warmup", "none")[0] == 0
        assert run(other, copy, "start", "--blocks", "1", "--no-sleep", "--warmup", "none")[0] == 0
        assert home_files(home) == home_files(copy)
        assert json.loads(home_files(copy)["data/app_meta.json"])["height"] == 3
    finally:
        mp.undo()


def test_pfb_and_balance_on_the_ports_signer(tmp_path):
    blob = tmp_path / "blob.bin"
    blob.write_bytes(bytes(range(256)) * 3)
    home = tmp_path / "home"
    assert run(appd, home, "init", CHAIN, "--gov-max-square-size", "4")[0] == 0
    addr = appd.PrivateKey.from_seed(f"{CHAIN}-account-0".encode()).public_key().address()
    code, stdout = run(appd, home, "tx-pay-for-blob", "--file", str(blob), "--namespace", "0a0b")
    result = json.loads(stdout)
    assert code == 0 and result["code"] == 0 and result["height"] == 1
    assert result["square_size"] == 2 and result["gas_used"] > 0
    balance = json.loads(run(appd, home, "query-balance", addr)[1])["balance"]
    assert 0 < balance < 10**12


def test_the_default_device_is_cuda(tmp_path):
    """Without --device the port's daemon asks for CUDA: here, with no card,
    it raises, and never carries on on the CPU."""
    home = tmp_path / "home"
    assert run(appd, home, "init", CHAIN)[0] == 0
    for argv in (("status",), ("start", "--blocks", "1", "--no-sleep")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            appd.main(["--home", str(home), *argv])
    assert not (home / "data" / "state.json").exists()


def test_module_entry_on_the_cpu(tmp_path):
    home = tmp_path / "home"
    assert run(appd, home, "init", CHAIN, "--gov-max-square-size", "4")[0] == 0
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "celestia_app_tpu_torch.cmd.appd", "--device", "cpu",
         "--home", str(home), "start", "--blocks", "2", "--no-sleep", "--warmup", "minimal"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert any(line.startswith("warmed square sizes [1, 4]") for line in lines)
    assert [line.split()[0] for line in lines if line.startswith("height=")] == \
        ["height=1", "height=2"]
    launches = [json.loads(line.split(" ", 1)[1]) for line in lines if line.startswith("launches ")]
    assert len(launches) == 2 and all(v == 0 for row in launches for v in row.values())
    assert "jax" not in out.stderr
