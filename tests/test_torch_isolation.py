"""The port imports nothing of JAX, nothing of the JAX package and nothing
of `cryptography` (the card's machine lacks it; the port's keys are its own).

Two checks: every module of celestia_app_tpu_torch (the multi-device plane,
the ABCI App and its block execution's keepers and IBC stack, the mempool,
the in-process node and its clients, the round machine, the vote WAL, the
chaos spec and the gossip-driven serving node, the protocol adversary, the
DAS provider, the healing loop and the height timeline, the gRPC plane, the
REST gateway, the daemon, the tools, the harnesses, the Blobstream
relayer, the operator's drivers and the leopard-parity tool under scripts/
included) imported in a
fresh interpreter leaves no `jax`, `celestia_app_tpu.*` or `cryptography`
module in sys.modules and no environment variable or sys.path entry
changed, and no source
of the port (nor chip_smoke.py) names one in an import statement, including
imports inside functions.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "celestia_app_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "celestia_app_tpu", "cryptography")

_IMPORT_ALL = """
import importlib, json, os, pkgutil, sys
import celestia_app_tpu_torch as port
env, path = dict(os.environ), list(sys.path)
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "celestia_app_tpu", "cryptography"))
env_changed = sorted(k for k in set(env) | set(os.environ) if env.get(k) != os.environ.get(k))
print(json.dumps({"imported": names, "forbidden": bad, "env_changed": env_changed,
                  "path_changed": path != sys.path}))
"""


def _top_level(name: str) -> str:
    return name.split(".")[0]


def test_importing_every_port_module_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "celestia_app_tpu_torch.da.repair" in result["imported"]
    assert "celestia_app_tpu_torch.serve.verify" in result["imported"]
    for name in ("inclusion.batched", "inclusion.commitment", "proof.querier",
                 "bridge.worker", "bridge.client", "parallel.mesh", "parallel.sharded_eds",
                 "parallel.sharded_repair", "kernels.panel_sharded", "serve.shard",
                 "app.app", "app.ante", "crypto.keys", "crypto.ripemd160", "tx.sign",
                 "tx.messages", "modules.blob.types", "state.store", "trace.tracer",
                 "testutil.blocks", "consensus.votes", "modules.gov", "modules.paramfilter",
                 "modules.authz", "modules.slashing.keeper", "modules.blobstream.keeper",
                 "app.module_manager", "modules.tokenfilter", "modules.ibc.core",
                 "modules.ibc.transfer", "modules.ibc.stack", "modules.ibc.client",
                 "modules.ibc.handshake", "modules.ibc.ica", "mempool", "qos",
                 "trace.square_journal", "trace.slo", "trace.device_ledger",
                 "testutil.testnode", "testutil.network", "user.errors", "user.signer",
                 "user.tx_client", "txsim.run", "consensus.machine", "consensus.wal",
                 "trace.round_journal", "trace.flight_recorder", "chaos", "chaos.spec",
                 "chaos.degrade", "rpc", "rpc.transport", "rpc.codec", "rpc.gossip",
                 "rpc.server", "rpc.client", "chaos.adversary", "serve.api", "serve.heal",
                 "trace.timeline", "rpc.grpc_plane", "rpc.api_gateway", "cmd.appd",
                 "cmd.config", "tools.blockscan", "tools.blocktime", "testutil.benchmark",
                 "testutil.malicious", "testutil.ibc", "crypto.keccak",
                 "modules.blobstream.evm", "modules.blobstream.relayer",
                 "scripts", "scripts.common", "scripts.chaos_soak", "scripts.das_loadgen",
                 "scripts.block_anatomy", "scripts.devnet_smoke", "scripts.trace_lint",
                 "scripts.verify_leopard_parity"):
        assert f"celestia_app_tpu_torch.{name}" in result["imported"]
    assert result["forbidden"] == []
    # Importing a module writes no environment variable and no sys.path
    # entry (the JAX drivers under scripts/ do both at import).
    assert result["env_changed"] == [] and not result["path_changed"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    assert not [n for n in names if _top_level(n) in FORBIDDEN], names


_WITHOUT_GRPC = """
import sys
sys.modules["grpc"] = None  # `import grpc` raises ImportError
import celestia_app_tpu_torch.rpc.api_gateway as gateway
import celestia_app_tpu_torch.rpc.grpc_plane as plane
page = plane._parse_page_request(b"", 2)
items, resp = plane._paginate([1, 2, 3], dict(page, limit=2, count_total=True))
assert items == [1, 2] and plane._parse_page_response(resp) == {"next_key": b"2", "total": 3}
try:
    plane.serve_grpc(object())
except ImportError:
    print("ok")
"""


def test_the_planes_import_without_grpc():
    """The gRPC plane imports grpcio only where a server or a channel is
    made; the REST gateway and the shared pagination run without it."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _WITHOUT_GRPC], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip() == "ok"
