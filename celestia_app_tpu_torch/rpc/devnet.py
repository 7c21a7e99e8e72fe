"""Multi-process devnet: N validators exchanging proposals over sockets.

The reference's testnode Network starts real nodes with RPC/gRPC servers on
random ports (test/util/testnode/network.go:20-43); its multi-validator
tier runs containers. This devnet is the socket tier for this framework:
each validator is its OWN PROCESS serving JSON-RPC, block production
rotates by height, and every block is replicated over HTTP with app-hash /
data-root equality enforced (ReplicationDivergence otherwise).

Run one validator:   python -m celestia_app_tpu_torch.rpc.devnet --index 0 \
                        --n 3 --ports 26800,26801,26802 [--device cpu]
Spawn a whole devnet in-code (tests): `spawn_devnet(n=3)`.

All validators derive the identical deterministic genesis from the shared
seed set (testutil.testnode.deterministic_genesis), so chain state agrees
from height 0 without any genesis-distribution step.

The port's copy of celestia_app_tpu/rpc/devnet.py, with three deliberate
differences:
  * kernels are built once, and loudly: where the JAX parent pre-warms its
    compile cache in a throwaway child whose failure it ignores, the port's
    parent calls kernels/_build.build() once before it spawns, and a failed
    build raises.  _build serialises builds only within a process, so the
    children, which find every library built, never run nvcc at once;
  * the device is explicit: `run_validator`, `spawn_devnet` and `main` take
    a device (default CUDA; the CPU tests pass "cpu"), on which each child's
    App runs and `da.eds.warmup([1, 2, 4])` pays the first calls.  A child
    serves its RPC only once warmed, so the startup barrier also waits out
    every peer's warm-up and no first extend sits under a node lock inside
    a round timeout;
  * a child's fault stays visible: each child's stdout and stderr go to a
    log file beside the devnet (`Devnet.logs`), not to /dev/null; in push
    mode the produce loop lets a device.DeviceFault end the process, and
    `Devnet.exited()` / `Devnet.check()` report a child that exited, with
    its log.  Each child also logs its own kernel launches at every new
    committed height (`Devnet.launches`), since its counters live in its
    process.  Ports are free ones picked at spawn (`--ports`), not a fixed
    base; a child that finds its port taken in the meantime makes the
    spawn start over once more with fresh ports.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from celestia_app_tpu_torch.da.eds import warmup
from celestia_app_tpu_torch.device import DeviceFault
from celestia_app_tpu_torch.kernels import _build
from celestia_app_tpu_torch.rpc.client import RemoteNode
from celestia_app_tpu_torch.rpc.server import ServingNode, serve
from celestia_app_tpu_torch.testutil.testnode import deterministic_genesis, funded_keys

#: The directory that holds the package: children run from it, so that
#: `python -m celestia_app_tpu_torch.rpc.devnet` imports this checkout.
_ROOT = Path(__file__).resolve().parents[2]


#: A child's launch report: `validator <i> height <h> launches <json>`.
_LAUNCH_LINE = re.compile(r"^validator \d+ height (\d+) launches (\{.*\})$", re.M)

#: Spawn attempts when the ports are picked here (a port taken between the
#: pick and the child's bind fails only that attempt).
_SPAWN_ATTEMPTS = 3


def _url(port: int) -> str:
    return f"http://127.0.0.1:{port}"


def _report_height(node: ServingNode, index: int, last: int) -> int:
    """Print this process's kernel launches when the committed height has
    moved past `last`; returns the height."""
    with node.lock:
        height = node.app.height
        launches = dict(_build.LAUNCHES)
    if height != last:
        print(f"validator {index} height {height} launches "
              f"{json.dumps(launches, sort_keys=True)}", flush=True)
    return height


def free_ports(n: int) -> list[int]:
    """n distinct localhost ports that were free when asked."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def run_validator(
    index: int,
    n: int,
    ports: list[int],
    block_interval_ms: int = 300,
    n_accounts: int = 4,
    mode: str = "gossip",
    peer_indices: list[int] | None = None,
    wal_dir: str | None = None,
    device=None,
) -> None:
    """Serve validator `index` of `n` on `ports[index]`; blocks until killed.

    mode="gossip" (default): the multi-round Tendermint machine over p2p
    flood gossip (rpc/gossip.py) — survives proposer crashes via round
    changes.  mode="push": the legacy proposer-push round (one round per
    height, the round-1/2 plane).  `peer_indices` restricts this node's
    peer list (partial topologies, e.g. a ring, to exercise multi-hop
    relay); default is fully connected.  `wal_dir` enables the
    double-sign WAL (one file per validator index).  `device` is the App's
    (None: CUDA).
    """
    keys = funded_keys(n_accounts)
    if peer_indices is None:
        peer_indices = [j for j in range(n) if j != index]
    node = ServingNode(
        genesis=deterministic_genesis(keys, n_validators=n),
        keys=keys,
        validator_index=index,
        n_validators=n,
        peers=[_url(ports[j]) for j in peer_indices],
        device=device,
    )
    driver = None
    if mode == "gossip":
        driver = node.enable_gossip_consensus(
            interval_s=block_interval_ms / 1000.0,
            wal_path=(
                os.path.join(wal_dir, f"wal-{index}.jsonl")
                if wal_dir else None
            ),
        )
    # Warm-up BEFORE serving (SURVEY §7 hard part 4: first calls must never
    # sit on the block path — a first extend under the node lock stalls
    # every round timeout).  Small sizes cover empty and near-empty devnet
    # blocks.
    warmup([1, 2, 4], device=node.app.device)
    print(f"validator {index} warmed on {node.app.device}", flush=True)
    server = serve(node, port=ports[index], block_interval_s=None)
    print(f"validator {index}/{n} serving on {server.url} ({mode})", flush=True)

    # Startup barrier: wait for every peer to serve (and so to be warm)
    # before proposing.
    for peer_url in node.peer_urls:
        peer = RemoteNode(peer_url, defer_status=True, timeout=2.0)
        deadline = time.monotonic() + 120
        while True:
            try:
                peer.status()
                break
            except Exception:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"peer {peer_url} never came up")
                time.sleep(0.1)
    print(f"validator {index} peers up", flush=True)
    last = _report_height(node, index, -1)

    if driver is not None:
        driver.start()
        while True:  # the driver's timers run the chain
            with node.commit_event:
                node.commit_event.wait(timeout=0.1)
            last = _report_height(node, index, last)

    interval = block_interval_ms / 1000.0
    while True:
        time.sleep(interval)
        try:
            if node.is_proposer(node.app.height + 1):
                node.produce_block()
        except DeviceFault:
            raise  # the card failed: end the process, the parent sees it
        except Exception as e:  # noqa: BLE001 — keep serving; surface the fault
            print(f"validator {index} produce error: {e}", file=sys.stderr, flush=True)
        last = _report_height(node, index, last)


class Devnet:
    """Handle to spawned validator processes and their log files."""

    def __init__(self, procs: list[subprocess.Popen], urls: list[str],
                 logs: list[str] | None = None):
        self.procs = procs
        self.urls = urls
        self.logs = logs or []

    def client(self, i: int = 0) -> RemoteNode:
        return RemoteNode(self.urls[i])

    def log(self, i: int) -> str:
        """Validator i's output so far (stdout and stderr)."""
        try:
            return Path(self.logs[i]).read_text(errors="replace")
        except (IndexError, OSError):
            return ""

    def launches(self, i: int) -> list[tuple[int, dict]]:
        """(height, kernel launches so far) of every launch report in
        validator i's log, oldest first."""
        return [(int(h), json.loads(d)) for h, d in _LAUNCH_LINE.findall(self.log(i))]

    def launches_across(self, i: int, height: int) -> tuple[int, int, dict]:
        """(lo, hi, launches) of validator i's own process between its two
        consecutive reports at heights lo < `height` <= hi; hi > lo + 1 when
        several heights committed between two reports.  Raises if the log
        has no such pair yet."""
        reports = self.launches(i)
        for (lo, before), (hi, after) in zip(reports, reports[1:]):
            if lo < height <= hi:
                return lo, hi, {k: after[k] - before.get(k, 0) for k in after}
        raise LookupError(f"validator {i} has no launch reports around height {height}")

    def exited(self) -> list[tuple[int, int]]:
        """(index, exit code) of every validator that is no longer running."""
        return [(i, p.returncode) for i, p in enumerate(self.procs) if p.poll() is not None]

    def check(self) -> None:
        """Raise if a validator exited, naming it and carrying its log."""
        gone = self.exited()
        if gone:
            raise RuntimeError("devnet validators exited: " + "; ".join(
                f"{i} (exit {rc}):\n{self.log(i)[-4000:]}" for i, rc in gone))

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def spawn_devnet(
    n: int = 3,
    ports: list[int] | None = None,
    block_interval_ms: int = 300,
    wait_s: float = 120.0,
    env: dict | None = None,
    mode: str = "gossip",
    topology: dict[int, list[int]] | None = None,
    device=None,
    log_dir: str | None = None,
) -> Devnet:
    """Launch n validator processes on `device` (None: CUDA); returns once
    all serve their RPC (and so are warm).

    `ports` defaults to n free ports, picked again (up to _SPAWN_ATTEMPTS
    spawns) when a child finds its port taken before it binds; given
    ports are used once.  `topology` maps validator index -> peer indices
    (partial meshes, e.g. a ring for multi-hop relay tests), default fully
    connected.  Each child writes its output to
    `log_dir`/validator-<i>.log (default: a fresh temporary directory).
    On the card the kernels are built here, once, before any child starts;
    a failed build raises.
    """
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("spawn_devnet: no CUDA device (pass device='cpu')")
        _build.build()
    log_dir = log_dir or tempfile.mkdtemp(prefix="celestia-devnet-")
    os.makedirs(log_dir, exist_ok=True)
    child_env = dict(os.environ if env is None else env)
    attempts = 1 if ports is not None else _SPAWN_ATTEMPTS
    attempt = 1
    while True:
        use = list(ports) if ports is not None else free_ports(n)
        procs, logs = [], []
        for i in range(n):
            cmd = [
                sys.executable, "-m", "celestia_app_tpu_torch.rpc.devnet",
                "--index", str(i), "--n", str(n),
                "--ports", ",".join(str(p) for p in use),
                "--block-interval-ms", str(block_interval_ms),
                "--mode", mode, "--device", str(dev),
            ]
            if topology is not None:
                cmd += ["--peers", ",".join(str(j) for j in topology[i])]
            path = os.path.join(log_dir, f"validator-{i}.log")
            logs.append(path)
            with open(path, "wb") as out:
                procs.append(subprocess.Popen(
                    cmd, env=child_env, cwd=str(_ROOT),
                    stdout=out, stderr=subprocess.STDOUT,
                ))
        net = Devnet(procs, [_url(p) for p in use], logs)
        try:
            _wait_serving(net, time.monotonic() + wait_s)
            return net
        except RuntimeError as e:
            net.stop()
            if attempt == attempts or "Address already in use" not in str(e):
                raise
            attempt += 1
        except BaseException:
            net.stop()
            raise


def _wait_serving(net: Devnet, deadline: float) -> None:
    """Return once every validator serves; raise if one exits first
    (RuntimeError, with its log) or the deadline passes."""
    for u in net.urls:
        peer = RemoteNode(u, defer_status=True, timeout=2.0)
        while True:
            net.check()
            try:
                peer.status()
                break
            except Exception:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"validator at {u} never served")
                time.sleep(0.2)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="celestia devnet validator (PyTorch port)")
    ap.add_argument("--index", type=int, required=True)
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--ports", required=True,
                    help="comma-separated port of every validator, by index")
    ap.add_argument("--block-interval-ms", type=int, default=300)
    ap.add_argument("--mode", choices=["gossip", "push"], default="gossip")
    ap.add_argument("--peers", default=None,
                    help="comma-separated peer indices (default: all others)")
    ap.add_argument("--wal-dir", default=None,
                    help="directory for the double-sign WAL (off if unset)")
    ap.add_argument("--device", default="cuda",
                    help="the App's device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    ports = [int(x) for x in args.ports.split(",")]
    peer_indices = (
        [int(x) for x in args.peers.split(",") if x != ""]
        if args.peers is not None
        else None
    )
    run_validator(
        args.index, args.n, ports, args.block_interval_ms,
        mode=args.mode, peer_indices=peer_indices, wal_dir=args.wal_dir,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
