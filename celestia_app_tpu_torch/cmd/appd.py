"""celestia-appd-tpu: the CLI daemon.

Parity with the reference cmd/celestia-appd surface (root.go:44-130):
`init` writes a home directory with genesis, `start` runs the single-process
node loop (produce -> self-validate -> finalize -> commit, persisting state
each block), `export` dumps app state, `rollback` drops the last height,
`status` prints chain info.  Env prefix CELESTIA_ (root.go:33); state
survives restarts via the commit-store snapshot (LoadHeight analog).

Usage:  python -m celestia_app_tpu_torch.cmd.appd [--home DIR] [--device D] <command> ...

The port's copy of celestia_app_tpu/cmd/appd.py, with two deliberate
differences:
  * the device is a flag, not an environment pin: where the JAX daemon sets
    `jax_platforms` from $JAX_PLATFORMS before importing its backend, the
    port's parser takes a global `--device` beside `--home`.  Its default
    is CUDA, on which every command's App runs its square path (and
    `start --warmup` pays its first calls); without a card it raises
    rather than carrying on on the CPU.  `--device cpu` runs the plain
    PyTorch versions of the kernels (the CPU tests);
  * `start` prints the kernel launches of each produced height, `launches
    {json}`, counted from zero just before that height (the warm-up's are
    not in them), so that a caller can see that each block went through the
    card's kernels (all zero with `--device cpu`).
Homes are the same files in both packages: a home written by one daemon
loads in the other at the same app hash.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from celestia_app_tpu_torch.app import App, Genesis, GenesisAccount
from celestia_app_tpu_torch.crypto import PrivateKey
from celestia_app_tpu_torch.kernels import _build
from celestia_app_tpu_torch.state.dec import Dec
from celestia_app_tpu_torch.state.staking import Validator
from celestia_app_tpu_torch.state.store import CommitStore

DEFAULT_HOME = os.path.expanduser(
    os.environ.get("CELESTIA_HOME", "~/.celestia-app-tpu")
)


def _genesis_path(home: str) -> str:
    return os.path.join(home, "config", "genesis.json")


def _state_path(home: str) -> str:
    return os.path.join(home, "data", "state.json")


def _meta_path(home: str) -> str:
    return os.path.join(home, "data", "app_meta.json")


def cmd_init(args) -> int:
    home = args.home
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    os.makedirs(os.path.join(home, "data"), exist_ok=True)
    keys = [PrivateKey.from_seed(f"{args.chain_id}-account-{i}".encode()) for i in range(args.accounts)]
    genesis = {
        "chain_id": args.chain_id,
        "genesis_time_ns": time.time_ns(),
        "app_version": 2,
        "gov_max_square_size": args.gov_max_square_size,
        "accounts": [
            {
                "address": k.public_key().address(),
                "balance": 10**12,
                "pubkey": k.public_key().bytes.hex(),
            }
            for k in keys
        ],
        "validators": [
            {
                "address": PrivateKey.from_seed(f"{args.chain_id}-val-{i}".encode())
                .public_key()
                .address(),
                "pubkey": PrivateKey.from_seed(f"{args.chain_id}-val-{i}".encode())
                .public_key()
                .bytes.hex(),
                "power": 100,
            }
            for i in range(args.validators)
        ],
    }
    with open(_genesis_path(home), "w") as f:
        json.dump(genesis, f, indent=2)
    from celestia_app_tpu_torch.cmd.config import write_default_configs

    cfg_path, app_cfg_path = write_default_configs(home)
    print(f"initialized chain {args.chain_id!r} at {home}")
    print(f"wrote {cfg_path} and {app_cfg_path}")
    return 0


def _load_genesis(home: str) -> Genesis:
    with open(_genesis_path(home)) as f:
        g = json.load(f)
    return Genesis(
        chain_id=g["chain_id"],
        genesis_time_ns=g["genesis_time_ns"],
        app_version=g.get("app_version", 2),
        gov_max_square_size=g.get("gov_max_square_size", 64),
        accounts=tuple(
            GenesisAccount(a["address"], a["balance"], bytes.fromhex(a.get("pubkey", "")))
            for a in g.get("accounts", [])
        ),
        validators=tuple(
            Validator(v["address"], bytes.fromhex(v.get("pubkey", "")), v["power"])
            for v in g.get("validators", [])
        ),
    )


def load_app(home: str, node_min_gas_price: Dec | None = None, device=None) -> App:
    """Construct the App from a home dir on `device` (None means CUDA and
    raises without a card), resuming committed state if any."""
    genesis = _load_genesis(home)
    app = App(node_min_gas_price=node_min_gas_price or Dec.from_str("0.000001"),
              device=device)
    if os.path.exists(_state_path(home)):
        app.cms = CommitStore.load(_state_path(home))
        with open(_meta_path(home)) as f:
            meta = json.load(f)
        app.chain_id = meta["chain_id"]
        app.height = meta["height"]
        app.app_version = meta["app_version"]
        app.genesis_time_ns = meta["genesis_time_ns"]
        app.last_block_time_ns = meta["last_block_time_ns"]
    else:
        app.init_chain(genesis)
        save_app(home, app)
    return app


def save_app(home: str, app: App) -> None:
    app.cms.save(_state_path(home))
    with open(_meta_path(home), "w") as f:
        json.dump(
            {
                "chain_id": app.chain_id,
                "height": app.height,
                "app_version": app.app_version,
                "genesis_time_ns": app.genesis_time_ns,
                "last_block_time_ns": app.last_block_time_ns,
            },
            f,
        )


def _snapshot_dir(home: str) -> str:
    return os.path.join(home, "data", "snapshots")


def _write_snapshot(home: str, app: App, keep: int = 2) -> str:
    """State-sync snapshot artifact (reference: every 1500 blocks, keep 2,
    app/default_overrides.go:293-297 + snapshot.Cmd at root.go:125)."""
    os.makedirs(_snapshot_dir(home), exist_ok=True)
    path = os.path.join(_snapshot_dir(home), f"{app.height}.json")
    with open(path, "w") as f:
        json.dump(
            {
                "height": app.height,
                "chain_id": app.chain_id,
                "app_version": app.app_version,
                "app_hash": app.cms.last_app_hash.hex(),
                "state": {k.hex(): v.hex() for k, v in app.cms.export().items()},
            },
            f,
        )
    existing = sorted(
        (int(p.split(".")[0]) for p in os.listdir(_snapshot_dir(home))), reverse=True
    )
    for h in existing[keep:]:
        os.remove(os.path.join(_snapshot_dir(home), f"{h}.json"))
    return path


def cmd_start(args) -> int:
    # Tier 2 (files) + tier 1 (CLI/env) resolution, viper-style precedence
    # (cmd/celestia-appd/cmd/root.go:33,55,72-80).
    from celestia_app_tpu_torch.cmd.config import (
        load_configs,
        min_gas_price_from_config,
        resolve_option,
    )

    consensus_cfg, app_cfg = load_configs(args.home)
    args.snapshot_interval = resolve_option(
        args.snapshot_interval, "SNAPSHOT_INTERVAL",
        app_cfg.statesync.snapshot_interval, 1500, cast=int,
    )
    args.block_interval = resolve_option(
        args.block_interval, "BLOCK_INTERVAL", None, 15.0, cast=float
    )
    # Min gas price resolves lazily tier by tier: a malformed app.toml must
    # not block a start that overrides it from the CLI or environment.
    cli_price = getattr(args, "min_gas_price", None)
    env_price = os.environ.get("CELESTIA_MIN_GAS_PRICE")
    if cli_price is not None:
        min_gas = Dec.from_str(cli_price)
    elif env_price is not None:
        min_gas = Dec.from_str(env_price)
    else:
        min_gas = min_gas_price_from_config(app_cfg)
    app = load_app(args.home, node_min_gas_price=min_gas, device=args.device)
    if args.warmup != "none":
        from celestia_app_tpu_torch.da.eds import warmup
        from celestia_app_tpu_torch.parallel.pipeline import env_batch_cap

        upto = app.max_effective_square_size()
        sizes = [1, upto] if args.warmup == "minimal" else None
        # A server running with $CELESTIA_PIPE_BATCH=B (or =auto, whose
        # ceiling is the auto batch) also warms the coalesced-dispatch
        # programs up to that cap, so the dispatcher's first batched
        # block never pays a compile on the block path.
        batch_cap = env_batch_cap()
        batches = tuple(range(2, batch_cap + 1)) if batch_cap > 1 else ()
        t0 = time.time()
        warmed = warmup(square_sizes=sizes, upto=None if sizes else upto,
                        batches=batches, device=args.device)
        # $CELESTIA_WARMUP_K: extra square sizes beyond the app's cap —
        # the giant-square knob.  An operator serving k=1024 blocks with
        # $CELESTIA_PIPE_PANEL set warms the panel lowering's programs
        # here (warmup resolves the mode PER SIZE) — and with
        # $CELESTIA_EXTEND_SHARDS on top, the SHARDED panel partition's
        # collective programs (kernels/panel_sharded.py) — so the first
        # giant block never eats the compile; without it the panel (or
        # collective) compiles would land on the block path (reference
        # TimeoutPropose is 10s).
        from celestia_app_tpu_torch.da.eds import extra_warmup_sizes

        extra = sorted(set(extra_warmup_sizes()) - set(warmed))
        if extra:
            warmed += warmup(square_sizes=extra, device=args.device)
        print(f"warmed square sizes {warmed} in {time.time() - t0:.1f}s"
              + (f" (incl. batch sizes {list(batches)})" if batches else ""),
              flush=True)
    node = None
    peers = [u for u in (getattr(args, "peers", "") or "").split(",") if u]
    if peers and not getattr(args, "n_validators", 0):
        # A peer list without the network size would quietly run a
        # single-validator valset that self-commits with a quorum of one
        # and forks from the network it was told to join.
        print("FATAL: --peers requires --n-validators (the network's "
              "total validator count)", file=sys.stderr)
        return 1
    if (getattr(args, "grpc", False) or getattr(args, "api", False)) and not (
        getattr(args, "serve", False) or peers
    ):
        print("FATAL: --grpc/--api require --serve (the planes share the "
              "serving node)", file=sys.stderr)
        return 1
    if getattr(args, "serve", False) or peers:
        from celestia_app_tpu_torch.rpc.server import ServingNode, serve as rpc_serve

        node = ServingNode(
            app=app,
            validator_index=getattr(args, "validator_index", 0),
            n_validators=getattr(args, "n_validators", 1) or 1,
            peers=peers,
        )
        server = rpc_serve(node, port=args.rpc_port, block_interval_s=None)
        print(f"RPC serving on {server.url}", flush=True)
        if getattr(args, "grpc", False):
            from celestia_app_tpu_torch.rpc.grpc_plane import serve_grpc

            grpc_plane = serve_grpc(node, port=getattr(args, "grpc_port", 0))
            print(f"gRPC serving on {grpc_plane.target} "
                  f"(debug {grpc_plane.debug_url})", flush=True)
        if getattr(args, "api", False):
            from celestia_app_tpu_torch.rpc.api_gateway import serve_api

            api_gw = serve_api(node, port=getattr(args, "api_port", 0))
            print(f"API serving on {api_gw.url}", flush=True)
    if peers:
        # Multi-validator mode: consensus runs through the gossip round
        # machine (rpc/gossip.py) — this daemon is one validator of a
        # network, like `celestia-appd start` joining a chain.  The WAL
        # (double-sign protection) lives under the home dir.
        wal_path = os.path.join(args.home, "data", "consensus-wal.jsonl")
        driver = node.enable_gossip_consensus(
            interval_s=args.block_interval if not args.no_sleep else 0.05,
            wal_path=wal_path,
        )
        from celestia_app_tpu_torch.rpc.client import RemoteNode

        for peer_url in peers:
            # Bounded exponential backoff with deterministic jitter: a
            # peer that takes a minute to warm its jit cache should not be
            # hammered 5x/second the whole time, and when the wait DOES
            # time out the operator sees the last underlying error (DNS?
            # connection refused? a 500?) instead of a bare deadline.
            peer = RemoteNode(peer_url, defer_status=True, timeout=2.0)
            deadline = time.time() + 120
            delay, attempt, last_err = 0.2, 0, None
            while True:
                try:
                    peer.status()
                    break
                except Exception as e:  # chaos-ok: peer warm-up probe loop
                    last_err = e
                    if time.time() > deadline:
                        raise TimeoutError(
                            f"peer {peer_url} never came up after "
                            f"{attempt + 1} attempts "
                            f"(last error: {type(e).__name__}: {e})"
                        ) from e
                    import hashlib

                    digest = hashlib.sha256(
                        f"{peer_url}:{attempt}".encode()
                    ).digest()
                    jitter = 0.25 * delay * (digest[0] / 255.0)
                    time.sleep(min(delay + jitter, 5.0))
                    delay = min(delay * 2, 5.0)
                    attempt += 1
        driver.start()
        print(f"gossip consensus started (wal: {wal_path})", flush=True)
        last_saved = app.height
        try:
            while True:
                time.sleep(max(args.block_interval, 1.0))
                with node.lock:
                    if app.height != last_saved:
                        save_app(args.home, app)
                        last_saved = app.height
        except KeyboardInterrupt:
            return 0
    print(f"chain {app.chain_id} at height {app.height}, producing blocks...",
          flush=True)
    produced = 0
    while args.blocks == 0 or produced < args.blocks:
        _build.reset_launches()
        time_ns = max(time.time_ns(), app.last_block_time_ns + 1)
        if node is not None:
            # Served mode: production goes through the node so mempool txs
            # from RPC broadcasts are included and indexed for tx queries
            # (produce_block runs the full propose/validate/commit round).
            # Same wall-clock block time as the manual path below — chain
            # time must not depend on the serving mode.
            data, _ = node.produce_block(time_ns=time_ns)
        else:
            data = app.prepare_proposal([])
            if not app.process_proposal(data):
                print("FATAL: node rejected its own proposal", file=sys.stderr)
                return 1
            app.finalize_block(time_ns, list(data.txs))
            app.commit()
        # Under --serve, RPC handler threads can also commit blocks; hold
        # the node lock so the on-disk snapshot is never torn mid-commit.
        with node.lock if node is not None else contextlib.nullcontext():
            save_app(args.home, app)
            if args.snapshot_interval and app.height % args.snapshot_interval == 0:
                _write_snapshot(args.home, app)
        produced += 1
        print(
            f"height={app.height} square={data.square_size} "
            f"data_root={data.hash.hex()[:16]}... app_hash={app.cms.last_app_hash.hex()[:16]}..."
        )
        print(f"launches {json.dumps(dict(_build.LAUNCHES), sort_keys=True)}", flush=True)
        if args.blocks == 0 or produced < args.blocks:
            time.sleep(args.block_interval if not args.no_sleep else 0)
    return 0


def cmd_snapshot(args) -> int:
    if args.action == "create":
        app = load_app(args.home, device=args.device)
        print(f"wrote {_write_snapshot(args.home, app)}")
        return 0
    if args.action == "list":
        d = _snapshot_dir(args.home)
        for p in sorted(os.listdir(d)) if os.path.isdir(d) else []:
            print(p)
        return 0
    # restore: load a snapshot as the working state (state-sync join).
    path = os.path.join(_snapshot_dir(args.home), f"{args.height}.json")
    with open(path) as f:
        snap = json.load(f)
    app = load_app(args.home, device=args.device)
    app.cms = CommitStore()
    app.cms._committed[snap["height"]] = {
        bytes.fromhex(k): bytes.fromhex(v) for k, v in snap["state"].items()
    }
    app.cms.load_height(snap["height"])
    app.height = snap["height"]
    app.app_version = snap["app_version"]
    save_app(args.home, app)
    print(f"restored height {app.height} (app_hash {app.cms.last_app_hash.hex()[:16]}...)")
    return 0


def cmd_status(args) -> int:
    app = load_app(args.home, device=args.device)
    print(
        json.dumps(
            {
                "chain_id": app.chain_id,
                "height": app.height,
                "app_version": app.app_version,
                "app_hash": app.cms.last_app_hash.hex(),
            },
            indent=2,
        )
    )
    return 0


def cmd_export(args) -> int:
    app = load_app(args.home, device=args.device)
    state = {k.hex(): v.hex() for k, v in app.cms.export().items()}
    json.dump(
        {"height": app.height, "chain_id": app.chain_id, "state": state},
        sys.stdout,
        indent=2,
    )
    print()
    return 0


def cmd_check_invariants(args) -> int:
    """x/crisis on demand (the sdk's MsgVerifyInvariant / invariant-check
    path): run every registered module invariant against committed state."""
    from celestia_app_tpu_torch.modules.crisis import InvariantBroken, assert_invariants

    app = load_app(args.home, device=args.device)
    try:
        names = assert_invariants(app.cms.working)
    except InvariantBroken as e:
        print(f"INVARIANT BROKEN at height {app.height}: {e}", file=sys.stderr)
        return 1
    print(f"ok: {len(names)} invariants hold at height {app.height}: "
          + ", ".join(names))
    return 0


def cmd_rollback(args) -> int:
    app = load_app(args.home, device=args.device)
    if app.height == 0:
        print("nothing to roll back", file=sys.stderr)
        return 1
    # Reference rollback (cmd root.go:129 via sdk server): drop last height.
    app.cms.rollback()
    app.height = app.cms.last_height
    save_app(args.home, app)
    print(f"rolled back to height {app.height}")
    return 0


def cmd_tx_pfb(args) -> int:
    """Single-node devnet PFB submission (BASELINE config 1; reference CLI
    x/blob/client/cli/payforblob.go:43): build, sign with a genesis dev key,
    run one block, verify inclusion, persist."""
    from celestia_app_tpu_torch.crypto import PrivateKey
    from celestia_app_tpu_torch.modules.blob.types import estimate_gas
    from celestia_app_tpu_torch.shares.namespace import Namespace
    from celestia_app_tpu_torch.shares.sparse import Blob
    from celestia_app_tpu_torch.state.accounts import AuthKeeper
    from celestia_app_tpu_torch.user.signer import Signer

    app = load_app(args.home, device=args.device)
    with open(_genesis_path(args.home)) as f:
        chain_id = json.load(f)["chain_id"]
    key = PrivateKey.from_seed(f"{chain_id}-account-{args.account}".encode())
    addr = key.public_key().address()
    acc = AuthKeeper(app.cms.working).get_account(addr)
    if acc is None:
        print(f"dev account {addr} not in genesis", file=sys.stderr)
        return 1

    data = open(args.file, "rb").read() if args.file else os.urandom(args.random_bytes)
    ns = Namespace.v0(bytes.fromhex(args.namespace))
    blob = Blob(ns, data)
    gas = estimate_gas([len(data)])
    signer = Signer(chain_id)
    signer.add_account(key, acc.account_number, acc.sequence)
    raw = signer.create_pay_for_blobs(addr, [blob], gas, gas)

    check = app.check_tx(raw)
    if check.code != 0:
        print(f"CheckTx rejected: {check.log}", file=sys.stderr)
        return 1
    block = app.prepare_proposal([raw])
    if not app.process_proposal(block):
        print("proposal rejected", file=sys.stderr)
        return 1
    results = app.finalize_block(max(time.time_ns(), app.last_block_time_ns + 1), list(block.txs))
    app.commit()
    save_app(args.home, app)
    print(
        json.dumps(
            {
                "height": app.height,
                "code": results[0].code if results else 1,
                "gas_used": results[0].gas_used if results else 0,
                "square_size": block.square_size,
                "data_root": block.hash.hex(),
            }
        )
    )
    return 0


def cmd_query_balance(args) -> int:
    from celestia_app_tpu_torch.state.accounts import BankKeeper

    app = load_app(args.home, device=args.device)
    print(json.dumps({"address": args.address, "balance": BankKeeper(app.cms.working).balance(args.address)}))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="celestia-appd-tpu", description=__doc__)
    parser.add_argument("--home", default=DEFAULT_HOME)
    parser.add_argument("--device", default=None,
                        help="the device of the App's square path (default: "
                             "cuda, which raises without a card; cpu runs "
                             "the plain PyTorch versions of the kernels)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("init", help="initialize a home dir + genesis")
    p.add_argument("chain_id")
    p.add_argument("--accounts", type=int, default=4)
    p.add_argument("--validators", type=int, default=3)
    p.add_argument("--gov-max-square-size", type=int, default=64)
    p.set_defaults(fn=cmd_init)

    p = sub.add_parser("start", help="run the node loop")
    p.add_argument("--blocks", type=int, default=0, help="0 = forever")
    # None = unset: the 3-tier resolution in cmd_start falls back to env
    # CELESTIA_* then config.toml/app.toml then the built-in defaults.
    p.add_argument("--block-interval", type=float, default=None)
    p.add_argument("--no-sleep", action="store_true")
    p.add_argument("--snapshot-interval", type=int, default=None)
    p.add_argument("--min-gas-price", default=None,
                   help="node min gas price in utia (tier-1 override)")
    p.add_argument("--serve", action="store_true",
                   help="serve the JSON-RPC endpoint (broadcast/query/proofs)")
    p.add_argument("--grpc", action="store_true",
                   help="with --serve: also serve the cosmos gRPC plane")
    p.add_argument("--grpc-port", type=int, default=0,
                   help="gRPC port (0 = ephemeral)")
    p.add_argument("--api", action="store_true",
                   help="with --serve: also serve the REST API gateway "
                        "(the grpc-gateway plane, reference port 1317)")
    p.add_argument("--api-port", type=int, default=0,
                   help="API gateway port (0 = ephemeral)")
    p.add_argument("--peers", default="",
                   help="comma-separated peer RPC URLs: join as one gossip "
                        "validator of a network (implies --serve)")
    p.add_argument("--validator-index", type=int, default=0,
                   help="this validator's index in the network's valset")
    p.add_argument("--n-validators", type=int, default=0,
                   help="total validators in the network (gossip mode)")
    p.add_argument("--rpc-port", type=int, default=26657)
    p.add_argument("--warmup", choices=["none", "minimal", "all"],
                   default="minimal",
                   help="AOT-compile square pipelines at startup: minimal "
                        "(k=1 + max), all (every power of two up to max)")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("snapshot", help="state-sync snapshots")
    p.add_argument("action", choices=["create", "list", "restore"])
    p.add_argument("--height", type=int, default=0)
    p.set_defaults(fn=cmd_snapshot)

    p = sub.add_parser("tx-pay-for-blob", help="submit a PFB on the local devnet")
    p.add_argument("--namespace", default="deadbeef")
    p.add_argument("--file", default=None)
    p.add_argument("--random-bytes", type=int, default=10_000)
    p.add_argument("--account", type=int, default=0)
    p.set_defaults(fn=cmd_tx_pfb)

    p = sub.add_parser("query-balance", help="query an account balance")
    p.add_argument("address")
    p.set_defaults(fn=cmd_query_balance)

    p = sub.add_parser("status", help="print chain status")
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("export", help="export app state as JSON")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("rollback", help="drop the latest committed height")
    p.set_defaults(fn=cmd_rollback)

    p = sub.add_parser(
        "check-invariants", help="run x/crisis module invariants"
    )
    p.set_defaults(fn=cmd_check_invariants)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
