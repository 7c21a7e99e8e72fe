"""The three-tier config system (reference SURVEY §5 "Config / flags").

Tier 1 — CLI flags + env (prefix CELESTIA, viper-style precedence);
Tier 2 — files: config.toml (consensus/node tuning) + app.toml (app
         server tuning), written by `appd init` with celestia's defaults
         (app/default_overrides.go:258-301) and read back at `start`;
Tier 3 — on-chain: consensus params + module params (blob, minfee,
         blobstream window) mutable only through governance minus the
         paramfilter blocklist.

Precedence when resolving an option: CLI flag > CELESTIA_* env var >
config file > built-in default (cmd/celestia-appd/cmd/root.go:33,55,72-80).

Files are TOML; reading uses the stdlib tomllib, writing emits the small
subset we need (tables of scalars).

The port's copy of celestia_app_tpu/cmd/config.py.
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import asdict, dataclass, field, fields

from celestia_app_tpu_torch.constants import (
    CONTINUATION_SPARSE_SHARE_CONTENT_SIZE,
    SQUARE_SIZE_UPPER_BOUND,
)

GOAL_BLOCK_TIME_S = 15  # appconsts.GoalBlockTime (consensus_consts.go:5)
_UPPER_BOUND_TX_BYTES = (
    SQUARE_SIZE_UPPER_BOUND * SQUARE_SIZE_UPPER_BOUND
    * CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
)


@dataclass
class MempoolConfig:
    version: str = "v1"  # prioritized mempool
    ttl_num_blocks: int = 5
    ttl_duration_s: int = 5 * GOAL_BLOCK_TIME_S
    max_tx_bytes: int = _UPPER_BOUND_TX_BYTES
    max_txs_bytes: int = _UPPER_BOUND_TX_BYTES * 5


@dataclass
class RPCConfig:
    laddr: str = "127.0.0.1:26657"
    timeout_broadcast_tx_commit_s: int = 50
    max_body_bytes: int = 8 * 1024 * 1024  # 8 MiB


@dataclass
class ConsensusTimingConfig:
    timeout_propose_s: int = 10
    timeout_commit_s: int = 11
    skip_timeout_commit: bool = False


@dataclass
class ConsensusConfig:
    """config.toml analog (DefaultConsensusConfig, default_overrides.go:258)."""

    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    consensus: ConsensusTimingConfig = field(default_factory=ConsensusTimingConfig)


@dataclass
class StateSyncConfig:
    snapshot_interval: int = 1500
    snapshot_keep_recent: int = 2


@dataclass
class ApiConfig:
    enable: bool = False


@dataclass
class AppTomlConfig:
    """app.toml analog (DefaultAppConfig, default_overrides.go:286)."""

    min_gas_prices: str = "0.002utia"  # appconsts.DefaultMinGasPrice + BondDenom
    statesync: StateSyncConfig = field(default_factory=StateSyncConfig)
    api: ApiConfig = field(default_factory=ApiConfig)


def _toml_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return str(v)
    return '"' + str(v).replace("\\", "\\\\").replace('"', '\\"') + '"'


def _render_toml(cfg) -> str:
    """Dataclass -> TOML: top-level scalars, then one table per nested
    dataclass field."""
    lines: list[str] = []
    tables: list[str] = []
    for f in fields(cfg):
        v = getattr(cfg, f.name)
        if hasattr(v, "__dataclass_fields__"):
            tables.append(f"[{f.name}]")
            for sub, subval in asdict(v).items():
                tables.append(f"{sub} = {_toml_scalar(subval)}")
            tables.append("")
        else:
            lines.append(f"{f.name} = {_toml_scalar(v)}")
    return "\n".join(lines + [""] + tables if lines else tables) + "\n"


def _apply(cfg, data: dict):
    for f in fields(cfg):
        if f.name not in data:
            continue
        v = getattr(cfg, f.name)
        if hasattr(v, "__dataclass_fields__"):
            for sub, subval in data[f.name].items():
                if sub in {x.name for x in fields(v)}:
                    setattr(v, sub, subval)
        else:
            setattr(cfg, f.name, data[f.name])
    return cfg


def config_dir(home: str) -> str:
    return os.path.join(home, "config")


def write_default_configs(home: str) -> tuple[str, str]:
    """`appd init` tier-2 output: config.toml + app.toml with the
    celestia-tuned defaults; existing files are left untouched (the
    reference only injects defaults pre-run, root.go:72-80)."""
    os.makedirs(config_dir(home), exist_ok=True)
    paths = []
    for name, cfg in (("config.toml", ConsensusConfig()), ("app.toml", AppTomlConfig())):
        path = os.path.join(config_dir(home), name)
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write(f"# generated by appd init — edit freely\n{_render_toml(cfg)}")
        paths.append(path)
    return paths[0], paths[1]


def load_configs(home: str) -> tuple[ConsensusConfig, AppTomlConfig]:
    """Read tier 2, falling back to defaults for anything absent."""
    consensus, app = ConsensusConfig(), AppTomlConfig()
    for name, cfg in (("config.toml", consensus), ("app.toml", app)):
        path = os.path.join(config_dir(home), name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                _apply(cfg, tomllib.load(f))
    return consensus, app


def resolve_option(
    cli_value, env_key: str, file_value, default, cast=str
):
    """Tier-1/2 precedence: CLI > CELESTIA_<env_key> > file > default."""
    if cli_value is not None:
        return cli_value
    env = os.environ.get(f"CELESTIA_{env_key}")
    if env is not None:
        return cast(env)
    if file_value is not None:
        return file_value
    return default


def min_gas_price_from_config(app_cfg: AppTomlConfig):
    """Parse the cosmos min-gas-prices string ('0.002utia', possibly a
    comma-separated multi-denom list) into the utia Dec the node enforces."""
    from celestia_app_tpu_torch.state.dec import Dec

    for entry in app_cfg.min_gas_prices.split(","):
        entry = entry.strip()
        if not entry.endswith("utia"):
            continue
        number = entry[: -len("utia")].strip()
        if not number or not all(c.isdigit() or c == "." for c in number):
            raise ValueError(f"unparseable min gas price entry {entry!r}")
        return Dec.from_str(number)
    raise ValueError(
        f"no utia entry in min_gas_prices {app_cfg.min_gas_prices!r}"
    )
