"""Helpers the drivers share: the deterministic synthetic squares, the
device argument, the record's platform label and the restore of the
process state a drill touches.

`deterministic_blocks`, `deterministic_square` and `tenant_square` give the
bytes of the JAX scripts' `_deterministic_blocks` (scripts/chaos_soak.py),
`deterministic_square` (scripts/das_loadgen.py, scripts/block_anatomy.py)
and `tenant_square` (scripts/das_loadgen.py) for the same seed: one copy of
each here.
"""

from __future__ import annotations

import contextlib
import os
import subprocess

import numpy as np

from celestia_app_tpu_torch.constants import NAMESPACE_SIZE, SHARE_SIZE
from celestia_app_tpu_torch.device import resolve_device


def deterministic_blocks(n: int, k: int, seed: int = 1234) -> list:
    """[(i, ods)] for i < n: namespace-ordered synthetic (k, k, 512) squares,
    all drawn from one generator seeded with `seed`."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        shares = k * k
        ns = np.sort(rng.integers(0, 128, shares).astype(np.uint8))
        ods = rng.integers(0, 256, (shares, SHARE_SIZE), dtype=np.uint8)
        ods[:, :NAMESPACE_SIZE] = 0
        ods[:, NAMESPACE_SIZE - 1] = ns
        out.append((i, ods.reshape(k, k, SHARE_SIZE)))
    return out


def deterministic_square(k: int, seed: int) -> np.ndarray:
    """One synthetic namespace-ordered ODS: the first of
    `deterministic_blocks(1, k, seed)`."""
    return deterministic_blocks(1, k, seed)[0][1]


def tenant_square(k: int, seed: int, tenants: int):
    """One synthetic namespace-ordered ODS with exactly `tenants`
    namespaces; returns (ods, ranges) where ranges[t] = (start, end) is
    the share-index range of tenant t (contiguous: the square is
    namespace-sorted, like every real square)."""
    if not 1 <= tenants <= 255:
        # Tenant ids map onto one namespace byte (value 1..255; 0 stays
        # reserved): more would wrap uint8 and alias tenants.
        raise ValueError(f"tenants must be 1..255, got {tenants}")
    rng = np.random.default_rng(seed)
    n = k * k
    vals = np.sort(rng.integers(0, tenants, n).astype(np.uint8))
    ods = rng.integers(0, 256, (n, SHARE_SIZE), dtype=np.uint8)
    ods[:, :NAMESPACE_SIZE] = 0
    ods[:, NAMESPACE_SIZE - 1] = vals + 1  # 1..tenants; 0 stays reserved
    ranges = {}
    for t in range(tenants):
        idx = np.nonzero(vals == t)[0]
        if len(idx):
            ranges[int(t)] = (int(idx[0]), int(idx[-1]) + 1)
    return ods.reshape(k, k, SHARE_SIZE), ranges


def add_device_argument(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run: cuda (the default; raises "
                         "without a card) or cpu (their plain PyTorch "
                         "versions)")


def platform_label(device=None) -> str:
    """What the JAX scripts' records hold as `platform`
    (`jax.default_backend()`): "cpu", or on a card its name and power
    limit as `nvidia-smi --query-gpu=name,power.limit` prints them."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    import torch

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        line = out.stdout.strip().splitlines()[0].strip()
        if line:
            return line
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return f"{torch.cuda.get_device_name(index)}, power limit not read"


@contextlib.contextmanager
def restored_env(*names: str):
    """Restore the listed environment variables on exit, whatever the body
    set them to."""
    saved = {name: os.environ.get(name) for name in names}
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


@contextlib.contextmanager
def process_state():
    """Give back, on exit, the process-wide state a drill touches: the
    installed chaos spec, every `CELESTIA_*` variable (the flight directory
    and the seams' settings among them), the SLO engine, the exposition's
    scrape stamp; and reset the degradation ladder, which every drill
    leaves at its top rung as the JAX drills do.  Files of one test worker
    share a process, so a drill must leave it as it found it."""
    from celestia_app_tpu_torch import chaos
    from celestia_app_tpu_torch.chaos import degrade
    from celestia_app_tpu_torch.trace import exposition, slo

    installed = chaos._INSTALLED
    env = {k: v for k, v in os.environ.items() if k.startswith("CELESTIA_")}
    engine, tenant_specs = slo._ENGINE, slo._TENANT_SPECS
    scrape_ts = exposition._LAST_SCRAPE_TS
    try:
        yield
    finally:
        chaos._INSTALLED = installed
        for key in [k for k in os.environ if k.startswith("CELESTIA_")]:
            if key not in env:
                del os.environ[key]
        os.environ.update(env)
        with slo._ENGINE_LOCK:
            slo._ENGINE, slo._TENANT_SPECS = engine, tenant_specs
        exposition._LAST_SCRAPE_TS = scrape_ts
        degrade.reset_for_tests()
