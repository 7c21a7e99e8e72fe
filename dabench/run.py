"""Run one cell of the benchmark and print its result as the last line.

    python3 -m dabench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json and the program
(celestia_app_tpu_torch).  One process per run: it sets up, warms, measures
for --seconds, checks the window's outputs against the plain reference and
prints one JSON object.  It exits non-zero and prints no result without
enough CUDA cards for the cell, without the program, or when JAX or the
JAX package was loaded.

Caches stay inside the checkout: the program builds its kernels into its
fixed celestia_app_tpu_torch/build/; the profile directory lies under
$TMPDIR; the flight recorder stays off.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "celestia_app_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (celestia_app_tpu_torch is not celestia_app_tpu)."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def prepare_environment(config: dict) -> None:
    """The deployment's settings and nothing else of the program's: every
    other CELESTIA_* variable is dropped, so the program runs its
    defaults."""
    for key in [k for k in os.environ if k.startswith("CELESTIA_")]:
        del os.environ[key]
    os.environ.update(config.get("env", {}))
    os.environ["CELESTIA_PROFILE_DIR"] = os.path.join(tempfile.gettempdir(), "dabench-profile")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from dabench.spec import Bench

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    prepare_environment(bench.config(cell))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import celestia_app_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test is missing: {e}", file=sys.stderr)
        return 3
    from dabench.harness import run_cell

    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (JAX or the JAX package)",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
