#!/usr/bin/env python
"""Metric-name lint: registry names must be well-formed AND documented.

Walks every registry().counter/gauge/histogram registration in
`celestia_app_tpu_torch/` (AST, no imports — runs in any image) and checks
it against the same README "Metrics" and endpoint tables the JAX package's
lint reads (scripts/trace_lint.py):

  1. the name matches `celestia_[a-z0-9_]+` (static names exactly;
     f-string names on their static prefix), so the exposition namespace
     stays uniform; and
  2. the name appears in the README "Metrics" table (dynamic families may
     be documented with a `<placeholder>` segment, e.g.
     `celestia_block_<stage>_seconds`, matched by prefix), so docs and
     exposition goldens cannot drift apart; and
  3. every explicit LABEL keyword on a metric write (`.inc(...)` /
     `.set(...)` / `.observe(...)`) matches `[a-z][a-z0-9_]*`; and
  4. labels fed from an unbounded-cardinality source (today: `namespace`,
     one value per tenant) only appear in modules that route the value
     through the top-N cap helper
     (trace/square_journal.capped_namespace_label) — a module that slaps
     `namespace=` on a metric without referencing the helper fails,
     which is what keeps the exposition's label cardinality provably
     bounded as tenants multiply; and
  5. in the HOT-PATH modules (parallel/, da/, kernels/, consensus/),
     every `except Exception:` / bare `except:` handler carries a
     `# chaos-ok: <why>` rationale on its line (or the line above).  A
     broad catch on the block path is where a fault gets SWALLOWED
     instead of retried/degraded/propagated (the chaos layer exists
     because of exactly such sites) — the tag forces each one to say why
     swallowing is right.  Existing sites were grandfathered by tagging
     them with their (pre-existing) rationales; and
  6. every path ROUTED in trace/exposition.handle_observability_get —
     an `p == "/x"` equality or a `p.startswith("/x/")` prefix — appears
     in the README endpoint table as a `GET /x` (prefix routes match any
     documented `GET /x/<placeholder>` row).  The shared handler is what
     makes the three planes' observability surface one surface; this
     rule closes the doc-drift loophole where a new endpoint ships on
     every plane but no operator can discover it; and
  7. the fleet surface stays discoverable and the wire trace stays ONE
     trace: (a) every route in trace/fleet.FLEET_ROUTES appears in the
     README endpoint table (the aggregator scrapes peers by these paths,
     so an undocumented fleet route is invisible to the operator wiring
     the fleet up), and (b) any rpc/ module that calls
     `new_context(...)` or `use_context(...)` must also reference
     `adopt_context` or `adopt_or_new` — a serving plane that mints a
     fresh root context on an inbound hop instead of adopting the
     x-celestia-trace header splits the cross-node trace, which is
     exactly the regression the propagation layer exists to prevent.
  8. every module under da/, kernels/, serve/, parallel/ that builds a
     compiled program (`torch.compile(...)`, `torch.jit.script(...)` /
     `torch.jit.trace(...)`, or a `jax.jit` in the JAX package's lint)
     must reference `trace/device_ledger` — a program family that never
     registers with the device-attribution ledger is invisible on GET
     /device: its builds, dispatches, and residency vanish from the exact
     surface built to account for them.  The port builds none today (its
     pipelines are hand-written kernels and torch code, registered with
     `device_ledger.track` where they are cached).
  9. every trace-row write (`.write("table", ...)` with a resolvable
     table name — a string literal or a module-level string constant)
     must stamp `height=` or `trace_id=` (a `**splat` keyword counts:
     the spread row carries the stamps), unless the table is in the
     height-free allowlist (HEIGHT_FREE_TABLES — process-scoped events
     like pages and WAL salvage that genuinely belong to no height).  An
     unstamped row is invisible to the height-anatomy timeline
     (trace/timeline.py): it can never be stitched into a per-height
     critical path, which is exactly the observability gap this plane
     exists to close.  Unresolvable first args (self.TABLE, a local) are
     skipped — the literal-name sites are the enforcement surface.

Run: `python -m celestia_app_tpu_torch.scripts.trace_lint` (exit 1 on
problems); tests/test_torch_scripts.py puts the check in tier-1.

The port's copy of scripts/trace_lint.py: the package, the exposition
router, the fleet routes and the rpc/ planes are the port's
(`celestia_app_tpu_torch/...`), `lint` and the collectors take the package
directory, and rule 8 looks for torch's compiled programs.  It reads
sources only: no device, no import of the package.
"""

from __future__ import annotations

import ast
import os
import re
import sys

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)
README = os.path.join(REPO_ROOT, "README.md")

METRIC_NAME_RE = re.compile(r"^celestia_[a-z0-9_]+$")
METRIC_PREFIX_RE = re.compile(r"^celestia_[a-z0-9_]*$")
README_TOKEN_RE = re.compile(r"celestia_[a-z0-9_<>]+")
REGISTRY_METHODS = {"counter", "gauge", "histogram"}

LABEL_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
METRIC_WRITE_METHODS = {"inc", "set", "observe"}
# Labels whose value space grows with usage (one value per tenant): a
# metric may only carry them when the module routes the value through the
# cardinality cap helper.
UNBOUNDED_LABELS = {"namespace"}
CAP_HELPER = "capped_namespace_label"

# Hot-path module prefixes (package-relative) where a broad exception
# handler must carry a `# chaos-ok:` rationale tag.
HOT_PATH_PREFIXES = ("parallel/", "da/", "kernels/", "consensus/")
CHAOS_OK_TAG = "chaos-ok:"

# Rule 6: the shared observability router + the README table its routes
# must be documented in.
EXPOSITION_REL = os.path.join("celestia_app_tpu_torch", "trace", "exposition.py")
ROUTER_FUNC = "handle_observability_get"
README_ENDPOINT_RE = re.compile(r"GET\s+(/[A-Za-z0-9_/<>-]*)")

# Rule 7: the fleet scrape surface + the adopt-don't-mint discipline on
# the serving planes.
FLEET_REL = os.path.join("celestia_app_tpu_torch", "trace", "fleet.py")
FLEET_ROUTES_NAME = "FLEET_ROUTES"
RPC_PREFIX = "celestia_app_tpu_torch/rpc/"
MINT_FUNCS = {"new_context", "use_context"}
ADOPT_FUNCS = {"adopt_context", "adopt_or_new"}

# Rule 9: trace tables whose rows genuinely belong to no height — page
# events, bundle dumps, WAL salvage, chaos injections are process-scoped.
# Everything else written through the tracer must stamp height= or
# trace_id= so the height-anatomy timeline can stitch it.
TABLE_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
STITCH_KEYS = {"height", "trace_id"}
HEIGHT_FREE_TABLES = {
    "slo_page",
    "flight_dump",
    "wal_salvage",
    "chaos_injection",
    "profiler",        # one capture window per process, not per height
    "hbm_high_water",  # lifetime allocator/RSS peaks, not per height
}


def _parse_package(package_dir: str = PACKAGE_DIR):
    """[(repo-relative path, parsed AST, source lines)] for every .py
    under the package — the single walk+parse all collectors share."""
    out = []
    for dirpath, dirnames, filenames in os.walk(package_dir):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
            out.append((
                os.path.relpath(path, REPO_ROOT), tree, source.splitlines()
            ))
    return out


def collect_registrations(package_dir: str = PACKAGE_DIR, trees=None):
    """[(file, lineno, kind, name)] where kind is "static" (a literal
    name) or "dynamic" (an f-string; `name` is its static prefix)."""
    out = []
    for rel, tree, _ in trees if trees is not None else _parse_package(package_dir):
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in REGISTRY_METHODS
                and node.args
            ):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                out.append((rel, node.lineno, "static", arg.value))
            elif isinstance(arg, ast.JoinedStr):
                prefix = ""
                for part in arg.values:
                    if isinstance(part, ast.Constant):
                        prefix += str(part.value)
                    else:
                        break
                out.append((rel, node.lineno, "dynamic", prefix))
    return out


def collect_label_uses(package_dir: str = PACKAGE_DIR, trees=None):
    """[(file, lineno, label_name, module_has_cap_helper)] for every
    explicit keyword on a metric write call (.inc/.set/.observe).

    `**spread` labels carry no static name and are skipped (none of the
    in-tree spreads feed unbounded sources; explicit keywords are the
    enforcement surface).  Whether the module references the cap helper
    (an import or a call of `capped_namespace_label`) is recorded per
    file so lint() can flag unbounded labels used outside it.
    """
    out = []
    for rel, tree, _ in trees if trees is not None else _parse_package(package_dir):
        has_helper = any(
            (isinstance(n, ast.Name) and n.id == CAP_HELPER)
            or (isinstance(n, ast.Attribute) and n.attr == CAP_HELPER)
            or (isinstance(n, ast.ImportFrom)
                and any(a.name == CAP_HELPER for a in n.names))
            for n in ast.walk(tree)
        )
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in METRIC_WRITE_METHODS
                and node.keywords
            ):
                continue
            for kw in node.keywords:
                if kw.arg is None:  # **spread
                    continue
                out.append((rel, node.lineno, kw.arg, has_helper))
    return out


def _is_hot_path(rel: str) -> bool:
    p = "/" + rel.replace(os.sep, "/")
    return any("/" + prefix in p for prefix in HOT_PATH_PREFIXES)


def collect_broad_excepts(package_dir: str = PACKAGE_DIR, trees=None):
    """[(file, lineno, tagged)] for every `except Exception` / bare
    `except:` handler in a hot-path module.  `tagged` is whether the
    handler line (or the line above it — long rationales wrap) carries
    the `# chaos-ok:` tag."""

    def _catches_broad(h: ast.ExceptHandler) -> bool:
        if h.type is None:
            return True  # bare except
        names = (
            h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
        )
        # BaseException is in the net too: the strictly BROADER catch
        # must not be the easy way around the rationale requirement.
        return any(
            isinstance(n, ast.Name)
            and n.id in ("Exception", "BaseException")
            for n in names
        )

    out = []
    for rel, tree, lines in (
        trees if trees is not None else _parse_package(package_dir)
    ):
        if not _is_hot_path(rel):
            continue
        for node in ast.walk(tree):
            if not (isinstance(node, ast.ExceptHandler)
                    and _catches_broad(node)):
                continue
            nearby = lines[max(0, node.lineno - 2):node.lineno]
            out.append(
                (rel, node.lineno, any(CHAOS_OK_TAG in l for l in nearby))
            )
    return out


def collect_routed_paths(package_dir: str = PACKAGE_DIR, trees=None):
    """[(file, lineno, kind, path)] for every route in the shared
    observability handler: kind "exact" for `p == "/x"` comparisons,
    "prefix" for `p.startswith("/x/")`.  The bare "/" normalization
    compare is not a route and is skipped."""
    out = []
    for rel, tree, _ in trees if trees is not None else _parse_package(package_dir):
        if rel.replace(os.sep, "/") != EXPOSITION_REL.replace(os.sep, "/"):
            continue
        router = next(
            (n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef) and n.name == ROUTER_FUNC),
            None,
        )
        if router is None:
            continue
        for node in ast.walk(router):
            if isinstance(node, ast.Compare):
                for side in [node.left, *node.comparators]:
                    if (
                        isinstance(side, ast.Constant)
                        and isinstance(side.value, str)
                        and side.value.startswith("/")
                        and side.value != "/"
                    ):
                        out.append((rel, node.lineno, "exact", side.value))
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "startswith"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
                and node.args[0].value.startswith("/")
            ):
                out.append(
                    (rel, node.lineno, "prefix", node.args[0].value)
                )
    return out


def collect_fleet_routes(package_dir: str = PACKAGE_DIR, trees=None):
    """[(file, lineno, path)] for every string in the module-level
    `FLEET_ROUTES` tuple of trace/fleet.py — the paths the aggregator
    scrapes peers on and serves the merged view under."""
    out = []
    for rel, tree, _ in trees if trees is not None else _parse_package(package_dir):
        if rel.replace(os.sep, "/") != FLEET_REL.replace(os.sep, "/"):
            continue
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.Assign)
                and any(
                    isinstance(t, ast.Name) and t.id == FLEET_ROUTES_NAME
                    for t in node.targets
                )
                and isinstance(node.value, (ast.Tuple, ast.List))
            ):
                continue
            for elt in node.value.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                    out.append((rel, node.lineno, elt.value))
    return out


def collect_rpc_context_mints(package_dir: str = PACKAGE_DIR, trees=None):
    """[(file, lineno, func, adopts)] for every `new_context(...)` /
    `use_context(...)` call in an rpc/ module.  `adopts` is whether the
    MODULE references adopt_context or adopt_or_new anywhere (import,
    name, or attribute) — minting a context on an inbound serving plane
    is only legitimate alongside the adoption path (adopt when the
    header is present, mint only as the no-header fallback)."""
    out = []
    for rel, tree, _ in trees if trees is not None else _parse_package(package_dir):
        if not rel.replace(os.sep, "/").startswith(RPC_PREFIX):
            continue
        adopts = any(
            (isinstance(n, ast.Name) and n.id in ADOPT_FUNCS)
            or (isinstance(n, ast.Attribute) and n.attr in ADOPT_FUNCS)
            or (isinstance(n, ast.ImportFrom)
                and any(a.name in ADOPT_FUNCS for a in n.names))
            for n in ast.walk(tree)
        )
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = (
                func.id if isinstance(func, ast.Name)
                else func.attr if isinstance(func, ast.Attribute)
                else None
            )
            if name in MINT_FUNCS:
                out.append((rel, node.lineno, name, adopts))
    return out


def _builds_program(node) -> bool:
    """`torch.compile`, `torch.jit.script` / `torch.jit.trace`, `jax.jit`."""
    if not isinstance(node, ast.Attribute):
        return False
    base = node.value
    if isinstance(base, ast.Name):
        return (base.id, node.attr) in (("torch", "compile"), ("jax", "jit"))
    return (
        node.attr in ("script", "trace")
        and isinstance(base, ast.Attribute) and base.attr == "jit"
        and isinstance(base.value, ast.Name) and base.value.id == "torch"
    )


def collect_unledgered_jits(package_dir: str = PACKAGE_DIR, trees=None):
    """[(file, lineno)] for the FIRST compiled-program build in each
    device-plane module (da/, kernels/, serve/, parallel/) that never
    references the device ledger.  One finding per module: the fix is
    registering the module's cache family, not annotating each site."""
    out = []
    for rel, tree, _ in trees if trees is not None else _parse_package(package_dir):
        p = rel.replace(os.sep, "/")
        if not any(
            f"/{d}/" in "/" + p
            for d in ("da", "kernels", "serve", "parallel")
        ):
            continue
        jit_line = None
        references_ledger = False
        for node in ast.walk(tree):
            if _builds_program(node):
                if jit_line is None:
                    jit_line = node.lineno
            elif (
                isinstance(node, ast.ImportFrom)
                and node.module is not None
                and node.module.endswith("device_ledger")
            ) or (
                isinstance(node, (ast.Name, ast.Attribute))
                and getattr(node, "id", getattr(node, "attr", None))
                == "device_ledger"
            ):
                references_ledger = True
        if jit_line is not None and not references_ledger:
            out.append((rel, jit_line))
    return out


def collect_unstitched_writes(package_dir: str = PACKAGE_DIR, trees=None):
    """[(file, lineno, table)] for every `.write(<table>, ...)` call
    whose table name resolves statically (string literal, or a Name
    bound to a module-level string constant) to something shaped like a
    trace table, but whose keywords carry neither `height=` nor
    `trace_id=` nor a `**splat` — and whose table is not in the
    height-free allowlist.

    The table-name regex is what separates tracer writes from the
    file/socket `.write(...)` calls that share the method name: a
    payload like "\\n" or a bytes body never matches
    `[a-z][a-z0-9_]*`."""
    out = []
    for rel, tree, _ in trees if trees is not None else _parse_package(package_dir):
        consts = {
            t.id: n.value.value
            for n in ast.walk(tree)
            if isinstance(n, ast.Assign)
            and isinstance(n.value, ast.Constant)
            and isinstance(n.value.value, str)
            for t in n.targets
            if isinstance(t, ast.Name)
        }
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "write"
                and node.args
            ):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                table = arg.value
            elif isinstance(arg, ast.Name) and arg.id in consts:
                table = consts[arg.id]
            else:
                continue  # self.TABLE / locals: not statically resolvable
            if not TABLE_NAME_RE.match(table):
                continue  # a file payload, not a trace table name
            if table in HEIGHT_FREE_TABLES:
                continue
            stamped = any(
                kw.arg is None or kw.arg in STITCH_KEYS
                for kw in node.keywords
            )
            if not stamped:
                out.append((rel, node.lineno, table))
    return out


def readme_metric_tokens(readme_path: str = README) -> set[str]:
    with open(readme_path, encoding="utf-8") as f:
        return set(README_TOKEN_RE.findall(f.read()))


def readme_endpoint_paths(readme_path: str = README) -> set[str]:
    """Every `GET /path` the README documents (the endpoint table plus
    any prose mention — either keeps the route discoverable)."""
    with open(readme_path, encoding="utf-8") as f:
        return set(README_ENDPOINT_RE.findall(f.read()))


def lint(package_dir: str = PACKAGE_DIR, readme_path: str = README) -> list[str]:
    problems = []
    trees = _parse_package(package_dir)  # one walk feeds both collectors
    tokens = readme_metric_tokens(readme_path)
    # A documented dynamic family like celestia_block_<stage>_seconds
    # covers every name matching it with the placeholder as one
    # [a-z0-9_]+ segment — prefix AND suffix must line up (prefix-only
    # matching let `celestia_<span>_seconds` whitelist every name).
    doc_res = [
        re.compile("^" + re.sub(r"<[a-z0-9_]+>", "[a-z0-9_]+", t) + "$")
        for t in tokens if "<" in t
    ]
    for rel, lineno, kind, name in collect_registrations(package_dir, trees):
        where = f"{rel}:{lineno}"
        if kind == "static":
            if not METRIC_NAME_RE.match(name):
                problems.append(
                    f"{where}: metric {name!r} does not match "
                    "celestia_[a-z0-9_]+"
                )
            elif name not in tokens and not any(
                r.match(name) for r in doc_res
            ):
                problems.append(
                    f"{where}: metric {name!r} missing from the README "
                    "metrics table"
                )
        else:
            if not METRIC_PREFIX_RE.match(name):
                problems.append(
                    f"{where}: dynamic metric prefix {name!r} does not "
                    "match celestia_[a-z0-9_]*"
                )
            elif not any(t.startswith(name) for t in tokens):
                problems.append(
                    f"{where}: dynamic metric family {name!r}* missing "
                    "from the README metrics table"
                )
    for rel, lineno, label, has_helper in collect_label_uses(package_dir, trees):
        where = f"{rel}:{lineno}"
        if not LABEL_NAME_RE.match(label):
            problems.append(
                f"{where}: metric label {label!r} does not match "
                "[a-z][a-z0-9_]*"
            )
        elif label in UNBOUNDED_LABELS and not has_helper:
            problems.append(
                f"{where}: label {label!r} is unbounded-cardinality; route "
                f"the value through trace/square_journal.{CAP_HELPER} "
                "(module never references the helper)"
            )
    for rel, lineno, tagged in collect_broad_excepts(package_dir, trees):
        if not tagged:
            problems.append(
                f"{rel}:{lineno}: broad `except Exception` in a hot-path "
                f"module without a `# {CHAOS_OK_TAG}` rationale — swallow "
                "sites on the block path must say why they are not a "
                "retry/degrade/propagate seam (see chaos/)"
            )
    endpoints = readme_endpoint_paths(readme_path)
    for rel, lineno, kind, path in collect_routed_paths(package_dir, trees):
        where = f"{rel}:{lineno}"
        if kind == "exact":
            documented = path in endpoints
        else:  # prefix route: any documented path under the prefix counts
            documented = any(
                e.startswith(path) and len(e) > len(path) for e in endpoints
            )
        if not documented:
            problems.append(
                f"{where}: routed path {path!r}{'*' if kind == 'prefix' else ''} "
                "missing from the README endpoint table — every route on "
                "the shared observability handler must be documented "
                "(GET <path> in README.md)"
            )
    for rel, lineno, path in collect_fleet_routes(package_dir, trees):
        if path not in endpoints:
            problems.append(
                f"{rel}:{lineno}: fleet route {path!r} missing from the "
                "README endpoint table — every FLEET_ROUTES path must be "
                "documented (GET <path> in README.md)"
            )
    for rel, lineno, func, adopts in collect_rpc_context_mints(
        package_dir, trees
    ):
        if not adopts:
            problems.append(
                f"{rel}:{lineno}: rpc module calls {func}() but never "
                "references adopt_context/adopt_or_new — an inbound "
                "serving plane that mints instead of adopting the "
                "x-celestia-trace header splits the cross-node trace"
            )
    for rel, lineno in collect_unledgered_jits(package_dir, trees):
        problems.append(
            f"{rel}:{lineno}: module builds jit programs but never "
            "references trace/device_ledger — register the cache family "
            "(device_ledger.track) so GET /device can attribute its "
            "compiles, dispatches, and residency"
        )
    for rel, lineno, table in collect_unstitched_writes(package_dir, trees):
        problems.append(
            f"{rel}:{lineno}: trace table {table!r} written without "
            "height= or trace_id= — the height-anatomy timeline "
            "(trace/timeline.py) cannot stitch an unstamped row; stamp "
            "it, or add the table to HEIGHT_FREE_TABLES if it genuinely "
            "belongs to no height"
        )
    return problems


def main(argv=None) -> int:
    problems = lint()
    regs = collect_registrations()
    routes = collect_routed_paths()
    print(
        f"trace_lint: {len(regs)} registrations "
        f"({len({n for _, _, k, n in regs if k == 'static'})} distinct static names), "
        f"{len(routes)} observability routes"
    )
    for p in problems:
        print(f"  PROBLEM {p}")
    if problems:
        return 1
    print("trace_lint: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
