"""Fleet aggregator: one merged observability view over N peers.

Every telemetry surface the repo grew — /metrics, /healthz, /slo, /heal
— is process-private: a 3-node drill means three browser tabs and
hand-merged quantiles.  This module is the fleet face: an aggregator
scrapes each peer's observability port on an interval, merges what
composes —

  * counters by SUMMATION (fleet proofs served = sum of per-host
    cumulative counters; per-host rates from successive scrape deltas),
  * histograms by BUCKET-WISE merge (`Histogram.merge`, exact at bucket
    resolution — cross-host p99 comes from summed bucket counts, never
    from averaging per-host quantiles),
  * SLO burn from the MERGED histogram delta between the last two
    scrape rounds, budget-normalized against the same SLOSpec the
    per-node engine judges (the fleet "fast window" is the scrape
    interval),

— and reports what doesn't (per-host degraded rung, quarantined
heights, QoS throttle counts) side by side.  A peer that stops
answering is never silently dropped: its row stays in the payload with
`reachable: false` + the error, and `celestia_fleet_peer_unreachable`
marks it for alerting — absence of data is itself a datum.

`GET /fleet` rides the shared exposition handler on all three planes;
the payload is a pure function of the aggregator's last merged state
(scrapes are rate-limited by the interval, like /slo's maybe_tick), so
cross-plane byte-identity is structural here too.

Configuration: `configure([urls], interval_s=...)` explicitly, or
`$CELESTIA_FLEET_PEERS` (comma-separated base URLs) +
`$CELESTIA_FLEET_INTERVAL_S` lazily on the first /fleet request.

On a fleet fast-burn page (merged burn >= the spec's paging threshold)
the aggregator drops a `fleet_fast_burn` flight bundle whose context
carries `peer_bundle_index()` — the per-node black boxes of a shared
$CELESTIA_FLIGHT_DIR, attributable by filename since bundles are
node_id-stamped.

The port's copy of celestia_app_tpu/trace/fleet.py, whole: the same parse,
merge, rates, SLO burn, gauges and page on the port's registry.  A peer's
`device` block carries its ledger's measured bytes, from
`torch.cuda.memory_stats` on a node that has run on its card.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time

from celestia_app_tpu_torch.trace.metrics import Histogram, HistogramSnapshot

#: Routes this module publishes on the shared exposition handler
#: (trace_lint rule 7: every one must have a README endpoint-table row).
FLEET_ROUTES = ("/fleet", "/das/coverage")

#: The peer paths one scrape round pulls.
SCRAPE_PATHS = ("/metrics", "/healthz", "/slo", "/heal", "/device",
                "/timeline")

DEFAULT_INTERVAL_S = 5.0
DEFAULT_TIMEOUT_S = 2.0

_SAMPLE_RE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(?:\{(.*)\})?$")
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="([^"]*)"')


def parse_prometheus_text(text: str):
    """Parse one /metrics exposition (the trace/metrics.py dialect:
    no escaped quotes or spaces inside label values) into

        (kinds, scalars, histograms)

    where `kinds` maps family -> counter/gauge/histogram, `scalars` maps
    counter/gauge family -> {sorted-label-tuple: value} (the Counter
    children key shape), and `histograms` maps family ->
    HistogramSnapshot rebuilt from the cumulative _bucket lines (counts
    de-cumulated per child, +Inf tail restored) — the merge-ready form
    `Histogram.merge` consumes."""
    kinds: dict[str, str] = {}
    scalars: dict[str, dict[tuple, float]] = {}
    raw_hists: dict[str, dict[tuple, dict]] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            if line.startswith("# TYPE "):
                parts = line.split()
                if len(parts) >= 4:
                    kinds[parts[2]] = parts[3]
            continue
        name_part, _, value_part = line.rpartition(" ")
        try:
            value = float(value_part)
        except ValueError:
            continue
        m = _SAMPLE_RE.match(name_part)
        if m is None:
            continue
        name, labels_raw = m.group(1), m.group(2) or ""
        labels = dict(_LABEL_RE.findall(labels_raw))
        base = None
        for suffix in ("_bucket", "_sum", "_count"):
            cand = name[:-len(suffix)] if name.endswith(suffix) else None
            if cand and kinds.get(cand) == "histogram":
                base, part = cand, suffix
                break
        if base is not None:
            le = labels.pop("le", None)
            key = tuple(sorted(labels.items()))
            child = raw_hists.setdefault(base, {}).setdefault(
                key, {"cum": {}, "sum": 0.0}
            )
            if part == "_bucket" and le is not None:
                child["cum"][
                    float("inf") if le == "+Inf" else float(le)
                ] = value
            elif part == "_sum":
                child["sum"] = value
            continue
        scalars.setdefault(name, {})[tuple(sorted(labels.items()))] = value
    hists: dict[str, HistogramSnapshot] = {}
    for name, children in raw_hists.items():
        bounds = sorted({
            b for ch in children.values() for b in ch["cum"]
            if b != float("inf")
        })
        buckets = tuple(bounds)
        snap_children = {}
        for key, ch in children.items():
            counts, prev = [], 0.0
            for b in buckets:
                cum = ch["cum"].get(b, prev)
                counts.append(max(0, int(round(cum - prev))))
                prev = cum
            tail = ch["cum"].get(float("inf"), prev)
            counts.append(max(0, int(round(tail - prev))))
            snap_children[key] = (counts, ch["sum"])
        hists[name] = HistogramSnapshot(buckets, snap_children)
    return kinds, scalars, hists


def _sum_family(scalars: dict, name: str) -> float:
    return float(sum(scalars.get(name, {}).values()))


def _round6(v):
    return None if v is None else round(float(v), 6)


def _http_fetch(url: str, path: str, timeout_s: float) -> str:
    import urllib.request

    with urllib.request.urlopen(url + path, timeout=timeout_s) as resp:
        return resp.read().decode()


class FleetAggregator:
    """Scrapes `peers` and keeps the last two merged rounds (rates and
    SLO deltas need a window).  `fetch(url, path) -> text` is the test
    seam; the default is urllib with a per-request timeout."""

    def __init__(self, peers, interval_s: float | None = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S, fetch=None):
        self.peers = tuple(peers)
        self.interval_s = (
            float(interval_s) if interval_s is not None else DEFAULT_INTERVAL_S
        )
        self.timeout_s = timeout_s
        self._fetch = fetch or (
            lambda url, path: _http_fetch(url, path, self.timeout_s)
        )
        self._lock = threading.RLock()
        self._rounds: list[dict] = []  # last two scrape rounds
        self._state: dict | None = None
        self._last_scrape: float | None = None  # monotonic
        self._burning: set[str] = set()  # fleet-fast-burning SLO names

    # --- scraping -----------------------------------------------------------
    def _scrape_peer(self, url: str) -> dict:
        try:
            metrics_text = self._fetch(url, "/metrics")
            healthz = json.loads(self._fetch(url, "/healthz"))
            slo = json.loads(self._fetch(url, "/slo"))
            heal = json.loads(self._fetch(url, "/heal"))
        except Exception as e:  # noqa: BLE001 — a dead peer is a DATUM
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        try:
            # A peer predating the device ledger still merges — its host
            # row just carries no device block (rolling-upgrade safety).
            device = json.loads(self._fetch(url, "/device"))
        except Exception:  # noqa: BLE001 — optional surface
            device = None
        try:
            # Same rolling-upgrade stance for the height timeline.
            timeline = json.loads(self._fetch(url, "/timeline"))
        except Exception:  # noqa: BLE001 — optional surface
            timeline = None
        kinds, scalars, hists = parse_prometheus_text(metrics_text)
        return {
            "ok": True,
            "kinds": kinds,
            "scalars": scalars,
            "hists": hists,
            "healthz": healthz,
            "slo": slo,
            "heal": heal,
            "device": device,
            "timeline": timeline,
        }

    def scrape(self) -> dict:
        """One full round over every peer, then re-merge.  Returns the
        merged state (also retained for payload())."""
        mono = time.monotonic()
        wall_ms = int(time.time() * 1000)
        round_data: dict = {"mono": mono, "wall_ms": wall_ms, "peers": {}}
        for url in self.peers:
            round_data["peers"][url] = self._scrape_peer(url)
        with self._lock:
            self._rounds.append(round_data)
            del self._rounds[:-2]
            self._last_scrape = mono
            state = self._merge_locked()
            self._state = state
        self._publish(state)
        self._maybe_page(state)
        return state

    def maybe_scrape(self) -> None:
        """Scrape at most once per interval — the /slo maybe_tick
        pattern, which is what keeps GET /fleet pure (and byte-identical
        across planes) between rounds."""
        with self._lock:
            due = (
                self._last_scrape is None
                or time.monotonic() - self._last_scrape >= self.interval_s
            )
        if due:
            self.scrape()

    # --- merging ------------------------------------------------------------
    def _merge_locked(self) -> dict:
        cur = self._rounds[-1]
        prev = self._rounds[-2] if len(self._rounds) > 1 else None
        dt = (cur["mono"] - prev["mono"]) if prev is not None else None
        hosts: dict = {}
        ok_urls = []
        for url in self.peers:
            d = cur["peers"][url]
            if not d["ok"]:
                hosts[url] = {
                    "reachable": False,
                    "peer_unreachable": True,
                    "error": d["error"],
                }
                continue
            ok_urls.append(url)
            proofs_total = _sum_family(d["scalars"],
                                       "celestia_proofs_served_total")
            per_s = None
            if prev is not None and dt and prev["peers"][url]["ok"]:
                prev_total = _sum_family(
                    prev["peers"][url]["scalars"],
                    "celestia_proofs_served_total",
                )
                per_s = max(0.0, proofs_total - prev_total) / dt
            quarantined = sorted({
                h
                for eng in d["heal"].get("engines", {}).values()
                for h in (eng.get("quarantined") or {})
            })
            hosts[url] = {
                "reachable": True,
                "peer_unreachable": False,
                "status": d["healthz"].get("status"),
                "degraded": d["healthz"].get("degraded") or {},
                "proofs_served_total": proofs_total,
                "proofs_per_s": _round6(per_s),
                "qos_throttled_total": _sum_family(
                    d["scalars"], "celestia_qos_throttled_total"
                ),
                "quarantined_heights": quarantined,
                "slo": {
                    name: {"state": s.get("state"), "burn": s.get("burn")}
                    for name, s in d["slo"].get("slos", {}).items()
                },
            }
            dev = d.get("device")
            if dev is not None:
                own = dev.get("ownership") or {}
                hosts[url]["device"] = {
                    "programs": len(dev.get("programs") or []),
                    "programs_resident": sum(
                        (dev.get("programs_resident") or {}).values()
                    ),
                    "owned_bytes": own.get("owned_bytes"),
                    "measured_bytes": own.get("measured_bytes"),
                    "unattributed_residual": own.get("unattributed_residual"),
                }
            from celestia_app_tpu_torch.trace.timeline import fleet_block

            tl = fleet_block(d.get("timeline"))
            if tl is not None:
                hosts[url]["timeline"] = tl

        def merged_hist(round_data, name):
            return Histogram.merge([
                round_data["peers"][u]["hists"][name]
                for u in self.peers
                if round_data["peers"][u]["ok"]
                and name in round_data["peers"][u]["hists"]
            ])

        lat = merged_hist(cur, "celestia_proof_latency_seconds")
        fleet: dict = {
            "hosts_total": len(self.peers),
            "hosts_reachable": len(ok_urls),
            "proofs_served_total": sum(
                hosts[u]["proofs_served_total"] for u in ok_urls
            ),
            "proof_latency": {
                "p50_s": _round6(lat.quantile(0.5, phase="total")),
                "p99_s": _round6(lat.quantile(0.99, phase="total")),
                "samples": lat.count(phase="total"),
            },
            # Device-attribution rollup across hosts that serve /device:
            # the cluster's resident-program count and claimed-vs-slack
            # bytes in one block (per-host detail in hosts[url]["device"]).
            "device": {
                "programs_resident": sum(
                    hosts[u]["device"]["programs_resident"]
                    for u in ok_urls if "device" in hosts[u]
                ),
                "owned_bytes": sum(
                    hosts[u]["device"]["owned_bytes"] or 0
                    for u in ok_urls if "device" in hosts[u]
                ),
                "unattributed_residual": sum(
                    hosts[u]["device"]["unattributed_residual"] or 0
                    for u in ok_urls if "device" in hosts[u]
                ),
                "hosts_reporting": sum(
                    1 for u in ok_urls if "device" in hosts[u]
                ),
            },
        }
        # Fleet-level SLO burn: the per-node engine's own quantile specs
        # judged over the MERGED bucket delta of the last scrape window.
        # Budget-normalized exactly like trace/slo.py (burn 1.0 =
        # consuming error budget exactly), the window being the scrape
        # interval — a fleet-wide fast window.
        from celestia_app_tpu_torch.trace.slo import engine

        slo_block: dict = {}
        if prev is not None and dt:
            for spec in engine().specs:
                if spec.kind != "quantile":
                    continue
                try:
                    now_snap = merged_hist(cur, spec.metric)
                    prev_snap = merged_hist(prev, spec.metric)
                except ValueError:
                    continue  # peers disagree on bucket layout: skip
                if not now_snap.children:
                    continue
                delta = (
                    now_snap.delta(prev_snap)
                    if prev_snap.children else now_snap
                )
                bad = delta.fraction_over(
                    spec.threshold, **dict(spec.labels)
                )
                if bad is None:
                    continue
                burn = bad / spec.effective_budget()
                slo_block[spec.name] = {
                    "burn": _round6(burn),
                    "window_s": _round6(dt),
                    "paging": burn >= spec.fast_burn,
                }
        fleet["slo"] = slo_block
        return {
            "node_id": _own_node_id(),
            "scraped_unix_ms": cur["wall_ms"],
            "interval_s": self.interval_s,
            "hosts": hosts,
            "fleet": fleet,
        }

    # --- exports ------------------------------------------------------------
    def _publish(self, state: dict) -> None:
        """The celestia_fleet_* families — the merged view in the same
        exposition the per-node families live in."""
        from celestia_app_tpu_torch.trace.metrics import registry

        reg = registry()
        hosts = state["hosts"]
        reachable = sum(1 for h in hosts.values() if h["reachable"])
        peers_g = reg.gauge(
            "celestia_fleet_peers",
            "configured fleet peers by scrape outcome",
        )
        peers_g.set(float(reachable), state="reachable")
        peers_g.set(float(len(hosts) - reachable), state="unreachable")
        unreachable_g = reg.gauge(
            "celestia_fleet_peer_unreachable",
            "1 when the last scrape of this peer failed (staleness "
            "marker: the host row is stale, not silently dropped)",
        )
        per_s_g = reg.gauge(
            "celestia_fleet_proofs_per_s",
            "per-host proofs served per second over the last scrape "
            "window",
        )
        quarantined_g = reg.gauge(
            "celestia_fleet_quarantined_heights",
            "per-host count of quarantined heights (serve/heal.py)",
        )
        throttled_g = reg.gauge(
            "celestia_fleet_qos_throttled_total",
            "per-host cumulative QoS refusals as last scraped",
        )
        for url, h in hosts.items():
            unreachable_g.set(
                0.0 if h["reachable"] else 1.0, peer=url
            )
            if not h["reachable"]:
                continue
            if h["proofs_per_s"] is not None:
                per_s_g.set(h["proofs_per_s"], peer=url)
            quarantined_g.set(
                float(len(h["quarantined_heights"])), peer=url
            )
            throttled_g.set(h["qos_throttled_total"], peer=url)
        lat = state["fleet"]["proof_latency"]
        lat_g = reg.gauge(
            "celestia_fleet_proof_latency_seconds",
            "cross-host DAS proof latency quantiles off the bucket-"
            "merged per-host histograms",
        )
        for q in ("p50_s", "p99_s"):
            if lat[q] is not None:
                lat_g.set(lat[q], q=q[:-2])
        burn_g = reg.gauge(
            "celestia_fleet_slo_burn_rate",
            "budget-normalized fleet burn per SLO over the merged "
            "scrape-window delta",
        )
        for name, s in state["fleet"]["slo"].items():
            if s["burn"] is not None:
                burn_g.set(s["burn"], slo=name)

    def _maybe_page(self, state: dict) -> None:
        """Edge-detect fleet fast burn and drop ONE bundle per
        transition, its context pointing at the peers' own bundles."""
        from celestia_app_tpu_torch.trace.flight_recorder import (
            note_trigger,
            peer_bundle_index,
        )

        paging = {
            name for name, s in state["fleet"]["slo"].items() if s["paging"]
        }
        with self._lock:
            new = paging - self._burning
            self._burning = paging
        for name in sorted(new):
            note_trigger(
                "fleet_fast_burn",
                slo=name,
                burn=state["fleet"]["slo"][name]["burn"],
                hosts_reachable=state["fleet"]["hosts_reachable"],
                peer_bundles=peer_bundle_index(),
            )

    def payload(self) -> dict:
        """The last merged state (scrape() first if none yet) — what
        GET /fleet renders."""
        with self._lock:
            state = self._state
        return state if state is not None else self.scrape()


def _own_node_id() -> str:
    from celestia_app_tpu_torch.trace.context import node_id

    return node_id()


_AGG_LOCK = threading.Lock()
_AGGREGATOR: FleetAggregator | None = None


def configure(peers, interval_s: float | None = None,
              timeout_s: float = DEFAULT_TIMEOUT_S,
              fetch=None) -> FleetAggregator:
    """Install the process's aggregator (last call wins); returns it."""
    global _AGGREGATOR
    agg = FleetAggregator(peers, interval_s=interval_s,
                          timeout_s=timeout_s, fetch=fetch)
    with _AGG_LOCK:
        _AGGREGATOR = agg
    return agg


def aggregator() -> FleetAggregator | None:
    """The installed aggregator, lazily built from $CELESTIA_FLEET_PEERS
    on first ask; None when the fleet plane is unconfigured."""
    global _AGGREGATOR
    with _AGG_LOCK:
        if _AGGREGATOR is not None:
            return _AGGREGATOR
    peers = [
        u.strip()
        for u in os.environ.get("CELESTIA_FLEET_PEERS", "").split(",")
        if u.strip()
    ]
    if not peers:
        return None
    try:
        interval = float(
            os.environ.get("CELESTIA_FLEET_INTERVAL_S", "")
            or DEFAULT_INTERVAL_S
        )
    except ValueError:
        interval = DEFAULT_INTERVAL_S
    return configure(peers, interval_s=interval)


def _reset_for_tests() -> None:
    global _AGGREGATOR
    with _AGG_LOCK:
        _AGGREGATOR = None


def fleet_response():
    """GET /fleet -> (status, content_type, bytes): the merged view, or
    a 503 when no aggregator is configured.  Canonical render (sorted
    keys, compact separators — the serve/api.render shape) so the bytes
    are a pure function of the merged state on every plane."""
    agg = aggregator()
    if agg is None:
        return 503, "application/json", json.dumps({
            "error": "no fleet aggregator configured "
                     "(set $CELESTIA_FLEET_PEERS or trace.fleet.configure())"
        }).encode()
    agg.maybe_scrape()
    return 200, "application/json", json.dumps(
        agg.payload(), sort_keys=True, separators=(",", ":")
    ).encode()
