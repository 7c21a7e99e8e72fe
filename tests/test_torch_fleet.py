"""The port's fleet aggregator (trace/fleet.py), held against the JAX
package: the same exposition texts, through the `fetch` seam, go into a
port and a JAX FleetAggregator, with the clocks injected.  The parsed
scrapes, the merged rounds (sums, bucket-merged quantiles, per-host rates,
the fleet SLO burn and its page), the dead-peer row, the published
celestia_fleet_* gauges and the /fleet bytes are equal.  Then one live
port NodeServer (device="cpu") is scraped over HTTP, beside a stopped
URL: the port aggregator's merge of it equals the JAX aggregator's merge of
the same recorded pages.
"""

from __future__ import annotations

import json
import types

import pytest

from celestia_app_tpu.trace import fleet as jax_fleet
from celestia_app_tpu.trace import metrics as jax_metrics
from celestia_app_tpu.trace import slo as jax_slo
from celestia_app_tpu_torch.rpc.server import ServingNode, serve
from celestia_app_tpu_torch.testutil import deterministic_genesis, funded_keys
from celestia_app_tpu_torch.testutil.blocks import block_txs
from celestia_app_tpu_torch.trace import fleet, metrics, slo

BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0)
NOW = 1_700_000_000.0
PACKAGES = ((fleet, metrics, slo), (jax_fleet, jax_metrics, jax_slo))


class _Clock:
    """A stepped monotonic clock: `step` seconds per call."""

    def __init__(self, start: float, step: float):
        self.t, self.step = start, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Fresh registries, default SLO engines and no aggregator in both
    packages; each fleet module's clock replaced by a stepped one."""
    monkeypatch.delenv("CELESTIA_FLEET_PEERS", raising=False)
    for fl, met, sl in PACKAGES:
        monkeypatch.setattr(met, "_REGISTRY", met.Registry())
        monkeypatch.setattr(fl, "time", types.SimpleNamespace(
            monotonic=_Clock(1000.0, 2.5), time=lambda: NOW))
        sl._reset_for_tests()
        fl._reset_for_tests()
    yield
    for fl, _, sl in PACKAGES:
        fl._reset_for_tests()
        sl._reset_for_tests()


def peer_registry(latencies, proofs_total: float, throttled: float = 0.0) -> metrics.Registry:
    """A stub peer's registry: the families the aggregator merges."""
    r = metrics.Registry()
    h = r.histogram("celestia_proof_latency_seconds", "lat", buckets=BUCKETS)
    for v in latencies:
        h.observe(v, phase="total")
    r.counter("celestia_proofs_served_total", "served").inc(
        proofs_total, plane="jsonrpc", kind="share_proof")
    if throttled:
        r.counter("celestia_qos_throttled_total", "qos").inc(
            throttled, namespace="t01", kind="proof_rate")
    r.gauge("celestia_square_last_occupancy_ratio", "occ").set(0.25)
    return r


def pages(reg: metrics.Registry, status: str = "SERVING", quarantined=(), device=None,
          timeline=None) -> dict:
    out = {
        "/metrics": reg.render(),
        "/healthz": json.dumps({"status": status,
                                "degraded": {"device": "staged"} if status == "DEGRADED" else {}}),
        "/slo": json.dumps({"slos": {"proof_p99": {"state": "ok", "burn": 0.0}}}),
        "/heal": json.dumps({"engines": {"node:1": {"quarantined": {str(h): {} for h in
                                                                      quarantined}}}}),
    }
    if device is not None:
        out["/device"] = json.dumps(device)
    if timeline is not None:
        out["/timeline"] = json.dumps(timeline)
    return out


def stub_fetch(peer_pages: dict):
    """fetch(url, path) over {url: {path: text}}; an absent url or path
    raises like a dead socket."""

    def fetch(url, path):
        site = peer_pages.get(url)
        if site is None:
            raise OSError("connection refused")
        if path not in site:
            raise OSError(f"404 {path}")
        return site[path]

    return fetch


DEVICE = {"programs": [{"family": "forest"}, {"family": "extend"}],
          "programs_resident": {"forest": 1, "extend": 1},
          "ownership": {"owned_bytes": 4096, "measured_bytes": 1 << 30,
                        "unattributed_residual": (1 << 30) - 4096}}


def three_peers(round_: int) -> dict:
    return {
        "http://a": pages(peer_registry([0.02, 0.02, 0.3] + [0.7] * round_, 10.0 + 60 * round_),
                          device=DEVICE),
        "http://b": pages(peer_registry([0.02, 0.7], 20.0, throttled=3.0), status="DEGRADED",
                          quarantined=(7, 9)),
        "http://c": pages(peer_registry([0.05, 0.05, 0.05, 0.9], 30.0 + round_)),
    }


def test_parse_prometheus_text_equal_jax():
    reg = peer_registry([0.02, 0.02, 0.3, 0.7, 3.0], 41.0, throttled=3.0)
    reg.gauge("celestia_fleet_peers", "peers").set(2.0, state="reachable")
    text = reg.render()
    kinds, scalars, hists = fleet.parse_prometheus_text(text)
    j_kinds, j_scalars, j_hists = jax_fleet.parse_prometheus_text(text)
    assert kinds == j_kinds and scalars == j_scalars
    assert set(hists) == set(j_hists)
    for name, snap in hists.items():
        assert snap.buckets == j_hists[name].buckets
        assert snap.children == j_hists[name].children
        for q in (0.5, 0.99):
            assert snap.quantile(q, phase="total") == j_hists[name].quantile(q, phase="total")
    assert fleet._sum_family(scalars, "celestia_proofs_served_total") == 41.0


FLEET_FAMILIES = {
    "celestia_fleet_peer_unreachable", "celestia_fleet_peers",
    "celestia_fleet_proof_latency_seconds", "celestia_fleet_proofs_per_s",
    "celestia_fleet_qos_throttled_total", "celestia_fleet_quarantined_heights",
    "celestia_fleet_slo_burn_rate",
}


def fleet_families(text: str) -> list[str]:
    """The lines of an exposition text that belong to celestia_fleet_*
    families (samples, and their HELP and TYPE lines)."""
    return [line for line in text.splitlines()
            if (line.split()[2] if line.startswith("#") else line).startswith("celestia_fleet_")]


def test_merged_rounds_equal_jax():
    site = three_peers(0)
    fetch = stub_fetch(site)
    urls = [*site, "http://down"]
    aggs = [fl.configure(urls, interval_s=3600, fetch=fetch) for fl, _, _ in PACKAGES]
    states = [agg.scrape() for agg in aggs]
    assert json.dumps(states[0], sort_keys=True) == json.dumps(states[1], sort_keys=True)
    first = states[0]
    assert first["fleet"]["hosts_total"] == 4 and first["fleet"]["hosts_reachable"] == 3
    assert first["fleet"]["proofs_served_total"] == 60.0
    assert first["hosts"]["http://down"] == {
        "reachable": False, "peer_unreachable": True,
        "error": "OSError: connection refused"}
    assert first["hosts"]["http://b"]["quarantined_heights"] == ["7", "9"]
    assert first["hosts"]["http://a"]["device"]["programs_resident"] == 2
    # The second round: 60 more proofs and slow samples on one host.
    site.update(three_peers(1))
    states = [agg.scrape() for agg in aggs]
    assert json.dumps(states[0], sort_keys=True) == json.dumps(states[1], sort_keys=True)
    second = states[0]
    assert second["hosts"]["http://a"]["proofs_per_s"] == 24.0  # 60 over the 2.5 s window
    assert second["fleet"]["slo"]["proof_p99"]["paging"] is True
    # The published celestia_fleet_* families, byte for byte.  Only those:
    # the registries are process-wide, and a thread or finalizer left by
    # another test in this process may write other families into either.
    port_fleet, jax_fleet_text = (fleet_families(met.registry().render())
                                  for met in (metrics, jax_metrics))
    assert port_fleet == jax_fleet_text
    assert {line.split()[2] for line in port_fleet if line.startswith("# TYPE")} == FLEET_FAMILIES
    # GET /fleet inside the interval serves the same bytes in both packages.
    bodies = [fl.fleet_response() for fl, _, _ in PACKAGES]
    assert bodies[0] == bodies[1] and bodies[0][0] == 200
    assert json.loads(bodies[0][2]) == json.loads(json.dumps(second))


def test_unconfigured_and_env_configured_equal_jax(monkeypatch):
    assert fleet.fleet_response() == jax_fleet.fleet_response()
    assert fleet.fleet_response()[0] == 503 and fleet.aggregator() is None
    monkeypatch.setenv("CELESTIA_FLEET_PEERS", " http://x , http://y,")
    monkeypatch.setenv("CELESTIA_FLEET_INTERVAL_S", "7.5")
    aggs = [fl.aggregator() for fl, _, _ in PACKAGES]
    assert [(a.peers, a.interval_s) for a in aggs] == [(("http://x", "http://y"), 7.5)] * 2
    monkeypatch.setenv("CELESTIA_FLEET_INTERVAL_S", "soon")
    for fl, _, _ in PACKAGES:
        fl._reset_for_tests()
    assert fleet.aggregator().interval_s == jax_fleet.aggregator().interval_s == 5.0


def test_live_port_node_scraped_over_http():
    """One port NodeServer with a committed block, scraped over HTTP beside
    a stopped URL: two rounds through the default fetch, then the recorded
    pages replayed into a JAX aggregator merge to the same state."""
    keys = funded_keys(4)
    node = ServingNode(deterministic_genesis(keys, n_validators=1), keys, device="cpu")
    for raw in block_txs(keys, node.app.chain_id, seed=16, sends=1, pfbs=2, blob_shares=(1, 2)):
        node.broadcast(raw)
    node.produce_block()
    server = serve(node, port=0, block_interval_s=None)
    dead = serve(ServingNode(deterministic_genesis(keys, n_validators=1), keys, device="cpu"),
                 port=0, block_interval_s=None)
    dead.stop()
    try:
        recorded: dict = {}

        def recording(url, path):
            try:
                text = fleet._http_fetch(url, path, 5.0)
            except Exception as e:
                recorded.setdefault(url, {})[path] = e
                raise
            recorded.setdefault(url, {})[path] = text
            return text

        def replay(url, path):
            page = recorded[url][path]
            if isinstance(page, Exception):
                raise page
            return page

        agg = fleet.FleetAggregator([server.url, dead.url], interval_s=3600, fetch=recording)
        state = agg.scrape()
        live = state["hosts"][server.url]
        assert live["reachable"] and live["status"] == "SERVING"
        assert live["device"]["measured_bytes"] > 0  # rss_high_water on the CPU
        assert "timeline" in live
        assert state["hosts"][dead.url]["peer_unreachable"] is True
        assert state["fleet"]["hosts_reachable"] == 1
        health = json.loads(recorded[server.url]["/healthz"])
        assert health["layers"][f"node:{server.port}"]["height"] == 1
        theirs = jax_fleet.FleetAggregator([server.url, dead.url], interval_s=3600,
                                           fetch=replay)
        want = theirs.scrape()
        assert json.dumps(state, sort_keys=True) == json.dumps(want, sort_keys=True)
    finally:
        server.stop()
