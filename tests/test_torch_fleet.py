"""Fleet observability (`banjax_tpu_torch/obs/fleet.py` and its seams in
the app, the exposition and the server) against the JAX package's
`banjax_tpu/obs/fleet.py`, on the CPU. The tolerance is exact equality.

- `merge_expositions` on the same texts (counters, gauges, histograms on
  differing bounds, both packages' own /metrics renders with the fabric
  families) gives the same bytes, and the strict parser takes them.
- `FleetScraper` over scripted peers (a live one, one that raises, one
  that returns garbage, one that comes back from its cache) on a
  scripted clock gives the same merged payload and the same fleet SLO
  counters; the health bits, the origin index and the incident capture
  fan-out give the same values.
- The app: three port shards serve HTTP; `/metrics?fleet=1` on one merges
  the live shards (a stopped one flagged unreachable, still a 200),
  `/decisions/explain` for an IP another shard owns is proxied to it,
  and a flight-recorder incident holds the peers' files.
"""

import json
import time
import types
import urllib.request

import pytest

from banjax_tpu.obs import exposition as jax_expo
from banjax_tpu.obs import fleet as jax_fleet
from banjax_tpu.resilience import breaker as jax_breaker
from banjax_tpu.resilience import failpoints as jax_fp
from banjax_tpu_torch import cli as port_cli
from banjax_tpu_torch.fabric import stats as port_fabric_stats
from banjax_tpu_torch.obs import exposition as port_expo
from banjax_tpu_torch.obs import fleet as port_fleet
from banjax_tpu_torch.resilience import breaker as port_breaker
from banjax_tpu_torch.resilience import failpoints as port_fp
from tests.test_torch_fabric import IDS, Fabric, _lines_for, _owner, _wait
from tests.test_torch_matcher import _one_torch_thread  # noqa: F401
from tests.test_torch_obs import obs_reset  # noqa: F401

COUNTER_A = ("# HELP banjax_x_total things\n# TYPE banjax_x_total counter\n"
             'banjax_x_total{kind="a"} 3\nbanjax_x_total{kind="b"} 10\n')
COUNTER_B = ("# HELP banjax_x_total things\n# TYPE banjax_x_total counter\n"
             'banjax_x_total{kind="a"} 4.5\n')
GAUGE = '# HELP banjax_g current state\n# TYPE banjax_g gauge\nbanjax_g{q="x\\"y"} 5\n'
HIST_A = ("# HELP banjax_h_seconds latency\n# TYPE banjax_h_seconds histogram\n"
          'banjax_h_seconds_bucket{le="0.5"} 1\nbanjax_h_seconds_bucket{le="+Inf"} 2\n'
          "banjax_h_seconds_sum 0.9\nbanjax_h_seconds_count 2\n")
HIST_B = ("# HELP banjax_h_seconds latency\n# TYPE banjax_h_seconds histogram\n"
          'banjax_h_seconds_bucket{le="1.0"} 3\nbanjax_h_seconds_bucket{le="+Inf"} 3\n'
          "banjax_h_seconds_sum 1.0\nbanjax_h_seconds_count 3\n")


def _render(pkg_expo, stats):
    lists = types.SimpleNamespace(metrics=lambda: (2, 3))
    return pkg_expo.render_prometheus(lists, [1, 2], [], fabric=stats)


def _fabric_stats(pkg_stats, k):
    s = pkg_stats.FabricStats()
    s.note_forwarded(10 * k + 3)
    s.note_received(7 + k)
    s.note_local(5)
    s.note_peer("a", True)
    s.note_peer("b", k % 2 == 0)
    s.note_member_state("b", ("alive", "suspect", "dead")[k % 3])
    s.note_frame_sent("v2", "tcp", 900 + 100 * k)
    s.note_frame_sent("json", "shm", 70000)
    s.note_ack(0.0004 * (k + 1))
    s.note_takeover("b", 0.02 * k, 40)
    s.note_detection(1.5)
    s.note_peer_health("c", k)
    return s


def test_fabric_exposition_and_merge_match_jax():
    from banjax_tpu.fabric import stats as jax_fabric_stats

    port_texts = {f"n{k}": _render(port_expo, _fabric_stats(port_fabric_stats, k))
                  for k in range(3)}
    jax_texts = {f"n{k}": _render(jax_expo, _fabric_stats(jax_fabric_stats, k))
                 for k in range(3)}
    for name, text in port_texts.items():
        fabric_lines = [ln for ln in text.splitlines() if "fabric" in ln]
        assert fabric_lines == [ln for ln in jax_texts[name].splitlines() if "fabric" in ln]
        assert len(fabric_lines) > 40
        port_expo.parse_text_format(text)
    for texts in (port_texts, {"w0": COUNTER_A + HIST_A + GAUGE, "w1": COUNTER_B + HIST_B},
                  {"w1": HIST_B}, {}):
        merged = port_fleet.merge_expositions(texts)
        assert merged == jax_fleet.merge_expositions(texts)
        port_expo.parse_text_format(merged)


class _Peers:
    """Scripted pulls: ok, raising, garbage, and one that fails after
    its first answer (served from the cache, flagged stale)."""

    def __init__(self):
        self.round = 0

    def __call__(self):
        r = self.round
        self.round += 1

        def flaky():
            if r:
                raise OSError("gone")
            return COUNTER_A + HIST_B

        def boom():
            raise OSError("refused")

        return {"ok": lambda: COUNTER_B + GAUGE + HIST_A, "boom": boom,
                "garbage": lambda: "not { a metric", "flaky": flaky, "self": lambda: ""}


def _scrapes(fleet):
    now = [50.0]
    s = fleet.FleetScraper("self", lambda: COUNTER_A + HIST_A, _Peers(), timeout_s=0.01,
                           clock=lambda: now[0])
    out = []
    for _ in range(3):
        out.append(s.scrape())
        out.append(s.fleet_collect())
        now[0] += 2.5
    empty = fleet.FleetScraper("", lambda: "", None)
    out.append((empty.node_id, empty.fleet_collect()))
    return out


def test_scraper_output_matches_jax():
    port, jax = _scrapes(port_fleet), _scrapes(jax_fleet)
    assert port == jax
    assert 'banjax_fleet_peer_unreachable{instance="boom"} 1' in port[0]
    assert 'banjax_fleet_peer_staleness_seconds{instance="flaky"} 2.5' in port[2]


def test_health_bits_origin_index_and_capture_match_jax():
    def bits(fleet, brk):
        out = []
        for breached in (False, True):
            slo = types.SimpleNamespace(breached=lambda b=breached: {"x": b, "y": False})
            for state in (brk.CLOSED, brk.OPEN, brk.HALF_OPEN):
                m = types.SimpleNamespace(breaker=types.SimpleNamespace(state=state))
                out.append(fleet.compute_health_bits(slo=slo, matcher=m))
        bad = types.SimpleNamespace(breached=lambda: 1 / 0)
        out.append(fleet.compute_health_bits(slo=bad, matcher=object()))
        out.append((fleet.HEALTH_SLO_BREACHED, fleet.HEALTH_BREAKER_OPEN,
                    fleet.HEALTH_BREAKER_HALF_OPEN))
        return out

    assert bits(port_fleet, port_breaker) == bits(jax_fleet, jax_breaker)
    assert bits(port_fleet, port_breaker)[:6] == [0, 2, 4, 1, 3, 5]

    def index(fleet):
        idx = fleet.OriginIndex(max_entries=20, clock=lambda: 1.0)
        for i in range(40):
            idx.note(f"10.0.0.{i % 25}", f"n{i % 3}", i)
        idx.note("10.9.9.9", "", 5)
        return len(idx), [idx.resolve(f"10.0.0.{i}") for i in range(25)], idx.resolve("10.9.9.9")

    assert index(port_fleet) == index(jax_fleet)

    def capture(fleet, fp):
        def ok(incident):
            return {"metrics.prom": f"# {incident}\n", "../escape": "x", "a/b": "y", "n": 3}

        def dead(incident):
            raise OSError("peer down")

        out = [fleet.capture_fleet("inc-1", lambda: {"b": ok, "c": dead, "d": lambda i: "x"}),
               fleet.capture_fleet("inc-2", lambda: 1 / 0)]
        fp.arm("obs.fleet.capture", count=1)
        try:
            out.append(fleet.capture_fleet("inc-3", lambda: {"b": ok, "c": ok}))
        finally:
            fp.disarm()
        files = fleet.local_capture_files(metrics_text_fn=lambda: "# m\n",
                                          fabric_fn=lambda: {"node_id": "x"})
        out.append(sorted(files))
        out.append({k: files[k] for k in ("metrics.prom", "fabric.json")})
        return out

    port, jax = capture(port_fleet, port_fp), capture(jax_fleet, jax_fp)
    assert port[:3] == [[{k: v for k, v in d.items()} for d in [x]][0] for x in jax[:3]]
    assert port[3:] == jax[3:]
    assert port[3] == ["fabric.json", "metrics.prom", "provenance.json", "trace.json"]


# ------------------------------------------------------------------ the app

@pytest.fixture(autouse=True)
def _ipset_off(monkeypatch):
    monkeypatch.setattr(port_cli, "init_ipset", lambda *a, **k: None)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.read().decode()


def test_fleet_metrics_explain_proxy_and_incident_capture_in_the_app(tmp_path):
    f = Fabric(tmp_path, "port", gossip_ms=80, http=True, extra_keys=dict(
        fleet_metrics_enabled=True, fleet_scrape_timeout_ms=500, flightrec_fleet_capture=True,
        flightrec_dir=str(tmp_path / "incidents"), flightrec_min_interval_s=0.0))
    try:
        now = time.time()
        lines = {n: _lines_for(k, now, 160, seed=30 + k) for k, n in enumerate(IDS)}
        for n in IDS:
            f.append(n, lines[n])
        f.settle(sum(map(len, lines.values())))
        bans = f.bans()
        asker = f.apps["a"]
        status, text = _get(asker.port, "/metrics?fleet=1")
        assert status == 200
        parsed = port_expo.parse_text_format(text)
        unreachable = {s[1]["instance"]: s[2]
                       for s in parsed["banjax_fleet_peer_unreachable"]["samples"]}
        assert unreachable == {"a": 0, "b": 0, "c": 0}
        forwarded = sum(s[2] for s in parsed["banjax_fabric_forwarded_lines_total"]["samples"])
        assert forwarded == sum(a.fabric.stats.peek()["FabricForwardedLines"]
                                for a in f.apps.values())
        status, own = _get(asker.port, "/metrics")
        assert status == 200 and "banjax_fabric_ack_rtt_seconds_bucket" in own
        # an IP another shard owns is explained by its owner
        remote = next(ip for ip in bans if _owner(ip) != "a")
        status, body = _get(asker.port, f"/decisions/explain?ip={remote}")
        payload = json.loads(body)
        assert status == 200 and payload["proxied"] is True
        assert payload["owning_node"] == payload["node_id"] == _owner(remote)
        assert payload["active_decision"] is not None and payload["records"]
        local = next(ip for ip in bans if _owner(ip) == "a")
        payload = json.loads(_get(asker.port, f"/decisions/explain?ip={local}")[1])
        assert payload["node_id"] == "a" and "proxied" not in payload
        # an incident on one shard holds every alive peer's files
        name = asker.flightrec.notify("fleet-test", "drill")
        assert name
        listed = {e["name"]: e for e in asker.flightrec.list_incidents()}[name]["files"]
        for peer in ("b", "c"):
            for fname in ("metrics.prom", "fabric.json", "provenance.json", "trace.json"):
                assert f"peers/{peer}/{fname}" in listed
                assert asker.flightrec.read_file(name, f"peers/{peer}/{fname}")
        assert json.loads(asker.flightrec.read_file(name, "fabric.json"))["node_id"] == "a"
        assert asker.flightrec.read_file(name, "peers/../meta.json") is None
        # a stopped shard: flagged, never a 500
        f.kill("b")
        status, text = _get(asker.port, "/metrics?fleet=1")
        assert status == 200
        parsed = port_expo.parse_text_format(text)
        flags = {s[1]["instance"]: s[2] for s in parsed["banjax_fleet_peer_unreachable"]["samples"]}
        assert flags["b"] == 1 and flags["c"] == 0
        _wait(lambda: asker.fabric.membership.status_of("b") == "dead", "b confirmed dead")
        status, text = _get(asker.port, "/metrics?fleet=1")
        assert status == 200 and 'instance="b"' not in text.split("banjax_fleet_peer_unreachable")[-1]
    finally:
        f.close()
