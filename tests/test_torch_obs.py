"""The observability plane (`banjax_tpu_torch/obs/`) against the JAX
package's, on the CPU.

- The registry: every family the port declares equals the JAX entry
  (name, type, help, label names), and the JAX families it leaves out are
  exactly the keys whose meaning would differ (every module is ported,
  the mesh's families are in); the fabric and fleet families are in; the histograms, `MatcherStats` and `PipelineStats` views and
  the strict text-format parser behave as JAX's.
- The tracer and the provenance ledger on one call sequence; the SLO
  engine's burn rates and breaches on a virtual clock; the flight
  recorder's bundles.
- The chain's scripted stream (tests/test_torch_decision_chain.py): the
  same provenance records (static and UA lists, challenge failures,
  expiries) and `challenge.sha_inv` spans; the chain's failpoints raise
  as JAX's do, and `challenge.device_verify`'s deliberate difference is
  pinned (the port's verifier fails the request, JAX falls back).
- Ban logs byte-identical with tracing (and the profiler bridge) on and
  off through the pipeline scheduler, with one span tree a batch.

`obs_reset` (autouse, imported by the other port test files that build
apps) leaves both packages' tracer, ledger, flight recorder, failpoints
and kernel-edge counters as it found them.
"""

import io
import json
import random
import time

import pytest

from banjax_tpu.challenge.stats import get_stats as jax_challenge_stats
from banjax_tpu.effectors.ipset_stats import get_stats as jax_ipset_stats
from banjax_tpu.httpapi import decision_chain as jax_chain
from banjax_tpu.obs import exposition as jax_expo
from banjax_tpu.obs import flightrec as jax_flightrec
from banjax_tpu.obs import provenance as jax_prov
from banjax_tpu.obs import registry as jax_reg
from banjax_tpu.obs import slo as jax_slo
from banjax_tpu.obs import stats as jax_stats
from banjax_tpu.obs import trace as jax_trace
from banjax_tpu.pipeline import scheduler as jax_sched_mod
from banjax_tpu.resilience import failpoints as jax_fp
from banjax_tpu.scenarios.stats import get_stats as jax_scenario_stats
from banjax_tpu_torch.challenge.stats import get_stats as port_challenge_stats
from banjax_tpu_torch.scenarios.stats import get_stats as port_scenario_stats
from banjax_tpu_torch.httpapi import decision_chain as port_chain
from banjax_tpu_torch.obs import exposition as port_expo
from banjax_tpu_torch.obs import flightrec as port_flightrec
from banjax_tpu_torch.obs import provenance as port_prov
from banjax_tpu_torch.obs import registry as port_reg
from banjax_tpu_torch.obs import slo as port_slo
from banjax_tpu_torch.obs import stats as port_stats
from banjax_tpu_torch.obs import trace as port_trace
from banjax_tpu_torch.pipeline import scheduler as port_sched_mod
from banjax_tpu_torch.resilience import failpoints as port_fp
from tests.test_torch_decision_chain import pinned  # noqa: F401
from tests.test_torch_matcher import _one_torch_thread  # noqa: F401


def _reset_obs():
    for tr in (port_trace, jax_trace):
        tr.configure(enabled=False)
    for pv in (port_prov, jax_prov):
        pv.configure(enabled=True)
    for fr in (port_flightrec, jax_flightrec):
        fr.install(None)
    for fp in (port_fp, jax_fp):
        fp.disarm()
    for st in (jax_ipset_stats(), jax_challenge_stats(), port_challenge_stats(),
               jax_scenario_stats(), port_scenario_stats()):
        st.reset()


@pytest.fixture(autouse=True)
def obs_reset():
    """Both packages' process-wide observability state, as found."""
    _reset_obs()
    yield
    _reset_obs()


# ------------------------------------------------------------ the registry

# JAX keys whose meaning in the port would differ, or that the port does
# not count (ROADMAP Queue 3)
DIFFERENT_MEANING = {
    "MatcherCpuFallbackBatches", "MatcherBudgetTrips", "MatcherH2dBytesTotal",
    "MatcherD2hBytesTotal", "MatcherH2dBytesPerBatch", "MatcherD2hBytesPerBatch",
    "SingleKernelD2hBytesPerBatch", "SketchAdmissionFpRate",
}
# JAX families of modules the port does not have: none
NOT_PORTED_MODULES = ()


def _key(f):
    return (f.line_key, f.prom)


def test_registry_entries_equal_jax():
    jax = {_key(f): f for f in jax_reg.FAMILIES}
    for f in port_reg.FAMILIES:
        j = jax[_key(f)]
        assert (f.kind, f.help, f.line_key, f.prom, f.labels) == \
            (j.kind, j.help, j.line_key, j.prom, j.labels), _key(f)
    assert port_reg.REFERENCE_LINE_KEYS == jax_reg.REFERENCE_LINE_KEYS
    assert port_reg.LATENCY_BUCKETS_S == jax_reg.LATENCY_BUCKETS_S
    assert port_reg.DYNAMIC_LINE_PREFIXES == jax_reg.DYNAMIC_LINE_PREFIXES
    assert len(port_reg.FAMILIES) == len({_key(f) for f in port_reg.FAMILIES})


def test_registry_leaves_out_exactly_the_unported_families():
    port = {_key(f) for f in port_reg.FAMILIES}
    left_out = [f for f in jax_reg.FAMILIES if _key(f) not in port]
    for f in left_out:
        unported = any((lk and f.line_key.startswith(lk)) or (pk and f.prom.startswith(pk))
                       for lk, pk in NOT_PORTED_MODULES)
        assert unported or f.line_key in DIFFERENT_MEANING, _key(f)
    assert DIFFERENT_MEANING <= {f.line_key for f in left_out}
    # what the port does have stays declared: the e2e histogram (both
    # hops), and every fabric and fleet family
    assert "banjax_e2e_latency_seconds" in port_reg.PROM_FAMILIES
    assert port_reg.is_declared_line_key("Health_matcher")
    fabric = [f for f in jax_reg.FAMILIES
              if f.line_key.startswith("Fabric") or f.prom.startswith(("banjax_fabric_",
                                                                        "banjax_fleet_"))]
    assert len(fabric) > 30 and all(_key(f) in port for f in fabric)
    mesh = [f for f in jax_reg.FAMILIES if f.line_key.startswith("Mesh")]
    assert len(mesh) == 5 and all(_key(f) in port for f in mesh)
    assert port_reg.FRAME_BYTES_BUCKETS == jax_reg.FRAME_BYTES_BUCKETS


def test_histograms_and_stats_views_match_jax():
    rng = random.Random(3)
    xs = [rng.expovariate(20.0) for _ in range(500)] + [0.0005, 10.0, 99.0]
    ph, jh = port_reg.Histogram(), jax_reg.Histogram()
    psh, jsh = port_reg.StageHistograms(), jax_reg.StageHistograms()
    pp, jp = port_stats.PipelineStats(), jax_stats.PipelineStats()
    pm, jm = port_stats.MatcherStats(), jax_stats.MatcherStats()
    for k, x in enumerate(xs):
        ph.observe(x)
        jh.observe(x)
        stage = ("encode", "device", "drain")[k % 3]
        psh.observe(stage, x)
        jsh.observe(stage, x)
        for s in (pp, jp):
            s.note_admitted(7)
            s.note_processed(5)
            s.note_shed(1)
            s.note_drain_error(1)
            s.note_stale(k % 2)
            s.note_batch(fallback=k % 5 == 0)
            s.observe_device(x)
            s.observe_stages({"encode": x * 1e3, "device": 2e3 * x, "drain": 1.0})
            if k % 7 == 0:
                s.note_encode_shards([x * 1e3, 2e3 * x + 0.1], 3e3 * x + 0.2)
        pm.record_batch(64, x)
        jm.record_batch(64, x)
    assert ph.snapshot() == jh.snapshot()
    assert [(n, h.snapshot()) for n, h in psh.items()] == [(n, h.snapshot()) for n, h in jsh.items()]
    assert pp.peek() == jp.peek()
    assert pp.snapshot() == jp.snapshot() and pp.snapshot() == jp.snapshot()  # maxima reset
    assert pp.device_latency_hist.snapshot() == jp.device_latency_hist.snapshot()
    assert [(n, h.snapshot()) for n, h in pp.stage_hists.items()] == \
        [(n, h.snapshot()) for n, h in jp.stage_hists.items()]
    assert pp.worker_busy_fractions() == jp.worker_busy_fractions()
    jax_peek = {k: v for k, v in jm.peek().items() if not k.startswith(("MatcherH2d", "MatcherD2h"))}
    assert pm.peek() == jax_peek
    assert pm.batch_latency_hist.snapshot() == jm.batch_latency_hist.snapshot()
    snap = pm.snapshot()
    assert snap["MatcherLinesTotal"] == 64 * len(xs) and snap["MatcherLinesPerSec"] > 0
    assert pm.snapshot()["MatcherLinesPerSec"] == 0.0  # the interval was reset


BAD_TEXTS = [
    "x 1",                                                   # no trailing newline
    "x 1\n",                                                 # sample before its TYPE
    "# TYPE x counter\nx -1\n",                              # negative counter
    "# TYPE x gauge\nx{a=b} 1\n",                            # bad label syntax
    "# TYPE x gauge\n# TYPE x gauge\nx 1\n",                 # declared twice
    "# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_sum 1\nh_count 2\n",  # no +Inf
    "# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_bucket{le=\"+Inf\"} 1\nh_sum 1\nh_count 1\n",
    "# TYPE h histogram\nh_bucket{le=\"+Inf\"} 3\nh_sum 1\nh_count 2\n",
    "# TYPE x gauge\nx one\n",
]


def test_parser_is_as_strict_as_jax():
    for text in BAD_TEXTS:
        with pytest.raises(port_expo.ExpositionError):
            port_expo.parse_text_format(text)
        with pytest.raises(jax_expo.ExpositionError):
            jax_expo.parse_text_format(text)
    w = port_expo._Writer()
    h = port_reg.Histogram()
    for x in (0.001, 0.2, 3.0):
        h.observe(x)
    w.histogram(port_reg.PROM_FAMILIES["banjax_stage_duration_seconds"], h, {"stage": 'a"b'})
    w.sample(port_reg.PROM_FAMILIES["banjax_health_status"], 1)
    text = w.text()
    assert port_expo.parse_text_format(text) == jax_expo.parse_text_format(text)


# ------------------------------------------------------ tracer and ledger


def _trace_script(tr):
    """One call sequence: a root span ended on another call, nested stage
    spans, an ambient child, instants, an explicit-id shard span."""
    tid = tr.new_trace()
    root = tr.begin("admission", tid, args={"items": 3})
    with tr.span("encode", tid, parent=root.span_id) as sp:
        sp.note("rows", 3)
        with tr.span("encode-shard", tid, sp.span_id, args={"shard": 0}):
            pass
    with tr.span("submit", tid, parent=root.span_id):
        inner_tid = tr.current_trace_id()
        with tr.span("program-ab-fused", args={"row0": 0}):
            pass
        with tr.step_annotation(tid):
            pass
    with tr.span("nothing-ambient"):
        pass  # no ambient parent: not recorded
    tr.instant("shed", {"lines": 4})
    tr.instant("device-failure", {"stage": "submit"}, trace_id=tid)
    try:
        with tr.span("drain", tid, parent=root.span_id):
            raise ValueError("boom")
    except ValueError:
        pass
    root.note("ok", True)
    tr.end(root)
    return inner_tid


def _shape(snapshot):
    ids = {s["span_id"]: s["name"] for s in snapshot}
    return [(s["name"], ids.get(s["parent_id"], ""), s["trace_id"], s["dur_us"] is None,
             sorted(s["args"])) for s in snapshot]


@pytest.mark.parametrize("annotations", [False, True])
def test_tracer_records_what_jax_records(annotations):
    p = port_trace.configure(enabled=True, ring_size=16, jax_annotations=annotations)
    j = jax_trace.configure(enabled=True, ring_size=16)
    assert _trace_script(p) == _trace_script(j) == 1
    ps, js = p.snapshot(), j.snapshot()
    assert _shape(ps) == _shape(js) and len(ps) == 8
    pc, jc = p.export_chrome(), j.export_chrome()
    assert [(e["name"], e["ph"]) for e in pc["traceEvents"]] == \
        [(e["name"], e["ph"]) for e in jc["traceEvents"]]
    assert sorted(pc["otherData"]) == sorted(jc["otherData"])
    # ?clear=1 takes and empties in one step; the ring wraps at its size
    assert len(p.export_chrome(clear=True)["traceEvents"]) == len(pc["traceEvents"])
    assert p.snapshot() == []
    for tr in (p, j):
        for _ in range(20):
            tr.instant("x")
    assert len(p.snapshot()) == len(j.snapshot()) == 16
    # off: the shared no-op, nothing recorded
    off = port_trace.configure(enabled=False)
    assert off.span("x", 1, 0) is port_trace.NOOP_SPAN and off.new_trace() == 0
    assert off.begin("x", 1) is port_trace.NOOP_SPAN and off.step_annotation(1) is port_trace.NOOP_SPAN
    off.instant("x")
    assert off.snapshot() == []


def test_profiler_bridge_shows_spans_in_a_torch_capture():
    import torch

    tr = port_trace.configure(enabled=True, jax_annotations=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tid = tr.new_trace()
        with tr.span("submit", tid, 0):
            with tr.span("program-ab-fused"):
                torch.ones(4).add_(1)
    names = {e.name for e in prof.events()}
    assert {"submit", "program-ab-fused"} <= names


def _ledger_script(pv):
    pv.record(pv.SOURCE_RATE_LIMIT, "10.0.0.1", "IptablesBlock", rule="r1", rule_index=3,
              hits=5, trace_id=7)
    pv.record(pv.SOURCE_STATIC, "10.0.0.2", "Allow", rule="GlobalAccessGranted")
    pv.record("no-such-source", "10.0.0.3", "NginxBlock")
    pv.record(pv.SOURCE_CHALLENGE, "10.0.0.1", "IptablesBlock", rule="failed challenge sha_inv",
              hits=2)
    pv.record(pv.SOURCE_EXPIRY, "10.0.0.1", "IptablesBlock", rule="sweep")
    for k in range(40):
        pv.record(pv.SOURCE_UA, f"10.1.0.{k}", "Challenge", rule="GlobalUAChallenge")


def _untimed(records):
    return [{k: v for k, v in r.items() if k not in ("t_monotonic", "time_unix")} for r in records]


def test_ledger_matches_jax():
    p = port_prov.configure(enabled=True, ring_size=16)
    j = jax_prov.configure(enabled=True, ring_size=16)
    _ledger_script(port_prov)
    _ledger_script(jax_prov)
    assert _untimed(p.explain("10.0.0.1")) == _untimed(j.explain("10.0.0.1"))
    assert _untimed(p.tail(100)) == _untimed(j.tail(100))
    assert p.counters() == j.counters() and p.total_records() == j.total_records() == 45
    port_prov.configure(enabled=False)
    _ledger_script(port_prov)
    assert port_prov.get_ledger().total_records() == 0


# --------------------------------------------------------------- the SLOs


class _Breaker:
    def __init__(self):
        self.open_s = 0.0

    def open_seconds_total(self):
        return self.open_s


class _Matcher:
    def __init__(self, reg):
        self.stats = type("S", (), {})()
        self.stats.batch_latency_hist = reg.Histogram()
        self.breaker = _Breaker()
        self.budget_trips = 0


class _Pipeline:
    def __init__(self, stats_mod):
        self.stats = stats_mod.PipelineStats()


def test_slo_burn_rates_on_a_virtual_clock_match_jax():
    clock = [1000.0]
    engines, sources, breaches = [], [], []
    for slo_mod, reg, stats_mod in ((port_slo, port_reg, port_stats),
                                    (jax_slo, jax_reg, jax_stats)):
        m, p = _Matcher(reg), _Pipeline(stats_mod)
        fired = []
        eng = slo_mod.SloEngine(
            matcher_getter=lambda m=m: m, pipeline_getter=lambda p=p: p,
            batch_budget_s_fn=lambda: 0.25, shed_ratio_max=0.01, stale_ratio_max=0.01,
            breaker_open_ratio_max=0.01, budget_trip_ratio_max=0.01,
            on_breach=lambda name, burn, fired=fired: fired.append((name, burn)),
            clock=lambda: clock[0],
        )
        engines.append(eng)
        sources.append((m, p))
        breaches.append(fired)
    rng = random.Random(9)
    history = [[], []]
    for step in range(60):
        lat = [rng.choice([0.01, 0.05, 0.3, 1.0]) for _ in range(rng.randrange(1, 20))]
        admitted, shed, stale = rng.randrange(100, 1000), rng.randrange(0, 30), rng.randrange(3)
        trips, open_s = rng.randrange(2), rng.choice([0.0, 0.0, 2.0])
        for (m, p), eng, hist in zip(sources, engines, history):
            for x in lat:
                m.stats.batch_latency_hist.observe(x)
            m.budget_trips += trips
            m.breaker.open_s += open_s
            p.stats.note_admitted(admitted)
            p.stats.note_processed(admitted - shed)
            p.stats.note_shed(shed)
            p.stats.note_stale(stale)
            hist.append((eng.sample(), eng.burn_rates(), eng.breached()))
        clock[0] += rng.choice([1.0, 15.0, 120.0])
    assert history[0] == history[1]
    assert breaches[0] == breaches[1] and breaches[0]
    assert engines[0].snapshot() == engines[1].snapshot()


# -------------------------------------------------------- flight recorder


def test_flight_recorder_bundles_match_jax(tmp_path):
    t = [100.0]
    out = []
    for name, fr_mod, pv, tr in (("port", port_flightrec, port_prov, port_trace),
                                 ("jax", jax_flightrec, jax_prov, jax_trace)):
        tracer = tr.configure(enabled=True)
        _trace_script(tracer)
        pv.configure(enabled=True)
        _ledger_script(pv)
        rec = fr_mod.FlightRecorder(
            str(tmp_path / name), min_interval_s=10.0, keep=2, provenance_tail=5,
            metrics_text_fn=lambda: "# TYPE x gauge\nx 1\n", config_hash_fn=lambda: "abc",
            traffic_fn=lambda: {"enabled": True, "top": []}, clock=lambda: t[0],
        )
        fr_mod.install(rec)
        names = [fr_mod.notify("breaker-trip", "matcher-device")]
        names.append(fr_mod.notify("drain-error", "debounced"))
        t[0] += 11.0
        names.append(fr_mod.notify("shed-burst", "shed 5 lines"))
        t[0] += 11.0
        names.append(fr_mod.notify("slo-shed_ratio", "burn"))
        t[0] = 100.0
        listed = rec.list_incidents()
        newest = listed[0]["name"]
        files = {f: rec.read_file(newest, f) for f in listed[0]["files"]}
        meta = json.loads(files["meta.json"])
        prov = json.loads(files["provenance.json"])
        trace_json = json.loads(files["trace.json"])
        out.append((
            [n is None for n in names], rec.incident_count, len(listed),
            [e["reason"] for e in listed], listed[0]["files"],
            sorted(meta), meta["reason"], meta["config_hash"],
            _untimed(prov["records"]), prov["counters"],
            [e["name"] for e in trace_json["traceEvents"]],
            files["metrics.prom"], json.loads(files["traffic.json"]),
            rec.read_file(newest, "../meta.json"), rec.read_file("..", "meta.json"),
            rec.read_file(newest, ".hidden"),
        ))
        fr_mod.install(None)
    assert out[0] == out[1]
    assert out[0][0] == [False, True, False, False] and out[0][2] == 2
    assert out[0][4] == ["metrics.prom", "provenance.json", "trace.json", "traffic.json",
                         "meta.json"]


# --------------------------------------------------------------- the chain


def test_chain_provenance_and_spans_match_jax(pinned):
    from tests.test_torch_decision_chain import (
        CONFIG_YAML,
        Decision as PortDecision,
        JaxDecision,
        _jax_state,
        _port_state,
        _run,
        _script,
    )

    script = _script()
    runs = []
    for state_fn, chain, dec, pv, tr in (
        (_jax_state, jax_chain, JaxDecision, jax_prov, jax_trace),
        (_port_state, port_chain, PortDecision, port_prov, port_trace),
    ):
        pinned.reset()
        ledger = pv.configure(enabled=True, ring_size=4096)
        tracer = tr.configure(enabled=True, ring_size=4096)
        state, logs = state_fn(CONFIG_YAML)
        _run(state, logs, script, chain.RequestInfo, chain.decision_for_nginx, dec, pinned)
        spans = tracer.snapshot()
        runs.append((
            [(r["source"], r["ip"], r["decision"], r["rule"], r["rule_index"], r["hits"])
             for r in ledger.tail(4096)],
            ledger.counters(),
            sorted((s["name"], s["args"].get("ip")) for s in spans),
            # a challenge failure's record carries its verification's trace id
            sorted(r["trace_id"] > 0 for r in ledger.tail(4096)
                   if r["source"] == "challenge_failure"),
        ))
        state.dynamic_lists.close()
    assert runs[0] == runs[1]
    sources = {r[0] for r in runs[0][0]}
    assert {"static_list", "ua_list", "challenge_failure"} <= sources
    assert runs[0][2] and all(name == "challenge.sha_inv" for name, _ in runs[0][2])
    assert any(runs[0][3])  # the sha-inv failures' (password failures have no span)


@pytest.mark.parametrize("site, request_kind", [
    ("decision_chain", "any"), ("challenge.issue", "cookieless"), ("challenge.verify", "solved"),
])
def test_chain_failpoints_raise_as_jax(site, request_kind, pinned):
    from tests.test_torch_decision_chain import CONFIG_YAML, _jax_state, _port_state, _solved

    cookies = {"deflect_challenge3": _solved("8.8.8.8")} if request_kind == "solved" else {}
    outcomes = []
    for state_fn, chain, fp in ((_jax_state, jax_chain, jax_fp), (_port_state, port_chain, port_fp)):
        state, _ = state_fn(CONFIG_YAML)
        req = chain.RequestInfo(client_ip="8.8.8.8", requested_host="nothing.com",
                                requested_path="/", client_user_agent="mozilla", method="GET",
                                cookies=cookies)
        ok = chain.decision_for_nginx(state, req)[0].status
        fp.arm(site, "error", count=1)
        with pytest.raises(OSError) as err:
            chain.decision_for_nginx(state, req)
        after = chain.decision_for_nginx(state, req)[0].status
        outcomes.append((ok, type(err.value).__name__, str(err.value), after, fp.fired_count(site)))
        state.dynamic_lists.close()
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == (200 if request_kind == "solved" else 429)


def test_device_verify_failpoint_fails_the_request_in_the_port(pinned):
    """The deliberate difference: an armed `challenge.device_verify` makes
    the port's verifier dispatch raise as a kernel fault would (counted in
    `faults`); the JAX verifier falls back to hashlib and answers."""
    from tests.test_torch_decision_chain import CONFIG_YAML, _port_state, _solved

    state, _ = _port_state(CONFIG_YAML)
    req = port_chain.RequestInfo(client_ip="8.8.8.8", requested_host="nothing.com",
                                 requested_path="/", client_user_agent="mozilla", method="GET",
                                 cookies={"deflect_challenge3": _solved("8.8.8.8")})
    port_fp.arm("challenge.device_verify", "error", count=1)
    with pytest.raises(RuntimeError, match="kernel C dispatch failed"):
        port_chain.decision_for_nginx(state, req)
    assert state.challenge_verifier.faults == 1
    assert port_chain.decision_for_nginx(state, req)[0].status == 200
    state.dynamic_lists.close()


# ------------------------------------------- tracing on and off, pipelined


def test_ban_logs_identical_with_tracing_on_and_off():
    from tests.test_torch_pipeline import FIXED_NOW, pipeline_lines, pipeline_yaml, port_matcher
    from tests.test_torch_pipeline import run_scheduler

    lines = pipeline_lines(FIXED_NOW, 700, seed=21)
    logs, trees = [], []
    for on in (False, True):
        tracer = port_trace.configure(enabled=on, jax_annotations=on)
        m = port_matcher(pipeline_yaml())
        try:
            run_scheduler(port_sched_mod, m, lines, target=160)
        finally:
            m.close()
        logs.append((m.test_log.getvalue(), m.test_bans))
        by_trace = {}
        ids = {}
        for s in tracer.snapshot():
            ids[s["span_id"]] = s["name"]
            by_trace.setdefault(s["trace_id"], []).append(s)
        trees.append({tid: sorted((s["name"], ids.get(s["parent_id"], "")) for s in spans)
                      for tid, spans in by_trace.items() if tid})
    assert logs[0] == logs[1] and logs[0][0].count("\n") > 3
    assert trees[0] == {}
    shapes = set(tuple(t) for t in trees[1].values())
    assert len(trees[1]) == 5  # one trace a batch: 700 lines at 160 a take
    for tree in shapes:
        names = [n for n, _ in tree]
        assert ("admission", "") in tree and ("encode", "admission") in tree
        assert ("encode-shard", "encode") in tree and ("submit", "admission") in tree
        assert ("collect", "admission") in tree and ("drain", "admission") in tree
        # a chunk the in-program gate sent to the classic fallback replays
        # without an effector-replay span (as in JAX)
        assert names.count("program-ab-fused") >= max(1, names.count("effector-replay"))
        assert set(p for n, p in tree if n == "program-ab-fused") == {"submit"}
        assert set(p for n, p in tree if n == "effector-replay") <= {"drain"}


def test_jax_scheduler_records_the_same_span_tree():
    """The JAX scheduler over the same stream (its XLA scan, the
    single-program commit) records the span names and parents the port's
    does."""
    from tests.test_torch_pipeline import (
        FIXED_NOW,
        jax_matcher,
        pipeline_lines,
        pipeline_yaml,
        port_matcher,
        run_scheduler,
    )

    lines = pipeline_lines(FIXED_NOW, 300, seed=22)
    shapes = []
    for tr, sched, make in ((port_trace, port_sched_mod, port_matcher),
                            (jax_trace, jax_sched_mod, jax_matcher)):
        tracer = tr.configure(enabled=True)
        m = make(pipeline_yaml())
        try:
            run_scheduler(sched, m, lines, target=150)
        finally:
            m.close()
        ids = {s["span_id"]: s["name"] for s in tracer.snapshot()}
        by_trace = {}
        for s in tracer.snapshot():
            if s["trace_id"] and s["dur_us"] is not None:
                by_trace.setdefault(s["trace_id"], []).append((s["name"], ids.get(s["parent_id"], "")))
        shapes.append(sorted(tuple(sorted(v)) for v in by_trace.values()))
    assert shapes[0] == shapes[1] and len(shapes[0]) == 2


def test_metrics_line_writes_declared_keys(tmp_path):
    from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
    from banjax_tpu_torch.obs.metrics import MetricsReporter, write_metrics_line

    lists = DynamicDecisionLists(start_sweeper=False)
    out = io.StringIO()
    write_metrics_line(out, lists, [], [])
    line = json.loads(out.getvalue())
    assert list(line) == list(port_reg.REFERENCE_LINE_KEYS)
    path = tmp_path / "metrics.log"
    rep = MetricsReporter(str(path), lists, [], [], interval_seconds=0.05)
    rep.start()
    deadline = time.monotonic() + 5
    while (not path.exists() or path.read_text().count("\n") < 2) and time.monotonic() < deadline:
        time.sleep(0.02)
    rep.stop()
    assert rep._thread is None
    rows = [json.loads(r) for r in path.read_text().splitlines()]
    assert len(rows) >= 2 and all(port_reg.is_declared_line_key(k) for r in rows for k in r)
    lists.close()
