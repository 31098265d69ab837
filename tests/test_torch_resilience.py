"""The breaker and the failpoints, held against the JAX package's modules:

- failpoints: one spec and seed give the same `snapshot()` and the same
  firing sequence in both modules (counts, probabilities, bad entries);
- the breaker: the same state sequence as the JAX `CircuitBreaker` under
  one record sequence and an injected clock, consecutive and windowed;
- the port's deliberate difference: an open breaker refuses the batch
  (`BreakerOpen`, counted, health DEGRADED) and no host matcher exists;
- `/debug/failpoints`: GET and POST bodies and status codes against the
  JAX server's, including the 400s and the 403 when
  `failpoints_admin_enabled` is false;
- the `tailer.open` and `serve.fastpath.lookup` sites fire and are
  counted (the chain serves the request, byte for byte);
- the pipeline's encode, encode-shard, submit, collect and drain
  failpoints, each with the scheduler's accounting held against the JAX
  scheduler's on the same lines and batches.

Both failpoint modules keep module state: every test leaves them
disarmed."""

import json
import socket
import time

import pytest
import yaml

from banjax_tpu.pipeline import scheduler as jax_sched_mod
from banjax_tpu.resilience import breaker as jax_breaker
from banjax_tpu.resilience import failpoints as jax_fp
from banjax_tpu_torch import cli as port_cli
from banjax_tpu_torch.cli import BanjaxApp
from banjax_tpu_torch.decisions.model import Decision
from banjax_tpu_torch.ingest.tailer import LogTailer
from banjax_tpu_torch.matcher import runner as port_runner
from banjax_tpu_torch.pipeline import scheduler as port_sched_mod
from banjax_tpu_torch.resilience import breaker as port_breaker
from banjax_tpu_torch.resilience import failpoints as port_fp
from banjax_tpu_torch.resilience.health import HealthRegistry
from tests.test_torch_matcher import _one_torch_thread  # noqa: F401
from tests.test_torch_obs import obs_reset  # noqa: F401
from tests.test_torch_pipeline import (  # noqa: F401
    FIXED_NOW,
    _disarmed,
    jax_matcher,
    pipeline_lines,
    pipeline_yaml,
    port_matcher,
    run_scheduler,
)
from tests.test_torch_serve import HOST, _config, _JaxServer, _norm, _request, loop  # noqa: F401


@pytest.fixture(autouse=True)
def _port_ipset_off(monkeypatch):
    """The port's app creates the kernel's ipset outside standalone
    testing; here it runs with its ipset off, as the JAX app does
    (`init_ipset` returns None). tests/test_torch_ipset.py covers the
    kernel edge."""
    monkeypatch.setattr(port_cli, "init_ipset", lambda *a, **k: None)


# ----------------------------------------------------------- failpoints


def _fire_sequence(fp, names, n):
    out = []
    for _ in range(n):
        for name in names:
            try:
                fp.check(name)
                out.append(0)
            except fp.FaultInjected as e:
                out.append(str(e))
    return out


@pytest.mark.parametrize("spec", [
    "pipeline.submit=error:3;matcher.device=error:5@0.5;tailer.open",
    "a.b=error@0.25;c.d=sleep:2;bad=nomode;e.f=error:x;g.h=error:2@y;;  ",
    "matcher.device=error:1@1.5;pipeline.drain=error:0",
])
def test_failpoints_spec_snapshot_and_firing_match_jax(spec):
    for fp in (jax_fp, port_fp):
        fp.arm_from_spec(spec)
    assert port_fp.snapshot() == jax_fp.snapshot()
    names = [e["name"] for e in jax_fp.snapshot()] + ["not.armed"]
    assert _fire_sequence(port_fp, names, 12) == _fire_sequence(jax_fp, names, 12)
    assert port_fp.snapshot() == jax_fp.snapshot()
    for name in names:
        assert port_fp.fired_count(name) == jax_fp.fired_count(name)
        assert port_fp.is_armed(name) == jax_fp.is_armed(name)


def test_failpoints_seeded_arming_matches_jax():
    for fp in (jax_fp, port_fp):
        fp.arm("pipeline.collect", count=7, probability=0.3, seed=1234)
        fp.arm("pipeline.encode", mode="sleep", delay_s=0.0, probability=0.6)
    names = ["pipeline.collect", "pipeline.encode"]
    assert _fire_sequence(port_fp, names, 30) == _fire_sequence(jax_fp, names, 30)
    assert port_fp.snapshot() == jax_fp.snapshot()
    assert port_fp.KNOWN_SITES == jax_fp.KNOWN_SITES
    assert port_fp.MODES == jax_fp.MODES
    for fp in (jax_fp, port_fp):
        fp.disarm("pipeline.collect")
    assert port_fp.snapshot() == jax_fp.snapshot()
    assert issubclass(port_fp.FaultInjected, OSError)


# ------------------------------------------------------------- breaker


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _breaker_trace(mod, window):
    clock = _Clock()
    trips = []
    b = mod.CircuitBreaker(failure_threshold=3, recovery_seconds=5.0, clock=clock,
                           name="m", on_trip=trips.append, window_size=window)
    ops = ["f", "f", "s", "f", "f", "s", "f", "f", "f", "allow", "t3", "allow", "t3",
           "allow", "allow", "f", "t6", "allow", "s", "allow", "f", "s", "f", "s", "f",
           "t1", "f", "f", "f", "t10", "allow", "s", "f"]
    out = []
    for op in ops:
        if op == "f":
            b.record_failure()
        elif op == "s":
            b.record_success()
        elif op == "allow":
            out.append(("allow", b.allow()))
        else:
            clock.t += float(op[1:])
        out.append((op, b.state, b.trip_count, round(b.open_seconds_total(), 6)))
    return out, trips


@pytest.mark.parametrize("window", [0, 4, 8])
def test_breaker_state_sequence_matches_jax(window):
    assert port_breaker.CLOSED == jax_breaker.CLOSED
    assert port_breaker.OPEN == jax_breaker.OPEN
    assert port_breaker.HALF_OPEN == jax_breaker.HALF_OPEN
    port, port_trips = _breaker_trace(port_breaker, window)
    jax, jax_trips = _breaker_trace(jax_breaker, window)
    assert port == jax
    assert port_trips == jax_trips and port_trips
    for mod in (port_breaker, jax_breaker):
        with pytest.raises(ValueError):
            mod.CircuitBreaker(failure_threshold=0)
        with pytest.raises(ValueError):
            mod.CircuitBreaker(window_size=-1)


def test_open_breaker_refuses_and_counts_without_a_host_matcher():
    """The deliberate difference: where the JAX matcher reruns the batch on
    its host reference matcher, the port raises before the card and counts
    the refusal; health says the batches are refused, not rerouted."""
    health = HealthRegistry()
    m = port_matcher(pipeline_yaml(), health=health)
    now = FIXED_NOW
    lines = pipeline_lines(now, 64, seed=3)
    m.consume_lines(lines, now_unix=now)
    assert health.snapshot()["components"]["matcher"]["status"] == "healthy"
    port_fp.arm("matcher.device", count=3)
    for _ in range(2):
        with pytest.raises(port_fp.FaultInjected):
            m.consume_lines(lines, now_unix=now)
    assert m.breaker.state == port_breaker.CLOSED
    with pytest.raises(port_fp.FaultInjected):
        m.consume_lines(lines, now_unix=now)
    assert m.breaker.state == port_breaker.OPEN and m.breaker.trip_count == 1
    with pytest.raises(port_runner.BreakerOpen):
        m.consume_lines(lines, now_unix=now)
    assert (m.refused_batches, m.refused_lines) == (1, len(lines))
    assert port_fp.fired_count("matcher.device") == 3
    comp = health.snapshot()["components"]["matcher"]
    assert comp["status"] == "degraded" and "refused, not rerouted" in comp["detail"]
    assert m.probe() is False  # the open breaker refuses the probe too
    assert not hasattr(m, "_fallback_matcher") and not hasattr(m, "_cpu_fallback")
    # half-open after the recovery: the probe closes it (the site is spent)
    m.breaker._clock = lambda: time.monotonic() + 3600
    assert m.probe() is True and m.breaker.state == port_breaker.CLOSED
    m.consume_lines(lines, now_unix=now)
    assert health.snapshot()["components"]["matcher"]["status"] == "healthy"


def test_probe_matches_jax_outcomes():
    """probe(): True while closed; a failing device records a breaker
    failure in both packages; the JAX and port breakers end alike."""
    port, jax = port_matcher(pipeline_yaml()), jax_matcher(pipeline_yaml())
    for fp, m in ((port_fp, port), (jax_fp, jax)):
        assert m.probe(now_unix=FIXED_NOW) is True
        fp.arm("matcher.device", count=2)
        assert m.probe(now_unix=FIXED_NOW) is False
        assert m.probe(now_unix=FIXED_NOW) is False
        assert m.probe(now_unix=FIXED_NOW) is True
    assert (port.breaker.state, port.breaker.trip_count, port.breaker._failures) == \
        (jax.breaker.state, jax.breaker.trip_count, jax.breaker._failures)


# ------------------------------------------------------- /debug/failpoints

POSTS = [
    {"arm": [{"name": "pipeline.submit", "mode": "error", "count": 3}]},
    {"spec": "matcher.device=error:2@0.5;tailer.open"},
    {"arm": [{"name": "pipeline.encode", "mode": "sleep", "delay_s": 0.0,
              "probability": 0.5, "seed": 9}], "disarm": ["tailer.open"]},
    {"arm": [{"mode": "error"}]},
    {"arm": [{"name": "x", "mode": "explode"}]},
    {"arm": [{"name": "x", "count": "many"}]},
    {"arm": [{"name": "x", "probability": "p"}]},
    {"arm": {"name": "x"}},
    [1, 2],
    "not json",
    {"disarm_all": True, "arm": [{"name": "serve.fastpath.lookup", "count": 1}]},
    {},
]


def _http(port, method, body=None):
    data = b"" if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    head = (f"{method} /debug/failpoints HTTP/1.1\r\nHost: 127.0.0.1\r\n"
            f"Content-Type: application/json\r\nContent-Length: {len(data)}\r\n"
            "Connection: close\r\n\r\n").encode()
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(head + data)
        out = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            out += chunk
    status = int(out.split(b" ", 2)[1])
    return status, json.loads(out.split(b"\r\n\r\n", 1)[1])


def _port_app(tmp_path, admin_enabled=True):
    path = _config(tmp_path / f"port-{admin_enabled}.yaml", False, False, tmp_path)
    cfg = yaml.safe_load(path.read_text())
    cfg["failpoints_admin_enabled"] = admin_enabled
    path.write_text(yaml.safe_dump(cfg))
    app = BanjaxApp(str(path), device="cpu")
    app.start_background(port=0)
    return app


def _jax_app(lp, tmp_path, admin_enabled=True):
    path = _config(tmp_path / f"jax-{admin_enabled}.yaml", False, False, tmp_path)
    cfg = yaml.safe_load(path.read_text())
    cfg["failpoints_admin_enabled"] = admin_enabled
    path.write_text(yaml.safe_dump(cfg))
    return _JaxServer(lp, path, False, tmp_path)


def test_debug_failpoints_route_matches_jax(tmp_path, loop):  # noqa: F811
    port_app = _port_app(tmp_path)
    jax_srv = _jax_app(loop, tmp_path)
    try:
        assert _http(port_app.port, "GET") == _http(jax_srv.port, "GET")
        for body in POSTS:
            raw = body.encode() if isinstance(body, str) else body
            got, want = _http(port_app.port, "POST", raw), _http(jax_srv.port, "POST", raw)
            assert got == want, body
        assert _http(port_app.port, "GET") == _http(jax_srv.port, "GET")
        assert port_fp.snapshot() == jax_fp.snapshot() != []
    finally:
        port_app.stop_background()
        jax_srv.stop()
    off_port = _port_app(tmp_path, admin_enabled=False)
    off_jax = _jax_app(loop, tmp_path, admin_enabled=False)
    try:
        for method, body in (("GET", None), ("POST", {"spec": "tailer.open"})):
            got, want = _http(off_port.port, method, body), _http(off_jax.port, method, body)
            assert got == want == (403, {"error": "failpoints_admin_enabled is false"})
    finally:
        off_port.stop_background()
        off_jax.stop()


# ----------------------------------------------- tailer and fast-path sites


def test_tailer_open_site_fires_and_is_counted(tmp_path):
    log_path = tmp_path / "a.log"
    log_path.write_text("")
    got = []
    port_fp.arm("tailer.open", count=2)
    t = LogTailer(str(log_path), got.extend)
    t.backoff.base = t.backoff.cap = 0.01
    t.start()
    try:
        assert t.opened.wait(10)
        with open(log_path, "a") as f:
            f.write("one\ntwo\n")
        deadline = time.monotonic() + 10
        while len(got) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        assert t.stop()
    assert got == ["one", "two"]
    assert t.open_faults == 2 == port_fp.fired_count("tailer.open")
    assert t.errors == 0


def test_fastpath_lookup_site_is_a_counted_fault_the_chain_serves(tmp_path, loop):  # noqa: F811
    path = _config(tmp_path / "port-fast.yaml", True, False, tmp_path)
    app = BanjaxApp(str(path), device="cpu")
    app.start_background(port=0)
    jax_srv = _JaxServer(loop, _config(tmp_path / "jax-fast.yaml", True, False, tmp_path),
                         True, tmp_path)
    try:
        far = time.time() + 600
        for lists in (app.dynamic_lists, jax_srv.lists):
            lists.update("43.0.0.2", far, Decision.NGINX_BLOCK, False, HOST)
        clean = _request(app.port, "43.0.0.2")
        hits0 = app.serve_stats.snapshot()["hits_total"]
        for fp in (port_fp, jax_fp):
            fp.arm("serve.fastpath.lookup", count=1)
        faulted = _request(app.port, "43.0.0.2")
        jax_faulted = _request(jax_srv.port, "43.0.0.2")
        stats = app.serve_stats.snapshot()
        assert port_fp.fired_count("serve.fastpath.lookup") == 1
        assert jax_fp.fired_count("serve.fastpath.lookup") == 1
        assert stats["faults_total"] == 1 and stats["hits_total"] == hits0
        assert _norm(faulted) == _norm(clean) == _norm(jax_faulted)
        assert b" 403 " in faulted.split(b"\r\n", 1)[0]
        after = _request(app.port, "43.0.0.2")  # the count is spent: a hit again
        assert app.serve_stats.snapshot()["hits_total"] == hits0 + 1
        assert _norm(after) == _norm(clean)
    finally:
        app.stop_background()
        jax_srv.stop()


# ------------------------------------------------ the pipeline's stage sites


@pytest.mark.parametrize("site, spec", [
    ("pipeline.encode", "pipeline.encode=error:2"),
    ("pipeline.encode_shard", "pipeline.encode_shard=error:1"),
    ("pipeline.submit", "pipeline.submit=error:2"),
    ("pipeline.collect", "pipeline.collect=error:1"),
    ("pipeline.drain", "pipeline.drain=error:2"),
])
def test_pipeline_stage_failpoints_account_as_jax(site, spec, monkeypatch):
    """One stream through both schedulers with the site armed: the same
    batches, the same firings, and the same admitted/processed/shed/
    failed/fallback totals; admitted == processed + shed + failed."""
    for mod in (jax_sched_mod, port_sched_mod):
        monkeypatch.setattr(mod, "_MIN_SHARD_LINES", 32)
    lines = pipeline_lines(FIXED_NOW, 640, seed=21)
    out = {}
    for name, fp, sched_mod, matcher in (
        ("jax", jax_fp, jax_sched_mod, jax_matcher(pipeline_yaml())),
        ("port", port_fp, port_sched_mod, port_matcher(pipeline_yaml())),
    ):
        fp.arm_from_spec(spec)
        stats, batches, _ = run_scheduler(sched_mod, matcher, lines, target=128,
                                          encode_workers=2)
        out[name] = (stats, batches, fp.fired_count(site))
        fp.disarm()
    (jstats, jb, jfired), (pstats, pb, pfired) = out["jax"], out["port"]
    assert pfired == jfired > 0
    assert [n for n, _ in pb] == [n for n, _ in jb]
    assert [ok for _, ok in pb] == [ok for _, ok in jb]
    keys = ("PipelineAdmittedLines", "PipelineProcessedLines", "PipelineShedLines",
            "PipelineDrainErrorLines", "PipelineStaleDroppedLines", "PipelineBatches",
            "PipelineFallbackBatches")
    assert {k: pstats[k] for k in keys} == {k: jstats[k] for k in keys}
    assert pstats["PipelineAdmittedLines"] == (
        pstats["PipelineProcessedLines"] + pstats["PipelineShedLines"]
        + pstats["PipelineDrainErrorLines"])
