"""`/auth_request` serving: the port's decision table, fast path and
servers against the JAX package's, all on the CPU and on port 0.

- The decision table (`native/decisiontable.py`) against the JAX native
  table on one put/get/delete/clear/len/dropped/session sequence,
  including a full table.
- The port's app (`BanjaxApp(device="cpu").start_background(port=0)`)
  against the JAX app's server (`build_app` + `start_fast_server`, or
  aiohttp alone), both over the same decisions: the `/auth_request`
  responses are byte-identical after the fresh session and challenge
  randomness is masked (as `tests/integration/
  test_fastpath_differential.py` masks it), in both `http_fast_path`
  layouts; the cold routes give equal JSON and text.
- A fast-path hit is identical to the port's own chain answer with the
  table off; a table whose `get` raises is served by the chain and
  counted as a fault.

The clock is pinned for both packages, so failure-state timestamps and
cookie expiries agree. The JAX side verifies PoW with hashlib
(`challenge_device_verify: false`); the port's CPU verifier runs kernel
C's plain version. Every server binds port 0 and is stopped."""

import asyncio
import dataclasses
import io
import json
import re
import socket
import threading
import time
from pathlib import Path

import pytest
import yaml
from aiohttp import web

from banjax_tpu.challenge.failures import make_failed_challenge_states as jax_failures
from banjax_tpu.config.holder import ConfigHolder as JaxHolder
from banjax_tpu.decisions.dynamic_lists import DynamicDecisionLists as JaxDynamicLists
from banjax_tpu.decisions.protected_paths import PasswordProtectedPaths as JaxPaths
from banjax_tpu.decisions.rate_limit import RegexRateLimitStates
from banjax_tpu.decisions.static_lists import StaticDecisionLists as JaxLists
from banjax_tpu.effectors.banner import Banner as JaxBanner
from banjax_tpu.httpapi import fastserve as jax_fastserve
from banjax_tpu.httpapi import server as jax_server
from banjax_tpu.httpapi.serve_stats import get_stats as jax_serve_stats
from banjax_tpu.native import decisiontable as jax_table
from banjax_tpu.resilience.health import HealthRegistry as JaxHealth
from banjax_tpu_torch import cli as port_cli
from banjax_tpu_torch.cli import BanjaxApp
from banjax_tpu_torch.crypto.challenge import new_challenge_cookie_at, solve_challenge_for_testing
from banjax_tpu_torch.crypto.session import new_session_cookie
from banjax_tpu_torch.decisions.model import Decision
from banjax_tpu_torch.httpapi.server import run_http_server
from banjax_tpu_torch.native.decisiontable import DecisionTable
from banjax_tpu_torch.utils import go_query_escape
from tests.test_torch_matcher import _one_torch_thread  # noqa: F401
from tests.test_torch_obs import obs_reset  # noqa: F401


@pytest.fixture(autouse=True)
def _port_ipset_off(monkeypatch):
    """The port's app creates the kernel's ipset outside standalone
    testing; here it runs with its ipset off, as the JAX app does
    (`init_ipset` returns None). tests/test_torch_ipset.py covers the
    kernel edge."""
    monkeypatch.setattr(port_cli, "init_ipset", lambda *a, **k: None)


FIXTURE = Path(__file__).resolve().parent / "fixtures" / "banjax-config-test.yaml"
HOST = "eligible.example.net"  # in no per-site or password list: fast-path eligible
SECRET = "session_secret"      # the fixture's session_cookie_hmac_secret
NOW = 1_790_000_000.25

_MASKS = (
    (re.compile(rb"(X-Deflect-Session: )(\S+)"), rb"\1MASKED"),
    (re.compile(rb"(deflect_session=)([^;\r\n]+)"), rb"\1MASKED"),
    (re.compile(rb"(deflect_challenge3=)([^;\r\n]+)"), rb"\1MASKED"),
    (re.compile(rb"[A-Za-z0-9+/=]{40,}"), rb"MASKEDB64"),
    (re.compile(rb"(Date: )([^\r\n]+)"), rb"\1MASKED"),
)


def _norm(raw: bytes) -> bytes:
    for pat, repl in _MASKS:
        raw = pat.sub(repl, raw)
    return raw


@pytest.fixture(autouse=True)
def _jax_serve_stats_reset():
    """The JAX fast path counts on a process-wide singleton: leave it as
    found for the next test file in this worker."""
    jax_serve_stats().reset()
    yield
    jax_serve_stats().reset()


# ------------------------------------------------------------ the table


def _table_ops(t, small):
    """One op sequence; returns every observable result."""
    out = []
    far, past = NOW + 600, NOW - 5
    for i in range(6):
        out.append(("put", t.put(f"10.0.0.{i}", 1 + i % 4, far, i % 2 == 0, "d", now=NOW)))
    out.append(("get", [t.get(f"10.0.0.{i}") for i in range(7)]))
    out.append(("get-empty", t.put("", 2, far, now=NOW), t.get("")))
    out.append(("replace", t.put("10.0.0.1", 3, far + 1, now=NOW), t.get("10.0.0.1")))
    out.append(("del", t.delete("10.0.0.2"), t.delete("10.0.0.2"), t.get("10.0.0.2")))
    out.append(("len", len(t), t.dropped))
    # fill past the probe window: the small table refuses, then reuses an
    # expired slot
    for i in range(small + 4):
        out.append(("fill", i, t.put(f"172.16.{i >> 8}.{i & 255}", 2, far, now=NOW)))
    out.append(("full", len(t), t.dropped))
    out.append(("expired", t.put("10.0.0.3", 2, past, now=NOW),
                t.put("192.0.2.1", 2, far, now=NOW + 10)))
    out.append(("sessions", t.session_add(2), t.session_add(-1), t.session_count(),
                t.session_add(-5), t.session_count()))
    t.clear()
    out.append(("cleared", len(t), t.get("10.0.0.1"), t.dropped, t.session_count()))
    out.append(("after", t.put("10.0.0.1", 4, far, now=NOW), t.get("10.0.0.1"), len(t)))
    return out


@pytest.mark.parametrize("capacity", [8, 300])
def test_decision_table_matches_the_jax_native_table(capacity):
    port = DecisionTable(capacity=capacity)
    jax = jax_table.ShmDecisionTable(capacity=capacity)
    try:
        assert port.capacity == jax.capacity
        assert _table_ops(port, capacity) == _table_ops(jax, capacity)
        assert port.dropped > 0 if capacity == 8 else port.dropped == 0
    finally:
        port.close()
        jax.close()
        jax.unlink()
    assert port.get("10.0.0.1") is None and len(port) == 0 and port.put("x", 1, NOW) is False


# ----------------------------------------------------------- the servers


@pytest.fixture()
def pinned(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    monkeypatch.setattr(time, "time_ns", lambda: int(NOW * 1e9))
    for mod in ("banjax_tpu.effectors.banner", "banjax_tpu_torch.effectors.banner"):
        monkeypatch.setattr(f"{mod}._format_ban_time", lambda t: "2026-01-01T00:00:00")


@pytest.fixture()
def loop():
    lp = asyncio.new_event_loop()
    t = threading.Thread(target=lp.run_forever, name="test-loop", daemon=True)
    t.start()
    yield lp
    lp.call_soon_threadsafe(lp.stop)
    t.join(timeout=10)
    lp.close()


def _run(lp, coro, timeout=30):
    return asyncio.run_coroutine_threadsafe(coro, lp).result(timeout)


def _config(path: Path, fast: bool, device_verify: bool, tmp_path: Path) -> Path:
    cfg = yaml.safe_load(FIXTURE.read_text())
    (tmp_path / "access.log").touch()
    # Kafka off: the JAX side here is a server without the app's Kafka loops
    cfg.update(http_fast_path=fast, serve_fastpath_enabled=True, disable_kafka=True,
               challenge_device_verify=device_verify, server_log_file=str(tmp_path / "access.log"),
               banning_log_file=str(path.with_suffix(".bans")))
    path.write_text(yaml.safe_dump(cfg))
    return path


class _JaxServer:
    """The JAX package's server over its own state, started on `lp`: the
    fast layout (aiohttp on a unix socket behind `start_fast_server`) or
    aiohttp alone."""

    def __init__(self, lp, cfg_path, fast, tmp_path):
        holder = JaxHolder(str(cfg_path))
        config = holder.get()
        self.lists = JaxDynamicLists(start_sweeper=False)
        self.table = jax_table.ShmDecisionTable(capacity=config.serve_decision_table_capacity)
        self.lists.set_mirror(self.table)
        self.ban_log = io.StringIO()
        health = JaxHealth()
        health.register("tailer")
        self.deps = jax_server.ServerDeps(
            config_holder=holder, static_lists=JaxLists(config), dynamic_lists=self.lists,
            protected_paths=JaxPaths(config), regex_states=RegexRateLimitStates(),
            failed_challenge_states=jax_failures(config),
            banner=JaxBanner(self.lists, self.ban_log, io.StringIO(), None),
            health=health, decision_table=self.table,
        )
        self.lp = lp
        self.fast_server = None

        async def start():
            app = jax_server.build_app(self.deps)
            self.runner = web.AppRunner(app, access_log=None)
            await self.runner.setup()
            if fast:
                sock = str(tmp_path / "jax-app.sock")
                await web.UnixSite(self.runner, sock).start()
                self.fast_server = await jax_fastserve.start_fast_server(
                    self.deps, sock, "127.0.0.1", 0)
                return self.fast_server.sockets[0].getsockname()[1]
            await web.TCPSite(self.runner, "127.0.0.1", 0).start()
            return next(a[1] for a in self.runner.addresses if isinstance(a, tuple))

        self.port = _run(lp, start())

    def stop(self):
        async def stop():
            if self.fast_server is not None:
                self.fast_server.close()
                await self.fast_server.wait_closed()
            await self.runner.cleanup()

        _run(self.lp, stop())
        self.table.close()
        self.table.unlink()


def _request(port, ip, path="/", host=HOST, cookie=None, method="GET", route="/auth_request"):
    head = f"{method} {route}?path={path} HTTP/1.1\r\nHost: {host}\r\n"
    if ip is not None:
        head += (f"X-Client-IP: {ip}\r\nX-Requested-Host: {host}\r\n"
                 f"X-Requested-Path: {path}\r\nX-Client-User-Agent: mozilla\r\n")
    if cookie:
        head += f"Cookie: {cookie}\r\n"
    head += "Connection: close\r\n\r\n"
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(head.encode())
        out = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                return out
            out += chunk


def _session(ip):
    return "deflect_session=" + go_query_escape(new_session_cookie(SECRET, 3600, ip))


def _solved(ip, bits=10):
    cookie = new_challenge_cookie_at("secret", int(NOW) + 600, ip)
    return "deflect_challenge3=" + go_query_escape(solve_challenge_for_testing(cookie, bits))


DECISIONS = [
    ("43.0.0.1", Decision.ALLOW), ("43.0.0.2", Decision.NGINX_BLOCK),
    ("43.0.0.3", Decision.IPTABLES_BLOCK), ("43.0.0.4", Decision.CHALLENGE),
    ("43.0.0.5", Decision.CHALLENGE), ("8.8.8.8", Decision.NGINX_BLOCK),
]

# (description, request kwargs, fast-path outcome: hit tier or miss
# reason, status)
REQUESTS = [
    ("allow, fresh session", dict(ip="43.0.0.1"), "allow", 200),
    ("allow, cookie echo", dict(ip="43.0.0.1", cookie=_session("43.0.0.1")), "allow", 200),
    ("allow, foreign cookie", dict(ip="43.0.0.1", cookie=_session("9.9.9.9")), "allow", 200),
    ("allow, HEAD", dict(ip="43.0.0.1", method="HEAD"), "allow", 200),
    ("nginx block", dict(ip="43.0.0.2"), "block", 403),
    ("iptables block, cookie", dict(ip="43.0.0.3", cookie=_session("43.0.0.3")), "block", 403),
    ("challenge, cookieless", dict(ip="43.0.0.4"), "challenge", 429),
    ("challenge, solved", dict(ip="43.0.0.5", cookie=_solved("43.0.0.5")), "challenge", 200),
    ("challenge, torn cookie", dict(ip="43.0.0.4", cookie=_solved("43.0.0.4", 0)
                                     .replace("deflect_challenge3=", "deflect_challenge3=A")),
     "challenge", 429),
    ("no decision", dict(ip="43.0.0.9"), "table", 200),
    ("global list beats the table", dict(ip="8.8.8.8"), "global_list", 429),
    ("per-site host", dict(ip="43.0.0.2", host="example.com"), "ineligible", 403),
    ("password host", dict(ip="43.0.0.1", host="localhost", path="wp-admin"), "ineligible", 401),
    ("password cookie", dict(ip="43.0.0.1", cookie="deflect_password3=x"), "password", 200),
]

COLD = [
    ("GET", "/info", None), ("GET", "/decision_lists", None), ("GET", "/rate_limit_states", None),
    ("GET", "/is_banned?ip=43.0.0.2", None), ("GET", "/is_banned?ip=1.1.1.1", None),
    ("GET", "/is_banned", None), ("GET", "/ipset/list", None),
    ("GET", "/banned?domain=d", None), ("GET", "/banned", None),
    ("POST", "/unban", b"ip=43.0.0.2"), ("POST", "/unban", b"ip=43.0.0.3"),
    ("POST", "/unban", b""), ("GET", "/nowhere", None),
]


def _cold(port, method, route, body):
    head = f"{method} {route} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
    if body is not None:
        head += ("Content-Type: application/x-www-form-urlencoded\r\n"
                 f"Content-Length: {len(body)}\r\n")
    head = (head + "Connection: close\r\n\r\n").encode() + (body or b"")
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(head)
        out = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            out += chunk
    status = out.split(b"\r\n", 1)[0]
    return status, out.split(b"\r\n\r\n", 1)[1]


@pytest.mark.parametrize("fast", [True, False], ids=["fast_layout", "aiohttp_layout"])
def test_port_server_matches_the_jax_server(tmp_path, pinned, loop, fast):
    jax_server_ = _JaxServer(loop, _config(tmp_path / "jax.yaml", fast, False, tmp_path),
                             fast, tmp_path)
    port_app = BanjaxApp(str(_config(tmp_path / "port.yaml", fast, True, tmp_path)),
                         device="cpu")
    try:
        port_app.start_background(port=0)
        assert port_app.port not in (0, 8081, None)
        assert port_app.tailer.opened.wait(10)
        for ip, decision in DECISIONS:
            for lists in (jax_server_.lists, port_app.dynamic_lists):
                lists.update(ip, NOW + 600, decision, False, "d")
        assert len(port_app.decision_table) == len(jax_server_.table) == len(DECISIONS)

        # the /auth_request hot path, request by request
        for desc, kw, outcome, status in REQUESTS:
            jax_raw = _request(jax_server_.port, **kw)
            port_raw = _request(port_app.port, **kw)
            assert _norm(port_raw) == _norm(jax_raw), (desc, _norm(port_raw)[:300],
                                                       _norm(jax_raw)[:300])
            assert port_raw.split(b" ", 2)[1] == str(status).encode(), desc
        stats = port_app.serve_stats.snapshot()
        if fast:
            jstats = jax_serve_stats().prom_snapshot()
            assert (stats["hits"], stats["misses"]) == (jstats["hits"], jstats["misses"])
            want_hits = {o for _, _, o, _ in REQUESTS if o in ("allow", "block", "challenge")}
            assert set(stats["hits"]) == want_hits
            assert set(stats["misses"]) == {o for _, _, o, _ in REQUESTS} - want_hits
        else:
            assert stats["hits_total"] == stats["misses_total"] == 0
        assert stats["faults_total"] == stats["fail_open_total"] == 0
        assert port_app.banner._ban_log.name.endswith(".bans")

        # the cold routes (through the fast server's proxy in the fast layout)
        for method, route, body in COLD:
            assert _cold(port_app.port, method, route, body) == \
                _cold(jax_server_.port, method, route, body), route
        for route in ("/healthz",):
            jax_status, jax_body = _cold(jax_server_.port, "GET", route, None)
            port_status, port_body = _cold(port_app.port, "GET", route, None)
            assert port_status == jax_status
            assert re.sub(rb'"age_seconds": [0-9.]+', b"", port_body) == \
                re.sub(rb'"age_seconds": [0-9.]+', b"", jax_body)
    finally:
        port_app.stop_background()
        jax_server_.stop()


class _RaisingTable:
    def __init__(self, inner):
        self.inner = inner

    def get(self, ip):
        raise OSError("table fault")

    def session_count(self):
        return self.inner.session_count()

    def __len__(self):
        return len(self.inner)

    @property
    def dropped(self):
        return self.inner.dropped


def test_fast_path_hits_equal_the_chain_and_a_table_fault_goes_to_the_chain(
        tmp_path, pinned, loop):
    port_app = BanjaxApp(str(_config(tmp_path / "port.yaml", True, True, tmp_path)),
                         device="cpu")
    handles = []
    try:
        for ip, decision in DECISIONS:
            port_app.dynamic_lists.update(ip, NOW + 600, decision, False, "d")
        deps = port_app.server_deps()
        chain_deps = dataclasses.replace(deps, decision_table=None)
        faulty_table = _RaisingTable(port_app.decision_table)
        faulty_deps = dataclasses.replace(deps, decision_table=faulty_table,
                                          serve_stats=type(deps.serve_stats)())
        for d in (deps, chain_deps, faulty_deps):
            handles.append(_run(loop, run_http_server(d, port=0)))
        hits = 0
        for desc, kw, outcome, _ in REQUESTS:
            if outcome not in ("allow", "block"):
                continue  # a challenge hit runs the chain's own stage: its state moves
            fast, chain, faulty = (_request(h.port, **kw) for h in handles)
            assert _norm(fast) == _norm(chain) == _norm(faulty), desc
            hits += 1
        assert deps.serve_stats.snapshot()["hits_total"] == hits
        assert chain_deps.serve_stats is deps.serve_stats
        fs = faulty_deps.serve_stats.snapshot()
        assert fs["faults_total"] == hits and fs["hits_total"] == 0
        assert fs["fail_open_total"] == 0
    finally:
        for h in handles:
            _run(loop, h.cleanup())
        port_app.shutdown()


def test_dynamic_lists_and_their_mirror_match_jax(monkeypatch):
    """The dynamic lists' admin reads and the mirror into the table, on one
    sequence of inserts, lazy expiries, removals and a clear."""
    from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
    from banjax_tpu_torch.httpapi.serve_stats import ServeFastpathStats

    clock = [NOW]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    port_table, jax_t = DecisionTable(capacity=64), jax_table.ShmDecisionTable(capacity=64)
    port, jax = DynamicDecisionLists(start_sweeper=False), JaxDynamicLists(start_sweeper=False)
    stats = ServeFastpathStats()
    port.set_mirror(port_table, stats)
    jax.set_mirror(jax_t)

    def observe():
        entries = lambda lst: sorted(  # noqa: E731
            (ip, int(e.decision), e.expires, e.domain) for ip, e in lst.format_ip_entries().items())
        banned = lambda lst, d: sorted(vars(b).items() for b in lst.check_by_domain(d))  # noqa: E731
        return (entries(port), banned(port, "a"), banned(port, "b"), port.metrics(),
                [port_table.get(f"10.0.0.{i}") for i in range(6)], len(port_table),
                port_table.session_count()), \
            (entries(jax), banned(jax, "a"), banned(jax, "b"), jax.metrics(),
             [jax_t.get(f"10.0.0.{i}") for i in range(6)], len(jax_t), jax_t.session_count())

    try:
        steps = [
            lambda lst: lst.update("10.0.0.1", NOW + 60, Decision.CHALLENGE, False, "a"),
            lambda lst: lst.update("10.0.0.1", NOW + 90, Decision.ALLOW, False, "a"),
            lambda lst: lst.update("10.0.0.2", NOW + 5, Decision.NGINX_BLOCK, True, "b"),
            lambda lst: lst.update("10.0.0.3", NOW + 60, Decision.IPTABLES_BLOCK, False, "a"),
            lambda lst: lst.update_by_session_id("10.0.0.4", "s1", NOW + 5, Decision.CHALLENGE,
                                                 False, "b"),
            lambda lst: lst.update_by_session_id("10.0.0.4", "s1", NOW + 9, Decision.NGINX_BLOCK,
                                                 False, "b"),
            lambda lst: lst.remove_by_ip("10.0.0.3"),
        ]
        for step in steps:
            step(port), step(jax)
            a, b = observe()
            assert a == b
        assert port.peek("10.0.0.1").decision == Decision.CHALLENGE
        clock[0] = NOW + 10  # 10.0.0.2 and the session entry expire on a read
        for lst in (port, jax):
            assert lst.check("s1", "10.0.0.9")[1] is False
            assert lst.check("", "10.0.0.2")[1] is False
        a, b = observe()
        assert a == b and a[6] == 0
        port.clear(), jax.clear()
        a, b = observe()
        assert a == b and a[5] == 0
        assert stats.snapshot()["mirror_errors_total"] == 0
    finally:
        port.close(), jax.close()
        port_table.close(), jax_t.close()
        jax_t.unlink()


# ------------------------------------------------- the observability routes

OBS_ROUTES = ("/metrics", "/debug/trace", "/decisions/explain?ip=8.8.8.8",
              "/decisions/explain?ip=43.0.0.2", "/decisions/explain", "/debug/incidents",
              "/traffic/top", "/traffic/top?k=x")


def _obs_view(route, status, body):
    """What must agree of an observability route's answer: its status and
    body, less wall and monotonic times and thread ids."""
    if route == "/metrics":
        from banjax_tpu_torch.obs.exposition import parse_text_format

        fams = parse_text_format(body.decode())
        return status, {f: [(n, l, v) for n, l, v in e["samples"]]
                        for f, e in fams.items() if e["type"] != "histogram"}
    payload = json.loads(body)
    if route == "/debug/trace":
        return status, [(e["name"], e["ph"], e["args"].get("ip")) for e in payload["traceEvents"]
                        if e["ph"] != "M"], payload["otherData"]["enabled"]
    for r in payload.get("records", ()):
        r.pop("t_monotonic")
        r.pop("time_unix")
    return status, payload


@pytest.mark.parametrize("fast", [True, False], ids=["fast_layout", "aiohttp_layout"])
def test_observability_routes_match_the_jax_server(tmp_path, pinned, loop, fast):
    """/metrics, /debug/trace, /decisions/explain, /debug/incidents and
    /traffic/top against the JAX server over the same decisions and
    requests (through the fast server's proxy in the fast layout); then
    the chain's failpoints answer fail-open as the JAX server's do."""
    from banjax_tpu.obs import slo as jax_slo
    from banjax_tpu.obs import trace as jax_trace
    from banjax_tpu.resilience import failpoints as jax_fp
    from banjax_tpu_torch.resilience import failpoints as port_fp

    jax_cfg = _config(tmp_path / "jax.yaml", fast, False, tmp_path)
    jax_server_ = _JaxServer(loop, jax_cfg, fast, tmp_path)
    jax_server_.deps.slo_getter = lambda: jax_slo.SloEngine.from_config(jax_server_.deps.config_holder.get())
    port_cfg = _config(tmp_path / "port.yaml", fast, False, tmp_path)
    cfg = yaml.safe_load(port_cfg.read_text())
    cfg["trace_enabled"] = True
    port_cfg.write_text(yaml.safe_dump(cfg))
    port_app = BanjaxApp(str(port_cfg), device="cpu")
    jax_trace.configure(enabled=True)
    try:
        port_app.start_background(port=0)
        assert port_app.tailer.opened.wait(10)
        for ip, decision in DECISIONS:
            for lists in (jax_server_.lists, port_app.dynamic_lists):
                lists.update(ip, NOW + 600, decision, False, "d")
        for _, kw, _, _ in REQUESTS:
            assert _norm(_request(port_app.port, **kw)) == _norm(_request(jax_server_.port, **kw))
        for route in OBS_ROUTES:
            got = _obs_view(route, *_cold(port_app.port, "GET", route, None))
            want = _obs_view(route, *_cold(jax_server_.port, "GET", route, None))
            assert got == want, route
        explain = json.loads(_cold(port_app.port, "GET", "/decisions/explain?ip=8.8.8.8", None)[1])
        assert explain["records"] and explain["ledger_enabled"]
        trace = json.loads(_cold(port_app.port, "GET", "/debug/trace?clear=1", None)[1])
        assert any(e["name"] == "challenge.sha_inv" for e in trace["traceEvents"])
        assert json.loads(_cold(port_app.port, "GET", "/debug/trace", None)[1])["traceEvents"] == []

        # the chain's failpoints: an injected fault answers fail-open (8.8.8.8
        # is on the global challenge list, so the fast path defers to the chain)
        kw = dict(ip="8.8.8.8", cookie=_solved("8.8.8.8"))
        for site in ("decision_chain", "challenge.issue", "challenge.verify"):
            answers = []
            for fp, srv_port in ((port_fp, port_app.port), (jax_fp, jax_server_.port)):
                fp.arm(site, "error", count=1)
                raw = _request(srv_port, **(kw if site == "challenge.verify" else dict(ip="8.8.8.8")))
                answers.append(re.sub(rb"X-Banjax-Error: [^\r\n]*", b"X-Banjax-Error: MASKED",
                                      _norm(raw)))
                fp.disarm()
            assert answers[0] == answers[1], site
            assert b" 500 " in answers[0].split(b"\r\n", 1)[0] and b"@fail_open" in answers[0]
        assert port_app.serve_stats.snapshot()["fail_open_total"] == 3
    finally:
        port_app.stop_background()
        jax_server_.stop()


@pytest.mark.parametrize("route", ["/metrics", "/debug/trace", "/decisions/explain?ip=1.2.3.4",
                                   "/debug/incidents", "/traffic/top", "/healthz"])
def test_admin_routes_refuse_without_the_token_as_jax(tmp_path, loop, route):
    """Off loopback with an `admin_token`, both servers answer 401 without
    the bearer token and 200 with it (the app is bound to 127.0.0.1; only
    the listener host the gate reads is not loopback)."""
    cfg_path = _config(tmp_path / "tok.yaml", False, False, tmp_path)
    cfg = yaml.safe_load(cfg_path.read_text())
    cfg["admin_token"] = "s3cret"
    cfg_path.write_text(yaml.safe_dump(cfg))
    jax_srv = _JaxServer(loop, cfg_path, False, tmp_path)
    port_app = BanjaxApp(str(cfg_path), device="cpu")
    from banjax_tpu_torch.httpapi import server as port_server

    runners = []

    async def serve(app):
        runner = web.AppRunner(app, access_log=None)
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", 0).start()
        runners.append(runner)
        return next(a[1] for a in runner.addresses if isinstance(a, tuple))

    try:
        ports = [_run(loop, serve(jax_server.build_app(jax_srv.deps, listen_host="192.0.2.1"))),
                 _run(loop, serve(port_server.build_app(port_app.server_deps(),
                                                        listen_host="192.0.2.1")))]
        for token, want in ((None, 401), ("Bearer s3cret", 200), ("Bearer nope", 401)):
            statuses = []
            for p in ports:
                head = f"GET {route} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
                if token:
                    head += f"Authorization: {token}\r\n"
                with socket.create_connection(("127.0.0.1", p), timeout=10) as sck:
                    sck.sendall((head + "\r\n").encode())
                    raw = b""
                    while chunk := sck.recv(65536):
                        raw += chunk
                statuses.append(int(raw.split(b" ", 2)[1]))
            assert statuses == [want, want], (route, token, statuses)
    finally:
        for r in runners:
            _run(loop, r.cleanup())
        port_app.shutdown()
        jax_srv.stop()
