"""Multi-process serving of the port (`banjax_tpu_torch/httpapi/workers.py`,
`worker_serve.py`, the fc_* table of `native/shmstate.c` and
`native/shm.py`, `native/decisiontable.py` `ShmDecisionTable`):

- seeded `apply` sequences into the port's and the JAX package's
  `ShmFailedChallengeStates`, the clock pinned: the same results,
  `format_states`, counts and drops; a slot lock held by a dead pid or a
  wedged live one is stolen (`tests/faults/test_shm_lock_steal.py`);
- the named decision table: attached by name, a worker reads what the
  primary wrote; the segments are gone once the creator unlinks them;
- one module-scoped port app with two SO_REUSEPORT workers on an
  ephemeral port: a seeded request sequence over fresh connections
  answers exactly as the port's single-process app, an IP failing
  challenges across processes is banned at the threshold with one
  ban-log line, the cold routes answer through the proxy, a reload fans
  out, and a killed worker is respawned while the rest keep serving.
"""

import os
import re
import socket
import subprocess
import time
import types
from pathlib import Path

import pytest
import yaml

from banjax_tpu.native import shm as jax_shm
from banjax_tpu_torch import cli as port_cli
from banjax_tpu_torch.native import shm as port_shm
from banjax_tpu_torch.native.decisiontable import ShmDecisionTable
from tests.test_torch_matcher import _one_torch_thread  # noqa: F401

CFG = types.SimpleNamespace(too_many_failed_challenges_interval_seconds=10,
                            too_many_failed_challenges_threshold=3)
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "banjax-config-test.yaml"


class _Clock:
    """time.time_ns for both tables: advances `step_ns` per call."""

    def __init__(self, step_ns):
        self.t = 1_790_000_000 * 10**9
        self.step_ns = step_ns

    def time_ns(self):
        self.t += self.step_ns
        return self.t


def _dead_pid():
    p = subprocess.Popen(["sleep", "0"])
    p.wait()
    return p.pid


# ------------------------------------------------------------ the fc table


@pytest.mark.parametrize("seed, capacity, step_ms", [(1, 1024, 1500), (2, 64, 1500),
                                                     (3, 8, 1500), (4, 8, 10)])
def test_fc_apply_sequences_match_jax(monkeypatch, seed, capacity, step_ms):
    """Results, format_states, len and dropped equal JAX's over one seeded
    sequence; at capacity 8 the probe window fills: expired slots are
    stolen (a 1.5 s step) or, when none is expired (a 10 ms step), the
    first hit goes unstored and counts as dropped."""
    import random

    got = {}
    for name, mod in (("port", port_shm), ("jax", jax_shm)):
        monkeypatch.setattr(mod, "time", _Clock(step_ms * 1_000_000))
        t = mod.ShmFailedChallengeStates(capacity=capacity)
        try:
            rng = random.Random(seed)
            out = []
            for i in range(400):
                ip = rng.choice([f"9.{seed}.{rng.randrange(4)}.{rng.randrange(40)}", "", "x" * 200])
                r = t.apply(ip, CFG)
                out.append((int(r.match_type), r.exceeded))
            got[name] = (out, t.format_states(), len(t), t.dropped)
        finally:
            t.close()
            t.unlink()
    assert got["port"] == got["jax"]
    assert got["port"][2] > 0 and any(e for _, e in got["port"][0])
    assert (got["port"][3] > 0) == (step_ms == 10)


@pytest.mark.parametrize("owner", ["dead", "live"])
def test_a_held_slot_lock_is_stolen(owner):
    t = port_shm.ShmFailedChallengeStates(capacity=256)
    try:
        tag = _dead_pid() if owner == "dead" else os.getpid()
        if owner == "live":
            t.set_steal_ns(2_000_000)
        for i in range(t.capacity):
            t._test_lock_slot(i, tag)
        t0 = time.monotonic()
        assert t.apply("9.9.9.9", CFG).match_type == 0
        assert time.monotonic() - t0 < 2.0
        assert t.apply("9.9.9.9", CFG).match_type == 2
        t._test_lock_slot(5, os.getpid())
        assert t._test_slot_owner(5) == os.getpid()
    finally:
        t.set_steal_ns(50_000_000)
        t.close()
        t.unlink()


def test_named_tables_attach_and_unlink():
    fc = port_shm.ShmFailedChallengeStates(capacity=64)
    dt = ShmDecisionTable(capacity=64)
    try:
        dt.put("1.2.3.4", 3, 2e9, True, "d")
        fc.apply("5.6.7.8", CFG)
        code = (
            "import sys; from banjax_tpu_torch.native.shm import ShmFailedChallengeStates as F;"
            "from banjax_tpu_torch.native.decisiontable import ShmDecisionTable as D;"
            f"f = F(name={fc.name!r}); d = D(name={dt.name!r});"
            "print(len(f), d.get('1.2.3.4'), d.capacity); f.close(); d.close()"
        )
        out = subprocess.run([os.environ.get("PYTHON", "python3"), "-c", code],
                             capture_output=True, text=True, timeout=60,
                             cwd=Path(__file__).resolve().parents[1])
        assert out.stdout.split("\n")[0] == "1 (3, 2000000000.0, True) 64", out.stderr
        # the attaching process left the segments to their creator
        assert len(fc) == 1 and dt.get("1.2.3.4") is not None
    finally:
        for t in (fc, dt):
            t.close()
            t.unlink()
    with pytest.raises(FileNotFoundError):
        port_shm.ShmFailedChallengeStates(name=fc.name)


# ------------------------------------------------------------ the app


def _config(tmp_path, name, workers, **extra):
    cfg = yaml.safe_load(FIXTURE.read_text())
    (tmp_path / f"{name}.log").touch()
    cfg.update(http_workers=workers, disable_kafka=True, gin_log_file="-",
               server_log_file=str(tmp_path / f"{name}.log"),
               banning_log_file=str(tmp_path / f"{name}.bans"),
               too_many_failed_challenges_threshold=5)
    cfg.update(extra)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _request(port, ip, host="localhost:8081", path="/", cookie=None, route="/auth_request"):
    """One request on a fresh connection (SO_REUSEPORT spreads them)."""
    head = (f"GET {route} HTTP/1.1\r\nHost: {host}\r\nX-Client-IP: {ip}\r\n"
            f"X-Requested-Host: {host}\r\nX-Requested-Path: {path}\r\n"
            "X-Client-User-Agent: ua\r\nConnection: close\r\n")
    if cookie:
        head += f"Cookie: {cookie}\r\n"
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall((head + "\r\n").encode())
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return buf


def _status(raw):
    return int(raw.split(b" ", 2)[1])


_MASKS = ((rb"(deflect_session=|deflect_challenge3=|deflect_password3=)([^;\r\n]+)", rb"\1M"),
          (rb"(X-Deflect-Session: )(\S+)", rb"\1M"), (rb"(Date: )([^\r\n]+)", rb"\1M"),
          (rb"[A-Za-z0-9+/=]{40,}", rb"B64"))


def _norm(raw):
    for pat, repl in _MASKS:
        raw = re.sub(pat, repl, raw)
    return raw


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """The port's app with two workers, and its single-process twin."""
    mp = pytest.MonkeyPatch()
    mp.setattr(port_cli, "init_ipset", lambda *a, **k: None)
    tmp = tmp_path_factory.mktemp("workers")
    multi = port_cli.BanjaxApp(str(_config(tmp, "multi", 2)), device="cpu")
    single = port_cli.BanjaxApp(str(_config(tmp, "single", 0)), device="cpu")
    try:
        multi.start_background(port=0)
        single.start_background(port=0)
        assert multi._supervisor.wait_ready(60), "the workers did not come up"
        yield types.SimpleNamespace(multi=multi, single=single, tmp=tmp)
    finally:
        multi.stop_background()
        single.stop_background()
        mp.undo()


def _requests(seed, n):
    import random

    rng = random.Random(seed)
    out = []
    for i in range(n):
        k = rng.random()
        if k < 0.3:
            out.append(dict(ip=f"40.0.0.{rng.randrange(1, 50)}", host="example.com"))
        elif k < 0.45:
            out.append(dict(ip=rng.choice(["8.8.8.8", "70.80.90.100", "20.20.20.20",
                                           "91.91.91.91"]), host="example.com"))
        elif k < 0.6:
            out.append(dict(ip=f"41.0.0.{i}", host="localhost:8081", path="/wp-admin/x",
                            cookie="deflect_password3=garbage"))
        elif k < 0.75:
            out.append(dict(ip="92.92.92.92", host="localhost:8081"))
        else:
            out.append(dict(ip=f"42.0.{i % 3}.{rng.randrange(1, 9)}", host="news.net",
                            path=f"/p{i % 7}"))
    return out


def test_responses_equal_the_single_process_app(apps):
    for kw in _requests(seed=4, n=120):
        assert _norm(_request(apps.multi.port, **kw)) == _norm(_request(apps.single.port, **kw)), kw
    # the workers answered some of them
    assert all(p.poll() is None for p in apps.multi._supervisor._procs)


def test_failed_challenges_across_processes_ban_at_the_threshold(apps):
    """Six failed password challenges over fresh connections (spread over
    the processes) answer as the single-process app's: the sixth passes
    the threshold of 5 and is banned; every process then answers 403, and
    the ban log has one line."""
    got = {}
    for name, app in (("multi", apps.multi), ("single", apps.single)):
        got[name] = [_status(_request(app.port, "23.23.23.23", path="/wp-admin/x",
                                      cookie="deflect_password3=garbage")) for _ in range(6)]
    assert got["multi"] == got["single"] == [401] * 5 + [403]
    app = apps.multi
    deadline = time.time() + 5
    while time.time() < deadline and not all(
            _status(_request(app.port, "23.23.23.23")) == 403 for _ in range(4)):
        time.sleep(0.05)
    assert {_status(_request(app.port, "23.23.23.23")) for _ in range(8)} == {403}
    bans = {name: [re.sub(r'"timestring":"[^"]*"', "", ln) for ln in Path(
        a.config_holder.get().banning_log_file).read_text().splitlines() if '"23.23.23.23"' in ln]
        for name, a in (("multi", apps.multi), ("single", apps.single))}
    assert bans["multi"] == bans["single"] and len(bans["multi"]) == 1
    assert '"number_of_fails":5' in bans["multi"][0] and "IptablesBlock" in bans["multi"][0]


def test_cold_routes_answer_through_the_proxy(apps):
    app = apps.multi
    for _ in range(6):
        for route, want in (("/rate_limit_states", b"failed challenges:"),
                            ("/decision_lists", b"per_site:"), ("/ipset/list", b"entries"),
                            ("/info", b"config_version"), ("/healthz", b"worker-supervisor"),
                            ("/metrics", b"banjax_http_workers 2")):
            raw = _request(app.port, "1.1.1.1", route=route)
            assert _status(raw) == 200 and want in raw, (route, raw[:300])


def test_reload_fans_out(apps):
    app = apps.multi
    path = Path(app.config_holder.path)
    text = path.read_text()
    new = text.replace("config_version: 2022-01-02_00:00:00", "config_version: 2033-03-03_03:03:03")
    assert new != text
    path.write_text(new)
    app.reload()
    deadline, seen = time.time() + 10, set()
    while time.time() < deadline:
        seen = {re.search(rb'"config_version": "([^"]+)"',
                          _request(app.port, "1.1.1.1", route="/info")).group(1)
                for _ in range(8)}
        if seen == {b"2033-03-03_03:03:03"}:
            break
        time.sleep(0.1)
    assert seen == {b"2033-03-03_03:03:03"}


# the respawned worker is a child of the module's app, which stops it at
# the module's end
@pytest.mark.allow_leaks
def test_a_killed_worker_is_respawned(apps):
    sup = apps.multi._supervisor
    victim = sup._procs[0]
    sup.kill_worker(0)
    victim.wait(timeout=5)
    served = 0
    deadline = time.time() + 10
    while time.time() < deadline and served < 10:
        try:
            served += _status(_request(apps.multi.port, f"30.30.30.{served + 1}")) == 200
        except OSError:
            pass  # a connection queued on the dead listener
    assert served >= 10
    assert sup.wait_ready(20) and sup._procs[0].pid != victim.pid
    assert sup.respawn_count >= 1
    assert apps.multi.health.snapshot()["components"]["worker-supervisor"]["status"] in (
        "healthy", "degraded")


def test_a_worker_imports_no_torch():
    """A worker never touches the card: its module, and all it imports,
    leave torch unimported."""
    code = ("import sys, banjax_tpu_torch.httpapi.worker_serve; "
            "print(sorted(m for m in sys.modules if m == 'torch' or m.startswith('torch.')))")
    out = subprocess.run([os.environ.get("PYTHON", "python3"), "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "[]", out.stderr


def test_http_workers_auto_resolves_as_jax(monkeypatch):
    from banjax_tpu_torch.cli import http_worker_count

    monkeypatch.setattr(os, "cpu_count", lambda: 5)
    assert [http_worker_count(n) for n in (-1, 0, 3, -2)] == [4, 0, 3, 0]
    monkeypatch.setattr(os, "cpu_count", lambda: None)
    assert http_worker_count(-1) == 0
