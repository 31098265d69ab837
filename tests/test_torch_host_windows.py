"""The host window states and the host matcher: the port's
`RegexRateLimitStates`, `CpuMatcher` (`matcher: cpu`) and `TorchMatcher`
with `matcher_device_windows: false` against the JAX package's, on the
CPU, tolerance 0.

- `RegexRateLimitStates` on a seeded `apply` sequence: seen_ip, results,
  `get`, `format_states` and the length.
- `CpuMatcher` on malformed, old, allowlisted, per-site-first and
  `hosts_to_skip` lines: results, ban-log bytes, bans and states.
- `TorchMatcher(device="cpu")` with host windows against JAX `TpuMatcher`
  with host windows (its XLA scan) and against JAX `CpuMatcher`:
  synchronous, through the port's `PipelineScheduler` (the windows step
  at the drain), and on a 2 x 2 mesh under `tests/test_torch_mesh.py`'s
  `jax_mesh_shim`; and continuing from JAX host states carried over by
  `convert.load_regex_states`.
- `BanjaxApp` from a YAML with no `matcher` key (the host matcher) and
  with `matcher: tpu` without device windows, against the JAX app, both
  tailing one log: ban-log bytes, `/rate_limit_states` bytes and
  `LenIpToRegexStates`.
- The deploy file with its `matcher:` line removed, with host windows
  (tiering off) and with `pallas_single_kernel: off` loads with nothing
  left unported and builds the matcher it names.
- An open breaker refuses batches in every device mode, and neither an
  open breaker nor a device fault builds or calls `CpuMatcher`.
"""

import io
import json
import time
import urllib.request

import numpy as np
import pytest
import yaml

from banjax_tpu import cli as jax_cli
from banjax_tpu.config.schema import config_from_yaml_text as jax_config
from banjax_tpu.decisions import rate_limit as jax_rl
from banjax_tpu.decisions.static_lists import StaticDecisionLists as JaxLists
from banjax_tpu.matcher.cpu_ref import CpuMatcher as JaxCpuMatcher
from banjax_tpu.matcher.runner import TpuMatcher
from banjax_tpu.obs import metrics as jax_metrics
from banjax_tpu_torch import cli as port_cli
from banjax_tpu_torch import convert, workload
from banjax_tpu_torch.cli import BanjaxApp, RegexStatesView, build_matcher
from banjax_tpu_torch.config import config_from_yaml_text
from banjax_tpu_torch.decisions import rate_limit as port_rl
from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
from banjax_tpu_torch.effectors.banner import Banner
from banjax_tpu_torch.matcher import cpu_ref
from banjax_tpu_torch.matcher.runner import BreakerOpen, TorchMatcher
from banjax_tpu_torch.obs import metrics as port_metrics
from banjax_tpu_torch.pipeline import PipelineScheduler
from banjax_tpu_torch.resilience import failpoints as port_fp
from tests.differential.test_tpu_matcher import result_key
from tests.test_torch_app import _Counted, _config, _wait_consumed
from tests.test_torch_app import _lines as app_lines
from tests.test_torch_matcher import _RecordingBanner, _lines, _one_torch_thread  # noqa: F401
from tests.test_torch_matcher import _yaml
from tests import mesh_oracle
from tests.test_torch_mesh import CASES, jax_mesh_shim  # noqa: F401
from tests.test_torch_obs import obs_reset  # noqa: F401


@pytest.fixture(autouse=True)
def _port_ipset_off(monkeypatch):
    """Both apps run with their ipset off (`init_ipset` returns None);
    tests/test_torch_ipset.py covers the kernel edge."""
    monkeypatch.setattr(port_cli, "init_ipset", lambda *a, **k: None)
    monkeypatch.setattr(jax_cli, "init_ipset", lambda *a, **k: None)


@pytest.fixture(autouse=True)
def _disarmed():
    port_fp.disarm()
    yield
    port_fp.disarm()


def _mode_yaml(mode, **over):
    """`tests/test_torch_matcher.py`'s YAML (the differential rules, eight
    generated rules, 128-line chunks) in one matcher mode."""
    cfg = yaml.safe_load(_yaml())
    if mode == "cpu":
        del cfg["matcher"]
        cfg.pop("matcher_device_windows")
    elif mode == "host":
        cfg["matcher_device_windows"] = False
    elif mode == "two":
        cfg["pallas_single_kernel"] = "off"
    cfg.update(over)
    return yaml.safe_dump(cfg)


def _port(yaml_text, states=None):
    cfg = config_from_yaml_text(yaml_text)
    log = io.StringIO()
    banner = Banner(DynamicDecisionLists(start_sweeper=False), log, io.StringIO())
    states = states if states is not None else port_rl.RegexRateLimitStates()
    m = build_matcher(cfg, banner, StaticDecisionLists(cfg), states, device="cpu")
    return m, log, states


def _jax(cls, yaml_text, **over):
    cfg = jax_config(yaml_text)
    for k, v in over.items():
        setattr(cfg, k, v)
    log = io.StringIO()
    banner = _RecordingBanner(log)
    states = jax_rl.RegexRateLimitStates()
    return cls(cfg, banner, JaxLists(cfg), states), log, states


# ------------------------------------------------------------ the host states


def test_regex_states_equal_jax_on_a_seeded_apply_sequence():
    rng = np.random.default_rng(13)
    text = _yaml()
    jrules = jax_config(text).regexes_with_rates
    prules = config_from_yaml_text(text).regexes_with_rates
    assert [r.rule for r in jrules] == [r.rule for r in prules]
    js, ps = jax_rl.RegexRateLimitStates(), port_rl.RegexRateLimitStates()
    t = 1_790_000_000 * 10**9
    ips = [f"10.0.0.{i}" for i in range(6)]
    for _ in range(400):
        # steps inside and outside the windows (intervals of 1-5 s and
        # the generated rules'), with exact-boundary repeats
        t += int(rng.choice([0, 1, 10**8, 10**9, 5 * 10**9, 6 * 10**9]))
        ip = ips[int(rng.integers(len(ips)))]
        k = int(rng.integers(len(jrules)))
        jseen, jres = js.apply(ip, jrules[k], t)
        pseen, pres = ps.apply(ip, prules[k], t)
        assert (pseen, int(pres.match_type), pres.exceeded) == \
            (jseen, int(jres.match_type), jres.exceeded)
        assert str(pres.match_type) == str(jres.match_type)
    assert len(ps) == len(js) == len(ips)
    for ip in ips + ["10.9.9.9"]:
        jg, jhave = js.get(ip)
        pg, phave = ps.get(ip)
        assert phave == jhave
        assert {r: (s.num_hits, s.interval_start_time_ns) for r, s in pg.items()} == \
            {r: (s.num_hits, s.interval_start_time_ns) for r, s in jg.items()}
    assert ps.format_states() == js.format_states() != ""
    assert port_rl.RegexRateLimitStates().format_states() == ""


def test_cpu_matcher_equals_jax():
    now = time.time()
    lines = _lines(now, n=256, seed=21)
    text = _mode_yaml("cpu")
    port, plog, pstates = _port(text)
    assert isinstance(port, cpu_ref.CpuMatcher)
    jax_m, jlog, jstates = _jax(JaxCpuMatcher, text)
    got = [port.consume_line(ln, now) for ln in lines]
    want = [jax_m.consume_line(ln, now) for ln in lines]
    assert [result_key(r) for r in got] == [result_key(r) for r in want]
    # every kind of line is there: malformed, old, allowlisted, per-site
    # first, a skipped host
    keys = [result_key(r) for r in got]
    assert any(k[0] for k in keys) and any(k[1] for k in keys) and any(k[2] for k in keys)
    assert any(rr[0] == "instant block" for k in keys for rr in k[3])
    assert any(rr[2] for k in keys for rr in k[3])
    assert plog.getvalue() == jlog.getvalue() != ""
    assert pstates.format_states() == jstates.format_states()
    # the batch entry point gives the same as line by line
    port2, plog2, _ = _port(text)
    assert [result_key(r) for r in port2.consume_lines(lines, now)] == keys
    assert plog2.getvalue() == plog.getvalue()
    assert port2.stats.snapshot()["MatcherLinesTotal"] == len(lines)


# ------------------------------------------------------------ host windows


def test_host_windows_equal_jax_tpu_matcher_and_cpu_oracle():
    now = time.time()
    lines = _lines(now)
    text = _mode_yaml("host")
    port, plog, pstates = _port(text)
    assert isinstance(port, TorchMatcher)
    assert port.device_windows is None and port._fw_pipeline is None
    assert port.traffic_sketch is None and port._prefilter is not None
    tpu, tlog, tstates = _jax(TpuMatcher, text)
    cpu, clog, cstates = _jax(JaxCpuMatcher, text)
    assert tpu.device_windows is None
    got = []
    for s in range(0, len(lines), 100):
        got += port.consume_lines(lines[s : s + 100], now)
    tpu_res = []
    for s in range(0, len(lines), 100):
        tpu_res += tpu.consume_lines(lines[s : s + 100], now)
    want = [cpu.consume_line(ln, now) for ln in lines]
    keys = [result_key(r) for r in got]
    assert keys == [result_key(r) for r in tpu_res] == [result_key(r) for r in want]
    assert plog.getvalue() == tlog.getvalue() == clog.getvalue() != ""
    assert pstates.format_states() == tstates.format_states() == cstates.format_states()
    # the line entry point, a batch of one
    tail = f"{now:f} 10.1.0.1 POST example.com POST /submit HTTP/1.1 ua -"
    assert result_key(port.consume_line(tail, now)) == result_key(tpu.consume_line(tail, now))
    assert pstates.format_states() == tstates.format_states()


def test_host_windows_pipelined_equal_jax_synchronous():
    """The port's scheduler over a host-window TorchMatcher: the windows
    step at the drain, after the staleness re-cut, in admission order."""
    now = time.time()
    lines = _lines(now, n=384, seed=9)
    text = _mode_yaml("host", matcher_native_parse=True)
    port, plog, pstates = _port(text)
    tpu, tlog, tstates = _jax(TpuMatcher, text)
    want = tpu.consume_lines(lines, now)
    collected = []
    sched = PipelineScheduler(lambda: port, on_results=lambda bl, rs: collected.append(rs),
                              now_fn=lambda: now, latency_budget_ms=1e9)
    sched._sizer.target = lambda: 96
    sched.submit(lines)
    sched.start()
    try:
        assert sched.flush(120)
    finally:
        sched.stop()
    assert len(collected) > 2
    assert [result_key(r) for rs in collected for r in rs] == [result_key(r) for r in want]
    assert plog.getvalue() == tlog.getvalue() != ""
    assert pstates.format_states() == tstates.format_states()
    assert sched.stats.peek()["PipelineShedLines"] == 0


def test_host_windows_on_a_mesh_equal_jax_mesh():
    """(The JAX mesh runs under `jax_mesh_shim`, imported above: an
    autouse fixture, so every test here runs with it.)"""
    rules, make_lines, _, _ = CASES["generated_fused"]
    text = rules()
    now = time.time()
    lines = make_lines(now)
    cfg = config_from_yaml_text(text)
    cfg.matcher, cfg.matcher_mesh_devices, cfg.matcher_mesh_rp = "tpu", 4, 2
    states = port_rl.RegexRateLimitStates()
    log = io.StringIO()
    port = TorchMatcher(cfg, Banner(DynamicDecisionLists(start_sweeper=False), log,
                                    io.StringIO()), StaticDecisionLists(cfg), states,
                        device="cpu")
    assert port.device_windows is None
    assert (port._mesh_matcher.dp, port._mesh_matcher.rp) == (2, 2)
    jax_m, jax_b = mesh_oracle.build_matcher(TpuMatcher, text, mesh_devices=4, mesh_rp=2)
    assert jax_m._mesh_matcher is not None and jax_m.device_windows is None
    cpu_m, _ = mesh_oracle.build_matcher(JaxCpuMatcher, text)
    got = port.consume_lines(lines, now)
    jres = jax_m.consume_lines(lines, now)
    want = [cpu_m.consume_line(ln, now) for ln in lines]
    keys = [mesh_oracle.result_key(r) for r in got]
    assert keys == [mesh_oracle.result_key(r) for r in jres] == \
        [mesh_oracle.result_key(r) for r in want]
    assert states.format_states() == jax_m.rate_limit_states.format_states() != ""
    assert log.getvalue().count("\n") == len(jax_b.regex_ban_logs) > 0
    mm, jm = port._mesh_matcher, jax_m._mesh_matcher
    assert (mm.fused_batches, mm.fallback_batches) == (jm.fused_batches, jm.fallback_batches)


def test_host_states_carried_from_jax_continue_identically():
    now = time.time()
    lines = _lines(now, n=256, seed=17)
    text = _mode_yaml("host")
    tpu, tlog, tstates = _jax(TpuMatcher, text)
    tpu.consume_lines(lines[:160], now)
    pstates = port_rl.RegexRateLimitStates()
    convert.load_regex_states(pstates, tstates._states)
    assert pstates.format_states() == tstates.format_states() != ""
    port, plog, _ = _port(text, states=pstates)
    tlog.seek(0)
    tlog.truncate()
    got = port.consume_lines(lines[160:], now)
    want = tpu.consume_lines(lines[160:], now)
    assert [result_key(r) for r in got] == [result_key(r) for r in want]
    assert plog.getvalue() == tlog.getvalue()
    assert pstates.format_states() == tstates.format_states()
    # a plain mapping of pairs carries over too
    other = port_rl.RegexRateLimitStates()
    convert.load_regex_states(other, {"1.2.3.4": {"rule1": (2, 5)}})
    assert other.format_states() == "1.2.3.4:\n\trule1:\n\t\tNumHitsAndIntervalStart(2, 5)\n\n"


# ------------------------------------------------------------ the app


def _app_yaml(path, mode):
    cfg = yaml.safe_load(path.read_text())
    if mode == "cpu":
        for k in ("matcher", "matcher_device_windows", "pallas_single_kernel"):
            cfg.pop(k, None)
    else:
        cfg["matcher_device_windows"] = False
    path.write_text(yaml.safe_dump(cfg))
    return path


def _rate_limit_states_body(view, failed):
    # the JAX route's body (`banjax_tpu/httpapi/server.py` rate_limit_states_route)
    return f"regexes:\n{view.format_states()}\nfailed challenges:\n{failed.format_states()}\n"


@pytest.mark.parametrize("mode", ["cpu", "host"])
def test_app_host_states_equal_jax_app(tmp_path, mode):
    log_path = tmp_path / "access.log"
    log_path.write_text("")
    jax_app = jax_cli.BanjaxApp(str(_app_yaml(_config(tmp_path, "jax", log_path), mode)))
    port_app = BanjaxApp(str(_app_yaml(_config(tmp_path, "port", log_path), mode)),
                         device="cpu")
    counts = (_Counted(jax_app), _Counted(port_app))
    try:
        jax_app.tailer.start()
        port_app.start_background(port=0)
        assert jax_app.tailer.opened.wait(10) and port_app.tailer.opened.wait(10)
        assert port_app.config_holder.get().not_ported == []
        total = 0
        for seed in (1, 2):
            batch = app_lines(time.time(), 160, seed)
            with open(log_path, "a") as f:
                f.write("\n".join(batch) + "\n")
            total += len(batch)
            _wait_consumed(counts, total)
        want_cls = cpu_ref.CpuMatcher if mode == "cpu" else TorchMatcher
        assert type(port_app._matcher) is want_cls
        assert port_app._matcher.device_windows is None
        jax_bans = (tmp_path / "jax-bans.log").read_text()
        assert (tmp_path / "port-bans.log").read_text() == jax_bans != ""
        with urllib.request.urlopen(f"http://127.0.0.1:{port_app.port}/rate_limit_states",
                                    timeout=10) as r:
            body = r.read().decode()
        want = _rate_limit_states_body(jax_cli.RegexStatesView(jax_app),
                                       jax_app.failed_challenge_states)
        assert body == want
        assert port_app.regex_states.format_states() in body
        assert len(port_app.regex_states) > 0
        lens = []
        for write, app, view, extra in (
            (jax_metrics.write_metrics_line, jax_app, jax_cli.RegexStatesView(jax_app),
             (jax_app._matcher, None, jax_app.health)),
            (port_metrics.write_metrics_line, port_app, RegexStatesView(port_app),
             (port_app._matcher, port_app.health)),
        ):
            out = io.StringIO()
            write(out, app.dynamic_lists, view, app.failed_challenge_states, *extra)
            line = json.loads(out.getvalue())
            lens.append((line["LenIpToRegexStates"], line["MatcherLinesTotal"],
                         line["Health_matcher"]))
        assert lens[0] == lens[1]
        assert lens[1][0] == len(port_app.regex_states) and lens[1][1] == total
    finally:
        port_app.shutdown()
        jax_app.shutdown()


def test_deploy_file_variants_load_and_build_their_matcher():
    with open("deploy/banjax-config.yaml") as f:
        text = f.read()
    patterns = workload.generate_rules(12, seed=7)
    rules = yaml.safe_load(workload.rules_config(patterns, seed=7))
    small = dict(matcher_batch_lines=64, matcher_window_capacity=256,
                 warm_tier_capacity=1024, traffic_sketch_width=1024)
    no_matcher = "\n".join(ln for ln in text.splitlines() if not ln.startswith("matcher:"))
    variants = {
        "cpu": (no_matcher, {}),
        "host": (text, dict(matcher_device_windows=False, slot_admission_enabled=False,
                            warm_tier_enabled=False)),
        "two": (text, dict(pallas_single_kernel="off")),
    }
    now = time.time()
    lines = workload.access_log(64, patterns, now, seed=7, n_ips=8)
    for mode, (base, over) in variants.items():
        cfg = yaml.safe_load(base)
        cfg.update(rules, **small, **over)
        pcfg = config_from_yaml_text(yaml.safe_dump(cfg))
        assert pcfg.not_ported == [], mode
        log = io.StringIO()
        m = build_matcher(pcfg, Banner(DynamicDecisionLists(start_sweeper=False), log,
                                       io.StringIO()), StaticDecisionLists(pcfg), device="cpu")
        if mode == "cpu":
            assert isinstance(m, cpu_ref.CpuMatcher)
        elif mode == "host":
            assert isinstance(m, TorchMatcher) and m.device_windows is None
            assert m.device.type == "cpu"
        else:
            assert m._fw_pipeline is not None and not m._fw_pipeline.single_kernel
        for _ in range(3):  # slot admission lets repeated IPs in
            res = m.consume_lines(lines, now)
            assert len(res) == 64 and not any(r.error for r in res), mode
        if mode == "two":
            assert m._fw_pipeline.fused_batches + m._fw_pipeline.fallback_batches > 0
        m.close()


# ------------------------------------------------------------ no fallback


@pytest.mark.parametrize("mode", ["single", "two", "host"])
def test_open_breaker_refuses_and_no_fault_builds_the_host_matcher(monkeypatch, mode):
    """In every device mode an open breaker refuses the batch, and a
    device fault raises into the breaker: nothing builds or calls
    CpuMatcher."""

    def forbidden(*a, **k):
        raise AssertionError("CpuMatcher reached")

    monkeypatch.setattr(cpu_ref.CpuMatcher, "__init__", forbidden)
    monkeypatch.setattr(cpu_ref.CpuMatcher, "consume_line", forbidden)
    now = time.time()
    lines = _lines(now, n=64, seed=3)
    port, plog, states = _port(_mode_yaml({"single": "dev"}.get(mode, mode)))
    assert (port._fw_pipeline is None) == (mode == "host")
    port_fp.arm("matcher.device", "raise")
    for _ in range(port.breaker.failure_threshold):
        with pytest.raises(Exception) as ei:
            port.consume_lines(lines, now)
        assert not isinstance(ei.value, BreakerOpen)
    port_fp.disarm()
    assert not port.breaker.allow()
    with pytest.raises(BreakerOpen):
        port.consume_lines(lines, now)
    assert port.refused_lines == len(lines)
    assert plog.getvalue() == "" and states.format_states() == ""
    if port.device_windows is not None:
        assert port.device_windows.format_states() == ""
    port.breaker.record_success()
    assert len(port.consume_lines(lines, now)) == len(lines)
    assert plog.getvalue() != ""


def test_reload_keeps_the_app_host_states(tmp_path):
    """The app's host states are made once: a reload's matcher rebuild
    keeps them (the JAX app's)."""
    log_path = tmp_path / "access.log"
    log_path.write_text("")
    app = BanjaxApp(str(_app_yaml(_config(tmp_path, "port", log_path), "host")), device="cpu")
    try:
        states = app.regex_states
        _, m1 = app._current_matcher()
        m1.consume_lines(app_lines(time.time(), 64, 5))
        before = states.format_states()
        assert before != "" and RegexStatesView(app).format_states() == before
        _config(tmp_path, "port", log_path, hits=1)
        _app_yaml(tmp_path / "port.yaml", "host")
        app.reload()
        _, m2 = app._current_matcher()
        assert m2 is not m1 and m2.rate_limit_states is states is app.regex_states
        assert RegexStatesView(app).format_states() == before
    finally:
        app.shutdown()
