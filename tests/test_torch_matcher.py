"""The slice as a whole: TorchMatcher(device="cpu") against the JAX
package's TpuMatcher on the deploy configuration (two-stage prefilter,
device windows, single-program commit; pallas-interpret, Python parse,
dict slots, no traffic sketch) and against the CpuMatcher oracle.

Same seeded log lines through all three; compared exactly: the per-line
result stream, the ban-log bytes, the ban calls, the window states, and
which chunks the fused program committed or sent to the classic
fallback. A second test carries the JAX matcher's window state into the
port (convert.load_window_state) and continues there."""

import io
import random
import time

import numpy as np
import pytest
import torch
import yaml

from banjax_tpu.config.schema import config_from_yaml_text as jax_config
from banjax_tpu.decisions.dynamic_lists import DynamicDecisionLists as JaxDynamicLists
from banjax_tpu.decisions.rate_limit import RegexRateLimitStates
from banjax_tpu.decisions.static_lists import StaticDecisionLists as JaxLists
from banjax_tpu.effectors.banner import Banner as JaxBanner
from banjax_tpu.matcher.cpu_ref import CpuMatcher
from banjax_tpu.matcher.runner import TpuMatcher
from banjax_tpu_torch import convert, workload
from banjax_tpu_torch.cli import build_matcher
from banjax_tpu_torch.config import config_from_yaml_text
from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
from banjax_tpu_torch.effectors.banner import Banner
from tests.differential.test_tpu_matcher import CONFIG_YAML, result_key


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers, and the timing-sensitive tests beside these need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DEPLOY_KEYS = """
matcher: tpu
matcher_device_windows: true
matcher_prefilter: true
pallas_single_kernel: "on"
matcher_native_parse: false
slotmgr_native: false
traffic_sketch_enabled: false
matcher_max_line_len: 128
matcher_prefilter_cand_frac: 0.25
"""


def _yaml(batch_lines=128, capacity=0):
    """The differential suite's CONFIG_YAML plus eight generated rules and
    the deploy keys, as one YAML text both packages read."""
    cfg = yaml.safe_load(CONFIG_YAML)
    extra = yaml.safe_load(workload.rules_config(workload.generate_rules(8, seed=31), seed=3))
    cfg["regexes_with_rates"] += extra["regexes_with_rates"]
    cfg.update(yaml.safe_load(DEPLOY_KEYS))
    cfg.update(matcher_batch_lines=batch_lines, matcher_window_capacity=capacity)
    return yaml.safe_dump(cfg)


class _RecordingBanner(JaxBanner):
    def __init__(self, log):
        super().__init__(JaxDynamicLists(start_sweeper=False), log, io.StringIO(), None)
        self.bans = []

    def ban_or_challenge_ip(self, config, ip, decision, domain):
        self.bans.append((ip, int(decision), domain))
        super().ban_or_challenge_ip(config, ip, decision, domain)


def _jax(cls, yaml_text):
    cfg = jax_config(yaml_text)
    # the JAX side's backend: the port refuses this key's JAX-only values
    cfg.matcher_backend = "pallas-interpret"
    log = io.StringIO()
    banner = _RecordingBanner(log)
    states = RegexRateLimitStates()
    return cls(cfg, banner, JaxLists(cfg), states), banner, log, states


def _port(yaml_text):
    cfg = config_from_yaml_text(yaml_text)
    log = io.StringIO()
    banner = Banner(DynamicDecisionLists(start_sweeper=False), log, io.StringIO())
    return build_matcher(cfg, banner, StaticDecisionLists(cfg), device="cpu"), banner, log


def _lines(now, n=384, seed=5):
    """Offenders crossing their thresholds, allowlisted and skipped hosts,
    per-site rules, stale and unparseable lines, generated-rule attacks."""
    rng = random.Random(seed)
    pats = workload.generate_rules(8, seed=31)
    out = []
    for i in range(n):
        ip = f"10.1.{rng.randrange(3)}.{rng.randrange(8)}"
        ts = now - 9 + 8 * i / n
        kind = rng.random()
        if kind < 0.03:
            rest = "POST example.com POST /submit HTTP/1.1 ua -"
        elif kind < 0.07:
            rest = f"GET example.com GET /page{i % 5} HTTP/1.1 ua -"
        elif kind < 0.10:
            rest = "GET per-site.com GET /blockme HTTP/1.1 ua -"
        elif kind < 0.12:
            rest = "DELETE skipme.com DELETE /x HTTP/1.1 ua -"
        elif kind < 0.14:
            ip, rest = "12.12.12.12", "GET example.com GET /allowed HTTP/1.1 ua -"
        elif kind < 0.18:
            rest = workload.synthesize_match(pats[rng.randrange(len(pats))], rng)
        else:
            rest = f"GET news.net GET /benign/{i % 11} HTTP/1.1 Mozilla/5.0 -"
        out.append(f"{ts:f} {ip} {rest}")
    out[7] = "short garbage"
    out[11] = f"{now - 100:f} 10.9.9.9 GET example.com GET /old HTTP/1.1 ua -"
    # one chunk of nothing but candidates: the prefilter overflows
    burst = [f"{now - 0.5:f} 10.7.0.{i % 9} POST example.com POST /x{i} HTTP/1.1 ua -"
             for i in range(128)]
    return out[:128] + burst + out[128:]


def _assert_same(tag, a_res, b_res, a_banner, b_banner, a_log, b_log, a_view, b_view):
    assert [result_key(r) for r in a_res] == [result_key(r) for r in b_res], tag
    assert a_log.getvalue() == b_log.getvalue(), tag
    assert [(ip, int(d), dom) for ip, d, dom in a_banner.bans] == \
        [(ip, int(d), dom) for ip, d, dom in b_banner.bans], tag
    assert a_view.format_states() == b_view.format_states(), tag


def test_slice_matches_tpu_matcher_and_cpu_oracle():
    now = time.time()
    lines = _lines(now)
    yaml_text = _yaml()
    cpu, cpu_banner, cpu_log, cpu_states = _jax(CpuMatcher, yaml_text)
    tpu, tpu_banner, tpu_log, _ = _jax(TpuMatcher, yaml_text)
    port, port_banner, port_log = _port(yaml_text)
    assert tpu._fw_pipeline is not None and tpu._fw_pipeline.single_kernel
    assert port._fw_pipeline is not None

    cpu_res = [cpu.consume_line(l, now_unix=now) for l in lines]
    tpu_res = list(tpu.consume_lines(lines, now_unix=now))
    port_res = list(port.consume_lines(lines, now_unix=now))
    # a batch with a non-ASCII line takes the classic path (host re row)
    tail = [f"{now - 0.2:f} 10.1.0.1 GET per-site.com GET /blockme/é HTTP/1.1 ua -",
            f"{now - 0.1:f} 10.1.0.1 POST example.com POST /submit HTTP/1.1 ua -"]
    cpu_res += [cpu.consume_line(l, now_unix=now) for l in tail]
    tpu_res += tpu.consume_lines(tail, now_unix=now)
    port_res += port.consume_lines(tail, now_unix=now)

    _assert_same("port vs tpu", tpu_res, port_res, tpu_banner, port_banner,
                 tpu_log, port_log, tpu.device_windows, port.device_windows)
    _assert_same("port vs cpu", cpu_res, port_res, cpu_banner, port_banner,
                 cpu_log, port_log, cpu_states, port.device_windows)
    assert port_log.getvalue().count("\n") > 10
    jfw, tfw = tpu._fw_pipeline, port._fw_pipeline
    assert (tfw.sk_chunks, tfw.sk_fallbacks) == (jfw.sk_chunks, jfw.sk_fallbacks)
    assert tfw.sk_chunks > 0 and tfw.sk_fallbacks > 0
    assert tfw.idle()


def test_window_state_carried_from_jax_continues_identically():
    now = time.time()
    lines = _lines(now, n=256, seed=8)
    yaml_text = _yaml(batch_lines=64, capacity=24)
    tpu, tpu_banner, tpu_log, _ = _jax(TpuMatcher, yaml_text)
    head, rest = lines[:192], lines[192:]
    tpu.consume_lines(head, now_unix=now)
    dw = tpu.device_windows
    assert dw.eviction_count > 0
    port, port_banner, port_log = _port(yaml_text)
    convert.load_window_state(
        port.device_windows,
        {k: np.asarray(getattr(dw._state, k))
         for k in ("hits", "start_s", "start_ns", "valid", "ip_seen")},
        dw._slots, dw._shadow, free=dw._free, last_used=dw._last_used,
        batch_seq=dw._batch_seq,
    )
    assert port.device_windows.format_states() == dw.format_states()
    tpu_banner.bans.clear()
    tpu_log.seek(0)
    tpu_log.truncate()
    tpu_res = tpu.consume_lines(rest, now_unix=now)
    port_res = port.consume_lines(rest, now_unix=now)
    _assert_same("carried", tpu_res, port_res, tpu_banner, port_banner,
                 tpu_log, port_log, tpu.device_windows, port.device_windows)
    for k, v in port.device_windows._state.arrays().items():
        assert np.array_equal(np.asarray(getattr(dw._state, k)), v), k
    assert port.device_windows._slots == dw._slots


def test_auto_sized_window_table_grows_as_jax_does(monkeypatch):
    """matcher_window_capacity 0 (the deploy value): the slot table doubles
    on distinct-IP pressure, in both packages, with the same outcome."""
    from banjax_tpu.matcher import windows as jax_windows
    from banjax_tpu_torch.matcher import windows

    monkeypatch.setattr(jax_windows.DeviceWindows, "AUTO_START_CAPACITY", 8)
    monkeypatch.setattr(windows.DeviceWindows, "AUTO_START_CAPACITY", 8)
    now = time.time()
    lines = _lines(now, n=96, seed=13)
    yaml_text = _yaml(batch_lines=64, capacity=0)
    tpu, tpu_banner, tpu_log, _ = _jax(TpuMatcher, yaml_text)
    port, port_banner, port_log = _port(yaml_text)
    tpu_res = tpu.consume_lines(lines, now_unix=now)
    port_res = port.consume_lines(lines, now_unix=now)
    _assert_same("grown", tpu_res, port_res, tpu_banner, port_banner,
                 tpu_log, port_log, tpu.device_windows, port.device_windows)
    assert port.device_windows.grow_count == tpu.device_windows.grow_count > 0
    assert port.device_windows.capacity == tpu.device_windows.capacity
