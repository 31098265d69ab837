"""The two-program chunk commit (`pallas_single_kernel: off`): program A
(the stateless match and every overflow flag, kernel A) at submit,
program B (the window commit, kernel B) at resolve, against the JAX
package's two-program mode (its XLA scan: `matcher_backend: auto` on the
CPU), tolerance 0.

- Synchronous `consume_lines` on all-ok traffic, candidate overflow,
  event overflow, overflow chunks among ok chunks, and a slot table too
  small for two chunks' pins: results, ban-log bytes, `format_states`,
  the window state arrays and the fused/fallback chunk counts; and the
  JAX `CpuMatcher`'s results.
- Program A's buffer (flags, pairs, always-rule bits) and program B's
  event buffer, byte for byte against JAX's, on an ok chunk and on an
  overflowing one.
- The port's `PipelineScheduler` at `drain_resolve_depth` 1 and 2 over
  overflow bursts among ok chunks (and a tight slot table): the same
  against JAX's synchronous run, and the span names (`program-a`,
  `program-b`, `effector-replay`) against JAX's pipelined run;
  `DrainResolveOverlapMs` is set at depth 2 only.
- The drain-time staleness cut (a fully stale chunk and a mixed one)
  at depth 1 and 2, driven by hand through begin, submit, collect and
  finish, against JAX.
- The metrics (`SingleKernelDepthIgnored` where JAX sets it) and the
  "matcher-single-kernel" health component's text, against JAX.

Small sizes: at most 16 rules, 64-128-line chunks, at most 512 lines a
case.
"""

import io
import random
import time
from collections import Counter

import numpy as np
import pytest
import yaml

from banjax_tpu.config.schema import config_from_yaml_text as jax_config
from banjax_tpu.decisions.rate_limit import RegexRateLimitStates as JaxStates
from banjax_tpu.decisions.static_lists import StaticDecisionLists as JaxLists
from banjax_tpu.matcher.cpu_ref import CpuMatcher as JaxCpuMatcher
from banjax_tpu.matcher.runner import TpuMatcher
from banjax_tpu.obs import trace as jax_trace
from banjax_tpu.pipeline import PipelineScheduler as JaxScheduler
from banjax_tpu.resilience.health import HealthRegistry as JaxHealth
from banjax_tpu_torch import workload
from banjax_tpu_torch.config import config_from_yaml_text
from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
from banjax_tpu_torch.effectors.banner import Banner
from banjax_tpu_torch.matcher.runner import TorchMatcher
from banjax_tpu_torch.obs import trace as port_trace
from banjax_tpu_torch.pipeline import PipelineScheduler
from banjax_tpu_torch.resilience.health import HealthRegistry
from tests.differential.test_tpu_matcher import result_key
from tests.test_torch_matcher import _RecordingBanner, _one_torch_thread  # noqa: F401
from tests.test_torch_obs import obs_reset  # noqa: F401

KEYS = dict(matcher="tpu", matcher_device_windows=True, matcher_prefilter=True,
            pallas_single_kernel="off", matcher_native_parse=False, slotmgr_native=False,
            traffic_sketch_enabled=False, matcher_max_line_len=128)
# the differential suite's per-site and skipped-host rules beside the
# generated ones
EXTRA = """
- decision: iptables_block
  rule: skip-rule
  regex: 'DELETE '
  interval: 5
  hits_per_interval: 0
  hosts_to_skip: {skipme.com: true}
"""
PER_SITE = {"per-site.com": [{"decision": "nginx_block", "hits_per_interval": 0,
                              "interval": 1, "regex": ".*blockme.*",
                              "rule": "instant block"}]}


def _yaml_text(patterns, hits=3, interval=20, **over):
    cfg = {"regexes_with_rates": [
        {"rule": f"r{i}", "regex": p, "interval": interval, "hits_per_interval": hits,
         "decision": "nginx_block"} for i, p in enumerate(patterns)]}
    cfg["regexes_with_rates"] += yaml.safe_load(EXTRA)
    cfg["per_site_regexes_with_rates"] = PER_SITE
    cfg.update(KEYS, **over)
    return yaml.safe_dump(cfg)


def _pair(text, max_events=None, health=False):
    """(port matcher, its ban log), (JAX matcher, its ban log) on one YAML."""
    pcfg = config_from_yaml_text(text)
    plog = io.StringIO()
    port = TorchMatcher(pcfg, Banner(DynamicDecisionLists(start_sweeper=False), plog,
                                     io.StringIO()), StaticDecisionLists(pcfg),
                        device="cpu", health=HealthRegistry() if health else None)
    jcfg = jax_config(text)
    jlog = io.StringIO()
    jax_m = TpuMatcher(jcfg, _RecordingBanner(jlog), JaxLists(jcfg), JaxStates(),
                       health=JaxHealth() if health else None)
    if max_events is not None:
        port.device_windows.max_events = jax_m.device_windows.max_events = max_events
    return (port, plog), (jax_m, jlog)


def _lines(patterns, n, now, attack_rate, n_ips=24, seed=3):
    rests = workload.generate_lines(n, patterns, seed=seed, attack_rate=attack_rate)
    return [f"{now + i * 0.0005:.6f} 10.9.{i % n_ips}.1 {r}" for i, r in enumerate(rests)]


def _mixed_lines(patterns, now):
    """Benign-ish and attack-heavy 64-line stretches on a small IP pool,
    with per-site, skipped-host and unparseable lines."""
    lines = []
    for stretch in range(6):
        rate = 1.0 if stretch % 2 else 0.05
        rests = workload.generate_lines(64, patterns, seed=40 + stretch, attack_rate=rate)
        for r in rests:
            k = len(lines)
            lines.append(f"{now + k * 0.0004:.6f} 10.11.{k % 6}.1 {r}")
    lines[5] = f"{now:f} 10.11.0.1 GET per-site.com GET /blockme HTTP/1.1 ua -"
    lines[70] = f"{now:f} 10.11.1.1 DELETE skipme.com DELETE /x HTTP/1.1 ua -"
    lines[71] = f"{now:f} 10.11.1.1 DELETE other.com DELETE /x HTTP/1.1 ua -"
    lines[9] = "short garbage"
    return lines


def _assert_equal(port, plog, jax_m, jlog, got, want, tag, arrays=True):
    """Results, ban-log bytes, `format_states` and (unless the two runs cut
    their batches differently and evicted: then the slots differ) the
    window state arrays."""
    assert [result_key(r) for r in got] == [result_key(r) for r in want], tag
    assert plog.getvalue() == jlog.getvalue(), tag
    pdw, jdw = port.device_windows, jax_m.device_windows
    assert pdw.format_states() == jdw.format_states(), tag
    if arrays:
        for k, v in pdw._state.arrays().items():
            assert np.array_equal(np.asarray(getattr(jdw._state, k)), v), (tag, k)


CASES = {
    # name: (rules, seed, lines(patterns, now), overrides, max_events)
    "ok_chunks": (30, 35, lambda p, now: _lines(p, 400, now, 0.3, n_ips=8, seed=9),
                  dict(matcher_batch_lines=64, matcher_prefilter_cand_frac=1.0), None),
    "candidate_overflow": (16, 32, lambda p, now: _lines(p, 200, now, 1.0),
                           dict(matcher_batch_lines=64, matcher_prefilter_cand_frac=1 / 64),
                           None),
    "event_overflow": (15, 33, lambda p, now: _lines(p + [r".*"], 256, now, 0.1)[:256],
                       dict(matcher_batch_lines=128, matcher_prefilter_cand_frac=1.0), 64),
    "overflow_among_ok": (16, 37, _mixed_lines,
                          dict(matcher_batch_lines=64, matcher_prefilter_cand_frac=0.25), None),
    "tight_slots": (16, 36, lambda p, now: _lines(p, 300, now, 0.5, n_ips=90, seed=10),
                    dict(matcher_batch_lines=64, matcher_prefilter_cand_frac=1.0,
                         matcher_window_capacity=48, hits=0), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_synchronous_two_program_equals_jax(case):
    n_rules, seed, make, over, max_events = CASES[case]
    patterns = workload.generate_rules(n_rules, seed=seed)
    if case == "event_overflow":
        patterns = patterns + [r".*"]
    now = time.time()
    lines = make(patterns[:n_rules], now)
    over = dict(over)
    text = _yaml_text(patterns, hits=over.pop("hits", 1), interval=30, **over)
    (port, plog), (jax_m, jlog) = _pair(text, max_events)
    assert port._fw_pipeline is not None and not port._fw_pipeline.single_kernel
    assert not jax_m._fw_pipeline.single_kernel
    got = port.consume_lines(lines, now + 1)
    want = jax_m.consume_lines(lines, now + 1)
    _assert_equal(port, plog, jax_m, jlog, got, want, case)
    cfg = jax_config(text)
    cpu = JaxCpuMatcher(cfg, _RecordingBanner(io.StringIO()), JaxLists(cfg), JaxStates())
    assert [result_key(r) for r in got] == \
        [result_key(cpu.consume_line(ln, now + 1)) for ln in lines]
    pf, jf = port._fw_pipeline, jax_m._fw_pipeline
    assert (pf.fused_batches, pf.fallback_batches) == (jf.fused_batches, jf.fallback_batches)
    assert pf.sk_chunks == pf.sk_fallbacks == 0
    if case in ("candidate_overflow", "event_overflow", "overflow_among_ok"):
        assert pf.fallback_batches > 0, case
    if case in ("ok_chunks", "overflow_among_ok"):
        assert pf.fused_batches > 0, case
    if case == "tight_slots":
        assert port.device_windows.eviction_count > 0
    assert pf.idle()
    assert plog.getvalue() != ""


def test_program_buffers_equal_jax_byte_for_byte():
    """Program A's buffer and program B's event buffer of an ok chunk, and
    an overflowing chunk's A buffer (which dispatches no B): the flags
    bytes, the (row, rule) pairs as a set (the two packages list a chunk's
    pairs in different orders), the always-rule bits, the dense bitmap,
    and B's event buffer byte for byte."""
    patterns = workload.generate_rules(16, seed=31)
    now = time.time()
    text = _yaml_text(patterns, matcher_batch_lines=128, matcher_prefilter_cand_frac=0.25)
    (port, _), (jax_m, _) = _pair(text)
    ok = _lines(patterns, 128, now, 0.1, seed=4)
    burst = [f"{now:f} 7.7.7.{i} POST example.com POST /x{i} HTTP/1.1 ua -" for i in range(128)]
    overflow_rules = _yaml_text(patterns + ["POST"], matcher_batch_lines=128,
                                matcher_prefilter_cand_frac=1 / 64)
    (port2, _), (jax2, _) = _pair(overflow_rules)
    for (pm, jm), lines, want_ok in (((port, jax_m), ok, True), ((port2, jax2), burst, False)):
        ps, js = pm.pipeline_begin(lines, now), jm.pipeline_begin(lines, now)
        pe = pm._submit_pipeline_chunk(ps["work"], *ps["pre"][:2])
        je = jm._submit_pipeline_chunk(js["work"], *js["pre"][:2])
        assert np.array_equal(pe["slots"], je["slots"])
        pp, jp = pe["pend"], je["pend"]
        pbuf, jbuf = pp.buf.numpy(), np.asarray(jp.sparse_buf)
        assert pbuf.shape == jbuf.shape and pbuf[:16].tobytes() == jbuf[:16].tobytes()
        assert np.array_equal(pp.bits_dev.numpy(), np.asarray(jp.bits_dev))
        if want_ok:
            pm._fw_pipeline.resolve(pp)
            jm._fw_pipeline.resolve(jp)
            assert sorted(pp.matched_pairs.tolist()) == sorted(jp.matched_pairs.tolist()) != []
            assert (pp.always_bits is None) == (jp.always_bits is None)
            if pp.always_bits is not None:
                assert np.array_equal(pp.always_bits, jp.always_bits)
            tail = pbuf[16 + 4 * pp.P:]
            assert tail.tobytes() == jbuf[16 + 4 * jp.P:].tobytes()
            assert pp.events_buf.numpy().tobytes() == np.asarray(jp.events_buf).tobytes()
            pr, jr = pm._fw_pipeline.collect(pp), jm._fw_pipeline.collect(jp)
            assert [(e.line, e.rule_id, int(e.match_type), e.exceeded, e.seen_ip)
                    for e in pr.events] == \
                [(e.line, e.rule_id, int(e.match_type), e.exceeded, e.seen_ip)
                 for e in jr.events] != []
            assert pm.device_windows.format_states() == jm.device_windows.format_states()
        else:
            from banjax_tpu.matcher.fused_windows import PipelineOverflow as JaxOverflow
            from banjax_tpu_torch.matcher.fused_windows import PipelineOverflow

            with pytest.raises(PipelineOverflow) as pov:
                pm._fw_pipeline.resolve(pp)
            with pytest.raises(JaxOverflow) as jov:
                jm._fw_pipeline.resolve(jp)
            assert pov.value.candidate_overflow == jov.value.candidate_overflow is True
            assert pp.events_buf is None
            pm._fw_pipeline.abandon(pp)
            jm._fw_pipeline.abandon(jp)
            pm._fw_pipeline.fallback_done(pp)


def _stream(patterns, now):
    """Overflow bursts (every line a candidate) among ordinary chunks, on
    IPs shared across every batch boundary."""
    rng = random.Random(3)
    lines = []
    for burst in range(12):
        if burst % 6 == 0:
            lines += [f"{now:f} 7.7.{burst}.{i % 5} POST example.com POST /x{i} HTTP/1.1 ua -"
                      for i in range(40)]
        else:
            rests = workload.generate_lines(40, patterns, seed=100 + burst, attack_rate=0.05)
            lines += [f"{now:f} 1.2.{rng.randrange(4)}.{rng.randrange(6)} {r}" for r in rests]
    return lines


@pytest.mark.parametrize("depth,capacity", [(1, 0), (2, 0), (2, 32)])
def test_pipelined_two_program_equals_jax(depth, capacity):
    patterns = workload.generate_rules(12, seed=38)
    now = time.time()
    lines = _stream(patterns, now)
    text = _yaml_text(patterns + ["POST"], hits=3, interval=30, matcher_batch_lines=64,
                      matcher_prefilter_cand_frac=0.5, drain_resolve_depth=depth,
                      matcher_window_capacity=capacity)
    (port, plog), (jax_m, jlog) = _pair(text)
    want = jax_m.consume_lines(lines, now)
    (_, _), (jax_p, _) = _pair(text)
    for tr in (port_trace, jax_trace):
        tr.configure(enabled=True, ring_size=65536)
    collected = []
    sched = PipelineScheduler(lambda: port, on_results=lambda bl, rs: collected.append((bl, rs)),
                              now_fn=lambda: now, latency_budget_ms=1e9)
    jsched = JaxScheduler(lambda: jax_p, now_fn=lambda: now)
    # the same seeded batch cuts in both schedulers, two to four chunks
    # a batch (so that the depth-2 drain has a later program B to overlap)
    for s in (sched, jsched):
        rng = random.Random(depth)
        s._sizer.target = lambda rng=rng: rng.choice([100, 128, 192, 256])
    for s in (sched, jsched):
        s.submit(lines)
        s.start()
    try:
        assert sched.flush(120) and jsched.flush(120)
    finally:
        sched.stop()
        jsched.stop()
    assert [ln for bl, _ in collected for ln in bl] == lines
    got = [r for _, rs in collected for r in rs]
    _assert_equal(port, plog, jax_m, jlog, got, want, (depth, capacity),
                  arrays=capacity == 0)
    assert port.pipelined_fused_chunks > 0 and port.pipelined_fused_fallbacks > 0
    assert port._fw_pipeline.idle()
    assert sched.stats.peek()["PipelineShedLines"] == 0
    names = ("program-a", "program-b", "effector-replay", "program-ab-fused",
             "fused-overflow-fallback")
    counts = [Counter(s["name"] for s in tr.get_tracer().snapshot() if s["name"] in names)
              for tr in (port_trace, jax_trace)]
    assert counts[0] == counts[1]
    assert counts[0]["program-a"] > 0 and counts[0]["program-b"] > 0
    assert counts[0]["effector-replay"] > 0 and counts[0]["program-ab-fused"] == 0
    snap = port.stats.snapshot(port.device_windows, port)
    assert snap["DrainResolveAheadDepth"] == depth
    assert (snap["DrainResolveOverlapMs"] is not None) == (depth > 1) == \
        (jax_p.drain_resolve_overlap_ms_ewma is not None)
    assert "SingleKernelDepthIgnored" not in snap and "SingleKernelChunks" not in snap


@pytest.mark.parametrize("depth", [1, 2])
def test_drain_stale_cut_equals_jax(depth):
    """Lines fresh at submit age past the 10 s cutoff before their drain:
    a fully stale chunk commits nothing (no program B), a mixed chunk
    commits its fresh rows only; both marked and counted as JAX does."""
    patterns = workload.generate_rules(8, seed=31)
    now = time.time()
    old = [f"{now - 8:f} 9.9.9.{i % 7} GET per-site.com GET /blockme HTTP/1.1 ua -"
           for i in range(64)]
    mixed = [f"{now - (8 if i % 3 == 0 else 0):f} 8.8.8.{i % 5} "
             f"GET per-site.com GET /blockme{i} HTTP/1.1 ua -" for i in range(64)]
    rest = _lines(patterns, 64, now, 0.3, n_ips=5, seed=6)
    batch = old + mixed + rest
    text = _yaml_text(patterns, matcher_batch_lines=64, matcher_prefilter_cand_frac=1.0,
                      drain_resolve_depth=depth)
    (port, plog), (jax_m, jlog) = _pair(text)
    out = []
    for m in (port, jax_m):
        state = m.pipeline_begin(batch, now)
        m.pipeline_submit(state)
        assert len(state["fused"]) == 3
        m.pipeline_collect(state)
        out.append(m.pipeline_finish(state, now + 3))
    (got, p_stale), (want, j_stale) = out
    assert p_stale == j_stale == 64 + 22
    _assert_equal(port, plog, jax_m, jlog, got, want, depth)
    assert all(r.old_line and not r.rule_results for r in got[:64])
    assert "9.9.9.0" not in port.device_windows.format_states()
    assert plog.getvalue().count("instant block") == jlog.getvalue().count("instant block") > 0
    assert port._fw_pipeline.idle()


@pytest.mark.parametrize("mode,depth", [("off", 1), ("off", 2), ("on", 1), ("on", 2)])
def test_depth_metrics_and_health_text_equal_jax(mode, depth):
    patterns = workload.generate_rules(8, seed=31)
    text = _yaml_text(patterns, matcher_batch_lines=64, pallas_single_kernel=mode,
                      drain_resolve_depth=depth)
    (port, _), (jax_m, _) = _pair(text, health=True)
    assert port._fw_pipeline.single_kernel == jax_m._fw_pipeline.single_kernel == (mode == "on")
    assert port.single_kernel_depth_ignored == jax_m.single_kernel_depth_ignored == \
        (mode == "on" and depth > 1)
    keys = ("SingleKernelDepthIgnored", "SingleKernelChunks", "SingleKernelFallbacks",
            "DrainResolveAheadDepth", "DrainResolveOverlapMs", "PipelineFusedBatches",
            "PipelineFallbackBatches")
    ps = port.stats.snapshot(port.device_windows, port)
    js = jax_m.stats.snapshot(jax_m.device_windows, jax_m)
    assert {k: ps[k] for k in keys if k in ps} == {k: js[k] for k in keys if k in js}
    assert ("SingleKernelChunks" in ps) == (mode == "on")
    comp = "matcher-single-kernel"
    got, want = (m._health_registry.snapshot()["components"][comp]
                 for m in (port, jax_m))
    assert (got["status"], got["detail"]) == (want["status"], want["detail"])
