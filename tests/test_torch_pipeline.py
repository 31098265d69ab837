"""The streaming pipeline slice: the port's split protocol, scheduler and
sizer against the JAX package's (`TpuMatcher` with its XLA scan
(`matcher_backend: auto` on the CPU) and the single-program commit, `PipelineScheduler`,
`AdaptiveBatchSizer`), and against the port's own synchronous path.

- The split protocol driven by hand, two batches in flight, through a
  prefilter overflow (the classic fallback at drain), a host-eval batch
  (the classic pend) and the batch after it (gated onto the classic pend
  too): per-batch results, ban-log bytes, bans and `format_states`.
- Staleness: the single-program live mask at submit and the classic
  pend's re-check at drain, each against JAX.
- A churn-sized stream, every line submitted before `start()`, each take
  at a seeded random target, through both schedulers and the port's
  synchronous `consume_lines`: the same batches, ban log and states.
- The sharded encode against the single-thread encode, byte for byte,
  with flagged rows (unparseable, stale, allowlisted, deferred, host-eval)
  at the shard boundaries.
- A slot refusal at a batch's second chunk (the first stays committed,
  the rest takes the classic pend), and device-stage faults after a
  commit (the drain finishes the batch; no hit counts twice), each
  against the port's synchronous path.
- Slot refusal mid-stream (the classic pend), abort freeing turns and
  pins, backpressure shedding the oldest lines with every line
  accounted, the sizer's targets, the probe thread, the command lane.
- `BanjaxApp` with `pipeline_enabled: true` against the JAX app, both
  tailing one log across a rotation and a reload: identical ban logs.

Compared are outputs, not modes: both packages commit in one program a
chunk on the CPU here. Small sizes throughout (8 + 19 rules, 128-line
chunks)."""

import io
import itertools
import random
import threading
import time

import numpy as np
import pytest
import yaml

from banjax_tpu import cli as jax_cli
from banjax_tpu.config.schema import config_from_yaml_text as jax_config
from banjax_tpu.decisions.dynamic_lists import DynamicDecisionLists as JaxDynamicLists
from banjax_tpu.decisions.rate_limit import RegexRateLimitStates
from banjax_tpu.decisions.static_lists import StaticDecisionLists as JaxLists
from banjax_tpu.effectors.banner import Banner as JaxBanner
from banjax_tpu.matcher.runner import TpuMatcher
from banjax_tpu.pipeline import scheduler as jax_sched_mod
from banjax_tpu.pipeline.sizer import AdaptiveBatchSizer as JaxSizer
from banjax_tpu.resilience import failpoints as jax_fp
from banjax_tpu_torch import workload
from banjax_tpu_torch import cli as port_cli
from banjax_tpu_torch.cli import BanjaxApp, RegexStatesView, build_matcher
from banjax_tpu_torch.config import config_from_yaml_text
from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
from banjax_tpu_torch.effectors.banner import Banner
from banjax_tpu_torch.pipeline import scheduler as port_sched_mod
from banjax_tpu_torch.pipeline.sizer import AdaptiveBatchSizer
from banjax_tpu_torch.resilience import failpoints as port_fp
from tests.differential.test_tpu_matcher import CONFIG_YAML, result_key
from tests.test_torch_app import _Counted, _wait_consumed
from tests.test_torch_matcher import _one_torch_thread  # noqa: F401
from tests.test_torch_obs import obs_reset  # noqa: F401


@pytest.fixture(autouse=True)
def _port_ipset_off(monkeypatch):
    """The port's app creates the kernel's ipset outside standalone
    testing; here it runs with its ipset off, as the JAX app does
    (`init_ipset` returns None). tests/test_torch_ipset.py covers the
    kernel edge."""
    monkeypatch.setattr(port_cli, "init_ipset", lambda *a, **k: None)


FIXED_NOW = 1_790_000_000.0


@pytest.fixture(autouse=True)
def _disarmed():
    """Both packages' failpoints are module state: start and end disarmed."""
    jax_fp.disarm()
    port_fp.disarm()
    yield
    jax_fp.disarm()
    port_fp.disarm()

# (no matcher_backend: the JAX "auto" is its XLA scan on the CPU, and the
# port refuses "xla")
PIPELINE_KEYS = """
matcher: tpu
matcher_device_windows: true
matcher_prefilter: true
pallas_single_kernel: "on"
matcher_native_parse: true
slotmgr_native: false
traffic_sketch_enabled: false
matcher_max_line_len: 128
matcher_prefilter_cand_frac: 0.25
matcher_batch_lines: 128
"""


def pipeline_yaml(**over):
    """The differential suite's CONFIG_YAML, eight generated rules and the
    pipeline test keys, as one YAML text both packages read."""
    cfg = yaml.safe_load(CONFIG_YAML)
    extra = yaml.safe_load(workload.rules_config(workload.generate_rules(8, seed=31), seed=3))
    cfg["regexes_with_rates"] += extra["regexes_with_rates"]
    cfg.update(yaml.safe_load(PIPELINE_KEYS))
    cfg.update(over)
    return yaml.safe_dump(cfg)


def pipeline_lines(now, n, seed, span=6.0):
    """Offenders crossing their thresholds, allowlisted and skipped hosts,
    per-site rules, unparseable, stale and deferred lines (a timestamp
    with underscores), and generated-rule attacks, stamped over `span`
    seconds before `now`."""
    rng = random.Random(seed)
    pats = workload.generate_rules(8, seed=31)
    out = []
    for i in range(n):
        ip = f"10.1.{rng.randrange(3)}.{rng.randrange(8)}"
        ts = now - span + span * i / n
        kind = rng.random()
        if kind < 0.05:
            rest = "POST example.com POST /submit HTTP/1.1 ua -"
        elif kind < 0.10:
            rest = f"GET example.com GET /page{i % 5} HTTP/1.1 ua -"
        elif kind < 0.13:
            rest = "GET per-site.com GET /blockme HTTP/1.1 ua -"
        elif kind < 0.15:
            rest = "DELETE skipme.com DELETE /x HTTP/1.1 ua -"
        elif kind < 0.17:
            ip, rest = "12.12.12.12", "GET example.com GET /allowed HTTP/1.1 ua -"
        elif kind < 0.24:
            rest = workload.synthesize_match(pats[rng.randrange(len(pats))], rng)
        else:
            rest = f"GET news.net GET /benign/{i % 11} HTTP/1.1 Mozilla/5.0 -"
        stamp = f"{ts:f}"
        if kind > 0.985:
            whole, frac = stamp.split(".")
            stamp = f"{whole[:4]}_{whole[4:]}.{frac}"  # Python-parsed (deferred)
        out.append(f"{stamp} {ip} {rest}")
    for k in range(5, n, 97):
        out[k] = "short garbage"
    for k in range(11, n, 89):
        out[k] = f"{now - 100:f} 10.9.9.9 GET example.com GET /old HTTP/1.1 ua -"
    return out


def _jax_banner(log):
    banner = JaxBanner(JaxDynamicLists(start_sweeper=False), log, io.StringIO(), None)
    banner.bans = []
    inner = banner.ban_or_challenge_ip

    def record(config, ip, decision, domain):
        banner.bans.append((ip, int(decision), domain))
        inner(config, ip, decision, domain)

    banner.ban_or_challenge_ip = record
    return banner


def _port_banner(log):
    banner = Banner(DynamicDecisionLists(start_sweeper=False), log, io.StringIO())
    banner.bans_seen = []
    inner = banner.ban_or_challenge_ip

    def record(config, ip, decision, domain):
        banner.bans_seen.append((ip, int(decision), domain))
        inner(config, ip, decision, domain)

    banner.ban_or_challenge_ip = record
    return banner


def jax_matcher(yaml_text, health=None):
    cfg = jax_config(yaml_text)
    log = io.StringIO()
    m = TpuMatcher(cfg, _jax_banner(log), JaxLists(cfg), RegexRateLimitStates(), health=health)
    m.test_log = log
    m.test_bans = m.banner.bans
    return m


def port_matcher(yaml_text, health=None):
    cfg = config_from_yaml_text(yaml_text)
    log = io.StringIO()
    m = build_matcher(cfg, _port_banner(log), StaticDecisionLists(cfg), device="cpu",
                      health=health)
    m.test_log = log
    m.test_bans = m.banner.bans_seen
    return m


def run_scheduler(sched_mod, matcher, lines, target=128, encode_workers=0, targets=None,
                  ring_size=4, **kw):
    """Every line submitted before start(), each take at `target` (or at
    the next of `targets`), the clock pinned; returns (stats totals,
    [(batch lines, ok)], the batches' lines)."""
    batches, taken = [], []

    def on_results(batch_lines, results):
        batches.append((len(batch_lines), results is not None))
        taken.append(list(batch_lines))

    sch = sched_mod.PipelineScheduler(
        lambda: matcher, ring_size=ring_size, latency_budget_ms=1e9,
        buffer_lines=kw.pop("buffer_lines", 1 << 20), max_batch=1 << 14,
        encode_workers=encode_workers, on_results=on_results,
        now_fn=lambda: FIXED_NOW, **kw,
    )
    if targets is not None:
        sch._sizer.target = lambda: next(targets)
    else:
        sch._sizer.target = lambda: target
    sch.submit(lines)
    sch.start()
    try:
        assert sch.flush(120)
    finally:
        sch.stop()
    return sch.stats.peek(), batches, taken


def _same(tag, a, b):
    assert a.test_log.getvalue() == b.test_log.getvalue(), tag
    assert a.test_bans == b.test_bans, tag
    assert a.device_windows.format_states() == b.device_windows.format_states(), tag


def _drive(m, batches, now_begin, now_submit, now_drain, depth=2):
    """The split protocol by hand: `depth` batches in flight."""
    states, out = [], []

    def drain_one():
        st = states.pop(0)
        m.pipeline_collect(st)
        res, n_stale = m.pipeline_finish(st, now_drain)
        out.append(([result_key(r) for r in res], n_stale))

    modes = m.test_modes = []
    partial = m.test_partial = []
    for lines in batches:
        st = m.pipeline_begin(lines, now_begin)
        m.pipeline_submit(st, now=now_submit)
        modes.append("fused" if st.get("fused") else
                     "classic" if st.get("pend") is not None else "none")
        # committed chunks and a classic rest in one batch (the port only)
        partial.append(bool(st.get("fused")) and st.get("classic") is not None)
        states.append(st)
        if len(states) >= depth:
            drain_one()
    while states:
        drain_one()
    return out


def _protocol_batches(now):
    lines = pipeline_lines(now, 512, seed=5)
    burst = [f"{now - 0.5:f} 10.7.0.{i % 9} POST example.com POST /x{i} HTTP/1.1 ua -"
             for i in range(128)]
    host_eval = [f"{now - 0.4:f} 10.1.0.1 GET per-site.com GET /blockme/é HTTP/1.1 ua -",
                 f"{now - 0.3:f} 10.1.0.1 POST example.com POST /submit HTTP/1.1 ua -"] * 8
    return [lines[:128], burst, lines[128:300], host_eval, lines[300:400], lines[400:]]


def test_split_protocol_matches_tpu_matcher():
    now = FIXED_NOW
    jax, port = jax_matcher(pipeline_yaml()), port_matcher(pipeline_yaml())
    batches = _protocol_batches(now)
    want = _drive(jax, batches, now, now, now)
    got = _drive(port, batches, now, now, now)
    assert got == want
    assert port.test_modes == jax.test_modes
    # the host-eval batch takes the classic pend, and the batches submitted
    # while a classic pend still owes its drain are gated onto it
    assert port.test_modes == ["fused", "fused", "fused", "classic", "classic", "classic"]
    _same("split protocol", jax, port)
    assert port.test_log.getvalue().count("\n") > 10
    assert port.pipelined_fused_fallbacks == jax.pipelined_fused_fallbacks > 0
    assert port.pipelined_fused_chunks == jax.pipelined_fused_chunks > 0
    assert port._fw_pipeline.idle() and not port.device_windows._pin_counts.any()
    assert port._drain_window_batches == 0


@pytest.mark.parametrize("fused", [True, False])
def test_staleness_at_submit_and_at_drain_matches_jax(fused):
    """Lines age past the 10 s cutoff between the encode and the commit:
    cut at submit (the single-program live mask) or, on the classic pend
    (`pipeline_fused: false`), at drain; counted and marked old_line."""
    now = FIXED_NOW
    text = pipeline_yaml(pipeline_fused=fused)
    jax, port = jax_matcher(text), port_matcher(text)
    batches = [pipeline_lines(now, 256, seed=s, span=8.0)[i:i + 128]
               for s in (6, 7) for i in (0, 128)]
    later = now + 4.0
    want = _drive(jax, batches, now, later if fused else now, later)
    got = _drive(port, batches, now, later if fused else now, later)
    assert got == want
    assert port.test_modes == jax.test_modes
    assert set(port.test_modes) == {"fused" if fused else "classic"}
    assert sum(n for _, n in got) > 0
    _same("stale", jax, port)


def test_churn_stream_matches_sync_path_and_jax_scheduler():
    lines = pipeline_lines(FIXED_NOW, 1500, seed=9)
    runs = {}
    for name, mod, matcher in (("jax", jax_sched_mod, jax_matcher(pipeline_yaml())),
                               ("port", port_sched_mod, port_matcher(pipeline_yaml()))):
        rng = random.Random(77)
        targets = iter(lambda: rng.choice((1, 7, 64, 128, 200, 333)), None)
        stats, batches, taken = run_scheduler(mod, matcher, lines, targets=targets)
        runs[name] = (stats, batches, taken, matcher)
    (jstats, jb, _, jm), (pstats, pb, ptaken, pm) = runs["jax"], runs["port"]
    assert pb == jb and len(pb) > 8
    _same("churn vs jax scheduler", jm, pm)
    sync = port_matcher(pipeline_yaml())
    for batch in ptaken:
        sync.consume_lines(batch, now_unix=FIXED_NOW)
    _same("churn vs sync", sync, pm)
    assert pstats["PipelineProcessedLines"] == pstats["PipelineAdmittedLines"] == len(lines)
    assert pstats["PipelineFallbackBatches"] == 0 and pstats["PipelineDrainErrorLines"] == 0


def _work_view(state):
    w = state["work"]
    rows = [(i, p.ip, p.host, p.timestamp_ns, p.rest) for i, p in w]
    uips, uinv = w.unique_ips()
    return rows, list(uips), np.asarray(uinv).tolist(), w.ts_array().tolist()


def test_sharded_encode_is_byte_identical_to_single_thread():
    now = FIXED_NOW
    lines = pipeline_lines(now, 300, seed=12)
    # flagged rows exactly at the shard boundaries (and the rows beside them)
    bounds = [0, 60, 61, 150, 220, 300]
    specials = [
        "short garbage",
        f"{now - 100:f} 10.9.9.9 GET example.com GET /old HTTP/1.1 ua -",
        f"{now - 1:f} 12.12.12.12 GET example.com GET /allowed HTTP/1.1 ua -",
        f"{str(now - 1)[:4]}_{str(now - 1)[4:]} 10.1.0.2 POST example.com POST /submit HTTP/1.1 ua -",
        f"{now - 1:f} 10.1.0.3 GET per-site.com GET /blockme/é HTTP/1.1 ua -",
    ]
    for k, b in enumerate(bounds[1:-1]):
        lines[b] = specials[k % len(specials)]
        lines[b - 1] = specials[(k + 1) % len(specials)]
    one, sharded = port_matcher(pipeline_yaml()), port_matcher(pipeline_yaml())
    st1 = one.pipeline_begin(lines, now)
    shards = [(bounds[k], sharded.encode_shard(lines[bounds[k]:bounds[k + 1]], now))
              for k in range(len(bounds) - 1)]
    st2 = sharded.pipeline_begin_from_shards(lines, now, shards)
    assert [result_key(r) for r in st2["results"]] == [result_key(r) for r in st1["results"]]
    assert _work_view(st2) == _work_view(st1)
    for a, b in zip(st1["pre"], st2["pre"]):
        assert np.array_equal(a, b)
    # the JAX merge gives the same work set
    jm = jax_matcher(pipeline_yaml())
    jshards = [(bounds[k], jm.encode_shard(lines[bounds[k]:bounds[k + 1]], now))
               for k in range(len(bounds) - 1)]
    jst = jm.pipeline_begin_from_shards(lines, now, jshards)
    assert _work_view(jst) == _work_view(st2)
    for m, st in ((one, st1), (sharded, st2)):
        m.pipeline_submit(st, now=now)
        m.pipeline_collect(st)
        m.pipeline_finish(st, now)
    _same("sharded", one, sharded)
    assert one.test_log.getvalue()


def test_sharded_scheduler_encode_matches_single_thread(monkeypatch):
    monkeypatch.setattr(port_sched_mod, "_MIN_SHARD_LINES", 40)
    lines = pipeline_lines(FIXED_NOW, 1024, seed=14)
    one, pool = port_matcher(pipeline_yaml()), port_matcher(pipeline_yaml())
    s1, b1, _ = run_scheduler(port_sched_mod, one, lines, target=256)
    s2, b2, _ = run_scheduler(port_sched_mod, pool, lines, target=256, encode_workers=3)
    assert b1 == b2
    assert s2["EncodeShardedBatches"] == len(b2) and s1["EncodeShardedBatches"] == 0
    _same("pool", one, pool)


def _pend_then_refused_batches(now):
    """Batch 1: six IPs with two rule1 hits and a benign line each (three
    rows: admitted at slot_admission_min_estimate 3). Batch 2: one rule1
    hit from each of those IPs (one row: the estimate decides) and
    twenty benign one-off IPs. With pipeline_fused false batch 1 takes
    the classic pend: its windows apply at its drain."""
    t = now - 4
    b1, b2 = [], []
    for k in range(6):
        ip = f"10.9.0.{k}"
        b1 += [f"{t + k * 0.01:f} {ip} GET example.com GET /a HTTP/1.1 ua -",
               f"{t + k * 0.01 + 0.001:f} {ip} GET example.com GET /b HTTP/1.1 ua -",
               f"{t + k * 0.01 + 0.002:f} {ip} GET news.net GET /n HTTP/1.1 ua -"]
        b2.append(f"{t + 1 + k * 0.01:f} {ip} GET example.com GET /c HTTP/1.1 ua -")
    b2 += [f"{t + 1.5:f} 10.8.0.{i} GET news.net GET /z HTTP/1.1 ua -" for i in range(20)]
    return [b1, b2]


PEND_THEN_REFUSED = dict(pipeline_fused=False, traffic_sketch_enabled=True,
                         slot_admission_enabled=True, slot_admission_min_estimate=3)


def test_admission_ahead_of_a_classic_pend_matches_the_jax_scheduler():
    """A later batch's admission runs while an earlier batch's classic pend
    still owes its windows: the port keeps the JAX runner's outcome
    (results, ban log, bans, states), two batches in flight."""
    now = FIXED_NOW
    text = pipeline_yaml(**PEND_THEN_REFUSED)
    batches = _pend_then_refused_batches(now)
    jax, port = jax_matcher(text), port_matcher(text)
    want = _drive(jax, batches, now, now, now)
    got = _drive(port, batches, now, now, now)
    assert port.test_modes == jax.test_modes == ["classic", "none"]
    assert got == want
    _same("admission ahead of a classic pend", jax, port)


@pytest.mark.xfail(strict=True, reason=(
    "shared with the JAX scheduler (ROADMAP Queue 3, reference side): batch 2's "
    "refused rows step their windows on the host at submit, before batch 1's "
    "classic pend applies the same IPs' earlier hits at its drain, so the "
    "hits count out of order and each IP bans on batch 1's line, not batch 2's"))
def test_admission_ahead_of_a_classic_pend_matches_the_sync_path():
    """The same batches through the pipeline (two in flight) and through
    the synchronous consume_lines: the serial path bans each IP on its
    third hit (/c, batch 2) with its window started at batch 1."""
    now = FIXED_NOW
    text = pipeline_yaml(**PEND_THEN_REFUSED)
    batches = _pend_then_refused_batches(now)
    port = port_matcher(text)
    got = _drive(port, batches, now, now, now)
    sync, want = _sync(text, batches, now)
    assert sync.test_log.getvalue().count("\n") == 6
    _same("admission ahead of a classic pend vs sync", sync, port)
    assert got == want


def test_slot_refusal_mid_stream_takes_the_classic_pend():
    """24 slots, batches of many distinct IPs, two in flight: allocations
    refuse while the earlier batch holds its pins, and those batches take
    the classic pend (windows at their drain); the later batches are gated
    onto it until it drained. Same outcome as JAX; no pin or turn leaks."""
    now = FIXED_NOW
    text = pipeline_yaml(matcher_window_capacity=24)
    rng = random.Random(3)
    batches = []
    for b in range(6):
        batch = []
        for i in range(40):
            ip = f"10.2.{b % 2}.{rng.randrange(18)}"
            batch.append(f"{now - 5 + b * 0.5 + i / 100:f} {ip} POST example.com POST /submit "
                         "HTTP/1.1 ua -")
        batches.append(batch)
    jax, port = jax_matcher(text), port_matcher(text)
    want = _drive(jax, batches, now, now, now)
    got = _drive(port, batches, now, now, now)
    assert got == want
    assert port.test_modes == jax.test_modes
    assert "classic" in port.test_modes and "fused" in port.test_modes
    _same("slot refusal", jax, port)
    assert port.test_log.getvalue()
    assert not port.device_windows._pin_counts.any() and port._fw_pipeline.idle()
    assert port._drain_window_batches == 0


def _chunked_batches(now, n_batches=3, chunks=3, ips_per_chunk=16, one_offs=0, seed=8):
    """Batches of `chunks` full 128-line chunks, each chunk with its own
    `ips_per_chunk` distinct IPs (a batch's first chunk reuses the IPs of
    the previous batch's last). Each IP of a chunk sends one rule1 line
    (three in 5 s exceed it): an IP in two batches stays one hit short,
    so any hit counted twice bans it. Two IPs a chunk send two POSTs (a
    ban each). `one_offs` lines a batch come from IPs seen once, with one
    POST each (slot admission refuses them; a second count bans them)."""
    rng = random.Random(seed)
    batches, prev, fresh, t = [], None, 0, 0
    for _ in range(n_batches):
        batch = []
        for c in range(chunks):
            if c == 0 and prev is not None:
                ips = prev
            else:
                ips = [f"10.3.{(fresh + k) // 200}.{(fresh + k) % 200}"
                       for k in range(ips_per_chunk)]
                fresh += ips_per_chunk
            for i in range(128):
                t += 1
                k, r = i % ips_per_chunk, i // ips_per_chunk
                if r == 0:
                    rest = f"GET example.com GET /page{k} HTTP/1.1 ua -"
                elif r in (1, 2) and k < 2:
                    rest = "POST example.com POST /submit HTTP/1.1 ua -"
                else:
                    rest = f"GET news.net GET /benign/{i % 7} HTTP/1.1 ua -"
                batch.append(f"{now - 6 + t / 1000:f} {ips[k]} {rest}")
            prev = ips
        for _ in range(one_offs):
            t += 1
            pos = rng.randrange(len(batch))
            batch.insert(pos, f"{now - 6 + t / 1000:f} 10.4.{t // 200}.{t % 200} POST "
                              "example.com POST /submit HTTP/1.1 ua -")
        batches.append(batch)
    return batches


def _sync(text, batches, now):
    """The port's synchronous consume_lines on the same batches."""
    m = port_matcher(text)
    out = [([result_key(r) for r in m.consume_lines(b, now_unix=now)], 0) for b in batches]
    return m, out


@pytest.mark.parametrize("depth", [1, 2])
def test_partial_commit_with_a_classic_rest_matches_the_sync_path(depth):
    """24 slots and batches of three 128-line chunks of 16 distinct IPs
    each: a batch's second chunk finds its slots pinned by the first, so
    the first stays committed and the rest of the batch takes the classic
    pend (the JAX runner would abandon the whole batch). Results, ban log,
    bans and `format_states` equal the synchronous path's."""
    now = FIXED_NOW
    text = pipeline_yaml(matcher_window_capacity=24)
    batches = _chunked_batches(now)
    port = port_matcher(text)
    got = _drive(port, batches, now, now, now, depth=depth)
    assert any(port.test_partial)
    sync, want = _sync(text, batches, now)
    assert got == want
    _same(f"partial commit, depth {depth}", sync, port)
    assert port.test_log.getvalue().count("\n") > 10
    assert not port.device_windows._pin_counts.any() and port._fw_pipeline.idle()
    assert port._drain_window_batches == 0


def _state_blocks(m):
    return sorted(m.device_windows.format_states().split("\n\n"))


def _arm_at_first_call(m, method):
    """Arm `matcher.device` once, as the matcher's `method` is first
    entered, so that the failpoint fires at its next site: after what
    the batch committed before that call."""
    inner = getattr(m, method)

    def armed(*args, **kw):
        if not port_fp.fired_count("matcher.device") and not port_fp.snapshot():
            port_fp.arm("matcher.device", count=1)
        return inner(*args, **kw)

    setattr(m, method, armed)


ADMISSION = dict(traffic_sketch_enabled=True, traffic_sketch_width=512,
                 traffic_sketch_hll_p=8, slot_admission_enabled=True,
                 slot_admission_min_estimate=4)

FAULT_CASES = {
    # the older batch's chunks are committed when its collect fails
    "pipeline.collect": ({}, None),
    # the first chunk committed, the second refused a slot: the classic
    # match dispatch for the rest fails
    "matcher.device_after_chunks": (dict(matcher_window_capacity=24), "_match_bits_submit"),
    # the slot-refused rows stepped on the host; the first chunk fails
    "matcher.device_after_refused_rows": (ADMISSION, "_submit_fused_pipeline"),
    # the refused rows folded into the sketch; their match fails
    "matcher.device_in_refused_rows": (ADMISSION, "_partition_admission"),
}


@pytest.mark.parametrize("case", list(FAULT_CASES))
def test_device_failure_after_a_commit_counts_each_hit_once(case):
    """A device stage that fails once the batch has committed something
    (its chunks, its slot-refused rows' sketch fold or host steps) must
    not rerun the batch whole: its drain replays what was committed and
    runs the rest. The scheduler's ban log, bans and per-IP states equal
    the synchronous path's on the same batches, and no line is lost."""
    now = FIXED_NOW
    over, method = FAULT_CASES[case]
    text = pipeline_yaml(**over)
    batches = _chunked_batches(now, one_offs=12 if over is ADMISSION else 0)
    m = port_matcher(text)
    recovered = []
    inner = m.pipeline_recover
    m.pipeline_recover = lambda st: recovered.append(inner(st)) or recovered[-1]
    if method is None:
        port_fp.arm("pipeline.collect", count=2)
    else:
        _arm_at_first_call(m, method)
    stats, taken_ok, taken = run_scheduler(port_sched_mod, m, [x for b in batches for x in b],
                                           targets=itertools.chain(
                                               (len(b) for b in batches), itertools.repeat(128)))
    assert taken == batches and all(ok for _, ok in taken_ok)
    assert recovered and all(recovered)
    assert port_fp.fired_count(case.split("_")[0]) == len(recovered)
    assert stats["PipelineFallbackBatches"] == len(recovered)
    assert stats["PipelineDrainErrorLines"] == 0
    assert stats["PipelineProcessedLines"] == stats["PipelineAdmittedLines"] == sum(
        map(len, batches))
    sync, _ = _sync(text, batches, now)
    assert m.test_log.getvalue() == sync.test_log.getvalue(), case
    assert m.test_bans == sync.test_bans, case
    # the same state per IP; the listing's order is the order in which
    # IPs reached the host shadow, which two batches in flight change
    # (refused rows step at the next submit, before this batch's drain)
    assert _state_blocks(m) == _state_blocks(sync), case
    assert m.test_log.getvalue().count("\n") > 10
    assert not m.device_windows._pin_counts.any() and m._fw_pipeline.idle()
    assert m._drain_window_batches == 0
    if over is ADMISSION:
        assert m.device_windows.slot_refusals > 0


def test_abort_frees_turns_and_pins():
    now = FIXED_NOW
    m = port_matcher(pipeline_yaml())
    lines = pipeline_lines(now, 384, seed=16)
    a = m.pipeline_begin(lines[:128], now)
    b = m.pipeline_begin(lines[128:256], now)
    c = m.pipeline_begin(lines[256:], now)
    for st in (a, b, c):
        m.pipeline_submit(st, now=now)
    assert m.device_windows._pin_counts.any()
    m.pipeline_abort(a)
    m.pipeline_abort(a)  # idempotent
    m.pipeline_collect(b)
    m.pipeline_finish(b, now)  # would wait forever on a's turns
    m.pipeline_abort(c)
    assert not m.device_windows._pin_counts.any() and m._fw_pipeline.idle()
    # and a classic-pend batch's drain-window slot is released once
    d = m.pipeline_begin(lines[:16] + [f"{now:f} 10.1.0.1 GET x.com GET /é HTTP/1.1 ua -"], now)
    m.pipeline_submit(d, now=now)
    assert m._drain_window_batches == 1
    m.pipeline_abort(d)
    m.pipeline_abort(d)
    assert m._drain_window_batches == 0
    later = m.pipeline_begin(lines[:128], now)
    m.pipeline_submit(later, now=now)
    assert later["fused"]  # commit at submit again


class _SlowMatcher:
    """A matcher without the split protocol: every batch drains through
    consume_lines, which records the batch and waits for the gate."""

    def __init__(self):
        self.batches = []
        self.gate = threading.Event()

    def consume_lines(self, lines, now_unix=None):
        self.gate.wait(30)
        self.batches.append(list(lines))
        return [None] * len(lines)


@pytest.mark.parametrize("mod", [jax_sched_mod, port_sched_mod], ids=["jax", "port"])
def test_backpressure_sheds_oldest_and_accounts_every_line(mod):
    m = _SlowMatcher()
    sch = mod.PipelineScheduler(lambda: m, ring_size=1, buffer_lines=100, max_block_ms=5,
                                latency_budget_ms=1e9, now_fn=lambda: FIXED_NOW)
    sch._sizer.target = lambda: 30
    sch.start()
    try:
        sch.submit([f"a{i}" for i in range(30)])
        deadline = time.monotonic() + 10
        while sch.snapshot()["PipelineInflightBatches"] < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        sch.submit([f"b{i}" for i in range(80)])
        sch.submit([f"c{i}" for i in range(60)])
        sch.submit([f"d{i}" for i in range(150)])
        m.gate.set()
        assert sch.flush(30)
    finally:
        sch.stop()
    s = sch.stats.peek()
    seen = [x for b in m.batches for x in b]
    assert m.batches[0] == [f"a{i}" for i in range(30)]
    assert seen[30:] == [f"d{i}" for i in range(50, 150)]
    assert s["PipelineShedLines"] == 80 + 60 + 50
    assert s["PipelineAdmittedLines"] == 320 == s["PipelineProcessedLines"] + s["PipelineShedLines"]


def test_backpressure_port_matches_jax():
    out = []
    for mod in (jax_sched_mod, port_sched_mod):
        m = _SlowMatcher()
        sch = mod.PipelineScheduler(lambda: m, ring_size=1, buffer_lines=64, max_block_ms=1,
                                    latency_budget_ms=1e9, now_fn=lambda: FIXED_NOW)
        for k in range(5):
            sch.submit([f"{k}-{i}" for i in range(25 + 10 * k)])
        sch._sizer.target = lambda: 16
        m.gate.set()
        sch.start()
        try:
            assert sch.flush(30)
        finally:
            sch.stop()
        out.append((sch.stats.peek(), m.batches))
    (js, jb), (ps, pb) = out
    assert pb == jb
    for k in ("PipelineAdmittedLines", "PipelineProcessedLines", "PipelineShedLines",
              "PipelineBatches", "PipelineFallbackBatches"):
        assert ps[k] == js[k], k


def test_sizer_targets_match_jax():
    rng = random.Random(5)
    kw = dict(min_batch=64, max_batch=8192, start_batch=512, settle=2)
    port, jax = AdaptiveBatchSizer(120.0, **kw), JaxSizer(120.0, **kw)
    targets = []
    for i in range(400):
        t = port.target()
        assert t == jax.target()
        n = t if rng.random() > 0.1 else max(1, t // 5)
        per_line = 0.02 + (0.03 if t > 2048 else 0.0) + rng.random() * 0.01
        stage = {"encode": n * per_line * 0.3, "device": 4.0 + n * per_line * 0.5,
                 "drain": n * per_line * 0.2 + (300.0 if i % 97 == 0 else 0.0)}
        port.observe(n, stage)
        jax.observe(n, stage)
        assert port.snapshot() == jax.snapshot()
        targets.append(t)
    assert len(set(targets)) > 3
    assert port.command_target() == jax.command_target()
    for bad in (dict(budget_ms=0), dict(budget_ms=1, min_batch=10, max_batch=5),
                dict(budget_ms=1, command_max=0)):
        with pytest.raises(ValueError):
            AdaptiveBatchSizer(**bad)


def test_probe_thread_runs_when_idle_and_counts():
    m = port_matcher(pipeline_yaml())
    calls = []
    inner = m.probe

    def probe():
        calls.append(threading.current_thread().name)
        return inner()

    m.probe = probe
    sch = port_sched_mod.PipelineScheduler(lambda: m, probe_seconds=0.05,
                                           now_fn=lambda: FIXED_NOW)
    sch.start()
    try:
        deadline = time.monotonic() + 20
        while sch.stats.probe_ok < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        sch.stop()
    assert sch.stats.probe_ok >= 2 and sch.stats.probe_failed == 0
    assert set(calls) == {"pipeline-probe"}
    assert sch.wait_idle(1)


def test_command_lane_keeps_admission_order():
    m = port_matcher(pipeline_yaml())
    order = []

    def handler(raw):
        order.append(raw)

    sch = port_sched_mod.PipelineScheduler(lambda: m, now_fn=lambda: FIXED_NOW,
                                           command_take_max=3,
                                           on_results=lambda ls, r: order.append(len(ls)))
    sch._sizer.target = lambda: 64
    lines = pipeline_lines(FIXED_NOW, 100, seed=2)
    sch.submit(lines[:50])
    sch.submit_commands([b"c1", b"c2", b"c3", b"c4"], handler)
    sch.submit(lines[50:])
    sch.start()
    try:
        assert sch.flush(60)
    finally:
        sch.stop()
    assert order == [50, b"c1", b"c2", b"c3", b"c4", 50]
    s = sch.stats.peek()
    assert s["PipelineCommandItems"] == 4 and s["PipelineCommandBatches"] == 2
    assert s["PipelineAdmittedLines"] == 104 == s["PipelineProcessedLines"]


# ------------------------------------------------------------ the service


APP_KEYS = """
pipeline_enabled: true
pipeline_max_block_ms: 50.0
encode_workers: 2
iptables_ban_seconds: 10
kafka_brokers: ["localhost:9092"]
disable_kafka: true
challenge_device_verify: false
"""


def _app_config(tmp_path, name, log_path, hits=2):
    cfg = yaml.safe_load(pipeline_yaml())
    cfg.update(yaml.safe_load(APP_KEYS))
    cfg["regexes_with_rates"][0]["hits_per_interval"] = hits
    cfg.update(server_log_file=str(log_path),
               banning_log_file=str(tmp_path / f"{name}-bans.log"),
               metrics_log_file=str(tmp_path / f"{name}-metrics.log"))
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


class _Drained:
    """Counts the lines a pipeline drained (its on_results hook)."""

    def __init__(self, pipeline):
        self.n = 0
        self.lock = threading.Lock()
        pipeline.on_results = self
        pipeline._on_results = self

    def __call__(self, lines, results):
        with self.lock:
            self.n += len(lines)


def test_app_with_pipeline_writes_the_jax_apps_ban_log(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_cli, "init_ipset", lambda *a, **k: None)
    log_path = tmp_path / "access.log"
    log_path.write_text("")
    jax_app = jax_cli.BanjaxApp(str(_app_config(tmp_path, "jax", log_path)))
    port_app = BanjaxApp(str(_app_config(tmp_path, "port", log_path)), device="cpu")
    assert jax_app.pipeline is not None and port_app.pipeline is not None
    counts = (_Drained(jax_app.pipeline), _Drained(port_app.pipeline))
    tailed = (_Counted(jax_app), _Counted(port_app))
    try:
        jax_app.pipeline.start()
        jax_app.tailer.start()
        port_app.start_workers()
        assert jax_app.tailer.opened.wait(10) and port_app.tailer.opened.wait(10)
        total = 0
        for step in range(6):
            # stamped a minute ahead: under load, one app may drain a
            # write seconds after the other, and the 10 s staleness cut
            # must not fall between them (the `/old` lines stay stale)
            batch = pipeline_lines(time.time() + 60, 160, seed=40 + step, span=3.0)
            with open(log_path, "a") as f:
                f.write("\n".join(batch) + "\n")
            total += len(batch)
            _wait_consumed(tailed, total, timeout=120)
            _wait_consumed(counts, total, timeout=120)
            if step == 2:
                log_path.rename(tmp_path / "access.log.1")
                log_path.write_text("")
            if step == 3:
                for app, name in ((jax_app, "jax"), (port_app, "port")):
                    cfg = yaml.safe_load((tmp_path / f"{name}.yaml").read_text())
                    cfg["regexes_with_rates"][0]["hits_per_interval"] = 1
                    (tmp_path / f"{name}.yaml").write_text(yaml.safe_dump(cfg))
                    app.reload()
        jax_bans = (tmp_path / "jax-bans.log").read_text()
        port_bans = (tmp_path / "port-bans.log").read_text()
        assert port_bans == jax_bans and port_bans.count("\n") > 5
        assert RegexStatesView(port_app).format_states() == \
            jax_cli.RegexStatesView(jax_app).format_states()
        assert port_app._matcher_generation == 1
        s = port_app.pipeline.stats.peek()
        assert s["PipelineProcessedLines"] == s["PipelineAdmittedLines"] == total
        assert port_app.pipeline.stats.e2e_percentiles()["n"] > 0
        assert port_app.tailer.errors == 0
        comps = port_app.health.snapshot()["components"]
        assert {"tailer", "pipeline", "matcher"} <= set(comps)
    finally:
        port_app.shutdown()
        jax_app.shutdown()
    assert port_app._matcher is None


def test_launch_counts_and_stage_clock_hold_under_thread_contention():
    """The pipeline's threads count kernel launches and stage seconds
    concurrently: no update may be lost (16 threads, a short switch
    interval)."""
    import sys

    from banjax_tpu_torch.matcher.kernels._build import CudaLibrary
    from banjax_tpu_torch.obs.stages import StageClock

    lib = CudaLibrary("stress", "none.cu", {})
    clock = StageClock()
    n_threads, n_iter = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_iter):
                lib.count_launch()
                with clock("outer"):
                    with clock("inner"):
                        pass

        threads = [threading.Thread(target=work, name=f"t{k}") for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert lib.launches == n_threads * n_iter
    assert lib.launches_by_thread == {f"t{k}": n_iter for k in range(n_threads)}
    assert set(clock.by_thread) == {f"t{k}" for k in range(n_threads)}
    assert set(clock.seconds) == {"outer", "inner"}
    total = sum(sum(d.values()) for d in clock.by_thread.values())
    assert abs(total - sum(clock.seconds.values())) < 1e-9 * max(1.0, total) + 1e-12


def test_a_matcher_that_cannot_be_built_fails_health_and_keeps_the_lines(monkeypatch):
    from banjax_tpu_torch.resilience.health import HealthRegistry

    monkeypatch.setattr(port_sched_mod, "_NO_MATCHER_RETRY_S", 0.01)
    m = port_matcher(pipeline_yaml())
    calls = []

    def getter():
        calls.append(1)
        if len(calls) <= 2:
            raise RuntimeError("CUDA error: out of memory")
        return m

    health = HealthRegistry()
    comp = health.register("pipeline")
    statuses = []
    inner = comp.failed
    comp.failed = lambda detail="": (statuses.append(detail), inner(detail))
    sch = port_sched_mod.PipelineScheduler(getter, health=comp, now_fn=lambda: FIXED_NOW)
    lines = pipeline_lines(FIXED_NOW, 100, seed=4)
    sch.submit(lines)
    sch.start()
    try:
        assert sch.flush(60)
    finally:
        sch.stop()
    assert len(statuses) == 2 and "out of memory" in statuses[0]
    s = sch.stats.peek()
    assert s["PipelineProcessedLines"] == s["PipelineAdmittedLines"] == 100
