"""The device mesh (`banjax_tpu_torch/parallel/mesh.py`) and the mesh-mode
TorchMatcher on the CPU, against the JAX mesh (`banjax_tpu/parallel/
mesh.py`) on the eight virtual CPU devices of tests/conftest.py, against
the JAX CpuMatcher and against Python `re`.

Every port member sits on the CPU and runs the plain versions; the JAX
side runs the XLA-scan body or the Pallas kernel in interpret mode. Bits
are compared exactly (tolerance 0), with the fused and fallback batch
counts; the matchers' result keys and Banner effects exactly. The cases
copy `tests/unit/test_parallel_mesh.py`. Kernel A on the card under a
mesh is held to its plain version by chip_smoke.py's `mesh` phase."""

import logging
import re
import time

import jax
import numpy as np
import pytest
import torch
import yaml

import banjax_tpu.parallel.mesh as jax_mesh
import bench as jax_bench
from banjax_tpu.matcher.cpu_ref import CpuMatcher
from banjax_tpu.matcher.encode import encode_for_match
from banjax_tpu.matcher.prefilter import build_plan as jax_build_plan
from banjax_tpu.matcher.rulec import compile_rules as jax_compile_rules
from banjax_tpu.matcher.runner import TpuMatcher
from banjax_tpu_torch import workload
from banjax_tpu_torch.config import config_from_yaml_text
from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
from banjax_tpu_torch.matcher import encode as port_encode
from banjax_tpu_torch.matcher.kernels import nfa_match
from banjax_tpu_torch.matcher.prefilter import build_plan
from banjax_tpu_torch.matcher.rulec import compile_rules, lower_rules, pack_programs
from banjax_tpu_torch.matcher.runner import TorchMatcher
from banjax_tpu_torch.obs import exposition
from banjax_tpu_torch.parallel import mesh
from banjax_tpu_torch.pipeline import scheduler
from banjax_tpu_torch.resilience.health import HealthRegistry
from banjax_tpu_torch.scenarios.runtime import RecordingBanner
from tests import mesh_oracle
from tests.test_torch_matcher import _one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def jax_mesh_shim(monkeypatch):
    """Run the JAX mesh on this JAX. Its version shim
    (`banjax_tpu/parallel/mesh.py:43-51`) passes `mesh` positionally, and
    `jax.shard_map` here takes it by keyword only (`f, /, *, out_specs,
    in_specs, mesh, ...`), so every JAX mesh step fails to build; this
    stand-in passes it by keyword, for the test only. No file of the JAX
    package changes."""

    def shim(f, mesh, in_specs, out_specs, check_vma=False):
        return jax_mesh._shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                                   check_vma=check_vma)

    monkeypatch.setattr(jax_mesh, "shard_map", shim)
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")


PATTERNS = [
    r"GET /wp-login\.php",
    r"POST /xmlrpc\.php",
    r"(GET|POST) /[a-z-]*\.php",
    r"^GET .* HTTP/1\.1$",
    r"Mozilla/\d+\.\d+",
    r"a+b",
    r"[0-9]{2,4}",
    r".*",
    r"^$",
    r"wp-admin",
]

LINES = [
    "GET example.com GET /wp-login.php HTTP/1.1",
    "POST example.com POST /xmlrpc.php HTTP/1.1",
    "GET example.com GET / HTTP/1.1",
    "aaab and 123",
    "Mozilla/5.0 something",
    "",
    "nothing interesting here",
    "GET site.org GET /wp-admin/panel HTTP/1.1",
] * 4  # 32 lines


def _cpu_mesh(n, rp):
    return mesh.make_mesh(["cpu"] * n, rp=rp)


def _assert_re(got, patterns, lines):
    for j, pat in enumerate(patterns):
        rx = re.compile(pat)
        for i, line in enumerate(lines):
            assert bool(got[i, j]) == (rx.search(line) is not None), (pat, line)


# ------------------------------------------------------------ the backend


@pytest.mark.parametrize("dp,rp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_match_equals_jax_mesh(dp, rp):
    compiled = compile_rules(PATTERNS, n_shards=rp)
    cls_ids, lens, host_eval = port_encode.encode_for_match(compiled, LINES, 128)
    assert not host_eval.any()
    port = mesh.ShardedMatchBackend(compiled, _cpu_mesh(dp * rp, rp), 128)
    got = port.match_bits(cls_ids, lens)

    jc = jax_compile_rules(PATTERNS, n_shards=rp)
    jcls, jlens, _ = encode_for_match(jc, LINES, 128)
    want = jax_mesh.ShardedMatchBackend(jc, jax_mesh.make_mesh(dp * rp, rp=rp), 128,
                                        backend="xla", block_b=8).match_bits(jcls, jlens)
    np.testing.assert_array_equal(got, want)
    _assert_re(got, PATTERNS, LINES)
    assert port.fused_batches == port.fallback_batches == 0
    assert len(port.last_shard_merge_ms) == dp


def _fused_inputs(rp, n_rules=40, seed=5, attack_rate=0.3, extra=(r".*", r"^$"), n=64):
    patterns = jax_bench.generate_rules(n_rules, seed=seed) + list(extra)
    lines = jax_bench.generate_lines(n, patterns, seed=seed + 1, attack_rate=attack_rate)
    lines += [""] if extra else []
    compiled = compile_rules(patterns, n_shards=rp)
    plan = build_plan(patterns, byte_classes=(compiled.byte_to_class, compiled.n_classes),
                      stage2_shards=rp)
    jc = jax_compile_rules(patterns, n_shards=rp)
    jplan = jax_build_plan(patterns, byte_classes=(jc.byte_to_class, jc.n_classes),
                           stage2_shards=rp)
    return patterns, lines, compiled, plan, jc, jplan


@pytest.mark.parametrize("backend,dp,rp", [
    ("xla", 4, 2), ("xla", 2, 4), ("pallas-interpret", 4, 2),
])
def test_fused_mesh_equals_jax_fused_mesh(backend, dp, rp):
    patterns, lines, compiled, plan, jc, jplan = _fused_inputs(rp)
    assert plan is not None and plan.n_always >= 2
    cls_ids, lens, host_eval = encode_for_match(jc, lines, 128)
    assert not host_eval.any()
    port = mesh.ShardedMatchBackend(compiled, _cpu_mesh(dp * rp, rp), 128, plan=plan)
    port.cand_frac = 1.0
    got = port.match_bits(cls_ids, lens)
    jf = jax_mesh.ShardedMatchBackend(jc, jax_mesh.make_mesh(dp * rp, rp=rp), 128,
                                      backend=backend, block_b=8, plan=jplan, cand_frac=1.0)
    np.testing.assert_array_equal(got, jf.match_bits(cls_ids, lens))
    assert (port.fused_batches, port.fallback_batches) == (jf.fused_batches, jf.fallback_batches)
    assert port.fused_batches == 1
    # and the single-stage sharded match, the unsupported rules' columns aside
    want = mesh.ShardedMatchBackend(compiled, _cpu_mesh(dp * rp, rp), 128).match_bits(
        cls_ids, lens)
    want[:, list(plan.unsupported)] = 0
    np.testing.assert_array_equal(got, want)


def test_fused_mesh_overflow_falls_back_as_jax_does():
    _, lines, compiled, plan, jc, jplan = _fused_inputs(2, n_rules=30, seed=8,
                                                        attack_rate=1.0, extra=())
    cls_ids, lens, _ = encode_for_match(jc, lines, 128)
    health = HealthRegistry()
    port = mesh.ShardedMatchBackend(compiled, _cpu_mesh(8, 2), 128, plan=plan,
                                    health=health.register("matcher-mesh"))
    port.cand_frac = 1.0 / 64
    got = port.match_bits(cls_ids, lens)
    jf = jax_mesh.ShardedMatchBackend(jc, jax_mesh.make_mesh(8, rp=2), 128, backend="xla",
                                      block_b=8, plan=jplan, cand_frac=1.0 / 64)
    np.testing.assert_array_equal(got, jf.match_bits(cls_ids, lens))
    assert port.fallback_batches == jf.fallback_batches == 1
    assert port.fused_batches == jf.fused_batches == 0
    comp = health.snapshot()["components"]["matcher-mesh"]
    assert comp["status"] == "degraded" and "overflow" in comp["detail"]


@pytest.fixture(scope="module")
def jax_pallas_4x2():
    """One JAX pallas-interpret backend over PATTERNS on a 4 x 2 mesh,
    shared by the cases below so that its one program builds once (its
    steps are traced under each case's `jax_mesh_shim`)."""
    jc = jax_compile_rules(PATTERNS, n_shards=2)
    return jc, jax_mesh.ShardedMatchBackend(jc, jax_mesh.make_mesh(8, rp=2), 128,
                                            backend="pallas-interpret", block_b=8)


@pytest.mark.parametrize("n_lines", [1, 3, 7, 13])
def test_dp_remainder_pads_and_keeps_line_order(n_lines, jax_pallas_4x2):
    compiled = compile_rules(PATTERNS, n_shards=2)
    lines = LINES[:n_lines]
    cls_ids, lens, _ = port_encode.encode_for_match(compiled, lines, 128)
    got = mesh.ShardedMatchBackend(compiled, _cpu_mesh(8, 2), 128).match_bits(cls_ids, lens)
    assert got.shape == (n_lines, compiled.n_rules)
    jc, jb = jax_pallas_4x2
    np.testing.assert_array_equal(got, jb.match_bits(*encode_for_match(jc, lines, 128)[:2]))
    _assert_re(got, PATTERNS, lines)


def test_batch_and_length_buckets_are_jax_s(jax_pallas_4x2):
    """Varying batch sizes and line lengths share JAX's power-of-two
    buckets (the JAX backend compiles one program for all of these)."""
    compiled = compile_rules(PATTERNS, n_shards=2)
    backend = mesh.ShardedMatchBackend(compiled, _cpu_mesh(8, 2), 128)
    jc, jb = jax_pallas_4x2
    shapes = set()
    for n in (1, 3, 9, 17, 25, 31, 32):
        cls_ids, lens, _ = port_encode.encode_for_match(compiled, LINES[:n], 128)
        pend = backend.submit(cls_ids, lens)
        shapes.add((pend["Bp"], pend["L_p"]))
        assert backend.collect(pend).shape == (n, compiled.n_rules)
    jb.match_bits(*encode_for_match(jc, LINES, 128)[:2])
    assert shapes == set(jb._fns) == {(32, 64)}


def test_submit_collect_split_and_row_pulls():
    """Two batches in flight, collected out of submit order, equal
    match_bits; one timed pull a dp row; the EWMAs and byte counts set."""
    compiled = compile_rules(PATTERNS, n_shards=2)
    backend = mesh.ShardedMatchBackend(compiled, _cpu_mesh(8, 2), 128)
    cls_ids, lens, _ = port_encode.encode_for_match(compiled, LINES, 128)
    want = backend.match_bits(cls_ids, lens)
    p1 = backend.submit(cls_ids, lens)
    p2 = backend.submit(cls_ids[:7], lens[:7])
    got2 = backend.collect(p2)
    got1 = backend.collect(p1)
    np.testing.assert_array_equal(got1, want)
    np.testing.assert_array_equal(got2, want[:7])
    assert len(backend.last_shard_merge_ms) == 4
    assert backend.submit_ms_ewma is not None and backend.merge_ms_ewma is not None
    assert p1["h2d_bytes"] > 0 and p1["d2h_bytes"] > 0
    # the plain versions launch nothing
    assert backend.row_launches == [0] * 4 and backend.member_launches == [[0, 0]] * 4


def test_rp_mismatch_and_bad_mesh_rejected():
    compiled = compile_rules(PATTERNS, n_shards=2)
    with pytest.raises(ValueError, match="shards"):
        mesh.ShardedMatchBackend(compiled, _cpu_mesh(8, 4), 128)
    with pytest.raises(ValueError, match="shards"):
        mesh.member_slab(compile_rules(PATTERNS, n_shards=3), 2, 0)
    with pytest.raises(ValueError) as err:
        mesh.make_mesh(["cpu"] * 8, rp=3)
    with pytest.raises(ValueError) as jerr:
        jax_mesh.make_mesh(8, rp=3)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("rp", [2, 4])
def test_member_slabs_equal_jax_addressable_shards(rp):
    """k = 1: member r's slab holds exactly the words JAX's `shard_params`
    puts on rp member r, tables and masks."""
    compiled = compile_rules(PATTERNS, n_shards=rp)
    backend = mesh.ShardedMatchBackend(compiled, _cpu_mesh(8, rp), 128)
    jc = jax_compile_rules(PATTERNS, n_shards=rp)
    params = jax_mesh.shard_params(jc, jax_mesh.make_mesh(8, rp=rp))
    wps = compiled.words_per_shard
    mask_names = ("shift_in", "inject_always", "inject_start", "selfloop", "accept_any",
                  "accept_end")
    seen = set()
    for sh in params["b_table"].addressable_shards:
        r = sh.index[1].start // wps
        seen.add(r)
        slab = backend._slabs[0][r]
        assert (slab.n_shards, slab.wps) == (1, wps)
        np.testing.assert_array_equal(slab.table.numpy().view(np.uint32), np.asarray(sh.data))
    for k, name in enumerate(mask_names):
        for sh in params[name].addressable_shards:
            r = sh.index[0].start // wps
            np.testing.assert_array_equal(backend._slabs[0][r].masks[k].numpy().view(np.uint32),
                                          np.asarray(sh.data))
    assert seen == set(range(rp))
    # every dp row shares its member's one copy on the device
    assert all(backend._slabs[d][r] is backend._slabs[0][r] for d in range(8 // rp)
               for r in range(rp))


def test_wide_ruleset_takes_two_shards_a_member():
    """Over 1,024 words a shard at rp = 2: compile_for_mesh packs k = 2
    shards a member, and the bits are the single-device match's."""
    patterns = workload.generate_rules(1000, seed=7)
    compiled = mesh.compile_for_mesh(patterns, 2)
    programs, unsupported = lower_rules(patterns)
    single = pack_programs(programs, n_shards="auto", unsupported=unsupported)
    assert compiled.n_words > 2 * nfa_match._MAX_WORDS_PER_SHARD
    assert compiled.n_shards == 4 and compiled.words_per_shard <= nfa_match._MAX_WORDS_PER_SHARD
    np.testing.assert_array_equal(compiled.byte_to_class, single.byte_to_class)
    now = time.time()
    lines = [ln.split(" ", 2)[2] for ln in
             workload.access_log(24, patterns, now, seed=7, n_ips=8, n_offenders=2,
                                 offender_hits=4)]
    lines += [ln.split(" ", 2)[2] for ln in workload.attack_lines(8, patterns, now, seed=7)]
    cls_ids, lens, host_eval = port_encode.encode_for_match(compiled, lines, 256)
    lens = np.where(host_eval, 0, lens).astype(np.int32)
    backend = mesh.ShardedMatchBackend(compiled, _cpu_mesh(2, 2), 256)
    assert backend._slabs[0][0].n_shards == 2
    got = backend.match_bits(cls_ids, lens)
    prep = nfa_match.prepare(single, "cpu")
    want = nfa_match.match_bits(prep, torch.from_numpy(cls_ids), torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[~host_eval].any()


# ------------------------------------------------------------ placement


def test_placement_decision():
    cpu = torch.device("cpu")
    assert mesh.mesh_placement(4, "cpu") == [cpu] * 4
    assert mesh.mesh_placement(2, "cuda:0", ["cuda:0", "cuda:0"]) == [torch.device("cuda", 0)] * 2
    with pytest.raises(ValueError, match="names 1 devices"):
        mesh.mesh_placement(2, "cpu", ["cpu"])
    # no member off the matcher's device type
    with pytest.raises(ValueError, match="are not cuda devices"):
        mesh.mesh_placement(2, "cuda:0", ["cuda:0", "cpu"])
    with pytest.raises(ValueError, match="are not cpu devices"):
        mesh.mesh_placement(1, "cpu", ["cuda:0"])
    # the JAX matcher's auto rule-parallel degree
    assert [mesh.resolve_rp(n) for n in (1, 2, 3, 4, 6, 8, 12)] == [1, 2, 1, 4, 2, 4, 4]
    assert mesh.resolve_rp(8, 2) == 2
    with pytest.raises(ValueError, match="does not divide"):
        mesh.resolve_rp(6, 4)


def test_cuda_matcher_with_more_members_than_cards_runs_single_device(monkeypatch, caplog):
    """The placement the matcher takes on the card, decided here: with
    more members than cards it logs the JAX warning and returns None."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.mesh_placement(2, torch.device("cuda", 0)) == [torch.device("cuda", i)
                                                               for i in range(2)]
    with caplog.at_level(logging.WARNING, logger="banjax_tpu_torch.parallel.mesh"):
        assert mesh.mesh_placement(4096, torch.device("cuda", 0)) is None
    assert "running single-device" in caplog.text


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_matcher_degrades_past_the_attached_cards(cuda_device):
    cfg = config_from_yaml_text(
        "regexes_with_rates:\n"
        "  - decision: nginx_block\n"
        "    rule: r\n"
        "    regex: 'GET .*'\n"
        "    interval: 5\n"
        "    hits_per_interval: 2\n"
        "matcher_device_windows: true\n"
        "matcher_mesh_devices: 4096\n"
    )
    m = TorchMatcher(cfg, RecordingBanner(), StaticDecisionLists(cfg), device=cuda_device)
    assert m._mesh_matcher is None and m._nfa is not None
    r = m.consume_lines([f"{time.time():.6f} 1.2.3.4 GET h.com GET /"])[0]
    assert not r.error


# ------------------------------------------------------------ the mesh-mode matcher


class _PortBanner(RecordingBanner):
    def __init__(self):
        super().__init__()
        self.bans = []

    def ban_or_challenge_ip(self, config, ip, decision, domain) -> None:
        self.bans.append((ip, int(decision), domain))
        super().ban_or_challenge_ip(config, ip, decision, domain)


def _port_matcher(yaml_text, n_devices, rp, health=None):
    cfg = config_from_yaml_text(yaml_text)
    cfg.matcher_mesh_devices = n_devices
    cfg.matcher_mesh_rp = rp
    cfg.matcher_device_windows = True
    banner = _PortBanner()
    m = TorchMatcher(cfg, banner, StaticDecisionLists(cfg), device="cpu", health=health)
    return m, banner


def _jax_bans(banner):
    return [(b.ip, int(b.decision), b.domain) for b in banner.bans]


TWO_RULES = r"""
regexes_with_rates:
  - decision: nginx_block
    rule: 'rule1'
    regex: 'GET example\.com GET .*'
    interval: 5
    hits_per_interval: 2
  - decision: challenge
    rule: 'rule2'
    regex: 'POST .*'
    interval: 5
    hits_per_interval: 1
"""

LONG_LINE = (
    "regexes_with_rates:\n"
    "  - decision: nginx_block\n"
    "    rule: tail\n"
    "    regex: 'zzz$'\n"
    "    interval: 5\n"
    "    hits_per_interval: 2\n"
    "matcher_max_line_len: 100\n"
)


def _two_rule_lines(now):
    return [f"{now:.6f} 10.1.1.{i % 4} GET example.com GET /x{i} HTTP/1.1" for i in range(20)] + [
        f"{now:.6f} 10.1.1.9 POST example.com POST /submit HTTP/1.1" for _ in range(4)]


def _long_lines(now):
    rest = "GET h.com GET /" + "a" * 82 + "zzz"
    assert len(rest) == 100
    return [f"{now:.6f} 5.6.7.8 {rest}", f"{now:.6f} 5.6.7.8 GET h.com GET /"]


def _pattern_rules():
    return yaml.safe_dump({"regexes_with_rates": [
        {"decision": "nginx_block", "rule": f"rule{j}", "regex": pat, "interval": 5,
         "hits_per_interval": 2} for j, pat in enumerate(PATTERNS)]})


def _pattern_lines(now):
    return [f"{now:.6f} 10.0.0.{i % 3} {line}" for i, line in enumerate(LINES)]


def _generated_rules():
    """Sixteen generated rules and the deploy keys: the fused two-stage
    runs under the mesh, and one chunk of attack lines overflows it."""
    pats = workload.generate_rules(16, seed=31)
    cfg = yaml.safe_load(workload.rules_config(pats, seed=3))
    cfg.update(matcher_batch_lines=64, matcher_max_line_len=128, matcher_prefilter=True)
    return yaml.safe_dump(cfg), pats


def _generated_lines(now, pats):
    lines = workload.access_log(96, pats, now, seed=4, n_ips=12, n_offenders=3,
                                offender_hits=12)
    return lines[:32] + workload.attack_lines(64, pats, now, seed=4) + lines[32:]


CASES = {
    "two_rules": (lambda: TWO_RULES, _two_rule_lines, 8, 2),
    "long_line_near_max_len": (lambda: LONG_LINE, _long_lines, 8, 2),
    "patterns": (_pattern_rules, _pattern_lines, 8, 2),
    "generated_fused": (lambda: _generated_rules()[0],
                        lambda now: _generated_lines(now, _generated_rules()[1]), 4, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_matcher_equals_jax_mesh_matcher_and_cpu_oracle(case):
    """Synchronous consume_lines: result keys and Banner effects of the
    mesh-mode TorchMatcher equal the JAX mesh-mode TpuMatcher's (device
    windows on, pallas-interpret) and the CpuMatcher's."""
    rules, make_lines, n, rp = CASES[case]
    yaml_text = rules()
    now = time.time()
    lines = make_lines(now)
    cpu_m, cpu_b = mesh_oracle.build_matcher(CpuMatcher, yaml_text)
    want = [cpu_m.consume_line(ln, now) for ln in lines]
    jax_m, jax_b = mesh_oracle.build_matcher(TpuMatcher, yaml_text, mesh_devices=n, mesh_rp=rp,
                                             interpret=True, device_windows=True)
    assert jax_m._mesh_matcher is not None
    jax_res = jax_m.consume_lines(lines, now)
    health = HealthRegistry()
    port, port_b = _port_matcher(yaml_text, n, rp, health=health)
    mm = port._mesh_matcher
    assert mm is not None and (mm.dp, mm.rp) == (n // rp, rp)
    assert port._prefilter is None and port._fw_pipeline is None
    got = port.consume_lines(lines, now)
    keys = [mesh_oracle.result_key(r) for r in got]
    assert keys == [mesh_oracle.result_key(r) for r in jax_res]
    assert keys == [mesh_oracle.result_key(r) for r in want]
    assert port_b.bans == _jax_bans(jax_b) == _jax_bans(cpu_b)
    jm = jax_m._mesh_matcher
    assert (mm.plan is None) == (jm.plan is None)
    assert (mm.fused_batches, mm.fallback_batches) == (jm.fused_batches, jm.fallback_batches)
    if case == "generated_fused":
        assert mm.fused_batches > 0 and mm.fallback_batches > 0 and port_b.bans
    assert "matcher-mesh" in health.snapshot()["components"]
    # the mesh's counters on the metrics line and in /metrics
    jax_keys = {k: v for k, v in jax_m.stats.snapshot(jax_m.device_windows, jax_m).items()
                if k.startswith("Mesh")}
    port_keys = {k: v for k, v in port.stats.snapshot(port.device_windows, port).items()
                 if k.startswith("Mesh")}
    assert set(port_keys) == set(jax_keys) == {
        "MeshFusedBatches", "MeshFallbackBatches", "MeshSubmitMsEwma", "MeshMergeMsEwma",
        "MeshShardMergeMsMax"}
    assert [port_keys[k] for k in ("MeshFusedBatches", "MeshFallbackBatches")] == \
        [jax_keys[k] for k in ("MeshFusedBatches", "MeshFallbackBatches")]
    text = exposition.render_prometheus(DynamicDecisionLists(start_sweeper=False), {}, {},
                                        matcher=port)
    assert f"banjax_mesh_fused_batches_total {mm.fused_batches}" in text
    assert "banjax_mesh_shard_merge_ms_max" in text


@pytest.mark.parametrize("case", ["patterns", "generated_fused"])
def test_pipelined_mesh_stream_equals_cpu_oracle(case):
    """The port's PipelineScheduler driving a mesh-mode TorchMatcher:
    sharded submit, one pull a dp row at collect, ordered window commit
    at drain; results and Banner effects equal the CpuMatcher's and the
    synchronous mesh matcher's, nothing shed."""
    rules, make_lines, n, rp = CASES[case]
    yaml_text = rules()
    now = time.time()
    lines = make_lines(now)
    cpu_m, cpu_b = mesh_oracle.build_matcher(CpuMatcher, yaml_text)
    want = [mesh_oracle.result_key(cpu_m.consume_line(ln, now)) for ln in lines]
    port, port_b = _port_matcher(yaml_text, n, rp)
    collected = []
    sch = scheduler.PipelineScheduler(
        lambda: port, on_results=lambda bl, rs: collected.append((list(bl), rs)),
        now_fn=lambda: now, latency_budget_ms=1e9,
    )
    sch._sizer.target = lambda: max(1, len(lines) // 5)
    sch.submit(lines)
    sch.start()
    try:
        assert sch.flush(120), "the pipelined mesh stream did not drain"
    finally:
        sch.stop()
    assert [ln for bl, _ in collected for ln in bl] == lines
    assert [mesh_oracle.result_key(r) for _, rs in collected for r in rs] == want
    assert port_b.bans == _jax_bans(cpu_b)
    assert len(port._mesh_matcher.last_shard_merge_ms) == n // rp
    assert sch.stats.peek()["PipelineShedLines"] == 0
    assert len(collected) > 1


def test_deploy_file_mesh_keys_engage_a_cpu_mesh():
    """`matcher_mesh_devices: 1` in the deploy file gives a 1 x 1 mesh."""
    with open("deploy/banjax-config.yaml") as f:
        text = f.read()
    patterns = workload.generate_rules(12, seed=7)
    cfg = yaml.safe_load(text)
    cfg.update(yaml.safe_load(workload.rules_config(patterns, seed=7)))
    cfg.update(matcher_mesh_devices=1, matcher_batch_lines=64, matcher_window_capacity=256,
               warm_tier_capacity=1024, traffic_sketch_width=1024)
    pcfg = config_from_yaml_text(yaml.safe_dump(cfg))
    assert pcfg.not_ported == []
    m = TorchMatcher(pcfg, RecordingBanner(), StaticDecisionLists(pcfg), device="cpu")
    assert (m._mesh_matcher.dp, m._mesh_matcher.rp) == (1, 1)
    now = time.time()
    res = m.consume_lines(workload.access_log(64, patterns, now, seed=7, n_ips=8), now)
    assert len(res) == 64 and not any(r.error for r in res)
    m.close()
    assert m._mesh_matcher is None
