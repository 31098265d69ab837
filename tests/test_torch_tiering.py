"""The deploy configuration's host tier and state tiering: TorchMatcher
(device="cpu") against the JAX package's TpuMatcher with native parse,
the native slot manager, the traffic sketch, slot admission and the warm
tier (pallas-interpret, 64 slots, admission threshold 4).

The same seeded batches of `_gen_tier_lines` traffic go through both;
compared exactly: result keys, ban-log bytes, ban calls, format_states,
the sketch's arrays and pull summary, and the tier counters. A second
test carries a JAX run's window, sketch, warm-tier and shadow state into
the port and continues there. The rest: the config refuses the matcher
paths the port lacks, and a native library that cannot be built raises."""

import dataclasses
import time

import numpy as np
import pytest
import yaml

from banjax_tpu.matcher.runner import TpuMatcher
from banjax_tpu_torch import convert, native, workload
from banjax_tpu_torch.config import config_from_yaml_text
from banjax_tpu_torch.matcher.kernels import _build
from banjax_tpu_torch.native import shm, slotmgr
from tests.differential.test_mega_state_differential import _gen_tier_lines
from tests.differential.test_tpu_matcher import CONFIG_YAML
from tests.test_torch_matcher import _assert_same, _jax, _one_torch_thread, _port  # noqa: F401

TIER_KEYS = """
matcher: tpu
matcher_device_windows: true
matcher_prefilter: true
pallas_single_kernel: "on"
matcher_native_parse: true
slotmgr_native: true
traffic_sketch_enabled: true
traffic_sketch_width: 512
traffic_sketch_hll_p: 8
slot_admission_enabled: true
slot_admission_min_estimate: 4
warm_tier_enabled: true
warm_tier_capacity: 4096
matcher_window_capacity: 64
matcher_batch_lines: 64
matcher_max_line_len: 128
matcher_prefilter_cand_frac: 0.25
"""

NS = 1_000_000_000
COUNTERS = ("slot_refusals", "sketch_admissions", "sketch_fp_evaluated", "sketch_fp_count",
            "warm_spills", "warm_refills", "eviction_count", "warm_occupancy", "warm_dropped")


def _yaml(**over):
    cfg = yaml.safe_load(CONFIG_YAML)
    extra = yaml.safe_load(workload.rules_config(workload.generate_rules(8, seed=31), seed=3))
    cfg["regexes_with_rates"] += extra["regexes_with_rates"]
    cfg.update(yaml.safe_load(TIER_KEYS))
    cfg.update(over)
    return yaml.safe_dump(cfg)


def _batches(now, n=640, seed=3, size=96):
    lines = _gen_tier_lines(n, now, seed=seed)
    return [lines[s : s + size] for s in range(0, len(lines), size)]


def _jax_sketch(sk):
    return {"cm": np.asarray(sk._state[0]), "hll": np.asarray(sk._state[1]),
            "slot_hash": np.asarray(sk._slot_hash_dev)}


def _assert_tiers_equal(tpu, port):
    jdw, pdw = tpu.device_windows, port.device_windows
    assert {k: getattr(jdw, k) for k in COUNTERS} == {k: getattr(pdw, k) for k in COUNTERS}
    got, want = port.traffic_sketch.arrays(), _jax_sketch(tpu.traffic_sketch)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    jsk, psk = tpu.traffic_sketch, port.traffic_sketch
    assert (psk.lines_total, psk.refused_rows_folded) == (jsk.lines_total, jsk.refused_rows_folded)
    assert np.array_equal(psk._cm_host, jsk._cm_host)
    jsum, psum = jsk.pull(force=True), psk.pull(force=True)
    assert psum == jsum
    for k, v in port.device_windows._state.arrays().items():
        assert np.array_equal(np.asarray(getattr(jdw._state, k)), v), k


def test_tiering_matches_tpu_matcher():
    now = time.time()
    yaml_text = _yaml()
    tpu, tpu_banner, tpu_log, _ = _jax(TpuMatcher, yaml_text)
    port, port_banner, port_log = _port(yaml_text)
    assert tpu._native and tpu.device_windows.slotmgr_native and tpu._slot_admission
    assert port._native and port.device_windows.slotmgr_native and port._slot_admission
    assert port._fw_pipeline is not None
    assert port.admission_min_estimate == tpu._admission_min_estimate == 4
    tpu_res, port_res = [], []
    for k, batch in enumerate(_batches(now)):
        tpu_res += tpu.consume_lines(batch, now_unix=now)
        port_res += port.consume_lines(batch, now_unix=now)
        if k == 2:
            # a pull refreshes the count-min cache the gate estimates from
            tpu.traffic_sketch.pull(force=True)
            port.traffic_sketch.pull(force=True)
    _assert_same("tiering", tpu_res, port_res, tpu_banner, port_banner,
                 tpu_log, port_log, tpu.device_windows, port.device_windows)
    _assert_tiers_equal(tpu, port)
    dw = port.device_windows
    assert dw.slot_refusals > 0 and dw.sketch_admissions > 0
    assert dw.warm_spills > 0 and dw.warm_refills > 0
    assert port_log.getvalue().count("\n") > 10
    assert port._fw_pipeline.idle()


def test_tiering_state_carried_from_jax_continues_identically():
    """At 16 slots, so that evictions spill into the warm tier as well."""
    now = time.time()
    yaml_text = _yaml(matcher_window_capacity=16)
    batches = _batches(now, n=480, seed=9)
    tpu, tpu_banner, tpu_log, _ = _jax(TpuMatcher, yaml_text)
    for batch in batches[:4]:
        tpu.consume_lines(batch, now_unix=now)
    tpu.traffic_sketch.pull(force=True)
    jdw, jsk = tpu.device_windows, tpu.traffic_sketch
    assert jdw.warm_spills > 0 and jdw.eviction_count > 0
    evicted_before = jdw.eviction_count
    port, port_banner, port_log = _port(yaml_text)
    pdw = port.device_windows
    convert.load_window_state(
        pdw,
        {k: np.asarray(getattr(jdw._state, k))
         for k in ("hits", "start_s", "start_ns", "valid", "ip_seen")},
        {ip: s for s, ip in jdw._slot_ip.items()}, jdw._shadow,
        last_used=jdw._last_used, batch_seq=jdw._batch_seq,
    )
    convert.load_tiering(
        pdw, {k: getattr(jdw, k) for k in COUNTERS if not k.startswith("warm_o")
              and k != "warm_dropped"},
        sketch_pending=jdw._sketch_pending, sketch_slots=jdw._sketch_slots,
        warm_table=bytes(jdw._warm._shm.buf[: shm.table_bytes(jdw._warm.capacity,
                                                               jdw._warm.max_rules)]),
    )
    convert.load_sketch_state(port.traffic_sketch, {
        **_jax_sketch(jsk), "cm_host": jsk._cm_host, "cm_cache": jsk._cm_cache,
        "candidates": jsk._candidates, "rule_hits": jsk._rule_hits,
        "lines_total": jsk.lines_total, "update_count": jsk.update_count,
        "refused_rows_folded": jsk.refused_rows_folded, "pull_count": jsk.pull_count,
        "pull_bytes_total": jsk.pull_bytes_total,
    })
    assert pdw.format_states() == jdw.format_states()
    tpu_banner.bans.clear()
    tpu_log.seek(0)
    tpu_log.truncate()
    tpu_res, port_res = [], []
    for batch in batches[4:]:
        tpu_res += tpu.consume_lines(batch, now_unix=now)
        port_res += port.consume_lines(batch, now_unix=now)
    _assert_same("carried", tpu_res, port_res, tpu_banner, port_banner,
                 tpu_log, port_log, tpu.device_windows, port.device_windows)
    _assert_tiers_equal(tpu, port)
    assert pdw.warm_refills > 0 and pdw.eviction_count > evicted_before


@pytest.mark.parametrize("warm", [False, True])
def test_apply_host_events_matches_jax(warm):
    """The refused rows' window step on the host, at the interval's edges
    (exactly the interval is inside, one ns past it restarts), over
    thresholds 0-2, with and without the warm tier as the state's home."""
    from banjax_tpu.config.schema import config_from_yaml_text as jax_config
    from banjax_tpu.matcher.windows import DeviceWindows as JaxWindows
    from banjax_tpu_torch.matcher.windows import DeviceWindows

    text = "\n".join(
        ["regexes_with_rates:"] + [
            f"  - {{rule: r{k}, regex: 'x{k}', interval: {iv}, hits_per_interval: {h},"
            " decision: challenge}"
            for k, (iv, h) in enumerate([(5, 0), (1.5, 1), (10, 2)])
        ])
    keys = dict(warm_tier_enabled=warm, warm_tier_capacity=64)
    port = DeviceWindows(config_from_yaml_text(text).regexes_with_rates, "cpu", capacity=8, **keys)
    ref = JaxWindows(jax_config(text).regexes_with_rates, capacity=8, **keys)
    iv = [5 * NS, 1_500_000_000, 10 * NS]
    t0 = 1_700_000_000 * NS + 123
    rng = np.random.default_rng(4)
    kinds = set()
    for batch in range(6):
        events = []
        for row in range(12):
            rid = int(rng.integers(3))
            step = int(rng.choice([0, 1, iv[rid] - 1, iv[rid], iv[rid] + 1]))
            t0 += step
            events += [(row, rid, f"9.9.9.{int(rng.integers(4))}", t0)]
        events.sort(key=lambda e: (e[0], e[1]))
        got, want = port.apply_host_events(events), ref.apply_host_events(events)
        assert [dataclasses.astuple(e) for e in got] == [dataclasses.astuple(e) for e in want]
        assert port.format_states() == ref.format_states()
        assert (port.warm_spills, len(port)) == (ref.warm_spills, len(ref))
        kinds |= {(int(e.match_type), e.exceeded) for e in got}
    assert kinds >= {(0, False), (1, False), (2, False), (2, True)}


@pytest.mark.parametrize("target", ["estimate_ips", "note_assignments", "update"])
def test_a_fault_in_the_sketch_or_the_gate_reaches_the_caller(monkeypatch, target):
    """Where the JAX runner logs and goes on, the port raises; the batch's
    slot pins are released and the chunk pipeline is left idle."""
    now = time.time()
    port, _, _ = _port(_yaml())

    def fault(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(port.traffic_sketch, target, fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        port.consume_lines(_batches(now)[0], now_unix=now)
    assert not port.device_windows._pin_counts.any()
    assert port._fw_pipeline.idle()


@pytest.mark.parametrize("text, key", [
    # the pipeline is ported: `true` loads (test_torch_config.py); a
    # non-bool value is still refused
    ("pipeline_enabled: 1", "pipeline_enabled"),
    # the mesh is ported: a mesh loads (test_torch_config.py), a bad one
    # is still refused
    ("matcher_mesh_devices: 4\nmatcher_mesh_rp: 3", "matcher_mesh_rp"),
    ("matcher_mesh_devices: -1", "matcher_mesh_devices"),
    ("slot_admission_enabled: true\ntraffic_sketch_enabled: false\n"
     "matcher_device_windows: true", "slot_admission_enabled"),
    ("traffic_sketch_hll_p: 3", "traffic_sketch_hll_p"),
])
def test_config_refuses_unported_paths_and_bad_keys(text, key):
    with pytest.raises(ValueError, match=key):
        config_from_yaml_text(text)


def test_config_reads_the_deploy_tiering_keys():
    with open("deploy/banjax-config.yaml") as f:
        cfg = config_from_yaml_text(f.read())
    assert (cfg.matcher_native_parse, cfg.slotmgr_native, cfg.traffic_sketch_enabled,
            cfg.slot_admission_enabled, cfg.warm_tier_enabled) == (True,) * 5
    assert (cfg.warm_tier_capacity, cfg.slot_admission_min_estimate) == (1 << 20, 0)
    assert config_from_yaml_text("pipeline_enabled: false\nmatcher_mesh_devices: 0")


@pytest.mark.parametrize("module, name, over", [
    (native, "FASTPARSE", {"slotmgr_native": False, "warm_tier_enabled": False}),
    (slotmgr, "SLOTMGR", {"matcher_native_parse": False, "warm_tier_enabled": False}),
    (shm, "SHMSTATE", {"matcher_native_parse": False, "slotmgr_native": False}),
])
def test_native_build_failure_raises(monkeypatch, tmp_path, module, name, over):
    """No C compiler: the matcher that asks for a native library fails to
    start instead of falling back to the Python route."""
    lib = getattr(module, name)
    fresh = _build.HostLibrary(lib.name, lib.source.name, lib.functions)
    monkeypatch.setattr(fresh, "build_dir", tmp_path)
    monkeypatch.setattr(module, name, fresh)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="no C compiler"):
        _port(_yaml(**over))
