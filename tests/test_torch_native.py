"""The port's native host tier against the JAX package's: the batch parse
(`native.parse_encode_batch`), the slot manager (`native/slotmgr.c`
through `DeviceWindows`) and the warm tier (`native/shm.ShmWarmTier`).

Parse: every output array identical on the JAX suite's corpus and seeded
fuzz, deferred rows included. Slots: the port's native manager, the
port's dict path and the JAX native manager in lockstep under eviction
churn, pins, growth, shadow restores, warm spills and refills, and the
admission probes. Warm tier: put / take / peek / contains / keys and a
drop on a full probe window, down to the table's bytes; and a dropped
spill keeps its state in the shadow."""

import random
import re

import numpy as np
import pytest
import torch

from banjax_tpu import native as jax_native
from banjax_tpu.config.schema import Decision as JaxDecision
from banjax_tpu.config.schema import RegexWithRate as JaxRule
from banjax_tpu.matcher.windows import DeviceWindows as JaxWindows
from banjax_tpu.native import shm as jax_shm
from banjax_tpu_torch import native
from banjax_tpu_torch.config import RegexWithRate
from banjax_tpu_torch.decisions.model import Decision
from banjax_tpu_torch.matcher.windows import DeviceWindows
from banjax_tpu_torch.native import shm
from tests.unit.test_native_fastparse import COMPILED, LINES, MAX_LEN, NOW

NS = 1_000_000_000
PARSE_FIELDS = ("ts_ns", "flags", "ip_off", "ip_len", "host_off", "host_len",
                "rest_off", "rest_len", "cls_ids", "lens")


def _fuzz_lines(seed):
    rng = np.random.default_rng(seed)
    charset = list("abc ./:0123456789eE+-_é")
    out = []
    for _ in range(500):
        n = int(rng.integers(0, 60))
        out.append("".join(charset[int(k)] for k in rng.integers(0, len(charset), n)))
    return out


def _ts_lines(seed):
    rng = random.Random(seed)
    cases = []
    for _ in range(500):
        kind = rng.random()
        if kind < 0.4:
            cases.append(f"{rng.randrange(10**9, 2 * 10**9)}.{rng.randrange(10**6):06d}")
        elif kind < 0.6:
            cases.append(f"{rng.randrange(10**17, 10**18)}.{rng.randrange(10**6):06d}")
        elif kind < 0.8:
            cases.append(f"{rng.randrange(10**9)}e{rng.randrange(-3, 4)}")
        else:
            cases.append(rng.choice(["1_000.5", "inf", "nan", "0x1p3", "9223372036854775808"]))
    return [f"{ts} 1.2.3.{k % 7} GET h{k % 3}.com GET /p{k} x" for k, ts in enumerate(cases)]


@pytest.mark.parametrize("lines", [LINES, _fuzz_lines(0), _fuzz_lines(1), _ts_lines(2)],
                         ids=["corpus", "fuzz0", "fuzz1", "timestamps"])
def test_parse_encode_batch_matches_jax(lines):
    got = native.parse_encode_batch(lines, COMPILED.byte_to_class, MAX_LEN, NOW, 10.0,
                                    native.ParseScratch())
    want = jax_native.parse_encode_batch(lines, COMPILED.byte_to_class, MAX_LEN, NOW, 10.0)
    assert got.n == want.n == len(lines)
    for f in PARSE_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.blob == want.blob
    deferred = (got.flags & native.FLAG_DEFER) != 0
    assert deferred.any() or lines is not LINES


def test_dedup_spans_and_embedded_newline_match_jax():
    lines = [f"{NOW:f} 10.0.0.{k % 5} GET h{k % 3}.com GET / x" for k in range(40)]
    got = native.parse_encode_batch(lines, COMPILED.byte_to_class, MAX_LEN, NOW, 10.0)
    want = jax_native.parse_encode_batch(lines, COMPILED.byte_to_class, MAX_LEN, NOW, 10.0)
    for off, ln in (("ip_off", "ip_len"), ("host_off", "host_len")):
        a = native.dedup_spans(got.blob, getattr(got, off), getattr(got, ln))
        b = jax_native.dedup_spans(want.blob, getattr(want, off), getattr(want, ln))
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    bad = lines[:3] + ["1.0 1.1.1.1 GET a\nb c"]
    assert native.parse_encode_batch(bad, COMPILED.byte_to_class, MAX_LEN, NOW, 10.0) is None
    assert jax_native.parse_encode_batch(bad, COMPILED.byte_to_class, MAX_LEN, NOW, 10.0) is None


# ---- the slot manager, three ways in lockstep ----


def _three(capacity, warm_capacity=0):
    warm = dict(warm_tier_enabled=warm_capacity > 0, warm_tier_capacity=max(1, warm_capacity))
    port_rule = RegexWithRate("r", "x", re.compile("x"), 5 * NS, 2, Decision.NGINX_BLOCK)
    jax_rule = JaxRule(rule="r", regex_string="x", regex=re.compile("x"), interval_ns=5 * NS,
                       hits_per_interval=2, decision=JaxDecision.NGINX_BLOCK)
    nat = DeviceWindows([port_rule], "cpu", capacity=capacity, native_slotmgr=True, **warm)
    ora = DeviceWindows([port_rule], "cpu", capacity=capacity, native_slotmgr=False, **warm)
    ref = JaxWindows([jax_rule], capacity=capacity, native_slotmgr=True, **warm)
    assert nat.slotmgr_native and not ora.slotmgr_native and ref.slotmgr_native
    return nat, ora, ref


def _same(a, b, ctx):
    assert a.capacity == b.capacity, ctx
    assert a._slot_ip == b._slot_ip, ctx
    assert a._pending_evict == b._pending_evict, ctx
    assert a._pending_restore == b._pending_restore, ctx
    assert (a.eviction_count, a.grow_count) == (b.eviction_count, b.grow_count), ctx
    assert np.array_equal(a._pin_counts, b._pin_counts), ctx
    assert np.array_equal(a._last_used, b._last_used), ctx
    free = [w._sm.free_count() if w._sm is not None else len(w._free) for w in (a, b)]
    held = [w._sm.assigned() if w._sm is not None else len(w._slots) for w in (a, b)]
    assert free[0] == free[1] and held[0] == held[1] == len(a._slot_ip), ctx
    assert (a.warm_spills, a.warm_refills, a.warm_dropped) == \
        (b.warm_spills, b.warm_refills, b.warm_dropped), ctx
    assert {k: dict(v) for k, v in a._shadow.items()} == {k: dict(v) for k, v in b._shadow.items()}
    if a._warm is not None:
        keys = sorted(a._warm.keys())
        assert keys == sorted(b._warm.keys()), ctx
        assert [a._warm.peek(ip) for ip in keys] == [b._warm.peek(ip) for ip in keys], ctx


def _ip(i):
    return f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}"


def _lockstep(ws, ips, ctx):
    out = [w.slots_for_unique_ips(ips) for w in ws]
    assert len({o is None for o in out}) == 1, f"{ctx}: refusal diverged"
    if out[0] is not None:
        assert all(np.array_equal(out[0], o) for o in out[1:]), ctx
    for w in ws[1:]:
        _same(ws[0], w, ctx)
    return out[0]


@pytest.mark.parametrize("capacity, warm_capacity, seed", [(16, 0, 11), (16, 256, 12), (64, 256, 13)])
def test_slot_manager_matches_dict_path_and_jax(capacity, warm_capacity, seed):
    rng = random.Random(seed)
    ws = _three(capacity, warm_capacity)
    pool = [_ip(i) for i in range(capacity * 4)]
    held, seeded = [], 0
    for step in range(150):
        ips = rng.sample(pool, min(rng.randrange(1, capacity + 4), len(pool)))
        s = _lockstep(ws, ips, f"step {step}")
        if s is not None:
            if rng.random() < 0.7:
                for w in ws:
                    w.release_pins(s)
            else:
                held.append(s)
        while held and (s is None or rng.random() < 0.4):
            h = held.pop(rng.randrange(len(held)))
            for w in ws:
                w.release_pins(h)
        if rng.random() < 0.3:
            # a real window vector for the shadow: evictions spill it,
            # returns refill it or queue its restore
            ip, seeded = rng.choice(pool), seeded + 1
            for w in ws:
                w._shadow.setdefault(ip, {0: (seeded, 1_700_000_000 + seeded, seeded * 7)})
        if rng.random() < 0.5:
            probe = rng.sample(pool, rng.randrange(1, capacity))
            est = np.asarray([rng.randrange(3) for _ in probe], dtype=np.int64)
            masks = [w.admission_mask(probe, estimates=est, min_estimate=1) for w in ws]
            assert all(np.array_equal(masks[0], m) for m in masks[1:]), step
            assert len({(w.slot_refusals, w.sketch_admissions) for w in ws}) == 1
    nat = ws[0]
    assert nat.eviction_count > 0 and nat._pending_restore + nat._pending_evict
    if warm_capacity:
        assert nat.warm_spills > 0 and nat.warm_refills > 0


def test_slot_manager_growth_matches(monkeypatch):
    monkeypatch.setattr(DeviceWindows, "AUTO_START_CAPACITY", 64)
    monkeypatch.setattr(JaxWindows, "AUTO_START_CAPACITY", 64)
    rng = random.Random(7)
    ws = _three(0)
    nxt = 0
    for step in range(10):
        k = rng.randrange(50, 300)
        s = _lockstep(ws, [_ip(nxt + i) for i in range(k)], f"grow {step}")
        nxt += k
        for w in ws:
            w.release_pins(s)
    assert ws[0].grow_count > 0
    assert ws[0]._state.capacity == ws[0].capacity


def test_warm_drop_keeps_the_state():
    """A warm tier of two records: later spills find the probe window full
    of live records and drop; the shadow keeps each dropped vector."""
    ws = _three(2, warm_capacity=1)
    for i in range(10):
        for w in ws:
            w._shadow.setdefault(_ip(i), {0: (3, 1_700_000_123, 42)})
        s = _lockstep(ws, [_ip(i)], f"fill {i}")
        for w in ws:
            w.release_pins(s)
    nat = ws[0]
    assert nat.warm_dropped > 0 and nat.warm_occupancy == 2
    for i in range(10):
        assert nat._warm.peek(_ip(i)) is not None or _ip(i) in nat._shadow
    assert len(nat) == 10


# ---- the warm table ----


def test_warm_tier_matches_jax_table_bytes():
    n_rules, expiry = 3, 10 * NS
    port = shm.create_warm_tier(capacity=4, max_rules=n_rules, expiry_ns=expiry)
    ref = jax_shm.ShmWarmTier(capacity=4, max_rules=n_rules, expiry_ns=expiry)
    try:
        script = [("put", "1.1.1.1", [(0, 1, 2, 3), (2, 4, 5, 6)], 100),
                  ("put", "", [(1, 7, 8, 9)], 100),
                  ("put", "2.2.2.2", [(0, 9, 9, 9)], 100),
                  ("take", "1.1.1.1"), ("put", "3.3.3.3", [(1, 1, 1, 1)] * 5, 100),
                  ("put", "4.4.4.4", [(0, 2, 2, 2)], 100),
                  ("put", "5.5.5.5", [(0, 3, 3, 3)], 200),        # full window: dropped
                  ("put", "6.6.6.6", [(0, 4, 4, 4)], 100 + expiry + 1),  # steals the stalest
                  ("take", "9.9.9.9"), ("put", "2.2.2.2", [(2, 0, 1, 2)], 300)]
        for op, ip, *rest in script:
            if op == "put":
                assert port.put(ip, rest[0], rest[1]) == ref.put(ip, rest[0], rest[1]), (op, ip)
            else:
                assert port.take(ip) == ref.take(ip), (op, ip)
            assert (len(port), port.dropped, port.keys()) == (len(ref), ref.dropped, ref.keys())
        assert port.dropped == 2
        probe = ["1.1.1.1", "2.2.2.2", "", "6.6.6.6", "7.7.7.7"]
        assert np.array_equal(port.contains_batch(probe), ref.contains_batch(probe))
        assert [port.peek(ip) for ip in probe] == [ref.peek(ip) for ip in probe]
        raw = bytes(ref._shm.buf[: shm.table_bytes(4, n_rules)])
        assert bytes(port._view) == raw
    finally:
        port.close()
        ref.close()
        ref.unlink()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
