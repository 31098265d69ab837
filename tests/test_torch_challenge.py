"""The challenge plane of the port against the JAX package, exactly: the
cookie crypto (bytes and every CookieError text), the session cookie and
the integrity score, the micro-batching verifier on the CPU, and the
bounded failed-challenge state on a seeded sequence that evicts, spills,
refills and drops."""

import base64
import hashlib
import json
import random
import threading
import time
import types

import pytest
import torch

from banjax_tpu.challenge import failures as jax_failures
from banjax_tpu.crypto import challenge as jax_crypto
from banjax_tpu.crypto import integrity as jax_integrity
from banjax_tpu.crypto import session as jax_session
from banjax_tpu_torch.challenge import failures, verifier
from banjax_tpu_torch.challenge import stats as challenge_stats
from banjax_tpu_torch.crypto import challenge as crypto
from banjax_tpu_torch.crypto import integrity, session
from banjax_tpu_torch.matcher.kernels import pow_verify

SECRET = "port-secret"
NOW = 1_760_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers, and the timing-sensitive tests beside these need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except (jax_crypto.CookieError, crypto.CookieError) as e:
        return (type(e).__name__, str(e))


def _cookies():
    """(name, cookie string, binding) for every accept and reject shape."""
    fresh = jax_crypto.new_challenge_cookie_at(SECRET, NOW + 300, "1.2.3.4")
    solved = jax_crypto.solve_challenge_for_testing(fresh, 8)
    raw = bytearray(base64.standard_b64decode(solved))
    return [
        ("solved", solved, "1.2.3.4"),
        ("unsolved", fresh, "1.2.3.4"),
        ("plus_mangled", solved.replace("+", " "), "1.2.3.4"),
        ("bad_base64", "!!not base64!!", "1.2.3.4"),
        ("torn", solved[:40], "1.2.3.4"),
        ("long", base64.standard_b64encode(bytes(raw) + b"x").decode(), "1.2.3.4"),
        ("wrong_binding", solved, "8.8.8.8"),
        ("expired", jax_crypto.solve_challenge_for_testing(
            jax_crypto.new_challenge_cookie_at(SECRET, NOW - 5, "1.2.3.4"), 8), "1.2.3.4"),
        ("tampered_hmac", base64.standard_b64encode(b"\x00" + bytes(raw[1:])).decode(), "1.2.3.4"),
    ]


@pytest.mark.parametrize("name,cookie,binding", _cookies(), ids=[c[0] for c in _cookies()])
def test_cookie_checks_and_error_texts_match_jax(name, cookie, binding):
    for zero_bits in (8, 30):
        want = _outcome(jax_crypto.validate_sha_inv_cookie, SECRET, cookie, NOW, binding, zero_bits)
        assert _outcome(crypto.validate_sha_inv_cookie, SECRET, cookie, NOW, binding, zero_bits) == want
        # the verifier's path (wire checks on the host, count by the plain version)
        got = _outcome(verifier.verify_sha_inv, SECRET, cookie, NOW, binding, zero_bits,
                       _cpu_verifier())
        assert got == (want[0], None if want[0] == "ok" else want[1])
    pw = hashlib.sha256(b"password").digest()
    assert _outcome(crypto.validate_password_cookie, SECRET, cookie, NOW, binding, pw) == \
        _outcome(jax_crypto.validate_password_cookie, SECRET, cookie, NOW, binding, pw)


def test_cookie_bytes_match_jax():
    for binding in ("1.2.3.4", "Mozilla/5.0 (X11)", ""):
        for expiry in (NOW, NOW + 14400, 2**64 - 1):
            assert crypto.compute_hmac(SECRET, expiry, binding) == \
                jax_crypto.compute_hmac(SECRET, expiry, binding)
            fresh = crypto.new_challenge_cookie_at(SECRET, expiry, binding)
            assert fresh == jax_crypto.new_challenge_cookie_at(SECRET, expiry, binding)
        assert crypto.solve_challenge_for_testing(fresh, 6) == \
            jax_crypto.solve_challenge_for_testing(fresh, 6)
    for data in (b"", b"\x00" * 32, b"\x00\x01", b"\x80"):
        assert crypto.count_zero_bits_from_left(data) == jax_crypto.count_zero_bits_from_left(data)


def test_session_cookie_and_integrity_score_match_jax(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: float(NOW))
    draws = []
    for _ in range(2):
        rng = random.Random(5)
        monkeypatch.setattr("secrets.randbits", lambda k: rng.getrandbits(k))
        draws.append(session.new_session_cookie("s", 3600, "1.2.3.4")
                     if not draws else jax_session.new_session_cookie("s", 3600, "1.2.3.4"))
    assert draws[0] == draws[1]
    good = draws[0]
    for cookie, ip, now in ((good, "1.2.3.4", NOW), (good, "9.9.9.9", NOW),
                            (good, "1.2.3.4", NOW + 7200), ("***", "1.2.3.4", NOW),
                            (good[:8], "1.2.3.4", NOW)):
        outs = []
        for mod in (session, jax_session):
            try:
                mod.validate_session_cookie(cookie, "s", now, ip)
                outs.append("ok")
            except ValueError as e:
                outs.append(str(e))
        assert outs[0] == outs[1]
    payload = {"webdriver": False, "hasPlugins": True, "gpuRenderer": "Mesa llvmpipe",
               "cpu": 8, "memory": 8, "screen": {"width": 1920, "height": 1080},
               "window": {"innerWidth": 1920, "innerHeight": 1000}, "colorDepth": 24,
               "langLength": 2, "languages": ["en", None]}
    for cookie in ("", "%%%", base64.b64encode(b"[1]").decode(),
                   base64.b64encode(json.dumps(payload).encode()).decode(),
                   base64.b64encode(b'{"cpu": 1.5}').decode()):
        a = integrity.calc_bot_score_from_cookie(cookie)
        b = jax_integrity.calc_bot_score_from_cookie(cookie)
        assert (a[0], a[1], a[2].hash, a[2].payload.to_json_dict()) == \
            (b[0], b[1], b[2].hash, b[2].payload.to_json_dict())


_VERIFIER = []


def _cpu_verifier():
    if not _VERIFIER:
        _VERIFIER.append(verifier.DeviceVerifier(batch_max=8, device="cpu"))
    return _VERIFIER[0]


@pytest.mark.parametrize("batch_max", [16, 2])
def test_concurrent_submits_get_the_right_bits_in_fewer_dispatches(batch_max):
    # at batch_max 2 the queue fills and callers wait for room
    v = verifier.DeviceVerifier(batch_max=batch_max, device="cpu")
    rng = random.Random(9)
    payloads = [bytes(rng.randrange(256) for _ in range(52)) for _ in range(48)]
    want = [verifier.cpu_zero_bits(p) for p in payloads]
    got = [None] * len(payloads)
    barrier = threading.Barrier(12)

    def worker(k):
        barrier.wait()
        for i in range(k, len(payloads), 12):
            got[i] = v.submit(payloads[i])

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == want
    c = v.counters()
    assert c["lanes_verified"] == len(payloads)
    assert c["dispatches"] < len(payloads)
    assert c["faults"] == 0
    assert v.verify_batch(payloads) == want


def test_a_launch_fault_raises_to_the_caller_and_is_counted(monkeypatch):
    v = verifier.DeviceVerifier(batch_max=4, device="cpu")
    monkeypatch.setattr(v, "_device_bits", lambda payloads: 1 / 0)
    challenge_stats.get_stats().reset()
    fresh = crypto.new_challenge_cookie_at(SECRET, NOW + 300, "1.2.3.4")
    solved = crypto.solve_challenge_for_testing(fresh, 8)
    for _ in range(3):
        with pytest.raises(RuntimeError, match="kernel C dispatch failed") as err:
            verifier.verify_sha_inv(SECRET, solved, NOW, "1.2.3.4", 8, v)
        assert isinstance(err.value.__cause__, ZeroDivisionError)
    with pytest.raises(ZeroDivisionError):
        v.verify_batch([b"\x00" * 52])
    assert v.counters() == {"dispatches": 0, "lanes_verified": 0, "faults": 4}
    assert challenge_stats.get_stats().verifications == {}
    # the verifier takes traffic again once the fault is gone
    monkeypatch.undo()
    verifier.verify_sha_inv(SECRET, solved, NOW, "1.2.3.4", 8, v)
    assert challenge_stats.get_stats().verifications == {("accept", "device"): 1}


def test_no_device_raises_without_a_gpu_and_a_bad_selftest_raises(monkeypatch):
    from banjax_tpu_torch.cli import build_decision_chain
    from banjax_tpu_torch.config import config_from_yaml_text
    from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
    from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
    from banjax_tpu_torch.effectors.banner import Banner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verifier.DeviceVerifier()
    cfg = config_from_yaml_text("challenge_device_verify: true\n")
    banner = Banner(DynamicDecisionLists(start_sweeper=False), None, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_decision_chain(cfg, banner, StaticDecisionLists(cfg))
    monkeypatch.setattr(pow_verify, "leading_zero_bits",
                        lambda msg: torch.zeros(msg.shape[0], dtype=torch.int32))
    with pytest.raises(RuntimeError, match="selftest mismatch"):
        verifier.DeviceVerifier(device="cpu")


def _failure_sequence(seed=11, n=900):
    """(ip, clock_ns) events: 300 IPs at cap 12, a few repeat offenders,
    and clock jumps past the 5 s interval."""
    rng = random.Random(seed)
    t = NOW * 10**9
    out = []
    for k in range(n):
        t += rng.randrange(1, 40_000_000)
        if k % 300 == 299:
            t += 6 * 10**9
        ip = f"10.{rng.randrange(2)}.{rng.randrange(8)}.{rng.randrange(20)}" \
            if rng.random() < 0.7 else f"66.6.0.{rng.randrange(6)}"
        out.append((ip, t))
    return out


def test_bounded_failure_state_matches_jax():
    cfg = types.SimpleNamespace(too_many_failed_challenges_interval_seconds=5,
                                too_many_failed_challenges_threshold=3)
    clock = [0]
    jax_states = jax_failures.BoundedFailedChallengeStates(12, now_ns_fn=lambda: clock[0])
    port_states = failures.BoundedFailedChallengeStates(12, now_ns_fn=lambda: clock[0])
    for k, (ip, t) in enumerate(_failure_sequence()):
        clock[0] = t
        a, b = jax_states.apply(ip, cfg), port_states.apply(ip, cfg)
        assert (int(a.match_type), a.exceeded) == (int(b.match_type), b.exceeded), k
        if k % 100 == 0:
            assert port_states.format_states() == jax_states.format_states(), k
    assert port_states.format_states() == jax_states.format_states()
    c = port_states.counters()
    assert c == jax_states.counters()
    assert len(port_states) == 12
    for key in ("evictions_total", "spill_writes", "spill_refills", "spill_drops",
                "gate_skips", "stale_drops"):
        assert c[key] > 0, key


def _submit_beside_verify_batch(v, n_threads=12):
    """n_threads callers submit 48 payloads while the test's thread runs
    verify_batch over 40 others; returns (submitted counts, batch counts,
    hashlib's for each)."""
    rng = random.Random(10)
    submitted = [bytes(rng.randrange(256) for _ in range(52)) for _ in range(48)]
    batched = [bytes(rng.randrange(256) for _ in range(52)) for _ in range(40)]
    got = [None] * len(submitted)
    barrier = threading.Barrier(n_threads + 1)

    def worker(k):
        barrier.wait()
        for i in range(k, len(submitted), n_threads):
            got[i] = v.submit(submitted[i])

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
    for t in threads:
        t.start()
    barrier.wait()
    batch_got = v.verify_batch(batched)
    for t in threads:
        t.join()
    return (got, batch_got, [verifier.cpu_zero_bits(p) for p in submitted],
            [verifier.cpu_zero_bits(p) for p in batched])


@pytest.mark.parametrize("batch_max", [16, 2])
def test_verify_batch_beside_12_submitting_threads_gets_hashlibs_counts(batch_max):
    v = verifier.DeviceVerifier(batch_max=batch_max, device="cpu")
    got, batch_got, want, batch_want = _submit_beside_verify_batch(v)
    assert got == want and batch_got == batch_want
    assert v.counters()["lanes_verified"] == len(want) + len(batch_want)
    assert v.counters()["faults"] == 0


def test_wrong_length_payloads_are_refused_with_the_pack_message():
    bad = [b"\x00" * 52, b"short"]
    with pytest.raises(ValueError) as pack_err:
        pow_verify.pack_payloads(bad, "cpu")
    v = _cpu_verifier()
    with pytest.raises(ValueError) as err:
        v.verify_batch(bad)
    assert str(err.value) == str(pack_err.value) == "payload 1: want 52 bytes, got 5"
    # the fault is the caller's, and the verifier takes traffic again
    assert v.verify_batch(bad[:1]) == [verifier.cpu_zero_bits(bad[0])]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_card_verifier_dispatches_through_its_pinned_slots(cuda_device):
    v = verifier.DeviceVerifier(batch_max=16, device=cuda_device)
    assert isinstance(v._dispatcher, pow_verify.PowDispatcher)
    launches = pow_verify.KERNEL.launches
    got, batch_got, want, batch_want = _submit_beside_verify_batch(v)
    assert got == want and batch_got == batch_want
    c = v.counters()
    assert c["lanes_verified"] == len(want) + len(batch_want) and c["faults"] == 0
    assert pow_verify.KERNEL.launches - launches == c["dispatches"]
    with pytest.raises(ValueError, match="payload 1: want 52 bytes, got 5"):
        v.verify_batch([b"\x00" * 52, b"short"])
