"""The `/auth_request` decision chain of the port against the JAX
package's, exactly.

One scripted stream covers all nine chain steps (after
`tests/unit/test_decision_chain.py`'s scenarios) and the full reject
surface of the challenge plane (solved, under-target, expired, torn and
wrong-binding cookies, cookieless hits, repeats past the ban threshold).
It runs through JAX `decision_for_nginx` and through the port's chain
(`build_decision_chain(..., device="cpu")`, kernel C's plain version),
with the clock, the session-id draws and the ban-log time pinned in both.
Compared: each response's status, headers, set-cookies, content type and
body bytes, `DecisionForNginxResult.to_json()`, the ban-log bytes (both
files), the failure state's `format_states` and counters, and the
dynamic lists.

The JAX chain verifies on its host oracle (`challenge_verifier=None`):
the JAX package's own differential suite holds its device path equal to
that oracle, and its Pallas kernel in interpret mode does not finish
within minutes on a CPU. The second test runs the log path into the
chain: TorchMatcher and the JAX TpuMatcher (pallas-interpret) consume
the same `challengeme` lines, and the two chains then answer the same
requests identically."""

import base64
import hashlib
import io
import json
import random
import time

import pytest
import torch
import yaml

from banjax_tpu.challenge.failures import BoundedFailedChallengeStates as JaxBounded
from banjax_tpu.config.holder import _PAGES_DIR as JAX_PAGES
from banjax_tpu.config.schema import config_from_yaml_text as jax_config
from banjax_tpu.crypto.challenge import (
    count_zero_bits_from_left,
    new_challenge_cookie_at,
    parse_cookie,
    solve_challenge_for_testing,
)
from banjax_tpu.decisions.dynamic_lists import DynamicDecisionLists as JaxDynamic
from banjax_tpu.decisions.model import Decision as JaxDecision
from banjax_tpu.decisions.protected_paths import PasswordProtectedPaths as JaxPaths
from banjax_tpu.decisions.static_lists import StaticDecisionLists as JaxStatic
from banjax_tpu.effectors.banner import Banner as JaxBanner
from banjax_tpu.httpapi import decision_chain as jax_chain
from banjax_tpu.decisions.rate_limit import RegexRateLimitStates
from banjax_tpu.matcher.runner import TpuMatcher
from banjax_tpu_torch.cli import build_decision_chain, build_matcher
from banjax_tpu_torch.config import config_from_yaml_text, load_pages
from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
from banjax_tpu_torch.decisions.model import Decision
from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
from banjax_tpu_torch.effectors.banner import Banner
from banjax_tpu_torch.httpapi import decision_chain

SECRET = "chain-secret"
BITS = 8
NOW = 1_760_000_000.0
PASSWORD_HASH = hashlib.sha256(b"password").hexdigest()
SUB_HASH = hashlib.sha256(b"sub-password").hexdigest()

CONFIG_YAML = f"""
global_decision_lists:
  allow: [20.20.20.20]
  nginx_block: [70.80.90.100]
  challenge: [8.8.8.8]
  iptables_block: [30.0.0.0/8]
per_site_decision_lists:
  example.com:
    allow: [90.90.90.90]
    challenge: [91.91.91.91, 44.44.0.0/16]
    nginx_block: [92.92.92.92]
per_site_user_agent_decision_lists:
  example.com:
    allow: [GoodBot]
    challenge: ['Chall.*Bot']
    nginx_block: [EvilBot]
global_user_agent_decision_lists:
  nginx_block: [BadBot]
  challenge: [curl]
password_protected_paths:
  example.com: [wp-admin]
  sub.example.com: [private]
  nohash.com: [locked]
password_protected_path_exceptions:
  example.com: [wp-admin/admin-ajax.php]
  shainv.com: [open]
password_hashes:
  example.com: {PASSWORD_HASH}
  sub.example.com: {SUB_HASH}
password_hash_roaming:
  sub.example.com: example.com
password_persite_cookie_ttl_seconds:
  sub.example.com: 600
sitewide_sha_inv_list:
  shainv.com: block
  noblock.com: no_block
  uabind.com: block
  quiet.com: block
use_user_agent_in_cookie:
  uabind.com: true
sha_inv_path_exceptions:
  example.com: [/no_challenge]
sites_to_disable_baskerville:
  nobask.com: true
disable_logging:
  quiet.com: true
iptables_ban_seconds: 10
expiring_decision_ttl_seconds: 30
too_many_failed_challenges_interval_seconds: 10
too_many_failed_challenges_threshold: 2
password_cookie_ttl_seconds: 14400
sha_inv_cookie_ttl_seconds: 14400
sha_inv_expected_zero_bits: {BITS}
hmac_secret: {SECRET}
session_cookie_hmac_secret: session_secret
session_cookie_ttl_seconds: 3600
disable_kafka: true
challenge_device_verify: true
challenge_verify_batch_max: 8
challenge_failure_state_max: 6
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers, and the timing-sensitive tests beside these need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Clock:
    def __init__(self, t):
        self.t = t


@pytest.fixture
def pinned(monkeypatch):
    """The clock, the session-id draws and the ban-log time, pinned the
    same way for both packages; `reset()` restarts the clock and draws."""
    clock = Clock(NOW)
    rng = [random.Random(1)]
    monkeypatch.setattr(time, "time", lambda: clock.t)
    monkeypatch.setattr(time, "time_ns", lambda: int(clock.t * 1e9))
    monkeypatch.setattr("secrets.randbits", lambda k: rng[0].getrandbits(k))
    for mod in ("banjax_tpu.effectors.banner", "banjax_tpu_torch.effectors.banner"):
        monkeypatch.setattr(f"{mod}._format_ban_time", lambda t: "2026-01-01T00:00:00")

    def reset():
        clock.t = NOW
        rng[0] = random.Random(1)

    clock.reset = reset
    return clock


# ---------------------------------------------------------------- builders


def _jax_state(yaml_text, banner=None):
    cfg = jax_config(yaml_text)
    cfg.challenger_bytes = (JAX_PAGES / "sha-inverse-challenge.html").read_bytes()
    cfg.password_page_bytes = (JAX_PAGES / "password-protected-path.html").read_bytes()
    logs = (io.StringIO(), io.StringIO())
    if banner is None:
        banner = JaxBanner(JaxDynamic(start_sweeper=False), *logs, ipset_instance=None)
    else:
        logs = (banner._ban_log, banner._ban_log_temp)
    state = jax_chain.ChainState(
        config=cfg, static_lists=JaxStatic(cfg), dynamic_lists=banner.decision_lists,
        protected_paths=JaxPaths(cfg),
        failed_challenge_states=JaxBounded(cfg.challenge_failure_state_max,
                                           now_ns_fn=lambda: time.time_ns()),
        banner=banner, challenge_verifier=None,
    )
    return state, logs


def _port_state(yaml_text, banner=None):
    cfg = load_pages(config_from_yaml_text(yaml_text))
    if banner is None:
        banner = Banner(DynamicDecisionLists(start_sweeper=False), io.StringIO(), io.StringIO())
    state = build_decision_chain(cfg, banner, StaticDecisionLists(cfg), device="cpu")
    return state, (banner._ban_log, banner._ban_log_temp)


def _solved(binding, bits=BITS, expiry=NOW + 300):
    return solve_challenge_for_testing(new_challenge_cookie_at(SECRET, int(expiry), binding), bits)


def _under_target(binding):
    raw = bytearray(base64.standard_b64decode(new_challenge_cookie_at(SECRET, int(NOW + 300), binding)))
    for counter in range(1 << 16):
        raw[44:52] = counter.to_bytes(8, "big")
        if count_zero_bits_from_left(hashlib.sha256(bytes(raw[:52])).digest()) < BITS:
            return base64.standard_b64encode(bytes(raw)).decode()
    raise AssertionError("no under-target solution")


def _password_cookie(binding, password):
    hmac_b, _, expiry = parse_cookie(new_challenge_cookie_at(SECRET, int(NOW + 300), binding))
    solution = hashlib.sha256(hmac_b + hashlib.sha256(password).digest()).digest()
    return base64.standard_b64encode(hmac_b + solution + expiry).decode()


def _req(ip, host="nothing.com", path="/", ua="mozilla", method="GET", **cookies):
    return ("req", dict(client_ip=ip, requested_host=host, requested_path=path,
                        client_user_agent=ua, method=method, cookies=cookies))


C = "deflect_challenge3"
PW = "deflect_password3"
SESSION = "deflect_session"


def _script():
    s = []
    # 9. default allow, and the session cookie endpoint (valid, bad, new)
    s.append(_req("1.1.1.1"))
    s.append(("reuse_session", "1.1.1.1"))
    s.append(_req("1.1.1.1", **{SESSION: "garbage%zz"}))
    # 1. priority pass with a password cookie (own hash, roaming hash)
    s.append(_req("2.2.2.2", "example.com", "/anything", **{PW: _password_cookie("2.2.2.2", b"password")}))
    s.append(_req("2.2.2.3", "sub.example.com", "/x", **{PW: _password_cookie("2.2.2.3", b"sub-password")}))
    # 2. protected paths: exception, no cookie, bad cookie, roaming pass,
    #    a host with no hash, and an allowlisted IP failing past the threshold
    s.append(_req("3.3.3.3", "example.com", "/wp-admin/admin-ajax.php"))
    s.append(_req("3.3.3.3", "example.com", "/wp-admin/"))
    s.append(_req("3.3.3.3", "example.com", "/wp-admin/x", **{PW: _password_cookie("3.3.3.3", b"nope")}))
    s.append(_req("3.3.3.4", "sub.example.com", "/private/a", **{PW: _password_cookie("3.3.3.4", b"password")}))
    s.append(_req("3.3.3.5", "sub.example.com", "/private/a"))
    s.append(_req("3.3.3.6", "nohash.com", "/locked", **{PW: "x"}))
    for _ in range(4):
        s.append(_req("90.90.90.90", "example.com", "/wp-admin"))
    # 3. per-site IP list: allow, challenge (exact and CIDR), block
    s.append(_req("90.90.90.90", "example.com"))
    s.append(_req("92.92.92.92", "example.com"))
    s.append(_req("91.91.91.91", "example.com"))
    s.append(_req("91.91.91.91", "example.com", **{C: _solved("91.91.91.91")}))
    s.append(_req("44.44.1.2", "example.com", **{C: _under_target("44.44.1.2")}))
    # 4. per-site UA list
    s.append(_req("4.4.4.1", "example.com", ua="GoodBot/1.0"))
    s.append(_req("4.4.4.2", "example.com", ua="ChallengeBot"))
    s.append(_req("4.4.4.3", "example.com", ua="EvilBot"))
    # 5. global IP list (exact and CIDR)
    s.append(_req("20.20.20.20"))
    s.append(_req("70.80.90.100"))
    s.append(_req("8.8.8.8", "x.com", **{C: _solved("8.8.8.8")}))
    s.append(_req("30.1.2.3"))
    # 6. global UA list
    s.append(_req("6.6.6.1", ua="BadBot"))
    s.append(_req("6.6.6.2", ua="curl/8.0"))
    # 7. expiring lists: ban-fed entries, path exception, baskerville
    #    fall-through, the session id first, lazy expiry
    s.append(("ban", "7.7.7.1", Decision.CHALLENGE, "example.com"))
    s.append(("ban", "7.7.7.2", Decision.NGINX_BLOCK, "example.com"))
    s.append(("ban", "7.7.7.3", Decision.ALLOW, "example.com"))
    s.append(("basker", "7.7.7.4", Decision.CHALLENGE, "nobask.com"))
    s.append(("basker", "7.7.7.5", Decision.IPTABLES_BLOCK, "nobask.com"))
    s.append(("session", "7.7.7.6", "sess-77", Decision.NGINX_BLOCK, "example.com"))
    s.append(_req("7.7.7.1", "example.com"))
    s.append(_req("7.7.7.1", "example.com", "/no_challenge/x"))
    s.append(_req("7.7.7.1", "example.com", **{C: _solved("7.7.7.1")}))
    s.append(_req("7.7.7.2", "example.com"))
    s.append(_req("7.7.7.3", "example.com"))
    s.append(_req("7.7.7.4", "nobask.com"))
    s.append(_req("7.7.7.5", "nobask.com"))
    s.append(_req("7.7.7.9", "example.com", **{SESSION: "sess-77"}))
    # 8. sitewide SHA-inv: the full reject surface, repeats past the
    #    threshold (ban, then the expiring block), no_block, the password
    #    exception, UA binding, a disable_logging host
    kinds = {
        "solved": lambda ip: _solved(ip),
        "under": _under_target,
        "expired": lambda ip: _solved(ip, expiry=NOW - 10),
        "torn": lambda ip: _solved(ip)[:40],
        "wrong": lambda ip: _solved("9.9.9.9"),
        "none": lambda ip: None,
    }
    for k, (kind, make) in enumerate(kinds.items()):
        ip = f"88.0.0.{k}"
        cookie = make(ip)
        for _ in range(1 if kind == "solved" else 4):
            s.append(_req(ip, "shainv.com", "/login", **({} if cookie is None else {C: cookie})))
    s.append(_req("88.1.0.1", "shainv.com", "/open"))
    for _ in range(4):
        s.append(_req("88.2.0.1", "noblock.com", "/", **{C: _under_target("88.2.0.1")}))
    s.append(_req("88.3.0.1", "uabind.com", ua="UA-bound", **{C: _solved("UA-bound")}))
    s.append(_req("88.3.0.2", "uabind.com", ua="UA-bound", **{C: _solved("88.3.0.2")}))
    s.append(_req("88.3.0.3", "uabind.com", ua="other"))
    integrity = base64.b64encode(b'{"webdriver": true, "cpu": 2}').decode()
    for _ in range(3):
        s.append(_req("88.4.0.1", "quiet.com", "/q", **{"deflect_integrity": integrity}))
    # eviction pressure on the bounded failure state (cap 6), then the
    # clock moves: the failed-challenge window and the expiring entries end
    for k in range(10):
        s.append(_req(f"88.5.0.{k}", "shainv.com"))
    s.append(("advance", 31))
    s.append(_req("88.3.0.1", "shainv.com"))   # banned earlier, ban expired
    s.append(_req("7.7.7.2", "example.com"))
    s.append(_req("88.0.1.0", "shainv.com", **{C: _solved("88.0.1.0")}))
    return s


def _snapshot(resp, result):
    return (resp.status, dict(resp.headers), resp.content_type, resp.body,
            [vars(c) for c in resp.cookies], result.to_json())


def _dyn(dyn):
    rows = lambda d: sorted((k, int(e.decision), e.expires, e.ip_address, e.from_baskerville,
                             e.domain) for k, e in d.items())
    return rows(dyn._by_ip), rows(dyn._by_session_id)


def _run(state, logs, script, req_cls, decide, decision_type, clock):
    out = []
    last_session = {}
    for step in script:
        kind = step[0]
        if kind == "req":
            r = req_cls(**step[1])
            resp, result = decide(state, r)
            last_session[r.client_ip] = resp.headers.get("X-Deflect-Session")
            out.append(_snapshot(resp, result))
        elif kind == "reuse_session":
            r = req_cls(client_ip=step[1], requested_host="nothing.com", requested_path="/",
                        client_user_agent="mozilla", cookies={SESSION: last_session[step[1]]})
            resp, result = decide(state, r)
            assert resp.headers["X-Deflect-Session-New"] == "false"
            out.append(_snapshot(resp, result))
        elif kind == "ban":
            state.banner.ban_or_challenge_ip(state.config, step[1], decision_type(int(step[2])), step[3])
        elif kind == "basker":
            state.dynamic_lists.update(step[1], clock.t + 30, decision_type(int(step[2])), True, step[3])
        elif kind == "session":
            state.dynamic_lists.update_by_session_id(
                step[1], step[2], clock.t + 30, decision_type(int(step[3])), False, step[4])
        elif kind == "advance":
            clock.t += step[1]
    return out, logs[0].getvalue(), logs[1].getvalue()


def test_scripted_stream_is_identical_to_the_jax_chain(pinned):
    script = _script()
    jax_state, jax_logs = _jax_state(CONFIG_YAML)
    want = _run(jax_state, jax_logs, script, jax_chain.RequestInfo,
                jax_chain.decision_for_nginx, JaxDecision, pinned)
    pinned.reset()
    port_state, port_logs = _port_state(CONFIG_YAML)
    got = _run(port_state, port_logs, script, decision_chain.RequestInfo,
               decision_chain.decision_for_nginx, Decision, pinned)

    for k, (a, b) in enumerate(zip(got[0], want[0])):
        assert a == b, (k, a[-1], b[-1])
    assert len(got[0]) == len(want[0])
    assert got[1:] == want[1:]                      # both ban logs, byte for byte
    fs_port, fs_jax = port_state.failed_challenge_states, jax_state.failed_challenge_states
    assert fs_port.format_states() == fs_jax.format_states()
    assert fs_port.counters() == fs_jax.counters()
    assert _dyn(port_state.dynamic_lists) == _dyn(jax_state.dynamic_lists)

    # non-vacuous: every chain step answered, bans in both logs, the card's
    # stand-in verified, the failure state evicted
    results = {json.loads(r[-1])["DecisionListResult"] for r in got[0]}
    for name in ("PasswordProtectedPriorityPass", "PasswordProtectedPath",
                 "PasswordProtectedPathException", "PerSiteAccessGranted",
                 "PerSiteChallenge", "PerSiteBlock", "PerSiteUAAccessGranted",
                 "PerSiteUAChallenge", "PerSiteUABlock", "GlobalAccessGranted",
                 "GlobalChallenge", "GlobalBlock", "GlobalUAChallenge", "GlobalUABlock",
                 "ExpiringAccessGranted", "ExpiringChallenge", "ExpiringBlock",
                 "PerSiteShaInvPathException", "SiteWideChallenge",
                 "SiteWideChallengeException", "NoMention"):
        assert name in results, name
    assert got[1].count("\n") >= 5 and got[2].count("\n") == 1
    assert '"action":"NginxBlock"' in got[1] and '"trigger":"failed challenge password"' in got[1]
    assert port_state.challenge_verifier.lanes_verified > 5
    assert fs_port.counters()["evictions_total"] > 0


def _deploy_yaml():
    """The deploy configuration's rules and challenge keys, with the
    port's CPU-test matcher keys and a secret (the deploy file's
    `challenge_cookie_secret` is not a key the schema reads)."""
    with open("deploy/banjax-config.yaml") as f:
        raw = yaml.safe_load(f)
    raw.update(
        matcher_native_parse=False,
        slotmgr_native=False, traffic_sketch_enabled=False,
        slot_admission_enabled=False, warm_tier_enabled=False,
        matcher_batch_lines=64, matcher_max_line_len=128,
        hmac_secret=SECRET, sha_inv_expected_zero_bits=BITS,
        challenge_verify_batch_max=8,
    )
    return yaml.safe_dump(raw)


def test_deploy_config_signs_with_an_empty_hmac_secret():
    """A finding on the reference side, pinned in both packages: the
    deploy file sets `challenge_cookie_secret`, which no schema reads."""
    with open("deploy/banjax-config.yaml") as f:
        text = f.read()
    assert "challenge_cookie_secret" in text
    assert config_from_yaml_text(text).hmac_secret == jax_config(text).hmac_secret == ""


def test_log_path_challenges_reach_the_chain_identically(pinned):
    yaml_text = _deploy_yaml()
    ips = [f"10.20.0.{k}" for k in range(8)]
    lines = [f"{NOW - 2 + 0.01 * k:f} {ip} GET example.org GET /challengeme?k={k} HTTP/1.1 ua -"
             for k, ip in enumerate(ips)]
    lines += [f"{NOW - 1:f} 10.21.0.{k} GET example.org GET /benign HTTP/1.1 ua -" for k in range(8)]

    jax_banner = JaxBanner(JaxDynamic(start_sweeper=False), io.StringIO(), io.StringIO(),
                           ipset_instance=None)
    jcfg = jax_config(yaml_text)
    jcfg.matcher_backend = "pallas-interpret"  # the JAX side's; the port refuses it
    TpuMatcher(jcfg, jax_banner, JaxStatic(jcfg), RegexRateLimitStates()).consume_lines(
        lines, now_unix=NOW)
    jax_state, jax_logs = _jax_state(yaml_text, jax_banner)

    port_banner = Banner(DynamicDecisionLists(start_sweeper=False), io.StringIO(), io.StringIO())
    pcfg = config_from_yaml_text(yaml_text)
    build_matcher(pcfg, port_banner, StaticDecisionLists(pcfg), device="cpu").consume_lines(
        lines, now_unix=NOW)
    port_state, port_logs = _port_state(yaml_text, port_banner)
    assert _dyn(port_state.dynamic_lists) == _dyn(jax_state.dynamic_lists)
    assert [e[0] for e in _dyn(port_state.dynamic_lists)[0]] == sorted(ips)

    script = []
    for ip in ips:
        script += [_req(ip, "example.org", "/page"),
                   _req(ip, "example.org", "/page", **{C: _solved(ip)})]
    script.append(_req("10.21.0.1", "example.org"))
    pinned.reset()
    want = _run(jax_state, jax_logs, script, jax_chain.RequestInfo,
                jax_chain.decision_for_nginx, JaxDecision, pinned)
    pinned.reset()
    got = _run(port_state, port_logs, script, decision_chain.RequestInfo,
               decision_chain.decision_for_nginx, Decision, pinned)
    assert got == want
    assert [r[0] for r in got[0]] == [429, 200] * len(ips) + [200]
    assert all('"ExpiringChallenge"' in r[-1] for r in got[0][:-1])
    assert _dyn(port_state.dynamic_lists) == _dyn(jax_state.dynamic_lists)
