"""`DeviceUAMatcher`: the port's `matcher/fused.py` against the serial
reference (`check_ua_decision`) and the JAX class (`backend="xla"`), on the
cases of the JAX unit test, tolerance 0. Kernel A runs its plain version
here; the card's launch is held against it under `@pytest.mark.cuda`."""

import numpy as np
import pytest
import torch

from banjax_tpu.decisions.ua_lists import build_ua_rules as jax_build_ua_rules
from banjax_tpu.matcher.fused import DeviceUAMatcher as JaxUAMatcher
from banjax_tpu.matcher.fused import ua_patterns_in_severity_order as jax_rows
from banjax_tpu_torch.decisions.model import Decision
from banjax_tpu_torch.decisions.ua_lists import build_ua_rules, check_ua_decision
from banjax_tpu_torch.matcher.fused import DeviceUAMatcher, ua_patterns_in_severity_order
from banjax_tpu_torch.matcher.kernels import nfa_match
from tests.test_torch_matcher import _one_torch_thread  # noqa: F401

RAW = {
    "allow": ["GoodBot", "curl/[78]"],
    "challenge": ["Mozilla/4", "scanner"],
    "nginx_block": [r"sqlmap|nikto", "BadBot/2.0"],
    "iptables_block": ["EvilBot"],
}

UAS = [
    "Mozilla/5.0 (X11; Linux x86_64)",
    "Mozilla/4.0 (compatible; MSIE 6.0)",
    "sqlmap/1.7-dev",
    "EvilBot scanner",          # iptables beats challenge (severity order)
    "GoodBot scanner",          # allow is checked LAST: challenge wins
    "curl/8.1.2",
    "BadBot/2.0 (+http://x)",
    "",
    "nothing notable",
]
# rows encode_for_match sends to the host: non-ASCII and over-long
HOST_ROWS = ["Mozilla/4.0 (Ünïcode) scanner", "x" * 300 + " EvilBot", "é"]
RATE_RULES = [r"GET /wp-login\.php", r"POST /xmlrpc\.php", r"(?i)sqlmap|nikto"]
LINES = [
    "GET example.com GET /wp-login.php HTTP/1.1 sqlmap/1.7",
    "POST example.com POST /xmlrpc.php HTTP/1.1 Mozilla/5.0",
    "GET example.com GET / HTTP/1.1 GoodBot",
    "GET example.com GET /wp-login.php HTTP/1.1 " + "Ü" * 4,
    "POST example.com POST /xmlrpc.php HTTP/1.1 " + "y" * 300,
]


def test_device_ua_matches_serial_reference_and_jax():
    rules = build_ua_rules(RAW)
    dm = DeviceUAMatcher(rules, backend="cpu")
    uas = UAS + HOST_ROWS
    got = dm.check_batch(uas)
    assert got == [check_ua_decision(rules, ua) for ua in uas]
    jax = JaxUAMatcher(jax_build_ua_rules(RAW), backend="xla")
    assert [(d and d.name, m) for d, m in got] == \
        [(d and d.name, m) for d, m in jax.check_batch(uas)]
    assert dm.host_eval_rows == len(HOST_ROWS)


def test_severity_order_flattening_equals_jax():
    rows = ua_patterns_in_severity_order(build_ua_rules(RAW))
    decisions = [d for d, _ in rows]
    assert decisions == sorted(decisions, reverse=True)  # severity descending
    assert [(d.name, rx) for d, rx in rows] == \
        [(d.name, rx) for d, rx in jax_rows(jax_build_ua_rules(RAW))]


def test_fused_extra_rules_share_the_pass_like_jax():
    """Columns [0, n_extra) are the rate rules, the rest the UA patterns;
    the bitmap equals the JAX class's, host rows and host rules included."""
    dm = DeviceUAMatcher(build_ua_rules(RAW), backend="cpu", extra_rules=RATE_RULES)
    jax = JaxUAMatcher(jax_build_ua_rules(RAW), backend="xla", extra_rules=RATE_RULES)
    bits = dm.match_bits(LINES)
    assert bits.dtype == np.uint8 and np.array_equal(bits, jax.match_bits(LINES))
    assert bits.shape[1] == len(RATE_RULES) + sum(len(v) for v in RAW.values())
    assert bits[0, 0] == 1 and bits[1, 1] == 1 and not bits[2, :2].any()
    ua = dm.decide(bits[:, len(RATE_RULES):])
    assert ua[0] == (Decision.NGINX_BLOCK, True) and ua[2] == (Decision.ALLOW, True)


def test_rate_columns_equal_a_rate_only_pass():
    from banjax_tpu_torch.matcher.encode import encode_for_match
    from banjax_tpu_torch.matcher.rulec import compile_rules

    dm = DeviceUAMatcher(build_ua_rules(RAW), backend="cpu", extra_rules=RATE_RULES[:2])
    lines = LINES[:3] * 5
    rate = compile_rules(RATE_RULES[:2], n_shards="auto")
    cls, lens, host = encode_for_match(rate, lines, 256)
    assert not host.any()
    want = nfa_match.match_bits(nfa_match.prepare(rate, torch.device("cpu")),
                                torch.from_numpy(cls), torch.from_numpy(lens)).numpy()
    assert np.array_equal(dm.match_bits(lines)[:, :2], want)


@pytest.mark.parametrize("backend", ["xla", "pallas", "pallas-interpret"])
def test_jax_backend_names_are_refused(backend):
    with pytest.raises(ValueError, match="JAX lowering"):
        DeviceUAMatcher(build_ua_rules(RAW), backend=backend)


def test_default_backend_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceUAMatcher(build_ua_rules(RAW))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel A runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_launches_kernel_a_and_matches_the_cpu(cuda_device):
    rules = build_ua_rules(RAW)
    card = DeviceUAMatcher(rules, backend=cuda_device, extra_rules=RATE_RULES)
    host = DeviceUAMatcher(rules, backend="cpu", extra_rules=RATE_RULES)
    before = nfa_match.KERNEL.launches
    assert np.array_equal(card.match_bits(LINES + UAS), host.match_bits(LINES + UAS))
    assert nfa_match.KERNEL.launches == before + 1
