"""Fused UA + path matching on the device (a port of
`banjax_tpu/matcher/fused.py`).

The reference checks User-Agent patterns serially per request in severity
order (user_agent_decision.go:55-64) and path/rate rules serially per log
line (regex_rate_limiter.go:216-269). Here both ruleset kinds compile into
ONE batched NFA: UA patterns (regexes as-is, substring patterns as escaped
literals) occupy columns after the rate rules, so a single pass of kernel
A over a line batch yields both the rate-rule bitmap and the UA bitmap —
`DeviceUAMatcher` then reduces the UA columns to the reference's
first-match-in-severity-order decision.

Kernel A runs through the port's wrapper (`matcher/kernels/nfa_match.py`):
launched on a CUDA device, its plain version on the CPU; nothing moves to
the host on the card. As in JAX, rows `encode_for_match` marks host_eval
(non-ASCII or longer than `max_len`) and rules the compiler cannot lower
are evaluated with Python `re` — the reference's semantics for what the
NFA cannot hold, not a fallback of the kernel.

Substring-vs-regex auto-detection follows ua_lists.contains_regex_metachar
exactly, so device results are differentially testable against
check_ua_decision (tests/test_torch_fused_ua.py).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from banjax_tpu_torch.decisions.model import Decision
from banjax_tpu_torch.decisions.ua_lists import _UA_CHECK_ORDER, UARules
from banjax_tpu_torch.device import DeviceLike, resolve_device
from banjax_tpu_torch.matcher.encode import encode_for_match
from banjax_tpu_torch.matcher.kernels import nfa_match
from banjax_tpu_torch.matcher.rulec import compile_rules


def ua_patterns_in_severity_order(rules: UARules) -> List[Tuple[Decision, str]]:
    """Flatten a UARules map into (decision, regex_string) rows in the exact
    order check_ua_decision scans them; substring patterns are escaped."""
    out: List[Tuple[Decision, str]] = []
    for d in _UA_CHECK_ORDER:
        for p in rules.get(d, ()):
            out.append((d, p.raw if p.compiled is not None else re.escape(p.raw)))
    return out


class DeviceUAMatcher:
    """Batched UA classification: one kernel-A pass, then severity-order argmax."""

    def __init__(self, rules: UARules, max_len: int = 256,
                 backend: DeviceLike = None, extra_rules: Sequence[str] = ()):
        """`backend` is where kernel A runs, as the port's `device`
        arguments take it: None, "cuda" or "cuda:N" launch the kernel on
        the card (raising when there is none); "cpu" runs the wrapper's
        plain PyTorch version. The JAX values ("xla", "pallas",
        "pallas-interpret") name JAX lowerings and are refused.

        `extra_rules` are regex strings (e.g. the rate rules) fused into
        the same compiled ruleset; their match bits come back separately
        from match_bits()."""
        if backend in ("xla", "pallas", "pallas-interpret", "auto"):
            raise ValueError(
                f"backend {backend!r} is a JAX lowering; the port takes a "
                "device: None or 'cuda' (kernel A on the card) or 'cpu'"
            )
        self.device = resolve_device(backend)
        self._rows = ua_patterns_in_severity_order(rules)
        self.n_extra = len(extra_rules)
        patterns = list(extra_rules) + [rx for _, rx in self._rows]
        self.compiled = compile_rules(patterns, n_shards="auto")
        self._decisions = [d for d, _ in self._rows]
        self.max_len = max_len
        self._prep = nfa_match.prepare(self.compiled, self.device)
        # rows and rules the NFA cannot hold: Python `re`, as in JAX
        self._host_rx = [re.compile(p) for p in patterns]
        self._host_rule_idx = [
            i for i in range(len(patterns)) if not self.compiled.device_ok[i]
        ]
        self.host_eval_rows = 0  # rows sent to the host by encode_for_match

    def match_bits(self, lines: Sequence[str]) -> np.ndarray:
        """[B, n_extra + n_ua_patterns] uint8 — the fused bitmap."""
        cls_ids, lens, host_eval = encode_for_match(
            self.compiled, lines, self.max_len
        )
        n = len(lines)
        bits = np.zeros((n, self.compiled.n_rules), dtype=np.uint8)
        rows = np.flatnonzero(~host_eval)
        if rows.size:
            cls_t = torch.from_numpy(
                np.ascontiguousarray(cls_ids[rows], dtype=np.int32)
            ).to(self.device)
            lens_t = torch.from_numpy(
                np.ascontiguousarray(lens[rows], dtype=np.int32)
            ).to(self.device)
            bits[rows] = nfa_match.match_bits(self._prep, cls_t, lens_t).cpu().numpy()
        host_rows = np.flatnonzero(host_eval)
        self.host_eval_rows += int(host_rows.size)
        for row in host_rows:
            for i, rx in enumerate(self._host_rx):
                if rx.search(lines[row]) is not None:
                    bits[row, i] = 1
        for i in self._host_rule_idx:
            rx = self._host_rx[i]
            for row in rows:
                if rx.search(lines[row]) is not None:
                    bits[row, i] = 1
        return bits

    def decide(self, ua_bits: np.ndarray) -> List[Tuple[Optional[Decision], bool]]:
        """Reduce UA columns (bitmap WITHOUT the extra-rule columns) to the
        reference's first-match-in-severity-order result per row."""
        out: List[Tuple[Optional[Decision], bool]] = []
        for row in ua_bits:
            hit = np.flatnonzero(row)
            if hit.size:
                out.append((self._decisions[int(hit[0])], True))
            else:
                out.append((None, False))
        return out

    def check_batch(self, user_agents: Sequence[str]) -> List[Tuple[Optional[Decision], bool]]:
        """Batched check_ua_decision (identical results, one device pass)."""
        bits = self.match_bits(user_agents)
        return self.decide(bits[:, self.n_extra:])
