"""User-Agent decision lists.

Reference behavior (Go banjax): internal/user_agent_decision.go:17-96 —
each configured pattern is auto-detected as a regex (if it contains any of the
metacharacters ``\\.+*?[]{}()|^$``) or a plain substring; regexes pre-compile
at config load (bad ones fail the load). Matching iterates decisions in
severity order IptablesBlock → NginxBlock → Challenge → Allow; first matching
pattern wins.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from banjax_tpu_torch.decisions.model import Decision, parse_decision
from banjax_tpu_torch.matcher.re2check import check_re2_compatible

_METACHARS = set("\\.+*?[]{}()|^$")

# Severity order checked by check_ua_decision (user_agent_decision.go:56).
_UA_CHECK_ORDER = (
    Decision.IPTABLES_BLOCK,
    Decision.NGINX_BLOCK,
    Decision.CHALLENGE,
    Decision.ALLOW,
)


class UAPattern:
    """A pre-compiled optional regex alongside the raw pattern string."""

    __slots__ = ("raw", "compiled")

    def __init__(self, raw: str):
        self.raw = raw
        if contains_regex_metachar(raw):
            check_re2_compatible(raw)
            try:
                self.compiled: Optional["re.Pattern[str]"] = re.compile(raw)
            except re.error as e:
                raise ValueError(f"invalid UA regex pattern {raw!r}: {e}") from None
        else:
            self.compiled = None

    def matches(self, user_agent: str) -> bool:
        if self.compiled is not None:
            return self.compiled.search(user_agent) is not None
        return self.raw in user_agent


def contains_regex_metachar(s: str) -> bool:
    return any(ch in _METACHARS for ch in s)


UARules = Dict[Decision, List[UAPattern]]


def check_ua_decision(rules: UARules, user_agent: str) -> Tuple[Optional[Decision], bool]:
    """First match in severity order wins (user_agent_decision.go:55-64)."""
    for d in _UA_CHECK_ORDER:
        for p in rules.get(d, ()):
            if p.matches(user_agent):
                return d, True
    return None, False


def build_ua_rules(raw: Dict[str, List[str]]) -> UARules:
    """decision-string → patterns, from a config map (user_agent_decision.go:67-83)."""
    out: UARules = {}
    for decision_string, patterns in raw.items():
        decision = parse_decision(decision_string)
        for raw_pattern in patterns or []:
            out.setdefault(decision, []).append(UAPattern(raw_pattern))
    return out


def build_per_site_ua_rules(
    raw: Dict[str, Dict[str, List[str]]],
) -> Dict[str, UARules]:
    out: Dict[str, UARules] = {}
    for site, decision_to_patterns in raw.items():
        try:
            out[site] = build_ua_rules(decision_to_patterns)
        except ValueError as e:
            raise ValueError(f"per_site_user_agent_decision_lists[{site}]: {e}") from None
    return out
