"""The four-valued verdict and the sitewide SHA-inv fail action (copies of
`banjax_tpu/decisions/model.py`'s Decision and FailAction): Decision is
ordered Allow < Challenge < NginxBlock < IptablesBlock."""

from __future__ import annotations

import enum


class Decision(enum.IntEnum):
    ALLOW = 1
    CHALLENGE = 2
    NGINX_BLOCK = 3
    IPTABLES_BLOCK = 4

    def __str__(self) -> str:
        return _DECISION_TO_STRING[self]


_DECISION_TO_STRING = {
    Decision.ALLOW: "Allow",
    Decision.CHALLENGE: "Challenge",
    Decision.NGINX_BLOCK: "NginxBlock",
    Decision.IPTABLES_BLOCK: "IptablesBlock",
}

_STRING_TO_DECISION = {
    "allow": Decision.ALLOW,
    "challenge": Decision.CHALLENGE,
    "nginx_block": Decision.NGINX_BLOCK,
    "iptables_block": Decision.IPTABLES_BLOCK,
}


def parse_decision(s: str) -> Decision:
    try:
        return _STRING_TO_DECISION[s]
    except KeyError:
        raise ValueError(f"invalid decision: {s}") from None


class FailAction(enum.IntEnum):
    """What a sitewide SHA-inv challenge does on repeated failure
    (decision.go:68-85)."""

    BLOCK = 1
    NO_BLOCK = 2


_STRING_TO_FAIL_ACTION = {
    "block": FailAction.BLOCK,
    "no_block": FailAction.NO_BLOCK,
}


def parse_fail_action(s: str) -> FailAction:
    try:
        return _STRING_TO_FAIL_ACTION[s]
    except KeyError:
        raise ValueError(f"invalid fail action: {s}") from None
