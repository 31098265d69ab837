"""Shared strict-base64 cookie decoding.

Go's base64.StdEncoding.DecodeString rejects any non-alphabet byte, which is
what makes the reference's '+'-mangled-to-' ' retry work
(challenge_response.go:75-84): the first decode FAILS on a space, then the
replace(' ', '+') retry succeeds. Python's default b64decode silently discards
non-alphabet bytes, so we must pass validate=True for the first attempt or
mangled cookies would decode to garbage instead of triggering the retry.
"""

from __future__ import annotations

import base64
from typing import Type


def decode_cookie_b64(cookie_string: str, error: Type[Exception], message: str) -> bytes:
    try:
        return base64.b64decode(cookie_string, validate=True)
    except (ValueError, TypeError):
        try:
            return base64.b64decode(cookie_string.replace(" ", "+"), validate=True)
        except (ValueError, TypeError):
            raise error(message) from None


def decode_strict_b64(payload: str) -> bytes:
    """Single-attempt strict decode (no space retry) — for payloads where the
    reference has no retry, e.g. the integrity cookie."""
    return base64.b64decode(payload, validate=True)
