"""Go net/url QueryUnescape and QueryEscape (copies of
`banjax_tpu/utils/goquery.py`'s).

The reference's cookie round trip depends on gin's exact behavior: cookie
values are QueryEscape'd when set and QueryUnescape'd when read (which turns
a literal '+' into ' ' — the bug the challenge-cookie parser works around,
challenge_response.go:77-84). Python's urllib quoting differs in error
handling: Go QueryUnescape FAILS on a malformed %-sequence (gin then treats
the cookie as absent), while urllib silently passes it through — so these
ports raise like Go does.
"""

from __future__ import annotations

from urllib.parse import quote_plus

_HEX = "0123456789abcdefABCDEF"


def go_query_unescape(s: str) -> str:
    """url.QueryUnescape: %XX decoded (error on malformed), '+' → ' '."""
    out = bytearray()
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c == "%":
            if i + 2 >= n:
                raise ValueError(f"invalid URL escape {s[i:i+3]!r}")
            h1, h2 = s[i + 1], s[i + 2]
            if h1 not in _HEX or h2 not in _HEX:
                raise ValueError(f"invalid URL escape {s[i:i+3]!r}")
            out.append(int(h1 + h2, 16))
            i += 3
        elif c == "+":
            out.append(0x20)
            i += 1
        else:
            out.extend(c.encode("utf-8"))
            i += 1
    return out.decode("utf-8", errors="surrogateescape")


def go_query_escape(s: str) -> str:
    """url.QueryEscape: unreserved kept, space → '+', the rest %XX.
    urllib's quote_plus over the utf-8 bytes is byte for byte the same
    (the same always-safe set ALPHA/DIGIT/"-_.~", '+' for space,
    uppercase hex)."""
    return quote_plus(s.encode("utf-8", errors="surrogateescape"))
