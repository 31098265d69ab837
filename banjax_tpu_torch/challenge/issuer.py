"""Stateless challenge issuance (a copy of `banjax_tpu/challenge/issuer.py`).

A challenge cookie is a PURE function of (secret, binding, expiry) —
hmac[20] ‖ zeros[32] ‖ expiry_be8, base64'd, the reference's exact wire
layout (crypto/challenge.py; byte-compatible with the unchanged
client-side JS solvers). Issuing one therefore holds zero per-IP state:
state enters only when a challenge is *failed* (challenge/failures.py).
The decision chain's 429 and 401 paths issue through `issue()`, which
crosses the `challenge.issue` failpoint: an armed one raises into the
server's fail-open middleware, as in JAX.
"""

from __future__ import annotations

import time
from typing import Optional

from banjax_tpu_torch.challenge import stats as challenge_stats
from banjax_tpu_torch.crypto.challenge import new_challenge_cookie_at
from banjax_tpu_torch.resilience import failpoints


def issue(
    secret_key: str,
    cookie_ttl_seconds: int,
    client_binding: str,
    now_unix: Optional[float] = None,
) -> str:
    """Issue one signed expiring challenge cookie."""
    failpoints.check("challenge.issue")
    now = time.time() if now_unix is None else now_unix
    cookie = new_challenge_cookie_at(secret_key, int(now) + cookie_ttl_seconds, client_binding)
    challenge_stats.get_stats().note_issued()
    return cookie
