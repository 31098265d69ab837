"""Challenge-cookie crypto: SHA-inverting proof-of-work and password cookies.

Reference behavior (Go banjax): internal/challenge_response.go — the
cookie format is base64(hmac[20] ‖ solution[32] ‖ expiry_unix_be[8]); the KDF
is sha256(secret); the MAC is HMAC-SHA1(derived_key, expiry_be8 ‖ binding)
where the binding is the client IP or the User-Agent (per
use_user_agent_in_cookie). PoW validity = count-leading-zero-bits(
sha256(hmac ‖ solution)) ≥ sha_inv_expected_zero_bits; password validity =
solution == sha256(hmac ‖ sha256(password)). Cookies must interoperate with
the unchanged client-side JS solvers, so every byte layout here is part of
the wire contract. A copy of `banjax_tpu/crypto/challenge.py`.
"""

from __future__ import annotations

import base64
import hashlib
import hmac as hmac_mod
import struct
import time
from typing import Tuple

from banjax_tpu_torch.crypto._b64 import decode_cookie_b64

COOKIE_BYTE_LENGTH = 20 + 32 + 8


class CookieError(ValueError):
    pass


def compute_hmac(secret_key: str, expire_time_unix: int, client_binding: str) -> bytes:
    """challenge_response.go:23-35 — HMAC-SHA1(sha256(secret), expiry_be8 ‖ binding)."""
    derived_key = hashlib.sha256(secret_key.encode()).digest()
    expire_bytes = struct.pack(">Q", expire_time_unix & 0xFFFFFFFFFFFFFFFF)
    mac = hmac_mod.new(derived_key, digestmod=hashlib.sha1)
    mac.update(expire_bytes)
    mac.update(client_binding.encode())
    return mac.digest()


def count_zero_bits_from_left(data: bytes) -> int:
    """challenge_response.go:37-49 — leading-zero-bit count of the digest.

    O(1) big-int form of the reference's per-byte/per-bit loop: the
    leading-zero run is len*8 - bit_length of the value, identical to the
    loop for every byte pattern (tests/unit/test_challenge_crypto.py proves
    it exhaustively against the retained reference loop)."""
    value = int.from_bytes(data, "big")
    return len(data) * 8 - value.bit_length()


def parse_cookie(cookie_string: str) -> Tuple[bytes, bytes, bytes]:
    """Split a base64 cookie into (hmac, solution, expiration) —
    challenge_response.go:71-99, including the '+' → ' ' URL-unescape
    workaround for cookie values that crossed a query-unescaping proxy."""
    cookie_bytes = decode_cookie_b64(cookie_string, CookieError, "bad base64")

    if len(cookie_bytes) != COOKIE_BYTE_LENGTH:
        raise CookieError("bad length")

    return cookie_bytes[0:20], cookie_bytes[20:52], cookie_bytes[52:60]


def validate_expiration_and_hmac(
    secret_key: str,
    expiration_bytes: bytes,
    now_time_unix: float,
    hmac_from_client: bytes,
    client_binding: str,
) -> int:
    """challenge_response.go:51-69; returns the expiry unix time on success."""
    (expiration_int,) = struct.unpack(">Q", expiration_bytes)
    # float compare: Go compares with ns precision (challenge_response.go:59)
    if expiration_int < now_time_unix:
        raise CookieError(f"expiration time is in the past: {expiration_int}")
    expected = compute_hmac(secret_key, expiration_int, client_binding)
    if not hmac_mod.compare_digest(expected, hmac_from_client):
        raise CookieError("hmac not what it should be")
    return expiration_int


def validate_sha_inv_cookie(
    secret_key: str,
    cookie_string: str,
    now_time_unix: float,
    client_binding: str,
    expected_zero_bits: int,
) -> None:
    """challenge_response.go:101-131. Raises CookieError when invalid."""
    hmac_from_client, solution_bytes, expiration_bytes = parse_cookie(cookie_string)
    validate_expiration_and_hmac(
        secret_key, expiration_bytes, now_time_unix, hmac_from_client, client_binding
    )
    digest = hashlib.sha256(hmac_from_client + solution_bytes).digest()
    actual_zero_bits = count_zero_bits_from_left(digest)
    if actual_zero_bits < expected_zero_bits:
        raise CookieError(
            f"not enough zero bits in hash: expected {expected_zero_bits}, found {actual_zero_bits}"
        )


def validate_password_cookie(
    secret_key: str,
    cookie_string: str,
    now_time_unix: float,
    client_binding: str,
    hashed_password: bytes,
) -> None:
    """challenge_response.go:141-177 — solution must equal
    sha256(hmac ‖ sha256(password)). Raises CookieError when invalid."""
    hmac_from_client, solution_bytes, expiration_bytes = parse_cookie(cookie_string)
    validate_expiration_and_hmac(
        secret_key, expiration_bytes, now_time_unix, hmac_from_client, client_binding
    )
    expected_solution = hashlib.sha256(hmac_from_client + hashed_password).digest()
    if not hmac_mod.compare_digest(expected_solution, solution_bytes):
        raise CookieError("bad password")


def new_challenge_cookie_at(
    secret_key: str, expire_time_unix: int, client_binding: str
) -> str:
    """Deterministic issuance primitive: the cookie is a pure function of
    (secret, binding, expiry) — hmac[20] ‖ zeros[32] ‖ expiry_be8.  The
    stateless issuer (challenge/issuer.py) builds on this."""
    hmac_bytes = compute_hmac(secret_key, expire_time_unix, client_binding)
    cookie_bytes = (
        hmac_bytes[0:20] + b"\x00" * 32
        + struct.pack(">Q", expire_time_unix & 0xFFFFFFFFFFFFFFFF)
    )
    return base64.standard_b64encode(cookie_bytes).decode()


def new_challenge_cookie(secret_key: str, cookie_ttl_seconds: int, client_binding: str) -> str:
    """challenge_response.go:179-188 — hmac[20] ‖ zeros[32] ‖ expiry_be8."""
    expire_time = int(time.time()) + cookie_ttl_seconds
    return new_challenge_cookie_at(secret_key, expire_time, client_binding)


def solve_challenge_for_testing(cookie_string: str, zero_bits: int = 10) -> str:
    """Test-only PoW solver (challenge_response.go:190-215): brute-force an
    8-byte big-endian counter into bytes 44..52 until sha256(first 52 bytes)
    has ≥ zero_bits leading zero bits."""
    cookie_bytes = bytearray(base64.standard_b64decode(cookie_string))
    counter = 0
    while True:
        cookie_bytes[44:52] = struct.pack(">Q", counter)
        digest = hashlib.sha256(bytes(cookie_bytes[0:52])).digest()
        if count_zero_bits_from_left(digest) >= zero_bits:
            break
        counter += 1
    return base64.standard_b64encode(bytes(cookie_bytes)).decode()
