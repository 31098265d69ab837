"""Session cookie: the 16-byte per-client session ID issued on every response.

Reference behavior (Go banjax): internal/session_cookie.go — cookie =
base64(hmac[4] ‖ random_id[4] ‖ expiry_unix_be[8]); the MAC is HMAC-SHA1(
sha256(secret), expiry_be8 ‖ client_ip ‖ id_be4) truncated to 4 bytes. The
session ID is the key the Kafka `*_session` commands target, and it is
surfaced to Nginx logs via X-Deflect-Session / X-Deflect-Session-New headers.
"""

from __future__ import annotations

import base64
import hashlib
import hmac as hmac_mod
import secrets
import struct
import time

from banjax_tpu_torch.crypto._b64 import decode_cookie_b64

SESSION_COOKIE_NAME = "deflect_session"
EXPIRE_TIME_BYTE_LENGTH = 8
ID_BYTE_LENGTH = 4
HMAC_BYTE_LENGTH = 4
SESSION_ID_LENGTH = EXPIRE_TIME_BYTE_LENGTH + ID_BYTE_LENGTH + HMAC_BYTE_LENGTH


class SessionCookieError(ValueError):
    pass


# the sha256-derived key depends only on the config secret — memoized so
# the per-response cookie pays one HMAC, not HMAC + SHA256 (single entry:
# the secret changes only on config reload)
_derived_key_cache: tuple = ("", b"")


def _derived_key(secret_key: str) -> bytes:
    global _derived_key_cache
    cached_secret, cached = _derived_key_cache
    if cached_secret == secret_key:
        return cached
    key = hashlib.sha256(secret_key.encode()).digest()
    _derived_key_cache = (secret_key, key)
    return key


def _session_cookie_hmac(secret_key: str, expire_time_unix: int, client_ip: str, id_value: int) -> bytes:
    """session_cookie.go:40-55."""
    mac = hmac_mod.new(_derived_key(secret_key), digestmod=hashlib.sha1)
    mac.update(struct.pack(">Q", expire_time_unix & 0xFFFFFFFFFFFFFFFF))
    mac.update(client_ip.encode())
    mac.update(struct.pack(">I", id_value & 0xFFFFFFFF))
    return mac.digest()[0:HMAC_BYTE_LENGTH]


def new_session_cookie(secret_key: str, cookie_ttl_seconds: int, client_ip: str) -> str:
    """session_cookie.go:57-67."""
    expire_time = int(time.time()) + cookie_ttl_seconds
    id_value = secrets.randbits(32)
    hmac_bytes = _session_cookie_hmac(secret_key, expire_time, client_ip, id_value)
    cookie_bytes = (
        hmac_bytes
        + struct.pack(">I", id_value)
        + struct.pack(">Q", expire_time)
    )
    return base64.standard_b64encode(cookie_bytes).decode()


def validate_session_cookie(
    cookie_string: str, secret_key: str, now_time_unix: float, client_ip: str
) -> None:
    """session_cookie.go:69-104. Raises SessionCookieError when invalid."""
    cookie_bytes = decode_cookie_b64(
        cookie_string, SessionCookieError, "session cookie base64 decoding error"
    )

    if len(cookie_bytes) != SESSION_ID_LENGTH:
        raise SessionCookieError("bad session cookie length")

    hmac_from_client = cookie_bytes[0:HMAC_BYTE_LENGTH]
    id_bytes = cookie_bytes[HMAC_BYTE_LENGTH : HMAC_BYTE_LENGTH + ID_BYTE_LENGTH]
    expiration_bytes = cookie_bytes[HMAC_BYTE_LENGTH + ID_BYTE_LENGTH : SESSION_ID_LENGTH]

    (expiration_int,) = struct.unpack(">Q", expiration_bytes)
    if expiration_int < now_time_unix:
        raise SessionCookieError(f"session cookie expired: {expiration_int}")

    (id_value,) = struct.unpack(">I", id_bytes)
    expected = _session_cookie_hmac(secret_key, expiration_int, client_ip, id_value)
    if not hmac_mod.compare_digest(expected, hmac_from_client):
        raise SessionCookieError("hmac validation failed")
