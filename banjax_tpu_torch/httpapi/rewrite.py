"""Server-side rewriting of the challenge HTML pages before serving.

Reference behavior (Go banjax): internal/http_server.go:438-491 — the
pages ship with hardcoded JS that the server patches by literal string
replacement (first occurrence only): the cookie-set expression gains a
max-age (and, for roaming password sites, a domain scope), and
`new_solver(10)` is rewritten to the configured difficulty. The replacement
targets are part of the page contract (see the page headers in
`httpapi/pages/`).
"""

from __future__ import annotations

from banjax_tpu_torch.config import Config

PASSWORD_COOKIE_NAME = "deflect_password3"
CHALLENGE_COOKIE_NAME = "deflect_challenge3"


def modify_html_content(page_bytes: bytes, target: str, replacement: str) -> bytes:
    """bytes.Replace(..., 1) equivalent (http_server.go:438-440)."""
    return page_bytes.replace(target.encode(), replacement.encode(), 1)


def apply_cookie_max_age(page_bytes: bytes, cookie_name: str, ttl_seconds: int) -> bytes:
    """http_server.go:442-452."""
    return modify_html_content(
        page_bytes,
        f'"{cookie_name}=" + base64_cookie',
        f'"{cookie_name}=" + base64_cookie + ";max-age={ttl_seconds}"',
    )


def apply_cookie_domain(page_bytes: bytes, cookie_name: str) -> bytes:
    """http_server.go:454-464."""
    return modify_html_content(
        page_bytes,
        f'"{cookie_name}=" + base64_cookie',
        f'"{cookie_name}=" + base64_cookie + ";domain=" + window.location.hostname',
    )


def apply_args_to_password_page(page_bytes: bytes, roaming: bool, cookie_ttl: int) -> bytes:
    """http_server.go:466-477."""
    modified = apply_cookie_max_age(page_bytes, PASSWORD_COOKIE_NAME, cookie_ttl)
    if not roaming:
        return modified
    return apply_cookie_domain(modified, PASSWORD_COOKIE_NAME)


def apply_args_to_sha_inv_page(config: Config) -> bytes:
    """http_server.go:479-491."""
    modified = apply_cookie_max_age(
        config.challenger_bytes, CHALLENGE_COOKIE_NAME, config.sha_inv_cookie_ttl_seconds
    )
    return modify_html_content(
        modified, "new_solver(10)", f"new_solver({config.sha_inv_expected_zero_bits})"
    )
