"""Compiled /auth_request fast path: decision-table hit → byte template
(a copy of `banjax_tpu/httpapi/fastpath.py`).

Before the fast server runs the nine-step decision chain, it consults
the decision table (`native/decisiontable.py`) that the dynamic lists
mirror into. A hit on an eligible request is answered from prebuilt byte
templates — one probe, one session-cookie HMAC, a few joins — instead of
the whole `decision_for_nginx` walk.

Byte identity is the contract: a template response equals
`serialize_response` of the chain's answer bit for bit (status line,
header order, X-Accel-Redirect, cookies). Anything the templates cannot
reproduce — password cookies, per-site static lists, sitewide sha-inv
path exceptions, session-id entries, baskerville-disabled hosts — is an
eligibility miss, and the chain serves it. A CHALLENGE hit enters the
chain's own challenge stage, so its PoW check runs kernel C on the card.

A lookup fault (a table error, anything unexpected, or the armed
`serve.fastpath.lookup` failpoint, checked before the table probe) sends
the request to the chain and is counted (`faults_total`), as in the JAX
module.
Hits, misses and faults are counted on the app's ServeFastpathStats
(`deps.serve_stats`).
"""

from __future__ import annotations

import json
import logging
import struct
import time
from typing import Optional, Tuple

from banjax_tpu_torch.crypto._b64 import decode_cookie_b64
from banjax_tpu_torch.crypto.session import (
    SESSION_COOKIE_NAME,
    SessionCookieError,
    new_session_cookie,
    validate_session_cookie,
)
from banjax_tpu_torch.decisions.model import Decision, FailAction
from banjax_tpu_torch.httpapi.decision_chain import (
    ChainState,
    DecisionForNginxResult,
    DecisionListResult,
    RequestInfo,
    send_or_validate_sha_challenge,
)
from banjax_tpu_torch.httpapi.rewrite import PASSWORD_COOKIE_NAME
from banjax_tpu_torch.resilience import failpoints
from banjax_tpu_torch.utils import go_query_escape, go_query_unescape

log = logging.getLogger(__name__)

_GRANTED_BODY = b"access granted\n"
_DENIED_BODY = b"access denied\n"
_UNSET = object()


class _Gen:
    """Everything derived from one config generation, precompiled once:
    the byte templates and the eligibility gates.  Rebuilt whenever the
    config object identity changes (hot reload swaps the object)."""

    __slots__ = (
        "config", "enabled", "secret", "ttl", "not_verify",
        "granted_head", "denied_head", "setcookie_prefix",
        "setcookie_mid", "conn_keep", "conn_close",
        "has_global_ip", "has_global_ua",
        "password_hosts", "list_hosts", "sha_exc_hosts", "bask_disabled",
        "debug", "session_cache", "global_ip_cache", "global_ua_cache",
        "unescape_cache",
    )

    # bound for the per-generation memo dicts below; hitting it clears
    # the dict (O(1), rare) rather than evicting
    CACHE_MAX = 8192

    def __init__(self, config):
        self.config = config
        self.enabled = config.serve_fastpath_enabled
        self.secret = config.session_cookie_hmac_secret
        self.ttl = config.session_cookie_ttl_seconds
        self.not_verify = bool(config.session_cookie_not_verify)
        self.debug = bool(config.debug)
        # template heads run through the static half of the wire layout
        # (serialize_response order: status, CT, CL, headers, cookies,
        # Connection); the session headers are spliced per request
        self.granted_head = (
            "HTTP/1.1 200 OK\r\n"
            "Content-Type: text/plain\r\n"
            f"Content-Length: {len(_GRANTED_BODY)}\r\n"
            "X-Banjax-Decision: ExpiringAccessGranted\r\n"
            "X-Accel-Redirect: @access_granted\r\n"
            "X-Deflect-Session: "
        ).encode()
        self.denied_head = (
            "HTTP/1.1 403 Forbidden\r\n"
            "Content-Type: text/plain\r\n"
            f"Content-Length: {len(_DENIED_BODY)}\r\n"
            "X-Banjax-Decision: ExpiringBlock\r\n"
            "Cache-Control: no-cache,no-store\r\n"
            "X-Accel-Redirect: @access_denied\r\n"
            "X-Deflect-Session: "
        ).encode()
        self.setcookie_prefix = f"Set-Cookie: {SESSION_COOKIE_NAME}=".encode()
        self.setcookie_mid = f"; Max-Age={self.ttl}; Path=/; HttpOnly\r\n".encode()
        self.conn_keep = b"Connection: keep-alive\r\n\r\n"
        self.conn_close = b"Connection: close\r\n\r\n"
        # eligibility gates: any host with per-site state goes to the
        # chain (steps 2-4 could fire); sha-inv path exceptions make a
        # CHALLENGE hit path-dependent (step 7's prefix check)
        self.has_global_ip = bool(config.global_decision_lists)
        self.has_global_ua = bool(config.global_user_agent_decision_lists)
        self.password_hosts = frozenset(config.password_protected_paths) | \
            frozenset(config.password_protected_path_exceptions)
        self.list_hosts = frozenset(config.per_site_decision_lists) | \
            frozenset(config.per_site_user_agent_decision_lists)
        self.sha_exc_hosts = frozenset(config.sha_inv_path_exceptions)
        self.bask_disabled = frozenset(config.sites_to_disable_baskerville)
        # per-generation memos (all invalidated with the generation):
        #   session_cache: (url-decoded cookie, ip) -> embedded expiry.
        #     A cookie that validated once stays valid until the expiry
        #     baked into its own bytes (there is no revocation), so the
        #     steady-state echo path pays a dict probe, not an HMAC.
        #   global_ip_cache / global_ua_cache: the step-5/6 static-list
        #     probes are pure functions of the config generation.
        #   unescape_cache: escaped value -> QueryUnescape(value), None on
        #     reject.  A pure function; session cookies always carry %3D
        #     padding so a repeat bearer pays a dict probe, not the
        #     per-char unescape walk.
        self.session_cache = {}
        self.global_ip_cache = {}
        self.global_ua_cache = {}
        self.unescape_cache = {}

    def unescape(self, value: str):
        """Memoized go_query_unescape; None where it raises ValueError."""
        cache = self.unescape_cache
        out = cache.get(value, _UNSET)
        if out is _UNSET:
            try:
                out = go_query_unescape(value)
            except ValueError:
                out = None
            if len(cache) >= self.CACHE_MAX:
                cache.clear()
            cache[value] = out
        return out


class AuthFastPath:
    """One per FastPathServer; `try_serve` returns the full wire bytes
    for a decision-table hit, or None ("the chain serves this")."""

    def __init__(self, deps):
        self.deps = deps
        self.stats = deps.serve_stats
        self._gen: Optional[_Gen] = None
        if deps.decision_table is not None:
            self.stats.set_table(deps.decision_table)

    def try_serve(self, req) -> Optional[Tuple[bytes, int]]:
        """(wire_bytes, status) on a fast-path hit, else None."""
        table = self.deps.decision_table
        if table is None:
            return None
        config = self.deps.config_holder.get()
        gen = self._gen
        if gen is None or gen.config is not config:
            gen = _Gen(config)
            self._gen = gen
        if not gen.enabled:
            return None
        stats = self.stats
        try:
            failpoints.check("serve.fastpath.lookup")
            return self._lookup(req, gen, table, stats)
        except Exception:  # noqa: BLE001 — counted; the chain serves it
            stats.note_fault()
            log.debug("fastpath lookup fault", exc_info=True)
            return None

    # ------------------------------------------------------------- lookup

    def _lookup(self, req, gen: _Gen, table, stats) -> Optional[Tuple[bytes, int]]:
        headers = req.headers
        host = headers.get("x-requested-host", "")
        ip = headers.get("x-client-ip", "")
        # hosts with per-site static/password state can decide before the
        # dynamic lists (chain steps 1-4) — chain territory
        if host in gen.password_hosts or host in gen.list_hosts:
            stats.note_miss("ineligible")
            return None

        cookies = {}
        raw = headers.get("cookie", "")
        if raw:
            for part in raw.split(";"):
                name, eq, value = part.strip().partition("=")
                if not eq:
                    continue
                if "%" in value or "+" in value:
                    value = gen.unescape(value)
                    if value is None:
                        continue
                    cookies[name] = value
                else:
                    # QueryUnescape is the identity on a value with no
                    # escapes — skip the per-char walk (gin's read does
                    # the same unescape, so identity here is exact)
                    cookies[name] = value
            if PASSWORD_COOKIE_NAME in cookies:
                # chain step 1 (priority pass) could fire — let it decide
                stats.note_miss("password")
                return None
            if SESSION_COOKIE_NAME in cookies and table.session_count() > 0:
                # a session-id entry would beat the IP entry in chain
                # step 7; the table only mirrors a count, so any session
                # bearer defers to the chain while such entries exist
                stats.note_miss("session_guard")
                return None

        # chain steps 5-6 (global static lists) outrank the dynamic
        # lists; when configured they must MISS for the fast path to own
        # the request (both checks are cheap dict/filter probes)
        static_lists = self.deps.static_lists
        if gen.has_global_ip:
            cache = gen.global_ip_cache
            found = cache.get(ip)
            if found is None:
                _, found = static_lists.check_global(ip)
                if len(cache) >= gen.CACHE_MAX:
                    cache.clear()
                cache[ip] = found
            if found:
                stats.note_miss("global_list")
                return None
        if gen.has_global_ua:
            ua = headers.get("x-client-user-agent", "")
            cache = gen.global_ua_cache
            found = cache.get(ua)
            if found is None:
                _, found = static_lists.check_global_user_agent(ua)
                if len(cache) >= gen.CACHE_MAX:
                    cache.clear()
                cache[ua] = found
            if found:
                stats.note_miss("global_list")
                return None

        entry = table.get(ip)
        if entry is None:
            stats.note_miss("table")
            return None
        decision, expires, from_baskerville = entry
        # the chain's lazy-expiry comparison to the bit (dynamic_lists
        # check: strictly `now - expires > 0`); an expired entry misses
        # so the chain performs the deletion + provenance record
        if time.time() - expires > 0:
            stats.note_miss("expired")
            return None

        if decision == Decision.ALLOW:
            raw_resp = self._render(
                gen, gen.granted_head, req, cookies, ip, host, 200
            )
            self._log_result(gen, req, ip, host, "ExpiringAccessGranted")
            stats.note_hit("allow")
            return raw_resp, 200

        if decision == Decision.CHALLENGE:
            if host in gen.sha_exc_hosts:
                # step 7's per-path sha-inv exception prefix check
                stats.note_miss("ineligible")
                return None
            if from_baskerville and host in gen.bask_disabled:
                # chain falls through to step 8 with a DIS-BASK log line
                stats.note_miss("baskerville")
                return None
            return self._challenge(req, cookies, ip, host, stats)

        if decision in (Decision.NGINX_BLOCK, Decision.IPTABLES_BLOCK):
            if from_baskerville and host in gen.bask_disabled:
                stats.note_miss("baskerville")
                return None
            raw_resp = self._render(
                gen, gen.denied_head, req, cookies, ip, host, 403
            )
            self._log_result(gen, req, ip, host, "ExpiringBlock")
            stats.note_hit("block")
            return raw_resp, 403

        stats.note_miss("table")  # unknown decision byte: fall open
        return None

    # ------------------------------------------------------------- render

    def _render(self, gen: _Gen, head: bytes, req, cookies, ip: str,
                host: str, status: int) -> bytes:
        """Template render = the static head + the per-request session
        splice, reproducing `_session_cookie_endpoint` +
        `serialize_response` byte for byte."""
        dsc = cookies.get(SESSION_COOKIE_NAME)
        if dsc is not None:
            # the chain QueryUnescapes a second time on top of the cookie
            # read, falling back to the original on error (identity when
            # the value carries no escapes)
            if "%" in dsc or "+" in dsc:
                url_decoded = gen.unescape(dsc)
                if url_decoded is None:
                    url_decoded = dsc
            else:
                url_decoded = dsc
            now = time.time()
            cache = gen.session_cache
            exp = cache.get((url_decoded, ip))
            if exp is not None and exp >= now:
                # validated before and not yet past its embedded expiry —
                # exactly the window validate_session_cookie accepts
                out, new = url_decoded, False
            else:
                try:
                    validate_session_cookie(url_decoded, gen.secret, now, ip)
                    valid = True
                except SessionCookieError:
                    valid = False
                if valid:
                    try:
                        raw = decode_cookie_b64(
                            url_decoded, SessionCookieError, "bad b64"
                        )
                        if len(cache) >= gen.CACHE_MAX:
                            cache.clear()
                        cache[(url_decoded, ip)] = float(
                            struct.unpack(">Q", raw[8:16])[0]
                        )
                    except Exception:  # noqa: BLE001 — memo only
                        pass
                if valid or gen.not_verify:
                    out, new = url_decoded, False
                else:
                    out, new = new_session_cookie(gen.secret, gen.ttl, ip), True
        else:
            out, new = new_session_cookie(gen.secret, gen.ttl, ip), True
        # header values pass the serializer's CR/LF sanitizer (a client-
        # controlled echoed session value is a splitting vector)
        if "\r" in out or "\n" in out:
            out_hdr = out.replace("\r", " ").replace("\n", " ")
        else:
            out_hdr = out
        parts = [head, out_hdr.encode()]
        if new:
            parts.append(b"\r\nX-Deflect-Session-New: true\r\n")
            parts.append(gen.setcookie_prefix)
            parts.append(go_query_escape(out).encode())
            parts.append(gen.setcookie_mid)
        else:
            parts.append(b"\r\nX-Deflect-Session-New: false\r\n")
        parts.append(gen.conn_keep if req.keep_alive else gen.conn_close)
        if req.method != "HEAD":
            parts.append(_GRANTED_BODY if status == 200 else _DENIED_BODY)
        return b"".join(parts)

    def _challenge(self, req, cookies, ip: str, host: str,
                   stats) -> Tuple[bytes, int]:
        """A CHALLENGE hit skips chain steps 1-6 (all proven misses by
        the gates above) and enters the REAL challenge stage directly —
        issuance, verification, failure counting and ban side effects
        are the chain's own code, so the response and every side effect
        stay byte-identical."""
        from banjax_tpu_torch.httpapi.fastserve import serialize_response

        deps = self.deps
        info = RequestInfo(
            client_ip=ip,
            requested_host=host,
            requested_path=req.headers.get("x-requested-path", ""),
            client_user_agent=req.headers.get("x-client-user-agent", ""),
            method=req.method,
            cookies=cookies,
        )
        state = ChainState(
            config=deps.config_holder.get(),
            static_lists=deps.static_lists,
            dynamic_lists=deps.dynamic_lists,
            protected_paths=deps.protected_paths,
            failed_challenge_states=deps.failed_challenge_states,
            banner=deps.banner,
            challenge_verifier=deps.challenge_verifier,
        )
        resp, sha_result, rate_result = send_or_validate_sha_challenge(
            state, info, FailAction.BLOCK
        )
        result = DecisionForNginxResult(
            client_ip=ip,
            requested_host=host,
            requested_path=info.requested_path,
            decision_list_result=DecisionListResult.EXPIRING_CHALLENGE,
            sha_challenge_result=sha_result,
            too_many_failed_challenges_result=rate_result,
            client_user_agent=info.client_user_agent,
        )
        log.info("decisionForNginx: %s", result.to_json())
        stats.note_hit("challenge")
        raw_resp = serialize_response(
            resp, req.keep_alive, head_only=req.method == "HEAD"
        )
        return raw_resp, resp.status

    @staticmethod
    def _log_result(gen: _Gen, req, ip: str, host: str, dlr: str) -> None:
        """The chain's per-request log line (fastserve logs every result
        that isn't NoMention; fast-path hits never are).  Serialized only
        when INFO is actually emitted — the line's content is unchanged."""
        if not log.isEnabledFor(logging.INFO):
            return
        log.info("decisionForNginx: %s", json.dumps({
            "ClientIp": ip,
            "RequestedHost": host,
            "RequestedPath": req.headers.get("x-requested-path", ""),
            "DecisionListResult": dlr,
            "PasswordChallengeResult": None,
            "ShaChallengeResult": None,
            "TooManyFailedChallengesResult": None,
            "ClientUserAgent": req.headers.get("x-client-user-agent", ""),
        }))
