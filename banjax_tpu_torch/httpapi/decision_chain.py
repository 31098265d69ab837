"""The /auth_request decision chain.

Reference behavior (Go banjax): internal/http_server.go:347-1165 (spec:
PSEUDOCODE_DESCRIPTION.md:9-63). The priority chain, in order:

  1. valid password cookie for the host (or roaming) → priority pass
  2. password-protected path classification (exception beats protected)
  3. per-site IP list   4. per-site UA list
  5. global IP list     6. global UA list
  7. expiring (dynamic) list — session id first, with per-site SHA-inv path
     exceptions and the sites_to_disable_baskerville fall-through
  8. sitewide SHA-inv list, with password-exception paths passing
  9. default allow ("NoMention")

Every terminal response also runs the session-cookie endpoint, and each
request logs a DecisionForNginxResult JSON record.

This module is framework-agnostic: it consumes a RequestInfo and produces a
Response, so the chain can be tested without an HTTP server and reused by
any frontend. A copy of `banjax_tpu/httpapi/decision_chain.py`, with its
provenance records (static and UA list decisions, challenge-failure
bans), its rooted `challenge.sha_inv` span around validate -> fail -> ban,
and its failpoint sites. The sites `decision_chain` (here),
`challenge.issue` (`challenge/issuer.py`) and `challenge.verify`
(`challenge/verifier.py`) raise into the server's fail-open middleware,
which answers as the JAX server does; `challenge.device_verify` makes the
verifier's kernel-C dispatch raise as a kernel fault would (counted in
`faults`), where the JAX verifier falls back to hashlib. The chain reads
the clock as `time.time()` and draws session ids through
`secrets.randbits`, so a caller can pin both.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import logging
import time
from typing import Dict, List, Optional, Tuple

from banjax_tpu_torch.utils import go_query_unescape

from banjax_tpu_torch.challenge import issuer as challenge_issuer
from banjax_tpu_torch.challenge import verifier as challenge_verifier_mod
from banjax_tpu_torch.config import Config
from banjax_tpu_torch.crypto.challenge import (
    CookieError,
    validate_password_cookie,
)
from banjax_tpu_torch.crypto.integrity import (
    INTEGRITY_CHECK_COOKIE_NAME,
    IntegrityCheckPayloadWrapper,
    calc_bot_score_from_cookie,
)
from banjax_tpu_torch.crypto.session import (
    SESSION_COOKIE_NAME,
    SessionCookieError,
    new_session_cookie,
    validate_session_cookie,
)
from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists, ExpiringDecision
from banjax_tpu_torch.decisions.model import Decision, FailAction
from banjax_tpu_torch.decisions.protected_paths import PasswordProtectedPaths, PathType
from banjax_tpu_torch.decisions.rate_limit import (
    FailedChallengeRateLimitStates,
    RateLimitResult,
)
from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
from banjax_tpu_torch.effectors.banner import BannerInterface
from banjax_tpu_torch.httpapi.rewrite import (
    CHALLENGE_COOKIE_NAME,
    PASSWORD_COOKIE_NAME,
    apply_args_to_password_page,
    apply_args_to_sha_inv_page,
)
from banjax_tpu_torch.ingest.reports import report_passed_failed_banned_message
from banjax_tpu_torch.obs import provenance, trace
from banjax_tpu_torch.resilience import failpoints

log = logging.getLogger(__name__)


# ---------------------------------------------------------------- transport


@dataclasses.dataclass
class RequestInfo:
    """What the chain needs from a request (the Nginx-forwarded X-* headers
    plus cookies and method)."""

    client_ip: str = ""
    requested_host: str = ""
    requested_path: str = ""
    client_user_agent: str = ""
    method: str = "GET"
    cookies: Dict[str, str] = dataclasses.field(default_factory=dict)

    def cookie(self, name: str) -> Optional[str]:
        return self.cookies.get(name)


@dataclasses.dataclass
class SetCookie:
    name: str
    value: str
    max_age: int
    path: str = "/"
    domain: str = ""
    secure: bool = False
    http_only: bool = False


@dataclasses.dataclass
class Response:
    status: int = 200
    headers: Dict[str, str] = dataclasses.field(default_factory=dict)
    cookies: List[SetCookie] = dataclasses.field(default_factory=list)
    body: bytes = b""
    content_type: str = "text/plain"


# ------------------------------------------------------------ result enums


class ShaChallengeResult(enum.IntEnum):
    PASSED = 1
    FAILED_NO_COOKIE = 2
    FAILED_BAD_COOKIE = 3

    def __str__(self) -> str:
        return {
            ShaChallengeResult.PASSED: "ShaChallengePassed",
            ShaChallengeResult.FAILED_NO_COOKIE: "ShaChallengeFailedNoCookie",
            ShaChallengeResult.FAILED_BAD_COOKIE: "ShaChallengeFailedBadCookie",
        }[self]


class PasswordChallengeResult(enum.IntEnum):
    ERROR_NO_PASSWORD = 1
    PASSED = 2
    ROAMING_PASSED = 3
    FAILED_NO_COOKIE = 4
    FAILED_BAD_COOKIE = 5

    def __str__(self) -> str:
        return {
            PasswordChallengeResult.ERROR_NO_PASSWORD: "ErrorNoPassword",
            PasswordChallengeResult.PASSED: "PasswordChallengePassed",
            PasswordChallengeResult.ROAMING_PASSED: "PasswordChallengeRoamingPassed",
            PasswordChallengeResult.FAILED_NO_COOKIE: "PasswordChallengeFailedNoCookie",
            PasswordChallengeResult.FAILED_BAD_COOKIE: "PasswordChallengeFailedBadCookie",
        }[self]


class DecisionListResult(enum.IntEnum):
    """http_server.go:747-800 — the 23-value per-request outcome label."""

    PASSWORD_PROTECTED_PRIORITY_PASS = 1
    PASSWORD_PROTECTED_PATH = 2
    PASSWORD_PROTECTED_PATH_EXCEPTION = 3
    PER_SITE_ACCESS_GRANTED = 4
    PER_SITE_CHALLENGE = 5
    PER_SITE_BLOCK = 6
    GLOBAL_ACCESS_GRANTED = 7
    GLOBAL_CHALLENGE = 8
    GLOBAL_BLOCK = 9
    EXPIRING_ACCESS_GRANTED = 10
    EXPIRING_CHALLENGE = 11
    EXPIRING_BLOCK = 12
    PER_SITE_SHA_INV_PATH_EXCEPTION = 13
    SITE_WIDE_CHALLENGE = 14
    SITE_WIDE_CHALLENGE_EXCEPTION = 15
    PER_SITE_UA_ACCESS_GRANTED = 16
    PER_SITE_UA_CHALLENGE = 17
    PER_SITE_UA_BLOCK = 18
    GLOBAL_UA_ACCESS_GRANTED = 19
    GLOBAL_UA_CHALLENGE = 20
    GLOBAL_UA_BLOCK = 21
    NO_MENTION = 22
    NOT_SET = 23

    def __str__(self) -> str:
        return _DLR_TO_STRING[self]


_DLR_TO_STRING = {
    DecisionListResult.PASSWORD_PROTECTED_PRIORITY_PASS: "PasswordProtectedPriorityPass",
    DecisionListResult.PASSWORD_PROTECTED_PATH: "PasswordProtectedPath",
    DecisionListResult.PASSWORD_PROTECTED_PATH_EXCEPTION: "PasswordProtectedPathException",
    DecisionListResult.PER_SITE_ACCESS_GRANTED: "PerSiteAccessGranted",
    DecisionListResult.PER_SITE_CHALLENGE: "PerSiteChallenge",
    DecisionListResult.PER_SITE_BLOCK: "PerSiteBlock",
    DecisionListResult.GLOBAL_ACCESS_GRANTED: "GlobalAccessGranted",
    DecisionListResult.GLOBAL_CHALLENGE: "GlobalChallenge",
    DecisionListResult.GLOBAL_BLOCK: "GlobalBlock",
    DecisionListResult.EXPIRING_ACCESS_GRANTED: "ExpiringAccessGranted",
    DecisionListResult.EXPIRING_CHALLENGE: "ExpiringChallenge",
    DecisionListResult.EXPIRING_BLOCK: "ExpiringBlock",
    DecisionListResult.PER_SITE_SHA_INV_PATH_EXCEPTION: "PerSiteShaInvPathException",
    DecisionListResult.SITE_WIDE_CHALLENGE: "SiteWideChallenge",
    DecisionListResult.SITE_WIDE_CHALLENGE_EXCEPTION: "SiteWideChallengeException",
    DecisionListResult.PER_SITE_UA_ACCESS_GRANTED: "PerSiteUAAccessGranted",
    DecisionListResult.PER_SITE_UA_CHALLENGE: "PerSiteUAChallenge",
    DecisionListResult.PER_SITE_UA_BLOCK: "PerSiteUABlock",
    DecisionListResult.GLOBAL_UA_ACCESS_GRANTED: "GlobalUAAccessGranted",
    DecisionListResult.GLOBAL_UA_CHALLENGE: "GlobalUAChallenge",
    DecisionListResult.GLOBAL_UA_BLOCK: "GlobalUABlock",
    DecisionListResult.NO_MENTION: "NoMention",
    DecisionListResult.NOT_SET: "NotSet",
}


@dataclasses.dataclass
class DecisionForNginxResult:
    """http_server.go:816-825 — the per-request JSON log record."""

    client_ip: str = ""
    requested_host: str = ""
    requested_path: str = ""
    decision_list_result: DecisionListResult = DecisionListResult.NOT_SET
    password_challenge_result: Optional[PasswordChallengeResult] = None
    sha_challenge_result: Optional[ShaChallengeResult] = None
    too_many_failed_challenges_result: Optional[RateLimitResult] = None
    client_user_agent: str = ""

    def to_json(self) -> str:
        d = {
            "ClientIp": self.client_ip,
            "RequestedHost": self.requested_host,
            "RequestedPath": self.requested_path,
            "DecisionListResult": str(self.decision_list_result),
            "PasswordChallengeResult": (
                str(self.password_challenge_result)
                if self.password_challenge_result is not None
                else None
            ),
            "ShaChallengeResult": (
                str(self.sha_challenge_result)
                if self.sha_challenge_result is not None
                else None
            ),
            "TooManyFailedChallengesResult": (
                {
                    "MatchType": str(self.too_many_failed_challenges_result.match_type),
                    "Exceeded": self.too_many_failed_challenges_result.exceeded,
                }
                if self.too_many_failed_challenges_result is not None
                else None
            ),
            "ClientUserAgent": self.client_user_agent,
        }
        return json.dumps(d)


# ----------------------------------------------------------------- context


@dataclasses.dataclass
class ChainState:
    """Everything decisionForNginx needs, bundled (http_server.go:827-834)."""

    config: Config
    static_lists: StaticDecisionLists
    dynamic_lists: DynamicDecisionLists
    protected_paths: PasswordProtectedPaths
    failed_challenge_states: FailedChallengeRateLimitStates
    banner: BannerInterface
    # optional device-batched PoW verifier (challenge/verifier.py);
    # None = the pure-CPU reference path, decisions identical either way
    challenge_verifier: Optional[
        challenge_verifier_mod.DeviceVerifier
    ] = None


# --------------------------------------------------------- response helpers


def clean_requested_path(requested_path: str) -> str:
    """http_server.go:1138-1142."""
    path = "/" + requested_path.strip("/")
    return path.split("?")[0]


def _get_user_agent_or_ip(config: Config, req: RequestInfo) -> str:
    """Cookie binding selector (http_server.go:406-413)."""
    if req.requested_host in config.use_user_agent_in_cookie:
        return req.client_user_agent
    return req.client_ip


def _session_cookie_endpoint(config: Config, req: RequestInfo, resp: Response) -> None:
    """session_cookie.go:106-161 — validate-or-issue on every response."""
    dsc = req.cookie(SESSION_COOKIE_NAME)
    if dsc is not None:
        # the reference QueryUnescapes a second time on top of gin's read,
        # falling back to the original on error (session_cookie.go:122-129)
        try:
            url_decoded = go_query_unescape(dsc)
        except ValueError:
            url_decoded = dsc
        try:
            validate_session_cookie(
                url_decoded, config.session_cookie_hmac_secret, time.time(), req.client_ip
            )
            valid = True
        except SessionCookieError:
            valid = False
        if valid or config.session_cookie_not_verify:
            _attach_session_cookie(config, resp, url_decoded, False)
        else:
            new_dsc = new_session_cookie(
                config.session_cookie_hmac_secret,
                config.session_cookie_ttl_seconds,
                req.client_ip,
            )
            _attach_session_cookie(config, resp, new_dsc, True)
        return
    new_dsc = new_session_cookie(
        config.session_cookie_hmac_secret, config.session_cookie_ttl_seconds, req.client_ip
    )
    _attach_session_cookie(config, resp, new_dsc, True)


def _attach_session_cookie(config: Config, resp: Response, dsc: str, dsc_new: bool) -> None:
    if dsc_new:
        resp.cookies.append(
            SetCookie(
                SESSION_COOKIE_NAME, dsc, config.session_cookie_ttl_seconds,
                path="/", domain="", secure=False, http_only=True,
            )
        )
    resp.headers["X-Deflect-Session"] = dsc
    resp.headers["X-Deflect-Session-New"] = "true" if dsc_new else "false"


def _bot_score_headers(
    resp: Response, bot_score: float, top_factor: str, fingerprint: IntegrityCheckPayloadWrapper
) -> None:
    if bot_score >= 0:
        resp.headers["X-Banjax-Bot-Score"] = f"{bot_score:f}"
        resp.headers["X-Banjax-Bot-Score-Top-Factor"] = top_factor
        resp.headers["X-Banjax-Bot-Fingerprint"] = fingerprint.hash
        resp.headers["X-Banjax-Bot-Fingerprint-Full"] = json.dumps(
            fingerprint.payload.to_json_dict()
        )


def access_granted(
    config: Config,
    req: RequestInfo,
    decision_list_result_string: str,
    bot_score: float = -1.0,
    bot_score_top_factor: str = "",
    bot_fingerprint: Optional[IntegrityCheckPayloadWrapper] = None,
) -> Response:
    """http_server.go:347-365."""
    resp = Response(status=200, body=b"access granted\n")
    _bot_score_headers(resp, bot_score, bot_score_top_factor,
                       bot_fingerprint or IntegrityCheckPayloadWrapper())
    resp.headers["X-Banjax-Decision"] = decision_list_result_string
    resp.headers["X-Accel-Redirect"] = "@access_granted"
    _session_cookie_endpoint(config, req, resp)
    return resp


def access_denied(
    config: Config,
    req: RequestInfo,
    decision_list_result_string: str,
    bot_score: float = -1.0,
    bot_score_top_factor: str = "",
    bot_fingerprint: Optional[IntegrityCheckPayloadWrapper] = None,
) -> Response:
    """http_server.go:367-386."""
    resp = Response(status=403, body=b"access denied\n")
    _bot_score_headers(resp, bot_score, bot_score_top_factor,
                       bot_fingerprint or IntegrityCheckPayloadWrapper())
    resp.headers["X-Banjax-Decision"] = decision_list_result_string
    resp.headers["Cache-Control"] = "no-cache,no-store"
    resp.headers["X-Accel-Redirect"] = "@access_denied"
    _session_cookie_endpoint(config, req, resp)
    return resp


def _challenge_cookie(
    config: Config, req: RequestInfo, resp: Response, cookie_name: str,
    cookie_ttl_seconds: int, secret: str, set_domain_scope: bool,
) -> None:
    """http_server.go:388-404 — routed through the stateless issuer."""
    new_cookie = challenge_issuer.issue(
        secret, cookie_ttl_seconds, _get_user_agent_or_ip(config, req)
    )
    domain_scope = req.requested_host if set_domain_scope else ""
    resp.cookies.append(
        SetCookie(cookie_name, new_cookie, cookie_ttl_seconds,
                  path="/", domain=domain_scope, secure=False, http_only=False)
    )
    resp.headers["Cache-Control"] = "no-cache,no-store"


def _get_per_site_cookie_ttl_or_default(config: Config, domain: str, default_ttl: int) -> int:
    return config.password_persite_cookie_ttl_seconds.get(domain, default_ttl)


def password_challenge(config: Config, req: RequestInfo, roaming: bool) -> Response:
    """http_server.go:415-421 — 401 + rewritten page + new unsolved cookie."""
    resp = Response(status=401, content_type="text/html")
    cookie_ttl = _get_per_site_cookie_ttl_or_default(
        config, req.requested_host, config.password_cookie_ttl_seconds
    )
    _challenge_cookie(config, req, resp, PASSWORD_COOKIE_NAME, cookie_ttl,
                      config.hmac_secret, roaming)
    _session_cookie_endpoint(config, req, resp)
    resp.body = apply_args_to_password_page(config.password_page_bytes, roaming, cookie_ttl)
    return resp


def sha_inv_challenge(config: Config, req: RequestInfo) -> Response:
    """http_server.go:423-428 — 429 + rewritten page + new unsolved cookie."""
    resp = Response(status=429, content_type="text/html")
    _challenge_cookie(config, req, resp, CHALLENGE_COOKIE_NAME,
                      config.sha_inv_cookie_ttl_seconds, config.hmac_secret, False)
    _session_cookie_endpoint(config, req, resp)
    resp.body = apply_args_to_sha_inv_page(config)
    return resp


# ----------------------------------------------------- challenge sub-flows


def too_many_failed_challenges(
    state: ChainState, req: RequestInfo, challenge_type: str
) -> RateLimitResult:
    """http_server.go:494-532 — on exceed, ban (NginxBlock if per-site
    allowlisted, else IptablesBlock) and write the failed-challenge ban log."""
    config = state.config
    result = state.failed_challenge_states.apply(req.client_ip, config)
    if result.exceeded:
        decision, found = state.static_lists.check_per_site(req.requested_host, req.client_ip)
        decision_type = Decision.IPTABLES_BLOCK
        if found and decision == Decision.ALLOW:
            log.info(
                "!! IP %s failed too many challenges on host %s but is allowlisted, no iptables ban",
                req.client_ip, req.requested_host,
            )
            decision_type = Decision.NGINX_BLOCK
        state.banner.ban_or_challenge_ip(config, req.client_ip, decision_type, req.requested_host)
        state.banner.log_failed_challenge_ban(
            config, req.client_ip, challenge_type, req.requested_host, req.requested_path,
            config.too_many_failed_challenges_threshold, req.client_user_agent,
            decision_type, req.method,
        )
        provenance.record(
            provenance.SOURCE_CHALLENGE, req.client_ip, decision_type,
            rule=f"failed challenge {challenge_type}",
            hits=config.too_many_failed_challenges_threshold,
        )
    return result


def send_or_validate_sha_challenge(
    state: ChainState, req: RequestInfo, fail_action: FailAction
) -> Tuple[Response, ShaChallengeResult, RateLimitResult]:
    """http_server.go:571-626."""
    config = state.config
    challenge_cookie = req.cookie(CHALLENGE_COOKIE_NAME)
    integrity_cookie = req.cookie(INTEGRITY_CHECK_COOKIE_NAME) or ""
    bot_score, top_factor, fingerprint = calc_bot_score_from_cookie(integrity_cookie)

    # one span around validate -> fail -> ban, so that a challenge_failure
    # provenance record carries the trace id of the verification behind it;
    # the HTTP path has no ambient pipeline span, so the span roots its own
    # trace (inert when tracing is off: new_trace() returns 0)
    tid = trace.current_trace_id() or trace.new_trace()
    with trace.span("challenge.sha_inv", trace_id=tid, args={"ip": req.client_ip}):
        if challenge_cookie is not None:
            try:
                challenge_verifier_mod.verify_sha_inv(
                    config.hmac_secret, challenge_cookie, time.time(),
                    _get_user_agent_or_ip(config, req),
                    config.sha_inv_expected_zero_bits,
                    device=state.challenge_verifier,
                )
                resp = access_granted(
                    config, req, str(ShaChallengeResult.PASSED), bot_score, top_factor, fingerprint
                )
                report_passed_failed_banned_message(
                    config, "ip_passed_challenge", req.client_ip, req.requested_host
                )
                return resp, ShaChallengeResult.PASSED, RateLimitResult()
            except CookieError:
                sha_result = ShaChallengeResult.FAILED_BAD_COOKIE
        else:
            sha_result = ShaChallengeResult.FAILED_NO_COOKIE

        report_passed_failed_banned_message(
            config, "ip_failed_challenge", req.client_ip, req.requested_host
        )
        if fail_action == FailAction.BLOCK:
            rate_result = too_many_failed_challenges(state, req, "sha_inv")
            if rate_result.exceeded:
                report_passed_failed_banned_message(
                    config, "ip_banned", req.client_ip, req.requested_host
                )
                resp = access_denied(
                    config, req, "TooManyFailedChallenges", bot_score, top_factor, fingerprint
                )
                return resp, sha_result, rate_result
            return sha_inv_challenge(config, req), sha_result, rate_result
        return sha_inv_challenge(config, req), sha_result, RateLimitResult()


def send_or_validate_password(
    state: ChainState, req: RequestInfo
) -> Tuple[Response, PasswordChallengeResult, RateLimitResult]:
    """http_server.go:671-745."""
    config = state.config
    password_cookie = req.cookie(PASSWORD_COOKIE_NAME)

    if password_cookie is not None:
        expected_hash, ok = state.protected_paths.get_password_hash(req.requested_host)
        if not ok:
            log.error("!!!! BAD - missing password in config")
            # reference returns without any terminal response here
            # (http_server.go:688-691) — the request falls through with no
            # X-Accel-Redirect; reproduce as an empty 200 with no headers
            return Response(status=200), PasswordChallengeResult.ERROR_NO_PASSWORD, RateLimitResult()
        try:
            validate_password_cookie(
                config.hmac_secret, password_cookie, time.time(),
                _get_user_agent_or_ip(config, req), expected_hash,
            )
            resp = access_granted(config, req, str(PasswordChallengeResult.PASSED))
            report_passed_failed_banned_message(
                config, "ip_passed_challenge", req.client_ip, req.requested_host
            )
            return resp, PasswordChallengeResult.PASSED, RateLimitResult()
        except CookieError:
            roaming_hash, has_roaming = state.protected_paths.get_roaming_password_hash(
                req.requested_host
            )
            if has_roaming:
                try:
                    validate_password_cookie(
                        config.hmac_secret, password_cookie, time.time(),
                        _get_user_agent_or_ip(config, req), roaming_hash,
                    )
                    resp = access_granted(
                        config, req, str(PasswordChallengeResult.ROAMING_PASSED)
                    )
                    report_passed_failed_banned_message(
                        config, "ip_passed_challenge", req.client_ip, req.requested_host
                    )
                    return resp, PasswordChallengeResult.ROAMING_PASSED, RateLimitResult()
                except CookieError:
                    password_result = PasswordChallengeResult.FAILED_BAD_COOKIE
            else:
                password_result = PasswordChallengeResult.FAILED_BAD_COOKIE
    else:
        password_result = PasswordChallengeResult.FAILED_NO_COOKIE

    report_passed_failed_banned_message(
        config, "ip_failed_challenge", req.client_ip, req.requested_host
    )
    rate_result = too_many_failed_challenges(state, req, "password")
    if rate_result.exceeded:
        report_passed_failed_banned_message(
            config, "ip_banned", req.client_ip, req.requested_host
        )
        resp = access_denied(config, req, "TooManyFailedPassword")
        return resp, password_result, rate_result
    _, allow_roaming = state.protected_paths.get_expand_cookie_domain(req.requested_host)
    return password_challenge(config, req, allow_roaming), password_result, rate_result


# ------------------------------------------------------------ the chain


def _check_expiring_decision_lists(
    state: ChainState, req: RequestInfo
) -> Tuple[Optional[ExpiringDecision], bool]:
    """http_server.go:1144-1147 — session cookie id first, then IP (the
    cookie value was already query-unescaped at the request layer)."""
    session_id = req.cookie(SESSION_COOKIE_NAME) or ""
    return state.dynamic_lists.check(session_id, req.client_ip)


def _check_per_site_sha_inv_path_exceptions(config: Config, host: str, path: str) -> bool:
    """http_server.go:1149-1165 — prefix match on raw requested path."""
    for exception in config.sha_inv_path_exceptions.get(host, []):
        if path.startswith(exception):
            return True
    return False


def decision_for_nginx(
    state: ChainState, req: RequestInfo
) -> Tuple[Response, DecisionForNginxResult]:
    """Port of decisionForNginx2 (http_server.go:861-1136)."""
    # an armed `decision_chain` failpoint raises into the server's
    # fail-open middleware (500 + X-Accel-Redirect: @fail_open)
    failpoints.check("decision_chain")
    config = state.config
    result = DecisionForNginxResult(
        client_ip=req.client_ip,
        requested_host=req.requested_host,
        requested_path=req.requested_path,
        decision_list_result=DecisionListResult.NOT_SET,
        client_user_agent=req.client_user_agent,
    )
    requested_protected_path = clean_requested_path(req.requested_path)

    # 1. priority pass with a valid password cookie (http_server.go:886-907)
    password_cookie = req.cookie(PASSWORD_COOKIE_NAME)
    if password_cookie is not None:
        grant = False
        expected_hash, has_hash = state.protected_paths.get_password_hash(req.requested_host)
        roaming_hash, has_roaming = state.protected_paths.get_roaming_password_hash(
            req.requested_host
        )
        if has_hash:
            try:
                validate_password_cookie(
                    config.hmac_secret, password_cookie, time.time(), req.client_ip,
                    expected_hash,
                )
                grant = True
            except CookieError:
                pass
        elif has_roaming:
            try:
                validate_password_cookie(
                    config.hmac_secret, password_cookie, time.time(), req.client_ip,
                    roaming_hash,
                )
                grant = True
            except CookieError:
                pass
        if grant:
            result.decision_list_result = DecisionListResult.PASSWORD_PROTECTED_PRIORITY_PASS
            resp = access_granted(config, req, str(result.decision_list_result))
            return resp, result

    # 2. password-protected path classification (http_server.go:909-930)
    path_type = state.protected_paths.classify_path(
        req.requested_host, requested_protected_path
    )
    if path_type == PathType.PASSWORD_PROTECTED:
        resp, password_result, rate_result = send_or_validate_password(state, req)
        result.decision_list_result = DecisionListResult.PASSWORD_PROTECTED_PATH
        result.password_challenge_result = password_result
        result.too_many_failed_challenges_result = rate_result
        return resp, result
    if path_type == PathType.PASSWORD_PROTECTED_EXCEPTION:
        result.decision_list_result = DecisionListResult.PASSWORD_PROTECTED_PATH_EXCEPTION
        resp = access_granted(config, req, str(result.decision_list_result))
        return resp, result

    # 3. per-site IP list (http_server.go:932-964)
    decision, found = state.static_lists.check_per_site(req.requested_host, req.client_ip)
    if found:
        outcome = _apply_static_decision(
            state, req, result, decision,
            DecisionListResult.PER_SITE_ACCESS_GRANTED,
            DecisionListResult.PER_SITE_CHALLENGE,
            DecisionListResult.PER_SITE_BLOCK,
        )
        if outcome is not None:
            return outcome, result

    # 4. per-site UA list (http_server.go:966-991)
    ua_decision, found = state.static_lists.check_per_site_user_agent(
        req.requested_host, req.client_user_agent
    )
    if found:
        outcome = _apply_static_decision(
            state, req, result, ua_decision,
            DecisionListResult.PER_SITE_UA_ACCESS_GRANTED,
            DecisionListResult.PER_SITE_UA_CHALLENGE,
            DecisionListResult.PER_SITE_UA_BLOCK,
            prov_source=provenance.SOURCE_UA,
        )
        if outcome is not None:
            return outcome, result

    # 5. global IP list (http_server.go:993-1021)
    decision, found = state.static_lists.check_global(req.client_ip)
    if found:
        outcome = _apply_static_decision(
            state, req, result, decision,
            DecisionListResult.GLOBAL_ACCESS_GRANTED,
            DecisionListResult.GLOBAL_CHALLENGE,
            DecisionListResult.GLOBAL_BLOCK,
        )
        if outcome is not None:
            return outcome, result

    # 6. global UA list (http_server.go:1023-1048)
    ua_decision, found = state.static_lists.check_global_user_agent(req.client_user_agent)
    if found:
        outcome = _apply_static_decision(
            state, req, result, ua_decision,
            DecisionListResult.GLOBAL_UA_ACCESS_GRANTED,
            DecisionListResult.GLOBAL_UA_CHALLENGE,
            DecisionListResult.GLOBAL_UA_BLOCK,
            prov_source=provenance.SOURCE_UA,
        )
        if outcome is not None:
            return outcome, result

    # 7. expiring (dynamic) lists (http_server.go:1054-1100)
    expiring_decision, found = _check_expiring_decision_lists(state, req)
    baskerville_disabled = req.requested_host in config.sites_to_disable_baskerville
    if found:
        if expiring_decision.decision == Decision.ALLOW:
            result.decision_list_result = DecisionListResult.EXPIRING_ACCESS_GRANTED
            resp = access_granted(config, req, str(result.decision_list_result))
            return resp, result
        if expiring_decision.decision == Decision.CHALLENGE:
            if _check_per_site_sha_inv_path_exceptions(
                config, req.requested_host, req.requested_path
            ):
                result.decision_list_result = DecisionListResult.PER_SITE_SHA_INV_PATH_EXCEPTION
                resp = access_granted(config, req, str(result.decision_list_result))
                return resp, result
            if expiring_decision.from_baskerville and baskerville_disabled:
                log.info(
                    "DIS-BASK: domain %s disabled baskerville, skip expiring challenge for %s",
                    req.requested_host, req.client_ip,
                )
            else:
                resp, sha_result, rate_result = send_or_validate_sha_challenge(
                    state, req, FailAction.BLOCK
                )
                result.decision_list_result = DecisionListResult.EXPIRING_CHALLENGE
                result.sha_challenge_result = sha_result
                result.too_many_failed_challenges_result = rate_result
                return resp, result
        elif expiring_decision.decision in (Decision.NGINX_BLOCK, Decision.IPTABLES_BLOCK):
            if expiring_decision.from_baskerville and baskerville_disabled:
                log.info(
                    "DIS-BASK: domain %s disabled baskerville, skip expiring block for %s",
                    req.requested_host, req.client_ip,
                )
            else:
                result.decision_list_result = DecisionListResult.EXPIRING_BLOCK
                resp = access_denied(config, req, str(result.decision_list_result))
                return resp, result

    # 8. sitewide SHA-inv list (http_server.go:1104-1128)
    fail_action, found = state.static_lists.check_sitewide_sha_inv(req.requested_host)
    if found:
        if state.protected_paths.is_exception(req.requested_host, requested_protected_path):
            result.decision_list_result = DecisionListResult.SITE_WIDE_CHALLENGE_EXCEPTION
            resp = access_granted(config, req, str(result.decision_list_result))
        else:
            resp, sha_result, rate_result = send_or_validate_sha_challenge(
                state, req, fail_action
            )
            result.decision_list_result = DecisionListResult.SITE_WIDE_CHALLENGE
            result.sha_challenge_result = sha_result
            result.too_many_failed_challenges_result = rate_result
        return resp, result

    # 9. default allow (http_server.go:1130-1135)
    if result.decision_list_result == DecisionListResult.NOT_SET:
        result.decision_list_result = DecisionListResult.NO_MENTION
    resp = access_granted(config, req, str(result.decision_list_result))
    return resp, result


def _apply_static_decision(
    state: ChainState,
    req: RequestInfo,
    result: DecisionForNginxResult,
    decision: Decision,
    granted: DecisionListResult,
    challenge: DecisionListResult,
    block: DecisionListResult,
    prov_source: str = provenance.SOURCE_STATIC,
) -> Optional[Response]:
    """The shared Allow/Challenge/Block arm for chain steps 3-6; every
    acted-on list hit lands in the provenance ledger (the rule field
    carries the chain arm, e.g. "PerSiteBlock")."""
    config = state.config
    if decision == Decision.ALLOW:
        result.decision_list_result = granted
        provenance.record(prov_source, req.client_ip, decision, rule=str(granted))
        return access_granted(config, req, str(granted))
    if decision == Decision.CHALLENGE:
        resp, sha_result, rate_result = send_or_validate_sha_challenge(
            state, req, FailAction.BLOCK
        )
        result.decision_list_result = challenge
        result.sha_challenge_result = sha_result
        result.too_many_failed_challenges_result = rate_result
        provenance.record(prov_source, req.client_ip, decision, rule=str(challenge))
        return resp
    if decision in (Decision.NGINX_BLOCK, Decision.IPTABLES_BLOCK):
        result.decision_list_result = block
        provenance.record(prov_source, req.client_ip, decision, rule=str(block))
        return access_denied(config, req, str(block))
    return None
