"""The HTTP request API (a copy of `banjax_tpu/httpapi/server.py`).

Reference behavior (Go banjax): internal/http_server.go:32-332 — a server
on 127.0.0.1:8081 with: a JSON access-log middleware, a recovery
middleware that FAILS OPEN (X-Accel-Redirect: @fail_open + 500 with an
X-Banjax-Error header) on any handler crash, a standalone-testing
middleware that fakes the nginx X-* headers and writes the nginx-format
access log line itself, and these routes:

  ANY  /auth_request        — the decision chain
  GET  /info                — config version
  GET  /healthz             — component health (admin-gated off loopback)
  GET  /metrics             — Prometheus text (obs/exposition.py; admin)
  GET  /debug/trace         — the span ring as Chrome trace JSON; ?clear=1
                              takes and empties it in one step (admin)
  GET  /decisions/explain?ip= — the provenance ledger's records for one
                              IP and its live dynamic-list entry (admin)
  GET  /debug/incidents     — flight-recorder bundles; ?name=&file= reads
                              one file (admin)
  GET  /traffic/top         — the traffic sketch's heavy hitters (admin)
  GET  /debug/failpoints    — instrumented sites and armed failpoints (admin)
  POST /debug/failpoints    — arm/disarm failpoints (admin; 403 when
                              failpoints_admin_enabled is false)
  GET  /decision_lists      — formatted static+dynamic lists
  GET  /rate_limit_states   — formatted rate-limit states
  GET  /is_banned?ip=       — expiring-list + ipset lookup
  GET  /ipset/list          — raw ipset entries
  GET  /banned?domain=      — expiring entries for a domain
  POST /unban               — remove an IP from expiring list + ipset

With `profile: true` (gin's pprof in the reference, http_server.go:
314-317):

  GET  /debug/pprof/profile?seconds=N — cProfile of the event-loop thread
  GET  /debug/pprof/threads           — a stack dump of every thread
  GET  /debug/torch/trace?seconds=N   — a torch.profiler capture (CPU and
                              CUDA activities, at most 60 s) written as a
                              Chrome trace into a temporary directory; it
                              takes the place of the JAX /debug/jax/trace.
                              409 while a capture or profile runs.

In the fast layout every route but /auth_request, /info and /healthz
reaches this app through the fast server's raw proxy, as cold routes.
Multi-process serving (`httpapi/workers.py`): every process binds the
TCP port with SO_REUSEPORT; the primary also serves this app on a unix
socket, and a worker serves only the hot routes, reaching the primary
for the cold ones (its fast server's raw proxy, or the aiohttp reverse
proxy of `install_proxy_routes` without the fast path). With the
fabric on, `/metrics` shows its families, `/metrics?fleet=1` serves the
merged exposition of every alive shard (`obs/fleet.py` FleetScraper; 404
unless `fleet_metrics_enabled`), and `/decisions/explain` for an IP
another shard owns is answered by that shard over the peer wire
(T_EXPLAIN), tagged `owning_node` and `proxied`; an unreachable owner
gets the local view, flagged `owner_unreachable`. `run_http_server`
takes the port (the reference's
8081 by default) so that a test binds port 0. The recovery middleware
counts every fail-open answer on the app's ServeFastpathStats.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hmac
import json
import logging
import os
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, TextIO

from aiohttp import web

from banjax_tpu_torch.config_holder import ConfigHolder
from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
from banjax_tpu_torch.decisions.model import Decision
from banjax_tpu_torch.decisions.protected_paths import PasswordProtectedPaths
from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
from banjax_tpu_torch.effectors.banner import BannerInterface
from banjax_tpu_torch.effectors.ipset_stats import IpsetStats
from banjax_tpu_torch.httpapi.decision_chain import (
    ChainState,
    DecisionListResult,
    RequestInfo,
    Response,
    decision_for_nginx,
)
from banjax_tpu_torch.httpapi.fastserve import _clean_header
from banjax_tpu_torch.httpapi.serve_stats import ServeFastpathStats
from banjax_tpu_torch.resilience import failpoints
from banjax_tpu_torch.utils import go_query_escape, go_query_unescape

log = logging.getLogger(__name__)

LISTEN_HOST = "127.0.0.1"
LISTEN_PORT = 8081  # http_server.go:42

_LOOPBACK_HOSTS = {"", "127.0.0.1", "::1", "localhost"}


def is_loopback_host(host: str) -> bool:
    return (host or "").strip("[]") in _LOOPBACK_HOSTS or (host or "").startswith("127.")


def admin_auth_ok(config, listen_host: str, authorization: str) -> bool:
    """Gate of the admin surface. Open on a loopback
    listener or when no `admin_token` is configured; otherwise the request
    must carry `Authorization: Bearer <token>`, compared in constant time."""
    token = config.admin_token or ""
    if not token or is_loopback_host(listen_host):
        return True
    provided = authorization or ""
    if provided.startswith("Bearer "):
        provided = provided[len("Bearer "):]
    return hmac.compare_digest(token.encode(), provided.encode())


@dataclasses.dataclass
class ServerDeps:
    config_holder: ConfigHolder
    static_lists: StaticDecisionLists
    dynamic_lists: DynamicDecisionLists
    protected_paths: PasswordProtectedPaths
    regex_states: object  # format_states(), get(ip), len(): cli.RegexStatesView
    failed_challenge_states: object  # challenge/failures.py
    banner: BannerInterface
    gin_log_file: Optional[TextIO] = None  # the JSON access log
    server_log_file: Optional[TextIO] = None  # standalone: the fake nginx log
    health: Optional[object] = None  # resilience.health.HealthRegistry
    # the PoW verifier (challenge/verifier.py): kernel C on the card
    challenge_verifier: Optional[object] = None
    # the serving fast path's table (native/decisiontable.py); None = every
    # request takes the chain
    decision_table: Optional[object] = None
    serve_stats: ServeFastpathStats = dataclasses.field(default_factory=ServeFastpathStats)
    # the /metrics sources (getters: a reload swaps the matcher)
    matcher_getter: Optional[Callable[[], object]] = None
    pipeline_getter: Optional[Callable[[], object]] = None
    slo_getter: Optional[Callable[[], object]] = None
    flightrec_getter: Optional[Callable[[], object]] = None
    ipset_stats: Optional[IpsetStats] = None
    # multi-process serving: the primary's PrimarySupervisor (or None)
    supervisor_getter: Optional[Callable[[], object]] = None
    # the decision fabric's counters (fabric/stats.py FabricStats), its
    # fleet scraper (obs/fleet.py, /metrics?fleet=1) and the FabricService
    # itself (the cross-shard explain proxy); None when the fabric is off
    fabric_getter: Optional[Callable[[], object]] = None
    fleet_getter: Optional[Callable[[], object]] = None
    fabric_service_getter: Optional[Callable[[], object]] = None


def explain_payload(dynamic_lists, ip: str) -> dict:
    """One shard's /decisions/explain answer: the ledger's records of `ip`
    and its live dynamic-list entry (read without the lazy expiry: an
    admin read does not mutate). A fabric peer asks for it over T_EXPLAIN."""
    from banjax_tpu_torch.obs import provenance

    ledger = provenance.get_ledger()
    active = None
    ed = dynamic_lists.peek(ip)
    if ed is not None:
        active = {
            "decision": str(ed.decision),
            "expires": ed.expires,
            "domain": ed.domain,
            "from_baskerville": ed.from_baskerville,
        }
    return {
        "ip": ip,
        "ledger_enabled": ledger.enabled,
        "records": ledger.explain(ip),
        "active_decision": active,
    }


_STANDALONE_KEY = "banjax_standalone_hdrs"


def _hdr(request: web.Request, name: str) -> str:
    """Read an X-* header, honoring the standalone middleware's injected
    values (kept in the request's state dict — cheaper than cloning the
    request per hit, which the reference does by mutating the shared
    header map in place, http_server.go:137-169)."""
    ov = request.get(_STANDALONE_KEY)
    if ov is not None and name in ov:
        return ov[name]
    return request.headers.get(name, "")


def _request_info(request: web.Request) -> RequestInfo:
    # gin reads cookies through url.QueryUnescape (c.Cookie); a value whose
    # unescape fails is treated as an absent cookie
    cookies = {}
    for name, value in request.cookies.items():
        try:
            cookies[name] = go_query_unescape(value)
        except ValueError:
            continue
    return RequestInfo(
        client_ip=_hdr(request, "X-Client-IP"),
        requested_host=_hdr(request, "X-Requested-Host"),
        requested_path=_hdr(request, "X-Requested-Path"),
        client_user_agent=_hdr(request, "X-Client-User-Agent"),
        method=request.method,
        cookies=cookies,
    )


class CoalescedLog:
    """Per-request log lines without a per-request flush.

    Lines accumulate in a Python list; a single delayed callback (50 ms)
    writes the batch with ONE os.write on the underlying fd, so a 1k-rps
    burst pays ~20 syscalls/sec instead of 1k.  os.write(O_APPEND) emits
    whole lines atomically, where a block-buffer flush could split a
    line mid-byte for another writer of the same file.  Consumers (the
    standalone tailer, integration tests) all poll with retry budgets far
    above 50 ms; shutdown replays any tail through flush()."""

    __slots__ = ("_f", "_lines", "_pending", "delay")

    def __init__(self, f: TextIO, delay: float = 0.05):
        self._f = f
        self._lines: list = []
        self._pending = False
        self.delay = delay

    def write(self, s: str) -> None:
        self._lines.append(s)
        if not self._pending:
            self._pending = True
            asyncio.get_running_loop().call_later(self.delay, self._flush)

    def _flush(self) -> None:
        self._pending = False
        if not self._lines:
            return
        data = "".join(self._lines).encode("utf-8", "surrogatepass")
        self._lines.clear()
        try:
            os.write(self._f.fileno(), data)
        except (OSError, ValueError):
            pass  # closed during shutdown


def _to_web_response(resp: Response) -> web.Response:
    out = web.Response(
        status=resp.status, body=resp.body, content_type=resp.content_type
    )
    for k, v in resp.headers.items():
        out.headers[k] = v
    for c in resp.cookies:
        # gin SetCookie url.QueryEscape's the value; the page JS
        # decodeURIComponent's it back — keep the same wire encoding
        out.set_cookie(
            c.name, go_query_escape(c.value), max_age=c.max_age, path=c.path,
            domain=c.domain or None, secure=c.secure, httponly=c.http_only,
        )
    return out


def build_app(deps: ServerDeps, listen_host: str = LISTEN_HOST,
              worker_proxy_sock: Optional[str] = None) -> web.Application:
    """Build the aiohttp application. With `worker_proxy_sock` (a worker
    of multi-process serving) the primary-owned cold routes are reverse
    proxies to the primary's unix socket instead of local handlers: a
    worker's replicas are authoritative only for /auth_request."""
    middlewares = []

    config0 = deps.config_holder.get()

    coalesced_logs: list = []

    # --- access log middleware (http_server.go:65-95) ---
    if deps.gin_log_file is not None:
        gin_log = CoalescedLog(deps.gin_log_file)
        coalesced_logs.append(gin_log)

        @web.middleware
        async def access_log_middleware(request: web.Request, handler):
            start = time.monotonic()
            response = await handler(request)
            latency_us = int((time.monotonic() - start) * 1e6)
            line = {
                "Time": time.strftime("%a, %d %b %Y %H:%M:%S %Z"),
                "ClientIp": _hdr(request, "X-Client-IP"),
                "ClientReqHost": _hdr(request, "X-Requested-Host"),
                "ClientReqPath": _hdr(request, "X-Requested-Path"),
                "Method": request.method,
                "Path": request.path,
                "Status": response.status,
                "Latency": latency_us,
            }
            gin_log.write(json.dumps(line) + "\n")
            return response

        middlewares.append(access_log_middleware)

    # --- fail-open recovery middleware (http_server.go:110-135) ---
    @web.middleware
    async def recovery_middleware(request: web.Request, handler):
        try:
            return await handler(request)
        except web.HTTPException:
            raise  # normal HTTP responses (404 etc.), not crashes
        except Exception as e:  # noqa: BLE001 — this IS the crash handler
            tb = traceback.extract_tb(e.__traceback__)
            location = f"{tb[-1].filename}:{tb[-1].lineno}" if tb else "unknown"
            log.error("handler panic: %s (%s)", e, location)
            deps.serve_stats.note_fail_open()
            # CR/LF-sanitized: exception text can embed client-controlled
            # bytes, and an unsanitizable header value would make aiohttp
            # raise INSIDE the crash handler — dropping the fail-open
            # contract exactly when it matters
            headers = {
                "X-Banjax-Error": _clean_header(f"{e} ({location})"),
                "X-Accel-Redirect": "@fail_open",
            }
            return web.Response(status=500, headers=headers)

    middlewares.append(recovery_middleware)

    # --- standalone-testing middleware (http_server.go:137-169) ---
    if config0.standalone_testing:
        log.info("!!! standalone-testing mode enabled. adding some X- headers here")

        server_log = (
            CoalescedLog(deps.server_log_file)
            if deps.server_log_file is not None else None
        )
        if server_log is not None:
            coalesced_logs.append(server_log)

        @web.middleware
        async def standalone_middleware(request: web.Request, handler):
            # injected values ride the request's state dict (read back via
            # _hdr) — same effect as the reference's in-place header-map
            # mutation, without a per-request clone of the request object
            hdrs = request.headers
            client_ip = hdrs.get("X-Client-IP") or request.remote or "127.0.0.1"
            request[_STANDALONE_KEY] = {
                "X-Client-IP": client_ip,
                "X-Requested-Host": request.host,
                "X-Requested-Path": request.query.get("path", ""),
                "X-Client-User-Agent": hdrs.get("X-Client-User-Agent")
                or "mozilla",
            }

            # write the fake nginx banjax_format line so the log tailer has
            # input: '$msec $remote_addr $request_method $host $request $ua'
            if server_log is not None:
                server_log.write(
                    "%f %s %s %s %s %s HTTP/1.1 %s\n"
                    % (
                        float(int(time.time())),
                        client_ip,
                        request.method,
                        request.host,
                        request.method,
                        request.query.get("path", ""),
                        hdrs.get("User-Agent", ""),
                    )
                )
            return await handler(request)

        # outermost, so the injected X-* headers are visible to the access
        # log (the reference mutates the shared header map in place)
        middlewares.insert(0, standalone_middleware)

    app = web.Application(middlewares=middlewares)

    if coalesced_logs:
        # drain any coalesced log tail when the server shuts down
        async def _drain_logs(app_):
            for lg in coalesced_logs:
                lg._flush()

        app.on_cleanup.append(_drain_logs)

    # ---------------- routes ----------------

    async def auth_request(request: web.Request) -> web.Response:
        config = deps.config_holder.get()
        state = ChainState(
            config=config,
            static_lists=deps.static_lists,
            dynamic_lists=deps.dynamic_lists,
            protected_paths=deps.protected_paths,
            failed_challenge_states=deps.failed_challenge_states,
            banner=deps.banner,
            challenge_verifier=deps.challenge_verifier,
        )
        resp, result = decision_for_nginx(state, _request_info(request))
        if config.debug:
            log.info("decisionForNginx: %s", result.to_json())
        elif result.decision_list_result != DecisionListResult.NO_MENTION:
            log.info("decisionForNginx: %s", result.to_json())
        return _to_web_response(resp)

    async def info(request: web.Request) -> web.Response:
        return web.json_response(
            {"config_version": deps.config_holder.get().config_version}
        )

    async def decision_lists_route(request: web.Request) -> web.Response:
        per_site, global_ = deps.static_lists.format_lists()
        expiring = deps.dynamic_lists.format_ip_entries()

        def fmt_ip_map(m):
            return "".join(f"{ip}:\n\t{d}\n" for ip, d in m.items())

        per_site_str = "".join(
            f"{site}:\n" + "".join(f"\t{ip}:\n\t\t{d}\n" for ip, d in ips.items())
            for site, ips in per_site.items()
        )
        expiring_str = "".join(
            f"{ip}:\n\t{ed.domain} {ed.decision} until "
            f"{time.strftime('%H:%M:%S', time.localtime(ed.expires))} "
            f"(baskerville: {str(ed.from_baskerville).lower()})\n"
            for ip, ed in expiring.items()
        )
        body = (
            f"per_site:\n{per_site_str}\n\nglobal:\n{fmt_ip_map(global_)}\n\n"
            f"expiring:\n{expiring_str}"
        )
        return web.Response(text=body)

    async def rate_limit_states_route(request: web.Request) -> web.Response:
        body = (
            f"regexes:\n{deps.regex_states.format_states()}\n"
            f"failed challenges:\n{deps.failed_challenge_states.format_states()}\n"
        )
        return web.Response(text=body)

    async def is_banned(request: web.Request) -> web.Response:
        ip = request.query.get("ip", "")
        if not ip:
            return web.json_response({"error": "ip query param is required"}, status=400)
        try:
            banned = deps.banner.ipset_list()
        except Exception:  # noqa: BLE001 — reference ignores the error (banned, _ :=)
            banned = None
        expiring, ok = deps.dynamic_lists.check("", ip)
        if not ok:
            return web.json_response(
                {"ip": ip, "banned": banned, "expiringDecision": None}
            )
        return web.json_response(
            {
                "ip": ip,
                "banned": banned,
                "expiringDecision": {
                    "Decision": str(expiring.decision),
                    "Expires": expiring.expires,
                    "IpAddress": expiring.ip_address,
                },
            }
        )

    async def ipset_list_route(request: web.Request) -> web.Response:
        try:
            entries = deps.banner.ipset_list()
        except Exception as e:  # noqa: BLE001 — surface as 500 JSON like the reference
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response({"entries": entries})

    async def banned_route(request: web.Request) -> web.Response:
        domain = request.query.get("domain", "")
        if not domain:
            return web.json_response({"error": "domain query param is required"}, status=400)
        entries = deps.dynamic_lists.check_by_domain(domain)
        return web.json_response(
            {
                "domain": domain,
                "entries": [
                    {
                        "ip": e.ip_or_session_id,
                        "decision": e.decision,
                        "expires": time.strftime(
                            "%Y-%m-%dT%H:%M:%SZ", time.gmtime(e.expires)
                        ),
                        "from_baskerville": e.from_baskerville,
                    }
                    for e in entries
                ],
            }
        )

    async def unban(request: web.Request) -> web.Response:
        config = deps.config_holder.get()
        form = await request.post()
        ip = str(form.get("ip", "")).strip()
        if not ip:
            return web.json_response({"error": "ip in post form is required"}, status=400)
        expiring, ok = deps.dynamic_lists.check("", ip)
        decision_str = str(expiring.decision) if ok and expiring else ""
        if not ok or (expiring and expiring.decision == Decision.IPTABLES_BLOCK):
            if not deps.banner.ipset_test(config, ip):
                return web.json_response(
                    {
                        "ip": ip,
                        "found_in_decision_list": ok,
                        "decision": decision_str,
                        "unban": False,
                        "error": "ip is not banned",
                    },
                    status=400,
                )
            try:
                deps.banner.ipset_del(ip)
            except Exception as e:  # noqa: BLE001 — reference returns the error as 500 JSON
                return web.json_response(
                    {
                        "ip": ip,
                        "found_in_decision_list": ok,
                        "decision": decision_str,
                        "unban": False,
                        "error": str(e),
                    },
                    status=500,
                )
        if ok:
            deps.dynamic_lists.remove_by_ip(ip)
        return web.json_response(
            {
                "ip": ip,
                "found_in_decision_list": ok,
                "decision": decision_str,
                "unban": True,
            }
        )

    def _admin_denied(request: web.Request) -> Optional[web.Response]:
        """None when the admin request may proceed; a 401 otherwise.
        Evaluated per request (not at build time) so a SIGHUP'd token
        takes effect without a listener restart."""
        if admin_auth_ok(deps.config_holder.get(), listen_host,
                         request.headers.get("Authorization", "")):
            return None
        return web.json_response(
            {"error": "unauthorized"}, status=401,
            headers={"WWW-Authenticate": "Bearer"},
        )

    async def healthz(request: web.Request) -> web.Response:
        denied = _admin_denied(request)
        if denied is not None:
            return denied
        # the component health aggregate (resilience/health.py): 200 while
        # serving is possible (HEALTHY or DEGRADED — degraded modes still
        # answer traffic), 503 only when a component has FAILED
        if deps.health is None:
            return web.json_response({"status": "unknown", "components": {}})
        snap = deps.health.snapshot()
        status = 503 if snap["status"] == "failed" else 200
        return web.json_response(snap, status=status)

    async def metrics_route(request: web.Request) -> web.Response:
        denied = _admin_denied(request)
        if denied is not None:
            return denied
        if request.query.get("fleet") in ("1", "true"):
            scraper = deps.fleet_getter() if deps.fleet_getter else None
            if scraper is None:
                return web.json_response(
                    {"error": "fleet metrics disabled "
                              "(fleet_metrics_enabled + fabric required)"},
                    status=404,
                )
            # the peer pulls are blocking socket I/O: off the event loop;
            # a peer's failure degrades inside scrape(), never a 500
            text = await asyncio.get_running_loop().run_in_executor(None, scraper.scrape)
            return web.Response(text=text, content_type="text/plain", charset="utf-8",
                                headers={"X-Prometheus-Exposition-Version": "0.0.4"})
        from banjax_tpu_torch.obs.exposition import render_prometheus

        text = render_prometheus(
            deps.dynamic_lists, deps.regex_states, deps.failed_challenge_states,
            matcher=deps.matcher_getter() if deps.matcher_getter else None,
            pipeline=deps.pipeline_getter() if deps.pipeline_getter else None,
            health=deps.health,
            slo=deps.slo_getter() if deps.slo_getter else None,
            flightrec=deps.flightrec_getter() if deps.flightrec_getter else None,
            serve_stats=deps.serve_stats,
            ipset_stats=deps.ipset_stats,
            supervisor=deps.supervisor_getter() if deps.supervisor_getter else None,
            fabric=deps.fabric_getter() if deps.fabric_getter else None,
        )
        return web.Response(text=text, content_type="text/plain", charset="utf-8",
                            headers={"X-Prometheus-Exposition-Version": "0.0.4"})

    async def debug_trace_route(request: web.Request) -> web.Response:
        denied = _admin_denied(request)
        if denied is not None:
            return denied
        from banjax_tpu_torch.obs import trace as trace_mod

        tracer = trace_mod.get_tracer()
        # take and clear in one lock section: a span recorded meanwhile is
        # in this dump or kept for the next, never dropped
        payload = tracer.export_chrome(clear=request.query.get("clear") in ("1", "true"))
        payload["otherData"]["enabled"] = tracer.enabled
        return web.json_response(payload)

    async def decisions_explain_route(request: web.Request) -> web.Response:
        """Every ledger record of one IP, and its live dynamic-list entry
        (read without the lazy expiry: an admin read does not mutate).
        With the fabric on, an IP another shard owns is explained by that
        shard (its ledger holds the records)."""
        denied = _admin_denied(request)
        if denied is not None:
            return denied
        ip = request.query.get("ip", "")
        if not ip:
            return web.json_response({"error": "ip query param is required"}, status=400)
        owner_unreachable = None
        svc = deps.fabric_service_getter() if deps.fabric_service_getter else None
        if svc is not None:
            try:
                owner = svc.router.owner_of(ip)
            except Exception:  # noqa: BLE001 — no owner: answered locally
                owner = None
            if owner is not None and owner != svc.node_id:
                try:
                    payload = await asyncio.get_running_loop().run_in_executor(
                        None, svc.explain_remote, owner, ip)
                    payload["owning_node"] = owner
                    payload["proxied"] = True
                    return web.json_response(payload)
                except Exception:  # noqa: BLE001 — the local, partial view, flagged
                    owner_unreachable = owner
        out = explain_payload(deps.dynamic_lists, ip)
        if svc is not None:
            out["node_id"] = svc.node_id
        if owner_unreachable is not None:
            out["owner_unreachable"] = owner_unreachable
        return web.json_response(out)

    async def traffic_top_route(request: web.Request) -> web.Response:
        """The traffic sketch's top-K heavy hitters, distinct-IP estimate
        and per-rule pressure, through its throttled pull (?refresh=1
        forces one compact copy from the card)."""
        denied = _admin_denied(request)
        if denied is not None:
            return denied
        matcher = deps.matcher_getter() if deps.matcher_getter else None
        sketch = getattr(matcher, "traffic_sketch", None)
        if sketch is None:
            return web.json_response({
                "enabled": False,
                "top": [],
                "hint": "traffic_sketch_enabled + matcher_device_windows required",
            })
        try:
            k = int(request.query.get("k", "0") or 0)
        except ValueError:
            return web.json_response({"error": "k must be an integer"}, status=400)
        summary = sketch.pull(force=request.query.get("refresh") in ("1", "true"))
        top = summary["top"][:k] if k > 0 else summary["top"]
        age = sketch.pull_age_seconds()
        return web.json_response({
            "enabled": True,
            "k": k or summary["k_max"],
            "k_max": summary["k_max"],
            "top": top,
            "distinct_ips_estimate": summary["distinct_ips_estimate"],
            "heavy_hitter_share": summary["heavy_hitter_share"],
            "lines_total": summary["lines_total"],
            "rule_pressure": summary["rule_pressure"],
            "sketch": {
                **summary["sketch"],
                "pull_age_seconds": None if age is None else round(age, 3),
            },
        })

    async def debug_incidents_route(request: web.Request) -> web.Response:
        """The flight recorder's bundles: the list, one manifest, or one
        file (?name=...&file=...)."""
        denied = _admin_denied(request)
        if denied is not None:
            return denied
        rec = deps.flightrec_getter() if deps.flightrec_getter else None
        if rec is None:
            return web.json_response({"enabled": False, "incidents": []})
        name = request.query.get("name", "")
        fname = request.query.get("file", "")
        if name and fname:
            data = rec.read_file(name, fname)
            if data is None:
                return web.json_response({"error": "not found"}, status=404)
            ctype = "application/json" if fname.endswith(".json") else "text/plain"
            return web.Response(body=data, content_type=ctype)
        if name:
            for entry in rec.list_incidents():
                if entry["name"] == name:
                    return web.json_response(entry)
            return web.json_response({"error": "not found"}, status=404)
        return web.json_response({
            "enabled": True,
            "directory": rec.directory,
            "incidents": rec.list_incidents(),
        })

    async def debug_failpoints_route(request: web.Request) -> web.Response:
        """Runtime fault injection (resilience/failpoints.py): GET lists the
        instrumented sites and every armed point; POST arms and disarms.

        POST body (JSON), any combination, applied in this order:
            {"disarm_all": true}
            {"disarm": ["pipeline.submit", ...]}
            {"arm": [{"name": "pipeline.submit", "mode": "error",
                      "count": 3, "probability": 0.5, "delay_s": 0.0}]}
            {"spec": "matcher.device=error:3@0.5"}
        Responds with the resulting armed list (the JAX route's bodies and
        status codes)."""
        denied = _admin_denied(request)
        if denied is not None:
            return denied
        if not deps.config_holder.get().failpoints_admin_enabled:
            return web.json_response({"error": "failpoints_admin_enabled is false"}, status=403)
        if request.method == "POST":
            try:
                body = await request.json()
            except Exception:  # noqa: BLE001 — the client's error, answered 400
                return web.json_response({"error": "body must be JSON"}, status=400)
            if not isinstance(body, dict):
                return web.json_response({"error": "body must be a JSON object"}, status=400)
            if body.get("disarm_all"):
                failpoints.disarm()
            for name in body.get("disarm") or []:
                failpoints.disarm(str(name))
            arms = body.get("arm") or []
            if not isinstance(arms, list):
                return web.json_response({"error": "arm must be a list"}, status=400)
            for ent in arms:
                if not isinstance(ent, dict) or not ent.get("name"):
                    return web.json_response({"error": "each arm entry needs a name"},
                                             status=400)
                mode = ent.get("mode", "error")
                if mode not in failpoints.MODES:
                    return web.json_response({"error": f"unknown mode {mode!r}"}, status=400)
                count = ent.get("count")
                if count is not None:
                    try:
                        count = int(count)
                    except (TypeError, ValueError):
                        return web.json_response({"error": "count must be an integer"},
                                                 status=400)
                try:
                    probability = float(ent.get("probability", 1.0))
                    delay_s = float(ent.get("delay_s", 0.0))
                except (TypeError, ValueError):
                    return web.json_response(
                        {"error": "probability/delay_s must be numbers"}, status=400)
                failpoints.arm(str(ent["name"]), mode=mode, count=count, delay_s=delay_s,
                               probability=probability, seed=ent.get("seed"))
            if isinstance(body.get("spec"), str):
                failpoints.arm_from_spec(body["spec"])
        return web.json_response({
            "enabled": True,
            "sites": list(failpoints.KNOWN_SITES),
            "armed": failpoints.snapshot(),
        })


    app.router.add_route("*", "/auth_request", auth_request)
    app.router.add_get("/info", info)
    if worker_proxy_sock is None:
        app.router.add_get("/healthz", healthz)
        app.router.add_get("/metrics", metrics_route)
        app.router.add_get("/debug/trace", debug_trace_route)
        app.router.add_get("/decisions/explain", decisions_explain_route)
        app.router.add_get("/debug/incidents", debug_incidents_route)
        app.router.add_get("/traffic/top", traffic_top_route)
        app.router.add_get("/debug/failpoints", debug_failpoints_route)
        app.router.add_post("/debug/failpoints", debug_failpoints_route)
        app.router.add_get("/decision_lists", decision_lists_route)
        app.router.add_get("/rate_limit_states", rate_limit_states_route)
        app.router.add_get("/is_banned", is_banned)
        app.router.add_get("/ipset/list", ipset_list_route)
        app.router.add_get("/banned", banned_route)
        app.router.add_post("/unban", unban)
    else:
        from banjax_tpu_torch.httpapi.workers import install_proxy_routes

        install_proxy_routes(app, worker_proxy_sock)

    if config0.standalone_testing:
        async def favicon(request: web.Request) -> web.Response:
            return web.Response(text="")
        app.router.add_get("/favicon.ico", favicon)

    if config0.profile:
        _register_profile_routes(app)

    return app


def _register_profile_routes(app: web.Application) -> None:
    """The profiling routes of `profile: true` (see the module docstring)."""
    import cProfile
    import io
    import pstats
    import sys
    import threading

    profiling = {"active": False}

    async def pprof_profile(request: web.Request) -> web.Response:
        seconds = min(float(request.query.get("seconds", "5")), 60.0)
        if profiling["active"]:
            return web.Response(status=409, text="profile already running\n")
        profiling["active"] = True
        prof = cProfile.Profile()
        prof.enable()
        try:
            # a client disconnect cancels the handler mid-sleep; disable in
            # finally or cProfile stays on the event-loop thread
            await asyncio.sleep(seconds)
        finally:
            prof.disable()
            profiling["active"] = False
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(60)
        return web.Response(text=buf.getvalue())

    async def pprof_threads(request: web.Request) -> web.Response:
        buf = io.StringIO()
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            buf.write(f"--- thread {names.get(ident, '?')} ({ident}) ---\n")
            traceback.print_stack(frame, file=buf)
            buf.write("\n")
        return web.Response(text=buf.getvalue())

    async def torch_trace(request: web.Request) -> web.Response:
        seconds = min(float(request.query.get("seconds", "3")), 60.0)
        if profiling["active"]:
            return web.Response(status=409, text="profile already running\n")
        profiling["active"] = True
        try:
            prof, activities = _torch_profiler()
            trace_dir = tempfile.mkdtemp(prefix="banjax-torch-trace-")
            path = os.path.join(trace_dir, "trace.json")
            # the profiler is started and stopped on this (the loop's)
            # thread: torch stops a session only from the thread that
            # started it
            prof.__enter__()
            try:
                await asyncio.sleep(seconds)
            finally:
                prof.__exit__(None, None, None)
            prof.export_chrome_trace(path)
        finally:
            profiling["active"] = False
        return web.json_response({
            "trace_dir": trace_dir,
            "trace_file": path,
            "activities": activities,
            "hint": "open trace.json in Perfetto (ui.perfetto.dev) or chrome://tracing",
        })

    app.router.add_get("/debug/pprof/profile", pprof_profile)
    app.router.add_get("/debug/pprof/threads", pprof_threads)
    app.router.add_get("/debug/torch/trace", torch_trace)


def _torch_profiler():
    """A torch.profiler session over the CPU and, when there is a card,
    CUDA activities, recording the record_function ranges of every thread
    (the pipeline's stage threads are not the one that starts it).
    Returns (profiler, activity names)."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return (torch.profiler.profile(activities=activities, experimental_config=cfg),
            [a.name for a in activities])


class ServerHandle:
    """Shutdown handle over both layouts (aiohttp runner, fast-path asyncio
    server, temp unix-socket dir); `port` is the bound TCP port."""

    def __init__(self, port: int, runner=None, fast_server=None, tmpdir=None,
                 fast_logs=()):
        self.port = port
        self.runner = runner
        self.fast_server = fast_server
        self._tmpdir = tmpdir
        self._fast_logs = fast_logs

    async def cleanup(self) -> None:
        if self.fast_server is not None:
            self.fast_server.close()
            await self.fast_server.wait_closed()
        for lg in self._fast_logs:
            lg._flush()
        if self.runner is not None:
            await self.runner.cleanup()
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)


async def run_http_server(deps: ServerDeps, port: int = LISTEN_PORT,
                          reuse_port: bool = False, unix_path: Optional[str] = None,
                          worker_proxy_sock: Optional[str] = None) -> ServerHandle:
    """Start the server; returns a handle for a clean shutdown. `port` 0
    binds an ephemeral port (tests), read back as `handle.port`.

    Layouts (config key `http_fast_path`, default on):

      fast on  — the native protocol server (httpapi/fastserve.py) owns the
        TCP port and answers the hot routes; the full aiohttp app listens
        on a unix socket and receives everything else by raw proxy. A
        worker passes `worker_proxy_sock` (the primary's unix socket) and
        runs no aiohttp app of its own.
      fast off — the aiohttp app serves the TCP port directly.

    Multi-process serving (httpapi/workers.py): every process passes
    `reuse_port=True` so the kernel spreads the port's connections over
    them; the primary also passes `unix_path`, its cold-route listener for
    the workers' proxies.
    """
    from banjax_tpu_torch.httpapi.fastserve import start_fast_server

    config0 = deps.config_holder.get()
    # bind address: empty = the reference's hard-coded loopback. A
    # non-loopback listener without an admin token leaves /healthz open to
    # the network — allowed, but loudly
    listen_host = config0.http_listen_host or LISTEN_HOST
    if not is_loopback_host(listen_host) and not config0.admin_token:
        log.warning(
            "http listener binds non-loopback %s with no admin_token: the "
            "admin surface (/healthz /metrics /debug/trace /decisions/explain "
            "/debug/incidents /debug/failpoints /traffic/top) is open to the "
            "network", listen_host,
        )

    if not config0.http_fast_path:
        app = build_app(deps, listen_host=listen_host, worker_proxy_sock=worker_proxy_sock)
        runner = web.AppRunner(app, access_log=None)
        await runner.setup()
        await web.TCPSite(runner, listen_host, port, reuse_port=reuse_port or None).start()
        if unix_path is not None:
            await web.UnixSite(runner, unix_path).start()
        bound = next(a[1] for a in runner.addresses if isinstance(a, tuple))
        log.info("http server listening on %s:%s", listen_host, bound)
        return ServerHandle(bound, runner=runner)

    gin_log = CoalescedLog(deps.gin_log_file) if deps.gin_log_file is not None else None
    server_log = (
        CoalescedLog(deps.server_log_file)
        if (config0.standalone_testing and deps.server_log_file is not None)
        else None
    )
    fast_logs = [lg for lg in (gin_log, server_log) if lg is not None]
    if worker_proxy_sock is not None:
        # a worker: the fast server is the whole process surface; the cold
        # routes raw-proxy to the primary's unix socket
        fast_server = await start_fast_server(
            deps, worker_proxy_sock, listen_host, port, reuse_port=True,
            coalesced_gin=gin_log, coalesced_server=server_log,
        )
        bound = fast_server.sockets[0].getsockname()[1]
        log.info("fast http worker listening on %s:%s", listen_host, bound)
        return ServerHandle(bound, fast_server=fast_server, fast_logs=fast_logs)
    # the full aiohttp app on a unix socket (the fast server's cold-route
    # upstream, and the workers' proxy target), the fast server on the TCP port
    tmpdir = None
    if unix_path is None:
        tmpdir = tempfile.mkdtemp(prefix="banjax-http-")
        unix_path = os.path.join(tmpdir, "app.sock")
    app = build_app(deps, listen_host=listen_host)
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    await web.UnixSite(runner, unix_path).start()
    fast_server = await start_fast_server(
        deps, unix_path, listen_host, port, reuse_port=reuse_port,
        coalesced_gin=gin_log, coalesced_server=server_log,
    )
    bound = fast_server.sockets[0].getsockname()[1]
    log.info("fast http server on %s:%s (aiohttp upstream %s)", listen_host, bound, unix_path)
    return ServerHandle(bound, runner=runner, fast_server=fast_server, tmpdir=tmpdir,
                        fast_logs=fast_logs)
