"""Native asyncio-protocol server for the /auth_request hot path (a copy
of `banjax_tpu/httpapi/fastserve.py`).

The hot routes are served straight from an `asyncio.Protocol`: a
hand-rolled HTTP/1.1 request parser over bytes (pipelined keep-alive),
the compiled fast path (`httpapi/fastpath.py`), then the same decision
chain, and direct response serialisation, with the wire contract of the
aiohttp app.

Routes served natively: /auth_request (the nginx subrequest), /info,
/healthz and /favicon.ico (standalone). Every other route is raw-proxied
over a unix socket to the full aiohttp application (`httpapi/server.py`;
the primary's, in a multi-process worker, which also proxies /healthz),
so the whole API stays reachable on one TCP listener. A hot request is
answered inline in `data_received`; the first proxied request turns the
connection into task mode, which keeps the requests' order.

One addition to the JAX module: a handler crash answered fail-open
(500, `X-Accel-Redirect: @fail_open`) is counted on the app's
ServeFastpathStats, so a fault of kernel C behind the chain cannot pass
for a served request.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Optional
from urllib.parse import parse_qs

from banjax_tpu_torch.httpapi.decision_chain import (
    ChainState,
    DecisionListResult,
    RequestInfo,
    Response,
    decision_for_nginx,
)
from banjax_tpu_torch.utils import go_query_escape, go_query_unescape

log = logging.getLogger(__name__)

_REASONS = {
    200: "OK", 201: "Created", 204: "No Content", 301: "Moved Permanently",
    302: "Found", 400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
    404: "Not Found", 405: "Method Not Allowed", 429: "Too Many Requests",
    413: "Request Entity Too Large",
    500: "Internal Server Error", 502: "Bad Gateway", 501: "Not Implemented",
}

MAX_HEADER_BYTES = 65536
MAX_BODY_BYTES = 10 * 1024 * 1024


def _reason(status: int) -> str:
    return _REASONS.get(status, "Unknown")


def _clean_header(value) -> str:
    """CR/LF-sanitize a header name or value (aiohttp rejects them; the
    hand-rolled serializer must too).  The fail-open 500 path puts raw
    exception text — which can embed client-controlled bytes — into
    X-Banjax-Error, so unsanitized \\r\\n here is a response-splitting
    vector."""
    s = str(value)
    if "\r" in s or "\n" in s:
        s = s.replace("\r", " ").replace("\n", " ")
    return s


def serialize_response(resp: Response, keep_alive: bool,
                       head_only: bool = False) -> bytes:
    """Response dataclass → HTTP/1.1 bytes (matches what the aiohttp app
    emits for the same Response: status, bare content_type, custom
    headers, gin-escaped cookies).  head_only keeps Content-Length but
    suppresses the body bytes (RFC 7230 HEAD semantics)."""
    body = resp.body if isinstance(resp.body, bytes) else str(resp.body).encode()
    # no charset suffix: the aiohttp app emits the bare content_type for
    # byte bodies (differential-tested)
    lines = [
        f"HTTP/1.1 {resp.status} {_reason(resp.status)}",
        f"Content-Type: {resp.content_type}",
        f"Content-Length: {len(body)}",
    ]
    for k, v in resp.headers.items():
        lines.append(f"{_clean_header(k)}: {_clean_header(v)}")
    for c in resp.cookies:
        attrs = [f"{c.name}={go_query_escape(c.value)}"]
        # `is not None`: Max-Age=0 (immediate expiry) must reach the wire —
        # the aiohttp layout emits it, and a bare `if c.max_age:` turned it
        # into a session cookie on this layout (ADVICE r5)
        if c.max_age is not None:
            attrs.append(f"Max-Age={c.max_age}")
        if c.domain:
            attrs.append(f"Domain={c.domain}")
        attrs.append(f"Path={c.path}")
        if c.secure:
            attrs.append("Secure")
        if c.http_only:
            attrs.append("HttpOnly")
        lines.append("Set-Cookie: " + _clean_header("; ".join(attrs)))
    lines.append("Connection: keep-alive" if keep_alive else "Connection: close")
    head = ("\r\n".join(lines) + "\r\n\r\n").encode()
    return head if head_only else head + body


class _ParsedRequest:
    __slots__ = ("method", "path", "query", "headers", "body",
                 "keep_alive", "raw_head")

    def __init__(self, method, path, query, headers, body,
                 keep_alive, raw_head):
        self.method = method
        self.path = path              # str, decoded-less path component
        self.query = query            # raw query string (str)
        self.headers = headers        # dict[str(lower), str]
        self.body = body              # bytes
        self.keep_alive = keep_alive
        self.raw_head = raw_head      # bytes, original head incl. final CRLFCRLF

    def header(self, name: str) -> str:
        return self.headers.get(name, "")

    def query_param(self, name: str) -> str:
        if not self.query:
            return ""
        vals = parse_qs(self.query, keep_blank_values=True).get(name)
        return vals[0] if vals else ""


class FastHttpProtocol(asyncio.Protocol):
    """One instance per connection.

    Hot requests are parsed and answered INLINE in data_received — the
    decision chain is synchronous, so the common case costs zero task
    switches.  The first cold (proxied) request flips the connection into
    task mode: an event-driven loop that preserves request ordering and
    awaits the upstream."""

    def __init__(self, server: "FastPathServer"):
        self.server = server
        self.transport: Optional[asyncio.Transport] = None
        self.buf = bytearray()
        self.peer = ""
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._closed = False
        self._task_mode = False

    # --- asyncio.Protocol ---

    def connection_made(self, transport) -> None:
        self.transport = transport
        sock = transport.get_extra_info("socket")
        if sock is not None:
            import socket as _socket

            try:
                sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            except OSError:
                pass
        peername = transport.get_extra_info("peername")
        self.peer = peername[0] if peername else "127.0.0.1"

    def data_received(self, data: bytes) -> None:
        self.buf.extend(data)
        if self._task_mode:
            self._wake.set()
            return
        self._drain_inline()

    def connection_lost(self, exc) -> None:
        self._closed = True
        if self._wake is not None:
            self._wake.set()
        if self._task is not None:
            self._task.cancel()

    def eof_received(self):
        self._closed = True
        if self._wake is not None:
            self._wake.set()
        return False

    # --- inline fast path ---

    def _drain_inline(self) -> None:
        while True:
            req = self._try_parse()
            if req is None:
                # cap an endless header stream (task mode has the same
                # check in _next_request)
                if (b"\r\n\r\n" not in self.buf
                        and len(self.buf) > MAX_HEADER_BYTES):
                    self.write(serialize_response(
                        Response(status=400, body=b"header block too large"),
                        False))
                    self.transport.close()
                return
            if self.server.is_hot(req):
                self._handle_sync(req)
                if not req.keep_alive:
                    self.transport.close()
                    return
            else:
                self._enter_task_mode(req)
                return

    def _handle_sync(self, req: "_ParsedRequest") -> None:
        try:
            self.server.handle_hot(self, req)
        except Exception as e:  # noqa: BLE001 — the fail-open recovery
            # contract (http_server.go:110-135)
            import traceback

            tb = traceback.extract_tb(e.__traceback__)
            loc = f"{tb[-1].filename}:{tb[-1].lineno}" if tb else "?"
            log.error("fastserve handler panic: %s (%s)", e, loc)
            self.server.deps.serve_stats.note_fail_open()
            resp = Response(status=500, headers={
                "X-Banjax-Error": f"{e} ({loc})",
                "X-Accel-Redirect": "@fail_open",
            })
            self.write(serialize_response(resp, req.keep_alive))

    def _enter_task_mode(self, first_req: "_ParsedRequest") -> None:
        self._task_mode = True
        self._wake = asyncio.Event()
        self._task = asyncio.ensure_future(self._run(first_req))

    # --- task mode (proxied requests / slow bodies) ---

    async def _run(self, pending: Optional["_ParsedRequest"]) -> None:
        try:
            while not self._closed:
                req = pending
                pending = None
                if req is None:
                    req = await self._next_request()
                if req is None:
                    break
                if self.server.is_hot(req):
                    self._handle_sync(req)
                else:
                    try:
                        await self.server.proxy(self, req)
                    except Exception as e:  # noqa: BLE001 — fail open
                        log.error("fastserve proxy panic: %s", e)
                        self.write(serialize_response(
                            Response(status=502,
                                     body=f"proxy error: {e}\n".encode()),
                            False,
                        ))
                        break
                if not req.keep_alive:
                    break
        except asyncio.CancelledError:
            pass
        finally:
            if self.transport is not None and not self.transport.is_closing():
                self.transport.close()

    async def _next_request(self) -> Optional[_ParsedRequest]:
        while True:
            req = self._try_parse()
            if req is not None:
                return req
            if self._closed:
                return None
            if len(self.buf) > MAX_HEADER_BYTES:
                self.write(serialize_response(
                    Response(status=400, body=b"header block too large"),
                    False))
                return None
            self._wake.clear()
            await self._wake.wait()

    # --- shared parser: consumes from buf ONLY when a complete request
    # (head + body) is buffered; returns None otherwise ---

    def _try_parse(self) -> Optional[_ParsedRequest]:
        end = self.buf.find(b"\r\n\r\n")
        if end < 0:
            return None
        head_len = end + 4
        try:
            head = bytes(self.buf[:end]).decode("latin-1")
            req_line, *hdr_lines = head.split("\r\n")
            method, target, version = req_line.split(" ", 2)
            headers = {}
            for hl in hdr_lines:
                k, _, v = hl.partition(":")
                k = k.strip().lower()
                if k == "content-length" and k in headers \
                        and headers[k] != v.strip():
                    # conflicting Content-Length values: reject (RFC 7230)
                    # — last-wins would reopen the body-smuggling desync
                    # the Transfer-Encoding guard below closes
                    raise ValueError("conflicting content-length")
                headers[k] = v.strip()
        except ValueError:
            self.write(serialize_response(
                Response(status=400, body=b"bad request"), False))
            self.transport.close()
            return None
        if "transfer-encoding" in headers:
            # no chunked-request support: accepting the head with clen=0
            # would leave the chunked body in the buffer to be re-parsed
            # as a smuggled pipelined request
            self.write(serialize_response(
                Response(status=501, body=b"transfer-encoding unsupported"),
                False))
            self.transport.close()
            return None
        clen = 0
        if "content-length" in headers:
            try:
                clen = int(headers["content-length"])
            except ValueError:
                clen = -1
            if clen < 0 or clen > MAX_BODY_BYTES:
                # reject outright — clamping would leave body bytes in the
                # buffer to be re-parsed as a smuggled pipelined request
                status = 413 if clen > MAX_BODY_BYTES else 400
                self.write(serialize_response(
                    Response(status=status, body=b"bad content-length"),
                    False))
                self.transport.close()
                return None
        if len(self.buf) < head_len + clen:
            return None  # body not fully buffered yet
        raw_head = bytes(self.buf[:head_len])
        body = bytes(self.buf[head_len : head_len + clen])
        del self.buf[: head_len + clen]
        path, _, query = target.partition("?")
        conn = headers.get("connection", "").lower()
        keep_alive = (version == "HTTP/1.1" and conn != "close") or (
            conn == "keep-alive"
        )
        return _ParsedRequest(method, path, query, headers, body,
                              keep_alive, raw_head)

    def write(self, data: bytes) -> None:
        if self.transport is not None and not self.transport.is_closing():
            self.transport.write(data)


class FastPathServer:
    """Builds native handlers from ServerDeps; owns the upstream proxy."""

    def __init__(self, deps, proxy_sock: str,
                 coalesced_gin=None, coalesced_server=None,
                 listen_host: str = "127.0.0.1"):
        self.deps = deps
        self.proxy_sock = proxy_sock
        self.gin_log = coalesced_gin
        self.server_log = coalesced_server
        self.listen_host = listen_host  # admin-surface auth gate input
        config0 = deps.config_holder.get()
        self.standalone = config0.standalone_testing
        # compiled /auth_request fast path: decision-table hit → template
        # bytes, anything else (miss / fault / ineligible) → the chain
        from banjax_tpu_torch.httpapi.fastpath import AuthFastPath

        self.fastpath = AuthFastPath(deps)

    # ------------------------------------------------------------- handle

    def is_hot(self, req: _ParsedRequest) -> bool:
        # exact route + method matching, mirroring the aiohttp router:
        # /auth_request is ANY-method; /info, /healthz and /favicon.ico are
        # GET-only (other methods proxy upstream and get aiohttp's 405/404)
        path = req.path
        if path == "/auth_request":
            return True
        if req.method != "GET":
            return False
        if path == "/healthz" and self.deps.health is not None:
            # served natively so health stays answerable even when the
            # aiohttp upstream is the thing that is wedged
            return True
        return path == "/info" or (self.standalone and path == "/favicon.ico")

    def handle_hot(self, proto: FastHttpProtocol, req: _ParsedRequest) -> None:
        start = time.monotonic()
        path = req.path

        # --- standalone middleware (http_server.go:137-169) ---
        if self.standalone:
            client_ip = req.header("x-client-ip") or proto.peer or "127.0.0.1"
            query_path = req.query_param("path")  # parsed once per request
            # req.headers is built fresh per request in _try_parse — safe
            # to update in place (the reference mutates its shared header
            # map the same way)
            req.headers.update({
                "x-client-ip": client_ip,
                "x-requested-host": req.header("host"),
                "x-requested-path": query_path,
                "x-client-user-agent": req.header("x-client-user-agent")
                or "mozilla",
            })
            if self.server_log is not None:
                self.server_log.write(
                    "%f %s %s %s %s %s HTTP/1.1 %s\n"
                    % (
                        float(int(time.time())),
                        client_ip,
                        req.method,
                        req.header("host"),
                        req.method,
                        query_path,
                        req.header("user-agent"),
                    )
                )

        if path == "/info":
            body = json.dumps({
                "config_version": self.deps.config_holder.get().config_version
            }).encode()
            # aiohttp's json_response content type, charset included
            resp = Response(status=200, body=body,
                            content_type="application/json; charset=utf-8")
        elif path == "/healthz":
            # same admin gate as the aiohttp layout (server.admin_auth_ok):
            # bearer-token required when the listener binds non-loopback
            from banjax_tpu_torch.httpapi.server import admin_auth_ok

            if not admin_auth_ok(
                self.deps.config_holder.get(), self.listen_host,
                req.header("authorization"),
            ):
                resp = Response(
                    status=401,
                    body=b'{"error": "unauthorized"}',
                    content_type="application/json; charset=utf-8",
                    headers={"WWW-Authenticate": "Bearer"},
                )
            else:
                snap = self.deps.health.snapshot()
                resp = Response(
                    status=503 if snap["status"] == "failed" else 200,
                    body=json.dumps(snap).encode(),
                    content_type="application/json; charset=utf-8",
                )
        elif path == "/favicon.ico":
            # the aiohttp route uses web.Response(text="") — charset added
            resp = Response(status=200, body=b"",
                            content_type="text/plain; charset=utf-8")
        else:
            fast = self.fastpath.try_serve(req)
            if fast is not None:
                raw, status = fast
                proto.write(raw)
                self._access_log(req, path, status, start)
                return
            resp = self._auth_request(req)
        proto.write(serialize_response(
            resp, req.keep_alive, head_only=req.method == "HEAD"
        ))
        self._access_log(req, path, resp.status, start)

    def _access_log(self, req: _ParsedRequest, path: str, status: int,
                    start: float) -> None:
        """Access log middleware (http_server.go:65-95) — shared by the
        template fast path and the full-chain path so both emit the same
        gin-shaped line."""
        if self.gin_log is not None:
            latency_us = int((time.monotonic() - start) * 1e6)
            line = {
                "Time": time.strftime("%a, %d %b %Y %H:%M:%S %Z"),
                "ClientIp": req.header("x-client-ip"),
                "ClientReqHost": req.header("x-requested-host"),
                "ClientReqPath": req.header("x-requested-path"),
                "Method": req.method,
                "Path": path,
                "Status": status,
                "Latency": latency_us,
            }
            self.gin_log.write(json.dumps(line) + "\n")

    def _auth_request(self, req: _ParsedRequest) -> Response:
        deps = self.deps
        config = deps.config_holder.get()
        cookies = {}
        raw = req.header("cookie")
        if raw:
            for part in raw.split(";"):
                name, eq, value = part.strip().partition("=")
                if not eq:
                    continue
                try:
                    # gin reads cookies through url.QueryUnescape; a value
                    # whose unescape fails is treated as absent
                    cookies[name] = go_query_unescape(value)
                except ValueError:
                    continue
        info = RequestInfo(
            client_ip=req.header("x-client-ip"),
            requested_host=req.header("x-requested-host"),
            requested_path=req.header("x-requested-path"),
            client_user_agent=req.header("x-client-user-agent"),
            method=req.method,
            cookies=cookies,
        )
        state = ChainState(
            config=config,
            static_lists=deps.static_lists,
            dynamic_lists=deps.dynamic_lists,
            protected_paths=deps.protected_paths,
            failed_challenge_states=deps.failed_challenge_states,
            banner=deps.banner,
            challenge_verifier=deps.challenge_verifier,
        )
        resp, result = decision_for_nginx(state, info)
        if config.debug:
            log.info("decisionForNginx: %s", result.to_json())
        elif result.decision_list_result != DecisionListResult.NO_MENTION:
            log.info("decisionForNginx: %s", result.to_json())
        return resp

    # -------------------------------------------------------------- proxy

    async def proxy(self, proto: FastHttpProtocol, req: _ParsedRequest) -> None:
        """Forward the request verbatim to the aiohttp app on the unix
        socket and relay the response bytes back."""
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_unix_connection(self.proxy_sock), timeout=10
            )
        except (OSError, asyncio.TimeoutError) as e:
            proto.write(serialize_response(
                Response(status=502, body=f"upstream unavailable: {e}\n".encode()),
                req.keep_alive,
            ))
            return
        try:
            writer.write(req.raw_head + req.body)
            await writer.drain()
            head = await asyncio.wait_for(
                reader.readuntil(b"\r\n\r\n"), timeout=60
            )
            proto.write(head)
            hdr_text = head[:-4].decode("latin-1").lower()
            clen = None
            chunked = "transfer-encoding: chunked" in hdr_text
            for line in hdr_text.split("\r\n")[1:]:
                if line.startswith("content-length:"):
                    clen = int(line.split(":", 1)[1])
            if req.method == "HEAD":
                pass  # header-only response; no body follows Content-Length
            elif chunked:
                while True:
                    size_line = await asyncio.wait_for(
                        reader.readline(), timeout=60
                    )
                    proto.write(size_line)
                    size = int(size_line.strip() or b"0", 16)
                    chunk = await asyncio.wait_for(
                        reader.readexactly(size + 2), timeout=60
                    )
                    proto.write(chunk)
                    if size == 0:
                        break
            elif clen:
                remaining = clen
                while remaining > 0:
                    chunk = await asyncio.wait_for(
                        reader.read(min(65536, remaining)), timeout=60
                    )
                    if not chunk:
                        break
                    proto.write(chunk)
                    remaining -= len(chunk)
        except (OSError, asyncio.IncompleteReadError, asyncio.TimeoutError,
                ValueError) as e:
            log.warning("fastserve proxy error: %s", e)
            proto.write(serialize_response(
                Response(status=502, body=f"upstream error: {e}\n".encode()),
                False,
            ))
            if proto.transport is not None:
                proto.transport.close()
        finally:
            writer.close()


async def start_fast_server(deps, proxy_sock: str, host: str, port: int,
                            reuse_port: bool = False,
                            coalesced_gin=None, coalesced_server=None):
    """Bind the fast-path protocol server; returns the asyncio Server.
    `reuse_port` sets SO_REUSEPORT (multi-process serving)."""
    fps = FastPathServer(deps, proxy_sock, coalesced_gin, coalesced_server,
                         listen_host=host)
    loop = asyncio.get_running_loop()
    return await loop.create_server(lambda: FastHttpProtocol(fps), host, port,
                                    reuse_port=reuse_port or None)
