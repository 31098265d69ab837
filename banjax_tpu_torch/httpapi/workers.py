"""Multi-process SO_REUSEPORT serving of the HTTP request API: the port's
copy of `banjax_tpu/httpapi/workers.py`.

The reference is one compiled Go process, goroutine-per-request, with
shared state behind mutexes (Go banjax: internal/http_server.go:32,
rate_limit.go:105-156). One CPython event loop answers about a thousand
requests a second, so the request path scales across N worker processes
that keep the reference's decision semantics:

  * every process binds the listener's port with SO_REUSEPORT and the
    kernel spreads connections over them; nginx needs no change. The
    primary passes the port it bound to its workers (JAX workers bind the
    fixed 8081), so an ephemeral port works too;
  * the failed-challenge rate limiter, the one state the hot path
    writes, lives in the native shared-memory fc_* table
    (`native/shmstate.c`, `native/shm.py`), so an IP spreading failed
    challenges across processes is counted exactly once;
  * each worker keeps a replica of the dynamic decision lists, converged
    by a primary-to-worker broadcast (the lists' monotonic-severity
    `update` makes replays and echoes idempotent), and reads the
    primary's serving decision table, attached by name;
  * every side effect with one writer (ipset, Kafka reports, ban-log
    lines, dynamic-list inserts) is forwarded worker to primary over a
    unix datagram control socket, with the drop-don't-block discipline of
    the reference's Kafka channel (kafka.go:334-346);
  * the cold routes (`COLD_ROUTES`) are reverse-proxied to the primary
    over a unix HTTP socket: only the primary owns the rate-limit
    states, the ipset, the authoritative lists and the registries.

Workers never touch the card: they check PoW cookies on the host and are
started with no CUDA device visible; the primary alone runs the matcher
and launches kernels A, B and C. `http_workers: 0` (the default) keeps
single-process serving.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import queue
import shutil
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional

from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
from banjax_tpu_torch.decisions.model import Decision
from banjax_tpu_torch.effectors.banner import BannerInterface

log = logging.getLogger(__name__)

CONTROL_SOCK = "control.sock"
PRIMARY_HTTP_SOCK = "primary-http.sock"

# routes served by the primary only (worker reverse-proxies them)
COLD_ROUTES = (
    "/decision_lists",
    "/rate_limit_states",
    "/is_banned",
    "/ipset/list",
    "/banned",
    "/unban",
    "/healthz",
    # observability surface: the metrics registries, the trace ring, the
    # provenance ledger and the flight recorder live in the primary (the
    # pipeline/matcher run there)
    "/metrics",
    "/debug/trace",
    # fault-injection admin: failpoints are process-global module state
    # in the primary (the pipeline/matcher run there)
    "/debug/failpoints",
    "/decisions/explain",
    "/debug/incidents",
    # traffic introspection (obs/sketch.py): the sketch lives with the
    # matcher in the primary
    "/traffic/top",
)


def worker_sock_path(ctrl_dir: str, index: int) -> str:
    return os.path.join(ctrl_dir, f"worker-{index}.sock")


def _send_json(sock: socket.socket, path: str, msg: dict) -> None:
    """Fire-and-forget datagram; drops (never blocks) when the peer is gone
    or its buffer is full — the control plane inherits the kafka channel's
    drop-don't-block discipline."""
    try:
        sock.sendto(json.dumps(msg).encode(), path)
    except OSError as e:
        log.debug("control send to %s dropped: %s", path, e)


class ControlPlane:
    """Primary side: receives worker commands, broadcasts list deltas."""

    def __init__(self, ctrl_dir: str, app) -> None:
        self.ctrl_dir = ctrl_dir
        self._app = app  # BanjaxApp — executes forwarded side effects
        self._recv = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self._recv.bind(os.path.join(ctrl_dir, CONTROL_SOCK))
        self._recv.settimeout(0.5)
        self._send = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self._send.setblocking(False)
        self._worker_paths: List[str] = []
        self.ready: dict = {}  # worker index -> pid of its process that listens
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_worker(self, index: int) -> str:
        path = worker_sock_path(self.ctrl_dir, index)
        self._worker_paths.append(path)
        return path

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._recv_loop, name="control-plane", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        self._recv.close()
        self._send.close()

    def broadcast(self, msg: dict) -> None:
        for path in self._worker_paths:
            _send_json(self._send, path, msg)

    # --- worker→primary command execution ---

    def _recv_loop(self) -> None:
        while not self._stop.is_set():
            try:
                data = self._recv.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                self._handle(json.loads(data))
            except Exception as e:  # noqa: BLE001 — a bad datagram must not
                # kill the control plane
                log.warning("control plane: bad command: %s", e)

    def _handle(self, msg: dict) -> None:
        op = msg.get("op")
        app = self._app
        if op == "ban_or_challenge":
            app.banner.ban_or_challenge_ip(
                app.config_holder.get(), msg["ip"],
                Decision(int(msg["decision"])), msg["domain"],
            )
            # the worker recorded the chain-side provenance in ITS
            # process; the primary (which owns /decisions/explain)
            # ledgers the authoritative insert it just applied
            from banjax_tpu_torch.obs import provenance

            provenance.record(
                provenance.SOURCE_CHALLENGE, msg["ip"],
                Decision(int(msg["decision"])), rule="worker-forwarded",
            )
        elif op == "fc_log":
            app.banner.log_failed_challenge_ban(
                app.config_holder.get(), msg["ip"], msg["challenge_type"],
                msg["host"], msg["path"], int(msg["threshold"]), msg["ua"],
                Decision(int(msg["decision"])), msg["method"],
            )
        elif op == "ready":
            # the port's addition: a worker says it listens on the port
            self.ready[int(msg["index"])] = int(msg["pid"])
        elif op == "kafka":
            from banjax_tpu_torch.ingest import reports

            # re-inject the worker's report into the primary's queue with
            # the same drop-don't-block put
            try:
                reports.get_message_queue().put_nowait(msg["data"].encode("utf-8"))
            except queue.Full:
                log.debug("KAFKA: dropped forwarded worker report")
        else:
            log.warning("control plane: unknown op %r", op)


class ReplicatedDynamicLists(DynamicDecisionLists):
    """Primary's dynamic lists: every mutation also broadcasts a delta so
    worker replicas converge.  Monotonic-severity `update` makes the
    originator-applies-locally + broadcast-echo pattern idempotent."""

    def __init__(self, start_sweeper: bool = True):
        super().__init__(start_sweeper=start_sweeper)
        self._broadcast: Optional[Callable[[dict], None]] = None

    def set_broadcast(self, fn: Callable[[dict], None]) -> None:
        self._broadcast = fn

    def _emit(self, msg: dict) -> None:
        if self._broadcast is not None:
            self._broadcast(msg)

    def update(self, ip, expires, new_decision, from_baskerville, domain):
        super().update(ip, expires, new_decision, from_baskerville, domain)
        self._emit({
            "op": "dyn_update", "ip": ip, "expires": expires,
            "decision": int(new_decision),
            "from_baskerville": from_baskerville, "domain": domain,
        })

    def update_by_session_id(self, ip, session_id, expires, new_decision,
                             from_baskerville, domain):
        super().update_by_session_id(
            ip, session_id, expires, new_decision, from_baskerville, domain
        )
        self._emit({
            "op": "dyn_update_session", "ip": ip, "session_id": session_id,
            "expires": expires, "decision": int(new_decision),
            "from_baskerville": from_baskerville, "domain": domain,
        })

    def remove_by_ip(self, ip):
        super().remove_by_ip(ip)
        self._emit({"op": "dyn_remove", "ip": ip})

    def clear(self):
        super().clear()
        self._emit({"op": "dyn_clear"})


class WorkerControl:
    """Worker side: forwards side effects to the primary; applies
    primary broadcasts to the local replica."""

    def __init__(self, ctrl_dir: str, index: int,
                 replica: DynamicDecisionLists,
                 on_reload: Callable[[], None]) -> None:
        self._primary_path = os.path.join(ctrl_dir, CONTROL_SOCK)
        self._send = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self._send.setblocking(False)
        self._recv = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        path = worker_sock_path(ctrl_dir, index)
        if os.path.exists(path):
            os.unlink(path)
        self._recv.bind(path)
        self._recv.settimeout(0.5)
        self._replica = replica
        self._on_reload = on_reload
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._recv_loop, name="worker-control", daemon=True
        )
        self._thread.start()

    def send(self, msg: dict) -> None:
        _send_json(self._send, self._primary_path, msg)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        self._recv.close()
        self._send.close()

    def _recv_loop(self) -> None:
        while not self._stop.is_set():
            try:
                data = self._recv.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                self._apply(json.loads(data))
            except Exception as e:  # noqa: BLE001
                log.warning("worker control: bad broadcast: %s", e)

    def _apply(self, msg: dict) -> None:
        op = msg.get("op")
        if op == "dyn_update":
            self._replica.update(
                msg["ip"], float(msg["expires"]), Decision(int(msg["decision"])),
                bool(msg["from_baskerville"]), msg["domain"],
            )
        elif op == "dyn_update_session":
            self._replica.update_by_session_id(
                msg["ip"], msg["session_id"], float(msg["expires"]),
                Decision(int(msg["decision"])),
                bool(msg["from_baskerville"]), msg["domain"],
            )
        elif op == "dyn_remove":
            self._replica.remove_by_ip(msg["ip"])
        elif op == "dyn_clear":
            self._replica.clear()
        elif op == "reload":
            self._on_reload()
        else:
            log.warning("worker control: unknown op %r", op)


class RemoteBanner(BannerInterface):
    """Worker-side banner: applies the list effect locally for immediate
    visibility on THIS worker, forwards the authoritative side effects
    (ipset, ban log, kafka ip_banned report, broadcast) to the primary."""

    def __init__(self, control: WorkerControl,
                 replica: DynamicDecisionLists) -> None:
        self._control = control
        self._replica = replica

    def ban_or_challenge_ip(self, config, ip, decision, domain):
        expires = time.time() + config.expiring_decision_ttl_seconds
        self._replica.update(ip, expires, decision, False, domain)
        self._control.send({
            "op": "ban_or_challenge", "ip": ip, "decision": int(decision),
            "domain": domain,
        })

    def log_regex_ban(self, config, log_time_unix, ip, rule_name,
                      log_line_rest, decision):
        # regex bans originate in the primary's matcher; a worker never
        # takes this path
        log.warning("RemoteBanner.log_regex_ban called in a worker (unexpected)")

    def log_failed_challenge_ban(self, config, ip, challenge_type, host, path,
                                 too_many_failed_challenges_threshold,
                                 user_agent, decision, method):
        self._control.send({
            "op": "fc_log", "ip": ip, "challenge_type": challenge_type,
            "host": host, "path": path,
            "threshold": too_many_failed_challenges_threshold,
            "ua": user_agent, "decision": int(decision), "method": method,
        })

    # ipset is primary-owned; the routes that need it are proxied there.
    def ipset_add(self, config, ip):
        log.warning("RemoteBanner.ipset_add called in a worker (unexpected)")

    def ipset_test(self, config, ip):
        return False

    def ipset_list(self):
        return []

    def ipset_del(self, ip):
        log.warning("RemoteBanner.ipset_del called in a worker (unexpected)")


class PrimarySupervisor:
    """Owns worker subprocesses + the control plane, from the primary.

    A monitor thread respawns any worker that dies (crash, OOM-kill) with
    exponential backoff per worker slot — the serving capacity heals
    instead of silently degrading.  A respawned worker rebuilds its
    decision-list replica from the primary's broadcasts going forward;
    stale entries it missed while down converge via the next reload or
    expire on their TTLs (monotonic-severity updates make the partial
    window safe: it can only under-block briefly, exactly like the
    reference restarting)."""

    RESPAWN_BACKOFF_S = (1.0, 2.0, 4.0, 8.0, 16.0)
    MONITOR_INTERVAL_S = 1.0

    def __init__(self, app, ctrl_dir: str, n_workers: int,
                 health=None) -> None:
        self.ctrl_dir = ctrl_dir
        self.n_workers = n_workers
        self.port: Optional[int] = None  # the TCP port the primary bound
        self.control = ControlPlane(ctrl_dir, app)
        self._app = app
        self._procs: List[subprocess.Popen] = []
        self._respawns = [0] * n_workers
        self._next_spawn_ok = [0.0] * n_workers
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self.health = health  # resilience.health.ComponentHealth

    def primary_http_sock(self) -> str:
        return os.path.join(self.ctrl_dir, PRIMARY_HTTP_SOCK)

    def _spawn_one(self, index: int) -> subprocess.Popen:
        config = self._app.config_holder.get()
        cmd = [
            sys.executable, "-m", "banjax_tpu_torch.httpapi.worker_serve",
            "-config-file", self._app.config_holder.path,
            "-ctrl-dir", self.ctrl_dir,
            "-index", str(index),
            "-shm-name", self._app.failed_challenge_states.name,
            "-port", str(self.port),
        ]
        dt = self._app.decision_table
        if dt is not None:
            # workers attach the serving decision table read-only by name
            cmd += ["-dt-shm-name", dt.name]
        if config.standalone_testing:
            cmd.append("-standalone-testing")
        if config.debug:
            cmd.append("-debug")
        env = dict(os.environ)
        # workers never touch the card: the primary alone holds a CUDA
        # context and launches kernels A, B and C (PoW is checked on the
        # host in a worker, as JAX workers run with JAX_PLATFORMS=cpu)
        env["CUDA_VISIBLE_DEVICES"] = ""
        # the package may be run from a source tree (not installed):
        # make sure the worker can import banjax_tpu_torch
        import banjax_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(banjax_tpu_torch.__file__))
        parts = [pkg_root] + (
            env.get("PYTHONPATH", "").split(os.pathsep)
            if env.get("PYTHONPATH") else []
        )
        env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(parts))
        return subprocess.Popen(cmd, env=env)

    def spawn_workers(self, port: int) -> None:
        """Start the workers on `port`, the TCP port the primary bound."""
        self.port = port
        for i in range(self.n_workers):
            self.control.add_worker(i)
            self._procs.append(self._spawn_one(i))
        self.control.start()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="worker-monitor", daemon=True
        )
        self._monitor.start()
        log.info("spawned %d http workers (ctrl %s)", self.n_workers, self.ctrl_dir)

    def kill_worker(self, index: int, sig: int = 9) -> None:
        """Fault-injection hook (tests/faults/): deliver `sig` (default
        SIGKILL — the un-maskable OOM-kill shape) to one worker and let the
        monitor heal it."""
        proc = self._procs[index]
        if proc.poll() is None:
            os.kill(proc.pid, sig)

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.MONITOR_INTERVAL_S):
            down = sum(1 for p in self._procs if p.poll() is not None)
            if self.health is not None:
                if down:
                    self.health.degraded(
                        f"{down}/{self.n_workers} http workers down "
                        "(respawning)"
                    )
                else:
                    self.health.ok()
            for i, proc in enumerate(self._procs):
                try:
                    if proc.poll() is None:
                        continue
                    now = time.monotonic()
                    if now < self._next_spawn_ok[i]:
                        continue
                    n = self._respawns[i]
                    backoff = self.RESPAWN_BACKOFF_S[
                        min(n, len(self.RESPAWN_BACKOFF_S) - 1)
                    ]
                    self._next_spawn_ok[i] = now + backoff
                    self._respawns[i] = n + 1
                    log.warning(
                        "http worker %d exited rc=%s — respawning (attempt "
                        "%d, next backoff %.0fs)",
                        i, proc.returncode, n + 1, backoff,
                    )
                    self._procs[i] = self._spawn_one(i)
                except Exception as e:  # noqa: BLE001 — a failed spawn
                    # (fork EAGAIN under memory pressure) must not kill the
                    # monitor; the slot retries after its backoff
                    log.error("worker %d respawn failed: %s", i, e)

    def pids(self) -> List[int]:
        return [p.pid for p in self._procs]

    def wait_ready(self, timeout: float = 30.0) -> bool:
        """Wait until the process of every worker slot listens (its
        "ready" message arrived); False at the timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(p.poll() is None and self.control.ready.get(i) == p.pid
                   for i, p in enumerate(self._procs)):
                return True
            time.sleep(0.02)
        return False

    @property
    def respawn_count(self) -> int:
        return sum(self._respawns)

    def broadcast_reload(self) -> None:
        self.control.broadcast({"op": "reload"})

    def stop(self) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=3)
        for p in self._procs:
            p.terminate()
        for p in self._procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
        self.control.stop()
        shutil.rmtree(self.ctrl_dir, ignore_errors=True)


def install_proxy_routes(app, primary_sock: str) -> None:
    """Register reverse-proxy handlers for the primary-owned cold routes
    on a worker's aiohttp application."""
    import aiohttp
    from aiohttp import web

    state: dict = {"session": None}

    async def _open_session(app_):
        # created on startup (inside the running loop) — a lazy
        # check-then-set in the handler could race two first requests and
        # leak a session
        state["session"] = aiohttp.ClientSession(
            connector=aiohttp.UnixConnector(path=primary_sock)
        )

    app.on_startup.append(_open_session)

    async def proxy(request: web.Request) -> web.Response:
        sess = state["session"]
        body = await request.read()
        try:
            async with sess.request(
                request.method, f"http://primary{request.rel_url}",
                headers=request.headers, data=body,
                timeout=aiohttp.ClientTimeout(total=10),
            ) as r:
                payload = await r.read()
                resp = web.Response(status=r.status, body=payload)
                ct = r.headers.get("Content-Type")
                if ct:
                    resp.headers["Content-Type"] = ct
                return resp
        except (aiohttp.ClientError, asyncio.TimeoutError) as e:
            return web.Response(status=502, text=f"primary unavailable: {e}\n")

    for route in COLD_ROUTES:
        for method in ("GET", "POST"):
            try:
                app.router.add_route(method, route, proxy)
            except RuntimeError:
                pass  # duplicate method registration

    async def _close_session(app_):
        if state["session"] is not None:
            await state["session"].close()

    app.on_cleanup.append(_close_session)
