"""Streaming pipeline scheduler: overlapped tailer -> card -> effector
batching (a port of `banjax_tpu/pipeline/scheduler.py`).

Stages, one thread each::

    tailer -> submit() -> [admission buffer]
        -> encode  (batch formation at the adaptive target; the native
                   parse, gate and encode, `matcher.pipeline_begin`, fanned
                   across the encode pool when the batch is large enough)
        -> device  (`matcher.pipeline_submit`: admission, the refused
                   rows' windows, one fused program a chunk on the card,
                   kernel A then kernel B; up to two batches in flight, so
                   that batch N's `pipeline_collect` waits while batch N+1
                   computes)
        -> drain   (strictly FIFO: event pulls, replays, Banner, ban-log
                   lines, staleness accounting — `matcher.pipeline_finish`)

so batch N+1 encodes while batch N runs on the card and batch N-1 drains.

Ordering contract: the drain stage is one thread consuming batches in
admission order, so window updates and ban-log lines stay in log order
across batch boundaries. Window state is written at two places — commits
at submit on the device thread, classic applies at drain on the drain
thread — whose order the matcher decides on the host (its drain-window
gate); both threads enqueue on the card's default stream, so the host's
order is the card's.

Backpressure: a bounded ring of in-flight batches (`pipeline_ring_size`)
gates the encode stage; when the ring is full the admission buffer
absorbs up to `pipeline_buffer_lines`, beyond which submit() blocks the
tailer for at most `pipeline_max_block_ms` and then sheds OLDEST lines
first, counting every shed line.

Staleness: the matcher commits at submit, so the 10 s cutoff is taken
there from this scheduler's clock; the classic pend re-checks it at
drain. Stale lines are counted.

Failures (the port's contract): a batch whose encode or device stage
failed, or that the open breaker refused at the device stage, drains
generically through `matcher.consume_lines_serial` on the card — unless
its device stage had already committed something (`matcher.
pipeline_recover`): rerun whole, those hits would count twice, so it
drains through `pipeline_finish`, which replays the committed part once
and runs the rest on the classic path. Both count as fallback batches.
A batch that failed at or before its submit is a barrier: the device
thread waits for its drain before it submits the next batch, so that the
next batch's admission, slot and window work follows it as in the
synchronous path. A batch whose drain raises — the open breaker's
`BreakerOpen` among them — is counted in the drain-error lines and
aborted (its turns and pins released): admitted == processed + shed +
failed, where processed includes the stale lines.
Nothing moves to the host. Failpoints pipeline.encode, .encode_shard,
.submit, .collect and .drain sit at the stage boundaries; an optional
timer probe (`matcher_probe_seconds`) pushes a canned line through the
idle card so that a wedged card trips the breaker, and a half-open one
closes, without traffic.

Commands: submit_commands() admits items into the same buffer as tailer
lines, with the same bound and accounting, and the drain thread runs
each handler in admission order (the Kafka reader feeds this lane under
`pipeline_kafka`).

Tracing (`obs/trace.py`, off by default): a batch gets its trace id at
take-time and a root `admission` span that rides it to the drain; the
stages record `encode` (with an `encode-shard` child a shard), `submit`
(inside it the matcher's `program-ab-fused` span a chunk, and, with the
profiler bridge on, an NVTX range carrying the trace id), `collect` and
`drain` (the matcher's `effector-replay` a chunk), as in JAX. Instants:
`shed`, `device-failure`, and `breaker-refuse` where the JAX scheduler's
`breaker-reroute` stands (the port refuses). A shed burst and a drain
error notify the flight recorder (`obs/flightrec.py`), outside every
scheduler lock.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

from banjax_tpu_torch.obs import flightrec, trace
from banjax_tpu_torch.obs.stats import PipelineStats
from banjax_tpu_torch.pipeline.sizer import AdaptiveBatchSizer
from banjax_tpu_torch.resilience import failpoints
from banjax_tpu_torch.resilience.breaker import OPEN

log = logging.getLogger(__name__)

# a shard below this many rows costs more in fan-out and merge than the
# parallel parse saves; batches smaller than twice this stay single-thread
_MIN_SHARD_LINES = 2048
# the encode stage's wait before it asks again for a matcher it could not get
_NO_MATCHER_RETRY_S = 1.0


def resolve_encode_workers(v: int) -> int:
    """-1 = auto: min(4, cores), but 0 (single-thread, no pool) on a
    single-core host where a worker adds handoff latency for nothing."""
    if v >= 0:
        return v
    cores = os.cpu_count() or 1
    return min(4, cores) if cores > 1 else 0


def _bind(matcher) -> None:
    bind = getattr(matcher, "bind_thread", None)
    if bind is not None:
        bind()


class _Batch:
    __slots__ = ("lines", "matcher", "state", "t_encode_ms", "t_device_ms",
                 "t0_device", "kind", "e2e", "drained", "recovered", "trace_id",
                 "root_span")

    def __init__(self, lines: list, kind: str = "lines"):
        self.lines = lines      # log lines, or _Command items (kind="cmd")
        self.matcher = None
        self.state = None       # split-protocol state; None = generic drain
        self.t_encode_ms = 0.0
        self.t_device_ms = 0.0
        self.t0_device = 0.0
        self.kind = kind
        # {hop: oldest tailer-read monotonic stamp} of the lines it took
        # ("local": tailed here, "fabric": forwarded by a fabric peer)
        self.e2e: dict = {}
        self.drained: Optional[threading.Event] = None  # set for a barrier batch
        # its device stage failed after a commit: it drains through
        # pipeline_finish, which finishes what was not committed
        self.recovered = False
        # span propagation: the trace id allocated at take-time and the
        # root span that rides the batch to its drain
        self.trace_id = 0
        self.root_span = trace.NOOP_SPAN


class _Command:
    """One command riding the admission buffer: the raw payload and its
    handler. Commands share the buffer bound, the shed and the accounting
    with tailer lines; the drain stage runs them in admission order."""

    __slots__ = ("raw", "handler")

    def __init__(self, raw: bytes, handler: Callable[[bytes], None]):
        self.raw = raw
        self.handler = handler


class PipelineScheduler:
    def __init__(
        self,
        matcher_getter: Callable[[], object],
        ring_size: int = 4,
        latency_budget_ms: float = 250.0,
        buffer_lines: int = 131072,
        max_block_ms: float = 250.0,
        min_batch: int = 64,
        max_batch: int = 16384,
        probe_seconds: float = 0.0,
        encode_workers: int = 0,
        command_take_max: int = 1024,
        health=None,
        on_results: Optional[Callable[[List[str], Optional[list]], None]] = None,
        now_fn: Callable[[], float] = time.time,
    ):
        if ring_size < 1:
            raise ValueError(f"ring_size must be >= 1, got {ring_size}")
        if buffer_lines < 1:
            raise ValueError(f"buffer_lines must be >= 1, got {buffer_lines}")
        self._matcher_getter = matcher_getter
        self.ring_size = ring_size
        self.buffer_lines = buffer_lines
        self.max_block_s = max(0.0, max_block_ms) / 1e3
        self.probe_seconds = probe_seconds
        # the sharded encode pool (0 = single-thread encode): the native
        # parse releases the interpreter lock, so shards overlap there
        self.encode_workers = max(0, int(encode_workers))
        self._encode_pool = None  # created at start(), joined at stop()
        self._health = health
        # (lines, results or None) per drained line batch, in admission order
        self.on_results = on_results
        self._now_fn = now_fn
        self._sizer = AdaptiveBatchSizer(
            latency_budget_ms, min_batch=min_batch, max_batch=max_batch,
            command_max=command_take_max,
        )
        self.stats = PipelineStats()
        self._buf: deque = deque()
        # read stamps parallel to the LINE items in _buf: [count, t_read,
        # hop] per admitted chunk, trimmed in lockstep by sheds and takes
        self._marks: deque = deque()
        self._cond = threading.Condition()
        self._inflight = 0
        self._probing = False
        self._last_activity = time.monotonic()
        self._ring = threading.Semaphore(ring_size)
        self._q_dev: "queue.Queue" = queue.Queue()
        self._q_drain: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    @classmethod
    def from_config(cls, matcher_getter, config, health=None, on_results=None):
        return cls(
            matcher_getter,
            ring_size=config.pipeline_ring_size,
            latency_budget_ms=config.pipeline_latency_budget_ms,
            buffer_lines=config.pipeline_buffer_lines,
            max_block_ms=config.pipeline_max_block_ms,
            max_batch=max(64, config.matcher_batch_lines),
            probe_seconds=config.matcher_probe_seconds,
            encode_workers=resolve_encode_workers(config.encode_workers),
            command_take_max=config.pipeline_command_take_max,
            health=health,
            on_results=on_results,
        )

    # ---- lifecycle ----

    def start(self) -> None:
        if self.encode_workers > 0 and self._encode_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._encode_pool = ThreadPoolExecutor(
                max_workers=self.encode_workers,
                thread_name_prefix="pipeline-encode-worker",
            )
        loops = [
            ("pipeline-encode", self._encode_loop),
            ("pipeline-device", self._device_loop),
            ("pipeline-drain", self._drain_loop),
        ]
        if self.probe_seconds > 0:
            loops.append(("pipeline-probe", self._probe_loop))
        for name, fn in loops:
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        if self._health is not None:
            self._health.ok()

    def stop(self, timeout: float = 10.0) -> bool:
        """Drain everything already admitted, then stop the stage threads.
        False when a thread is still running after `timeout`."""
        with self._cond:
            self._stop.set()
            self._cond.notify_all()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.1, deadline - time.monotonic()))
        alive = any(t.is_alive() for t in self._threads)
        self._threads = []
        if self._encode_pool is not None:
            # after the stage threads joined no new shard work can arrive
            self._encode_pool.shutdown(wait=not alive)
            self._encode_pool = None
        return not alive

    def flush(self, timeout: float = 60.0) -> bool:
        """Block until every admitted line has drained."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._buf or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
        return True

    def wait_idle(self, timeout: float = 60.0) -> bool:
        """Block until no batch is in flight and no probe runs (a matcher
        rebuild waits here, so that it happens between batches)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._inflight or self._probing:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
        return True

    # ---- admission (tailer thread) ----

    def submit(self, lines: Sequence[str], t_read: Optional[float] = None,
               hop: str = "local") -> None:
        """Admit a chunk of log lines. Blocks for at most
        `pipeline_max_block_ms` when the buffer is full, then sheds
        oldest-first. `t_read` is the tailer-read monotonic stamp and
        `hop` whether the chunk was tailed here ("local") or arrived
        from a fabric peer ("fabric"): both key the
        banjax_e2e_latency_seconds{hop} histogram at drain time."""
        self._admit(list(lines), t_read=t_read, hop=hop)

    def submit_commands(self, raws: Sequence[bytes],
                        handler: Callable[[bytes], None]) -> None:
        """Admit commands into the same buffer as tailer lines (the same
        bound, shed and accounting); the drain stage runs `handler(raw)`
        for each in admission order."""
        self._admit([_Command(r, handler) for r in raws], hop=None)

    def _mark_drop_locked(self) -> None:
        if not self._marks:
            return
        m = self._marks[0]
        m[0] -= 1
        if m[0] <= 0:
            self._marks.popleft()

    def _take_marks_locked(self, n: int) -> dict:
        """Consume the marks of `n` line items taken off the buffer head;
        returns {hop: oldest stamp} over the stamped ones."""
        out: dict = {}
        while n > 0 and self._marks:
            m = self._marks[0]
            took = min(n, m[0])
            if m[1] is not None and (m[2] not in out or m[1] < out[m[2]]):
                out[m[2]] = m[1]
            m[0] -= took
            n -= took
            if m[0] <= 0:
                self._marks.popleft()
        return out

    def _admit(self, lines: list, t_read: Optional[float] = None,
               hop: Optional[str] = "local") -> None:
        if not lines:
            return
        self.stats.note_admitted(len(lines))
        deadline: Optional[float] = None
        shed_burst = 0
        with self._cond:
            self._last_activity = time.monotonic()
            while (
                len(self._buf) + len(lines) > self.buffer_lines
                and not self._stop.is_set()
            ):
                if deadline is None:
                    deadline = time.monotonic() + self.max_block_s
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            overflow = len(self._buf) + len(lines) - self.buffer_lines
            if overflow > 0:
                # sustained overload: oldest-first shed, every line counted
                dropped = 0
                while overflow > 0 and self._buf:
                    item = self._buf.popleft()
                    if isinstance(item, str):
                        self._mark_drop_locked()
                    overflow -= 1
                    dropped += 1
                if overflow > 0:  # the chunk alone exceeds the buffer bound
                    lines = lines[overflow:]
                    dropped += overflow
                self.stats.note_shed(dropped)
                # a shed belongs to no single batch: a stream-level instant
                trace.instant("shed", {"lines": dropped, "buffered": len(self._buf)})
                if self._health is not None:
                    self._health.degraded(f"overload: shed {dropped} lines")
                shed_burst = dropped
            was_empty = not self._buf
            self._buf.extend(lines)
            if hop is not None and lines:
                self._marks.append([len(lines), t_read, hop])
            if was_empty:
                # the encode thread sleeps only on an empty buffer
                self._cond.notify_all()
        if shed_burst:
            # the recorder writes files: outside the condition's lock
            flightrec.notify("shed-burst", f"shed {shed_burst} lines")

    # ---- encode stage ----

    def _encode_loop(self) -> None:
        try:
            while True:
                with self._cond:
                    while not self._buf and not self._stop.is_set():
                        self._cond.wait(0.2)
                    if not self._buf and self._stop.is_set():
                        return
                # reserve a ring slot outside the lock: while the ring is
                # full the admission buffer keeps absorbing (and shedding)
                if not self._ring.acquire(timeout=0.2):
                    continue
                # the matcher before the take: a rebuild after a reload
                # waits in the getter until the batches in flight drained
                try:
                    matcher = self._matcher_getter()
                except Exception as e:  # noqa: BLE001 — reported as failed health; retried
                    # the lines stay buffered (bounded, shed and counted
                    # as ever) until a matcher can be built
                    log.exception("pipeline: no matcher")
                    if self._health is not None:
                        self._health.failed(f"no matcher: {e!r}")
                    self._ring.release()
                    self._stop.wait(_NO_MATCHER_RETRY_S)
                    continue
                with self._cond:
                    # take what is buffered up to the target (never wait
                    # for a fuller batch); a batch is a run of one kind
                    is_cmd = bool(self._buf) and isinstance(self._buf[0], _Command)
                    take = min(
                        len(self._buf),
                        self._sizer.command_target() if is_cmd else self._sizer.target(),
                    )
                    lines = []
                    while (
                        len(lines) < take and self._buf
                        and isinstance(self._buf[0], _Command) == is_cmd
                    ):
                        lines.append(self._buf.popleft())
                    e2e = self._take_marks_locked(len(lines)) if lines and not is_cmd else {}
                    if lines:
                        self._inflight += 1
                        self.stats.note_inflight(self._inflight)
                    self._cond.notify_all()
                if not lines:  # a shed emptied the buffer under us
                    self._ring.release()
                    continue
                batch = _Batch(lines, kind="cmd" if is_cmd else "lines")
                batch.e2e = e2e
                batch.matcher = matcher
                if trace.enabled():
                    batch.trace_id = trace.new_trace()
                    batch.root_span = trace.begin(
                        "admission", batch.trace_id,
                        args={"items": len(lines), "kind": batch.kind},
                    )
                if not is_cmd:
                    self._encode_batch(batch)
                self._q_dev.put(batch)
        finally:
            self._q_dev.put(None)

    def _encode_batch(self, batch: _Batch) -> None:
        t0 = time.perf_counter()
        matcher = batch.matcher
        breaker = getattr(matcher, "breaker", None)
        with trace.span("encode", batch.trace_id, parent=batch.root_span.span_id) as sp:
            # breaker open: no split encode; the generic drain refuses the batch
            if hasattr(matcher, "pipeline_begin") and not (
                breaker is not None and breaker.state == OPEN
            ):
                try:
                    failpoints.check("pipeline.encode")
                    batch.state = self._begin_state(matcher, batch.lines, sp)
                except Exception:  # noqa: BLE001 — the batch drains generically; nothing is lost
                    log.exception("pipeline encode stage failed; the batch drains generically")
                    sp.note("failed", True)
                    batch.state = None
            elif breaker is not None and breaker.state == OPEN:
                sp.note("breaker", "open-skip")
        batch.t_encode_ms = (time.perf_counter() - t0) * 1e3

    def _begin_state(self, matcher, lines: List[str], encode_span=trace.NOOP_SPAN):
        """pipeline_begin, sharded across the encode pool when the batch is
        large enough to pay for the fan-out. Shards are contiguous row
        ranges and the matcher's merge keeps line order, so the output is
        the single-thread encode's. A failing shard fails this batch only
        (it drains generically); the pool survives. Each shard records an
        `encode-shard` child of the encode span (one covering the whole
        parse on the single-thread path)."""
        now = self._now_fn()
        pool = self._encode_pool
        n = len(lines)
        tid, parent = encode_span.trace_id, encode_span.span_id
        n_shards = 0
        if (
            pool is not None
            and hasattr(matcher, "encode_shard")
            and hasattr(matcher, "pipeline_begin_from_shards")
        ):
            n_shards = min(self.encode_workers, n // _MIN_SHARD_LINES)
        if n_shards < 2:
            with trace.span("encode-shard", tid, parent,
                            args={"shard": 0, "shards": 1, "rows": n}):
                return matcher.pipeline_begin(lines, now)
        bounds = [n * k // n_shards for k in range(n_shards + 1)]
        shard_ms = [0.0] * n_shards

        def run(k: int):
            t = time.perf_counter()
            with trace.span("encode-shard", tid, parent,
                            args={"shard": k, "shards": n_shards,
                                  "rows": bounds[k + 1] - bounds[k]}):
                failpoints.check("pipeline.encode_shard")
                out = matcher.encode_shard(lines[bounds[k] : bounds[k + 1]], now)
            shard_ms[k] = (time.perf_counter() - t) * 1e3
            return out

        t_fan = time.perf_counter()
        futs = [pool.submit(run, k) for k in range(n_shards)]
        shards = []
        err = None
        for k, f in enumerate(futs):
            try:
                shards.append((bounds[k], f.result()))
            except Exception as e:  # noqa: BLE001 — await every future before raising
                err = err or e
        if err is not None:
            raise err
        self.stats.note_encode_shards(shard_ms, (time.perf_counter() - t_fan) * 1e3)
        return matcher.pipeline_begin_from_shards(lines, now, shards)

    # ---- device stage ----

    def _device_loop(self) -> None:
        pending: deque = deque()  # submitted, awaiting collect (<= 2)
        try:
            while True:
                if pending:
                    # something is in flight: take only work already
                    # queued, else collect now
                    try:
                        batch = self._q_dev.get_nowait()
                    except queue.Empty:
                        self._collect(pending.popleft())
                        continue
                else:
                    batch = self._q_dev.get()
                if batch is None:
                    while pending:
                        self._collect(pending.popleft())
                    return
                if batch.kind == "cmd":
                    # no device work; everything before it reaches drain first
                    while pending:
                        self._collect(pending.popleft())
                    self._q_drain.put(batch)
                    continue
                if batch.state is not None:
                    _bind(batch.matcher)
                    breaker = getattr(batch.matcher, "breaker", None)
                    if breaker is not None and not breaker.allow():
                        trace.instant("breaker-refuse", {"state": breaker.state},
                                      trace_id=batch.trace_id)
                        batch.state = None  # the generic drain refuses it
                    else:
                        batch.t0_device = time.perf_counter()
                        try:
                            failpoints.check("pipeline.submit")
                            with trace.span("submit", batch.trace_id,
                                            parent=batch.root_span.span_id), \
                                    trace.step_annotation(batch.trace_id):
                                batch.matcher.pipeline_submit(batch.state, now=self._now_fn())
                            # submit's half of the device time; collect adds its own
                            batch.t_device_ms = (time.perf_counter() - batch.t0_device) * 1e3
                        except Exception:  # noqa: BLE001 — the batch drains generically, counted
                            log.exception("pipeline submit stage failed; the batch drains "
                                          "generically on the card")
                            self._device_failure(batch, "submit")
                        else:
                            pending.append(batch)
                            # keep <= 2 in flight: collect the older batch
                            # while this one computes
                            while len(pending) >= 2:
                                self._collect(pending.popleft())
                            continue
                # a generic batch keeps FIFO order, and is a barrier: the
                # next submit waits for its drain
                while pending:
                    self._collect(pending.popleft())
                batch.drained = threading.Event()
                self._q_drain.put(batch)
                batch.drained.wait()
        finally:
            self._q_drain.put(None)

    def _collect(self, batch: _Batch) -> None:
        t0 = time.perf_counter()
        try:
            failpoints.check("pipeline.collect")
            with trace.span("collect", batch.trace_id, parent=batch.root_span.span_id):
                batch.matcher.pipeline_collect(batch.state)
        except Exception:  # noqa: BLE001 — the batch drains generically, counted
            log.exception("pipeline collect stage failed; the batch drains generically "
                          "on the card")
            self._device_failure(batch, "collect")
        else:
            batch.t_device_ms += (time.perf_counter() - t0) * 1e3
            self.stats.observe_device(batch.t_device_ms / 1e3)
            note = getattr(batch.matcher, "note_device_outcome", None)
            if note is not None:
                note(batch.t_device_ms / 1e3, ok=True)
        self._q_drain.put(batch)

    def _device_failure(self, batch: _Batch, stage: str) -> None:
        trace.instant("device-failure", {"stage": stage}, trace_id=batch.trace_id)
        # a batch that committed something keeps its state: rerun whole,
        # its committed hits would count twice. Otherwise settle what it
        # holds (order turns, pins, its drain-window slot) before the
        # generic rerun — idempotent
        recover = getattr(batch.matcher, "pipeline_recover", None)
        if batch.state is not None and recover is not None and recover(batch.state):
            batch.recovered = True
        else:
            abort = getattr(batch.matcher, "pipeline_abort", None)
            if abort is not None and batch.state is not None:
                self._abort(abort, batch.state)
            batch.state = None
        batch.t_device_ms = max(batch.t_device_ms,
                                (time.perf_counter() - batch.t0_device) * 1e3)
        note = getattr(batch.matcher, "note_device_outcome", None)
        if note is not None:
            note(batch.t_device_ms / 1e3, ok=False)

    def _abort(self, abort, state) -> None:
        """Settle a batch that will not finish; a stage thread must outlive
        a failure here, which is logged and fails the component's health."""
        try:
            abort(state)
        except Exception as e:  # noqa: BLE001 — logged and reported as failed health
            log.exception("pipeline abort failed")
            if self._health is not None:
                self._health.failed(f"abort failed: {e!r}")

    # ---- drain stage (admission order: the ordering contract) ----

    def _drain_loop(self) -> None:
        while True:
            batch = self._q_drain.get()
            if batch is None:
                return
            t0 = time.perf_counter()
            n = len(batch.lines)
            results = None
            ok = True
            sp = trace.span("drain", batch.trace_id, parent=batch.root_span.span_id)
            with sp:
                try:
                    failpoints.check("pipeline.drain")
                    now = self._now_fn()
                    if batch.kind == "cmd":
                        # a bad command loses itself, not the batch (the
                        # handler owns its parse errors)
                        for item in batch.lines:
                            try:
                                item.handler(item.raw)
                            except Exception:  # noqa: BLE001 — logged; the next command runs
                                log.exception("pipeline command dispatch failed")
                        self.stats.note_commands(n)
                    elif batch.state is None:
                        # the generic path: consume_lines' breaker and all,
                        # without the fused program's order turns
                        _bind(batch.matcher)
                        sp.note("fallback", "generic-drain")
                        consume = (getattr(batch.matcher, "consume_lines_serial", None)
                                   or batch.matcher.consume_lines)
                        results = consume(batch.lines, now)
                        self.stats.note_batch(fallback=True)
                    else:
                        _bind(batch.matcher)
                        results, n_stale = batch.matcher.pipeline_finish(batch.state, now)
                        if n_stale:
                            sp.note("stale_dropped", n_stale)
                            self.stats.note_stale(n_stale)
                        self.stats.note_batch(fallback=batch.recovered)
                except Exception:  # noqa: BLE001 — a failed batch is counted, never silent
                    ok = False
                    results = None
                    log.exception("pipeline drain stage failed; %d lines counted as failed", n)
                    self.stats.note_drain_error(n)
                    if batch.state is not None:
                        abort = getattr(batch.matcher, "pipeline_abort", None)
                        if abort is not None:
                            self._abort(abort, batch.state)
                    if self._health is not None:
                        self._health.degraded(f"drain failure; {n} lines counted as failed")
            if ok:
                self.stats.note_processed(n)
                now_mono = time.monotonic()
                for hop, t_read in batch.e2e.items():
                    self.stats.observe_e2e(hop, now_mono - t_read)
                if self._health is not None:
                    self._health.ok()
            else:
                # lines lost to a failed drain are an incident like a shed
                # burst (debounced; outside every scheduler lock)
                flightrec.notify("drain-error", f"{n} lines counted as failed")
            t_drain_ms = (time.perf_counter() - t0) * 1e3
            batch.root_span.note("ok", ok)
            trace.end(batch.root_span)
            if batch.kind != "cmd":
                stage_ms = {"encode": batch.t_encode_ms, "device": batch.t_device_ms,
                            "drain": t_drain_ms}
                self._sizer.observe(n, stage_ms)
                self.stats.observe_stages(stage_ms)
            if self.on_results is not None and batch.kind != "cmd":
                try:
                    self.on_results(batch.lines, results)
                except Exception:  # noqa: BLE001 — an observer must not stall the drain
                    log.exception("pipeline on_results callback failed")
            self._ring.release()
            with self._cond:
                self._inflight -= 1
                self._last_activity = time.monotonic()
                self._cond.notify_all()
            if batch.drained is not None:
                batch.drained.set()

    # ---- idle probe ----

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_seconds):
            try:
                matcher = self._matcher_getter()
            except Exception:  # noqa: BLE001 — the encode stage reports it as failed health
                log.exception("pipeline probe: no matcher")
                continue
            probe = getattr(matcher, "probe", None)
            with self._cond:
                idle = (
                    probe is not None
                    and not self._buf
                    and self._inflight == 0
                    and time.monotonic() - self._last_activity >= self.probe_seconds
                )
                if idle:
                    self._probing = True
            if not idle:
                continue
            try:
                _bind(matcher)
                try:
                    probe_ok = bool(probe())
                except Exception:  # noqa: BLE001 — a probe bug must not kill the timer; counted
                    log.exception("pipeline device probe raised")
                    probe_ok = False
            finally:
                with self._cond:
                    self._probing = False
                    self._cond.notify_all()
            self.stats.note_probe(probe_ok)
            if self._health is not None:
                if probe_ok:
                    self._health.ok()
                else:
                    self._health.degraded("device probe failed")

    # ---- observability ----

    def snapshot(self) -> dict:
        """The 29 s line's keys (`obs/metrics.py`): resets the interval
        maxima, so it is for the line's single periodic consumer only."""
        out = self.stats.snapshot()
        out.update(self._sizer.snapshot())
        return self._live_gauges(out)

    def prom_snapshot(self) -> dict:
        """The non-destructive view for /metrics: totals, EWMAs and live
        gauges; never steals the line's interval maxima."""
        out = self.stats.peek()
        out.update(self._sizer.snapshot())
        return self._live_gauges(out)

    def _live_gauges(self, out: dict) -> dict:
        with self._cond:
            out["PipelineBufferedLines"] = len(self._buf)
            out["PipelineInflightBatches"] = self._inflight
        out["PipelineRingSize"] = self.ring_size
        out["EncodeWorkers"] = self.encode_workers
        return out
