"""Pipeline tracing: a lock-cheap, ring-buffered span recorder (a copy of
`banjax_tpu/obs/trace.py`).

Every admission batch gets a trace id at the scheduler's take-time and
carries it through encode (per-shard child spans), submit (one
`program-ab-fused` span a chunk: the fused program that launches kernels
A and B), collect and drain (`effector-replay` a chunk), with breaker,
shed and device-failure events as instant annotations.

  * **Off = free.** `trace_enabled` defaults false; every record path
    starts with one attribute check and returns the shared no-op span.
  * **On = lock-cheap.** A completed span is one lock acquisition and a
    tuple store into a preallocated ring (`trace_ring_size` slots, oldest
    overwritten); export pays the formatting.
  * **Cross-thread spans are explicit.** A batch's root span begins on
    the encode thread and ends on the drain thread, so it rides the batch
    (`begin`/`end`); single-thread spans use the context-manager form,
    which keeps a thread-local ambient parent, so spans recorded inside
    the matcher parent without knowing the scheduler's ids.

Export: `export_chrome()` renders the ring as Chrome `trace_event` JSON
(`/debug/trace`; load it in Perfetto or chrome://tracing).

Profiler bridge: the config key keeps its JAX name,
`trace_jax_annotations`, and its role. With it on, every context-manager
span also enters `torch.profiler.record_function(name)` and pushes an
NVTX range of the same name (`torch.cuda.nvtx`), so host spans line up
with kernels A, B and C in a `torch.profiler` capture (the
`/debug/torch/trace` route) and in Nsight Systems; the submit stage's
step annotation (JAX's `StepTraceAnnotation`) becomes an NVTX range
`banjax-batch <trace id>`. Both are no-ops when no profiler listens.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Dict, List, Optional

DEFAULT_RING_SIZE = 4096

# the five pipeline stage span names the acceptance test asserts on
STAGES = ("admission", "encode", "encode-shard", "submit", "collect", "drain")


class _NoopSpan:
    """Shared do-nothing span: returned whenever recording is off (or the
    caller has no trace), so call sites never branch on enablement."""

    __slots__ = ()
    trace_id = 0
    span_id = 0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def note(self, key: str, value) -> None:
        return None


NOOP_SPAN = _NoopSpan()


class Span:
    """One live span.  Mutable while open; recorded into the ring on
    `end()`/`__exit__`.  `note()` attaches args visible in the export
    (breaker state, fallback reasons, row counts)."""

    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "t0", "args", "_thread_name", "_bridge")

    def __init__(self, tracer: "Tracer", name: str, trace_id: int,
                 parent_id: int, args: Optional[dict]):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = next(tracer._ids)
        self.parent_id = parent_id
        self.name = name
        self.args = dict(args) if args else None
        self.t0 = time.perf_counter()
        self._thread_name = threading.current_thread().name
        self._bridge = None

    def note(self, key: str, value) -> None:
        if self.args is None:
            self.args = {}
        self.args[key] = value

    # -- context-manager form (single-thread spans; keeps the ambient
    # parent stack and the optional profiler bridge) --

    def __enter__(self) -> "Span":
        stack = self.tracer._ambient.__dict__.setdefault("stack", [])
        stack.append(self)
        if self.tracer.jax_annotations:
            self._bridge = _enter_bridge(self.name)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._bridge is not None:
            _exit_bridge(self._bridge, exc_type, exc, tb)
            self._bridge = None
        stack = self.tracer._ambient.__dict__.get("stack")
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.note("error", repr(exc))
        self.tracer.end(self)


class Tracer:
    """Process-wide span recorder.  All public methods are safe to call
    from any thread; when `enabled` is False every one of them is a
    single attribute check."""

    def __init__(self, enabled: bool = False,
                 ring_size: int = DEFAULT_RING_SIZE,
                 jax_annotations: bool = False):
        self.enabled = bool(enabled)
        self.jax_annotations = bool(jax_annotations)
        self.ring_size = max(16, int(ring_size))
        self._lock = threading.Lock()
        self._ring: List[Optional[tuple]] = [None] * self.ring_size
        self._n = 0  # monotone record count; ring index = _n % ring_size
        self._dropped = 0
        self._ids = itertools.count(1)
        self._traces = itertools.count(1)
        self._ambient = threading.local()
        self._epoch = time.perf_counter()
        self._epoch_wall = time.time()

    # ---- recording ----

    def new_trace(self) -> int:
        """Allocate a trace id for one admission batch; 0 when disabled
        (0 propagates as 'don't record' through every span call)."""
        if not self.enabled:
            return 0
        return next(self._traces)

    def begin(self, name: str, trace_id: int, parent: int = 0,
              args: Optional[dict] = None):
        """Open a span explicitly (cross-thread form: `end()` may run on
        a different thread).  Does NOT touch the ambient stack."""
        if not self.enabled or not trace_id:
            return NOOP_SPAN
        return Span(self, name, trace_id, parent, args)

    def end(self, span) -> None:
        """Close a span opened with `begin()` (or via __exit__)."""
        if span is NOOP_SPAN or not isinstance(span, Span):
            return
        dur_us = (time.perf_counter() - span.t0) * 1e6
        t0_us = (span.t0 - self._epoch) * 1e6
        rec = (span.trace_id, span.span_id, span.parent_id, span.name,
               t0_us, dur_us, span._thread_name, span.args)
        with self._lock:
            self._ring[self._n % self.ring_size] = rec
            self._n += 1

    def span(self, name: str, trace_id: Optional[int] = None,
             parent: Optional[int] = None, args: Optional[dict] = None):
        """Context-manager span.  With no explicit ids it parents under
        the thread's current ambient span — and records nothing when
        there is none, so instrumented library code (matcher, mesh) is
        inert outside a traced pipeline batch."""
        if not self.enabled:
            return NOOP_SPAN
        if trace_id is None or parent is None:
            stack = self._ambient.__dict__.get("stack")
            top = stack[-1] if stack else None
            if trace_id is None:
                if top is None:
                    return NOOP_SPAN
                trace_id = top.trace_id
            if parent is None:
                parent = top.span_id if top is not None else 0
        if not trace_id:
            return NOOP_SPAN
        return Span(self, name, trace_id, parent, args)

    def instant(self, name: str, args: Optional[dict] = None,
                trace_id: int = 0) -> None:
        """Point event (shed, breaker trip, fallback): zero duration,
        recorded even without a trace id so stream-level events (an
        admission-buffer shed belongs to no single batch) still land in
        the ring."""
        if not self.enabled:
            return
        t0_us = (time.perf_counter() - self._epoch) * 1e6
        rec = (trace_id, next(self._ids), 0, name, t0_us, None,
               threading.current_thread().name, dict(args) if args else None)
        with self._lock:
            self._ring[self._n % self.ring_size] = rec
            self._n += 1

    def current_trace_id(self) -> int:
        """Trace id of the thread's ambient span (0 when none / off) —
        lets passive observers (the provenance ledger) attribute an
        effect to the admitting batch without any id plumbing."""
        if not self.enabled:
            return 0
        stack = self._ambient.__dict__.get("stack")
        return stack[-1].trace_id if stack else 0

    # ---- export ----

    def snapshot(self, clear: bool = False) -> List[dict]:
        """Ring contents oldest-first as plain dicts (tests, debugging).

        ``clear=True`` snapshots AND empties the ring in one lock
        section: a span recorded between a separate dump and clear would
        be silently dropped, and two concurrent clearing dumps could
        each report the same span — /debug/trace?clear=1 uses this
        atomic form (tests/unit/test_trace.py hammers it)."""
        with self._lock:
            n = self._n
            if n <= self.ring_size:
                recs = [r for r in self._ring[:n]]
            else:
                cut = n % self.ring_size
                recs = self._ring[cut:] + self._ring[:cut]
            if clear:
                self._ring = [None] * self.ring_size
                self._n = 0
        out = []
        for r in recs:
            if r is None:
                continue
            tid, sid, pid, name, t0_us, dur_us, thread, args = r
            out.append({
                "trace_id": tid, "span_id": sid, "parent_id": pid,
                "name": name, "t0_us": t0_us, "dur_us": dur_us,
                "thread": thread, "args": args or {},
            })
        return out

    def export_chrome(self, clear: bool = False) -> dict:
        """Chrome trace_event JSON (Perfetto / chrome://tracing).

        Complete ('X') events for spans, instant ('i') events for
        annotations; one virtual pid, one tid per recorded thread name
        with 'M' metadata naming the track.  Span/trace ids ride in
        args so Perfetto's query surface can join parent/child.
        ``clear=True`` drains the ring atomically with the read (the
        /debug/trace?clear=1 contract — no span dropped or duplicated
        against a concurrent scrape)."""
        spans = self.snapshot(clear=clear)
        tids: Dict[str, int] = {}
        events = []
        pid = os.getpid()
        for s in spans:
            tid = tids.setdefault(s["thread"], len(tids) + 1)
            args = dict(s["args"])
            args["trace_id"] = s["trace_id"]
            args["span_id"] = s["span_id"]
            if s["parent_id"]:
                args["parent_span_id"] = s["parent_id"]
            ev = {
                "name": s["name"],
                "cat": "banjax",
                "ph": "X" if s["dur_us"] is not None else "i",
                "ts": round(s["t0_us"], 3),
                "pid": pid,
                "tid": tid,
                "args": args,
            }
            if s["dur_us"] is not None:
                ev["dur"] = round(s["dur_us"], 3)
            else:
                ev["s"] = "g"  # global-scope instant
            events.append(ev)
        meta = [
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": thread}}
            for thread, tid in tids.items()
        ]
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "tool": "banjax-tpu-torch trace ring",
                "ring_size": self.ring_size,
                "recorded": self._n,
                "epoch_unix": self._epoch_wall,
            },
        }

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.ring_size
            self._n = 0

    # ---- the torch profiler / NVTX bridge ----

    def step_annotation(self, trace_id: int):
        """An NVTX range `banjax-batch <trace id>` around one batch's
        device submit (the JAX tracer's StepTraceAnnotation); a no-op when
        the bridge is off."""
        if not (self.enabled and self.jax_annotations and trace_id):
            return NOOP_SPAN
        return _StepRange(trace_id)


class _StepRange:
    __slots__ = ("_bridge", "_name")

    def __init__(self, trace_id: int):
        self._name = f"banjax-batch {trace_id}"
        self._bridge = None

    def __enter__(self):
        self._bridge = _enter_bridge(self._name, record=False)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._bridge is not None:
            _exit_bridge(self._bridge, exc_type, exc, tb)
            self._bridge = None


def _enter_bridge(name: str, record: bool = True):
    """Enter torch.profiler.record_function(name) (when `record`) and push
    an NVTX range; returns what `_exit_bridge` undoes, or None. Best
    effort: tracing never raises."""
    ctx = None
    pushed = False
    try:
        import torch

        if record:
            ctx = torch.profiler.record_function(name)
            ctx.__enter__()
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
            pushed = True
    except Exception:  # noqa: BLE001 — the bridge is best-effort
        pass
    return (ctx, pushed)


def _exit_bridge(bridge, exc_type, exc, tb) -> None:
    ctx, pushed = bridge
    try:
        if pushed:
            import torch

            torch.cuda.nvtx.range_pop()
        if ctx is not None:
            ctx.__exit__(exc_type, exc, tb)
    except Exception:  # noqa: BLE001 — tracing must never raise
        pass


# ---- process-wide tracer -------------------------------------------------

_tracer = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _tracer


def configure(enabled: bool, ring_size: int = DEFAULT_RING_SIZE,
              jax_annotations: bool = False) -> Tracer:
    """(Re)configure the process tracer: called by cli.BanjaxApp from the
    config (`trace_enabled`, `trace_ring_size`, `trace_jax_annotations`)
    and by tests. Swaps the module singleton, so a disabled tracer keeps
    its one-check fast path."""
    global _tracer
    _tracer = Tracer(enabled=enabled, ring_size=ring_size,
                     jax_annotations=jax_annotations)
    return _tracer


# module-level delegates: call sites read the CURRENT singleton each time
# so a configure() mid-run (tests, SIGHUP) takes effect everywhere

def enabled() -> bool:
    return _tracer.enabled


def new_trace() -> int:
    return _tracer.new_trace()


def begin(name: str, trace_id: int, parent: int = 0,
          args: Optional[dict] = None):
    return _tracer.begin(name, trace_id, parent, args)


def end(span) -> None:
    _tracer.end(span)


def span(name: str, trace_id: Optional[int] = None,
         parent: Optional[int] = None, args: Optional[dict] = None):
    return _tracer.span(name, trace_id, parent, args)


def instant(name: str, args: Optional[dict] = None, trace_id: int = 0) -> None:
    _tracer.instant(name, args, trace_id)


def current_trace_id() -> int:
    return _tracer.current_trace_id()


def step_annotation(trace_id: int):
    return _tracer.step_annotation(trace_id)
