"""Fused matcher + device windows (port of `banjax_tpu/matcher/
fused_windows.py`): the chunk commit in one device program, or in two.

Single program (`single_kernel`, `pallas_single_kernel` auto or on):
submit() runs the whole chunk on the device — two-stage match, dense
caller-order bitmap, the overflow/chain gate and the window commit — and
starts the copy of its one compact buffer to the host; resolve() reads
the flags; collect() decodes the events and feeds the host shadow.

Ordering: the commit happens at submit, and submits are serialized, so
device apply order is log order. A chunk that overflows (candidates,
match pairs or window events beyond capacity) drops every state write;
so does every chunk submitted after it while it is outstanding (the
chain scalar: each commit gates on its predecessor's ok flag). Such
chunks resolve with PipelineOverflow and the caller replays them through
the classic fallback, in order, then calls fallback_done(). The chain
reseeds once no chunk is outstanding.

Each submitted chunk also folds its rows into the traffic sketch (the
count-min and HLL arrays on the card), keyed on the slots it already
uploads; an overflowed chunk's classic replay does not fold again, so a
line counts once.

Two programs (`pallas_single_kernel: off`):

  program A — the match, stateless (`_match_prog`): the two-stage match
    (kernel A for stage 1 and stage 2), the sparse pairs, the dense
    caller-order bitmap with padding rows zeroed, and every overflow flag
    — candidates, match pairs and window events, the last counted here,
    before any state is touched. submit() runs it and starts the one
    pinned, non-blocking copy of its buffer (flags ‖ pairs ‖ always-rule
    bits); the bitmap stays on the device. Any number of chunks may be
    submitted ahead.

  program B — the window commit (`_apply_prog`): the bits times the live
    mask through `windows._apply_core` (kernel B), then the event buffer.
    resolve(p, live) reads chunk p's flags and, when they are ok,
    dispatches B — in chunk order, so device apply order is log order.
    `live` (bool [B]) drops rows that aged past the staleness cutoff
    while the chunk waited in the pipeline. A chunk whose flags are not
    ok commits nothing: resolve raises PipelineOverflow, the caller
    replays every earlier chunk, then this one through the classic
    fallback, then calls fallback_done(). collect() pulls the events.

Order turns: submit() numbers the chunks; resolve() and collect() each
wait for their chunk's turn. A chunk that dies (abandon(), a failed
resolve or collect) marks its turns dead, and the counters step over
dead turns as they reach them (the dead-turn sweep), so that a lost
chunk never wedges the ones behind it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import List, Optional

import numpy as np
import torch

from banjax_tpu_torch.matcher import windows as W
from banjax_tpu_torch.matcher.kernels import fused_match_window as fmw
from banjax_tpu_torch.matcher.prefilter import FusedPrefilter
from banjax_tpu_torch.matcher.windows import DeviceWindows, WindowEvent


@dataclasses.dataclass
class _Pend:
    """One chunk in flight: submitted -> resolved -> done, or
    submitted -> overflow -> (caller fallback) -> done."""

    seq: int
    buf: torch.Tensor          # host copy of the chunk's (or A's) buffer
    copied: Optional[torch.cuda.Event]  # set when the copy is complete
    bits_dev: torch.Tensor     # [Bp, n_rules] uint8 on the device
    slots: np.ndarray          # caller-order, pins held
    B: int
    Bp: int
    K: int
    P: int
    # two programs: program B's inputs on the device (padded to Bp), its
    # event buffer's host copy and that copy's completion
    window_in: Optional[tuple] = None   # (slots, ts_s, ts_ns, host_idx)
    events_buf: Optional[torch.Tensor] = None
    events_copied: Optional[torch.cuda.Event] = None
    state: str = "submitted"
    flags: Optional[np.ndarray] = None
    host_buf: Optional[np.ndarray] = None
    events_off: int = 0
    matched_pairs: Optional[np.ndarray] = None
    always_bits: Optional[np.ndarray] = None
    pins_released: bool = False
    turns_freed: dict = dataclasses.field(
        default_factory=lambda: {"_resolve_seq": False, "_collect_seq": False}
    )


@dataclasses.dataclass
class FusedWindowsResult:
    events: List[WindowEvent]
    matched_pairs: Optional[np.ndarray]   # int32 caller_row * R8 + rule column
    always_bits: Optional[np.ndarray]     # [B, na8] packed always-rule bits


class PipelineOverflow(RuntimeError):
    """resolve() found a gated chunk: the caller finishes it through the
    classic fallback, then calls fallback_done."""

    def __init__(self, candidate_overflow: bool):
        super().__init__(
            "candidate capacity exceeded" if candidate_overflow
            else "match-pair/event capacity exceeded (or a gated predecessor)"
        )
        # True: stage 2 never saw the excess lines, so even the dense
        # bitmap is incomplete and must be recomputed single-stage
        self.candidate_overflow = candidate_overflow


class FusedWindowsPipeline:
    """Built by TorchMatcher when the fused prefilter and device windows
    are both active and every rule is device-decidable. Contract: submit
    in chunk order; resolve and collect in that same order."""

    def __init__(self, prefilter: FusedPrefilter, windows: DeviceWindows,
                 active_table: torch.Tensor, n_rules: int, single_kernel: bool = True,
                 traffic_sketch=None, clock=None):
        self.pf = prefilter
        self.single_kernel = bool(single_kernel)
        self._traffic_sketch = traffic_sketch
        # the owner's StageClock: the sketch fold counts as "sketch"
        self._clock = clock or (lambda name: contextlib.nullcontext())
        self.windows = windows
        self.active_table = active_table
        self.n_rules = n_rules
        self.device = prefilter.device
        self._progs = {}         # by Bp: the single program, or program A
        self._apply_progs = {}   # by Bp: program B
        self._chain_ok: Optional[torch.Tensor] = None
        self.fused_batches = 0   # chunks committed by either mode
        self.fallback_batches = 0  # chunks routed to the classic fallback
        self.sk_chunks = 0       # of those, the single program's
        self.sk_fallbacks = 0
        plan = prefilter.plan
        dev = self.device
        self._f_idx = torch.as_tensor(plan.f_idx, dtype=torch.int64).to(dev)
        self._a_idx = torch.as_tensor(plan.a_idx, dtype=torch.int64).to(dev)
        na = plan.n_always
        self._aw = torch.as_tensor(
            np.asarray(plan.stage1.always_match[:na], dtype=np.uint8)).to(dev)
        self._ae = torch.as_tensor(
            np.asarray(plan.stage1.empty_only[:na], dtype=np.uint8)).to(dev)
        self._cv = threading.Condition()
        self._next_seq = 0
        self._resolve_seq = 0
        self._collect_seq = 0
        self._dead = {"_resolve_seq": set(), "_collect_seq": set()}

    def _single_prog(self, Bp: int):
        hit = self._progs.get(Bp)
        if hit is None:
            hit = self._progs[Bp] = fmw.build_single_program(
                self.pf, self.windows, self.active_table, self.n_rules, Bp,
                f_idx=self._f_idx, a_idx=self._a_idx, aw=self._aw, ae=self._ae,
            )
        return hit

    def _match_prog(self, Bp: int):
        """Program A for chunks padded to Bp rows:
        fn(combined, n_real, host_idx) -> (buf, bits_dev), `buf` the
        `head_parts` of the flags [ok, n_cand, n_pairs, n_events], the
        pairs and the always-rule bits. The event count is of the
        unmasked bits (the live mask comes at resolve), as in JAX."""
        hit = self._progs.get(Bp)
        if hit is not None:
            return hit
        head, K, P = fmw.match_head(self.pf, self.n_rules, Bp, f_idx=self._f_idx,
                                    a_idx=self._a_idx, aw=self._aw, ae=self._ae)
        max_events = self.windows.max_events
        active_table = self.active_table

        def match(combined, n_real, host_idx):
            c, pairs, n_pairs, bits, ab = head(combined, n_real)
            n_events = W._count_events(bits, active_table, host_idx).to(torch.int32)
            ok = (c["n_cand"] <= K) & (n_pairs <= P) & (n_events <= max_events)
            flags = torch.stack([ok.to(torch.int32), c["n_cand"], n_pairs, n_events])
            return torch.cat(fmw.head_parts(flags, pairs, ab)), bits

        hit = self._progs[Bp] = (match, K, P)
        return hit

    def _apply_prog(self, Bp: int):
        """Program B for chunks padded to Bp rows: fn(state, bits, slots,
        ts_s, ts_ns, host_idx, live) commits the live rows' window events
        into `state` in place (kernel B) and returns the `event_parts`
        buffer."""
        hit = self._apply_progs.get(Bp)
        if hit is not None:
            return hit
        wnd = self.windows
        n_rules, max_events = self.n_rules, wnd.max_events
        active_table = self.active_table

        def apply(state, bits, slots, ts_s, ts_ns, host_idx, live):
            ev = W._apply_core(
                state, bits * live[:, None], active_table, host_idx, slots, ts_s, ts_ns,
                wnd._limits, wnd._iv_s, wnd._iv_ns, n_rules=n_rules, max_events=max_events,
            )
            return torch.cat(fmw.event_parts(ev))

        self._apply_progs[Bp] = apply
        return apply

    def submit(self, cls_ids: np.ndarray, lens: np.ndarray, slots: np.ndarray,
               ts_s: np.ndarray, ts_ns: np.ndarray, host_idx: np.ndarray,
               live: Optional[np.ndarray] = None) -> _Pend:
        """Run one chunk's program — the single program, or program A
        (slot pins pass to the pipeline, and are released here if submit
        fails) — then fold the chunk into the traffic sketch. `live` (bool
        [B], default all-true) masks rows out of the single program's
        commit; program A takes none (its commit's mask goes to
        resolve)."""
        if live is not None and not self.single_kernel:
            raise ValueError("program A takes no live mask: pass it to resolve")
        try:
            submit = self._submit if self.single_kernel else self._submit_match
            p = submit(cls_ids, lens, slots, ts_s, ts_ns, host_idx, live)
        except BaseException:
            self.windows.release_pins(slots)
            raise
        try:
            self._sketch_update(p)
        except BaseException:
            self.abandon(p)
            raise
        return p

    def _sketch_update(self, p: _Pend) -> None:
        if self._traffic_sketch is not None:
            with self._clock("sketch"):
                self._traffic_sketch.update(p.slots, p.B)

    def _pad(self, a, dtype, B: int, Bp: int) -> torch.Tensor:
        out = np.zeros(Bp, dtype=dtype)
        out[:B] = np.asarray(a, dtype=dtype)
        return torch.from_numpy(out).to(self.device)

    @staticmethod
    def _to_host(buf: torch.Tensor):
        """Start the one pinned, non-blocking copy of a device buffer:
        (host tensor, completion event), or (buf, None) on the CPU."""
        if not buf.is_cuda:
            return buf, None
        host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(buf, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        return host, copied

    def _submit_match(self, cls_ids, lens, slots, ts_s, ts_ns, host_idx, live) -> _Pend:
        """Program A for one chunk; nothing touches the window state."""
        cls_ids = np.asarray(cls_ids, dtype=np.int32)
        lens = np.asarray(lens, dtype=np.int32)
        B = cls_ids.shape[0]
        combined, Bp, _ = self.pf._assemble(cls_ids, lens)
        fn, K, P = self._match_prog(Bp)
        host_idx_p = self._pad(host_idx, np.int32, B, Bp)
        buf, bits_dev = fn(torch.from_numpy(combined).to(self.device), B, host_idx_p)
        buf, copied = self._to_host(buf)
        window_in = (self._pad(slots, np.int32, B, Bp), self._pad(ts_s, np.int32, B, Bp),
                     self._pad(ts_ns, np.int32, B, Bp), host_idx_p)
        with self._cv:
            seq = self._next_seq
            self._next_seq += 1
        return _Pend(seq=seq, buf=buf, copied=copied, bits_dev=bits_dev,
                     slots=np.asarray(slots), B=B, Bp=Bp, K=K, P=P, window_in=window_in)

    def _submit(self, cls_ids, lens, slots, ts_s, ts_ns, host_idx, live) -> _Pend:
        cls_ids = np.asarray(cls_ids, dtype=np.int32)
        lens = np.asarray(lens, dtype=np.int32)
        B = cls_ids.shape[0]
        combined, Bp, L_p = self.pf._assemble(cls_ids, lens)
        fn, K, P = self._single_prog(Bp)
        dev = self.device

        def pad(a, dtype):
            return self._pad(a, dtype, B, Bp)

        live_p = pad(np.ones(B, dtype=np.uint8) if live is None else live, np.uint8)
        wnd = self.windows
        with wnd._lock:
            with self._cv:
                seq = self._next_seq
                # quiescent reseed: every submitted chunk resolved means
                # every gated chunk's classic fallback has applied
                if seq == self._resolve_seq:
                    self._chain_ok = None
                self._next_seq += 1
                chain = self._chain_ok
            wnd._run_maintenance_locked()
            chain_out, buf, bits_dev = fn(
                wnd._state,
                chain if chain is not None else torch.ones((), dtype=torch.int32, device=dev),
                torch.from_numpy(combined).to(dev), B,
                pad(host_idx, np.int32), pad(slots, np.int32),
                pad(ts_s, np.int32), pad(ts_ns, np.int32), live_p,
            )
            with self._cv:
                self._chain_ok = chain_out
        buf, copied = self._to_host(buf)
        return _Pend(seq=seq, buf=buf, copied=copied, bits_dev=bits_dev,
                     slots=np.asarray(slots), B=B, Bp=Bp, K=K, P=P)

    # ---- order turns ----

    def _check_turn(self, p: _Pend, attr: str) -> None:
        with self._cv:
            while getattr(self, attr) != p.seq:
                self._cv.wait()

    def _free_turn(self, p: _Pend, attr: str) -> None:
        """Release one of p's order turns exactly once."""
        with self._cv:
            if p.turns_freed[attr]:
                return
            p.turns_freed[attr] = True
            cur = getattr(self, attr)
            if cur == p.seq:
                cur = p.seq + 1
            else:
                self._dead[attr].add(p.seq)
            dead = self._dead[attr]
            while cur in dead:
                dead.discard(cur)
                cur += 1
            setattr(self, attr, cur)
            self._cv.notify_all()

    def _release_chunk_pins(self, p: _Pend) -> None:
        if not p.pins_released:
            p.pins_released = True
            self.windows.release_pins(p.slots)

    def abandon(self, p: _Pend) -> None:
        """Settle a chunk whose results will never be collected: release
        its pins and turns once. A single-program chunk's commit already
        happened at submit; a program-A chunk leaves no trace."""
        if p.state in ("done", "failed", "resolved"):
            return
        p.state = "failed"
        self._release_chunk_pins(p)
        self._free_turn(p, "_resolve_seq")
        self._free_turn(p, "_collect_seq")

    def idle(self) -> bool:
        with self._cv:
            return self._next_seq == self._collect_seq

    # ---- resolve / collect ----

    def _decode_head(self, p: _Pend, buf: np.ndarray) -> int:
        """flags ‖ pairs ‖ always bits; returns the event-tail offset."""
        P = p.P
        R8 = self.pf._nf8 * 8
        p.flags = np.frombuffer(buf[:16].tobytes(), dtype="<i4")
        off = 16
        pairs = np.frombuffer(buf[off : off + 4 * P].tobytes(), dtype="<i4")
        off += 4 * P
        na8 = self.pf._na8
        if na8:
            p.always_bits = buf[off : off + p.Bp * na8].reshape(-1, na8)[: p.B]
            off += p.Bp * na8
        n_pairs = int(p.flags[2])
        if n_pairs <= P:
            live = pairs[:n_pairs]
            rows_idx = live // R8
            cols = live - rows_idx * R8
            keep = (
                (rows_idx >= 0) & (rows_idx < p.B)
                & (cols < self.pf.plan.stage2.n_rules)
            )
            p.matched_pairs = live[keep]
        return off

    def resolve(self, p: _Pend, live: Optional[np.ndarray] = None) -> None:
        """Pull the chunk's buffer and read its flags; in two-program mode
        then dispatch program B with the commit mask `live` (bool [B],
        default all-true; the single program took its mask at submit). A
        chunk whose flags are not ok raises PipelineOverflow; its resolve
        turn is held until fallback_done."""
        if live is not None and self.single_kernel:
            raise ValueError("the single program takes its live mask at submit")
        self._check_turn(p, "_resolve_seq")
        if p.state != "submitted":
            return
        try:
            if p.copied is not None:
                p.copied.synchronize()
            buf = p.buf.numpy()
            off = self._decode_head(p, buf)
            if not p.flags[0]:
                p.state = "overflow"
                self.fallback_batches += 1
                if self.single_kernel:
                    self.sk_fallbacks += 1
                raise PipelineOverflow(candidate_overflow=int(p.flags[1]) > p.K)
            if self.single_kernel:
                p.host_buf = buf
                p.events_off = off
                self.sk_chunks += 1
            else:
                self._dispatch_apply(p, live)
            p.state = "resolved"
            self.fused_batches += 1
        except PipelineOverflow:
            raise
        except Exception:
            p.state = "failed"
            self._release_chunk_pins(p)
            self._free_turn(p, "_resolve_seq")
            self._free_turn(p, "_collect_seq")
            raise
        self._free_turn(p, "_resolve_seq")

    def _dispatch_apply(self, p: _Pend, live: Optional[np.ndarray]) -> None:
        """Program B for a resolved chunk, after the queued maintenance
        (evictions and restores), under the windows lock; starts the copy
        of its event buffer."""
        live_p = np.ones(p.Bp, dtype=np.uint8)
        if live is not None:
            live_p[: p.B] = np.asarray(live, dtype=np.uint8)
        apply = self._apply_prog(p.Bp)
        wnd = self.windows
        with wnd._lock:
            wnd._run_maintenance_locked()
            ebuf = apply(wnd._state, p.bits_dev, *p.window_in,
                         torch.from_numpy(live_p).to(self.device))
        p.events_buf, p.events_copied = self._to_host(ebuf)

    def fallback_done(self, p: _Pend) -> None:
        """The caller's classic fallback for a gated chunk is applied (its
        apply_bitmap released the pins): release both turns."""
        p.state = "done"
        p.pins_released = True
        self._free_turn(p, "_resolve_seq")
        self._free_turn(p, "_collect_seq")
        with self._cv:
            if self._next_seq == self._resolve_seq:
                self._chain_ok = None

    def collect(self, p: _Pend) -> FusedWindowsResult:
        """Decode the chunk's window events, absorb the final counter
        states into the host shadow, release the pins."""
        if p.state == "submitted":
            self.resolve(p)  # may raise PipelineOverflow
        if p.state != "resolved":
            raise RuntimeError(f"collect of a chunk in state {p.state!r}")
        self._check_turn(p, "_collect_seq")
        wnd = self.windows
        try:
            if self.single_kernel:
                buf, off = p.host_buf, p.events_off
            else:
                if p.events_copied is not None:
                    p.events_copied.synchronize()
                buf, off = p.events_buf.numpy(), 0
            me = wnd.max_events
            ev = {}
            for key in ("line", "rule", "hits", "start_s", "start_ns"):
                ev[key] = np.frombuffer(buf[off : off + 4 * me].tobytes(), dtype="<i4")
                off += 4 * me
            for key in ("match_type", "exceeded", "seen_ip"):
                ev[key] = buf[off : off + me]
                off += me
            with wnd._lock:
                wnd.absorb_events_locked(ev, p.slots)
            p.state = "done"
            return FusedWindowsResult(
                events=DeviceWindows.window_events(ev),
                matched_pairs=p.matched_pairs, always_bits=p.always_bits,
            )
        finally:
            self._release_chunk_pins(p)
            self._free_turn(p, "_collect_seq")
