"""Fused matcher + device windows, one device program per chunk (port of
the single-kernel mode of `banjax_tpu/matcher/fused_windows.py`).

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

The JAX package's two-program mode (a stateless match program, then a
window program dispatched after a host decision) is not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import List, Optional

import numpy as np
import torch

from banjax_tpu_torch.matcher.kernels import fused_match_window as fmw
from banjax_tpu_torch.matcher.prefilter import FusedPrefilter
from banjax_tpu_torch.matcher.windows import DeviceWindows, WindowEvent


@dataclasses.dataclass
class _Pend:
    """One chunk in flight: submitted -> resolved -> done, or
    submitted -> overflow -> (caller fallback) -> done."""

    seq: int
    buf: torch.Tensor          # host copy of the chunk's buffer (in flight)
    copied: Optional[torch.cuda.Event]  # set when the copy is complete
    bits_dev: torch.Tensor     # [Bp, n_rules] uint8 on the device
    slots: np.ndarray          # caller-order, pins held
    B: int
    Bp: int
    K: int
    P: int
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
                 active_table: torch.Tensor, n_rules: int, traffic_sketch=None,
                 clock=None):
        self.pf = prefilter
        self._traffic_sketch = traffic_sketch
        # the owner's StageClock: the sketch fold counts as "sketch"
        self._clock = clock or (lambda name: contextlib.nullcontext())
        self.windows = windows
        self.active_table = active_table
        self.n_rules = n_rules
        self.device = prefilter.device
        self._progs = {}
        self._chain_ok: Optional[torch.Tensor] = None
        self.sk_chunks = 0       # chunks committed by the fused program
        self.sk_fallbacks = 0    # chunks routed to the classic fallback
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

    def submit(self, cls_ids: np.ndarray, lens: np.ndarray, slots: np.ndarray,
               ts_s: np.ndarray, ts_ns: np.ndarray, host_idx: np.ndarray,
               live: Optional[np.ndarray] = None) -> _Pend:
        """Run one chunk's program (slot pins pass to the pipeline, and are
        released here if submit fails), then fold the chunk into the
        traffic sketch. `live` (bool [B], default all-true) masks rows out
        of the commit."""
        try:
            p = self._submit(cls_ids, lens, slots, ts_s, ts_ns, host_idx, live)
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

    def _submit(self, cls_ids, lens, slots, ts_s, ts_ns, host_idx, live) -> _Pend:
        cls_ids = np.asarray(cls_ids, dtype=np.int32)
        lens = np.asarray(lens, dtype=np.int32)
        B = cls_ids.shape[0]
        combined, Bp, L_p = self.pf._assemble(cls_ids, lens)
        fn, K, P = self._single_prog(Bp)
        dev = self.device

        def pad(a, dtype):
            out = np.zeros(Bp, dtype=dtype)
            out[:B] = np.asarray(a, dtype=dtype)
            return torch.from_numpy(out).to(dev)

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
        copied = None
        if buf.is_cuda:
            host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
            buf = host
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
        """Settle a chunk whose results will never be collected (the commit
        already happened at submit): release its pins and turns once."""
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

    def resolve(self, p: _Pend) -> None:
        """Pull the chunk's buffer and read its flags. A gated chunk raises
        PipelineOverflow; its resolve turn is held until fallback_done."""
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
                self.sk_fallbacks += 1
                raise PipelineOverflow(candidate_overflow=int(p.flags[1]) > p.K)
            p.host_buf = buf
            p.events_off = off
            p.state = "resolved"
            self.sk_chunks += 1
        except PipelineOverflow:
            raise
        except Exception:
            p.state = "failed"
            self._release_chunk_pins(p)
            self._free_turn(p, "_resolve_seq")
            self._free_turn(p, "_collect_seq")
            raise
        self._free_turn(p, "_resolve_seq")

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
            buf, off, me = p.host_buf, p.events_off, wnd.max_events
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
