"""Kernel B (the window recurrence) and the single-program chunk commit.

`window_scan` replaces the Pallas TPU kernel `banjax_tpu/matcher/kernels/
fused_match_window.py` `_scan_kernel` (via `_scan_call` / `window_scan`):
the fixed-window recurrence `windows._window_step` of the JAX package
over the key-sorted events of one apply. The CUDA source is
`banjax_tpu_torch/csrc/window_scan.cu`; its note says what bounds it (the
latency of the longest carry segment) and how the design stages a tile
of events in shared memory, partitions the non-pad events to the front,
walks the segments in parallel from shared memory and hands the open
segment's carry from tile to tile. The wrapper launches the kernel and
nothing else: the flags go in as the bytes of torch.bool and `exceeded`
comes back as a torch.bool. The single-program commit, program B of the
two-program commit and the classic `DeviceWindows.apply_bitmap` run it.

`window_scan_plain` is its plain PyTorch version, with the same
structure: the pad events never change the carry, so the non-pad events
are walked segment by segment (all segments in lockstep, one step per
event of the longest), then every pad event takes the carry of the last
non-pad event before it.

`build_single_program` is the port of the one device program per chunk:
two-stage match, dense caller-order bitmap, live mask, the overflow/chain
gate and the gated window commit, returning one compact buffer whose
decode gives the JAX program's flags, pairs, always-rule bits and events.
`match_head` is the stateless part it shares with the two-program mode's
program A (`matcher/fused_windows.py`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from banjax_tpu_torch.device import packbits_rows
from banjax_tpu_torch.matcher import windows as W
from banjax_tpu_torch.matcher.kernels._build import CudaLibrary, I, P, raw_stream

KERNEL = CudaLibrary(
    "window_scan", "window_scan.cu", {"window_scan_launch": [P] * 16 + [I, I, P]},
)
_FLAGS = (0, 4, 10)  # b, gv and pad: torch.bool for the kernel

_NS_PER_S = 1_000_000_000

ScanIn = Tuple[torch.Tensor, ...]   # 11 x [E]: b, gh, gs, gn, gv, ts, tn, lim, ivs, ivn, pad
ScanOut = Tuple[torch.Tensor, ...]  # hits, start_s, start_ns, match_type (int32), exceeded (bool)


def _step(b, gh, gs, gn, gv, ts, tn, lim, ivs, ivn, pad, ch, cs, cn):
    """One event of the recurrence, vectorized over independent events
    (int32 wrapping arithmetic, as the JAX step)."""
    h0 = torch.where(b, gh, ch)
    s0 = torch.where(b, gs, cs)
    n0 = torch.where(b, gn, cn)
    have = torch.where(b, gv, True)
    ds = ts - s0
    dns = tn - n0
    borrow = (dns < 0).to(torch.int32)
    ds = ds - borrow
    dns = dns + borrow * _NS_PER_S
    outside = have & ((ds > ivs) | ((ds == ivs) & (dns > ivn)))
    restart = ~have | outside
    h1 = torch.where(restart, 1, h0 + 1).to(torch.int32)
    s1 = torch.where(restart, ts, s0)
    n1 = torch.where(restart, tn, n0)
    exceeded = h1 > lim
    h2 = torch.where(exceeded, 0, h1).to(torch.int32)
    mtype = torch.where(~have, 0, torch.where(outside, 1, 2)).to(torch.int32)
    h2 = torch.where(pad, ch, h2)
    s1 = torch.where(pad, cs, s1)
    n1 = torch.where(pad, cn, n1)
    return h2, s1, n1, mtype, exceeded


def _as_inputs(xs: ScanIn) -> ScanIn:
    b, gh, gs, gn, gv, ts, tn, lim, ivs, ivn, pad = xs
    i32 = [x.to(torch.int32) for x in (gh, gs, gn, ts, tn, lim, ivs, ivn)]
    gh, gs, gn, ts, tn, lim, ivs, ivn = i32
    return (b != 0, gh, gs, gn, gv != 0, ts, tn, lim, ivs, ivn, pad != 0)


def window_scan_plain(xs: ScanIn) -> ScanOut:
    """The plain PyTorch version of kernel B (any device)."""
    b, gh, gs, gn, gv, ts, tn, lim, ivs, ivn, pad = _as_inputs(xs)
    E = b.shape[0]
    dev = b.device
    h_out = torch.zeros(E, dtype=torch.int32, device=dev)
    s_out = torch.zeros_like(h_out)
    n_out = torch.zeros_like(h_out)
    mt_out = torch.zeros_like(h_out)
    ex_out = torch.zeros(E, dtype=torch.bool, device=dev)
    np_idx = torch.nonzero(~pad).reshape(-1)
    n_np = np_idx.numel()
    if n_np:
        start = b[np_idx].clone()
        start[0] = True
        seg_start = torch.nonzero(start).reshape(-1)
        seg_end = torch.cat([seg_start[1:], seg_start.new_full((1,), n_np)])
        seg_len = seg_end - seg_start
        ch, cs, cn = (
            torch.zeros(seg_start.numel(), dtype=torch.int32, device=dev)
            for _ in range(3)
        )
        for j in range(int(seg_len.max())):
            act = seg_len > j
            k = np_idx[seg_start[act] + j]
            h, s, n, mt, ex = _step(
                b[k], gh[k], gs[k], gn[k], gv[k], ts[k], tn[k], lim[k],
                ivs[k], ivn[k], pad[k], ch[act], cs[act], cn[act],
            )
            h_out[k], s_out[k], n_out[k], mt_out[k], ex_out[k] = h, s, n, mt, ex
            ch[act], cs[act], cn[act] = h, s, n
    kp = torch.nonzero(pad).reshape(-1)
    if kp.numel():
        rank = torch.cumsum((~pad).to(torch.int64), 0)  # non-pads up to k
        j = rank[kp] - 1
        has = j >= 0
        kj = np_idx[j.clamp(min=0)] if n_np else torch.zeros_like(kp)
        ch = torch.where(has, h_out[kj], 0).to(torch.int32)
        cs = torch.where(has, s_out[kj], 0).to(torch.int32)
        cn = torch.where(has, n_out[kj], 0).to(torch.int32)
        h, s, n, mt, ex = _step(
            b[kp], gh[kp], gs[kp], gn[kp], gv[kp], ts[kp], tn[kp], lim[kp],
            ivs[kp], ivn[kp], pad[kp], ch, cs, cn,
        )
        h_out[kp], s_out[kp], n_out[kp], mt_out[kp], ex_out[kp] = h, s, n, mt, ex
    return h_out, s_out, n_out, mt_out, ex_out


def window_scan(xs: ScanIn) -> ScanOut:
    """The recurrence over one key-sorted event list: kernel B for CUDA
    tensors (flags bool, the rest int32, all contiguous [E]), the plain
    version for CPU tensors."""
    dev = xs[0].device
    if dev.type == "cpu":
        return window_scan_plain(xs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    E = int(xs[0].shape[0])
    if len(xs) != 11:
        raise ValueError("window_scan takes 11 [E] tensors")
    for i, x in enumerate(xs):
        if x.shape != (E,) or x.device != dev or not x.is_contiguous():
            raise ValueError("window_scan takes 11 contiguous [E] tensors on one device")
        want = torch.bool if i in _FLAGS else torch.int32
        if x.dtype != want:
            raise TypeError(f"window_scan input {i} is {x.dtype}, not {want}")
    out = torch.empty((4, E), dtype=torch.int32, device=dev)
    ex = torch.empty(E, dtype=torch.bool, device=dev)
    if E:
        o = out.data_ptr()
        KERNEL.count_launch()
        KERNEL.call(
            "window_scan_launch", *[t.data_ptr() for t in xs],
            o, o + 4 * E, o + 8 * E, o + 12 * E, ex.data_ptr(), E, dev.index, raw_stream(dev),
        )
    h, s, n, mt = out.unbind(0)
    return h, s, n, mt, ex


def selftest_stimulus(E: int = 64, seed: int = 7):
    """`scan_selftest`'s stimulus of the JAX package (numpy arrays):
    random boundary/valid bits, restarts, exceeds and a pad tail."""
    rng = np.random.default_rng(seed)
    pad = np.zeros(E, dtype=bool)
    pad[-max(1, E // 8):] = True
    return (
        rng.integers(0, 2, E).astype(bool),
        rng.integers(0, 6, E).astype(np.int32),
        rng.integers(0, 40, E).astype(np.int32),
        rng.integers(0, 1000, E).astype(np.int32),
        rng.integers(0, 2, E).astype(bool),
        rng.integers(0, 60, E).astype(np.int32),
        rng.integers(0, 1000, E).astype(np.int32),
        rng.integers(0, 4, E).astype(np.int32),
        rng.integers(1, 20, E).astype(np.int32),
        rng.integers(0, 1000, E).astype(np.int32),
        pad,
    )


def scan_selftest(device, E: int = 64) -> None:
    """Hold the active window_scan on `device` against the plain version
    on the CPU on the selftest stimulus; raises on any difference."""
    xs = [torch.from_numpy(x) for x in selftest_stimulus(E)]
    want = window_scan_plain(xs)
    got = window_scan([x.to(device) for x in xs])
    for name, w, g in zip(("hits", "start_s", "start_ns", "match_type", "exceeded"), want, got):
        if not torch.equal(w, g.cpu()):
            raise RuntimeError(f"window-scan selftest mismatch on {name!r}")


def match_head(pf, n_rules: int, Bp: int, *, f_idx, a_idx, aw, ae):
    """The stateless head that both chunk commits share: the two-stage
    match (kernel A for both stages), the sparse (row, rule) pairs and the
    dense caller-order bitmap with padding rows zeroed.

    Returns (fn, K, P) where fn(combined, n_real) -> (c, pairs, n_pairs,
    bits, ab): `c` the match core's outputs, `bits` the [Bp, n_rules]
    uint8 bitmap, `ab` the always-rule bits in caller order (None when
    the plan has none)."""
    _, K = pf.capacities(Bp)
    P = pf.pair_capacity(Bp, K)
    plan = pf.plan
    n_always = plan.n_always
    n_filt = plan.stage2.n_rules
    dev = pf.device

    def head(combined, n_real):
        c = pf.match_core(combined, K)
        pairs, n_pairs, m2 = pf.pairs_from_core(c, K, P)
        # dense caller-order bitmap; row Bp collects the empty slots
        filt = torch.zeros((Bp + 1, n_filt), dtype=torch.uint8, device=dev)
        filt[c["idx_caller_k"]] = m2
        bits = torch.zeros((Bp, n_rules), dtype=torch.uint8, device=dev)
        bits[:, f_idx] = filt[:Bp]
        ab = None
        if n_always:
            ab = c["ab_caller"] | aw[None, :]
            ab = ab | (ae[None, :] * (c["lens"] == 0).to(torch.uint8)[:, None])
            bits[:, a_idx] = ab
        # padding rows can carry bits (an always-match column is all
        # ones) and must not reach a window commit: their slot belongs to
        # a real IP
        real = (torch.arange(Bp, device=dev) < n_real).to(torch.uint8)
        return c, pairs, n_pairs, bits * real[:, None], ab

    return head, K, P


def head_parts(flags, pairs, ab):
    """flags[4 x i32] ‖ (row, rule) pairs [4P] ‖ always-rule bits
    [Bp * na8] (when the plan has any), as uint8 pieces."""
    parts = [flags.view(torch.uint8), pairs.view(torch.uint8)]
    if ab is not None:
        parts.append(packbits_rows(ab).reshape(-1))
    return parts


def event_parts(ev):
    """ev line/rule/hits/start_s/start_ns [5 x 4E] ‖ match_type/exceeded/
    seen_ip [3 x E], as uint8 pieces."""
    parts = [ev[key].to(torch.int32).view(torch.uint8)
             for key in ("line", "rule", "hits", "start_s", "start_ns")]
    parts += [ev[key].to(torch.uint8) for key in ("match_type", "exceeded", "seen_ip")]
    return parts


def build_single_program(pf, windows, active_table, n_rules: int, Bp: int, *,
                         f_idx, a_idx, aw, ae):
    """One chunk's device work: match + dense bitmap + live mask +
    overflow/chain gate + gated window commit + compact output.

    Returns (fn, K, P) where
      fn(state, chain_ok, combined, n_real, host_idx, slots, ts_s, ts_ns,
         live) -> (chain_ok_out, buf, bits_dev)
    mutates `state` in place (every write drops when the gate is shut) and
    `buf` is the one uint8 buffer to pull: `head_parts` then
    `event_parts`.
    """
    head, K, P = match_head(pf, n_rules, Bp, f_idx=f_idx, a_idx=a_idx, aw=aw, ae=ae)
    max_events = windows.max_events

    def single(state, chain_ok, combined, n_real, host_idx, slots, ts_s, ts_ns, live):
        c, pairs, n_pairs, bits, ab = head(combined, n_real)
        # the live mask drops stale/abandoned rows from the commit; the
        # returned dense bitmap stays unmasked for the classic fallback
        bits_live = bits * live[:, None]
        n_events = W._count_events(bits_live, active_table, host_idx).to(torch.int32)
        self_ok = (c["n_cand"] <= K) & (n_pairs <= P) & (n_events <= max_events)
        ok = self_ok & (chain_ok != 0)
        ev = W._apply_core(
            state, bits_live, active_table, host_idx, slots, ts_s, ts_ns,
            windows._limits, windows._iv_s, windows._iv_ns,
            n_rules=n_rules, max_events=max_events, gate=ok,
        )
        flags = torch.stack([ok.to(torch.int32), c["n_cand"], n_pairs, n_events])
        parts = head_parts(flags, pairs, ab) + event_parts(ev)
        return ok.to(torch.int32), torch.cat(parts), bits

    return single, K, P
