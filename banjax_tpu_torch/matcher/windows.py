"""Device-resident fixed-window rate-limit counters (port of `banjax_tpu/
matcher/windows.py`).

The per-(IP slot, rule) counters live on the device as flat arrays
(key = slot * n_rules + rule). One batch of match bits folds into them
per call:

  match bits [B, R] -> mask by per-host rule applicability
    -> fixed-capacity compaction to (line, rule) events in row-major
       (= reference processing) order
    -> stable sort by key -> the fixed-window recurrence over the sorted
       events (kernel B, `kernels/fused_match_window.window_scan`)
    -> write each key's final state back.

Exactness: timestamps ride as (seconds, nanoseconds) int32 pairs with
borrow arithmetic, bit-identical to int64 nanoseconds: restart strictly
greater than the interval, hits reset to 0 on exceed, FirstTime /
OutsideInterval / InsideInterval, seen_ip = "the IP had state before this
event".

In-place state: where the JAX package donates and rebuilds its arrays,
the port updates them in place. Every state array carries one extra
element at its end, a drop slot: a write that the JAX code drops
(`mode="drop"` on an out-of-range index, or every write when `gate` is
False) lands there instead, so no write needs a dynamically shaped index
and the state outside the drop slot passes through bit-identical.

IP slots are assigned on the host (batch-granular LRU, pins for in-flight
batches), by the native slot manager (`native/slotmgr.c`, one C call a
batch) or by the dict path, which stays as its differential oracle: both
pick the same victims in the same order. Eviction is lossless: a host
shadow updated from each batch's event-final states holds every counter,
and a re-admitted IP's counters are restored on the device before its
next events.

State tiering (the deploy configuration): with the warm tier on, an
evicted IP's shadow entry spills into the bounded native warm table
(`native/shm.py`) and refills on its next slot claim; `admission_mask`
is the slot-admission gate, and `apply_host_events` steps the windows of
the rows it refused on the host, homing their state in the warm tier.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from banjax_tpu_torch.config import RegexWithRate
from banjax_tpu_torch.decisions.rate_limit import (
    NumHitsAndIntervalStart,
    RateLimitMatchType,
)
from banjax_tpu_torch.device import fixed_nonzero

log = logging.getLogger(__name__)

_NS_PER_S = 1_000_000_000


def split_ns(ts_ns) -> Tuple[np.ndarray, np.ndarray]:
    """int64 ns -> (seconds, subsecond ns) int32 pair; exact for epoch times."""
    ts_ns = np.asarray(ts_ns, dtype=np.int64)
    s, ns = np.divmod(ts_ns, _NS_PER_S)
    return s.astype(np.int32), ns.astype(np.int32)


@dataclasses.dataclass
class DeviceWindowState:
    """Flat key = slot * n_rules + rule; each array ends in a drop slot."""

    hits: torch.Tensor      # [cap * R + 1] int32
    start_s: torch.Tensor   # [cap * R + 1] int32
    start_ns: torch.Tensor  # [cap * R + 1] int32
    valid: torch.Tensor     # [cap * R + 1] bool — state exists for this key
    ip_seen: torch.Tensor   # [cap + 1] bool — slot has any state

    @property
    def cap_r(self) -> int:
        return self.hits.shape[0] - 1

    @property
    def capacity(self) -> int:
        return self.ip_seen.shape[0] - 1

    @classmethod
    def zeros(cls, capacity: int, n_rules: int, device) -> "DeviceWindowState":
        n = capacity * n_rules + 1
        return cls(
            hits=torch.zeros(n, dtype=torch.int32, device=device),
            start_s=torch.zeros(n, dtype=torch.int32, device=device),
            start_ns=torch.zeros(n, dtype=torch.int32, device=device),
            valid=torch.zeros(n, dtype=torch.bool, device=device),
            ip_seen=torch.zeros(capacity + 1, dtype=torch.bool, device=device),
        )

    def arrays(self) -> Dict[str, np.ndarray]:
        """The five arrays without their drop slots, as numpy (the JAX
        DeviceWindowState's shapes)."""
        return {
            "hits": self.hits[:-1].cpu().numpy(),
            "start_s": self.start_s[:-1].cpu().numpy(),
            "start_ns": self.start_ns[:-1].cpu().numpy(),
            "valid": self.valid[:-1].cpu().numpy(),
            "ip_seen": self.ip_seen[:-1].cpu().numpy(),
        }


def _fire(bits, active_table, host_idx) -> torch.Tensor:
    return (bits != 0) & active_table[host_idx.long()]


def _count_events(bits, active_table, host_idx) -> torch.Tensor:
    """Event count: the overflow check before any state mutation."""
    return _fire(bits, active_table, host_idx).sum(dtype=torch.int64)


def _apply_core(
    state: DeviceWindowState,
    bits: torch.Tensor,          # [B, R] uint8/bool match bits
    active_table: torch.Tensor,  # [H, R] bool
    host_idx: torch.Tensor,      # [B] row of active_table per line
    slot_ids: torch.Tensor,      # [B] slot per line
    ts_s: torch.Tensor,          # [B] int32
    ts_ns: torch.Tensor,         # [B] int32
    limits: torch.Tensor,        # [R] int32
    iv_s: torch.Tensor,          # [R] int32
    iv_ns: torch.Tensor,         # [R] int32
    *,
    n_rules: int,
    max_events: int,
    gate: Optional[torch.Tensor] = None,  # 0-d bool: False drops every write
) -> Dict[str, torch.Tensor]:
    """The window-apply body (mutates `state` in place; the caller has run
    the maintenance step). Returns the per-event records in sorted order:
    line, rule (-1 for pads), match_type, exceeded, seen_ip and the
    event-final hits/start_s/start_ns."""
    from banjax_tpu_torch.matcher.kernels.fused_match_window import window_scan

    dev = bits.device
    cap_r, cap = state.cap_r, state.capacity
    E = max_events
    slot_ids = slot_ids.long()
    fire = _fire(bits, active_table, host_idx)

    # 1. fixed-capacity compaction in row-major (= reference) order
    flat = fixed_nonzero(fire.reshape(-1), E, fill=-1)
    pad = flat < 0
    lines = torch.where(pad, -1, flat // n_rules)
    rules = torch.where(pad, -1, flat % n_rules)
    slot = torch.where(pad, 0, slot_ids[lines.clamp(min=0)])
    key = torch.where(pad, cap_r, slot * n_rules + rules)  # pads sort last
    seq = torch.arange(E, device=dev)

    # 2. stable sort by key (ties keep row-major order)
    key_s, order = torch.sort(key, stable=True)
    lines_s = lines[order]
    pad_s = key_s >= cap_r
    rules_s = torch.where(pad_s, 0, rules[order])
    e_ts_s = ts_s[lines_s.clamp(min=0)]
    e_ts_ns = ts_ns[lines_s.clamp(min=0)]

    # seen_ip: slot already seen on device, or an earlier event in this
    # batch touched the slot
    first_seq = torch.full((cap + 1,), E, dtype=torch.int64, device=dev)
    first_seq.scatter_reduce_(0, slot, torch.where(pad, E, seq), reduce="amin")
    seen_ip_s = (state.ip_seen[slot] | (seq > first_seq[slot]))[order]

    # 3. segment boundaries + persistent state gather per event
    prev_key = torch.cat([key_s.new_full((1,), -1), key_s[:-1]])
    boundary = key_s != prev_key
    gk = key_s.clamp(max=cap_r - 1)
    xs = (
        boundary, state.hits[gk], state.start_s[gk], state.start_ns[gk],
        state.valid[gk] & ~pad_s, e_ts_s, e_ts_ns,
        limits[rules_s], iv_s[rules_s], iv_ns[rules_s], pad_s,
    )
    f_hits, f_ss, f_sns, mtype, exceeded = window_scan(xs)

    # 4. write back each segment's final state (last event of each key)
    next_key = torch.cat([key_s[1:], key_s.new_full((1,), -2)])
    is_last = (key_s != next_key) & ~pad_s
    wb_key = torch.where(is_last, key_s, cap_r)
    seen_idx = torch.where(pad, cap, slot)
    if gate is not None:
        wb_key = torch.where(gate, wb_key, cap_r)
        seen_idx = torch.where(gate, seen_idx, cap)
    state.hits.scatter_(0, wb_key, f_hits)
    state.start_s.scatter_(0, wb_key, f_ss)
    state.start_ns.scatter_(0, wb_key, f_sns)
    state.valid.index_fill_(0, wb_key, True)
    state.ip_seen.index_fill_(0, seen_idx, True)
    return {
        "line": lines_s,
        "rule": torch.where(pad_s, -1, rules_s),
        "match_type": mtype,
        "exceeded": exceeded & ~pad_s,
        "seen_ip": seen_ip_s,
        "hits": f_hits,
        "start_s": f_ss,
        "start_ns": f_sns,
    }


def _maintenance_step(
    state: DeviceWindowState,
    ev_keys: torch.Tensor,   # keys to invalidate
    ev_slots: torch.Tensor,  # slots whose seen flag clears
    r_keys: torch.Tensor,    # keys to restore
    r_hits: torch.Tensor,
    r_ss: torch.Tensor,
    r_sns: torch.Tensor,
    r_slots: torch.Tensor,   # slots to mark seen
) -> None:
    """Evictions THEN restores, in place: a slot can be evicted and
    reassigned+restored between two apply steps, so this order keeps the
    restored state from being cleared."""
    ev_keys, ev_slots, r_keys, r_slots = (
        t.long() for t in (ev_keys, ev_slots, r_keys, r_slots)
    )
    state.valid.index_fill_(0, ev_keys, False)
    state.ip_seen.index_fill_(0, ev_slots, False)
    state.hits.scatter_(0, r_keys, r_hits)
    state.start_s.scatter_(0, r_keys, r_ss)
    state.start_ns.scatter_(0, r_keys, r_sns)
    state.valid.index_fill_(0, r_keys, True)
    state.ip_seen.index_fill_(0, r_slots, True)


@dataclasses.dataclass
class WindowEvent:
    """One applied (line, rule) window transition, in reference order."""

    line: int
    rule_id: int
    match_type: RateLimitMatchType
    exceeded: bool
    seen_ip: bool


def events_to_host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One device->host pull of an apply's event records."""
    keys = ("line", "rule", "match_type", "exceeded", "seen_ip", "hits",
            "start_s", "start_ns")
    stacked = torch.stack([out[k].to(torch.int64) for k in keys]).cpu().numpy()
    return dict(zip(keys, stacked))


class DeviceWindows:
    """Device-resident rate-limit states with host slot management; mirrors
    the host states' introspection (`get`, `format_states`, `__len__`)
    through the host shadow."""

    AUTO_START_CAPACITY = 16384
    AUTO_MEM_BUDGET_BYTES = 2 << 30

    def __init__(
        self,
        rules: Sequence[RegexWithRate],
        device,
        capacity: int = 16384,  # matcher_window_capacity; 0 = auto-size
        max_events: int = 4096,
        native_slotmgr: bool = False,
        warm_tier_enabled: bool = False,
        warm_tier_capacity: int = 1 << 20,
    ):
        self.device = torch.device(device)
        self.n_rules = max(1, len(rules))
        self.auto_grow = capacity <= 0
        if self.auto_grow:
            self.max_capacity = max(
                256, int(self.AUTO_MEM_BUDGET_BYTES // (13 * self.n_rules))
            )
            capacity = min(self.AUTO_START_CAPACITY, self.max_capacity)
        else:
            self.max_capacity = capacity
        self.grow_count = 0
        self.capacity = capacity
        # a single line can fire every rule; max_events >= n_rules makes
        # the overflow split terminate at B=1
        self.max_events = max(max_events, self.n_rules)
        self._lock = threading.Lock()

        limits = np.zeros(self.n_rules, dtype=np.int32)
        iv_s = np.zeros(self.n_rules, dtype=np.int32)
        iv_ns = np.zeros(self.n_rules, dtype=np.int32)
        iv_total = np.zeros(self.n_rules, dtype=np.int64)
        self._rule_names: List[str] = []
        for i, r in enumerate(rules):
            limits[i] = r.hits_per_interval
            iv_s[i], iv_ns[i] = divmod(int(r.interval_ns), _NS_PER_S)
            iv_total[i] = int(r.interval_ns)
            self._rule_names.append(r.rule)
        self._limits = torch.from_numpy(limits).to(self.device)
        self._iv_s = torch.from_numpy(iv_s).to(self.device)
        self._iv_ns = torch.from_numpy(iv_ns).to(self.device)
        # host copies for the refused-row apply (apply_host_events)
        self._limits_np = limits
        self._iv_total_np = iv_total

        # warm tier: evicted state spills here instead of staying in the
        # unbounded shadow. The steal horizon is twice the widest window:
        # a record whose every window has expired restarts as first-seen,
        # so stealing it loses nothing
        self._warm = None
        if warm_tier_enabled:
            from banjax_tpu_torch.native.shm import create_warm_tier

            self._warm = create_warm_tier(
                capacity=warm_tier_capacity, max_rules=self.n_rules,
                expiry_ns=max(60 * _NS_PER_S, 2 * int(iv_total.max() or 0)),
            )
        self.warm_spills = 0
        self.warm_refills = 0
        # slot admission: refused rows are counted (and host-applied by
        # the runner), never dropped. A slot claimed on a sketch estimate
        # is marked; a tenure that ends with no state was an overcount
        self.slot_refusals = 0
        self.sketch_admissions = 0
        self.sketch_fp_evaluated = 0
        self.sketch_fp_count = 0
        self._sketch_pending: set = set()
        self._sketch_slots: Dict[int, bool] = {}

        self._slots: Dict[str, int] = {}  # ip -> slot (dict path only)
        self._last_used = np.zeros(capacity, dtype=np.int64)
        self._batch_seq = 0
        # slot -> ip in both modes (shadow updates and restores need it)
        self._slot_ip: Dict[int, str] = {}
        self._free: List[int] = list(range(capacity - 1, -1, -1))  # dict path only
        self._sm = None
        if native_slotmgr:
            from banjax_tpu_torch.native import slotmgr

            self._sm = slotmgr.create(capacity)
        self.slotmgr_native = self._sm is not None
        self._pending_evict: List[int] = []
        self._pending_restore: List[Tuple[int, str]] = []
        # slots handed out by slots_for_ips stay pinned until the matching
        # apply consumes them
        self._pin_counts = np.zeros(capacity, dtype=np.int32)
        self.eviction_count = 0
        # ip -> OrderedDict(rule_id -> (hits, s, ns)), first-event order
        self._shadow: "Dict[str, OrderedDict]" = {}
        self._state = DeviceWindowState.zeros(capacity, self.n_rules, self.device)

    def close(self) -> None:
        """Release the native slot manager, the warm tier's mapping and the
        state on the device; the object is unusable afterwards."""
        with self._lock:
            if self._sm is not None:
                self._sm.close()
                self._sm = None
            if self._warm is not None:
                self._warm.close()
                self._warm = None
            self._state = None
            self._limits = self._iv_s = self._iv_ns = None

    # ---- slot management (host) ----

    def release_pins(self, slot_ids) -> None:
        """Release a batch's pins when apply_bitmap will NOT be called."""
        self._release_pins(slot_ids)

    def slots_for_unique_ips(self, ips: Sequence[str]) -> Optional[np.ndarray]:
        """A pinned slot per distinct IP for one batch, or None when an
        allocation would have to evict a pinned slot (the caller splits the
        batch). Recency is batch-granular; with every slot taken, auto-size
        doubles the table up to its memory ceiling, and past it the least
        recently used unpinned slot is evicted to the host shadow."""
        with self._lock:
            self._batch_seq += 1
            if self._sm is not None:
                return self._slots_unique_native_locked(ips)
            out = np.empty(len(ips), dtype=np.int32)
            misses: List[int] = []
            get = self._slots.get
            for i, ip in enumerate(ips):
                slot = get(ip)
                if slot is None:
                    misses.append(i)
                    out[i] = -1
                else:
                    out[i] = slot
            if len(misses) < len(ips):
                self._last_used[out[out >= 0]] = self._batch_seq
            for i in misses:
                ip = ips[i]
                if not self._free and self.auto_grow and self.capacity < self.max_capacity:
                    self._grow_locked(min(self.capacity * 2, self.max_capacity))
                if not self._free:
                    slot = self._evict_one_locked(out)
                    if slot is None:
                        return None  # every slot pinned
                else:
                    slot = self._free.pop()
                self._slots[ip] = slot
                self._slot_ip[slot] = ip
                self._last_used[slot] = self._batch_seq
                if self._sketch_pending and ip in self._sketch_pending:
                    self._sketch_pending.discard(ip)
                    self._sketch_slots[slot] = True
                if ip in self._shadow:
                    # a previously evicted IP returns: its counters re-enter
                    # the device before any of this batch's events apply
                    self._pending_restore.append((slot, ip))
                elif self._warm is not None and len(self._warm):
                    self._refill_from_warm_locked(slot, ip)
                out[i] = slot
            self._pin_counts[out] += 1
            return out

    def _slots_unique_native_locked(self, ips: Sequence[str]) -> Optional[np.ndarray]:
        """slots_for_unique_ips by the native manager: one C lookup pass
        (hits stamped), the growth chain between the passes, one C
        placement pass (free stack, then the exact-argmin eviction)."""
        sm = self._sm
        slots, miss_idx, ctx = sm.lookup_batch(ips, self._batch_seq, self._last_used)
        n_miss = len(miss_idx)
        if n_miss:
            # the dict path's per-miss doubling chain: grow while the free
            # pool cannot absorb the remaining misses and the ceiling allows
            new_cap = self.capacity
            free_cnt = new_cap - len(self._slot_ip)
            steps = 0
            while free_cnt < n_miss and self.auto_grow and new_cap < self.max_capacity:
                step = min(new_cap * 2, self.max_capacity)
                free_cnt += step - new_cap
                new_cap = step
                steps += 1
            if new_cap != self.capacity:
                self._grow_locked(new_cap)
                # one coalesced growth, counted as the dict path's doublings
                self.grow_count += steps - 1
        placed_idx, evicted, ok = sm.place_misses(
            ctx, slots, miss_idx, self._batch_seq, self._pin_counts, self._last_used,
        )
        if len(evicted):
            ev = [int(x) for x in evicted]
            for x in ev:
                self._note_eviction_locked(x, self._slot_ip.pop(x, None))
            self._pending_evict.extend(ev)
            if self.eviction_count == 0:
                self._warn_first_eviction()
            self.eviction_count += len(ev)
        if len(placed_idx):
            idx_l = placed_idx.tolist()
            slot_l = slots[placed_idx].tolist()
            ip_l = list(map(ips.__getitem__, idx_l))
            self._slot_ip.update(zip(slot_l, ip_l))
            pend_sketch = self._sketch_pending
            if pend_sketch:
                for slot, ip in zip(slot_l, ip_l):
                    if ip in pend_sketch:
                        pend_sketch.discard(ip)
                        self._sketch_slots[slot] = True
            # warm membership in one C probe over the placed ips
            warm = self._warm
            in_warm = warm.contains_batch(ip_l) if warm is not None and len(warm) else None
            if self._shadow or in_warm is not None:
                for k, (slot, ip) in enumerate(zip(slot_l, ip_l)):
                    if ip in self._shadow:
                        self._pending_restore.append((slot, ip))
                    elif in_warm is not None and in_warm[k]:
                        self._refill_from_warm_locked(slot, ip)
        if not ok:
            return None  # every eviction candidate pinned: the caller splits
        self._pin_counts[slots] += 1
        return slots

    def admission_mask(
        self,
        ips: Sequence[str],
        estimates: Optional[np.ndarray] = None,
        min_estimate: int = 1,
        counts: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """The slot-admission gate over a distinct ip list: bool [n], True
        = the IP may claim a hot-tier slot this batch. First hit wins:
        (1) already hot (membership only, no recency stamp); (2) known
        state in the shadow or the warm tier; (3) unseen, admitted iff
        estimates[i] >= min_estimate (count-min never under-counts, so an
        offender is delayed at most min_estimate lines, never missed).
        `estimates=None` admits every unseen IP; `counts` weights the
        refusal counter by rows."""
        n = len(ips)
        with self._lock:
            if n == 0:
                return np.zeros(0, dtype=bool)
            if self._sm is not None:
                admit = self._sm.contains_batch(ips)
            else:
                slots = self._slots
                admit = np.fromiter((ip in slots for ip in ips), dtype=bool, count=n)
            unknown = np.flatnonzero(~admit)
            if len(unknown) and self._shadow:
                shadow = self._shadow
                sh = np.fromiter((ips[int(i)] in shadow for i in unknown),
                                 dtype=bool, count=len(unknown))
                admit[unknown[sh]] = True
                unknown = unknown[~sh]
            if len(unknown) and self._warm is not None and len(self._warm):
                wm = self._warm.contains_batch([ips[int(i)] for i in unknown])
                admit[unknown[wm]] = True
                unknown = unknown[~wm]
            if len(unknown):
                if estimates is None:
                    admit[unknown] = True
                else:
                    est_ok = np.asarray(estimates)[unknown] >= min_estimate
                    admitted = unknown[est_ok]
                    admit[admitted] = True
                    for i in admitted:
                        self._sketch_pending.add(ips[int(i)])
                    self.sketch_admissions += int(est_ok.sum())
                    refused = unknown[~est_ok]
                    if counts is not None:
                        self.slot_refusals += int(np.asarray(counts)[refused].sum())
                    else:
                        self.slot_refusals += len(refused)
            return admit

    def _warn_first_eviction(self) -> None:
        log.warning(
            "device-windows capacity (%d slots) exceeded; evicting LRU IP "
            "state to the host shadow (restored on re-admission)", self.capacity,
        )

    def _note_eviction_locked(self, slot: int, ip: Optional[str]) -> None:
        """Tiering bookkeeping at a hot-tier eviction: the sketch-admission
        false-positive count, and the spill of the victim's shadow entry
        into the warm tier. When the put drops (probe window full of live
        records) the shadow keeps the entry."""
        if self._sketch_slots.pop(slot, False):
            self.sketch_fp_evaluated += 1
            if ip is None or ip not in self._shadow:
                self.sketch_fp_count += 1
        if self._warm is None or ip is None:
            return
        od = self._shadow.get(ip)
        if not od:
            return
        entries = [(rid, h, s, ns) for rid, (h, s, ns) in od.items()]
        if self._warm.put(ip, entries, time.time_ns()):
            del self._shadow[ip]
            self.warm_spills += 1

    def _refill_from_warm_locked(self, slot: int, ip: str) -> bool:
        """Move one IP's window vector warm -> shadow and queue its device
        restore (before any of this batch's events for the IP)."""
        ent = self._warm.take(ip)
        if ent is None:
            return False
        self._shadow[ip] = OrderedDict((rid, (h, s, ns)) for rid, h, s, ns in ent)
        self._pending_restore.append((slot, ip))
        self.warm_refills += 1
        return True

    def _evict_one_locked(self, batch_slots: np.ndarray) -> Optional[int]:
        """Evict the least recently used slot that is assigned, unpinned
        and not already handed to this batch."""
        never = np.iinfo(np.int64).max
        used = np.full(self.capacity, never, dtype=np.int64)
        assigned = list(self._slot_ip)
        used[assigned] = self._last_used[assigned]
        used[self._pin_counts > 0] = never
        mine = batch_slots[batch_slots >= 0]
        if mine.size:
            used[mine] = never
        victim = int(np.argmin(used))
        if used[victim] == never:
            return None
        victim_ip = self._slot_ip.pop(victim)
        self._slots.pop(victim_ip)
        self._note_eviction_locked(victim, victim_ip)
        self._pending_evict.append(victim)
        if self.eviction_count == 0:
            self._warn_first_eviction()
        self.eviction_count += 1
        return victim

    def _grow_locked(self, new_capacity: int) -> None:
        """Double the slot table (auto-size): copy the state into larger
        zeroed arrays and free-list the new high slots."""
        old_cap = self.capacity
        add = new_capacity - old_cap
        if add <= 0:
            return
        s = self._state
        grown = DeviceWindowState.zeros(new_capacity, self.n_rules, self.device)
        n_old = old_cap * self.n_rules
        grown.hits[:n_old] = s.hits[:n_old]
        grown.start_s[:n_old] = s.start_s[:n_old]
        grown.start_ns[:n_old] = s.start_ns[:n_old]
        grown.valid[:n_old] = s.valid[:n_old]
        grown.ip_seen[:old_cap] = s.ip_seen[:old_cap]
        self._state = grown
        # pop() takes from the end: keep existing (lower) slots there so
        # allocation order is unchanged (the native free stack does the same)
        if self._sm is not None:
            self._sm.grow(new_capacity)
        else:
            self._free = list(range(new_capacity - 1, old_cap - 1, -1)) + self._free
        self._last_used = np.concatenate([self._last_used, np.zeros(add, dtype=np.int64)])
        self._pin_counts = np.concatenate([self._pin_counts, np.zeros(add, dtype=np.int32)])
        self.capacity = new_capacity
        self.grow_count += 1

    def _release_pins(self, slot_ids) -> None:
        with self._lock:
            uniq = np.unique(np.asarray(slot_ids, dtype=np.int64))
            self._pin_counts[uniq] -= 1
            np.maximum(self._pin_counts, 0, out=self._pin_counts)

    @property
    def occupancy(self) -> int:
        with self._lock:
            return len(self._slot_ip)

    def __len__(self) -> int:
        # IPs with any state, evicted ones included (shadow and warm tier
        # are disjoint: a spill deletes the shadow entry)
        with self._lock:
            return len(self._shadow) + (len(self._warm) if self._warm is not None else 0)

    @property
    def warm_occupancy(self) -> int:
        return len(self._warm) if self._warm is not None else 0

    @property
    def warm_capacity(self) -> int:
        return int(self._warm.capacity) if self._warm is not None else 0

    @property
    def warm_dropped(self) -> int:
        return int(self._warm.dropped) if self._warm is not None else 0

    def tier_counters(self) -> Dict[str, int]:
        """The tiering counters, by name."""
        return {
            "slot_refusals": self.slot_refusals,
            "sketch_admissions": self.sketch_admissions,
            "sketch_fp_evaluated": self.sketch_fp_evaluated,
            "sketch_fp_count": self.sketch_fp_count,
            "warm_spills": self.warm_spills,
            "warm_refills": self.warm_refills,
            "eviction_count": self.eviction_count,
            "warm_occupancy": self.warm_occupancy,
            "warm_dropped": self.warm_dropped,
        }

    # ---- the batch step ----

    def apply_bitmap(
        self,
        bits,                   # [B, R] device tensor or host array
        slot_ids: np.ndarray,   # [B] int32
        ts_s: np.ndarray,
        ts_ns: np.ndarray,
        active_table: torch.Tensor,  # [H, R] bool on this device
        host_idx: np.ndarray,   # [B] int32
    ) -> List[WindowEvent]:
        """Apply one batch; returns its events in reference order. A batch
        with more events than max_events splits in half, each half applied
        in order. The batch's pins are released on every path."""
        try:
            return self._apply_bitmap_inner(
                torch.as_tensor(bits).to(self.device), slot_ids, ts_s, ts_ns,
                active_table, host_idx,
            )
        finally:
            self._release_pins(slot_ids)

    def _apply_bitmap_inner(
        self, bits, slot_ids, ts_s, ts_ns, active_table, host_idx
    ) -> List[WindowEvent]:
        B = bits.shape[0]
        host_idx_t = torch.as_tensor(np.asarray(host_idx, dtype=np.int32)).to(self.device)
        if int(_count_events(bits, active_table, host_idx_t)) > self.max_events:
            mid = B // 2
            ev1 = self._apply_bitmap_inner(
                bits[:mid], slot_ids[:mid], ts_s[:mid], ts_ns[:mid],
                active_table, host_idx[:mid],
            )
            ev2 = self._apply_bitmap_inner(
                bits[mid:], slot_ids[mid:], ts_s[mid:], ts_ns[mid:],
                active_table, host_idx[mid:],
            )
            for e in ev2:
                e.line += mid
            return ev1 + ev2

        def dev_i32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int32)).to(self.device)

        with self._lock:
            self._run_maintenance_locked()
            out = _apply_core(
                self._state, bits, active_table, host_idx_t, dev_i32(slot_ids),
                dev_i32(ts_s), dev_i32(ts_ns), self._limits, self._iv_s,
                self._iv_ns, n_rules=self.n_rules, max_events=self.max_events,
            )
            ev = events_to_host(out)
            # the shadow update stays inside this lock window, so batches'
            # final states land in device-apply order
            self.absorb_events_locked(ev, np.asarray(slot_ids))
        return self.window_events(ev)

    def absorb_events_locked(self, ev: Dict[str, np.ndarray], slot_ids: np.ndarray) -> None:
        """Shadow update in (line, rule) order — the reference's processing
        order — so dict insertion order matches the host path's; each
        (ip, rule)'s last write is its chronologically last event."""
        rule, line = ev["rule"], ev["line"]
        live = np.flatnonzero(rule >= 0)
        for k in live[np.lexsort((rule[live], line[live]))]:
            ip = self._slot_ip.get(int(slot_ids[int(line[k])]))
            if ip is None:  # unreachable while the batch is pinned
                continue
            od = self._shadow.setdefault(ip, OrderedDict())
            od[int(rule[k])] = (
                int(ev["hits"][k]), int(ev["start_s"][k]), int(ev["start_ns"][k])
            )

    @staticmethod
    def window_events(ev: Dict[str, np.ndarray]) -> List[WindowEvent]:
        live = np.flatnonzero(ev["rule"] >= 0)
        events = [
            WindowEvent(
                line=int(ev["line"][k]),
                rule_id=int(ev["rule"][k]),
                match_type=RateLimitMatchType(int(ev["match_type"][k])),
                exceeded=bool(ev["exceeded"][k]),
                seen_ip=bool(ev["seen_ip"][k]),
            )
            for k in live
        ]
        events.sort(key=lambda e: (e.line, e.rule_id))
        return events

    def _run_maintenance_locked(self) -> None:
        """Drain queued evictions + restores into the device state."""
        if not self._pending_evict and not self._pending_restore:
            return
        pend_ev, pend_rs = self._pending_evict, self._pending_restore
        self._pending_evict, self._pending_restore = [], []
        R = self.n_rules
        ev_slots = np.asarray(pend_ev, dtype=np.int64)
        ev_keys = (ev_slots[:, None] * R + np.arange(R, dtype=np.int64)[None, :]).ravel()
        r_keys: List[int] = []
        r_vals: List[Tuple[int, int, int]] = []
        r_slots: List[int] = []
        for slot, ip in pend_rs:
            if self._slot_ip.get(slot) != ip:
                # stale restore: the slot was re-evicted (and maybe given to
                # another ip) after this restore was queued
                continue
            od = self._shadow.get(ip)
            if not od:
                continue
            r_slots.append(slot)
            for rid, hsn in od.items():
                r_keys.append(slot * R + rid)
                r_vals.append(hsn)
        vals = np.asarray(r_vals, dtype=np.int32).reshape(-1, 3)

        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

        _maintenance_step(
            self._state, t(ev_keys), t(ev_slots), t(r_keys), t(vals[:, 0], torch.int32),
            t(vals[:, 1], torch.int32), t(vals[:, 2], torch.int32), t(r_slots),
        )

    # ---- refused-row host apply (the slot-admission path) ----

    def apply_host_events(self, events: Sequence[Tuple[int, int, str, int]]) -> List[WindowEvent]:
        """Window transitions of slot-refused rows: `events` are
        (row, rule_id, ip, ts_ns), sorted by (row, rule_id) — the
        reference order. The fixed-window step of `_apply_core` in exact
        int64 nanoseconds: restart strictly past the interval, hits reset
        to 0 on exceed, FirstTime / OutsideInterval / InsideInterval,
        seen_ip = the IP had state before this event. The touched vectors
        go to the warm tier (the shadow when it is off or the put drops),
        so a refused IP that matched anything is admitted next batch."""
        out: List[WindowEvent] = []
        if not events:
            return out
        with self._lock:
            touched: "Dict[str, OrderedDict]" = {}
            warm = self._warm
            warm_live = warm is not None and len(warm) > 0
            for row, rid, ip, ts_ns in events:
                od = touched.get(ip)
                if od is None:
                    od = self._shadow.get(ip)
                    if od is None and warm_live:
                        ent = warm.take(ip)
                        if ent is not None:
                            od = OrderedDict((r, (h, s, ns)) for r, h, s, ns in ent)
                    if od is None:
                        od = OrderedDict()
                    touched[ip] = od
                seen = bool(od)
                st = od.get(rid)
                have = st is not None
                outside = False
                if have:
                    h0, s0, n0 = st
                    outside = int(ts_ns) - (s0 * _NS_PER_S + n0) > int(self._iv_total_np[rid])
                if not have or outside:
                    h1 = 1
                    s1, n1 = divmod(int(ts_ns), _NS_PER_S)
                else:
                    h1 = h0 + 1
                    s1, n1 = s0, n0
                exceeded = h1 > int(self._limits_np[rid])
                od[rid] = (0 if exceeded else h1, s1, n1)
                mtype = 0 if not have else (1 if outside else 2)
                out.append(WindowEvent(
                    line=int(row), rule_id=int(rid),
                    match_type=RateLimitMatchType(mtype),
                    exceeded=bool(exceeded), seen_ip=seen,
                ))
            now_ns = time.time_ns()
            for ip, od in touched.items():
                if warm is not None:
                    entries = [(rid, h, s, ns) for rid, (h, s, ns) in od.items()]
                    if warm.put(ip, entries, now_ns):
                        self._shadow.pop(ip, None)
                        self.warm_spills += 1
                        continue
                self._shadow[ip] = od
        return out

    # ---- introspection through the host shadow and the warm tier ----

    def get(self, ip: str) -> Tuple[Dict[str, NumHitsAndIntervalStart], bool]:
        with self._lock:
            od = self._shadow.get(ip)
            if not od and self._warm is not None:
                ent = self._warm.peek(ip)
                if ent:
                    od = OrderedDict((r, (h, s, ns)) for r, h, s, ns in ent)
            if not od:
                return {}, False
            return {
                self._rule_names[rid]: NumHitsAndIntervalStart(h, s * _NS_PER_S + ns)
                for rid, (h, s, ns) in od.items()
            }, True

    def format_states(self) -> str:
        with self._lock:
            rows = [(ip, list(od.items())) for ip, od in self._shadow.items()]
            if self._warm is not None and len(self._warm):
                # warm-resident IPs are disjoint from the shadow
                for ip in self._warm.keys():
                    ent = self._warm.peek(ip)
                    if ent:
                        rows.append((ip, [(r, (h, s, ns)) for r, h, s, ns in ent]))
        if not rows:
            return ""
        lines: List[str] = []
        for ip, states in rows:
            lines.append(f"{ip}:")
            for rid, (h, s, ns) in states:
                lines.append(f"\t{self._rule_names[rid]}:")
                lines.append(f"\t\tNumHitsAndIntervalStart({h}, {s * _NS_PER_S + ns})")
            lines.append("")
        return "\n".join(lines) + ("\n" if lines else "")
