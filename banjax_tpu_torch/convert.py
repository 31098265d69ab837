"""Carry state from the JAX package into the port.

The JAX package hands its state over as plain numpy arrays and Python
containers (this module imports nothing of it):

* `rules_from_arrays` turns compiled-rule arrays — the fields of a
  `CompiledRules` as a dict (e.g. `dataclasses.asdict` of one) — into the
  port's CompiledRules; `plan_from_arrays` does the same for a prefilter
  plan whose two stages are such dicts. The port's own compile of the
  same patterns gives identical arrays (tests/test_torch_prefilter.py).
* `window_state_from_arrays` turns a JAX `DeviceWindowState` (its five
  arrays) into the port's; `load_window_state` puts such a state
  and the host slot bookkeeping of a JAX `DeviceWindows` into a port
  `DeviceWindows`, so a run can continue on the card where the JAX
  matcher stopped; `load_tiering` adds the tiering counters, the
  sketch-admission marks and the warm tier's table (its raw bytes: the
  port's record layout is the JAX package's), and `load_sketch_state`
  the traffic sketch (count-min, HLL, slot -> hash table, host mirror,
  cached pull, candidates, counters).
* `load_regex_states` puts the contents of a JAX `RegexRateLimitStates`
  (ip -> rule name -> hits and interval start) into the port's, the host
  window states that `matcher: cpu` and host windows step.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from banjax_tpu_torch.decisions.rate_limit import NumHitsAndIntervalStart, RegexRateLimitStates
from banjax_tpu_torch.obs.sketch import TrafficSketch

from banjax_tpu_torch.matcher.prefilter import PrefilterPlan
from banjax_tpu_torch.matcher.rulec import CompiledRules
from banjax_tpu_torch.matcher.windows import DeviceWindows, DeviceWindowState

_ARRAY_FIELDS = {
    "byte_to_class": np.int32, "b_table": np.uint32, "shift_in": np.uint32,
    "inject_always": np.uint32, "inject_start": np.uint32, "selfloop": np.uint32,
    "accept_any": np.uint32, "accept_end": np.uint32, "acc_word": np.int32,
    "acc_mask": np.uint32, "branch_rule": np.int32, "always_match": bool,
    "empty_only": bool, "device_ok": bool,
}


def rules_from_arrays(d: Mapping) -> CompiledRules:
    """Compiled-rule arrays (CompiledRules fields) -> the port's CompiledRules."""
    kw = {}
    for f in dataclasses.fields(CompiledRules):
        if f.name in _ARRAY_FIELDS:
            kw[f.name] = np.asarray(d[f.name], dtype=_ARRAY_FIELDS[f.name])
        elif f.name == "unsupported":
            kw[f.name] = {int(k): str(v) for k, v in dict(d.get(f.name, {})).items()}
        elif f.name == "carry_free":
            kw[f.name] = bool(d.get(f.name, False))
        else:
            kw[f.name] = int(d[f.name])
    return CompiledRules(**kw)


def plan_from_arrays(d: Mapping) -> PrefilterPlan:
    """Prefilter plan arrays ({"stage1": {...}, "stage2": {...}, n_rules,
    n_always, a_idx, n_factors, f_idx, unsupported}) -> PrefilterPlan."""
    return PrefilterPlan(
        n_rules=int(d["n_rules"]),
        stage1=rules_from_arrays(d["stage1"]),
        n_always=int(d["n_always"]),
        a_idx=np.asarray(d["a_idx"], dtype=np.int64),
        n_factors=int(d["n_factors"]),
        stage2=rules_from_arrays(d["stage2"]),
        f_idx=np.asarray(d["f_idx"], dtype=np.int64),
        unsupported={int(k): str(v) for k, v in dict(d.get("unsupported", {})).items()},
    )


def window_state_from_arrays(state: Mapping[str, np.ndarray], device) -> DeviceWindowState:
    """A JAX DeviceWindowState's five arrays (hits, start_s, start_ns,
    valid, ip_seen) -> the port's, with each array's drop slot appended."""

    def with_drop(a, dtype):
        t = torch.from_numpy(np.array(a, dtype=dtype))
        return torch.cat([t, torch.zeros(1, dtype=t.dtype)]).to(device)

    return DeviceWindowState(
        hits=with_drop(state["hits"], np.int32),
        start_s=with_drop(state["start_s"], np.int32),
        start_ns=with_drop(state["start_ns"], np.int32),
        valid=with_drop(state["valid"], bool),
        ip_seen=with_drop(state["ip_seen"], bool),
    )


def load_window_state(
    dw: DeviceWindows,
    state: Mapping[str, np.ndarray],   # hits, start_s, start_ns, valid, ip_seen
    slots: Mapping[str, int],          # ip -> slot
    shadow: Mapping[str, Mapping[int, Sequence[int]]],  # ip -> {rule: (h, s, ns)}
    free: Optional[Sequence[int]] = None,
    last_used: Optional[np.ndarray] = None,
    batch_seq: int = 0,
) -> None:
    """Replace `dw`'s state with a JAX DeviceWindows' state. The slot
    table, LRU stamps and free list carry over as they are (so slot
    numbering continues), pins start released and nothing is pending.
    `free` defaults to every unassigned slot, highest first. A native
    slot manager is rebuilt by placing the IPs in slot order; it holds
    the slots 0..k-1 and the default free order, which is what a slot
    manager without a clear ever holds."""
    cap = int(np.asarray(state["ip_seen"]).shape[0])
    cap_r = int(np.asarray(state["hits"]).shape[0])
    if cap_r != cap * dw.n_rules:
        raise ValueError(f"state holds {cap_r} keys, expected {cap} x {dw.n_rules}")
    with dw._lock:
        dw._state = window_state_from_arrays(state, dw.device)
        dw.capacity = cap
        if not dw.auto_grow:
            dw.max_capacity = cap
        dw._slots = {str(ip): int(s) for ip, s in slots.items()}
        dw._slot_ip = {s: ip for ip, s in dw._slots.items()}
        if free is None:
            free = [s for s in range(cap - 1, -1, -1) if s not in dw._slot_ip]
        dw._free = [int(s) for s in free]
        if dw._sm is not None:
            dw._sm = _native_slots(cap, dw._slot_ip, dw._free)
            dw._slots, dw._free = {}, []
        dw._last_used = (
            np.zeros(cap, dtype=np.int64) if last_used is None
            else np.asarray(last_used, dtype=np.int64).copy()
        )
        dw._batch_seq = int(batch_seq)
        dw._pin_counts = np.zeros(cap, dtype=np.int32)
        dw._pending_evict = []
        dw._pending_restore = []
        dw._shadow = {
            str(ip): OrderedDict(
                (int(rid), tuple(int(x) for x in hsn)) for rid, hsn in od.items()
            )
            for ip, od in shadow.items()
        }



def _native_slots(cap: int, slot_ip: Mapping[int, str], free: Sequence[int]):
    """A native slot manager holding `slot_ip`: the IPs placed in slot
    order pop the free stack 0, 1, 2, ..."""
    from banjax_tpu_torch.native import slotmgr

    order = sorted(slot_ip)
    if order != list(range(len(order))) or list(free) != list(range(cap - 1, len(order) - 1, -1)):
        raise ValueError("a native slot manager holds slots 0..k-1 with the rest free in order")
    sm = slotmgr.create(cap)
    if order:
        scratch_used = np.zeros(cap, dtype=np.int64)
        got, miss, ctx = sm.lookup_batch([slot_ip[x] for x in order], 1, scratch_used)
        _, evicted, ok = sm.place_misses(ctx, got, miss, 1, np.zeros(cap, dtype=np.int32),
                                         scratch_used)
        if not ok or len(evicted) or got.tolist() != order:
            raise ValueError("the slot table did not rebuild in slot order")
    return sm


def load_tiering(
    dw: DeviceWindows,
    counters: Mapping[str, int],
    sketch_pending: Iterable[str] = (),
    sketch_slots: Optional[Mapping[int, bool]] = None,
    warm_table: Optional[bytes] = None,
) -> None:
    """Carry a JAX DeviceWindows' tiering into `dw`: its counters
    (slot_refusals, sketch_admissions, sketch_fp_evaluated,
    sketch_fp_count, warm_spills, warm_refills, eviction_count), the IPs
    admitted on a sketch estimate and their slots, and the warm tier's
    table as raw bytes (the same geometry: capacity and rule count)."""
    with dw._lock:
        for k, v in counters.items():
            if not hasattr(dw, k):
                raise ValueError(f"unknown tiering counter {k!r}")
            setattr(dw, k, int(v))
        dw._sketch_pending = set(sketch_pending)
        dw._sketch_slots = {int(k): bool(v) for k, v in dict(sketch_slots or {}).items()}
        if warm_table is not None:
            if dw._warm is None:
                raise ValueError("the warm tier is off in the target")
            raw = np.frombuffer(warm_table, dtype=np.uint8)
            if raw.size != dw._warm.nbytes:
                raise ValueError(f"warm table of {raw.size} bytes, expected {dw._warm.nbytes}")
            dw._warm._view[:] = raw


def load_sketch_state(sk: TrafficSketch, d: Mapping) -> None:
    """Carry a JAX TrafficSketch into `sk` (same depth, width and p):
    cm, hll, slot_hash (uint32), cm_host, cm_cache (None or [depth,
    width]), candidates (ip -> base hash, LRU order), rule_hits,
    lines_total, update_count, refused_rows_folded."""
    cm = np.asarray(d["cm"], dtype=np.int32)
    hll = np.asarray(d["hll"], dtype=np.int32)
    if cm.shape != (sk.depth * sk.width,) or hll.shape != (sk.m,):
        raise ValueError("sketch geometry differs")
    slot_hash = np.asarray(d["slot_hash"], dtype=np.uint32)
    with sk._lock:
        sk._cm = torch.from_numpy(cm.copy()).to(sk.device)
        sk._hll = torch.from_numpy(hll.copy()).to(sk.device)
        sk._slot_hash_host = slot_hash.copy()
        sk._slot_hash_dev = torch.from_numpy(slot_hash.astype(np.int64)).to(sk.device)
        sk._cm_host = np.asarray(d["cm_host"], dtype=np.int64).copy()
        cache = d.get("cm_cache")
        sk._cm_cache = None if cache is None else np.asarray(cache).copy()
        sk._candidates = OrderedDict((str(k), int(v)) for k, v in d["candidates"].items())
        sk._rule_hits = np.asarray(d["rule_hits"], dtype=np.int64).copy()
        sk.lines_total = int(d["lines_total"])
        sk.update_count = int(d["update_count"])
        sk.refused_rows_folded = int(d["refused_rows_folded"])
        sk.pull_count = int(d["pull_count"])
        sk.pull_bytes_total = int(d["pull_bytes_total"])


def load_regex_states(states: RegexRateLimitStates, content: Mapping[str, Mapping]) -> None:
    """Replace `states`' contents with `content`: ip -> rule name -> the
    window's (num_hits, interval_start_time_ns), as a pair or as an object
    with those two attributes (a JAX `NumHitsAndIntervalStart`). Insertion
    order carries over, so `format_states` lists the IPs and rules as the
    source does."""
    def entry(v) -> NumHitsAndIntervalStart:
        if hasattr(v, "num_hits"):
            return NumHitsAndIntervalStart(int(v.num_hits), int(v.interval_start_time_ns))
        hits, start_ns = v
        return NumHitsAndIntervalStart(int(hits), int(start_ns))

    with states._lock:
        states._states = {
            str(ip): {str(rule): entry(v) for rule, v in rules.items()}
            for ip, rules in content.items()
        }
