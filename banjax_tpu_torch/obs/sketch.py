"""Traffic sketch: count-min and HyperLogLog over client-IP hashes, on the
matcher's device (port of `banjax_tpu/obs/sketch.py`).

Every chunk the matcher commits folds in as a few in-place torch ops on
the card: a count-min sketch (`[depth * width]` int32, conservative point
estimates for the heavy-hitter view and the slot-admission gate) with
`index_add_`, and HLL registers (`[2^p]` int32, distinct-source
cardinality) with `scatter_reduce_(..., "amax")`. Integer adds and max are
exact in any order, so the card's arrays equal the CPU's bit for bit and
the JAX package's.

The update keys on the per-row window slot ids the chunk already uses:
`note_assignments` keeps a slot -> ip-hash table on the device (host
mirror diffed per batch, only changed slots copied up) that the update
gathers through. Rows the admission gate refused have no slot; their
counts accrue exactly in a host count-min mirror (`fold_refused`).

Nothing on the chunk path reads the card: `estimate_ips` reads the host
mirror and the count-min cached by the last `pull`, and only `pull`
copies the device arrays to the host (throttled by `pull_seconds`).
Per-rule pressure is counted on the host from the window events every
path already replays.

`hash_ip`, `_fmix32_np` and `_CM_SEEDS` are also the base of the bounded
failed-challenge state (`challenge/failures.py`).
"""

from __future__ import annotations

import heapq
import math
import threading
import time
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# xor seeds decorrelating the count-min rows (any fixed distinct values
# work: the row hash is fmix32(ip_hash ^ seed_j)); the golden-ratio
# constant seeds the independent HLL hash
_CM_SEEDS = (0x0000_0000, 0x7F4A_7C15, 0x94D0_49BB, 0xDE82_4AD5,
             0x1B87_3593, 0xC2B2_AE35, 0x27D4_EB2F, 0x1656_67B1)
_HLL_SEED = 0x9E37_79B9

_MIN_SLOT_TABLE = 1024
_M32 = 0xFFFF_FFFF


def _bucket(n: int, floor: int) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def _fmix32_np(h: np.ndarray) -> np.ndarray:
    """murmur3 finalizer, numpy uint32 (the host mirror of `fmix32`)."""
    h = h.astype(np.uint32, copy=True)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EB_CA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2_AE35)
    h ^= h >> np.uint32(16)
    return h


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32), without an int64
    overflow: the constant splits into 16-bit halves, so each partial
    product stays below 2^48."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EB_CA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2_AE35)
    return h ^ (h >> 16)


def hll_rho(g: torch.Tensor, low_bits: int) -> torch.Tensor:
    """1 + leading zeros of the low `low_bits` bits of g (int64 holding a
    uint32): low_bits - bit_length(w) + 1, so w = 0 gives low_bits + 1.
    The bit length is frexp's exponent of w as a float64, exact for every
    w < 2^53 (w < 2^28 here)."""
    w = g & ((1 << low_bits) - 1)
    _, e = torch.frexp(w.to(torch.float64))
    return low_bits - e.to(torch.int64) + 1


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy on the host (`.cpu()` of a CPU tensor would alias the
    state that later updates change in place)."""
    return t.to("cpu", copy=True).numpy()


def hash_ip(ip: str) -> int:
    """The 32-bit base hash of one client-IP string (crc32 of the utf-8
    bytes); every derived hash mixes from this value."""
    return zlib.crc32(ip.encode("utf-8", "surrogatepass")) & 0xFFFF_FFFF


def hll_estimate(registers: np.ndarray) -> float:
    """Bias-corrected HyperLogLog estimate with the small-range (linear
    counting) correction; no large-range correction."""
    m = registers.size
    alpha = 0.7213 / (1.0 + 1.079 / m)
    raw = alpha * m * m / float(np.sum(np.exp2(-registers.astype(np.float64))))
    if raw <= 2.5 * m:
        zeros = int(np.count_nonzero(registers == 0))
        if zeros:
            return m * math.log(m / zeros)
    return raw


class TrafficSketch:
    """Device-resident traffic sketches with a host-side top-K view.

    Thread-safe: one lock serializes the in-place device updates and the
    host bookkeeping. Nothing here catches an error: a device fault in an
    update reaches the caller."""

    def __init__(
        self,
        rule_names: Sequence[str],
        device,
        *,
        depth: int = 4,
        width: int = 8192,
        hll_p: int = 12,
        pull_seconds: float = 5.0,
        topk: int = 32,
        max_candidates: int = 8192,
    ):
        if not 1 <= depth <= len(_CM_SEEDS):
            raise ValueError(f"sketch depth must be 1..{len(_CM_SEEDS)}")
        if width < 16:
            raise ValueError("sketch width must be >= 16")
        if not 4 <= hll_p <= 16:
            raise ValueError("hll_p must be 4..16")
        self.device = torch.device(device)
        self.depth = int(depth)
        self.width = int(width)
        self.hll_p = int(hll_p)
        self.m = 1 << self.hll_p
        self.pull_seconds = max(0.0, float(pull_seconds))
        self.topk = max(1, int(topk))
        self.max_candidates = max(self.topk, int(max_candidates))
        self.rule_names = list(rule_names)
        self._n_rules = max(1, len(self.rule_names))

        self._lock = threading.Lock()
        dev = self.device
        self._cm = torch.zeros(self.depth * self.width, dtype=torch.int32, device=dev)
        self._hll = torch.zeros(self.m, dtype=torch.int32, device=dev)
        # per-rule pressure: exact host counts of fired window events
        self._rule_hits = np.zeros(self._n_rules, dtype=np.int64)
        # host count-min mirror of the slot-refused rows (same geometry)
        self._cm_host = np.zeros((self.depth, self.width), dtype=np.int64)
        self.refused_rows_folded = 0
        # the count-min as of the last pull: the admission gate's view
        self._cm_cache: Optional[np.ndarray] = None
        # slot -> ip-hash table (uint32 values in int64 on the device)
        self._slot_hash_dev = torch.zeros(_MIN_SLOT_TABLE, dtype=torch.int64, device=dev)
        self._slot_hash_host = np.zeros(_MIN_SLOT_TABLE, dtype=np.uint32)
        # candidate heavy hitters: LRU of recent distinct IPs -> base hash
        self._candidates: "OrderedDict[str, int]" = OrderedDict()
        # row offsets of the count-min rows and their seeds, [depth, 1]
        self._row_base = (torch.arange(self.depth, dtype=torch.int64) * self.width)[:, None].to(dev)
        self._seeds = torch.tensor(_CM_SEEDS[: self.depth], dtype=torch.int64)[:, None].to(dev)

        self.lines_total = 0
        self.update_count = 0
        self.pull_count = 0
        self.pull_bytes_total = 0
        self._last_pull_mono: Optional[float] = None
        self._summary: Optional[dict] = None

    # ---- host bookkeeping (slot table + candidates) ----

    def note_assignments(self, ips: Sequence[str], slots: np.ndarray) -> None:
        """Refresh the slot -> hash table for one batch's distinct
        (ip, slot) pairs; only slots whose owner changed are copied to
        the device."""
        n = len(ips)
        if n == 0:
            return
        slots = np.asarray(slots, dtype=np.int64)
        with self._lock:
            cand = self._candidates
            hashes = np.empty(n, dtype=np.uint32)
            for k, ip in enumerate(ips):
                h = cand.get(ip)
                if h is None:
                    h = hash_ip(ip)
                cand[ip] = h
                cand.move_to_end(ip)
                hashes[k] = h
            while len(cand) > self.max_candidates:
                cand.popitem(last=False)

            need = int(slots.max()) + 1
            if need > self._slot_hash_host.size:
                new_size = _bucket(need, _MIN_SLOT_TABLE)
                grown = np.zeros(new_size, dtype=np.uint32)
                grown[: self._slot_hash_host.size] = self._slot_hash_host
                self._slot_hash_host = grown
                dev_grown = torch.zeros(new_size, dtype=torch.int64, device=self.device)
                dev_grown[: self._slot_hash_dev.shape[0]] = self._slot_hash_dev
                self._slot_hash_dev = dev_grown
            changed = self._slot_hash_host[slots] != hashes
            if changed.any():
                ch_slots, ch_hash = slots[changed], hashes[changed]
                self._slot_hash_host[ch_slots] = ch_hash
                idx = torch.from_numpy(ch_slots).to(self.device)
                val = torch.from_numpy(ch_hash.astype(np.int64)).to(self.device)
                self._slot_hash_dev.index_copy_(0, idx, val)

    # ---- the per-chunk device update ----

    def update(self, slots, n_real: int) -> None:
        """Fold one chunk's first `n_real` rows (their window slots) into
        the count-min and HLL arrays, in place; nothing is read back."""
        slots_np = np.ascontiguousarray(np.asarray(slots, dtype=np.int64)[: max(0, int(n_real))])
        if slots_np.size == 0:
            return
        low_bits = 32 - self.hll_p
        with self._lock:
            idx = torch.from_numpy(slots_np).to(self.device)
            h = self._slot_hash_dev[idx]                              # [B]
            col = fmix32(h[None, :] ^ self._seeds) % self.width       # [depth, B]
            flat = (col + self._row_base).reshape(-1)
            self._cm.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
            g = fmix32(h ^ _HLL_SEED)
            reg = g >> low_bits
            self._hll.scatter_reduce_(0, reg, hll_rho(g, low_bits).to(torch.int32), reduce="amax")
            self.lines_total += int(slots_np.size)
            self.update_count += 1

    def note_rule_events(self, rule_ids) -> None:
        """Fold fired (line, rule) window events into per-rule pressure."""
        ids = np.fromiter((int(r) for r in rule_ids), dtype=np.int64)
        if not ids.size:
            return
        counts = np.bincount(ids[(ids >= 0) & (ids < self._n_rules)], minlength=self._n_rules)
        with self._lock:
            self._rule_hits += counts

    # ---- state ----

    def arrays(self) -> Dict[str, np.ndarray]:
        """The device arrays on the host: count-min, HLL registers and the
        slot -> hash table (uint32), in the JAX sketch's shapes."""
        with self._lock:
            return {
                "cm": _host(self._cm),
                "hll": _host(self._hll),
                "slot_hash": _host(self._slot_hash_dev).astype(np.uint32),
            }

    # ---- the periodic compact pull ----

    def pull(self, force: bool = False) -> dict:
        """Refresh (throttled by `pull_seconds`) and return the summary:
        top-K heavy hitters with conservative count-min estimates, the HLL
        distinct-IP estimate and per-rule pressure."""
        with self._lock:
            now_m = time.monotonic()
            if (
                not force
                and self._summary is not None
                and self._last_pull_mono is not None
                and now_m - self._last_pull_mono < self.pull_seconds
            ):
                return self._summary
            cm = _host(self._cm).reshape(self.depth, self.width)
            hll = _host(self._hll)
            rule_hits = self._rule_hits
            self._cm_cache = cm
            self.pull_bytes_total += cm.nbytes + hll.nbytes
            self.pull_count += 1
            self._last_pull_mono = time.monotonic()

            top: List[dict] = []
            if self._candidates:
                ips = list(self._candidates)
                base = np.fromiter(self._candidates.values(), dtype=np.uint32, count=len(ips))
                est = None
                for j in range(self.depth):
                    ci = (_fmix32_np(base ^ np.uint32(_CM_SEEDS[j])) % np.uint32(self.width)).astype(np.int64)
                    vals = cm[j, ci] + self._cm_host[j, ci]
                    est = vals if est is None else np.minimum(est, vals)
                for k in heapq.nlargest(self.topk, range(len(ips)), key=lambda i: int(est[i])):
                    if est[k] <= 0:
                        break
                    top.append({"ip": ips[k], "est_count": int(est[k])})

            distinct = hll_estimate(hll)
            lines = self.lines_total
            share = round(top[0]["est_count"] / lines, 4) if top and lines else 0.0
            pressure = [
                {"rule": name, "index": i, "events": int(rule_hits[i])}
                for i, name in enumerate(self.rule_names)
                if i < rule_hits.size and rule_hits[i] > 0
            ]
            pressure.sort(key=lambda r: -r["events"])
            self._summary = {
                "top": top,
                "k_max": self.topk,
                "distinct_ips_estimate": round(distinct, 1),
                "heavy_hitter_share": share,
                "lines_total": lines,
                "rule_pressure": pressure,
                "sketch": {
                    "depth": self.depth,
                    "width": self.width,
                    "hll_registers": self.m,
                    "candidates": len(self._candidates),
                    "pull_count": self.pull_count,
                    "pull_bytes_total": self.pull_bytes_total,
                },
            }
            return self._summary

    def pull_age_seconds(self) -> Optional[float]:
        with self._lock:
            if self._last_pull_mono is None:
                return None
            return time.monotonic() - self._last_pull_mono

    def incident_snapshot(self) -> dict:
        """The flight recorder's `traffic.json`: a forced pull, so the
        bundle shows the traffic as of the incident."""
        out = dict(self.pull(force=True))
        out["enabled"] = True
        return out

    def estimate_ip(self, ip: str) -> int:
        """Point estimate for one IP from the device count-min as it is now
        plus the host mirror (a pull first, as the JAX sketch does)."""
        self.pull()
        with self._lock:
            cm = _host(self._cm).reshape(self.depth, self.width)
            cm_host = self._cm_host
        cols = self._columns(np.asarray([hash_ip(ip)], dtype=np.uint32))[:, 0]
        return int(min(int(cm[j, cols[j]]) + int(cm_host[j, cols[j]]) for j in range(self.depth)))

    # ---- the slot-admission surface ----

    @staticmethod
    def base_hashes(ips: Sequence[str]) -> np.ndarray:
        """uint32 [n] base hashes of a distinct-ip list."""
        return np.fromiter((hash_ip(ip) for ip in ips), dtype=np.uint32, count=len(ips))

    def _columns(self, base: np.ndarray) -> np.ndarray:
        """int64 [depth, n] count-min column per row of base hashes."""
        cols = np.empty((self.depth, len(base)), dtype=np.int64)
        for j in range(self.depth):
            cols[j] = (_fmix32_np(base ^ np.uint32(_CM_SEEDS[j])) % np.uint32(self.width)).astype(np.int64)
        return cols

    def estimate_ips(self, ips: Sequence[str], hashes: Optional[np.ndarray] = None) -> np.ndarray:
        """Conservative count estimates, int64 [n], from the host mirror
        plus the count-min cached at the last pull; never reads the card.
        An unseen IP's own rows are all in the host mirror, so a stale
        cache can only under-count collisions, never the IP's rows."""
        n = len(ips)
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        base = self.base_hashes(ips) if hashes is None else hashes
        cols = self._columns(base)
        with self._lock:
            cache = self._cm_cache
            est: Optional[np.ndarray] = None
            for j in range(self.depth):
                vals = self._cm_host[j, cols[j]]
                if cache is not None:
                    vals = vals + cache[j, cols[j]]
                est = vals if est is None else np.minimum(est, vals)
        return est

    def fold_refused(self, ips: Sequence[str], counts: np.ndarray,
                     hashes: Optional[np.ndarray] = None) -> None:
        """Fold one batch's refused rows (`counts[i]` rows of `ips[i]`)
        into the host count-min mirror, exactly."""
        if len(ips) == 0:
            return
        base = self.base_hashes(ips) if hashes is None else hashes
        cols = self._columns(base)
        counts = np.asarray(counts, dtype=np.int64)
        with self._lock:
            for j in range(self.depth):
                np.add.at(self._cm_host[j], cols[j], counts)
            self.refused_rows_folded += int(counts.sum())
