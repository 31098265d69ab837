"""Work batches of the matcher's host path (copies of `LazyResults`,
`LazyLine`, `NativeWork`, `ListWork`, `CompositeWork` and `unique_spans`
from `banjax_tpu/matcher/workset.py`).

`NativeWork` keeps a natively parsed batch columnar: numpy row indices
and unique-string tables, with per-row Python objects made only for the
rows something touches (matched rows, ban logging). `ListWork` wraps the
Python parse path in the same interface:

len(work); work[int] -> (orig_index, line); work[slice] and
work.take(index array) -> the same kind; unique_ips() -> (distinct ips in
first-appearance order, per-row inverse); host_idx(host_row) -> int32
per row; ts_array() -> int64 ns per row. `CompositeWork` joins the
work sets of the sharded encode's row shards in line order.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np

from banjax_tpu_torch.matcher.encode import ParsedLine


class LazyResults:
    """List-compatible ConsumeLineResult vector that materializes entries
    on first access (most lines of a batch are never touched)."""

    __slots__ = ("_items", "_n_set")

    def __init__(self, n: int):
        self._items = [None] * n
        self._n_set = 0

    def __len__(self) -> int:
        return len(self._items)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[k] for k in range(*i.indices(len(self._items)))]
        r = self._items[i]
        if r is None:
            from banjax_tpu_torch.matcher.api import ConsumeLineResult

            r = self._items[i] = ConsumeLineResult()
            self._n_set += 1
        return r

    def __iter__(self):
        for k in range(len(self._items)):
            yield self[k]

    def absorb(self, other: "LazyResults", row0: int) -> None:
        """Copy `other`'s materialized entries in at row offset `row0` (the
        sharded encode's merge); untouched rows stay lazy, and a shard
        that materialized nothing costs nothing."""
        if other._n_set == 0:
            return
        dst = self._items
        for i, r in enumerate(other._items):
            if r is not None:
                dst[row0 + i] = r
        self._n_set += other._n_set


class LazyLine:
    """ParsedLine-compatible view over one natively parsed row; `rest`
    decodes from the parse blob on first touch. Rows with an error or
    stale flag never enter a work set, so both are class-level False."""

    __slots__ = ("timestamp_ns", "ip", "host", "_nb", "_nbrow", "_rest")

    error = False
    old_line = False

    def __init__(self, nb, nbrow: int, ip: str, host: str, ts_ns: int):
        self.timestamp_ns = ts_ns
        self.ip = ip
        self.host = host
        self._nb = nb
        self._nbrow = nbrow
        self._rest = None

    @property
    def rest(self) -> str:
        if self._rest is None:
            self._rest = self._nb.rest(self._nbrow)
        return self._rest


class NativeWork:
    """(orig_index, line) sequence backed by a native ParsedBatch: `rows`
    index the parse batch (= the original line indices), `ip_inv` and
    `host_inv` index unique-string tables that slices and takes share."""

    __slots__ = ("nb", "rows", "ips_u", "ip_inv", "hosts_u", "host_inv", "ts_ns",
                 "defer_map")

    def __init__(self, nb, rows, ips_u, ip_inv, hosts_u, host_inv, ts_ns, defer_map):
        self.nb = nb
        self.rows = rows                  # int64 [n]
        self.ips_u: List[str] = ips_u
        self.ip_inv = ip_inv              # int64 [n] -> ips_u
        self.hosts_u: List[str] = hosts_u
        self.host_inv = host_inv          # int64 [n] -> hosts_u
        self.ts_ns = ts_ns                # int64 [n]
        # Python-parsed lines of the FLAG_DEFER rows, keyed by batch row
        self.defer_map: Dict[int, ParsedLine] = defer_map

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, k):
        if isinstance(k, slice):
            return NativeWork(self.nb, self.rows[k], self.ips_u, self.ip_inv[k],
                              self.hosts_u, self.host_inv[k], self.ts_ns[k], self.defer_map)
        nbrow = int(self.rows[k])
        p = self.defer_map.get(nbrow)
        if p is None:
            p = LazyLine(self.nb, nbrow, self.ips_u[self.ip_inv[k]],
                         self.hosts_u[self.host_inv[k]], int(self.ts_ns[k]))
        return nbrow, p

    def __iter__(self):
        for k in range(len(self.rows)):
            yield self[k]

    def take(self, idx) -> "NativeWork":
        """Subset by an index array, sharing the tables like a slice."""
        idx = np.asarray(idx, dtype=np.int64)
        return NativeWork(self.nb, self.rows[idx], self.ips_u, self.ip_inv[idx],
                          self.hosts_u, self.host_inv[idx], self.ts_ns[idx], self.defer_map)

    def unique_ips(self) -> Tuple[List[str], np.ndarray]:
        """(distinct ips of this view, per-row inverse): the shared table
        is compacted, so a slice never claims slots for ips not in it."""
        present, inv = np.unique(self.ip_inv, return_inverse=True)
        if present.size == len(self.ips_u):
            return self.ips_u, self.ip_inv
        ips_u = self.ips_u
        return [ips_u[j] for j in present.tolist()], inv

    def host_idx(self, host_row: Dict[str, int]) -> np.ndarray:
        if not self.hosts_u:
            return np.zeros(len(self.rows), dtype=np.int32)
        tbl = np.asarray([host_row.get(h, 0) for h in self.hosts_u], dtype=np.int32)
        return tbl[self.host_inv]

    def ts_array(self) -> np.ndarray:
        return self.ts_ns


class ListWork(list):
    """[(orig_index, ParsedLine)] with the columnar accessors."""

    def unique_ips(self) -> Tuple[List[str], np.ndarray]:
        uniq: "OrderedDict[str, int]" = OrderedDict()
        inv = np.empty(len(self), dtype=np.int64)
        for k, (_, p) in enumerate(self):
            j = uniq.get(p.ip)
            if j is None:
                j = len(uniq)
                uniq[p.ip] = j
            inv[k] = j
        return list(uniq), inv

    def host_idx(self, host_row: Dict[str, int]) -> np.ndarray:
        return np.asarray([host_row.get(p.host, 0) for _, p in self], dtype=np.int32)

    def ts_array(self) -> np.ndarray:
        # Python float()*1e9 can exceed int64: clamp (the window arrays
        # only; replay reads the exact Python int from the ParsedLine)
        lo, hi = -(2**63), 2**63 - 1
        return np.asarray(
            [min(max(p.timestamp_ns, lo), hi) for _, p in self], dtype=np.int64
        )

    def __getitem__(self, k):
        if isinstance(k, slice):
            return ListWork(super().__getitem__(k))
        return super().__getitem__(k)

    def take(self, idx) -> "ListWork":
        return ListWork(list.__getitem__(self, int(i)) for i in idx)


class CompositeWork:
    """Line-order concatenation of per-shard work sets: `offsets[j]` is the
    batch row where part j's shard starts, so the (orig_index, line) pairs
    it yields carry global batch rows. unique_ips() merges the parts'
    first-appearance tables in shard order, which is the global
    first-appearance order (slot assignment depends on it). Positional
    subsets take ascending indices, as every caller passes."""

    __slots__ = ("parts", "offsets", "_starts")

    def __init__(self, parts: List, offsets: List[int]):
        self.parts = parts
        self.offsets = offsets
        self._starts = np.cumsum([0] + [len(w) for w in parts])

    def __len__(self) -> int:
        return int(self._starts[-1])

    def __getitem__(self, k):
        if isinstance(k, slice):
            return self.take(np.arange(*k.indices(len(self)), dtype=np.int64))
        j = int(np.searchsorted(self._starts, k, side="right")) - 1
        i, p = self.parts[j][k - int(self._starts[j])]
        return self.offsets[j] + i, p

    def __iter__(self):
        for j, w in enumerate(self.parts):
            off = self.offsets[j]
            for i, p in w:
                yield off + i, p

    def take(self, idx):
        idx = np.asarray(idx, dtype=np.int64)
        parts: List = []
        offsets: List[int] = []
        for j, w in enumerate(self.parts):
            lo, hi = int(self._starts[j]), int(self._starts[j + 1])
            sel = idx[(idx >= lo) & (idx < hi)] - lo
            if sel.size:
                parts.append(w.take(sel))
                offsets.append(self.offsets[j])
        if not parts:
            return ListWork()
        if len(parts) == 1 and offsets[0] == 0:
            return parts[0]
        return CompositeWork(parts, offsets)

    def unique_ips(self) -> Tuple[List[str], np.ndarray]:
        merged: Dict[str, int] = {}
        strings: List[str] = []
        invs = []
        for w in self.parts:
            ips_u, inv = w.unique_ips()
            remap = np.empty(len(ips_u), dtype=np.int64)
            for j, s in enumerate(ips_u):
                g = merged.get(s)
                if g is None:
                    g = len(strings)
                    merged[s] = g
                    strings.append(s)
                remap[j] = g
            invs.append(remap[np.asarray(inv, dtype=np.int64)])
        return strings, np.concatenate(invs)

    def host_idx(self, host_row: Dict[str, int]) -> np.ndarray:
        return np.concatenate([w.host_idx(host_row) for w in self.parts])

    def ts_array(self) -> np.ndarray:
        return np.concatenate([w.ts_array() for w in self.parts])


def unique_spans(offs: np.ndarray, lens: np.ndarray, blob: bytes, text,
                 dedup_scratch=None) -> Tuple[List[str], np.ndarray]:
    """Distinct strings over (offset, length) spans of a parse blob, in
    first-appearance order, and the per-row inverse: the C dedup
    (`native.dedup_spans`), then the unique strings sliced out of the
    blob (out of `text`, the blob as str, when it is ASCII)."""
    from banjax_tpu_torch import native

    if len(offs) == 0:
        return [], np.zeros(0, dtype=np.int64)
    ids, first = native.dedup_spans(blob, offs, lens, dedup_scratch)
    ot, lt = offs.tolist(), lens.tolist()
    if text is not None:
        strings = [text[ot[r] : ot[r] + lt[r]] for r in first.tolist()]
    else:
        strings = [blob[ot[r] : ot[r] + lt[r]].decode("utf-8", "surrogatepass")
                   for r in first.tolist()]
    return strings, ids
