"""Device-mesh sharding for the batched NFA matcher (port of
`banjax_tpu/parallel/mesh.py`).

The JAX mesh is one process running one `jax.jit(shard_map(...))` over a
`Mesh` of shape (dp, rp):

  * `dp`, data parallel over the line batch: each dp row classifies one
    block of the lines;
  * `rp`, rule parallel over the packed NFA word axis: each member of a
    row holds one slab of the transition tables. rulec never lets a
    branch straddle a shard, so a slab takes no carry from its
    neighbour, and the only collective is one `psum` of accept bits over
    `rp`.

The port is one process too. `make_mesh` gives a dp x rp grid of
`torch.device`s, and each member's kernel launches on the member's own
device. One device may hold several members (the tests put every member
on the CPU; one card holds them all on cuda:0), and members on one device
share one copy of each table. There is no torch.distributed: the `psum`
of 0/1 selections followed by `> 0` is an OR, taken here by moving each
member's bits to its row's first member's device.

Member slabs (`member_slab`). Rp member r of a ruleset packed into
n_shards = rp * k shards owns the run of k shards r*k .. r*k + k - 1:
words [r*k*wps, (r+1)*k*wps) of the table and the masks, and the
branches whose accept word lies there. The JAX mesh needs n_shards == rp;
the port's kernel A takes at most 1,024 words a shard, so
`compile_for_mesh` packs rp * k shards with the least k that fits (k = 1
is the JAX layout). The match bits do not depend on k.

A member's match is kernel A (`nfa_match.accept_words`) on its slab, then
the selection of its own branches scattered into rules
(`nfa_match.extract`); a row ORs its members' bits. Scatter-then-OR is
JAX's OR-then-scatter (`_extract_local`), and each member ORing the
always-match and empty-only rules in is the same as doing it once.

The fused two-stage (JAX `sharded_fused_fn`). Stage 1, the narrow
factor/always automaton packed "auto", runs once per dp row on the row's
first member's device; JAX runs it on every member of the row, each
computing the same words. The candidate gate and the fixed-capacity
compaction are local to the row; stage 2 runs on each member's slab over
the candidates only; the always rules' bits come from stage 1. A row
whose candidates exceed the capacity K sends the whole batch to the
single-stage sharded match at collect (counted), as in JAX.

`ShardedMatchBackend` is the batch wrapper a mesh-mode TorchMatcher
matches with. Its batch bucket, its L_p bucket and its length-sorted
round-robin permutation are JAX's exactly: each row's candidate count,
and so whether a batch is fused, depends on them.

Differences from JAX: no `backend` argument (a CPU member runs the plain
versions, a CUDA member launches the kernel or raises), and no fallback
to another body when a kernel refuses a shape: a shape no kernel takes
raises when the backend is built.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from banjax_tpu_torch.device import fixed_nonzero, to_i32_storage
from banjax_tpu_torch.matcher.kernels import nfa_match
from banjax_tpu_torch.matcher.rulec import CompiledRules, lower_rules, pack_programs
from banjax_tpu_torch.obs import trace

log = logging.getLogger(__name__)

# byte columns a step of the JAX kernel (`nfa_match._COLS_PER_STEP`): the
# L_p bucket's floor and the granularity of its cap, kept so that the
# buckets, and with them the compaction shapes, are JAX's
_COLS_PER_STEP = 8

# lines a block: the batch bucket's granularity a dp row and the fused
# compaction's rounding. 8 is the block the JAX mesh runs under its xla and
# pallas-interpret backends, and the port's non-compiled candidate block
_BLOCK_B = 8

# the fused two-stage's candidate capacity, a share of a dp row's lines
# (JAX `sharded_fused_fn`'s default)
_CAND_FRAC = 0.125


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A dp x rp grid of devices: `grid[d][r]` runs rp member r of dp row d."""

    dp: int
    rp: int
    grid: Tuple[Tuple[torch.device, ...], ...]


def _norm(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices: Sequence, rp: int = 1) -> DeviceMesh:
    """Mesh of shape (dp = len(devices) // rp, rp), rows filled in order."""
    n = len(devices)
    if rp < 1 or n == 0 or n % rp != 0:
        raise ValueError(f"n_devices {n} not divisible by rp {rp}")
    devs = [_norm(d) for d in devices]
    grid = tuple(tuple(devs[i * rp:(i + 1) * rp]) for i in range(n // rp))
    return DeviceMesh(dp=n // rp, rp=rp, grid=grid)


def resolve_rp(n_devices: int, rp: int = 0) -> int:
    """The rule-parallel degree of a mesh-mode matcher: `rp`, or with 0 the
    largest power of two up to min(4, n_devices) that divides n_devices
    (JAX `TpuMatcher`)."""
    if rp == 0:
        rp = 1
        while rp * 2 <= min(4, n_devices) and n_devices % (rp * 2) == 0:
            rp *= 2
    if n_devices % rp != 0:
        raise ValueError(
            f"matcher_mesh_rp {rp} does not divide matcher_mesh_devices {n_devices}"
        )
    return rp


def mesh_placement(n_devices: int, device,
                   mesh_devices: Optional[Sequence] = None) -> Optional[List[torch.device]]:
    """The members' devices for a mesh-mode matcher on `device`: the given
    list (one device a member, repeats allowed), else cuda:0 .. cuda:N-1
    for a CUDA matcher, or N times the CPU for a CPU matcher. None when a
    CUDA matcher asks for more members than there are cards: the matcher
    then runs single-device, with a warning, as the JAX matcher does.
    Every member lies on the matcher's device type: a CPU member under a
    CUDA matcher, or the reverse, raises."""
    device = torch.device(device)
    if mesh_devices is not None:
        devs = [torch.device(d) for d in mesh_devices]
        if len(devs) != n_devices:
            raise ValueError(
                f"mesh_devices names {len(devs)} devices for matcher_mesh_devices {n_devices}"
            )
        mixed = sorted({str(d) for d in devs if d.type != device.type})
        if mixed:
            raise ValueError(f"mesh_devices {mixed} are not {device.type} devices like "
                             f"the matcher's {device}")
        return devs
    if device.type != "cuda":
        return [device] * n_devices
    n_avail = torch.cuda.device_count()
    if n_devices > n_avail:
        log.warning(
            "matcher_mesh_devices=%d but only %d CUDA devices are attached; "
            "running single-device", n_devices, n_avail,
        )
        return None
    return [torch.device("cuda", i) for i in range(n_devices)]


def compile_for_mesh(patterns: Sequence[str], rp: int) -> CompiledRules:
    """`compile_rules(patterns, n_shards=rp * k)` for the least k whose
    shards fit kernel A's words a shard. The byte classes do not depend on
    the shard count."""
    programs, unsupported = lower_rules(patterns)
    for k in itertools.count(1):
        compiled = pack_programs(programs, n_shards=rp * k, unsupported=unsupported)
        if compiled.words_per_shard <= nfa_match._MAX_WORDS_PER_SHARD:
            return compiled
        if rp * k >= max(1, len(compiled.branch_rule)):
            raise ValueError(
                f"a branch is wider than kernel A's {nfa_match._MAX_WORDS_PER_SHARD} "
                "words a shard"
            )
    raise AssertionError("unreachable")


def member_slab(compiled: CompiledRules, rp: int, r: int) -> CompiledRules:
    """Rp member r's part of `compiled` (whose shard count rp divides): k
    shards of the tables and masks, and its own branches with their accept
    words renumbered from the slab's first word."""
    if compiled.n_shards % rp:
        raise ValueError(
            f"ruleset compiled for {compiled.n_shards} shards, not a multiple of "
            f"mesh rp={rp}"
        )
    k = compiled.n_shards // rp
    span = k * compiled.words_per_shard
    lo, hi = r * span, (r + 1) * span
    local = np.asarray(compiled.acc_word, dtype=np.int64) - lo
    mine = (local >= 0) & (local < span)
    return dataclasses.replace(
        compiled,
        n_shards=k,
        b_table=compiled.b_table[:, lo:hi],
        shift_in=compiled.shift_in[lo:hi],
        inject_always=compiled.inject_always[lo:hi],
        inject_start=compiled.inject_start[lo:hi],
        selfloop=compiled.selfloop[lo:hi],
        accept_any=compiled.accept_any[lo:hi],
        accept_end=compiled.accept_end[lo:hi],
        acc_word=local[mine].astype(np.int32),
        acc_mask=np.asarray(compiled.acc_mask)[mine],
        branch_rule=np.asarray(compiled.branch_rule)[mine],
    )


@dataclasses.dataclass
class _Stage1:
    """Stage 1 of the fused plan on one device: the prepared tables, the
    candidate gate's factor mask and the always rules' extraction."""

    prep: nfa_match.TorchNfaRules
    fmask: torch.Tensor
    a_word: torch.Tensor
    a_mask: torch.Tensor
    a_rule: torch.Tensor
    a_idx: torch.Tensor
    f_idx: torch.Tensor


class ShardedMatchBackend:
    """Batch-level mesh matcher, the match backend of a mesh-mode
    TorchMatcher.

    `submit` pads and permutes an encoded batch onto the dp rows (length-
    sorted round robin, so that every row gets a balanced mix of line
    lengths) and queues each row's device work without waiting for it;
    `collect` pulls one buffer a dp row and returns the bitmap in the
    caller's line order. Kernel A's calls on a CUDA member, each one
    launch, are counted by dp row (`row_launches`, stage 1) and by member
    (`member_launches`, stage 2 or the single-stage match).

    `cand_frac` is the fused candidate capacity's share of a row
    (`_CAND_FRAC`); a test may set it before the first submit."""

    def __init__(
        self,
        compiled: CompiledRules,
        mesh: DeviceMesh,
        max_len: int,
        plan=None,                 # prefilter.PrefilterPlan (stage 2 rp-packed)
        health=None,               # resilience.health.ComponentHealth
    ):
        self.health = health
        self.mesh = mesh
        self.dp = mesh.dp
        self.rp = mesh.rp
        self.n_rules = compiled.n_rules
        self.max_len = max_len
        self.cand_frac = _CAND_FRAC
        self.plan = plan
        # how often the fused path ran against the single-stage fallback
        self.fused_batches = 0
        self.fallback_batches = 0
        # submit and collect wall times (the metrics line): the EWMAs, and
        # the per-row pulls of the last collect
        self.submit_ms_ewma: Optional[float] = None
        self.merge_ms_ewma: Optional[float] = None
        self.last_shard_merge_ms: List[float] = []
        self.row_launches = [0] * self.dp
        self.member_launches = [[0] * self.rp for _ in range(self.dp)]
        self._slabs = self._prepare_slabs(compiled)
        self._slabs2 = None
        self._stage1: Dict[torch.device, _Stage1] = {}
        if plan is not None:
            from banjax_tpu_torch.matcher.prefilter import gate_masks

            if plan.stage1.n_classes != plan.stage2.n_classes:
                raise ValueError("fused plan requires shared byte classes")
            self._slabs2 = self._prepare_slabs(plan.stage2)
            fmask, a_word, a_mask, a_rule = gate_masks(plan)
            for dev in {row[0] for row in mesh.grid}:
                self._stage1[dev] = _Stage1(
                    prep=nfa_match.prepare(plan.stage1, dev),
                    fmask=to_i32_storage(fmask, dev),
                    a_word=torch.as_tensor(a_word, dtype=torch.int64).to(dev),
                    a_mask=to_i32_storage(a_mask, dev),
                    a_rule=torch.as_tensor(a_rule, dtype=torch.int64).to(dev),
                    a_idx=torch.as_tensor(plan.a_idx, dtype=torch.int64).to(dev),
                    f_idx=torch.as_tensor(plan.f_idx, dtype=torch.int64).to(dev),
                )
            self._a_always = np.asarray(plan.stage1.always_match[: plan.n_always], dtype=bool)
            self._a_empty = np.asarray(plan.stage1.empty_only[: plan.n_always], dtype=bool)

    def _prepare_slabs(self, compiled: CompiledRules):
        """[dp][rp] prepared member slabs, one copy per (device, member)."""
        by_key: Dict[Tuple[torch.device, int], nfa_match.TorchNfaRules] = {}
        slabs = [member_slab(compiled, self.rp, r) for r in range(self.rp)]
        out = []
        for row in self.mesh.grid:
            out.append([])
            for r, dev in enumerate(row):
                if (dev, r) not in by_key:
                    by_key[(dev, r)] = nfa_match.prepare(slabs[r], dev)
                out[-1].append(by_key[(dev, r)])
        return out

    # ---- device work ----

    def _accept(self, d: int, r: Optional[int], prep, cls, lens) -> torch.Tensor:
        """Kernel A on a CUDA member (one launch, counted here), the plain
        version on a CPU one. A row's block never is empty."""
        acc = nfa_match.accept_words(prep, cls, lens)
        if cls.is_cuda:
            if r is None:
                self.row_launches[d] += 1
            else:
                self.member_launches[d][r] += 1
        return acc

    def _members_or(self, d: int, slabs, cls, lens) -> torch.Tensor:
        """Row d's match bits [b, n_rules of the slabs' ruleset] uint8, on
        the row's first member's device: each member's kernel A and
        extraction, ORed over rp."""
        lead = self.mesh.grid[d][0]
        out = None
        for r, dev in enumerate(self.mesh.grid[d]):
            c, ln = (cls, lens) if dev == lead else (cls.to(dev), lens.to(dev))
            bits = nfa_match.extract(slabs[d][r], self._accept(d, r, slabs[d][r], c, ln), ln)
            bits = bits.to(lead)
            out = bits if out is None else out | bits
        return out

    def _fused_row(self, d: int, cls, lens, K: int) -> torch.Tensor:
        """Row d's fused two-stage: one uint8 buffer, the candidate count
        (int32, 4 bytes) then the bits [b, n_rules] with the always rules'
        static flags not yet applied."""
        lead = self.mesh.grid[d][0]
        st = self._stage1[lead]
        plan = self.plan
        b = cls.shape[0]
        acc1 = self._accept(d, None, st.prep, cls, lens)                # [b, W1]
        cand = ((acc1 & st.fmask) != 0).any(dim=1)
        n_cand = cand.sum(dtype=torch.int32)
        idx = fixed_nonzero(cand, K, fill=0)                            # ascending
        valid = torch.arange(K, device=lead) < n_cand
        cls2 = cls[idx].contiguous()
        lens2 = torch.where(valid, lens[idx], 0).to(torch.int32)
        m2 = self._members_or(d, self._slabs2, cls2, lens2) * valid[:, None].to(torch.uint8)
        # valid slots hold distinct rows; empty ones write zeros to a dump row
        filt = torch.zeros((b + 1, m2.shape[1]), dtype=torch.uint8, device=lead)
        filt[torch.where(valid, idx, b)] = m2
        bits = torch.zeros((b, self.n_rules), dtype=torch.uint8, device=lead)
        if plan.n_always:
            sel = ((acc1[:, st.a_word] & st.a_mask) != 0).to(torch.uint8)
            ab = torch.zeros((b, plan.n_always), dtype=torch.uint8, device=lead)
            if sel.shape[1]:
                ab.scatter_reduce_(1, st.a_rule[None, :].expand(b, -1), sel, reduce="amax")
            bits[:, st.a_idx] = ab
        bits[:, st.f_idx] = filt[:b]
        return torch.cat([n_cand.reshape(1).view(torch.uint8), bits.reshape(-1)])

    def _ewma(self, attr: str, value_ms: float) -> None:
        prev = getattr(self, attr)
        setattr(self, attr, value_ms if prev is None else prev + 0.2 * (value_ms - prev))

    # ---- the batch ----

    def submit(self, cls_ids: np.ndarray, lens: np.ndarray) -> dict:
        """Queue the sharded match of one batch without waiting for the
        card (the streaming pipeline's submit stage); returns the pend
        `collect` completes."""
        t0 = time.perf_counter()
        cls_ids = np.asarray(cls_ids, dtype=np.int32)
        lens = np.asarray(lens, dtype=np.int32)
        B, L = cls_ids.shape
        # the padded batch: a power-of-two multiple of dp * _BLOCK_B
        chunk = self.dp * _BLOCK_B
        Bp = chunk
        while Bp < B:
            Bp <<= 1

        # the scan stops at the longest line: power-of-two L_p buckets
        max_len = int(lens.max()) if B else 0
        L_cap = -(-L // _COLS_PER_STEP) * _COLS_PER_STEP
        L_p = 32
        while L_p < max_len:
            L_p <<= 1
        L_p = max(_COLS_PER_STEP, min(L_cap, L_p))

        # length-sorted round robin over dp: row d takes sorted lines
        # d, d + dp, d + 2 dp, ...
        order = np.argsort(lens, kind="stable")
        perm = np.empty(Bp, dtype=np.int64)
        rows_per_dev = Bp // self.dp
        pos = 0
        for d in range(self.dp):
            idx = np.arange(d, Bp, self.dp)
            perm[pos : pos + rows_per_dev] = idx
            pos += rows_per_dev
        cls_sorted = np.zeros((Bp, L_p), dtype=np.int32)
        cls_sorted[:B, : min(L, L_p)] = cls_ids[order, : min(L, L_p)]
        lens_sorted = np.zeros(Bp, dtype=np.int32)
        lens_sorted[:B] = lens[order]
        cls_dev = cls_sorted[perm]
        lens_dev = lens_sorted[perm]

        b_local = Bp // self.dp
        blocks = []
        for d, row in enumerate(self.mesh.grid):
            sl = slice(d * b_local, (d + 1) * b_local)
            blocks.append((torch.from_numpy(cls_dev[sl]).to(row[0]),
                           torch.from_numpy(lens_dev[sl]).to(row[0])))
        pend = {
            "B": B, "Bp": Bp, "L_p": L_p, "order": order, "perm": perm,
            "lens_dev": lens_dev, "blocks": blocks, "fused": False,
            "h2d_bytes": cls_dev.nbytes + lens_dev.nbytes, "d2h_bytes": 0,
        }
        if self.plan is not None:
            # fused two-stage: stage-1 gate per dp row, stage 2 on the
            # compacted candidates only; a row's candidate overflow
            # sends the batch to the single-stage match at collect
            block = min(_BLOCK_B, b_local)
            K = min(b_local,
                    max(block, -(-int(b_local * self.cand_frac) // block) * block))
            with trace.span("mesh-submit", args={"dp": self.dp, "fused": True}):
                rows_d = [self._fused_row(d, c, ln, K) for d, (c, ln) in enumerate(blocks)]
            pend.update(fused=True, K=K, rows_d=rows_d)
            if self.health is not None:
                self.health.beat()
        else:
            with trace.span("mesh-submit", args={"dp": self.dp, "fused": False}):
                pend["out_d"] = [self._members_or(d, self._slabs, c, ln) for d, (c, ln) in enumerate(blocks)]
        self._ewma("submit_ms_ewma", (time.perf_counter() - t0) * 1e3)
        return pend

    def collect(self, pend: dict) -> np.ndarray:
        """Complete a submitted batch: pull each dp row's buffer, merge the
        rows back into the caller's line order, apply the always rules'
        static flags. The per-row pull times land in last_shard_merge_ms
        (metrics: MeshShardMergeMsMax)."""
        t0 = time.perf_counter()
        B, Bp = pend["B"], pend["Bp"]
        order, perm = pend["order"], pend["perm"]
        b_local = Bp // self.dp
        out = None
        if pend["fused"]:
            bufs = self._pull_rows(pend["rows_d"], pend)
            n_cand = [int(np.frombuffer(buf[:4].tobytes(), dtype="<i4")[0]) for buf in bufs]
            if max(n_cand) <= pend["K"]:
                out = np.concatenate([buf[4:].reshape(b_local, self.n_rules) for buf in bufs])
                self.fused_batches += 1
                if self.health is not None:
                    self.health.ok()
                plan = self.plan
                if plan.n_always:
                    if self._a_always.any():
                        out[:, plan.a_idx[self._a_always]] = 1
                    if self._a_empty.any():
                        empty_rows = np.flatnonzero(pend["lens_dev"] == 0)
                        out[np.ix_(empty_rows, plan.a_idx[self._a_empty])] = 1
            else:
                self.fallback_batches += 1
                if self.health is not None:
                    # correct but slower: the single-stage sharded match
                    # reruns the whole batch
                    self.health.degraded(
                        f"fused prefilter overflow x{self.fallback_batches}; "
                        "single-stage rerun"
                    )
        if out is None:
            if "out_d" not in pend:
                pend["out_d"] = [self._members_or(d, self._slabs, c, ln)
                                 for d, (c, ln) in enumerate(pend["blocks"])]
            out = np.concatenate(self._pull_rows(pend["out_d"], pend))

        # undo the row permutation, then the length sort
        unperm = np.empty(Bp, dtype=np.int64)
        unperm[perm] = np.arange(Bp)
        out_sorted = out[unperm][:B]
        unsorted = np.empty_like(out_sorted)
        unsorted[order] = out_sorted
        self._ewma("merge_ms_ewma", (time.perf_counter() - t0) * 1e3)
        return unsorted

    def _pull_rows(self, tensors, pend: dict) -> List[np.ndarray]:
        """One device-to-host pull a dp row, each timed and spanned."""
        self.last_shard_merge_ms = []
        out = []
        for d, t in enumerate(tensors):
            t0 = time.perf_counter()
            with trace.span("mesh-shard-pull", args={"shard": d}):
                host = t.cpu().numpy()
            self.last_shard_merge_ms.append((time.perf_counter() - t0) * 1e3)
            pend["d2h_bytes"] += host.nbytes
            out.append(host)
        return out

    def match_bits(self, cls_ids: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """[B, L] encoded lines -> [B, n_rules] uint8, any B, in input
        order: the synchronous form of submit and collect."""
        return self.collect(self.submit(cls_ids, lens))
