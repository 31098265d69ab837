"""Kernel A: the batched bit-parallel NFA match on Hopper.

Replaces the Pallas TPU kernel `banjax_tpu/matcher/kernels/nfa_match.py`
`_kernel` (built by `_build_raw_call`, wrapped by `device_matcher` and
`match_batch_pallas`). The CUDA source is `banjax_tpu_torch/csrc/
nfa_match.cu`; its note says what bounds it (the longest line's chain of
dependent byte steps, or the integer pipe for a large batch) and how the
design hides the step latency: each thread carries R lines of one
length-sorted group, teams share one staged table slab and exchange all R
lines' carries in one shuffle and one barrier per byte.

`prepare` is the port's own table layout: the packed uint32 rows of a
CompiledRules as int32 storage, unpadded ([C, W] table, [6, W] masks,
W = n_shards * words_per_shard; a team of the kernel owns one shard).
`accept_words` returns the raw accept words [B, W] in the layout of
`nfa_jax.nfa_scan`, so it compares directly with that function, and
`match_bits` adds the extraction epilogue of the TPU `device_matcher`.

On a CPU tensor the wrapper runs the plain version (`nfa.nfa_scan_words`);
on a CUDA tensor it launches the kernel or raises. The launch sorts the
line lengths on the device first (as `match_batch_pallas` sorts them on
the host), into scratch the wrapper allocates.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from banjax_tpu_torch.device import to_i32_storage, to_words
from banjax_tpu_torch.matcher import nfa
from banjax_tpu_torch.matcher.kernels._build import LL, CudaLibrary, I, P, raw_stream
from banjax_tpu_torch.matcher.rulec import CompiledRules

KERNEL = CudaLibrary(
    "nfa_match", "nfa_match.cu",
    {"nfa_scan_launch": [P, LL, P, P, P, P, P, I, I, I, I, I, I, I, I, P]},
)

_MAX_WORDS_PER_SHARD = 1024  # one thread per word of a shard
LINES_PER_THREAD = (1, 2, 4, 8)  # the kernel's instantiations of R
_RESIDENT_THREADS_PER_SM = 2048
_SMS: Dict[int, int] = {}  # multiprocessors per CUDA device index


@dataclasses.dataclass
class TorchNfaRules:
    """Kernel-ready repack of CompiledRules on one device."""

    n_rules: int
    n_shards: int
    wps: int                    # words per shard
    n_classes: int
    carry_free: bool
    table: torch.Tensor         # [C, W] int32 storage of the uint32 rows
    masks: torch.Tensor         # [6, W] int32 storage
    table_words: torch.Tensor   # [C, W] int64 words (the plain version's)
    mask_words: torch.Tensor    # [6, W] int64 words
    acc_word: torch.Tensor      # [n_branches] int64
    acc_mask: torch.Tensor      # [n_branches] int32 storage
    branch_rule: torch.Tensor   # [n_branches] int64
    always_match: torch.Tensor  # [n_rules] bool
    empty_only: torch.Tensor    # [n_rules] bool
    lines_by_batch: Dict[int, int] = dataclasses.field(default_factory=dict)  # B -> R

    @property
    def n_words(self) -> int:
        return self.n_shards * self.wps


def prepare(compiled: CompiledRules, device) -> TorchNfaRules:
    dev = torch.device(device)
    if compiled.words_per_shard > _MAX_WORDS_PER_SHARD:
        raise ValueError(
            f"{compiled.words_per_shard} words per shard exceeds the kernel's "
            f"{_MAX_WORDS_PER_SHARD}; compile with more shards (n_shards='auto')"
        )
    masks = np.stack([
        compiled.shift_in, compiled.inject_always, compiled.inject_start,
        compiled.selfloop, compiled.accept_any, compiled.accept_end,
    ]).astype(np.uint32)
    # the kernel takes no carry into a shard's first word (nor any word
    # when carry_free); the plain scan does, so both agree only where
    # shift_in drops it, as rulec packs it
    no_carry = masks[0] if compiled.carry_free else masks[0, :: compiled.words_per_shard]
    if (no_carry & 1).any():
        raise ValueError("shift_in takes a carry into a word the kernel gives none")
    return TorchNfaRules(
        n_rules=compiled.n_rules,
        n_shards=compiled.n_shards,
        wps=compiled.words_per_shard,
        n_classes=compiled.n_classes,
        carry_free=bool(compiled.carry_free),
        table=to_i32_storage(compiled.b_table, dev),
        masks=to_i32_storage(masks, dev),
        table_words=to_words(compiled.b_table, dev),
        mask_words=to_words(masks, dev),
        acc_word=torch.as_tensor(compiled.acc_word, dtype=torch.int64).to(dev),
        acc_mask=to_i32_storage(compiled.acc_mask, dev),
        branch_rule=torch.as_tensor(compiled.branch_rule, dtype=torch.int64).to(dev),
        always_match=torch.as_tensor(compiled.always_match, dtype=torch.bool).to(dev),
        empty_only=torch.as_tensor(compiled.empty_only, dtype=torch.bool).to(dev),
    )


def lines_per_thread(prep: TorchNfaRules, B: int, device=None) -> int:
    """R, the lines each thread of kernel A carries for a batch of B lines:
    the most that still puts two waves of the card's resident threads in
    flight. A thread per (line group, word): more lines a thread hide more
    of each byte step's latency, fewer threads fill more of the card.
    Picked on an H100 from chip_smoke.py's sweep over R (PERF.md): stage 1
    (4,096 lines, 38 words) takes 1, stage 2 (512 lines, 6 x 377 words) 2,
    the single-stage fallback (4,096 lines) 8."""
    dev = torch.device(device if device is not None else prep.table.device)
    # (a CPU rehearsal reports R for an H100's 132 multiprocessors)
    sms = _SMS.get(dev.index or 0) if dev.type == "cuda" else 132
    if sms is None:
        sms = _SMS[dev.index or 0] = torch.cuda.get_device_properties(dev).multi_processor_count
    wps = prep.wps if prep.carry_free else -(-prep.wps // 32) * 32
    threads_per_line = prep.n_shards * wps
    for R in (8, 4, 2):
        if -(-B // R) * threads_per_line >= 2 * sms * _RESIDENT_THREADS_PER_SM:
            return R
    return 1


def accept_words_plain(prep: TorchNfaRules, cls: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on the tensors' device."""
    return nfa.nfa_scan_words(prep.table_words, prep.mask_words, cls, lens)


def accept_words(prep: TorchNfaRules, cls: torch.Tensor, lens: torch.Tensor,
                 lines: int = 0) -> torch.Tensor:
    """Raw accept words [B, W] (int32 storage of uint32) for class ids
    `cls` [B, L] (int32; rows may be strided, elements contiguous) and
    line lengths `lens` [B] (int32): kernel A on CUDA tensors, the plain
    version on CPU tensors. `lines` overrides R (one of LINES_PER_THREAD)."""
    B, L = cls.shape
    W = prep.n_words
    if cls.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("cls and lens must be int32")
    if cls.stride(1) != 1 or not lens.is_contiguous() or lens.shape != (B,):
        raise ValueError("cls rows must be contiguous and lens a contiguous [B]")
    if lens.device != cls.device or prep.table.device != cls.device:
        raise ValueError("cls, lens and the prepared tables must share a device")
    if cls.device.type == "cpu":
        return accept_words_plain(prep, cls, lens)
    if cls.device.type != "cuda":
        raise ValueError(f"unsupported device {cls.device}")
    R = lines or prep.lines_by_batch.get(B)
    if R is None:
        R = prep.lines_by_batch[B] = lines_per_thread(prep, B, cls.device)
    if R not in LINES_PER_THREAD:
        raise ValueError(f"lines per thread {R} is not one of {LINES_PER_THREAD}")
    out = torch.empty((B, W), dtype=torch.int32, device=cls.device)
    if B == 0:
        return out
    # scratch for the kernel's length sort (groups of one line go without)
    order = torch.empty(B, dtype=torch.int32, device=cls.device) if R > 1 else None
    KERNEL.count_launch()
    KERNEL.call(
        "nfa_scan_launch", cls.data_ptr(), cls.stride(0), lens.data_ptr(),
        None if order is None else order.data_ptr(),
        prep.table.data_ptr(), prep.masks.data_ptr(), out.data_ptr(), B, L,
        prep.n_classes, W, prep.n_shards, 0 if prep.carry_free else 1, R,
        cls.device.index, raw_stream(cls.device),
    )
    return out


def extract(prep: TorchNfaRules, acc: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The `device_matcher` epilogue: accept words -> [B, n_rules] uint8."""
    return nfa.extract_matches(
        acc, lens, prep.acc_word, prep.acc_mask, prep.branch_rule,
        prep.always_match, prep.empty_only, prep.n_rules,
    )


def match_bits(prep: TorchNfaRules, cls: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """[B, L] class ids -> [B, n_rules] uint8 match bits (kernel + epilogue)."""
    return extract(prep, accept_words(prep, cls, lens), lens)
