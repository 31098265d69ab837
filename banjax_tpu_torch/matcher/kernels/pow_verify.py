"""Kernel C: the batched SHA-256 proof-of-work check on Hopper.

Replaces the Pallas TPU kernel `banjax_tpu/matcher/kernels/pow_verify.py`
`_pow_kernel` (via `_pow_call` and `leading_zero_bits_batch`). The sha-inv
challenge accepts a cookie when `sha256(hmac[20] || solution[32])` starts
with at least `sha_inv_expected_zero_bits` zero bits; the 52-byte message
pads to one SHA-256 block, so a batch of B candidates is B independent
compressions. The CUDA source is `banjax_tpu_torch/csrc/pow_verify.cu`;
its note says what bounds a dispatch and what bounds the body.

Two ways onto the card:

* `PowDispatcher`, the verifier's: pinned payload slots and counts that
  the card addresses directly, a stream of its own, and one C call a
  batch that launches the kernel and waits for that stream alone. Nothing
  is allocated or copied by PyTorch per dispatch.
* `leading_zero_bits`, for batches already on the card: packed `[B, 52]`
  uint8 messages (`pack_payloads`) in, `[B]` int32 counts out, launched
  on the current stream; on a CPU tensor it runs the plain version
  (`leading_zero_bits_plain`).

`pow_selftest` holds both against hashlib before a verifier takes traffic.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from banjax_tpu_torch.crypto.challenge import count_zero_bits_from_left
from banjax_tpu_torch.device import U32, DeviceLike, resolve_device
from banjax_tpu_torch.matcher.kernels._build import CudaLibrary, I, P, raw_stream

KERNEL = CudaLibrary("pow_verify", "pow_verify.cu", {
    "pow_verify_launch": [P, P, I, I, P],
    "pow_verify_dispatch": [P, P, I, I, P],
    "pow_verify_check_mapped": [P, I],
})

# 52-byte message = hmac[20] || solution[32]; one padded SHA-256 block:
# 13 data words, the 0x80 terminator word, a zero word, the bit length
POW_MESSAGE_BYTES = 20 + 32
_PAD_WORDS = (0x80000000, 0, POW_MESSAGE_BYTES * 8)

_H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)


def check_payloads(payloads: Sequence[bytes]) -> None:
    """Raise ValueError (the JAX `pack_pow_messages` text) on a payload
    that is not 52 bytes."""
    for j, payload in enumerate(payloads):
        if len(payload) != POW_MESSAGE_BYTES:
            raise ValueError(
                f"payload {j}: want {POW_MESSAGE_BYTES} bytes, got {len(payload)}"
            )


def pack_payloads(payloads: Sequence[bytes], device) -> torch.Tensor:
    """52-byte hmac||solution payloads -> [B, 52] uint8 on `device`."""
    check_payloads(payloads)
    flat = np.frombuffer(b"".join(payloads), dtype=np.uint8)
    return torch.from_numpy(flat.reshape(len(payloads), POW_MESSAGE_BYTES).copy()).to(device)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & U32


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit words (int64) by a bit-length cascade."""
    bl = torch.zeros_like(x)
    y = x
    for shift in (16, 8, 4, 2, 1):
        cond = (y >> shift) > 0
        bl = bl + torch.where(cond, shift, 0)
        y = torch.where(cond, y >> shift, y)
    return 32 - (bl + (y > 0).to(torch.int64))


def leading_zero_bits_plain(msg: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on the tensor's device:
    32-bit words carried in int64 masked to 32 bits, vectorised over the
    batch, the 64 rounds as a Python loop."""
    B = msg.shape[0]
    m = msg.to(torch.int64).view(B, POW_MESSAGE_BYTES // 4, 4)
    data = (m[..., 0] << 24) | (m[..., 1] << 16) | (m[..., 2] << 8) | m[..., 3]
    w = [data[:, i] for i in range(POW_MESSAGE_BYTES // 4)]
    w += [torch.full((B,), v, dtype=torch.int64, device=msg.device) for v in _PAD_WORDS]
    a, b, c, d, e, f, g, h = (
        torch.full((B,), v, dtype=torch.int64, device=msg.device) for v in _H0
    )
    for i in range(64):
        if i < 16:
            wi = w[i]
        else:
            w15, w2 = w[(i - 15) % 16], w[(i - 2) % 16]
            s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
            s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
            wi = (w[i % 16] + s0 + w[(i - 7) % 16] + s1) & U32
            w[i % 16] = wi
        ch = (e & f) ^ (~e & g & U32)
        t1 = (h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)) + ch + _K[i] + wi) & U32
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = ((_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)) + maj) & U32
        a, b, c, d, e, f, g, h = (t1 + t2) & U32, a, b, c, (d + t1) & U32, e, f, g
    total = torch.zeros(B, dtype=torch.int64, device=msg.device)
    live = torch.ones(B, dtype=torch.bool, device=msg.device)
    for x, v in zip((a, b, c, d, e, f, g, h), _H0):
        word = (x + v) & U32
        total = total + torch.where(live, _clz32(word), 0)
        live = live & (word == 0)
    return total.to(torch.int32)


def leading_zero_bits(msg: torch.Tensor) -> torch.Tensor:
    """Leading-zero-bit counts [B] int32 of sha256 over each row of the
    packed messages `msg` [B, 52] uint8 (contiguous, 4-byte aligned):
    kernel C on a CUDA tensor, the plain version on a CPU tensor."""
    if msg.dtype != torch.uint8:
        raise TypeError(f"msg must be uint8, got {msg.dtype}")
    if msg.dim() != 2 or msg.shape[1] != POW_MESSAGE_BYTES:
        raise ValueError(f"msg must be [B, {POW_MESSAGE_BYTES}], got {tuple(msg.shape)}")
    if not msg.is_contiguous():
        raise ValueError("msg must be contiguous")
    if msg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {msg.device}")
    if msg.data_ptr() % 4:
        # the kernel reads each row as 13 aligned 32-bit words
        raise ValueError("msg must start on a 4-byte boundary")
    if msg.device.type == "cpu":
        return leading_zero_bits_plain(msg)
    B = msg.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=msg.device)
    if B == 0:
        return out
    KERNEL.count_launch()
    KERNEL.call("pow_verify_launch", msg.data_ptr(), out.data_ptr(), B,
                msg.device.index, raw_stream(msg.device))
    return out


# PyTorch maps a priority past the card's range to its highest
_HIGHEST_PRIORITY = -(1 << 16)


class PowDispatcher:
    """Kernel C's zero-copy dispatch for one card (a verifier owns one).

    Holds `batch_max` pinned payload slots ([batch_max, 52] uint8) and
    counts ([batch_max] int32), which the card reads and writes at the
    same pointers (checked when it is built), and a high-priority stream
    of its own. `bits` writes the batch into the slots, makes one C call
    that launches the kernel and waits for this stream alone (ctypes lets
    go of the interpreter lock meanwhile), and reads the counts: no
    PyTorch op, allocation or pageable copy a dispatch. Not thread-safe:
    one caller at a time (the verifier's leader)."""

    def __init__(self, batch_max: int, device: DeviceLike) -> None:
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"PowDispatcher runs kernel C on a CUDA device, not {dev}")
        self.device = dev
        self.batch_max = int(batch_max)
        self._msg = torch.empty((self.batch_max, POW_MESSAGE_BYTES), dtype=torch.uint8,
                                pin_memory=True)
        self._out = torch.empty(self.batch_max, dtype=torch.int32, pin_memory=True)
        self._slots = memoryview(self._msg.numpy()).cast("B")
        self._counts = self._out.numpy()
        self._msg_ptr, self._out_ptr = self._msg.data_ptr(), self._out.data_ptr()
        self._stream = torch.cuda.Stream(dev, priority=_HIGHEST_PRIORITY)
        self._raw_stream = self._stream.cuda_stream
        self._launch = KERNEL.lib().pow_verify_dispatch
        for name, ptr in (("payload slots", self._msg_ptr), ("counts", self._out_ptr)):
            err = KERNEL.lib().pow_verify_check_mapped(ptr, dev.index)
            if err != 0:
                raise RuntimeError(
                    f"pinned {name} are not mapped into {dev} at the same pointer "
                    f"(CUDA error {err})"
                )

    def fill(self, payloads: Sequence[bytes]) -> int:
        """Write the batch into the payload slots; returns its size."""
        B = len(payloads)
        if B > self.batch_max:
            raise ValueError(f"{B} payloads exceed the dispatcher's {self.batch_max} slots")
        check_payloads(payloads)
        self._slots[: B * POW_MESSAGE_BYTES] = b"".join(payloads)
        return B

    def launch(self, B: int) -> None:
        """Kernel C over the first B slots into the counts; returns when
        they are written (raises on a CUDA error)."""
        KERNEL.count_launch()
        err = self._launch(self._msg_ptr, self._out_ptr, B, self.device.index, self._raw_stream)
        if err != 0:
            raise RuntimeError(f"pow_verify.pow_verify_dispatch failed: CUDA error {err}")

    def read(self, B: int) -> List[int]:
        return self._counts[:B].tolist()

    def bits(self, payloads: Sequence[bytes]) -> List[int]:
        """Leading-zero-bit counts of up to batch_max 52-byte payloads."""
        B = self.fill(payloads)
        if B == 0:
            return []
        self.launch(B)
        return self.read(B)


def pow_selftest(device, dispatcher: Optional[PowDispatcher] = None) -> None:
    """Hold `leading_zero_bits` on `device`, and `dispatcher` when given,
    against hashlib on the JAX `pow_selftest` stimulus (24 random
    payloads, all zeros, 51 zeros then 0x01); raises RuntimeError on any
    mismatch."""
    rng = np.random.default_rng(0x51A)
    payloads = [rng.integers(0, 256, POW_MESSAGE_BYTES, np.uint8).tobytes() for _ in range(24)]
    payloads += [b"\x00" * POW_MESSAGE_BYTES, b"\x00" * 51 + b"\x01"]
    routes = [("kernel", leading_zero_bits(pack_payloads(payloads, device)).tolist())]
    if dispatcher is not None:
        n = dispatcher.batch_max
        routes.append(("dispatcher", [b for i in range(0, len(payloads), n)
                                      for b in dispatcher.bits(payloads[i : i + n])]))
    for route, got in routes:
        for payload, bits in zip(payloads, got):
            want = count_zero_bits_from_left(hashlib.sha256(payload).digest())
            if bits != want:
                raise RuntimeError(
                    f"pow_verify selftest mismatch on {torch.device(device)} ({route}): "
                    f"payload {payload[:8].hex()}… kernel={bits} hashlib={want}"
                )
