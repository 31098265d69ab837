"""Sha-inv PoW verification: wire checks on the host, the zero-bit count
batched onto the card (kernel C), the same decision on every path.

The wire-contract stages — base64 parse, length check, expiry compare,
HMAC — always run on the host (they are cheap and branchy, and every
byte is part of the reference contract). Only the leading-zero count of
`sha256(hmac || solution)` goes to the batched kernel
(`matcher/kernels/pow_verify.py`, `csrc/pow_verify.cu`).

A copy of `banjax_tpu/challenge/verifier.py`, with its failpoint sites
(`challenge.verify` raises into the server's fail-open middleware;
`challenge.device_verify` fails a dispatch as a kernel fault would) and
deliberate differences:

  * the selftest runs when the verifier is built, on its device, and a
    failed build or a mismatch RAISES: there is no verifier that quietly
    verifies on the host (the JAX verifier turns a failed selftest into
    "CPU oracle only");
  * a fault during a launch is counted (`faults`) and RAISES to every
    caller of that dispatch. There is no breaker and no wait timeout that
    would move the count to the host oracle (the JAX verifier degrades
    the caller to hashlib): a verifier on the card verifies on the card
    or fails the request;
  * a full queue makes the caller wait for room, where the JAX verifier
    sends it to the host oracle;
  * `DeviceVerifier` takes an explicit device and, as every entry point
    of the port, runs on the card unless asked for the CPU (where the
    kernel's plain version runs).

Requests funnel into a leader/follower micro-batch: whichever caller
reaches the queue first dispatches everything pending, up to
`batch_max`, in one launch and wakes the followers with their counts.
On the card a dispatch goes through the verifier's `PowDispatcher`
(pinned slots the kernel reads in place, a stream of its own, one C call
a batch); only the leader uses it, and `verify_batch` takes the leader
role before it does.
Every verification records where its count ran (stats "device" when the
verifier ran it, "cpu" for the hashlib path of a chain configured with
`challenge_device_verify: false`).
"""

from __future__ import annotations

import hashlib
import threading
from typing import TYPE_CHECKING, List, Optional, Sequence

from banjax_tpu_torch.challenge import stats as challenge_stats
from banjax_tpu_torch.crypto.challenge import (
    CookieError,
    count_zero_bits_from_left,
    parse_cookie,
    validate_expiration_and_hmac,
)
from banjax_tpu_torch.resilience import failpoints

# torch is imported by `DeviceVerifier` alone: the host check, all an HTTP
# worker runs, needs none of it
if TYPE_CHECKING:
    from banjax_tpu_torch.device import DeviceLike


def cpu_zero_bits(payload: bytes) -> int:
    """The host reference: hashlib digest + reference count."""
    return count_zero_bits_from_left(hashlib.sha256(payload).digest())


class _Slot:
    __slots__ = ("payload", "event", "bits", "error")

    def __init__(self, payload: bytes) -> None:
        self.payload = payload
        self.event = threading.Event()
        self.bits: Optional[int] = None
        self.error: Optional[BaseException] = None


class DeviceVerifier:
    """Micro-batching front end over kernel C. Thread-safe; one per
    process."""

    def __init__(self, batch_max: int = 256, device: DeviceLike = None) -> None:
        from banjax_tpu_torch.device import resolve_device
        from banjax_tpu_torch.matcher.kernels import pow_verify

        if batch_max < 1:
            raise ValueError(f"batch_max must be >= 1, got {batch_max}")
        self.device = resolve_device(device)
        self.batch_max = int(batch_max)

        self._lock = threading.Lock()
        self._room = threading.Condition(self._lock)  # the queue has room
        self._idle = threading.Condition(self._lock)  # no leader
        self._queue: List[_Slot] = []
        self._dispatching = False  # a leader holds the role (and the dispatcher)

        self.dispatches = 0
        self.lanes_verified = 0
        self.faults = 0

        # on the card: builds kernel C on first use and raises when the
        # pinned slots are not mapped into the card
        self._dispatcher = (pow_verify.PowDispatcher(self.batch_max, self.device)
                            if self.device.type == "cuda" else None)
        # raises on a failed launch or any mismatch with hashlib
        pow_verify.pow_selftest(self.device, self._dispatcher)

    def _device_bits(self, payloads: Sequence[bytes]) -> List[int]:
        # an armed `challenge.device_verify` fails the dispatch as a kernel
        # fault would: counted in `faults` and raised to every caller (the
        # JAX verifier falls back to hashlib here)
        from banjax_tpu_torch.matcher.kernels import pow_verify

        failpoints.check("challenge.device_verify")
        if self._dispatcher is not None:
            return self._dispatcher.bits(payloads)
        msg = pow_verify.pack_payloads(payloads, self.device)
        return pow_verify.leading_zero_bits(msg).tolist()

    def _dispatch(self, payloads: Sequence[bytes]) -> List[int]:
        """One launch, counted; a fault is counted and raised."""
        try:
            bits = self._device_bits(payloads)
        except BaseException:
            with self._lock:
                self.faults += 1
            raise
        with self._lock:
            self.dispatches += 1
            self.lanes_verified += len(payloads)
        challenge_stats.get_stats().note_device_batch(len(payloads))
        return bits

    def _drain_as_leader(self) -> None:
        while True:
            with self._lock:
                batch = self._queue[: self.batch_max]
                del self._queue[: len(batch)]
                if not batch:
                    # seen empty and released under one lock, so no caller
                    # queues behind a leader that has left
                    self._dispatching = False
                    self._idle.notify()
                    return
                self._room.notify_all()
            try:
                bits = self._dispatch([s.payload for s in batch])
            except BaseException as exc:  # noqa: BLE001 — every caller of the batch raises it
                for slot in batch:
                    slot.error = exc
                    slot.event.set()
                continue
            for slot, b in zip(batch, bits):
                slot.bits = int(b)
                slot.event.set()

    def submit(self, payload: bytes) -> int:
        """Zero-bit count for one hmac||solution payload, micro-batched
        with concurrent callers. Waits while the queue is at its bound;
        raises RuntimeError when the dispatch that carried it failed."""
        with self._lock:
            while len(self._queue) >= self.batch_max:
                self._room.wait()
            slot = _Slot(payload)
            self._queue.append(slot)
            leader = not self._dispatching
            self._dispatching = True
        if leader:
            self._drain_as_leader()
        slot.event.wait()
        if slot.error is not None:
            raise RuntimeError(f"kernel C dispatch failed: {slot.error!r}") from slot.error
        assert slot.bits is not None
        return slot.bits

    def verify_batch(self, payloads: Sequence[bytes]) -> List[int]:
        """Bulk path: batch_max-sized launches as the leader (after the
        current one leaves); what queued meanwhile is dispatched before the
        role is given up. A fault raises."""
        with self._lock:
            while self._dispatching:
                self._idle.wait()
            self._dispatching = True
        out: List[int] = []
        try:
            for i in range(0, len(payloads), self.batch_max):
                out.extend(self._dispatch(list(payloads[i : i + self.batch_max])))
        finally:
            self._drain_as_leader()
        return out

    def counters(self) -> dict:
        with self._lock:
            return {
                "dispatches": self.dispatches,
                "lanes_verified": self.lanes_verified,
                "faults": self.faults,
            }


def from_config(config, device: DeviceLike = None) -> Optional[DeviceVerifier]:
    """A verifier when challenge_device_verify is set, else None (the
    host reference path)."""
    if not config.challenge_device_verify:
        return None
    return DeviceVerifier(config.challenge_verify_batch_max, device)


def verify_sha_inv(
    secret_key: str,
    cookie_string: str,
    now_time_unix: float,
    client_binding: str,
    expected_zero_bits: int,
    device: Optional[DeviceVerifier] = None,
) -> None:
    """The decision chain's verification entry. Raises CookieError on any
    invalid cookie with the reference's exact message text; the device
    only ever computes the zero-bit count, so decisions are the same
    whichever path ran. A fault of the verifier's dispatch raises
    RuntimeError. An armed `challenge.verify` failpoint raises into the
    server's fail-open middleware, as in JAX."""
    failpoints.check("challenge.verify")
    stats = challenge_stats.get_stats()
    try:
        hmac_from_client, solution_bytes, expiration_bytes = parse_cookie(cookie_string)
        validate_expiration_and_hmac(
            secret_key, expiration_bytes, now_time_unix, hmac_from_client, client_binding
        )
    except CookieError:
        stats.note_verification("reject", "cpu")
        raise

    payload = hmac_from_client + solution_bytes
    if device is not None:
        actual_zero_bits, path = device.submit(payload), "device"
    else:
        actual_zero_bits, path = cpu_zero_bits(payload), "cpu"

    if actual_zero_bits < expected_zero_bits:
        stats.note_verification("reject", path)
        raise CookieError(
            f"not enough zero bits in hash: expected {expected_zero_bits}, "
            f"found {actual_zero_bits}"
        )
    stats.note_verification("accept", path)
