"""Named failpoints: deterministic fault injection (a copy of
`banjax_tpu/resilience/failpoints.py`, with the port's own module state).

Instrumented sites call `check("site.name")`; when the failpoint is
disarmed (production) that is one module-flag test — effectively free on
the hot path.  Armed failpoints raise `FaultInjected` (an OSError
subclass, so sites that tolerate I/O errors — the tailer's retry loop —
treat an injected fault exactly like a real one) a bounded or unbounded
number of times.

Arming:
  * programmatic (tests):  failpoints.arm("matcher.device", count=3)
  * env / config:          BANJAX_FAILPOINTS="matcher.device=error:3;pipeline.submit=error"
    (the config key `failpoints` uses the same spec syntax; an optional
    "@p" suffix on an entry — "matcher.device=error:3@0.5" — fires it
    with probability p per check, from a seeded per-failpoint RNG so a
    given arming is reproducible)
  * admin surface:         GET/POST /debug/failpoints (httpapi/server.py)
    lists armed points and arms/disarms them at runtime

`KNOWN_SITES` is the JAX package's list, verbatim, so that
/debug/failpoints answers the same. The sites instrumented in the port:
  tailer.open      — LogTailer, every file open (start and rotation)
  matcher.device   — TorchMatcher, every device dispatch boundary
  matcher.resolve  — the pipelined drain's per-chunk event pull
  pipeline.encode  — pipeline scheduler, encode-stage boundary (a failing
                     batch drains generically; no loss)
  pipeline.encode_shard — one shard of the sharded encode fan-out
  pipeline.submit  — pipeline scheduler, device submit boundary (a
                     breaker failure; the batch drains generically on the
                     card)
  pipeline.collect — pipeline scheduler, device collect boundary (same)
  pipeline.drain   — pipeline scheduler, drain-stage boundary (the batch's
                     lines are counted as failed, never silently lost)
  serve.fastpath.lookup — compiled /auth_request fast path, before the
                     decision-table probe: an injected fault counts as a
                     fast-path fault and the chain serves the request
The rest (Kafka, fabric, the chain's challenge sites, ipset, fleet
observability) belong to modules the port has not taken yet; arming one
of them is accepted and never fires.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
import zlib
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

# the instrumented sites (module docstring) — served by /debug/failpoints
# so operators and the scenario harness discover what they can arm
KNOWN_SITES = (
    "kafka.read",
    "kafka.send",
    "tailer.open",
    "matcher.device",
    "matcher.resolve",
    "decision_chain",
    "pipeline.encode",
    "pipeline.encode_shard",
    "pipeline.submit",
    "pipeline.collect",
    "pipeline.drain",
    "fabric.send",
    "fabric.recv",
    "fabric.takeover",
    "fabric.frame.corrupt",
    "fabric.ring.stall",
    "fabric.gossip.ping",
    "fabric.gossip.ack",
    "fabric.membership.update",
    "challenge.issue",
    "challenge.verify",
    "challenge.device_verify",
    "serve.fastpath.lookup",
    "ipset.netlink.send",
    "obs.fleet.pull",
    "obs.fleet.capture",
)

MODES = ("error", "sleep")


class FaultInjected(OSError):
    """Raised by an armed failpoint (OSError: see module docstring)."""


class _Failpoint:
    __slots__ = ("name", "mode", "remaining", "message", "fired", "delay_s",
                 "probability", "rng")

    def __init__(self, name: str, mode: str = "error",
                 count: Optional[int] = None, message: str = "",
                 delay_s: float = 0.0, probability: float = 1.0,
                 seed: Optional[int] = None):
        self.name = name
        self.mode = mode          # "error" | "sleep"
        self.remaining = count    # None = unlimited
        self.message = message or f"failpoint {name} armed"
        self.delay_s = delay_s
        # probabilistic arming (chaos soak): each check() fires with this
        # probability, drawn from a PER-FAILPOINT seeded RNG — the default
        # seed derives from the name, so a given arming replays the same
        # fire pattern run to run
        self.probability = min(1.0, max(0.0, float(probability)))
        self.rng = random.Random(
            zlib.crc32(name.encode()) if seed is None else seed
        )
        self.fired = 0


_lock = threading.Lock()
_active: Dict[str, _Failpoint] = {}
_armed = False  # the fast gate read without the lock


def check(name: str) -> None:
    """The instrumented-site call: no-op unless `name` is armed."""
    if not _armed:
        return
    with _lock:
        fp = _active.get(name)
        if fp is None:
            return
        if fp.remaining is not None and fp.remaining <= 0:
            return
        if fp.probability < 1.0 and fp.rng.random() >= fp.probability:
            return  # probabilistic miss: count NOT consumed
        if fp.remaining is not None:
            fp.remaining -= 1
        fp.fired += 1
        mode, message, delay = fp.mode, fp.message, fp.delay_s
    if mode == "sleep":
        time.sleep(delay)
        return
    raise FaultInjected(message)


def arm(name: str, mode: str = "error", count: Optional[int] = None,
        message: str = "", delay_s: float = 0.0, probability: float = 1.0,
        seed: Optional[int] = None) -> None:
    global _armed
    with _lock:
        _active[name] = _Failpoint(name, mode, count, message, delay_s,
                                   probability, seed)
        _armed = True
    log.warning("FAILPOINT armed: %s mode=%s count=%s p=%s",
                name, mode, count, probability)


def disarm(name: Optional[str] = None) -> None:
    """Disarm one failpoint, or all of them (name=None)."""
    global _armed
    with _lock:
        if name is None:
            _active.clear()
        else:
            _active.pop(name, None)
        _armed = bool(_active)


def fired_count(name: str) -> int:
    with _lock:
        fp = _active.get(name)
        return fp.fired if fp is not None else 0


def is_armed(name: str) -> bool:
    with _lock:
        fp = _active.get(name)
        return fp is not None and (fp.remaining is None or fp.remaining > 0)


def snapshot() -> List[dict]:
    """JSON-ready view of every armed failpoint — the GET
    /debug/failpoints payload and the chaos soak's episode evidence."""
    with _lock:
        return [
            {
                "name": fp.name,
                "mode": fp.mode,
                "count": fp.remaining,   # None = unlimited
                "fired": fp.fired,
                "probability": fp.probability,
                "delay_s": fp.delay_s,
            }
            for fp in _active.values()
        ]


def arm_from_spec(spec: str) -> None:
    """Parse "name=mode[:count][@p][;name2=..]" (the BANJAX_FAILPOINTS /
    config / POST /debug/failpoints spec syntax).  A bare "name" arms an
    unlimited error failpoint; "@p" fires with probability p per check.
    Bad entries are logged and skipped — a typo in a fault spec must not
    stop a production start."""
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, _, rest = entry.partition("=")
        name = name.strip()
        mode, count, probability = "error", None, 1.0
        if rest:
            rest, _, prob_s = rest.partition("@")
            if prob_s:
                try:
                    probability = float(prob_s)
                except ValueError:
                    log.warning(
                        "FAILPOINT: bad probability in spec entry %r", entry
                    )
                    continue
            mode, _, count_s = rest.partition(":")
            mode = mode.strip() or "error"
            if count_s:
                try:
                    count = int(count_s)
                except ValueError:
                    log.warning("FAILPOINT: bad count in spec entry %r", entry)
                    continue
        if mode not in MODES:
            log.warning("FAILPOINT: unknown mode in spec entry %r", entry)
            continue
        arm(name, mode=mode, count=count, probability=probability)


def _load_env() -> None:
    spec = os.environ.get("BANJAX_FAILPOINTS", "")
    if spec:
        arm_from_spec(spec)


_load_env()
