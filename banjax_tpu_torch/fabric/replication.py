"""Decision replication over the existing Kafka command path.

(A copy of `banjax_tpu/fabric/replication.py`.)

Every ban/challenge a shard emits is ALSO produced to the Kafka
command topic as the reference's own command shape (`block_ip` /
`challenge_ip`, ingest/kafka_io.handle_command) tagged with a
`fabric_origin` + `fabric_seq` pair.  Every shard consumes the topic,
so any shard can answer for any IP, and a takeover successor
warm-starts from decisions already in its dynamic lists.

Idempotency lives in two layers: `FabricDeduper` drops a shard's own
commands and already-seen (origin, seq) pairs before dispatch, and
DynamicDecisionLists.update() is monotonic-severity, so a duplicate
that slips past the deduper (restart, bounded seen-set eviction) is a
no-op insert — duplicate decision inserts are suppressed or
idempotent, never double-applied.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

from banjax_tpu_torch.decisions.model import Decision
from banjax_tpu_torch.fabric.stats import FabricStats


class DecisionReplicator:
    """Produces decision commands to the command topic.  The transport
    is the same duck type KafkaReader/Writer use (`send(config, topic,
    value)`), so the in-memory transport serves unit tests and the wire
    transport serves real brokers."""

    def __init__(
        self,
        origin: str,
        transport: Any,
        topic: str,
        stats: Optional[FabricStats] = None,
        config: Any = None,
        local_apply: Optional[Callable[[Dict[str, Any]], None]] = None,
    ):
        self.origin = origin
        self.transport = transport
        self.topic = topic
        self.stats = stats or FabricStats()
        self.config = config
        # the origin applies its own decision directly (its kafka echo
        # is suppressed by the deduper) — a shard's dynamic lists must
        # hold its OWN bans even when the broker is down
        self.local_apply = local_apply
        self._lock = threading.Lock()
        self._seq = 0

    def configure(self, config: Any) -> None:
        self.config = config

    def publish(self, ip: str, decision: Decision, domain: str) -> None:
        name = (
            "challenge_ip" if decision == Decision.CHALLENGE else "block_ip"
        )
        with self._lock:
            self._seq += 1
            seq = self._seq
        cmd_dict = {
            "Name": name,
            "Value": ip,
            "host": domain or "",
            "fabric_origin": self.origin,
            "fabric_seq": seq,
        }
        if self.local_apply is not None:
            self.local_apply(dict(cmd_dict))
        cmd = json.dumps(cmd_dict).encode()
        for attempt in (0, 1):
            try:
                self.transport.send(self.config, self.topic, cmd)
                self.stats.note_replicated()
                return
            except OSError:
                self.stats.note_replication_error()
                if attempt:
                    return  # counted, dropped: local decision still holds


class ReplicatingBanner:
    """Wraps any banner; decisions pass through to the inner banner and
    fan out to the fabric via the replicator."""

    def __init__(self, inner: Any, replicator: DecisionReplicator):
        self.inner = inner
        self.replicator = replicator

    def ban_or_challenge_ip(self, config, ip, decision, domain) -> None:
        self.inner.ban_or_challenge_ip(config, ip, decision, domain)
        self.replicator.publish(ip, decision, domain)

    def __getattr__(self, name: str) -> Any:
        # everything else (regex-ban logging, ipset ops) is host-local
        return getattr(self.inner, name)


class FabricDeduper:
    """Bounded (origin, seq) seen-set in front of command dispatch.

    `dispatch(raw)` is shaped for KafkaReader.dispatch_raw: fabric-
    tagged commands from this shard's own origin or already seen are
    suppressed (counted); fresh ones go to the wrapped handler.
    Untagged commands (operator curl, Baskerville) pass straight
    through."""

    def __init__(
        self,
        origin: str,
        apply_command: Callable[[Dict[str, Any]], None],
        stats: Optional[FabricStats] = None,
        max_seen: int = 65536,
    ):
        self.origin = origin
        self.apply_command = apply_command
        self.stats = stats or FabricStats()
        self.max_seen = int(max_seen)
        self._lock = threading.Lock()
        self._seen: "OrderedDict[tuple, bool]" = OrderedDict()

    def dispatch(self, raw: Any) -> None:
        try:
            cmd = json.loads(raw if isinstance(raw, str) else raw.decode())
        except (ValueError, AttributeError):
            return
        if not isinstance(cmd, dict):
            return
        origin = cmd.get("fabric_origin")
        if origin is not None:
            key = (origin, cmd.get("fabric_seq"))
            with self._lock:
                dup = origin == self.origin or key in self._seen
                if not dup:
                    self._seen[key] = True
                    while len(self._seen) > self.max_seen:
                        self._seen.popitem(last=False)
            if dup:
                self.stats.note_duplicate_suppressed()
                return
            self.apply_command(cmd)
            self.stats.note_replicated_applied()
            return
        self.apply_command(cmd)
