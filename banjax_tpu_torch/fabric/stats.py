"""Fabric counters — the cross-process half of the accounting contract.

(A copy of `banjax_tpu/fabric/stats.py`.)

`FabricStats` mirrors the pipeline's PipelineStats shape: note_* under
one lock, `peek()` returns the registry line keys.  The counters close
the fabric-wide ledger the single-process invariant cannot see:

    fed == acked + shed            (feeder/router view, per chunk)
    received + replayed == local + forwarded + shed + replay_skipped
                                   (per shard disposition ledger)

summed with every shard's `admitted == processed + shed + drain_errors`
they prove no line entered the fabric and vanished, even across a
SIGKILL + takeover.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from banjax_tpu_torch.obs.registry import FRAME_BYTES_BUCKETS, Histogram


class FabricStats:
    """Thread-safe fabric counters + takeover duration histogram."""

    def __init__(self):
        self._lock = threading.Lock()
        self.forwarded_lines = 0       # sent to a peer (journaled at submit)
        self.received_lines = 0        # arrived over the wire from a peer
        self.local_lines = 0           # owned locally, submitted in-process
        self.shed_lines = 0            # no alive owner — counted, never silent
        self.replayed_lines = 0        # journal replay after a takeover
        self.replay_skipped_lines = 0  # replayed lines a live owner already saw
        self.replicated_decisions = 0  # decisions produced to the command topic
        self.replication_errors = 0    # produce attempts that failed (retried)
        self.duplicate_suppressed = 0  # replicated commands dropped by dedupe
        self.replicated_applied = 0    # replicated commands applied locally
        self.takeovers = 0
        self.takeover_duration = Histogram()
        self.peer_up: Dict[str, bool] = {}
        self.last_takeover: Optional[Dict[str, object]] = None
        # ---- gossip membership (fabric/membership.py) ----
        self.membership_suspects = 0       # alive -> suspect transitions
        self.membership_confirmed_dead = 0  # suspicion timeouts expired
        self.membership_refuted = 0        # suspect -> alive (incarnation bump)
        self.membership_joined = 0         # new/revived members inserted
        self.membership_left = 0           # graceful departures observed
        self.gossip_bytes = 0              # probe frames + piggyback digests
        self.member_state: Dict[str, str] = {}  # peer -> alive/suspect/dead/left
        self.detection_time = Histogram()  # last liveness evidence -> confirmed dead
        # node -> health bits piggybacked on gossip (obs/fleet.py
        # HEALTH_* encoding: 1 slo_breached, 2 breaker open, 4 half-open)
        self.peer_health: Dict[str, int] = {}
        # ---- wire v2 transport (fabric/peer.py LinePipe) ----
        self.frames_sent: Dict[Tuple[str, str], int] = {}  # (version, transport)
        self.frame_bytes_total = 0
        self.frame_bytes = Histogram(FRAME_BYTES_BUCKETS)
        self.acks_received = 0
        self.ack_rtt = Histogram()                 # seconds, shared buckets
        self.inflight: Dict[str, int] = {}         # peer -> frames outstanding
        self.ring_occupancy: Dict[str, float] = {}  # peer -> fill fraction

    def note_frame_sent(
        self, version: str, transport: str, nbytes: int
    ) -> None:
        with self._lock:
            key = (version, transport)
            self.frames_sent[key] = self.frames_sent.get(key, 0) + 1
            self.frame_bytes_total += nbytes
        self.frame_bytes.observe(float(nbytes))

    def note_ack(self, rtt_s: float) -> None:
        with self._lock:
            self.acks_received += 1
        self.ack_rtt.observe(rtt_s)

    def note_inflight(self, peer_id: str, n: int) -> None:
        with self._lock:
            self.inflight[peer_id] = n

    def note_ring_occupancy(self, peer_id: str, frac: float) -> None:
        with self._lock:
            self.ring_occupancy[peer_id] = frac

    def note_replay_skipped(self, n: int) -> None:
        with self._lock:
            self.replay_skipped_lines += n

    def note_forwarded(self, n: int) -> None:
        with self._lock:
            self.forwarded_lines += n

    def note_received(self, n: int) -> None:
        with self._lock:
            self.received_lines += n

    def note_local(self, n: int) -> None:
        with self._lock:
            self.local_lines += n

    def note_shed(self, n: int) -> None:
        with self._lock:
            self.shed_lines += n

    def note_replayed(self, n: int) -> None:
        with self._lock:
            self.replayed_lines += n

    def note_replicated(self, n: int = 1) -> None:
        with self._lock:
            self.replicated_decisions += n

    def note_replication_error(self) -> None:
        with self._lock:
            self.replication_errors += 1

    def note_duplicate_suppressed(self) -> None:
        with self._lock:
            self.duplicate_suppressed += 1

    def note_replicated_applied(self) -> None:
        with self._lock:
            self.replicated_applied += 1

    def note_peer(self, peer_id: str, up: bool) -> None:
        with self._lock:
            self.peer_up[peer_id] = up

    def note_membership_event(self, event: str) -> None:
        """Count one membership transition (membership.py event names)."""
        with self._lock:
            if event == "suspect":
                self.membership_suspects += 1
            elif event == "confirmed_dead":
                self.membership_confirmed_dead += 1
            elif event == "refuted":
                self.membership_refuted += 1
            elif event == "joined":
                self.membership_joined += 1
            elif event == "left":
                self.membership_left += 1

    def note_member_state(self, peer_id: str, state: str) -> None:
        with self._lock:
            self.member_state[peer_id] = state

    def note_gossip_bytes(self, n: int) -> None:
        with self._lock:
            self.gossip_bytes += n

    def note_peer_health(self, peer_id: str, bits: int) -> None:
        with self._lock:
            self.peer_health[peer_id] = int(bits)

    def peer_health_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.peer_health)

    def note_detection(self, duration_s: float) -> None:
        """Failure-detection latency: last liveness evidence for the
        member -> its death confirmed in this node's view."""
        self.detection_time.observe(duration_s)

    def note_takeover(
        self, peer_id: str, duration_s: float, replayed_lines: int
    ) -> None:
        with self._lock:
            self.takeovers += 1
            self.last_takeover = {
                "peer": peer_id,
                "duration_s": duration_s,
                "replayed_lines": replayed_lines,
            }
        self.takeover_duration.observe(duration_s)

    def peek(self) -> Dict[str, object]:
        """Registry line keys (obs/registry.py `Fabric*` families)."""
        with self._lock:
            return {
                "FabricForwardedLines": self.forwarded_lines,
                "FabricReceivedLines": self.received_lines,
                "FabricLocalLines": self.local_lines,
                "FabricShedLines": self.shed_lines,
                "FabricReplayedLines": self.replayed_lines,
                "FabricReplaySkippedLines": self.replay_skipped_lines,
                "FabricFramesSent": sum(self.frames_sent.values()),
                "FabricFrameBytes": self.frame_bytes_total,
                "FabricAcksReceived": self.acks_received,
                "FabricInflightFrames": sum(self.inflight.values()),
                "FabricRingOccupancy": round(
                    max(self.ring_occupancy.values(), default=0.0), 4
                ),
                "FabricReplicatedDecisions": self.replicated_decisions,
                "FabricReplicationErrors": self.replication_errors,
                "FabricDuplicatesSuppressed": self.duplicate_suppressed,
                "FabricReplicatedApplied": self.replicated_applied,
                "FabricTakeovers": self.takeovers,
                "FabricMembershipSuspects": self.membership_suspects,
                "FabricMembershipConfirmedDead":
                    self.membership_confirmed_dead,
                "FabricMembershipRefuted": self.membership_refuted,
                "FabricMembershipJoined": self.membership_joined,
                "FabricMembershipLeft": self.membership_left,
                "FabricGossipBytes": self.gossip_bytes,
            }

    def peers_snapshot(self) -> Dict[str, bool]:
        with self._lock:
            return dict(self.peer_up)

    def frames_snapshot(self) -> Dict[Tuple[str, str], int]:
        with self._lock:
            return dict(self.frames_sent)

    def ring_occupancy_snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.ring_occupancy)

    def member_states_snapshot(self) -> Dict[str, str]:
        with self._lock:
            return dict(self.member_state)

    def takeover_snapshot(
        self,
    ) -> Tuple[Tuple[float, ...], list, float, int]:
        return self.takeover_duration.snapshot()

    def detection_snapshot(
        self,
    ) -> Tuple[Tuple[float, ...], list, float, int]:
        return self.detection_time.snapshot()
