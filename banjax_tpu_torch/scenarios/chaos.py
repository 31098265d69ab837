"""Seeded chaos schedules: failpoint episodes over a scenario stream.

(A copy of `banjax_tpu/scenarios/chaos.py`.)

A ChaosSchedule deterministically places N fault episodes across a
scenario's event stream.  Each episode arms ONE failpoint
(resilience/failpoints.py) just before a chosen event index and settles
it when the next episode starts (or at finish()): the runner records how
often it actually fired and captures one flight-recorder bundle per
episode — the per-episode evidence a soak needs.  Organic
captures (breaker trips, shed bursts, SLO breaches) still fire on top;
the explicit per-episode capture guarantees the evidence floor even for
faults the engine absorbs without tripping anything.

The default point set is every failpoint on the pipeline's driven path;
tailer-fed runs add `tailer.open` (rotation reopen faults).  Kafka-fed
runs (ScenarioRunner's `kafka_broker` mode: commands produced into an
in-process broker stand-in, `ingest/broker_standin.py`, and drained by
a REAL KafkaReader/KafkaWriter pair over the wire protocol) add `kafka.read`/`kafka.send`, so the
reconnect-with-backoff and held-report-retry loops take faults during
soak, not only in the Kafka fault tests.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence

from banjax_tpu_torch.obs import flightrec
from banjax_tpu_torch.resilience import failpoints

# failpoints that fire on the ScenarioRunner's driven path
PIPELINE_POINTS = (
    "pipeline.encode",
    "pipeline.submit",
    "pipeline.collect",
    "pipeline.drain",
    "matcher.device",
    "matcher.resolve",
)
TAILER_POINTS = PIPELINE_POINTS + ("tailer.open",)
KAFKA_POINTS = PIPELINE_POINTS + ("kafka.read", "kafka.send")
# membership-layer failpoints: these fire inside fabric worker
# processes (armed over the wire via T_FAILPOINT), not on the
# single-process runner path
GOSSIP_POINTS = (
    "fabric.gossip.ping",
    "fabric.gossip.ack",
    "fabric.membership.update",
)


@dataclasses.dataclass
class Episode:
    point: str
    count: int               # bounded injections per episode
    probability: float
    at_event: int            # armed just before this event index
    fired: int = 0           # observed after settlement
    bundle: Optional[str] = None  # flight-recorder bundle name


class ChaosSchedule:
    def __init__(self, seed: int, n_events: int,
                 points: Sequence[str] = PIPELINE_POINTS,
                 episodes: int = 4):
        rng = random.Random(seed)
        episodes = max(1, min(episodes, max(1, n_events - 1)))
        # distinct, sorted injection sites strictly inside the stream
        sites = sorted(rng.sample(range(1, max(2, n_events)), episodes))
        order = list(points)
        rng.shuffle(order)
        self.episodes: List[Episode] = [
            Episode(
                point=order[i % len(order)],
                count=rng.randint(1, 3),
                probability=1.0 if rng.random() < 0.7 else 0.5,
                at_event=site,
            )
            for i, site in enumerate(sites)
        ]
        self._active: Optional[Episode] = None
        self._next = 0
        self._quiesce = None

    # ---- runner hooks ----

    def bind(self, quiesce) -> None:
        """Install the runner's quiesce callable (pipeline flush): before
        an episode settles, every batch admitted while it was armed is
        driven through the armed stage, so `fired` reflects the episode
        instead of racing the stage threads."""
        self._quiesce = quiesce

    def before_event(self, index: int) -> None:
        """Called by the runner before dispatching event `index`."""
        while (
            self._next < len(self.episodes)
            and self.episodes[self._next].at_event <= index
        ):
            ep = self.episodes[self._next]
            self._settle_active()
            failpoints.arm(
                ep.point, mode="error", count=ep.count,
                probability=ep.probability, seed=ep.at_event,
            )
            self._active = ep
            self._next += 1

    def finish(self) -> None:
        """Settle the last episode; leaves no failpoint armed."""
        self._settle_active()

    def _settle_active(self) -> None:
        ep = self._active
        if ep is None:
            return
        if self._quiesce is not None:
            self._quiesce()
        ep.fired = failpoints.fired_count(ep.point)
        failpoints.disarm(ep.point)
        # the per-episode evidence bundle: captured AFTER the episode so
        # the trace ring / metrics / provenance show its effect.  The
        # runner installs a debounce-free recorder, so this never returns
        # None while one is installed.
        ep.bundle = flightrec.notify(
            f"chaos-{ep.point}",
            f"episode at event {ep.at_event}: count={ep.count} "
            f"p={ep.probability} fired={ep.fired}",
        )
        self._active = None

    # ---- report ----

    def rows(self) -> List[dict]:
        return [dataclasses.asdict(ep) for ep in self.episodes]


@dataclasses.dataclass
class ChurnOp:
    op: str            # kill | join | slow_node | leave
    at_frac: float     # flood position (kill) / phase ordering hint
    detail: dict
    outcome: Optional[dict] = None  # filled by the executing harness


class MembershipChurnSchedule:
    """Seeded plan for one membership-churn episode over a fabric run.

    The dryrun_fabric churn mode (fabric/harness.py, churn=True) is the
    executor: a SIGKILL with the feed paused (detection must be gossip's
    alone), an automatic join (T_JOIN announce + snapshot sync, no
    restarts), a slow-node suspect/refute cycle (sleep failpoint on
    `fabric.gossip.ack`, armed over the wire), and a planned leave
    (drain + LEFT handback, zero shed / zero replay).  The schedule
    contributes the seeded knobs — where in the flood the kill lands
    and how deaf the slow node plays — so two runs with the same seed
    churn identically, the same determinism contract ChaosSchedule
    gives the single-process soak.
    """

    def __init__(self, seed: int,
                 kill_frac_bounds: tuple = (0.3, 0.6),
                 slow_delay_intervals: tuple = (2.5, 4.0)):
        rng = random.Random(seed)
        self.seed = seed
        self.kill_frac = round(rng.uniform(*kill_frac_bounds), 3)
        # the slow node answers probes after this many gossip intervals
        # (> 1 guarantees every direct probe against it times out)
        self.slow_delay_x = round(rng.uniform(*slow_delay_intervals), 2)
        self.ops: List[ChurnOp] = [
            ChurnOp("kill", self.kill_frac, {"feed_paused": True}),
            ChurnOp("join", 1.0, {"via": "gossip announce"}),
            ChurnOp("slow_node", 1.0,
                    {"point": "fabric.gossip.ack",
                     "delay_intervals": self.slow_delay_x}),
            ChurnOp("leave", 1.0, {"graceful": True}),
        ]

    def record(self, op: str, outcome: dict) -> None:
        for entry in self.ops:
            if entry.op == op:
                entry.outcome = outcome
                return

    def rows(self) -> List[dict]:
        return [dataclasses.asdict(entry) for entry in self.ops]
