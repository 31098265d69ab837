"""Keyspace-sharded multi-host decision fabric (a copy of
`banjax_tpu/fabric/`).

N banjax processes split the IP keyspace by consistent hash
(`hashring`), each running the full single-process engine for its
range.  Lines a process does not own travel to the owning shard over a
length-prefixed socket protocol (`wire`, `peer`, `node`); resulting
expiring Decisions replicate to every peer through the existing Kafka
command path (`replication`) so any shard can answer for any IP.

Failover is the point: a peer that stops answering (send timeout,
breaker trip, health probe) has its hash range taken over by its ring
successors (`router`), which re-derive the moved range's window state
from the replayed line journal plus the replicated decisions already
in their dynamic lists.  In-flight lines for the moving range are
drained or counted shed — never silently lost: the pipeline's accounting
contract (admitted == processed + shed) holds fabric-wide, summed
across processes (`stats`).

The port runs the fabric through the normal entry point: `cli.BanjaxApp`
with `fabric_enabled: true`, one process per shard, each running its own
`TorchMatcher` on the card. The JAX package's `worker` and `harness`
modules (its `dryrun_fabric` runner, built on the scenarios) are not
ported here.
"""

from banjax_tpu_torch.fabric.hashring import ConsistentHashRing
from banjax_tpu_torch.fabric.peer import PeerClient, PeerUnavailable
from banjax_tpu_torch.fabric.replication import (
    DecisionReplicator,
    FabricDeduper,
    ReplicatingBanner,
)
from banjax_tpu_torch.fabric.router import FabricRouter
from banjax_tpu_torch.fabric.stats import FabricStats
from banjax_tpu_torch.fabric.node import FabricNode
from banjax_tpu_torch.fabric import wire

__all__ = [
    "ConsistentHashRing",
    "DecisionReplicator",
    "FabricDeduper",
    "FabricNode",
    "FabricRouter",
    "FabricStats",
    "PeerClient",
    "PeerUnavailable",
    "ReplicatingBanner",
    "wire",
]
