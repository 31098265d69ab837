"""Adversarial traffic-scenario harness (a port of `banjax_tpu/scenarios/`).

Every bench before this package replayed one uniform tailer-shaped feed;
the reference's real workload is hostile — rotating-proxy botnets, slow
drips under many user agents, Baskerville command floods, challenge
storms, log rotation mid-burst.  This package turns those shapes into
deterministic, oracle-checked evidence:

  * shapes.py   — named attack-shape generators.  Same seed → byte-
                  identical line stream + identical ground-truth oracle.
  * oracle.py   — an independent reference-semantics simulator (fixed
                  windows with the Go quirks) producing the expected
                  (ip, rule) ban multiset for any line stream.
  * runtime.py  — ScenarioRunner: feeds a scenario through the real
                  engine (TorchMatcher + PipelineScheduler, device windows
                  on, on the card unless asked for the CPU), measures lines/s, shed ratio, ban precision/recall
                  vs the oracle and SLO burn peaks, and asserts the
                  structural invariants (admitted == processed + shed,
                  zero leaked fused turns/pins, benign ⇒ no SLO breach);
                  its Kafka mode drains commands from
                  `ingest/broker_standin.KafkaBrokerStandIn`.
  * chaos.py    — seeded chaos schedules arming resilience/failpoints.py
                  points mid-stream, one flight-recorder bundle per
                  injected episode.
  * stats.py    — last-run summary the /metrics exposition renders as
                  the banjax_scenario_* families.

Entry points: `chip_smoke.py`'s `scenarios` phase runs every shape on
the card; `tests/test_torch_scenarios.py` holds the generators, the
oracle, the schedules and the runner against the JAX package on the CPU.
"""

from banjax_tpu_torch.scenarios.chaos import ChaosSchedule  # noqa: F401
from banjax_tpu_torch.scenarios.oracle import expected_bans  # noqa: F401
from banjax_tpu_torch.scenarios.runtime import ScenarioRunner  # noqa: F401
from banjax_tpu_torch.scenarios.shapes import (  # noqa: F401
    SHAPES,
    CommandBatch,
    LineChunk,
    Rotation,
    Scenario,
    generate,
)
