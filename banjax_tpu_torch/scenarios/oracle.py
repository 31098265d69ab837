"""Ground-truth ban oracle: an independent reference-semantics simulator.

(A copy of `banjax_tpu/scenarios/oracle.py`.)

Given a scenario's line stream in admission order and the scenario's
compiled ruleset, predict the EXACT multiset of (ip, rule) ban events
the reference engine must emit.  This is deliberately a second,
self-contained implementation of the fixed-window semantics
(rate_limit.go quirks included) rather than a call into
banjax_tpu_torch/decisions/rate_limit.py — the oracle judging the engine must
not share the engine's code.

Quirks reproduced exactly (the contract the differential suites pin):

  * timestamps parse as int(float(text) * 1e9) — Go's float64-multiply
    truncation;
  * the window restarts (hits := 1) when ts - start > interval_ns,
    STRICTLY greater;
  * exceeded when hits > hits_per_interval, STRICTLY greater, and the
    hit count then resets to 0 (not 1 — rate_limit.go:71);
  * per-site rules first, then global rules, regex unanchored-searched
    over `rest` (everything after "<ts> <ip> ").

Scenario shapes keep every timestamp within the 10 s staleness cutoff
of the runner's pinned clock, so staleness never enters the oracle; a
guard assert catches a shape that violates that contract.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

from banjax_tpu_torch.scenarios.shapes import RUN_NOW, Scenario

OLD_LINE_CUTOFF_SECONDS = 10.0  # regex_rate_limiter.go:164


def expected_bans(scenario: Scenario, config) -> List[Tuple[str, str]]:
    """(ip, rule_name) ban events, in stream order, for the scenario's
    line stream under `config`'s compiled rules."""
    # (ip, rule) -> [num_hits, interval_start_ns]
    windows: Dict[Tuple[str, str], List[int]] = {}
    bans: List[Tuple[str, str]] = []
    for line in scenario.lines():
        parts = line.split(" ", 2)
        if len(parts) < 3:
            continue
        ts_ns = int(float(parts[0]) * 1e9)
        ip, rest = parts[1], parts[2]
        sub = rest.split(" ", 2)
        if len(sub) < 3:
            continue
        host = sub[1]
        assert RUN_NOW - ts_ns / 1e9 <= OLD_LINE_CUTOFF_SECONDS, (
            f"scenario {scenario.name} emitted a stale line — shapes must "
            "stay inside the 10 s cutoff so the oracle is exact"
        )
        rules = list(config.per_site_regexes_with_rates.get(host, []))
        rules.extend(config.regexes_with_rates)
        for rule in rules:
            if rule.regex.search(rest) is None:
                continue
            if rule.hosts_to_skip.get(host):
                continue
            state = windows.get((ip, rule.rule))
            if state is None:
                state = [1, ts_ns]
                windows[(ip, rule.rule)] = state
            elif ts_ns - state[1] > rule.interval_ns:
                state[0] = 1
                state[1] = ts_ns
            else:
                state[0] += 1
            if state[0] > rule.hits_per_interval:
                state[0] = 0  # the reference's reset-to-0 quirk
                bans.append((ip, rule.rule))
    return bans


def precision_recall(
    engine_bans: List[Tuple[str, str]],
    oracle_bans: List[Tuple[str, str]],
) -> Tuple[float, float, int]:
    """Multiset precision/recall of the engine's (ip, rule) ban events
    against the oracle's, plus the true-positive count.  Both default to
    1.0 on an empty side so a benign scenario scores clean."""
    eng, orc = Counter(engine_bans), Counter(oracle_bans)
    tp = sum((eng & orc).values())
    precision = tp / sum(eng.values()) if eng else 1.0
    recall = tp / sum(orc.values()) if orc else 1.0
    return precision, recall, tp
