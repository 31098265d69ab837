"""The host matcher that `matcher: cpu` selects (port of `banjax_tpu/
matcher/cpu_ref.py`'s `CpuMatcher`): Python `re` and host window states,
no torch and no device.

Reference behavior: regex_rate_limiter.go:113-269 — consumeLine and
applyRegexToLog:

  * split "<epoch.frac> <ip> <rest>" (3 words minimum, else error);
  * parse the float timestamp (nanoseconds through a float64 multiply);
  * split rest into "<method> <host> <rest2>" (3 words minimum, else error);
  * drop lines older than 10 s against the wall clock;
  * skip IPs allowlisted for that host;
  * apply the host's per-site rules FIRST, then the global rules;
  * per rule: regex over `rest` (unanchored search), the hosts_to_skip
    check, the fixed-window rate limit (`RegexRateLimitStates`), and on
    exceed the ban (`ban_or_challenge_ip`), the ban-log line and the
    provenance record.

It is what the caller asks for, never a fallback: `cli.build_matcher`
builds it for `matcher: cpu` only, and a `TorchMatcher` whose breaker is
open refuses batches instead of rerunning them here.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Sequence

from banjax_tpu_torch.config import Config, RegexWithRate
from banjax_tpu_torch.decisions.rate_limit import RegexRateLimitStates
from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
from banjax_tpu_torch.effectors.banner import BannerInterface
from banjax_tpu_torch.matcher.api import ConsumeLineResult, Matcher, RuleResult
from banjax_tpu_torch.matcher.encode import parse_line
from banjax_tpu_torch.obs import provenance
from banjax_tpu_torch.obs.stats import MatcherStats

log = logging.getLogger(__name__)

OLD_LINE_CUTOFF_SECONDS = 10  # regex_rate_limiter.go:164


class CpuMatcher(Matcher):
    device_windows = None  # the states are the host's (`rate_limit_states`)

    def __init__(
        self,
        config: Config,
        banner: BannerInterface,
        decision_lists: StaticDecisionLists,
        rate_limit_states: RegexRateLimitStates,
    ):
        self.config = config
        self.banner = banner
        self.decision_lists = decision_lists
        self.rate_limit_states = rate_limit_states
        self.stats = MatcherStats()

    def consume_lines(
        self, lines: Sequence[str], now_unix: Optional[float] = None
    ) -> List[ConsumeLineResult]:
        """One line after another; a line that raises loses only itself
        (the JAX `Matcher.consume_lines`)."""
        t0 = time.perf_counter()
        results = []
        for line in lines:
            try:
                results.append(self.consume_line(line, now_unix))
            except Exception:  # noqa: BLE001 — a bad line loses itself, not the batch
                log.exception("error consuming log line")
                results.append(ConsumeLineResult(error=True))
        self.stats.record_batch(len(lines), time.perf_counter() - t0)
        return results

    def consume_line(self, line_text: str, now_unix: Optional[float] = None) -> ConsumeLineResult:
        result = ConsumeLineResult()
        now = time.time() if now_unix is None else now_unix
        p = parse_line(line_text, now, OLD_LINE_CUTOFF_SECONDS)
        if p.error:
            log.warning("could not parse log line: %r", line_text)
            result.error = True
            return result
        if p.old_line:
            result.old_line = True
            return result
        if self.decision_lists.check_is_allowed(p.host, p.ip):
            result.exempted = True
            return result

        # per-site rules for the host first (regex_rate_limiter.go:175-193),
        # then the global rules (:195-211)
        rules = self.config.per_site_regexes_with_rates.get(p.host, [])
        for rule in list(rules) + list(self.config.regexes_with_rates):
            rule_result = self._apply_regex_to_log(rule, p.rest, p.timestamp_ns, p.ip, p.host)
            if rule_result.regex_match:
                result.rule_results.append(rule_result)
        return result

    def _apply_regex_to_log(self, rule: RegexWithRate, rest: str, timestamp_ns: int,
                            ip: str, host: str) -> RuleResult:
        """applyRegexToLog (regex_rate_limiter.go:216-269)."""
        if rule.regex.search(rest) is None:  # Go Regexp.Match is unanchored
            return RuleResult(rule_name=rule.rule)
        return apply_matched_rule(self.config, self.banner, self.rate_limit_states, rule,
                                  ip, host, rest, timestamp_ns)


def apply_matched_rule(config: Config, banner: BannerInterface, states: RegexRateLimitStates,
                       rule: RegexWithRate, ip: str, host: str, rest: str,
                       timestamp_ns: int) -> RuleResult:
    """applyRegexToLog after a confirmed match (regex_rate_limiter.go:
    240-269): the hosts_to_skip check, the window step in `states`, and
    on exceed the ban, the ban-log line and the provenance record.
    `CpuMatcher` and `TorchMatcher`'s host windows both run it."""
    result = RuleResult(rule_name=rule.rule, regex_match=True)
    if rule.hosts_to_skip.get(host):
        result.skip_host = True
        return result
    seen_ip, rate_limit_result = states.apply(ip, rule, timestamp_ns)
    result.seen_ip = seen_ip
    result.rate_limit_result = rate_limit_result
    if rate_limit_result.exceeded:
        banner.ban_or_challenge_ip(config, ip, rule.decision, host)
        banner.log_regex_ban(config, timestamp_ns / 1e9, ip, rule.rule, rest, rule.decision)
        provenance.record(
            provenance.SOURCE_RATE_LIMIT, ip, rule.decision,
            rule=rule.rule, hits=rule.hits_per_interval + 1,
        )
    return result
