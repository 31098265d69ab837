"""Banner: the ban effector both paths stream into.

Reference behavior (Go banjax): internal/iptables.go:117-331. A copy of
`banjax_tpu/effectors/banner.py`: `ban_or_challenge_ip` inserts an
expiring decision into the dynamic lists (which is how a regex ban or
challenge from the log path reaches `/auth_request`) and escalates
IptablesBlock to an ipset add (skipping localhost, standalone testing
and, on the subprocess path, already-banned IPs); the two ban logs
write the same bytes as the JAX package's (field order of the
reference's LogJson struct, compact JSON, local-time
"%Y-%m-%dT%H:%M:%S", the `_temp` file for hosts in `disable_logging`).
With a netlink writer (`effectors/ipset_netlink.py`) adds ride its
coalesced queue; the admin reads (test, list, del) keep the subprocess
shim. With no ipset instance (standalone testing) an add and a delete do
nothing, a test is False and the list is empty.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import List, Optional, TextIO, Tuple

from banjax_tpu_torch.config import Config
from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
from banjax_tpu_torch.decisions.model import Decision
from banjax_tpu_torch.effectors.ipset import IpsetInstance

log = logging.getLogger(__name__)


def _log_json(
    path: str, timestring: str, trigger: str, client_ua: str, client_ip: str,
    rule_type: str, http_method: str, http_schema: str, http_host: str,
    action: str, number_of_fails: int, disable_logging: int,
) -> str:
    return json.dumps(
        {
            "path": path,
            "timestring": timestring,
            "trigger": trigger,
            "client_ua": client_ua,
            "client_ip": client_ip,
            "rule_type": rule_type,
            "client_request_method": http_method,
            "http_request_scheme": http_schema,
            "client_request_host": http_host,
            "action": action,
            "number_of_fails": number_of_fails,
            "disable_logging": disable_logging,
        },
        separators=(",", ":"),
    )


def _format_ban_time(unix_seconds: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(unix_seconds))


class BannerInterface:
    def ban_or_challenge_ip(self, config: Config, ip: str, decision: Decision, domain: str) -> None:
        raise NotImplementedError

    def log_regex_ban(
        self, config: Config, log_time_unix: float, ip: str, rule_name: str,
        log_line_rest: str, decision: Decision,
    ) -> None:
        raise NotImplementedError

    def log_failed_challenge_ban(
        self, config: Config, ip: str, challenge_type: str, host: str, path: str,
        too_many_failed_challenges_threshold: int, user_agent: str,
        decision: Decision, method: str,
    ) -> None:
        raise NotImplementedError

    def ipset_add(self, config: Config, ip: str) -> None:
        raise NotImplementedError

    def ipset_test(self, config: Config, ip: str) -> bool:
        raise NotImplementedError

    def ipset_list(self) -> List[str]:
        raise NotImplementedError

    def ipset_del(self, ip: str) -> None:
        raise NotImplementedError


class Banner(BannerInterface):
    def __init__(
        self,
        decision_lists: DynamicDecisionLists,
        ban_log_file: TextIO,
        ban_log_file_temp: TextIO,
        ipset_instance: Optional[IpsetInstance] = None,
        netlink_writer=None,
    ):
        self.decision_lists = decision_lists
        self._ban_log = ban_log_file
        self._ban_log_temp = ban_log_file_temp
        self._ipset = ipset_instance
        # the batched kernel-edge writer: adds ride its coalesced netlink
        # queue; the admin reads (test/list/del) keep the subprocess shim
        self.netlink_writer = netlink_writer
        self._log_lock = threading.Lock()
        # (ip, decision, domain) per ban_or_challenge_ip call, in order
        self.bans: List[Tuple[str, Decision, str]] = []

    def ban_or_challenge_ip(self, config: Config, ip: str, decision: Decision, domain: str) -> None:
        """iptables.go:273-294."""
        self.bans.append((ip, decision, domain))
        expires = time.time() + config.expiring_decision_ttl_seconds
        self.decision_lists.update(ip, expires, decision, False, domain)
        if decision == Decision.IPTABLES_BLOCK:
            _ban_ip(config, ip, self)

    @property
    def ipset_batching(self) -> bool:
        return self.netlink_writer is not None and self._ipset is not None

    def log_regex_ban(
        self, config: Config, log_time_unix: float, ip: str, rule_name: str,
        log_line_rest: str, decision: Decision,
    ) -> None:
        # words: [method, host, method, path, proto, ua(+ optional | status)]
        words = log_line_rest.split(" ", 5)
        if len(words) < 6:
            return
        disable_logging = 1 if config.disable_logging.get(words[1]) else 0
        client_ua = words[5].split("|", 1)[0].strip()
        line = _log_json(
            path=words[3],
            timestring=_format_ban_time(log_time_unix),
            trigger=rule_name,
            client_ua=client_ua,
            client_ip=ip,
            rule_type="regex",
            http_method=words[0],
            http_schema="https",
            http_host=words[1],
            action=str(decision),
            number_of_fails=1,
            disable_logging=disable_logging,
        )
        self._write(line, disable_logging)

    def log_failed_challenge_ban(
        self, config: Config, ip: str, challenge_type: str, host: str, path: str,
        too_many_failed_challenges_threshold: int, user_agent: str,
        decision: Decision, method: str,
    ) -> None:
        """iptables.go:230-271."""
        disable_logging = 1 if config.disable_logging.get(host) else 0
        line = _log_json(
            path=path,
            timestring=_format_ban_time(time.time()),
            trigger=f"failed challenge {challenge_type}",
            client_ua=user_agent,
            client_ip=ip,
            rule_type="failed_challenge",
            http_method=method,
            http_schema="https",
            http_host=host,
            action=str(decision),
            number_of_fails=too_many_failed_challenges_threshold,
            disable_logging=disable_logging,
        )
        self._write(line, disable_logging)

    def _write(self, line: str, disable_logging: int) -> None:
        target = self._ban_log_temp if disable_logging == 1 else self._ban_log
        with self._log_lock:
            target.write(line + "\n")
            target.flush()

    def ipset_add(self, config: Config, ip: str) -> None:
        if self._ipset is None:
            return
        if self.netlink_writer is not None:
            # never blocks, never raises: overflow sheds (counted) and a
            # netlink failure falls back to the subprocess shim inside the
            # writer's drain thread
            self.netlink_writer.enqueue(ip, config.iptables_ban_seconds)
            return
        self._ipset.add(ip, config.iptables_ban_seconds)

    def ipset_test(self, config: Config, ip: str) -> bool:
        # iptables.go:300-303: an error reads as "not banned"
        if self._ipset is None:
            return False
        try:
            return self._ipset.test(ip)
        except Exception:  # noqa: BLE001 — the reference ignores the error
            return False

    def ipset_list(self) -> List[str]:
        if self._ipset is None:
            return []
        return self._ipset.list_entries()

    def ipset_del(self, ip: str) -> None:
        if self._ipset is not None:
            self._ipset.delete(ip)


def _ban_ip(config: Config, ip: str, banner: BannerInterface) -> None:
    """iptables.go:313-331: skip localhost, skip in testing, no double ban."""
    log.info("ban_ip: %s timeout %s", ip, config.iptables_ban_seconds)
    if ip == "127.0.0.1":
        log.info("ban_ip: not going to block localhost")
        return
    if config.standalone_testing:
        log.info("ban_ip: not calling ipset in testing")
        return
    if getattr(banner, "ipset_batching", False):
        # the batched writer's adds are idempotent (`-exist` on both the
        # netlink and the subprocess path): no test before the add
        banner.ipset_add(config, ip)
        return
    if banner.ipset_test(config, ip):
        log.info("ban_ip: no double ban %s", ip)
        return
    try:
        banner.ipset_add(config, ip)
    except Exception as e:  # noqa: BLE001 — the reference logs and continues (iptables.go:328-330)
        log.error("ban_ip ipset add failed: %s", e)
