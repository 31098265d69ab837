"""Static (config-sourced) decision lists.

Reference behavior (Go banjax): internal/decision.go:88-374. A copy of
`banjax_tpu/decisions/static_lists.py`: per-site and global IP→Decision
maps (plain IPs exact, every list also as one IP/CIDR filter per
decision, checked in the fixed order Allow → Challenge → NginxBlock →
IptablesBlock), the per-site and global User-Agent lists, and the
sitewide SHA-inv site→FailAction map. `check_is_allowed` is the log
tailer's allowlist exemption; the other checks are steps 3-6 and 8 of
the `/auth_request` decision chain.
"""

from __future__ import annotations

import ipaddress
import socket
from typing import Dict, List, Optional, Tuple

from banjax_tpu_torch.config import Config
from banjax_tpu_torch.decisions.model import (
    Decision,
    FailAction,
    parse_decision,
    parse_fail_action,
)
from banjax_tpu_torch.decisions.ua_lists import (
    UARules,
    build_per_site_ua_rules,
    build_ua_rules,
    check_ua_decision,
)

# The iteration order of per-decision CIDR filters (decision.go:127,149).
_FILTER_CHECK_ORDER = (
    Decision.ALLOW,
    Decision.CHALLENGE,
    Decision.NGINX_BLOCK,
    Decision.IPTABLES_BLOCK,
)


def _fast_parse_ip(ip_string: str) -> Optional[Tuple[int, int]]:
    """(version, address-int) via inet_pton; None for what it rejects
    (scoped IPv6 or garbage), which then takes the exact slow path."""
    try:
        return 4, int.from_bytes(socket.inet_pton(socket.AF_INET, ip_string), "big")
    except (OSError, ValueError):
        pass
    try:
        return 6, int.from_bytes(socket.inet_pton(socket.AF_INET6, ip_string), "big")
    except (OSError, ValueError):
        return None


class IPFilter:
    """Membership over a mixed list of plain IPs and CIDR blocks;
    unparseable entries are skipped."""

    __slots__ = ("_singles", "_networks", "_slow_singles", "_slow_networks")

    def __init__(self, entries: List[str]):
        self._singles = set()
        self._networks: List[Tuple[int, int, int]] = []
        self._slow_singles = set()
        self._slow_networks = []
        for entry in entries:
            entry = entry.strip()
            if not entry:
                continue
            try:
                if "/" in entry:
                    net = ipaddress.ip_network(entry, strict=False)
                    self._slow_networks.append(net)
                    self._networks.append(
                        (net.version, int(net.network_address), int(net.netmask))
                    )
                else:
                    addr = ipaddress.ip_address(entry)
                    self._slow_singles.add(addr)
                    if getattr(addr, "scope_id", None) is None:
                        self._singles.add((addr.version, int(addr)))
            except ValueError:
                continue

    def allowed(self, ip_string: str) -> bool:
        parsed = _fast_parse_ip(ip_string)
        if parsed is None:
            return self._allowed_slow(ip_string)
        if parsed in self._singles:
            return True
        version, addr = parsed
        return any(
            v == version and (addr & mask) == net for v, net, mask in self._networks
        )

    def _allowed_slow(self, ip_string: str) -> bool:
        try:
            addr = ipaddress.ip_address(ip_string)
        except ValueError:
            return False
        if addr in self._slow_singles:
            return True
        return any(addr in net for net in self._slow_networks)


class _Snapshot:
    """The lists built from one config; swapped whole on a reload."""

    def __init__(self, config: Config):
        self.global_decision_lists: Dict[str, Decision] = {}
        self.per_site_decision_lists: Dict[str, Dict[str, Decision]] = {}
        self.global_ip_filters: Dict[Decision, IPFilter] = {}
        self.per_site_ip_filters: Dict[str, Dict[Decision, IPFilter]] = {}
        for decision_string, ips in config.global_decision_lists.items():
            decision = parse_decision(decision_string)
            for ip in ips or []:
                if "/" not in ip:
                    self.global_decision_lists[ip] = decision
            self.global_ip_filters[decision] = IPFilter(list(ips or []))
        for site, decision_to_ips in config.per_site_decision_lists.items():
            for decision_string, ips in decision_to_ips.items():
                decision = parse_decision(decision_string)
                for ip in ips or []:
                    self.per_site_decision_lists.setdefault(site, {})
                    self.per_site_ip_filters.setdefault(site, {})
                    if "/" not in ip:
                        self.per_site_decision_lists[site][ip] = decision
                if ips:
                    self.per_site_ip_filters.setdefault(site, {})[decision] = (
                        IPFilter(list(ips))
                    )
        self.sitewide_sha_inv_list: Dict[str, FailAction] = {
            site: parse_fail_action(fa) for site, fa in config.sitewide_sha_inv_list.items()
        }
        self.global_ua_rules: UARules = build_ua_rules(config.global_user_agent_decision_lists)
        self.per_site_ua_rules: Dict[str, UARules] = build_per_site_ua_rules(
            config.per_site_user_agent_decision_lists
        )


class StaticDecisionLists:
    """Config-sourced decision maps (decision.go:278-374). A reload builds
    a new snapshot and swaps it in whole, so a reader never sees a part of
    one; `generation` moves on each swap (the matcher's allowlist cache
    keys on it)."""

    def __init__(self, config: Config):
        self._s = _Snapshot(config)
        self.generation = 0

    def update_from_config(self, config: Config) -> None:
        self._s = _Snapshot(config)
        self.generation += 1

    def check_per_site(self, site: str, client_ip: str) -> Tuple[Optional[Decision], bool]:
        """decision.go:115-139 — exact map first, then per-decision filters in order."""
        c = self._s
        site_map = c.per_site_decision_lists.get(site)
        if site_map is not None and client_ip in site_map:
            return site_map[client_ip], True
        site_filters = c.per_site_ip_filters.get(site)
        if site_filters:
            for decision in _FILTER_CHECK_ORDER:
                f = site_filters.get(decision)
                if f is not None and f.allowed(client_ip):
                    return decision, True
        return None, False

    def check_global(self, client_ip: str) -> Tuple[Optional[Decision], bool]:
        """decision.go:141-162."""
        c = self._s
        if client_ip in c.global_decision_lists:
            return c.global_decision_lists[client_ip], True
        for decision in _FILTER_CHECK_ORDER:
            f = c.global_ip_filters.get(decision)
            if f is not None and f.allowed(client_ip):
                return decision, True
        return None, False

    def check_per_site_user_agent(self, site: str, user_agent: str) -> Tuple[Optional[Decision], bool]:
        """decision.go:164-171."""
        c = self._s
        rules = c.per_site_ua_rules.get(site)
        if rules is None:
            return None, False
        return check_ua_decision(rules, user_agent)

    def check_global_user_agent(self, user_agent: str) -> Tuple[Optional[Decision], bool]:
        """decision.go:173-176."""
        c = self._s
        return check_ua_decision(c.global_ua_rules, user_agent)

    def check_sitewide_sha_inv(self, site: str) -> Tuple[Optional[FailAction], bool]:
        """decision.go:178-183."""
        c = self._s
        fa = c.sitewide_sha_inv_list.get(site)
        return fa, fa is not None

    def has_any_allow_entries(self) -> bool:
        """False when no allow entry exists anywhere (exact or CIDR, global
        or per site): check_is_allowed is then False for every input."""
        c = self._s
        if Decision.ALLOW in c.global_decision_lists.values():
            return True
        if Decision.ALLOW in c.global_ip_filters:
            return True
        if any(Decision.ALLOW in m.values() for m in c.per_site_decision_lists.values()):
            return True
        return any(Decision.ALLOW in f for f in c.per_site_ip_filters.values())

    def check_is_allowed(self, site: str, client_ip: str) -> bool:
        c = self._s
        site_map = c.per_site_decision_lists.get(site)
        if site_map is not None and site_map.get(client_ip) == Decision.ALLOW:
            return True
        site_filters = c.per_site_ip_filters.get(site)
        if site_filters:
            f = site_filters.get(Decision.ALLOW)
            if f is not None and f.allowed(client_ip):
                return True
        if c.global_decision_lists.get(client_ip) == Decision.ALLOW:
            return True
        f = c.global_ip_filters.get(Decision.ALLOW)
        return f is not None and f.allowed(client_ip)

    def format_lists(self) -> Tuple[Dict[str, Dict[str, Decision]], Dict[str, Decision]]:
        """(per-site, global) exact IP maps, for /decision_lists."""
        c = self._s
        return c.per_site_decision_lists, c.global_decision_lists
