"""Kernel-level blocking via ipset/iptables (a copy of
`banjax_tpu/effectors/ipset.py`).

Reference behavior (Go banjax): banjax.go:29-64 and internal/iptables.go.
At start the set `banjax_ipset` (hash:ip, default timeout
`iptables_ban_seconds`) is created and an iptables INPUT rule
`-m set --match-set banjax_ipset src -j DROP` is inserted; bans are
`ipset add` entries with per-entry timeouts that the kernel expires on
its own (there is no unbanner process: `iptables_unbanner_seconds` is
read by the config and used nowhere); the admin routes test, list and
delete entries. Standalone testing skips the kernel entirely.

The operations go through the `ipset` and `iptables` binaries, found on
`PATH`, via subprocess: one call a ban at most, not one a request.
"""

from __future__ import annotations

import logging
import subprocess
from typing import List, Optional, Tuple

log = logging.getLogger(__name__)

IPSET_NAME = "banjax_ipset"


class IpsetError(RuntimeError):
    pass


def _run(args: List[str]) -> Tuple[int, str]:
    try:
        proc = subprocess.run(args, capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise IpsetError(f"{args[0]} invocation failed: {e}") from None
    return proc.returncode, (proc.stdout or "") + (proc.stderr or "")


class IpsetInstance:
    """Operations on one named ipset: the subset of gonetx/ipset the
    reference uses (Add with Timeout, Test, List, Del)."""

    def __init__(self, name: str = IPSET_NAME):
        self.name = name

    def add(self, ip: str, timeout_seconds: int) -> None:
        code, out = _run(["ipset", "add", self.name, ip, "timeout", str(timeout_seconds), "-exist"])
        if code != 0:
            raise IpsetError(f"ipset add failed: {out.strip()}")

    def test(self, ip: str) -> bool:
        code, _ = _run(["ipset", "test", self.name, ip])
        return code == 0

    def list_entries(self) -> List[str]:
        """Entries formatted like the reference's API output:
        `1.2.3.4 timeout 298`."""
        code, out = _run(["ipset", "list", self.name])
        if code != 0:
            raise IpsetError(f"ipset list failed: {out.strip()}")
        entries = []
        in_members = False
        for line in out.splitlines():
            if line.startswith("Members:"):
                in_members = True
                continue
            if in_members and line.strip():
                entries.append(line.strip())
        return entries

    def delete(self, ip: str) -> None:
        code, out = _run(["ipset", "del", self.name, ip])
        if code != 0:
            raise IpsetError(f"ipset del failed: {out.strip()}")


def init_ipset(iptables_ban_seconds: int, standalone_testing: bool) -> Optional[IpsetInstance]:
    """banjax.go init_ipset: create the set and the DROP rule. Returns
    None in standalone testing (banjax.go:30-33); raises IpsetError on any
    failure otherwise (the reference panics)."""
    if standalone_testing:
        log.info("init_ipset: not initializing ipset in testing")
        return None
    code, out = _run(["ipset", "create", IPSET_NAME, "hash:ip",
                      "timeout", str(iptables_ban_seconds), "-exist"])
    if code != 0:
        raise IpsetError(f"ipset create failed: {out.strip()}")
    # insert the DROP rule only when it is not there already
    rule = ["-m", "set", "--match-set", IPSET_NAME, "src", "-j", "DROP"]
    code, _ = _run(["iptables", "-C", "INPUT"] + rule)
    if code != 0:
        code, out = _run(["iptables", "-I", "INPUT", "1"] + rule)
        if code != 0:
            raise IpsetError(f"iptables insert failed: {out.strip()}")
    return IpsetInstance(IPSET_NAME)
