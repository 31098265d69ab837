"""Incident flight recorder: capture the seconds before things broke (a
copy of `banjax_tpu/obs/flightrec.py`).

On an SLO breach, a breaker trip, a shed burst, a drain error or a
failure-state eviction storm (debounced by `flightrec_min_interval_s`)
it writes an incident bundle to `flightrec_dir`:

    incident-<utc>-<seq>-<reason>/
        trace.json        Chrome trace_event dump of the span ring
        metrics.prom      the full /metrics text (parseable by
                          obs/exposition.parse_text_format)
        traffic.json      the traffic sketch, pulled at the incident
        fabric.json       the fabric's peer table, ownership and last
                          takeover (when the fabric runs)
        provenance.json   the last N provenance records
        meta.json         reason, detail, timestamps, config hash,
                          health, SLO burn state
        peers/<node>/     each alive fabric peer's trace, metrics,
                          provenance and fabric files (with
                          `flightrec_fleet_capture`)

A bundle is written into a hidden `.tmp` directory and renamed into
place, so a listed incident is complete; the newest `flightrec_keep` are
kept. `GET /debug/incidents` lists and serves them, the peer files
included.

Trigger sites call the module-level `notify(reason, detail)`: one
None-check when no recorder is installed. Capture is synchronous,
debounced, and swallows every exception: a recorder bug never takes
down the path that tripped it.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from typing import Callable, List, Optional

log = logging.getLogger(__name__)

_SLUG_OK = "abcdefghijklmnopqrstuvwxyz0123456789-"


def _slug(reason: str) -> str:
    s = "".join(
        c if c in _SLUG_OK else "-" for c in (reason or "incident").lower()
    )
    return s.strip("-")[:48] or "incident"


class FlightRecorder:
    def __init__(
        self,
        directory: str,
        min_interval_s: float = 60.0,
        keep: int = 16,
        provenance_tail: int = 256,
        metrics_text_fn: Optional[Callable[[], str]] = None,
        config_hash_fn: Optional[Callable[[], str]] = None,
        health=None,
        slo_getter: Optional[Callable[[], object]] = None,
        traffic_fn: Optional[Callable[[], Optional[dict]]] = None,
        fabric_fn: Optional[Callable[[], Optional[dict]]] = None,
        fleet_capture_fn: Optional[Callable[[str], "dict[str, dict[str, str]]"]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.directory = directory
        self.min_interval_s = max(0.0, float(min_interval_s))
        self.keep = max(1, int(keep))
        self.provenance_tail = max(1, int(provenance_tail))
        self._metrics_text_fn = metrics_text_fn
        self._config_hash_fn = config_hash_fn
        self._health = health
        self._slo_getter = slo_getter
        self._traffic_fn = traffic_fn
        self._fabric_fn = fabric_fn
        self._fleet_capture_fn = fleet_capture_fn
        self._clock = clock
        self._lock = threading.Lock()
        self._last_capture = float("-inf")
        self._seq = 0
        self.incident_count = 0
        os.makedirs(directory, exist_ok=True)

    # ---- capture ----

    def notify(self, reason: str, detail: str = "") -> Optional[str]:
        """Debounced capture trigger; returns the bundle name when one
        was captured, None when debounced or on failure."""
        with self._lock:
            now = self._clock()
            if now - self._last_capture < self.min_interval_s:
                return None
            self._last_capture = now
            self._seq += 1
            seq = self._seq
        try:
            return self._capture(reason, detail, seq)
        except Exception:  # noqa: BLE001 — a recorder bug must never propagate
            log.exception("flight recorder capture failed (reason=%s)", reason)
            return None

    def _capture(self, reason: str, detail: str, seq: int) -> str:
        from banjax_tpu_torch.obs import provenance, trace

        stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        name = f"incident-{stamp}-{seq:03d}-{_slug(reason)}"
        tmp = os.path.join(self.directory, f".{name}.tmp")
        final = os.path.join(self.directory, name)
        os.makedirs(tmp, exist_ok=True)

        files = {}
        files["trace.json"] = json.dumps(
            trace.get_tracer().export_chrome(), separators=(",", ":")
        )
        if self._metrics_text_fn is not None:
            try:
                files["metrics.prom"] = self._metrics_text_fn()
            except Exception as e:  # noqa: BLE001 — partial bundle beats none
                files["metrics.prom"] = f"# capture failed: {e}\n"
        # traffic snapshot (obs/sketch.py): what the flood looked like —
        # heavy hitters, distinct-source estimate, per-rule pressure —
        # as of THIS incident (a forced pull, not the last sampling tick)
        traffic: Optional[dict] = None
        if self._traffic_fn is not None:
            try:
                traffic = self._traffic_fn()
            except Exception as e:  # noqa: BLE001 — partial bundle beats none
                traffic = {"enabled": False, "error": str(e)}
        files["traffic.json"] = json.dumps(
            traffic if traffic is not None else {"enabled": False},
            indent=1,
        )
        # the fabric's snapshot: a shard-failure capture describes itself
        # without asking the survivors
        if self._fabric_fn is not None:
            fabric: Optional[dict] = None
            try:
                fabric = self._fabric_fn()
            except Exception as e:  # noqa: BLE001 — partial bundle beats none
                fabric = {"enabled": False, "error": str(e)}
            files["fabric.json"] = json.dumps(
                fabric if fabric is not None else {"enabled": False},
                indent=1, default=str,
            )
        files["provenance.json"] = json.dumps(
            {
                "records": provenance.get_ledger().tail(self.provenance_tail),
                "counters": {
                    f"{src}/{dec}": v
                    for (src, dec), v in sorted(
                        provenance.get_ledger().counters().items()
                    )
                },
            },
            indent=1,
        )
        # the cluster capture (obs/fleet.py capture_fleet): every alive
        # peer's snapshot under peers/<node_id>/, fanned out before
        # meta.json so the manifest lists it; a peer that cannot answer
        # leaves an error.txt
        peer_files: dict = {}
        if self._fleet_capture_fn is not None:
            try:
                raw = self._fleet_capture_fn(name) or {}
            except Exception:  # noqa: BLE001 — fleet capture must not sink the bundle
                raw = {}
            for nid, pf in raw.items():
                nid_s = os.path.basename(str(nid))
                if not nid_s or nid_s.startswith("."):
                    continue
                clean = {}
                for fname, content in (pf or {}).items():
                    fname_s = os.path.basename(str(fname))
                    if fname_s and not fname_s.startswith("."):
                        clean[fname_s] = str(content)
                if clean:
                    peer_files[nid_s] = clean
        slo = self._slo_getter() if self._slo_getter else None
        meta = {
            "reason": reason,
            "detail": detail,
            "captured_unix": time.time(),
            "captured_monotonic": time.monotonic(),
            "config_hash": (
                self._config_hash_fn() if self._config_hash_fn else ""
            ),
            "health": self._health.snapshot() if self._health else None,
            "slo": slo.snapshot() if slo is not None else None,
            "files": sorted(files) + ["meta.json"] + sorted(
                f"peers/{nid}/{fname}" for nid, pf in peer_files.items() for fname in pf
            ),
        }
        files["meta.json"] = json.dumps(meta, indent=1)

        for fname, content in files.items():
            with open(os.path.join(tmp, fname), "w", encoding="utf-8") as f:
                f.write(content)
        for nid, pf in peer_files.items():
            pdir = os.path.join(tmp, "peers", nid)
            os.makedirs(pdir, exist_ok=True)
            for fname, content in pf.items():
                with open(os.path.join(pdir, fname), "w", encoding="utf-8") as f:
                    f.write(content)
        os.rename(tmp, final)  # atomic publish: listed == complete
        with self._lock:
            self.incident_count += 1
        self._prune()
        log.warning("flight recorder captured incident %s (%s)", name, reason)
        return name

    def _prune(self) -> None:
        try:
            entries = sorted(
                e for e in os.listdir(self.directory)
                if e.startswith("incident-")
            )
            for stale in entries[: max(0, len(entries) - self.keep)]:
                shutil.rmtree(
                    os.path.join(self.directory, stale), ignore_errors=True
                )
            # a crash mid-capture can strand a .tmp dir; sweep old ones
            for e in os.listdir(self.directory):
                if e.startswith(".incident-") and e.endswith(".tmp"):
                    age = time.time() - os.path.getmtime(
                        os.path.join(self.directory, e)
                    )
                    if age > 3600:
                        shutil.rmtree(
                            os.path.join(self.directory, e),
                            ignore_errors=True,
                        )
        except OSError:
            pass

    # ---- queries (the /debug/incidents surface) ----

    def list_incidents(self) -> List[dict]:
        """Newest-first bundle manifests."""
        out = []
        try:
            entries = sorted(
                (e for e in os.listdir(self.directory)
                 if e.startswith("incident-")),
                reverse=True,
            )
        except OSError:
            return []
        for name in entries:
            entry = {"name": name}
            try:
                with open(
                    os.path.join(self.directory, name, "meta.json"),
                    encoding="utf-8",
                ) as f:
                    meta = json.load(f)
                entry.update({
                    "reason": meta.get("reason", ""),
                    "captured_unix": meta.get("captured_unix"),
                    "files": meta.get("files", []),
                })
            except (OSError, ValueError):
                entry["reason"] = "unreadable"
            out.append(entry)
        return out

    def read_file(self, name: str, fname: str) -> Optional[bytes]:
        """One bundle file's bytes; None when absent. `fname` is a bundle
        file or a fleet capture path `peers/<node_id>/<file>`; every
        component is validated: no path traversal."""
        if name != os.path.basename(name) or not name.startswith("incident-"):
            return None
        parts = fname.split("/")
        if len(parts) == 3 and parts[0] == "peers":
            parts = parts[1:]
        elif len(parts) != 1:
            return None
        for part in parts:
            if (not part or part != os.path.basename(part)
                    or part in (".", "..") or part.startswith(".")):
                return None
        path = os.path.join(self.directory, name, fname)
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError:
            return None


# ---- module-level trigger hook --------------------------------------------
#
# Trigger sites (scheduler shed, breaker on_trip, SLO on_breach) call
# notify() unconditionally; with no recorder installed it is one
# None-check.  App-owned, not config-owned: cli.BanjaxApp installs its
# recorder at startup and uninstalls on shutdown so in-process tests
# never cross-contaminate.

_recorder: Optional[FlightRecorder] = None


def install(recorder: Optional[FlightRecorder]) -> None:
    global _recorder
    _recorder = recorder


def installed() -> Optional[FlightRecorder]:
    return _recorder


def notify(reason: str, detail: str = "") -> Optional[str]:
    rec = _recorder
    if rec is None:
        return None
    return rec.notify(reason, detail)
