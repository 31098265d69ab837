"""Named attack shapes: deterministic hostile-traffic generators.

(A copy of `banjax_tpu/scenarios/shapes.py`: the same (name, seed, scale)
gives the byte-identical line stream, events and notes in both packages.)

Each shape builds a `Scenario`: an ordered event stream (line chunks,
Kafka command batches, log-rotation markers) over a small shared
ruleset, plus everything the oracle needs to predict the exact ban
multiset.  Generation is pure in (name, seed, scale) — `random.Random`
only, fixed epoch — so the same call is byte-identical across runs and
machines (tests/test_torch_scenarios.py holds both packages' streams equal).

Timing model: all virtual timestamps live inside an 8-second span
anchored at T0, and the runner pins the pipeline clock at T0 + 9 s, so
no line is ever stale against the reference's 10 s cutoff and the
fixed-window math is fully determined by the generated timestamps —
wall-clock speed of the run cannot change the oracle.

The shapes (PAPER.md §0 sources 2–4):

  flash_crowd       sudden synchronized burst from a bounded IP pool —
                    every crowd IP must ban
  slow_drip         many IPs under many distinct UAs, each pacing JUST
                    under the rule threshold; a few greedy drippers
                    cross it — precision bait
  rotating_proxies  the all-distinct-IP worst case (maximal slot churn);
                    a handful of repeat offenders hide in the churn
  command_flood     Baskerville command storm through the pipeline's
                    admission buffer (exercises pipeline_command_take_max
                    chopping) over a live line stream
  challenge_storm   challenge-failure shape: a crowd hammering a
                    challenge-decision rule past its threshold
  log_rotation      flash-crowd burst with rotation markers mid-burst
                    (and a never-terminated trailing line) — the tailer
                    must deliver every line exactly once
  benign            clean traffic only: zero bans, zero SLO burn
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import Callable, Dict, List, Tuple

# fixed virtual epoch: part of the determinism contract
T0 = 1_700_000_000.0
SPAN_S = 8.0           # all line timestamps in [T0, T0 + SPAN_S]
RUN_NOW = T0 + 9.0     # the runner's pinned clock (max age 9 s < 10 s cutoff)

CHUNK_LINES = 256      # lines per LineChunk event (tailer-chunk shaped)

# the shared scenario ruleset: one volumetric GET rule, one tight probe
# rule, one challenge-decision rule — enough to exercise block,
# iptables and challenge effects without a per-scenario compile bill
RULES_YAML = r"""
regexes_with_rates:
  - rule: http_flood
    regex: 'GET /(index|home|assets)'
    interval: 5
    hits_per_interval: 40
    decision: nginx_block
  - rule: login_probe
    regex: '(GET|POST) /(wp-login|xmlrpc)\.php'
    interval: 5
    hits_per_interval: 8
    decision: iptables_block
  - rule: pay_probe
    regex: 'GET /(checkout|api/v1/pay)'
    interval: 4
    hits_per_interval: 12
    decision: challenge
"""

_BENIGN_PATHS = (
    "/about", "/contact", "/robots.txt", "/img/logo.png",
    "/css/site.css", "/news/2026/07",
)
_HOSTS = ("site.example", "shop.example", "news.example")
_BENIGN_UAS = (
    "Mozilla/5.0 (X11; Linux x86_64)", "Safari/604.1", "curl/8.1",
    "Opera/9.80",
)


@dataclasses.dataclass(frozen=True)
class LineChunk:
    """One tailer-shaped delivery of complete log lines."""

    lines: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class CommandBatch:
    """Kafka command messages for the pipeline admission buffer."""

    raws: Tuple[bytes, ...]


@dataclasses.dataclass(frozen=True)
class Rotation:
    """Log-rotation marker: in tailer-fed mode the runner renames the
    live log file here (new inode, writer moves on).  A no-op when the
    stream is submitted directly."""


@dataclasses.dataclass
class Scenario:
    name: str
    seed: int
    scale: float
    rules_yaml: str
    events: List[object]           # LineChunk | CommandBatch | Rotation
    benign: bool                   # oracle expects ZERO bans
    expected_command_ips: Tuple[str, ...] = ()
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)

    def lines(self) -> List[str]:
        """The flattened line stream in admission order."""
        out: List[str] = []
        for ev in self.events:
            if isinstance(ev, LineChunk):
                out.extend(ev.lines)
        return out

    def n_commands(self) -> int:
        return sum(
            len(ev.raws) for ev in self.events
            if isinstance(ev, CommandBatch)
        )


def _line(ts: float, ip: str, method: str, host: str, path: str,
          ua: str) -> str:
    # the tailer-compatible shape: "<epoch.frac> <ip> <method> <host>
    # <method> <path> HTTP/1.1 <ua> -" — rest starts at the first method
    return f"{ts:.6f} {ip} {method} {host} {method} {path} HTTP/1.1 {ua} -"


def _benign_line(rng: random.Random, t_lo: float, t_hi: float) -> Tuple[float, str]:
    t = T0 + rng.uniform(t_lo, t_hi)
    ip = f"10.9.{rng.randrange(4)}.{rng.randrange(64)}"
    method = rng.choice(("GET", "GET", "GET", "POST", "HEAD"))
    return t, _line(t, ip, method, rng.choice(_HOSTS),
                    rng.choice(_BENIGN_PATHS), rng.choice(_BENIGN_UAS))


def _chunked(timed: List[Tuple[float, str]],
             chunk: int = CHUNK_LINES) -> List[LineChunk]:
    """Sort by virtual time (stable) and split into tailer-sized chunks."""
    timed.sort(key=lambda p: p[0])
    lines = [ln for _, ln in timed]
    return [
        LineChunk(tuple(lines[i: i + chunk]))
        for i in range(0, len(lines), chunk)
    ]


def _scenario(name, seed, scale, events, benign=False, notes=None,
              expected_command_ips=()) -> Scenario:
    return Scenario(
        name=name, seed=seed, scale=scale, rules_yaml=RULES_YAML,
        events=events, benign=benign, notes=notes or {},
        expected_command_ips=tuple(expected_command_ips),
    )


# ---------------------------------------------------------------- shapes


def flash_crowd(seed: int, scale: float = 1.0) -> Scenario:
    """A quiet baseline, then a synchronized 2-second burst: every crowd
    IP exceeds http_flood's 40 hits / 5 s and must ban."""
    rng = random.Random(seed)
    n_crowd = max(4, int(32 * scale))
    hits = 56  # > hits_per_interval within one window
    timed = [_benign_line(rng, 0.0, SPAN_S) for _ in range(n_crowd * 12)]
    for k in range(n_crowd):
        ip = f"10.1.{k >> 8}.{k & 0xFF}"
        ua = rng.choice(_BENIGN_UAS)
        for _ in range(hits):
            t = T0 + rng.uniform(4.0, 6.0)  # the burst window
            timed.append((t, _line(t, ip, "GET", _HOSTS[0],
                                   "/index.html", ua)))
    return _scenario(
        "flash_crowd", seed, scale, _chunked(timed),
        notes={"crowd_ips": n_crowd, "hits_per_ip": hits},
    )


def slow_drip(seed: int, scale: float = 1.0) -> Scenario:
    """Many IPs under many DISTINCT user agents, each pacing login
    probes just under the 8 hits / 5 s threshold; a few greedy drippers
    burst past it.  The oracle expects bans for the greedy set only —
    banning the paced set is a precision failure."""
    rng = random.Random(seed)
    n_drip = max(8, int(96 * scale))
    n_greedy = max(1, n_drip // 24)
    timed = [_benign_line(rng, 0.0, SPAN_S) for _ in range(n_drip * 4)]
    for k in range(n_drip):
        ip = f"10.2.{k >> 8}.{k & 0xFF}"
        ua = f"DripAgent-{k}/{1 + k % 7}.{k % 10}"  # many-UA signature
        # 6 probes spread over the full span: never 9 inside any 5 s
        # fixed window that starts at the first probe
        for j in range(6):
            t = T0 + (j * SPAN_S / 6.0) + rng.uniform(0.0, 0.4)
            timed.append((t, _line(t, ip, "GET", _HOSTS[1],
                                   "/wp-login.php", ua)))
    for k in range(n_greedy):
        ip = f"10.3.0.{k}"
        ua = f"GreedyAgent-{k}/1.0"
        for _ in range(12):  # > 8 inside a 2 s burst
            t = T0 + 2.0 + rng.uniform(0.0, 2.0)
            timed.append((t, _line(t, ip, "POST", _HOSTS[1],
                                   "/xmlrpc.php", ua)))
    return _scenario(
        "slow_drip", seed, scale, _chunked(timed),
        notes={"drip_ips": n_drip, "greedy_ips": n_greedy},
    )


def rotating_proxies(seed: int, scale: float = 1.0) -> Scenario:
    """The all-distinct-IP worst case: every request from a fresh proxy
    exit, maximal window-slot churn, no single IP near a threshold — the
    engine must survive the churn WITHOUT banning the rotation, while
    still catching the few repeat offenders hidden inside it."""
    rng = random.Random(seed)
    n_distinct = max(64, int(2048 * scale))
    n_repeat = 3
    timed = []
    for k in range(n_distinct):
        ip = f"11.{(k >> 16) & 0xFF}.{(k >> 8) & 0xFF}.{k & 0xFF}"
        t = T0 + rng.uniform(0.0, SPAN_S)
        timed.append((t, _line(t, ip, "GET", _HOSTS[0], "/index.html",
                               rng.choice(_BENIGN_UAS))))
    for k in range(n_repeat):
        ip = f"12.0.0.{k + 1}"
        for _ in range(50):  # > 40 within a 2 s slice of the churn
            t = T0 + 3.0 + rng.uniform(0.0, 2.0)
            timed.append((t, _line(t, ip, "GET", _HOSTS[0], "/home",
                                   "curl/8.1")))
    return _scenario(
        "rotating_proxies", seed, scale, _chunked(timed),
        notes={"distinct_ips": n_distinct, "repeat_offenders": n_repeat},
    )


def command_flood(seed: int, scale: float = 1.0) -> Scenario:
    """Baskerville command storm: thousands of block/challenge commands
    ride the pipeline's admission buffer interleaved with a live line
    stream.  Batches are larger than pipeline_command_take_max (1024) so
    the encode stage must chop them instead of letting one giant
    dispatch starve line batching."""
    rng = random.Random(seed)
    n_cmds = max(256, int(3072 * scale))
    timed = [_benign_line(rng, 0.0, SPAN_S) for _ in range(n_cmds // 2)]
    for k in range(8):  # a light concurrent attack so lines still ban
        ip = f"10.4.0.{k}"
        for _ in range(56):
            t = T0 + rng.uniform(2.0, 5.0)
            timed.append((t, _line(t, ip, "GET", _HOSTS[2],
                                   "/assets/app.js", "curl/8.1")))
    chunks = _chunked(timed)
    cmd_ips = []
    raws = []
    for k in range(n_cmds):
        ip = f"198.51.{(k >> 8) & 0xFF}.{k & 0xFF}"
        cmd_ips.append(ip)
        name = "block_ip" if rng.random() < 0.7 else "challenge_ip"
        raws.append(json.dumps(
            {"Name": name, "Value": ip, "host": _HOSTS[0]},
            sort_keys=True,
        ).encode())
    # two oversized batches dropped mid-stream: each > take_max
    half = len(raws) // 2
    mid = max(1, len(chunks) // 3)
    events: List[object] = list(chunks[:mid])
    events.append(CommandBatch(tuple(raws[:half])))
    events.extend(chunks[mid: 2 * mid])
    events.append(CommandBatch(tuple(raws[half:])))
    events.extend(chunks[2 * mid:])
    return _scenario(
        "command_flood", seed, scale, events,
        expected_command_ips=cmd_ips,
        notes={"commands": n_cmds, "command_batches": 2},
    )


def challenge_storm(seed: int, scale: float = 1.0) -> Scenario:
    """Challenge-failure storm: a crowd hammering the challenge-decision
    rule past its threshold — the reference's repeated-challenge-failure
    shape expressed as tailer traffic.  Every storm IP must draw
    (repeated) challenge decisions.  The runner then pushes the same
    clients through the real challenge plane (issue -> solve -> verify
    -> failure state): a seeded `solver_fraction` of them solve the PoW
    cookie and pass, the rest fail until the failed-challenge rate
    limit bans them (runtime.ScenarioRunner._challenge_loop)."""
    rng = random.Random(seed)
    n_storm = max(8, int(48 * scale))
    timed = [_benign_line(rng, 0.0, SPAN_S) for _ in range(n_storm * 8)]
    for k in range(n_storm):
        ip = f"10.5.{k >> 8}.{k & 0xFF}"
        ua = f"ChallengeBot-{k}/2.{k % 5}"
        for _ in range(20):  # > 12 per 4 s window
            t = T0 + 1.0 + rng.uniform(0.0, 3.0)
            timed.append((t, _line(t, ip, "GET", _HOSTS[1], "/checkout",
                                   ua)))
    return _scenario(
        "challenge_storm", seed, scale, _chunked(timed),
        notes={"storm_ips": n_storm, "solver_fraction": 0.25},
    )


def log_rotation(seed: int, scale: float = 1.0) -> Scenario:
    """Flash-crowd burst with the access log rotated mid-burst (three
    times): the tailer must reopen by inode WITHOUT dropping the bytes
    still in the old file or duplicating any line.  Direct-submit runs
    treat the markers as no-ops, so the same oracle judges both modes."""
    base = flash_crowd(seed, scale)
    chunks = [ev for ev in base.events if isinstance(ev, LineChunk)]
    n = len(chunks)
    rot_at = {i for i in (n // 4, n // 2, (3 * n) // 4) if 0 < i < n}
    if not rot_at and n > 1:
        rot_at = {1}
    events: List[object] = []
    for i, ch in enumerate(chunks):
        if i in rot_at:
            events.append(Rotation())
        events.append(ch)
    return _scenario(
        "log_rotation", seed, scale, events,
        notes={**base.notes, "rotations": len(rot_at)},
    )


def benign(seed: int, scale: float = 1.0) -> Scenario:
    """Clean traffic only: the oracle expects zero bans, and the runner
    additionally asserts banjax_slo_breached stays 0 end to end."""
    rng = random.Random(seed)
    n = max(256, int(4096 * scale))
    timed = [_benign_line(rng, 0.0, SPAN_S) for _ in range(n)]
    return _scenario("benign", seed, scale, _chunked(timed), benign=True,
                     notes={"lines": n})


# ------------------------------------------- mega-state streaming shape

# the mega noise paths are RULE-NEUTRAL by construction: a slot-REFUSED
# row that matches a rule still accrues host window state (the
# bounded-ban-delay contract), so 10M matching noise IPs would grow host
# state without bound — neutral paths keep refused noise stateless while
# slot churn (the thing the A/B measures) is match-independent anyway
_MEGA_NOISE_PATHS = ("/about", "/contact", "/robots.txt", "/news/2026/07")
MEGA_OFFENDER_HITS = 50  # > http_flood's 40/5s inside a 2 s slice


def _mega_offender_timed(
    seed: int, n_repeat: int = 3
) -> List[Tuple[float, str]]:
    """The repeat offenders hidden in the mega rotation, sorted by time.
    Shared verbatim by the stream generator and the oracle scenario so
    the offender sub-stream is byte-identical in both."""
    rng = random.Random(seed)
    timed = []
    for k in range(n_repeat):
        ip = f"203.0.113.{k + 1}"  # TEST-NET-3: never collides with noise
        for _ in range(MEGA_OFFENDER_HITS):
            t = T0 + 3.0 + rng.uniform(0.0, 2.0)
            timed.append((t, _line(t, ip, "GET", _HOSTS[0], "/home",
                                   "curl/8.1")))
    timed.sort(key=lambda p: p[0])
    return timed


def mega_offenders(seed: int, n_repeat: int = 3) -> Scenario:
    """Offender-only mini Scenario: the oracle input for mega runs.

    The mega noise is rule-neutral, so the full stream's expected ban
    multiset equals `oracle.expected_bans` over just the offenders —
    per-(ip, rule) fixed windows make the noise interleaving irrelevant.
    Each offender lands exactly one http_flood ban (hit 41 exceeds 40
    and resets to 0; the remaining 9 hits cannot re-fire)."""
    timed = list(_mega_offender_timed(seed, n_repeat))
    return _scenario(
        "mega_rotating_proxies", seed, float(n_repeat), _chunked(timed),
        notes={"repeat_offenders": n_repeat,
               "hits_per_offender": MEGA_OFFENDER_HITS},
    )


def mega_rotating_proxies_stream(seed: int, n_distinct: int,
                                 n_repeat: int = 3, chunk: int = 16384):
    """rotating_proxies at mega scale: a GENERATOR of line chunks, never
    materializing the stream — 10M+ distinct IPs in bounded memory (one
    chunk of strings plus the 150-line offender list).

    Noise: the k-th of `n_distinct` IPs fires exactly one rule-neutral
    request at t = T0 + SPAN_S*k/n_distinct (evenly spaced, so the
    stream is time-sorted by construction and pure in (seed, n_distinct)
    — `seed` jitters only the offender sub-stream).  Offenders: the same
    `_mega_offender_timed` lines the oracle scenario uses, merged in
    timestamp order.  Chunks are `chunk` lines (device-batch shaped, not
    tailer-shaped: this stream exists to drive consume_lines directly)."""
    offenders = _mega_offender_timed(seed, n_repeat)
    oi, on = 0, len(offenders)
    buf: List[str] = []
    for k in range(n_distinct):
        t = T0 + SPAN_S * k / n_distinct
        while oi < on and offenders[oi][0] <= t:
            buf.append(offenders[oi][1])
            oi += 1
            if len(buf) >= chunk:
                yield buf
                buf = []
        ip = (f"{10 + (k >> 24)}.{(k >> 16) & 0xFF}."
              f"{(k >> 8) & 0xFF}.{k & 0xFF}")
        buf.append(_line(t, ip, "GET", _HOSTS[k % len(_HOSTS)],
                         _MEGA_NOISE_PATHS[k & 3],
                         _BENIGN_UAS[(k >> 2) & 3]))
        if len(buf) >= chunk:
            yield buf
            buf = []
    buf.extend(ln for _, ln in offenders[oi:])
    while len(buf) >= chunk:
        yield buf[:chunk]
        buf = buf[chunk:]
    if buf:
        yield buf


SHAPES: Dict[str, Callable[..., Scenario]] = {
    "flash_crowd": flash_crowd,
    "slow_drip": slow_drip,
    "rotating_proxies": rotating_proxies,
    "command_flood": command_flood,
    "challenge_storm": challenge_storm,
    "log_rotation": log_rotation,
    "benign": benign,
}


def generate(name: str, seed: int = 1234, scale: float = 1.0) -> Scenario:
    try:
        shape = SHAPES[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; known: {sorted(SHAPES)}"
        ) from None
    return shape(seed, scale)
