"""Synthetic workload: the OWASP-CRS-shaped ruleset and the log-line
stream of the repository's benchmark (copies of `generate_rules`,
`synthesize_match` and `generate_lines` from bench.py), plus the
rate-limit config and timestamped access-log lines the port's
end-to-end runs use."""

from __future__ import annotations

import random

from banjax_tpu_torch.matcher.rulec import compile_rule


def generate_rules(n: int, seed: int = 7) -> list:
    """OWASP-CRS-shaped synthetic ruleset (BASELINE.json configs[2]):
    literal attack paths, method+path prefixes, scanner UA tokens, char
    classes and bounded quantifiers — the pattern shapes of
    banjax-config.yaml's production rules."""
    rng = random.Random(seed)
    words = [
        "admin", "login", "wp", "xmlrpc", "shell", "config", "backup", "env",
        "passwd", "phpmyadmin", "setup", "install", "api", "token", "debug",
        "console", "cgi", "bin", "upload", "include", "vendor", "composer",
    ]
    exts = ["php", "asp", "aspx", "jsp", "cgi", "sh", "bak", "sql", "old"]
    patterns = []
    while len(patterns) < n:
        kind = rng.random()
        w1, w2 = rng.choice(words), rng.choice(words)
        ext = rng.choice(exts)
        if kind < 0.3:
            p = rf"GET /{w1}-{w2}/[a-z0-9_-]+\.{ext}"
        elif kind < 0.5:
            p = rf"(GET|POST) /{w1}/{w2}\.{ext}"
        elif kind < 0.65:
            p = rf"POST /{w1}[a-z]*/{w2}{rng.randint(0, 99)}"
        elif kind < 0.8:
            p = rf"/{w1}\.{ext}\?[a-z]+={rng.randint(0, 9)}[0-9]{{1,4}}"
        elif kind < 0.9:
            p = rf"(?i){w1}scan|{w2}bot/{rng.randint(1, 9)}\.[0-9]+"
        else:
            p = rf"^(GET|POST|HEAD) [a-z.-]+\.(com|org|net) .*/{w1}{w2}"
        patterns.append(p)
    return patterns


def synthesize_match(pattern: str, rng: random.Random) -> str:
    """Build a string the compiled rule actually matches (attack traffic)."""
    prog = compile_rule(pattern)
    if not prog.branches:
        return "GET example.com GET / HTTP/1.1 x -"
    br = rng.choice(prog.branches)
    chars = []
    for pos in br.positions:
        # prefer printable ASCII members of the byte class
        for lo, hi in ((0x61, 0x7A), (0x30, 0x39), (0x20, 0x7E)):
            cands = [b for b in range(lo, hi + 1) if (pos.cs >> b) & 1]
            if cands:
                break
        chars.append(chr(rng.choice(cands or [0x61])))
    body = "".join(chars)
    prefix = "" if br.anchored_start else "GET example.com "
    suffix = "" if br.anchored_end else " HTTP/1.1 ua -"
    return prefix + body + suffix


def generate_lines(n: int, patterns: list, seed: int = 11, attack_rate: float = 0.02) -> list:
    """Mostly benign traffic with ~attack_rate lines synthesized to match a
    random rule — the realistic shape of the tailer's input stream."""
    rng = random.Random(seed)
    hosts = ["example.com", "site.org", "news.net", "shop.com"]
    paths = [
        "/", "/index.html", "/assets/app.js", "/img/logo.png", "/about",
        "/api/v1/items", "/search?q=red4321", "/contact", "/news/2026/07",
    ]
    uas = ["Mozilla/5.0 (X11; Linux x86_64)", "curl/8.1", "Safari/604.1"]
    out = []
    for _ in range(n):
        if patterns and rng.random() < attack_rate:
            out.append(synthesize_match(rng.choice(patterns), rng))
            continue
        method = rng.choice(["GET", "GET", "GET", "POST", "HEAD"])
        out.append(
            f"{method} {rng.choice(hosts)} {method} {rng.choice(paths)} "
            f"HTTP/1.1 {rng.choice(uas)} -"
        )
    return out


def rules_config(patterns: list, seed: int = 7, **keys) -> str:
    """YAML config text with one global rate-limit rule per pattern
    (seeded intervals, thresholds and decisions) plus the given top-level
    keys — readable by the port and by the JAX package alike."""
    import yaml

    rng = random.Random(seed)
    rules = [
        {
            "rule": f"r{i:04d}",
            "regex": p,
            "interval": rng.choice([5, 10, 30, 60]),
            "hits_per_interval": rng.randint(1, 6),
            "decision": rng.choice(["challenge", "nginx_block", "iptables_block"]),
        }
        for i, p in enumerate(patterns)
    ]
    return yaml.safe_dump(dict(keys, regexes_with_rates=rules), sort_keys=False)


def access_log(n: int, patterns: list, now: float, seed: int = 11,
               attack_rate: float = 0.02, n_ips: int = 50_000,
               n_offenders: int = 40, offender_hits: int = 12,
               span_s: float = 9.0) -> list:
    """`n` access-log lines "<ts> <ip> <rest>": generate_lines traffic from
    a pool of `n_ips` client IPs, plus `n_offenders` IPs that each repeat
    one attack line `offender_hits` times, so they cross their rule's
    threshold. Timestamps rise over the `span_s` seconds before `now`
    (inside the 10 s staleness cutoff)."""
    rng = random.Random(seed)
    rests = generate_lines(n, patterns, seed=seed, attack_rate=attack_rate)
    ips = [
        f"198.{rng.randrange(18, 20)}.{rng.randrange(256)}.{rng.randrange(256)}"
        for _ in range(n_ips)
    ]
    line_ips = [rng.choice(ips) for _ in range(n)]
    for k in range(n_offenders):
        ip = f"203.0.{k // 250}.{k % 250 + 1}"
        rest = synthesize_match(rng.choice(patterns), rng)
        for pos in rng.sample(range(n), min(n, offender_hits)):
            rests[pos], line_ips[pos] = rest, ip
    return [
        f"{now - span_s + span_s * i / max(1, n):.6f} {line_ips[i]} {rests[i]}"
        for i in range(n)
    ]


def attack_lines(n: int, patterns: list, now: float, seed: int = 13) -> list:
    """`n` lines that each match some rule, from distinct IPs — a chunk of
    these overflows the prefilter's candidate capacity."""
    rng = random.Random(seed)
    return [
        f"{now - 0.5:.6f} 192.0.2.{i % 250 + 1} "
        f"{synthesize_match(rng.choice(patterns), rng)}"
        for i in range(n)
    ]


def tiering_log(n: int, patterns: list, now: float, seed: int = 7, repeaters: int = 81_920,
                n_offenders: int = 40, offender_hits: int = 40, attack_rate: float = 0.02,
                span_s: float = 9.0) -> list:
    """`n` access-log lines for the state-tiering path: `repeaters` IPs
    that each appear three times, a third of the stream apart (first
    appearances over the first third, in repeater order), `n_offenders`
    IPs repeating one attack line `offender_hits` times at random, and
    one-shot IPs for the rest; the rests are generate_lines traffic at
    `attack_rate`. Timestamps rise over the `span_s` seconds before `now`."""
    rng = random.Random(seed)
    n_rep = min(repeaters, (n - n_offenders * offender_hits) // 3)
    keyed = []  # (position in the stream, ip, offender's rest or None)
    for r in range(n_rep):
        t1 = r / n_rep / 3
        for k in range(3):
            keyed.append((t1 + k / 3 + rng.random() * 1e-4, f"100.{64 + (r >> 16)}.{(r >> 8) & 255}.{r & 255}", None))
    for k in range(n_offenders):
        rest = synthesize_match(rng.choice(patterns), rng)
        ip = f"203.0.{k // 250}.{k % 250 + 1}"
        keyed += [(rng.random(), ip, rest) for _ in range(offender_hits)]
    for i in range(n - len(keyed)):
        keyed.append((rng.random(), f"198.{18 + (i >> 16)}.{(i >> 8) & 255}.{i & 255}", None))
    keyed.sort(key=lambda x: x[0])
    rests = generate_lines(n, patterns, seed=seed, attack_rate=attack_rate)
    return [
        f"{now - span_s + span_s * i / max(1, n):.6f} {ip} {rests[i] if own is None else own}"
        for i, (_, ip, own) in enumerate(keyed)
    ]
