#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, then drives the
regex rate-limit main path — `TorchMatcher.consume_lines` on the deploy
configuration (two-stage prefilter, device windows, one program per
chunk) — at the size a deployment holds: 1,000 OWASP-CRS-shaped rules,
4,096-line chunks of 256-byte lines, 65,536 window slots (0.85 GB of
window state on the card), over 33 chunks of seeded traffic including
one chunk of nothing but attack lines, which overflows the prefilter and
is served by the classic fallback. The host tier is the JAX package's
default (native parse, native slot manager, traffic sketch; its three C
libraries are built from `banjax_tpu_torch/native/` too); the same lines
then go through the Python gate with the native slot manager and the
sketch off (the route before the native host tier), and both must write
the same ban log. The first chunks also go
through a CPU matcher running the plain versions; ban-log bytes and
per-line results must be identical.

Then `tiering`, the deploy file's state tiering (native gate, sketch,
slot admission with the derived threshold, warm tier) at 65,536 slots
and 131,072 warm records over 64 chunks in which 81,920 repeater IPs
appear three times each: refusals, admissions, evictions, warm spills
and refills must all happen; the ban multiset and each IP's ban sequence
must equal an ungated run's, and a prefix at 2,048 slots must give the
same ban log, results, states, sketch arrays and counters on the card
as on the CPU. Each path's phase prints its host µs a line by stage.

Then the second path, the `/auth_request` decision chain with the
challenge plane: kernel C (the batched SHA-256 PoW check) against its
plain version and hashlib at up to 1,048,576 lanes; the verifier's
dispatch (`pow_dispatch`: one `_device_bits` call by the old route,
pack → copy in → kernel C → copy out on the current stream, against the
verifier's `PowDispatcher`, in turns, idle and behind queued kernel-A
work); and the chain
(`build_decision_chain`, `decision_for_nginx`) on the deploy
configuration under a challenge storm from 32 request threads —
131,072 distinct challengers, solved, under-target, expired, torn and
wrong-binding cookies, offenders banned past the failure threshold, and
IPs challenged through the log path by a TorchMatcher on the same
Banner. A prefix of that stream also runs through a chain on the CPU
(plain versions); responses, result records, ban logs and state must be
identical.

Then the service around both paths (`service`): `BanjaxApp` from the
deploy file, its log paths in a temp dir under `build/`, on an
ephemeral port, with the rules and cuts of `tiering`. The tailer follows
16 appended writes of 4,096 lines (the offenders' lines among them, one
rotation after the 8th); then 32 keep-alive clients send `/auth_request`
for the log path's bans (the fast path's table hits), cookieless
challengers and solved cookies (the chain, kernel C); then a reload
(the matcher is closed and rebuilt: device memory must come back within
5 %). The ban log must equal `TorchMatcher.consume_lines` on the same
batches, and a 1,024-request prefix replayed into an app on the CPU
must answer identically; no fast-path fault, fail-open answer or tailer
error may show. It prints lines/s through the tailer, line → ban-log
latency, requests/s and the launches of kernels A, B and C.

Then `pipeline` (the same app and writes with `pipeline_enabled: true`,
and its fault drill), then `observability`: the same app and the same
stamped writes with tracing and the profiler bridge, the profile routes,
a flight recorder, the metrics line and a 1 s SLO sampler on. Its ban log
must be `pipeline`'s byte for byte; every batch must carry its span tree;
each offender's ban a provenance record whose trace id the span ring
holds; `/metrics` must parse strictly (50 scrapes, timed) and count the
lines written; a 1 s MetricsReporter must write the ported keys; no SLO
may breach; a 2 s `/debug/torch/trace` capture over two writes must hold
kernels A and B with every launch inside a device-stage span; a
`matcher.device` drill must trip the breaker and leave one loadable
incident bundle. The service's apps create the kernel's ipset outside
standalone testing, so these phases run against `FakeKernelEdge`:
`ipset` and `iptables` scripts first on PATH and a fake netlink socket
(nothing reaches the machine's kernel); each checks that the ipset adds
are its ban log's IptablesBlock IPs and that `/is_banned` sees them.

Then `kafka`: the pipeline phase's app and first 8 writes with Kafka on,
against the port's broker stand-in (`ingest/broker_standin.py`, on the
port's wire codecs). 4,096 Baskerville commands in bursts of 512 go
through the pipeline's command lane between the writes; every
well-formed command must land in the lists with its decision and expiry,
and `/auth_request` must answer each commanded IP from the fast-path
table; the ban log must be the pipeline phase's; a challenge burst's
reports must all reach the report topic, and a `kafka.send` drill must
deliver the report it held. It prints commands/s, command -> answer
latency and lines/s. Then `workers`: the service phase's app with
`http_workers: 4` serving its request mix from 32 clients, a lockout
spread over the processes, the cold routes, a reload and a SIGKILLed
worker; only the primary may hold a CUDA context.

Then `fabric`: three shard processes, `python -m banjax_tpu_torch.cli
-config-file shard-X.yaml`, each with its own CUDA context on the card,
on the deploy file's keys at `service`'s width with `fabric_enabled:
true` and the deploy file's fabric keys, Kafka on against the broker
stand-in (decision replication), trace propagation, fleet metrics and
fleet incident capture on. Each IP's lines enter through one shard's log
(about two thirds are owned by another shard); one shard gets the
request mix (replicated bans from its fast path, solved cookies through
kernel C); one shard is SIGKILLed mid-flood and the rest of the flood
goes to the survivors' logs. Every ban must reach every live shard, the
survivors' bans must hold every ban of a single-process app on the card
fed what entered them (recall 1.0, per ban line), every shard's fabric
accounting must close, the takeover must complete, `/metrics?fleet=1`
must merge the live shards and flag the dead one, `/decisions/explain`
must be proxied with the origin node, an incident must hold the live
peer's files, kernels A and B must launch in every shard (counted in
each shard's own torch.profiler capture), and no shard may be left
running. It prints lines/s through the fabric and through the single
process, frames, ack RTT, line → ban-log latency by hop and the
takeover's detection and replay times.

Then `scenarios`: every attack shape of `banjax_tpu_torch/scenarios/` at
scale 32 with the JAX soak's seed through `ScenarioRunner` on the card
(log_rotation through the tailer, command_flood also through the broker
stand-in, challenge_storm with kernel C checking the solvers' cookies, a
chaos pass over the pipeline's failpoints with a flight recorder), each
clean run equal to the oracle (recall and precision 1.0), then the mega
rotation at 1,048,576 distinct IPs through `TorchMatcher.consume_lines`
held to the oracle. Then `fabric_dryrun`: the port's dry-run harness with
three worker processes on the card, a SIGKILL mid-flood and a rejoin, then
a churn run (gossip detection, a join through a seed, a suspicion refuted,
a planned leave); recall 1.0, every ledger closed, no worker left. Then
`ua_fused`: BASELINE config 4 at 500,000 lines from 100,000 IPs through
`DeviceUAMatcher` (every UA decision equal to `check_ua_decision`, the
rate columns equal to a rate-only kernel-A pass) and a TorchMatcher with
auto-sized device windows (the oracle's bans, no eviction). Then `mesh`:
the device mesh (`parallel/mesh.py`) on the main path's rules and chunks,
every member on the one card: `ShardedMatchBackend` for 2 x 2 and 2 x 4
grids on a traffic chunk (fused two-stage) and an attack chunk (overflow,
single-stage fallback), bits identical to the same backend on the CPU and
to the single-device matcher, kernel A launched by every member and held
to its plain version at the members' shapes; a 2 x 2 mesh-mode
TorchMatcher over 16 chunks and the attack chunk, synchronous and through
`PipelineScheduler`, with the single-device matcher's ban log and result
keys and nothing shed; and the deploy file with `matcher_mesh_devices: 1`
as a 1 x 1 mesh. Then `matcher_modes`, on `mesh`'s traffic, each mode
on a fresh matcher in turns: the single program (the base); the two
programs (`pallas_single_kernel: off`: program A, kernel A, at submit;
program B, kernel B, at resolve), synchronous and through
`PipelineScheduler` at drain_resolve_depth 1 and 2; host windows
(`matcher_device_windows: false`), synchronous and pipelined; and
`matcher: cpu` (`CpuMatcher`) on the first 4,096 lines against the
single program and host windows on that prefix. Ban logs and result
keys must equal the single program's, window states too where they are
on the card, nothing may be shed, programs A's and B's buffers on a
traffic chunk and the attack chunk must equal the CPU's byte for byte,
and each call's launches of A and B must be the predicted ones. Each
prints its seconds and adds its launches of A, B and C to
`launches_by_path`.

The kernel phases time each shape three ways: `ms` (CUDA events around
20 back-to-back wrapper calls; the host's enqueue bounds it when slower
than the card, and `host_enqueue_us` says so), `device_ms` (the same 20
calls as one CUDA graph) and the plain version's `plain_ms`; kernel A's
rows add the sweep over lines per thread and `alu_bound_ms`, kernel B's
the shape's segments and longest segment, kernel C's `alu_bound_ms`
(both ALU-pipe bounds counted from the SASS of the built library).

Each phase prints one JSON line; then the kernels line, the card's name
and power limit, and as the last line {"ok": true, "device": ...}. Any
failed check raises, and the script exits non-zero with no result. It
needs a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import base64
import contextlib
import gc
import hashlib
import io
import json
import random
import subprocess
import sys
import threading
import time

# the deploy configuration at a deployment's size
FULL = dict(
    n_rules=1000,
    batch_lines=4096,
    max_line_len=256,
    capacity=65536,
    chunks=32,             # traffic chunks, plus one all-attack chunk
    n_ips=50_000,
    n_offenders=40,        # repeat offenders, each repeating one attack line
    offender_hits=40,
    chunks_per_call=4,     # consume_lines batches (up to two chunks in flight)
    cross_check_chunks=2,  # leading chunks also run through the CPU matcher
)
SEED = 7

# the challenge storm on the deploy configuration (deploy/banjax-config.yaml)
CHALLENGE = dict(
    challengers=131_072,   # distinct IPs, each with a cookieless first hit
    solved=4_096,          # return with a cookie solved at the target
    under=2_048,           # return with an under-target solution
    expired=1_024,
    torn=1_024,
    wrong_binding=1_024,
    offenders=64,          # fail past the threshold: banned
    log_lines=4_096,       # one log chunk through a TorchMatcher on the Banner
    log_ips=256,           # IPs in it that hit the deploy's challengeme rule
    threads=32,
    cross_check=2_048,     # prefix of the stream also run on the CPU
    # 1 and 2 are the shapes the storm's dispatches mostly take
    pow_lanes=(1, 2, 32, 256, 4_096, 1_048_576),
    dispatch_lanes=(1, 2, 4, 8, 32, 256),
    dispatch_calls=1_000,  # timed calls a route and turn
)
# the deploy configuration's state tiering (deploy/banjax-config.yaml:
# native gate, sketch, slot admission with the derived threshold, warm
# tier), cut to 65,536 slots and 131,072 warm records
TIERING = dict(
    n_rules=1000,
    batch_lines=4096,
    max_line_len=256,
    capacity=65536,
    warm_capacity=131_072,
    chunks=64,
    repeaters=81_920,       # 1.25x the slots, three appearances each
    n_offenders=40,
    offender_hits=40,
    chunks_per_call=4,
    cross_check_chunks=8,
    cross_check_capacity=2048,
    sketch_width=8192,
    hll_p=12,
)
# the service around both paths: BanjaxApp from the deploy file, tailing
# 16 writes of 4,096 lines (the offenders' 40 x 40 lines among them, one
# rotation after the 8th write), then /auth_request from 32 keep-alive
# clients: 2,048 requests from log-path blocks (fast-path hits), one from
# each log-path challenge, 2,048 cookieless challengers and 2,048 solved
# cookies (the chain, kernel C); the rules and cuts of `tiering`
SERVICE = dict(
    n_rules=1000,
    batch_lines=4096,
    capacity=65536,
    warm_capacity=131_072,
    writes=16,
    rotate_after=8,
    n_offenders=40,
    offender_hits=40,
    threads=32,
    per_kind=2048,
    cross_check=1024,      # requests replayed into an app on the CPU
    warmup_lines=64,
)
# the service's app and writes with pipeline_enabled: true and the deploy
# file's pipeline keys (ring 4, latency budget 250 ms, buffer 131,072
# lines, max block 50 ms, encode_workers -1, drain_resolve_depth 2); then
# the fault drill on a second pipelined app, its breaker recovery and
# probe shortened, with writes of drill_lines filler lines
PIPELINE = dict(
    n_rules=1000,
    batch_lines=4096,
    capacity=65536,
    warm_capacity=131_072,
    writes=16,
    rotate_after=8,
    n_offenders=40,
    offender_hits=40,
    warmup_lines=64,
    drill_lines=32,
    drill_recovery_s=3.0,
    drill_probe_s=1.0,
)
# the observability plane: the pipeline phase's app and its 16 writes with
# tracing (and the profiler bridge), profile routes, a flight recorder, the
# metrics line and a 1 s SLO sampler on; 50 /metrics scrapes, a 2 s
# /debug/torch/trace capture over two writes, a 1 s MetricsReporter, and a
# matcher.device drill of drill_lines-line writes
OBSERVABILITY = dict(
    n_rules=1000,
    batch_lines=4096,
    capacity=65536,
    warm_capacity=131_072,
    scrapes=50,
    capture_s=2.0,
    reporter_interval_s=1.0,
    drill_lines=32,
)
# the Kafka channel: the pipeline phase's app and its first 8 stamped
# writes with Kafka on against a broker stand-in; before each write a
# burst of 512 Baskerville commands (4,096 in all, about 2 % malformed),
# 16 commanded IPs a burst polled for command -> answer latency; then a
# 256-request challenge burst whose reports must all reach the report topic
KAFKA = dict(
    n_rules=1000,
    batch_lines=4096,
    capacity=65536,
    warm_capacity=131_072,
    writes=8,
    commands=4096,
    burst=512,
    malformed_frac=0.02,
    latency_samples=16,
    challenge_ips=64,      # 64 solved, 32 cookieless, 32 wrong cookies, 32 offenders x 4
)
# multi-process serving: the service phase's app with http_workers: 4 and
# its request mix (6,157 requests from 32 keep-alive clients), a lockout,
# the cold routes, a worker SIGKILLed under 8 clients' load, a reload
WORKERS = dict(
    n_rules=1000,
    batch_lines=4096,
    capacity=65536,
    warm_capacity=131_072,
    workers=4,
    threads=32,
    alone_requests=256,
    lockout_ip="110.0.0.1",
    kill_clients=8,
)
# the decision fabric: three shard processes at service's width; each
# shard's log gets timed_writes, then captured_writes under a profiler
# capture, then (the victim killed) after_writes on the survivors
FABRIC = dict(
    n_rules=1000,
    batch_lines=4096,
    capacity=65536,
    warm_capacity=131_072,
    timed_writes=4,
    captured_writes=2,
    after_writes=3,
    n_ips=50_000,
    n_offenders=120,
    offender_hits=40,
    capture_s=6.0,
    ban_requests=512,
    solved=128,
)

# the scenario harness: every attack shape at scale 32 with the JAX soak's
# seed (flash_crowd 69,632 lines from 1,024 crowd IPs, slow_drip 32,256,
# rotating_proxies 65,686 from 65,539 IPs, command_flood 49,600 lines and
# 98,304 commands, challenge_storm 43,008 lines and 1,536 storm clients,
# log_rotation 69,632 with 3 rotations, benign 131,072), a chaos pass of
# chaos_episodes; then the mega rotation at 1,048,576 distinct IPs in
# 16,384-line chunks with tiering's cuts (65,536 slots, the warm tier, slot
# admission, sketch width 1 << 22)
SCENARIOS = dict(
    seed=20260804,
    scale=32.0,
    chaos_episodes=6,
    mega_ips=1_048_576,
    mega_chunk=16_384,
    mega_capacity=65_536,
    mega_sketch_width=1 << 22,
)
# the fabric dry run: three worker processes on the card; flash_crowd at
# scale 32 with a kill and a rejoin, then a churn run (join, suspicion,
# leave) at churn_scale
FABRIC_DRYRUN = dict(
    seed=20260804,
    scale=32.0,
    workers=3,
    churn_scale=32.0,
)
# BASELINE config 4 at its full size: 500,000 access-log lines from 100,000
# distinct IPs, UA checks in 4,096-row batches
UA_FUSED = dict(
    lines=500_000,
    ips=100_000,
    batch=4096,
)
# the device mesh on the main path's width: the deploy configuration's
# rules and chunks, grids of members all on the one card
MESH = dict(
    n_rules=1000,
    batch_lines=4096,
    max_line_len=256,
    capacity=65536,
    chunks=16,             # traffic chunks, plus one all-attack chunk
    n_ips=50_000,
    n_offenders=40,
    offender_hits=40,
    chunks_per_call=4,
    grids=((2, 2), (2, 4)),
    matcher_grid=(2, 2),
)
# the matcher modes beside the single program (two programs, host
# windows, matcher: cpu) on the mesh phase's traffic
MATCHER_MODES = dict(
    n_rules=1000,
    batch_lines=4096,
    max_line_len=256,
    capacity=65536,
    chunks=16,             # traffic chunks, plus one all-attack chunk
    n_ips=50_000,
    n_offenders=40,
    offender_hits=40,
    chunks_per_call=4,
    depths=(1, 2),         # drain_resolve_depth of the pipelined two-program runs
    prefix_lines=4096,     # what CpuMatcher (Python re) takes within the phase
    cross_check_capacity=8192,  # window slots of the CPU matcher for the buffers
)

SHA_HOST = "sha.example"   # the one host in sitewide_sha_inv_list (block)
LOG_HOST = "example.org"

# the card's peaks (NVIDIA H100 SXM data sheet): device memory and
# non-tensor 32-bit throughput (the data sheet gives no integer-ALU rate;
# 32-bit integer operations are counted against the float32 rate)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Hopper's INT32 (ALU pipe) issue rate, from the architecture's 16 INT32
# lanes per SM sub-partition: 132 SMs x 64 lanes x 1.98 GHz boost, a
# quarter of PEAK_OPS_PER_S
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit operations per (line byte, NFA word) of kernel A: table-row
# select, shift, shift_in mask, inject or, selfloop and/or, class mask,
# accept and/or, end check; +3 for the cross-word carry
NFA_OPS = 10
NFA_CARRY_OPS = 3
# per event of kernel B: the step's selects, borrow arithmetic and compares
SCAN_OPS = 24
# kernel B's bytes an event: 8 int32 columns and 3 flag bytes in, 4 int32
# columns and the exceeded byte out
SCAN_BYTES = 8 * 4 + 3 + 4 * 4 + 1
# per lane of kernel C, counted from csrc/pow_verify.cu with every
# three-input bitwise function as one LOP3. A round: Sigma1 and Sigma0 at
# 3 funnel shifts + one three-way xor each, Ch and Maj one each, 7 adds
# (6 in rounds 13-15, where K + W is a constant); round 63 computes only
# a (+ H0): 17. A schedule step: sigma0 and sigma1 at 2 funnel shifts, a
# shift and one three-way xor each, 3 adds (11), less what the padding
# folds (24 over steps 16, 17, 21, 28, 29 and 30). 13 loads + 13 byte
# swaps; the count of the first digest word (clz, compare): the words
# past it run only when it is zero, which no lane of these inputs is
POW_OPS = (60 * 17 + 3 * 16 + 17) + (48 * 11 - 24) + 26 + 2
POW_BYTES = 52 + 4  # message in, count out
# `alu_bound_ms` of kernel C divides the ALU-pipe instructions a lane,
# counted in the run from the SASS of pow_verify_kernel
# (sass_alu.count_pow), by INT32_OPS_PER_S: a tighter bound than
# `bound_ms`, which uses the float32 rate as rows A and B do

REPLACES = {
    "nfa_match": "banjax_tpu/matcher/kernels/nfa_match.py:212",
    "window_scan": "banjax_tpu/matcher/kernels/fused_match_window.py:70",
    "pow_verify": "banjax_tpu/matcher/kernels/pow_verify.py:85",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps: int) -> float:
    """Mean wall time of fn() on the card, by CUDA events after a warm-up
    (host clock for a CPU rehearsal)."""
    import torch

    fn()
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def graph_ms(fn, device, reps: int = 20):
    """Mean device time of fn() with the host out of the way: reps calls
    captured in one CUDA graph, its replay timed by CUDA events (None for a
    CPU rehearsal)."""
    import torch

    if device.type != "cuda":
        return None
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture (first launches configure)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    sync(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    sync(device)
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def host_enqueue_us(fn, device, n: int = 100) -> float:
    """Mean host time to enqueue fn() (perf_counter around n calls with no
    sync): when it exceeds `ms`, CUDA events time the host, not the card.
    n calls of up to two launches each stay well inside the card's launch
    queue (about 1,024 entries), so no enqueue waits for the card."""
    n = n if device.type == "cuda" else 2  # a CPU rehearsal runs the plain versions
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    sync(device)
    return 1e6 * dt / n


def line_bytes(cls, lens) -> int:
    """The bytes kernel A steps: each line's first len class ids."""
    return int(lens.clamp(0, cls.shape[1]).sum())


def nfa_bytes(prep, cls, lens) -> int:
    """Kernel A's bytes: the class ids of each line's first len bytes,
    lengths, table and masks in, words out."""
    B, W = cls.shape[0], prep.n_words
    return 4 * (line_bytes(cls, lens) + B + prep.n_classes * W + 6 * W + B * W)


def nfa_alu_bound_ms(prep, cls, lens, alu_per_line_byte) -> float:
    """Bytes over the memory rate, or kernel A's ALU-pipe instructions per
    (line byte, word), as counted in the SASS of the instantiation that
    runs, over INT32_OPS_PER_S."""
    ops = line_bytes(cls, lens) * prep.n_words * alu_per_line_byte
    return 1e3 * max(nfa_bytes(prep, cls, lens) / PEAK_BYTES_PER_S, ops / INT32_OPS_PER_S)


def nfa_bound_ms(prep, cls, lens) -> tuple:
    W = prep.n_words
    nbytes = nfa_bytes(prep, cls, lens)
    ops = line_bytes(cls, lens) * W * (NFA_OPS + (0 if prep.carry_free else NFA_CARRY_OPS))
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def skewed_batch(cls, C: int, n: int, seed: int):
    """n lines of skewed length: encoded log lines (one in ten replaced by
    random class ids), lengths mostly short, with empty and full-length
    lines (which read the pad class past a log line's end)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    L = cls.shape[1]
    rows = np.resize(np.arange(cls.shape[0]), n)
    out = np.array(cls[rows], dtype=np.int32)
    noisy = rng.random(n) < 0.1
    out[noisy] = rng.integers(0, C, (int(noisy.sum()), L), dtype=np.int32)
    ln = (L * rng.random(n) ** 3).astype(np.int32)
    ln[rng.random(n) < 0.05] = 0
    ln[rng.random(n) < 0.05] = L
    ln[:2] = (0, L)
    return out, ln


def segments_of(b, pad) -> tuple:
    """(segments, longest segment) of a scan input: runs of non-pad events
    from the first one or a boundary to the next."""
    import numpy as np

    nb = np.asarray(b)[~np.asarray(pad)]
    if nb.size == 0:
        return 0, 0
    starts = np.flatnonzero(nb)
    if starts.size == 0 or starts[0] != 0:
        starts = np.r_[0, starts]
    ends = np.r_[starts[1:], nb.size]
    return int(starts.size), int((ends - starts).max())


def scan_shapes(seed: int) -> dict:
    """Kernel B's shapes: the selftest stimulus, the main path's size, one
    4,096-event carry segment (the serial worst case), E beyond one
    shared-memory tile, and a single event."""
    import numpy as np

    from banjax_tpu_torch.matcher.kernels import fused_match_window as fmw

    one = list(scan_stimulus(4096, seed))
    one[0] = np.zeros(4096, dtype=bool)
    one[0][0] = True
    one[10] = np.zeros(4096, dtype=bool)
    single = list(scan_stimulus(8, seed))
    single = [x[:1].copy() for x in single]
    single[0][0], single[10][0] = True, False
    return {
        "selftest": fmw.selftest_stimulus(64),
        "events_4096": scan_stimulus(4096, seed),
        "one_segment_4096": tuple(one),
        "events_16384": scan_stimulus(16384, seed),
        "events_1": tuple(single),
    }


def scan_bound_ms(E: int) -> tuple:
    t_bytes = SCAN_BYTES * E / PEAK_BYTES_PER_S
    t_ops = SCAN_OPS * E / PEAK_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def scan_stimulus(E: int, seed: int):
    """A sorted-event-shaped list: long carry segments, pads inside and a
    pad tail, restarts and exceeds."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pad = rng.random(E) < 0.05
    pad[-E // 8:] = True
    return (
        rng.random(E) < 0.02,
        rng.integers(0, 6, E).astype(np.int32),
        rng.integers(1_700_000_000, 1_700_000_040, E).astype(np.int32),
        rng.integers(0, 1_000_000_000, E).astype(np.int32),
        rng.random(E) < 0.8,
        np.sort(rng.integers(1_700_000_000, 1_700_000_060, E)).astype(np.int32),
        rng.integers(0, 1_000_000_000, E).astype(np.int32),
        rng.integers(0, 6, E).astype(np.int32),
        rng.integers(1, 30, E).astype(np.int32),
        rng.integers(0, 1_000_000_000, E).astype(np.int32),
        pad,
    )


def stage_us(m, n_lines: int) -> dict:
    """A matcher's host seconds by stage, in microseconds a line."""
    return {k: v * 1e6 / n_lines for k, v in sorted(m.clock.seconds.items())}


def result_key(r):
    return (
        r.error, r.old_line, r.exempted,
        tuple(
            (rr.rule_name, rr.regex_match, rr.skip_host, rr.seen_ip,
             None if rr.rate_limit_result is None else
             (int(rr.rate_limit_result.match_type), rr.rate_limit_result.exceeded))
            for rr in r.rule_results
        ),
    )


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def run(dev, n_rules, batch_lines, max_line_len, capacity, chunks, n_ips,
        n_offenders, offender_hits, chunks_per_call, cross_check_chunks) -> tuple:
    """Every phase on device `dev`; returns the kernels list and a load:
    one launch of kernel A at the single-stage fallback's shape (on the
    current stream, no sync). Raises on any failed check."""
    import numpy as np
    import torch

    from banjax_tpu_torch import native, workload
    from banjax_tpu_torch.config import config_from_yaml_text
    from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
    from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
    from banjax_tpu_torch.effectors.banner import Banner
    from banjax_tpu_torch.matcher import encode
    from banjax_tpu_torch.matcher.kernels import _build, nfa_match, pow_verify, sass_alu
    from banjax_tpu_torch.matcher.kernels import fused_match_window as fmw
    from banjax_tpu_torch.matcher.runner import TorchMatcher

    # ---- phase 1: build (one compiler per source, all at once) ----
    host_libs = native.libraries()
    native_s = _build.build_all(host_libs)
    libs = (nfa_match.KERNEL, fmw.KERNEL, pow_verify.KERNEL)
    build_s = _build.build_all(list(libs)) if dev.type == "cuda" else 0.0
    emit({"phase": "build", "seconds": build_s, "libraries": [str(k.path.name) for k in libs],
          "native_seconds": native_s, "native_libraries": [str(k.path.name) for k in host_libs]})

    # ---- the workload: the JAX package's defaults for the host tier
    # (native parse, native slot manager, sketch on; admission and warm
    # tier off, as the schema defaults them) ----
    patterns = workload.generate_rules(n_rules, seed=SEED)

    def yaml_for(**keys):
        return workload.rules_config(
            patterns, seed=SEED, matcher="tpu", matcher_batch_lines=batch_lines,
            matcher_max_line_len=max_line_len, matcher_device_windows=True,
            matcher_window_capacity=capacity, matcher_prefilter=True,
            pallas_single_kernel="on", **keys,
        )

    yaml_text = yaml_for()
    now = time.time()
    lines = workload.access_log(
        chunks * batch_lines, patterns, now, seed=SEED, n_ips=n_ips,
        n_offenders=n_offenders, offender_hits=offender_hits,
    )
    burst_at = (chunks // 2) * batch_lines
    lines[burst_at:burst_at] = workload.attack_lines(batch_lines, patterns, now, seed=SEED)

    def new_matcher(device, text=yaml_text):
        cfg = config_from_yaml_text(text)
        log = io.StringIO()
        banner = Banner(DynamicDecisionLists(start_sweeper=False), log, io.StringIO())
        m = TorchMatcher(cfg, banner, StaticDecisionLists(cfg), device=device)
        return m, log

    t0 = time.perf_counter()
    matcher, ban_log = new_matcher(dev)
    sync(dev)
    setup_s = time.perf_counter() - t0
    pf = matcher._prefilter
    check(matcher._fw_pipeline is not None, "the fused single-program path is active")

    # ---- phase 2: kernels against their plain versions, on the card ----
    first = lines[:batch_lines]
    rests = [ln.split(" ", 2)[2] for ln in first]
    cls_np, lens_np, host_eval = encode.encode_for_match(matcher.compiled, rests, max_line_len)
    lens_np = np.where(host_eval, 0, lens_np).astype(np.int32)
    cls = torch.from_numpy(np.ascontiguousarray(cls_np, dtype=np.int32)).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    acc1 = nfa_match.accept_words_plain(pf.pre1, cls, lens)
    cand = ((acc1 & pf._fmask) != 0).any(dim=1).cpu().numpy()
    _, K = pf.capacities(batch_lines)
    rows = np.flatnonzero(cand)[:K]
    cls2 = torch.zeros((K, max_line_len), dtype=torch.int32, device=dev)
    lens2 = torch.zeros(K, dtype=torch.int32, device=dev)
    cls2[: rows.size] = cls[torch.from_numpy(rows).to(dev)]
    lens2[: rows.size] = lens[torch.from_numpy(rows).to(dev)]
    sk_cls, sk_lens = skewed_batch(cls_np, pf.pre2.n_classes, 4095, SEED)
    nfa_shapes = {
        "stage1": (pf.pre1, cls, lens),
        "stage2": (pf.pre2, cls2, lens2),
        "single_stage": (matcher._nfa, cls, lens),
        # stage 2's rules on 4,095 lines of skewed length (no group size divides it)
        "skewed_4095": (pf.pre2, torch.from_numpy(sk_cls).to(dev), torch.from_numpy(sk_lens).to(dev)),
    }
    # kernel A's byte-step loop in the SASS of each instantiation a shape runs
    sass = sass_alu.sass_of(nfa_match.KERNEL.path) if dev.type == "cuda" else None
    step_loops = {}
    shape_rows = {}
    for name, (prep, c, ln) in nfa_shapes.items():
        got = nfa_match.accept_words(prep, c, ln)
        want = nfa_match.accept_words_plain(prep, c, ln)
        sync(dev)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(err == 0, f"kernel A ({name}) is bit-identical to its plain version")
        # every instantiation of R, held to the plain version and timed
        by_r = {}
        for R in nfa_match.LINES_PER_THREAD if dev.type == "cuda" else ():
            check(torch.equal(nfa_match.accept_words(prep, c, ln, lines=R), want),
                  f"kernel A ({name}, R={R}) is bit-identical to its plain version")
            by_r[str(R)] = graph_ms(lambda: nfa_match.accept_words(prep, c, ln, lines=R), dev)
        bound, by = nfa_bound_ms(prep, c, ln)
        R = nfa_match.lines_per_thread(prep, int(c.shape[0]), dev)
        key = ("free" if prep.carry_free else "carry", R)
        if sass is not None and key not in step_loops:
            step_loops[key] = sass_alu.count(sass, not prep.carry_free, R)
        alu = step_loops[key]["alu_per_line_byte"] if sass is not None else None
        shape_rows[name] = {
            "lines": int(c.shape[0]), "bytes": int(c.shape[1]), "words": prep.n_words,
            "shards": prep.n_shards, "classes": prep.n_classes,
            "carry": not prep.carry_free, "line_bytes": line_bytes(c, ln), "max_abs_err": err,
            "lines_per_thread": R, "alu_per_line_byte_word": alu,
            "ms": time_ms(lambda: nfa_match.accept_words(prep, c, ln), dev, 20),
            "device_ms": graph_ms(lambda: nfa_match.accept_words(prep, c, ln), dev),
            "device_ms_by_lines_per_thread": by_r,
            "host_enqueue_us": host_enqueue_us(lambda: nfa_match.accept_words(prep, c, ln), dev),
            "plain_ms": time_ms(lambda: nfa_match.accept_words_plain(prep, c, ln), dev, 2),
            "bound_ms": bound, "bound_by": by,
            "alu_bound_ms": None if alu is None else nfa_alu_bound_ms(prep, c, ln, alu),
        }
    emit({"phase": "kernel_nfa_match", "tolerance": 0, "shapes": shape_rows,
          "step_loops": {f"{k}_R{R}": v for (k, R), v in step_loops.items()}})

    scan_rows = {}
    for name, xs_np in scan_shapes(SEED).items():
        xs = [torch.from_numpy(x).to(dev) for x in xs_np]
        got = fmw.window_scan(xs)
        want = fmw.window_scan_plain(xs)
        sync(dev)
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) for g, w in zip(got, want))
        check(err == 0, f"kernel B ({name}) is bit-identical to its plain version")
        E = int(xs[0].shape[0])
        bound, by = scan_bound_ms(E)
        n_seg, longest = segments_of(xs_np[0], xs_np[10])
        scan_rows[name] = {
            "events": E, "segments": n_seg, "longest_segment": longest, "max_abs_err": err,
            "ms": time_ms(lambda: fmw.window_scan(xs), dev, 20),
            "device_ms": graph_ms(lambda: fmw.window_scan(xs), dev),
            "host_enqueue_us": host_enqueue_us(lambda: fmw.window_scan(xs), dev),
            "plain_ms": time_ms(lambda: fmw.window_scan_plain(xs), dev, 2),
            "bound_ms": bound, "bound_by": by,
        }
    emit({"phase": "kernel_window_scan", "tolerance": 0, "shapes": scan_rows})

    # ---- phase 3: the main path, by the native gate (the JAX package's
    # defaults), then by the Python gate (native parse, native slots and
    # the sketch off: the route before the native host tier), on the same
    # lines ----
    calls = [lines[s : s + chunks_per_call * batch_lines]
             for s in range(0, len(lines), chunks_per_call * batch_lines)]
    cross_lines = cross_check_chunks * batch_lines

    def drive_main(m, log, route):
        nfa_match.KERNEL.launches = 0
        fmw.KERNEL.launches = 0
        m.clock.reset()
        head_results, head_log = None, None
        sync(dev)
        t0 = time.perf_counter()
        for k, batch in enumerate(calls):
            if k == 0:
                # the cross-checked chunks form the first call on their own
                res = m.consume_lines(batch[:cross_lines], now_unix=now)
                head_results = [result_key(r) for r in res]
                head_log = log.getvalue()
                batch = batch[cross_lines:]
            m.consume_lines(batch, now_unix=now)
        sync(dev)
        wall = time.perf_counter() - t0
        launches = {"nfa_match": nfa_match.KERNEL.launches, "window_scan": fmw.KERNEL.launches}
        fw = m._fw_pipeline
        n_bans = log.getvalue().count("\n")
        stages = stage_us(m, len(lines))
        emit({
            "phase": "main_path" if route == "native" else "main_path_python_gate",
            "route": route, "rules": n_rules, "lines": len(lines),
            "chunks": -(-len(lines) // batch_lines), "batch_lines": batch_lines,
            "window_slots": capacity, "max_events": m.device_windows.max_events,
            "setup_s": setup_s if route == "native" else None,
            "wall_s": wall, "lines_per_s": len(lines) / wall,
            "gate_us_per_line": stages.get("gate", 0.0) + stages.get("encode", 0.0),
            "host_us_per_line_by_stage": stages,
            "fused_chunks": fw.sk_chunks, "fallback_chunks": fw.sk_fallbacks,
            "ban_log_lines": n_bans, "ip_slots_used": m.device_windows.occupancy,
            "launches": launches,
            "window_state_bytes": 13 * capacity * m.device_windows.n_rules,
            "peak_device_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        })
        # (a CPU rehearsal runs the plain versions and launches nothing)
        check(dev.type != "cuda" or all(v > 0 for v in launches.values()),
              f"every kernel launched on the main path ({route} gate)")
        check(fw.sk_fallbacks >= 1, "the overflow chunk was served by the classic fallback")
        check(fw.sk_chunks >= chunks // 2, "the fused program committed the traffic chunks")
        check(n_bans > 0, "the repeat offenders were banned")
        return launches, head_results, head_log

    launches, head_results, head_log = drive_main(matcher, ban_log, "native")
    check(matcher._native and matcher.device_windows.slotmgr_native
          and matcher.traffic_sketch is not None, "the main path ran the native gate")
    py_matcher, py_log = new_matcher(dev, yaml_for(
        matcher_native_parse=False, slotmgr_native=False, traffic_sketch_enabled=False))
    drive_main(py_matcher, py_log, "python")
    check(py_log.getvalue() == ban_log.getvalue(), "both gate routes wrote the same ban log")
    del py_matcher

    # ---- phase 4: the leading chunks on the CPU (plain versions) ----
    t0 = time.perf_counter()
    cpu_matcher, cpu_log = new_matcher("cpu")
    cpu_res = cpu_matcher.consume_lines(lines[:cross_lines], now_unix=now)
    same_results = [result_key(r) for r in cpu_res] == head_results
    same_log = cpu_log.getvalue() == head_log
    emit({"phase": "cross_check", "lines": cross_lines,
          "ban_log_lines": head_log.count("\n"), "results_identical": same_results,
          "ban_log_identical": same_log, "seconds": time.perf_counter() - t0})
    check(same_results and same_log, "the card's results equal the CPU plain versions'")
    check(head_log.count("\n") > 0, "the cross-checked chunks produced bans")

    # ---- the kernels line ----
    s1, s2 = shape_rows["stage1"], shape_rows["stage2"]
    ev = scan_rows["events_4096"]
    prep, c, ln = nfa_shapes["single_stage"]
    load = lambda: nfa_match.accept_words(prep, c, ln)  # noqa: E731
    return [
        {
            "name": "nfa_match", "route": "cuda",
            "source": "banjax_tpu_torch/csrc/nfa_match.cu",
            "replaces": REPLACES["nfa_match"], "launches": launches["nfa_match"],
            "max_abs_err": max(r["max_abs_err"] for r in shape_rows.values()),
            # one chunk of the main path: the stage-1 and stage-2 launches
            "ms": s1["ms"] + s2["ms"], "plain_ms": s1["plain_ms"] + s2["plain_ms"],
            "device_ms": None if s1["device_ms"] is None else s1["device_ms"] + s2["device_ms"],
            "bound_ms": s1["bound_ms"] + s2["bound_ms"],
            "bound_by": s2["bound_by"], "library_ms": None,
            "shapes": shape_rows,
        },
        {
            "name": "window_scan", "route": "cuda",
            "source": "banjax_tpu_torch/csrc/window_scan.cu",
            "replaces": REPLACES["window_scan"], "launches": launches["window_scan"],
            "max_abs_err": max(r["max_abs_err"] for r in scan_rows.values()),
            "ms": ev["ms"], "device_ms": ev["device_ms"], "plain_ms": ev["plain_ms"],
            "bound_ms": ev["bound_ms"],
            "bound_by": ev["bound_by"], "library_ms": None, "shapes": scan_rows,
        },
    ], load


# ---------------------------------------------------------------- state tiering


def per_ip_bans(log_text: str) -> dict:
    out = {}
    for ln in log_text.splitlines():
        parts = ln.split()
        out.setdefault(parts[1].rstrip(",") if len(parts) > 1 else ln, []).append(ln)
    return out


def sketch_events(sk, dev, batch_lines: int, capacity: int):
    """Device events (kernels and copies) of one chunk's sketch work on
    the card, by torch.profiler: note_assignments of a chunk of fresh
    IPs, then the update. None off the card."""
    if dev.type != "cuda":
        return None
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ips = [f"240.{i >> 16}.{(i >> 8) & 255}.{i & 255}" for i in range(batch_lines)]
    slots = np.arange(batch_lines, dtype=np.int32) % capacity
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sk.note_assignments(ips, slots)
        sk.update(slots, batch_lines)
        sync(dev)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"events": len(names), "kernels": sum(1 for n in names if "emcpy" not in n),
            "copies": sum(1 for n in names if "emcpy" in n)}


def warm_probe_us(warm_capacity: int, n_rules: int, n: int = 20_000) -> dict:
    """Host µs an IP of one `contains_batch` probe of `n` new IPs on a
    fresh warm table of the tiering geometry, then of the same IPs again:
    a first probe of a record faults its page in."""
    from banjax_tpu_torch.native import shm

    tier = shm.create_warm_tier(capacity=warm_capacity, max_rules=n_rules)
    try:
        ips = [f"250.{i >> 16}.{(i >> 8) & 255}.{i & 255}" for i in range(n)]
        out = {}
        for name in ("first_touch", "touched"):
            t0 = time.perf_counter()
            tier.contains_batch(ips)
            out[name] = (time.perf_counter() - t0) * 1e6 / n
        return out
    finally:
        tier.close()


def run_tiering(dev, n_rules, batch_lines, max_line_len, capacity, warm_capacity, chunks,
                repeaters, n_offenders, offender_hits, chunks_per_call, cross_check_chunks,
                cross_check_capacity, sketch_width, hll_p) -> dict:
    """The deploy configuration's state tiering (native gate, native slot
    manager, sketch, slot admission with the derived threshold, warm
    tier) at a deployment's size; then the same lines with admission and
    the warm tier off, and a card-vs-CPU prefix at a small slot table.
    Returns the launches of kernels A and B in the gated run."""
    from collections import Counter

    import torch

    from banjax_tpu_torch import workload
    from banjax_tpu_torch.config import config_from_yaml_text
    from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
    from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
    from banjax_tpu_torch.effectors.banner import Banner
    from banjax_tpu_torch.matcher.kernels import fused_match_window as fmw
    from banjax_tpu_torch.matcher.kernels import nfa_match
    from banjax_tpu_torch.matcher.runner import TorchMatcher
    from banjax_tpu_torch.native import shm

    patterns = workload.generate_rules(n_rules, seed=SEED)
    now = time.time()
    lines = workload.tiering_log(chunks * batch_lines, patterns, now, seed=SEED,
                                 repeaters=repeaters, n_offenders=n_offenders,
                                 offender_hits=offender_hits)

    def new_matcher(device, gated=True, slots=capacity):
        cfg = config_from_yaml_text(workload.rules_config(
            patterns, seed=SEED, matcher="tpu", matcher_batch_lines=batch_lines,
            matcher_max_line_len=max_line_len, matcher_device_windows=True,
            matcher_window_capacity=slots, matcher_prefilter=True,
            pallas_single_kernel="on", matcher_native_parse=True, slotmgr_native=True,
            traffic_sketch_enabled=True, traffic_sketch_depth=4,
            traffic_sketch_width=sketch_width, traffic_sketch_hll_p=hll_p,
            slot_admission_enabled=gated, slot_admission_min_estimate=0,
            warm_tier_enabled=gated, warm_tier_capacity=warm_capacity,
        ))
        log = io.StringIO()
        banner = Banner(DynamicDecisionLists(start_sweeper=False), log, io.StringIO())
        return TorchMatcher(cfg, banner, StaticDecisionLists(cfg), device=device), log

    def drive(m, part, keep=False):
        res = []
        for s in range(0, len(part), chunks_per_call * batch_lines):
            out = m.consume_lines(part[s : s + chunks_per_call * batch_lines], now_unix=now)
            if keep:
                res += [result_key(r) for r in out]
        return res

    # the gated run, timed, its launches counted
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    matcher, ban_log = new_matcher(dev)
    dw = matcher.device_windows
    nfa_match.KERNEL.launches = 0
    fmw.KERNEL.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    drive(matcher, lines)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = {"nfa_match": nfa_match.KERNEL.launches, "window_scan": fmw.KERNEL.launches}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    tiers = dw.tier_counters()
    gated_log = ban_log.getvalue()

    # the same lines with admission and the warm tier off
    ungated, ungated_log = new_matcher(dev, gated=False)
    drive(ungated, lines)
    same_multiset = Counter(gated_log.splitlines()) == Counter(ungated_log.getvalue().splitlines())
    same_per_ip = per_ip_bans(gated_log) == per_ip_bans(ungated_log.getvalue())
    del ungated

    # the prefix on the card and on the CPU, at a small slot table
    t1 = time.perf_counter()
    head = lines[: cross_check_chunks * batch_lines]
    sides = []
    for device in (dev, "cpu"):
        m, log = new_matcher(device, slots=cross_check_capacity)
        res = drive(m, head, keep=True)
        sides.append((res, log.getvalue(), m.device_windows.format_states(),
                      m.traffic_sketch.arrays(), m.device_windows.tier_counters()))
        del m
    card, host = sides
    cross = {
        "results": card[0] == host[0], "ban_log": card[1] == host[1],
        "format_states": card[2] == host[2],
        "sketch": all((card[3][k] == host[3][k]).all() for k in ("cm", "hll", "slot_hash")),
        "tier_counters": card[4] == host[4],
    }

    n_chunks = -(-len(lines) // batch_lines)
    emit({
        "phase": "tiering", "rules": n_rules, "lines": len(lines), "chunks": n_chunks,
        "batch_lines": batch_lines, "repeaters": repeaters,
        "admission_min_estimate": matcher.admission_min_estimate,
        "reduced": {
            "matcher_window_capacity": {"here": capacity, "deploy": "0 (auto-size, up to "
                                        f"{dw.AUTO_MEM_BUDGET_BYTES // (13 * dw.n_rules)} slots)"},
            "warm_tier_capacity": {"here": warm_capacity, "deploy": 1 << 20,
                                   "bytes_here": shm.table_bytes(warm_capacity, dw.n_rules),
                                   "bytes_deploy": shm.table_bytes(1 << 20, dw.n_rules)},
        },
        "wall_s": wall, "lines_per_s": len(lines) / wall,
        "host_us_per_line_by_stage": stage_us(matcher, len(lines)),
        "tier_counters": tiers, "refused_rows_folded": matcher.traffic_sketch.refused_rows_folded,
        "sketch_device_events_per_chunk": sketch_events(matcher.traffic_sketch, dev,
                                                        batch_lines, capacity),
        "launches": launches, "ban_log_lines": gated_log.count("\n"),
        "ban_multiset_equal_ungated": same_multiset, "per_ip_bans_equal_ungated": same_per_ip,
        "cross_check": {"chunks": cross_check_chunks, "slots": cross_check_capacity,
                        "seconds": time.perf_counter() - t1, **cross},
        "peak_device_bytes": peak, "warm_table_bytes": dw._warm.nbytes,
        "warm_probe_us_per_ip": warm_probe_us(warm_capacity, dw.n_rules),
    })
    check(tiers["slot_refusals"] > 0 and tiers["sketch_admissions"] > 0,
          "the admission gate refused and admitted rows")
    check(tiers["eviction_count"] > 0 and tiers["warm_spills"] > 0 and tiers["warm_refills"] > 0,
          "hot-tier state was evicted, spilled and refilled")
    check(gated_log.count("\n") > 0, "the offenders were banned")
    check(same_multiset and same_per_ip,
          "the ban multiset and every IP's ban sequence equal the ungated run's")
    check(all(cross.values()), "the card's tiering equals the CPU plain versions' on the prefix")
    check(dev.type != "cuda" or all(v > 0 for v in launches.values()),
          "every kernel launched on the tiering path")
    return launches


# ---------------------------------------------------------------- the second path


def pow_bound_ms(lanes: int) -> tuple:
    t_bytes = POW_BYTES * lanes / PEAK_BYTES_PER_S
    t_ops = POW_OPS * lanes / PEAK_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def degenerate_payloads() -> list:
    """All zeros, 51 zeros then 0x01, all 0xFF, and four payloads whose
    digest starts with at least 10 zero bits (found by search)."""
    from banjax_tpu_torch.crypto.challenge import count_zero_bits_from_left

    out = [b"\x00" * 52, b"\x00" * 51 + b"\x01", b"\xff" * 52]
    base = bytearray(random.Random(SEED).randbytes(52))
    counter = 0
    while len(out) < 7:
        base[44:52] = counter.to_bytes(8, "big")
        if count_zero_bits_from_left(hashlib.sha256(bytes(base)).digest()) >= 10:
            out.append(bytes(base))
        counter += 1
    return out


def run_kernel_pow(dev, pow_lanes) -> dict:
    """Kernel C against its plain version (tolerance 0) and hashlib."""
    import numpy as np
    import torch

    from banjax_tpu_torch.crypto.challenge import count_zero_bits_from_left
    from banjax_tpu_torch.matcher.kernels import pow_verify, sass_alu

    def hashlib_bits(payloads):
        return [count_zero_bits_from_left(hashlib.sha256(p).digest()) for p in payloads]

    # kernel C's ALU-pipe instructions a lane, from the SASS of the library
    sass = sass_alu.count_pow(sass_alu.sass_of(pow_verify.KERNEL.path)) if dev.type == "cuda" else None
    rng = np.random.default_rng(SEED)
    rows = {}
    host_rate = None
    for lanes in pow_lanes:
        arr = rng.integers(0, 256, (lanes, pow_verify.POW_MESSAGE_BYTES), dtype=np.uint8)
        msg = torch.from_numpy(arr).to(dev)
        got = pow_verify.leading_zero_bits(msg)
        want = pow_verify.leading_zero_bits_plain(msg)
        sync(dev)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(err == 0, f"kernel C ({lanes} lanes) is bit-identical to its plain version")
        head = [arr[i].tobytes() for i in range(min(lanes, 4096))]
        check(got[: len(head)].tolist() == hashlib_bits(head),
              f"kernel C ({lanes} lanes) agrees with hashlib")
        bound, by = pow_bound_ms(lanes)
        rows[str(lanes)] = {
            "lanes": lanes, "max_abs_err": err,
            "ms": time_ms(lambda: pow_verify.leading_zero_bits(msg), dev, 20),
            "device_ms": graph_ms(lambda: pow_verify.leading_zero_bits(msg), dev),
            "host_enqueue_us": host_enqueue_us(lambda: pow_verify.leading_zero_bits(msg), dev),
            "plain_ms": time_ms(lambda: pow_verify.leading_zero_bits_plain(msg), dev, 2),
            "bound_ms": bound, "bound_by": by,
            "alu_bound_ms": None if sass is None else 1e3 * max(
                POW_BYTES * lanes / PEAK_BYTES_PER_S, sass["alu"] * lanes / INT32_OPS_PER_S),
            "message_bytes": int(arr.nbytes),
        }
        if lanes == max(pow_lanes):
            payloads = [arr[i].tobytes() for i in range(lanes)]
            t0 = time.perf_counter()
            hashlib_bits(payloads)
            host_rate = lanes / (time.perf_counter() - t0)
    degenerate = degenerate_payloads()
    got = pow_verify.leading_zero_bits(pow_verify.pack_payloads(degenerate, dev)).tolist()
    check(got == hashlib_bits(degenerate), "kernel C agrees with hashlib on degenerate payloads")
    check(max(got) >= 10, "the degenerate payloads include solutions at the target")
    emit({"phase": "kernel_pow", "tolerance": 0, "shapes": rows,
          "degenerate_bits": got, "sass_per_lane": sass})
    # context only (PyTorch has no SHA-256, so there is no library call)
    emit({"phase": "pow_hashlib_host", "lanes": max(pow_lanes),
          "cookies_per_s": host_rate})
    return rows


def run_pow_dispatch(dev, lane_counts, calls, load=None) -> dict:
    """The wall µs of one verifier `_device_bits` call by the old route
    (pack_payloads → leading_zero_bits → .tolist() on the current stream)
    and by the dispatcher (a card verifier's), in turns (old, new, new,
    old) of `calls` calls after a warm-up, every result held against
    hashlib; the dispatcher's split (filling the slots, the C call, reading
    the counts); and, with `load` (one launch of kernel A, no sync), one
    one-lane call by each route timed alone: with nothing queued (the
    baseline of a single call), behind 20 queued loads, and behind one
    single-thread spin kernel of about the same length (which leaves the
    SMs free: what is left is the wait for the queue). Returns the rows."""
    import torch

    from banjax_tpu_torch.challenge.verifier import DeviceVerifier, cpu_zero_bits
    from banjax_tpu_torch.matcher.kernels import pow_verify

    verifier = DeviceVerifier(batch_max=max(lane_counts), device=dev)
    d = verifier._dispatcher  # None on the CPU, where both routes run the plain version

    def old(payloads):
        return pow_verify.leading_zero_bits(pow_verify.pack_payloads(payloads, dev)).tolist()

    routes = {"old": old, "new": verifier._device_bits}
    rng = random.Random(SEED)

    @contextlib.contextmanager
    def collector_off():
        # A full collection of this process's heap takes ~110-210 ms on
        # the H100 host (`collector` below, PERF.md §7): landing in a
        # 1,000-call turn, it adds as many µs to that turn's mean, whatever
        # the route. As timeit does, the collector is off while a turn is
        # timed.
        gc.disable()
        try:
            yield
        finally:
            gc.enable()

    def per_call_us(fn):
        with collector_off():
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            return 1e6 * (time.perf_counter() - t0) / calls

    # what one full collection of the heap costs here (the phase's rows
    # are timed with the collector off, see collector_off)
    t0 = time.perf_counter()
    gc.collect()
    collector = {"full_collect_ms": 1e3 * (time.perf_counter() - t0),
                 "tracked_objects": len(gc.get_objects())}
    rows = {}
    for lanes in lane_counts:
        batches = [[rng.randbytes(52) for _ in range(lanes)] for _ in range(8)]
        wants = [[cpu_zero_bits(p) for p in b] for b in batches]
        # max_call_us: a turn's longest single call (a stall shows there)
        row = {"lanes": lanes, "old_us": [], "new_us": [], "max_call_us": []}
        for route in ("old", "new", "new", "old"):
            fn = routes[route]
            fn(batches[0])
            got = []
            longest = 0.0
            with collector_off():
                t0 = t_prev = time.perf_counter()
                for k in range(calls):
                    got.append(fn(batches[k % 8]))
                    t = time.perf_counter()
                    longest, t_prev = max(longest, t - t_prev), t
            row[f"{route}_us"].append(1e6 * (t_prev - t0) / calls)
            row["max_call_us"].append(1e6 * longest)
            check(all(g == wants[k % 8] for k, g in enumerate(got)),
                  f"the {route} route agrees with hashlib at {lanes} lanes")
        if d is not None:
            b = batches[0]
            row["new_fill_us"] = per_call_us(lambda: d.fill(b))
            row["new_c_call_us"] = per_call_us(lambda: d.launch(lanes))
            row["new_read_us"] = per_call_us(lambda: d.read(lanes))
            check(d.read(lanes) == wants[0], f"the dispatcher's split agrees at {lanes} lanes")
        rows[str(lanes)] = row

    loaded = []
    if load is not None and d is not None:
        one = [rng.randbytes(52)]
        want = [cpu_zero_bits(one[0])]
        queue = {
            "none": lambda: None,
            "kernel_a": lambda: [load() for _ in range(20)],
            "spin": lambda: torch.cuda._sleep(15_000_000),  # ~7.5 ms of one thread
        }
        for kind, enqueue in queue.items():
            for route in ("old", "new", "new", "old"):
                sync(dev)
                t_load = time.perf_counter()
                enqueue()
                queued = torch.cuda.Event()
                queued.record()
                t0 = time.perf_counter()
                bits = routes[route](one)
                us = 1e6 * (time.perf_counter() - t0)
                pending = not queued.query()
                sync(dev)
                check(bits == want, f"the {route} route agrees with hashlib under load")
                loaded.append({"load": kind, "route": route, "us": us,
                               "load_pending_at_return": pending,
                               "load_ms": 1e3 * (time.perf_counter() - t_load)})
    emit({"phase": "pow_dispatch", "calls": calls, "collector": collector,
          "shapes": rows, "under_load": loaded,
          "load": {"none": "nothing queued",
                   "kernel_a": "20 launches of kernel A at the single-stage fallback's "
                               "shape, queued on the current stream",
                   "spin": "torch.cuda._sleep(15_000_000) on the current stream"}})
    if d is not None:
        for r in rows.values():
            check(sum(r["new_us"]) <= sum(r["old_us"]),
                  f"the dispatcher is no slower than the old route at {r['lanes']} lanes")
        check(all(not r["load_pending_at_return"] for r in loaded if r["route"] == "old"),
              "the old route waited for the queued load")
    return rows


@contextlib.contextmanager
def pinned(now: float, seed=None):
    """Pin time.time/time.time_ns (and, with a seed, the session-id draws)
    for the port's modules, which read them through those names."""
    import secrets

    saved = time.time, time.time_ns, secrets.randbits
    time.time = lambda: now
    time.time_ns = lambda: int(now) * 1_000_000_000
    if seed is not None:
        rng = random.Random(seed)
        secrets.randbits = rng.getrandbits
    try:
        yield
    finally:
        time.time, time.time_ns, secrets.randbits = saved


def solve(cookie: str, bits: int) -> str:
    """solve_challenge_for_testing's search (first counter whose digest
    has >= bits leading zero bits), with the 44-byte prefix hashed once."""
    from banjax_tpu_torch.crypto.challenge import count_zero_bits_from_left

    raw = bytearray(base64.standard_b64decode(cookie))
    prefix = hashlib.sha256(bytes(raw[:44]))
    counter = 0
    while True:
        h = prefix.copy()
        h.update(counter.to_bytes(8, "big"))
        if count_zero_bits_from_left(h.digest()) >= bits:
            break
        counter += 1
    raw[44:52] = counter.to_bytes(8, "big")
    return base64.standard_b64encode(bytes(raw)).decode()


def under_target(cookie: str, bits: int) -> str:
    from banjax_tpu_torch.crypto.challenge import count_zero_bits_from_left

    raw = bytearray(base64.standard_b64decode(cookie))
    for counter in range(1 << 20):
        raw[44:52] = counter.to_bytes(8, "big")
        if count_zero_bits_from_left(hashlib.sha256(bytes(raw[:52])).digest()) < bits:
            return base64.standard_b64encode(bytes(raw)).decode()
    raise RuntimeError("no under-target solution")


def challenge_config(sitewide_host: str):
    """The deploy configuration with two changes: hmac_secret set (the
    deploy file sets challenge_cookie_secret, a key the schema does not
    read, so it would sign with an empty secret) and one host in
    sitewide_sha_inv_list with block."""
    import yaml

    from banjax_tpu_torch.config import config_from_yaml_text, load_pages

    with open("deploy/banjax-config.yaml") as f:
        raw = yaml.safe_load(f)
    raw["hmac_secret"] = "chip-smoke-secret"
    raw["sitewide_sha_inv_list"] = {sitewide_host: "block"}
    return load_pages(config_from_yaml_text(yaml.safe_dump(raw)))


def challenge_stream(cfg, now: int, challengers, solved, under, expired, torn,
                     wrong_binding, offenders, log_ips):
    """The storm as (ip, host, cookie or None, expected) requests; expected
    is (status, X-Banjax-Decision header or None, ShaChallengeResult name,
    wire_ok). Returns (phase A + B, phase C) as lists of per-client blocks:
    A = returning clients and offenders in a seeded shuffle, B = one-shot
    challengers, C = third hits of the failing clients and the clients the
    log path challenged."""
    from banjax_tpu_torch.crypto.challenge import new_challenge_cookie_at

    secret, bits = cfg.hmac_secret, cfg.sha_inv_expected_zero_bits
    ttl = cfg.sha_inv_cookie_ttl_seconds
    threshold = cfg.too_many_failed_challenges_threshold
    ip_of = lambda k: f"100.{(k >> 16) & 255}.{(k >> 8) & 255}.{k & 255}"
    fresh = lambda ip: new_challenge_cookie_at(secret, now + ttl, ip)
    first = (429, None, "ShaChallengeFailedNoCookie", False)
    bad_wire = (429, None, "ShaChallengeFailedBadCookie", False)
    bad_bits = (429, None, "ShaChallengeFailedBadCookie", True)
    passed = (200, "ShaChallengePassed", "ShaChallengePassed", True)

    bounds = {}
    returning = 0
    for kind, n in (("solved", solved), ("under", under), ("expired", expired),
                    ("torn", torn), ("wrong", wrong_binding), ("offender", offenders)):
        bounds[kind] = range(returning, returning + n)
        returning += n
    check(returning <= challengers, "the returning clients are among the challengers")

    blocks_a, blocks_c = [], []
    for kind, ks in bounds.items():
        for k in ks:
            ip = ip_of(k)
            if kind == "solved":
                blocks_a.append([(ip, SHA_HOST, None, first), (ip, SHA_HOST, solve(fresh(ip), bits), passed)])
                continue
            if kind == "offender":
                bad = under_target(fresh(ip), bits)
                block = [(ip, SHA_HOST, None, first)]
                block += [(ip, SHA_HOST, bad, bad_bits)] * (threshold - 1)
                block.append((ip, SHA_HOST, bad, (403, "TooManyFailedChallenges",
                                                  "ShaChallengeFailedBadCookie", True)))
                block.append((ip, SHA_HOST, bad, (403, "ExpiringBlock", None, False)))
                blocks_a.append(block)
                continue
            if kind == "under":
                cookie, exp = under_target(fresh(ip), bits), bad_bits
            elif kind == "expired":
                cookie, exp = new_challenge_cookie_at(secret, now - 10, ip), bad_wire
            elif kind == "torn":
                cookie, exp = fresh(ip)[:40], bad_wire
            else:
                cookie, exp = new_challenge_cookie_at(secret, now + ttl, "192.0.2.1"), bad_wire
            blocks_a.append([(ip, SHA_HOST, None, first), (ip, SHA_HOST, cookie, exp)])
            blocks_c.append([(ip, SHA_HOST, cookie, exp)])
    random.Random(SEED).shuffle(blocks_a)
    blocks_b = [[(ip_of(k), SHA_HOST, None, first)] for k in range(returning, challengers)]
    for j in range(log_ips):
        ip = f"101.0.{j >> 8}.{j & 255}"
        blocks_c.append([
            (ip, LOG_HOST, None, (429, None, "ShaChallengeFailedNoCookie", False)),
            (ip, LOG_HOST, solve(fresh(ip), bits), (200, "ShaChallengePassed", "ShaChallengePassed", True)),
        ])
    return blocks_a + blocks_b, blocks_c, [ip_of(k) for k in bounds["offender"]]


def log_chunk(now: float, lines: int, log_ips: int) -> list:
    """One access-log chunk: each of log_ips IPs hits the deploy's
    challengeme rule once; the rest is benign traffic from other IPs."""
    rng = random.Random(SEED)
    out = [f"{now - 5 + j * 1e-4:f} 101.0.{j >> 8}.{j & 255} GET {LOG_HOST} GET "
           f"/challengeme/{j} HTTP/1.1 Mozilla/5.0 -" for j in range(log_ips)]
    out += [f"{now - 5 + j * 1e-4:f} 102.0.{rng.randrange(64)}.{rng.randrange(256)} GET {LOG_HOST} "
            f"GET /page/{j % 97} HTTP/1.1 Mozilla/5.0 -" for j in range(lines - log_ips)]
    rng.shuffle(out)
    return out


def host_breakdown(state, cfg, now: int, dispatch_s: float, wall: float) -> dict:
    """Where a request's time goes, one thread at a time, after the storm:
    a cookieless first hit through the chain, one verification of one
    lane through the verifier (queue, dispatch, wake-up), and hashlib for
    the same payload."""
    from banjax_tpu_torch.challenge.verifier import cpu_zero_bits
    from banjax_tpu_torch.crypto.challenge import new_challenge_cookie_at, parse_cookie
    from banjax_tpu_torch.httpapi.decision_chain import RequestInfo, decision_for_nginx

    n = 2048
    reqs = [RequestInfo(client_ip=f"103.0.{k >> 8}.{k & 255}", requested_host=SHA_HOST,
                        requested_path="/", client_user_agent="Mozilla/5.0") for k in range(n)]
    t0 = time.perf_counter()
    for r in reqs:
        decision_for_nginx(state, r)
    first_hit_us = 1e6 * (time.perf_counter() - t0) / n
    payloads = [b"".join(parse_cookie(new_challenge_cookie_at(
        cfg.hmac_secret, now + 60, f"104.0.0.{k}"))[:2]) for k in range(256)]
    state.challenge_verifier.submit(payloads[0])
    t0 = time.perf_counter()
    for p in payloads:
        state.challenge_verifier.submit(p)
    dispatch_us = 1e6 * (time.perf_counter() - t0) / len(payloads)
    t0 = time.perf_counter()
    for p in payloads:
        cpu_zero_bits(p)
    hashlib_us = 1e6 * (time.perf_counter() - t0) / len(payloads)
    return {
        "first_hit_us_one_thread": first_hit_us,
        "one_lane_dispatch_us": dispatch_us, "hashlib_us": hashlib_us,
        "dispatch_s_in_storm": dispatch_s, "dispatch_share_of_wall": dispatch_s / wall,
    }


def new_chain(cfg, dev):
    from banjax_tpu_torch.cli import build_decision_chain
    from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
    from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
    from banjax_tpu_torch.effectors.banner import Banner

    banner = Banner(DynamicDecisionLists(start_sweeper=False), io.StringIO(), io.StringIO())
    return build_decision_chain(cfg, banner, StaticDecisionLists(cfg), device=dev)


def run_challenge(dev, challengers, solved, under, expired, torn, wrong_binding,
                  offenders, log_lines, log_ips, threads, cross_check, pow_lanes,
                  dispatch_lanes=CHALLENGE["dispatch_lanes"],
                  dispatch_calls=CHALLENGE["dispatch_calls"], load=None,
                  failure_state_max=None) -> list:
    """Kernel C, its dispatch, the chain under the storm, and the
    cross-check; returns kernel C's entry of the kernels line. Raises on
    any failed check. `load` is `run`'s (the dispatch's loaded rows need
    it); `failure_state_max` replaces the deploy file's bound (for a
    rehearsal at a smaller size)."""
    import torch

    from banjax_tpu_torch.challenge import stats as challenge_stats
    from banjax_tpu_torch.challenge.verifier import cpu_zero_bits
    from banjax_tpu_torch.cli import build_matcher
    from banjax_tpu_torch.crypto.challenge import (
        count_zero_bits_from_left,
        new_challenge_cookie_at,
        solve_challenge_for_testing,
    )
    from banjax_tpu_torch.decisions.model import Decision
    from banjax_tpu_torch.httpapi.decision_chain import RequestInfo, decision_for_nginx
    from banjax_tpu_torch.matcher.kernels import fused_match_window as fmw
    from banjax_tpu_torch.matcher.kernels import nfa_match, pow_verify

    pow_rows = run_kernel_pow(dev, pow_lanes)
    dispatch_rows = run_pow_dispatch(dev, dispatch_lanes, dispatch_calls, load)

    # ---- the stream, made from SEED at a pinned clock ----
    now = int(time.time())
    cfg = challenge_config(SHA_HOST)
    if failure_state_max is not None:
        cfg.challenge_failure_state_max = failure_state_max
    t0 = time.perf_counter()
    head, tail, offender_ips = challenge_stream(
        cfg, now, challengers, solved, under, expired, torn, wrong_binding, offenders, log_ips)
    stream_s = time.perf_counter() - t0
    sample = new_challenge_cookie_at(cfg.hmac_secret, now + 60, "198.51.100.7")
    check(solve(sample, 10) == solve_challenge_for_testing(sample, 10),
          "the stream's solver is solve_challenge_for_testing's search")

    with pinned(float(now)):
        # ---- the chain on the card, fed by a TorchMatcher on its Banner ----
        t0 = time.perf_counter()
        state = new_chain(cfg, dev)
        setup_s = time.perf_counter() - t0
        matcher = build_matcher(cfg, state.banner, state.static_lists, device=dev)
        nfa_match.KERNEL.launches = fmw.KERNEL.launches = 0
        t0 = time.perf_counter()
        matcher.consume_lines(log_chunk(now, log_lines, log_ips), now_unix=float(now))
        sync(dev)
        log_s = time.perf_counter() - t0
        log_launches = {"nfa_match": nfa_match.KERNEL.launches, "window_scan": fmw.KERNEL.launches}
        challenged = sorted(ip for ip, d, _ in state.banner.bans if d == Decision.CHALLENGE)
        check(challenged == sorted(f"101.0.{j >> 8}.{j & 255}" for j in range(log_ips)),
              "the log path challenged exactly the challengeme IPs")

        # each IP's requests stay on one thread, in order
        per_thread = [[] for _ in range(threads)]
        thread_of = {}
        for blocks in (head, tail):
            for block in blocks:
                ip = block[0][0]
                per_thread[thread_of.setdefault(ip, len(thread_of) % threads)].extend(block)
        n_requests = sum(len(t) for t in per_thread)
        reqs = [[(RequestInfo(client_ip=ip, requested_host=host, requested_path="/",
                              client_user_agent="Mozilla/5.0",
                              cookies={} if c is None else {"deflect_challenge3": c}), c, exp)
                 for ip, host, c, exp in t] for t in per_thread]
        outcomes = [None] * threads
        errors = []

        def worker(i):
            try:
                out = []
                for req, _, _ in reqs[i]:
                    resp, result = decision_for_nginx(state, req)
                    sha = result.sha_challenge_result
                    out.append((resp.status, resp.headers.get("X-Banjax-Decision"),
                                None if sha is None else str(sha)))
                outcomes[i] = out
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        # wall time inside the verifier's dispatches (kernel C and the
        # host steps around it), summed over the leaders, and every lane's
        # payload and count, held against hashlib below
        v_obj, dispatch_s, dispatched = state.challenge_verifier, [0.0], []
        device_bits = v_obj._device_bits

        def timed_bits(payloads):
            t = time.perf_counter()
            try:
                bits = device_bits(payloads)
                dispatched.append((list(payloads), list(bits)))
                return bits
            finally:
                dispatch_s[0] += time.perf_counter() - t

        v_obj._device_bits = timed_bits
        challenge_stats.get_stats().reset()
        pow_verify.KERNEL.launches = 0
        workers = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
        sync(dev)
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        sync(dev)
        wall = time.perf_counter() - t0
        launches = pow_verify.KERNEL.launches
        v_obj._device_bits = device_bits
        v = v_obj.counters()
        stats = challenge_stats.get_stats().snapshot()
        fs = state.failed_challenge_states.counters()
        banned = sorted(ip for ip, d, _ in state.banner.bans if d == Decision.IPTABLES_BLOCK)
        ban_log = state.banner._ban_log.getvalue()
        breakdown = host_breakdown(state, cfg, now, dispatch_s[0], wall)
    check(not errors, f"no request raised: {errors[:3]}")

    # ---- checks ----
    mismatches, wire_ok, oracle_checked = [], 0, 0
    bits = cfg.sha_inv_expected_zero_bits
    for t in range(threads):
        for (req, cookie, exp), got in zip(reqs[t], outcomes[t]):
            status, header, sha_name, ok_wire = exp
            wire_ok += ok_wire
            if ok_wire:
                raw = base64.standard_b64decode(cookie)
                accept = count_zero_bits_from_left(hashlib.sha256(raw[:52]).digest()) >= bits
                check(accept == (sha_name == "ShaChallengePassed"), "the stream's oracle")
                oracle_checked += 1
            if got != (status, header, sha_name):
                mismatches.append((req.client_ip, got, exp))
    verifications = stats["verifications"]
    on_card = verifications.get("accept/device", 0) + verifications.get("reject/device", 0)
    lanes = [(p, b) for payloads, bits in dispatched for p, b in zip(payloads, bits)]
    count_mismatches = sum(b != cpu_zero_bits(p) for p, b in lanes)
    emit({
        "phase": "challenge_path",
        "config": "deploy/banjax-config.yaml with hmac_secret set and "
                  f"sitewide_sha_inv_list {{{SHA_HOST}: block}}; clock pinned",
        "requests": n_requests, "threads": threads, "challengers": challengers,
        "stream_setup_s": stream_s, "chain_setup_s": setup_s,
        "wall_s": wall, "requests_per_s": n_requests / wall,
        "log_chunk_lines": log_lines, "log_chunk_s": log_s, "log_chunk_launches": log_launches,
        "verifications_on_card": on_card, "wire_ok_verifications": wire_ok,
        "verifications": verifications, "dispatches": v["dispatches"],
        "mean_lanes_per_dispatch": v["lanes_verified"] / max(1, v["dispatches"]),
        "batch_size_counts": stats["batch_size_counts"],
        "launches": launches, "faults": v["faults"],
        "lanes_checked_by_hashlib": len(lanes), "count_mismatches": count_mismatches,
        "failure_state": fs,
        "bans": len(banned), "ban_log_lines": ban_log.count("\n"),
        "response_mismatches": len(mismatches), "first_mismatches": mismatches[:3],
        "breakdown": breakdown,
    })
    check(not mismatches, "every response is the expected one (accept/reject by hashlib)")
    check(oracle_checked == wire_ok > 0, "every wire-valid cookie was checked by hashlib")
    check(v["faults"] == 0, "no fault")
    check(len(lanes) == v["lanes_verified"] == on_card and count_mismatches == 0,
          "every lane the storm dispatched has hashlib's bit count")
    check(dev.type != "cuda" or (on_card == wire_ok and launches > 0),
          "every verification that passed the wire checks ran on the card")
    check(banned == sorted(offender_ips), "the offenders, and only they, are banned")
    check(ban_log.count("\n") == len(offender_ips) + log_ips, "one ban-log line per ban")
    check(fs["entries"] <= cfg.challenge_failure_state_max and fs["evictions_total"] > 0
          and fs["spill_writes"] > 0 and fs["spill_refills"] > 0,
          "the failure state held its bound and evicted, spilled and refilled")

    # ---- cross-check: a prefix on the card and on the CPU ----
    prefix = [r for block in head for r in block][:cross_check]
    runs = []
    t0 = time.perf_counter()
    for d in (dev, torch.device("cpu")):
        with pinned(float(now), seed=SEED):
            st = new_chain(cfg, d)
            out = []
            for ip, host, c, _ in prefix:
                resp, result = decision_for_nginx(st, RequestInfo(
                    client_ip=ip, requested_host=host, requested_path="/",
                    client_user_agent="Mozilla/5.0",
                    cookies={} if c is None else {"deflect_challenge3": c}))
                out.append((resp.status, resp.headers, [vars(x) for x in resp.cookies],
                            resp.content_type, resp.body, result.to_json()))
            dyn = st.dynamic_lists.format_ip_entries()
            runs.append((out, st.banner._ban_log.getvalue(), st.banner._ban_log_temp.getvalue(),
                         st.failed_challenge_states.format_states(),
                         sorted((ip, int(e.decision), e.expires, e.domain) for ip, e in dyn.items()),
                         st.challenge_verifier.lanes_verified))
    same = {
        "responses": runs[0][0] == runs[1][0],
        "ban_log": runs[0][1:3] == runs[1][1:3],
        "failure_states": runs[0][3] == runs[1][3],
        "dynamic_lists": runs[0][4] == runs[1][4],
    }
    emit({"phase": "challenge_cross_check", "requests": len(prefix),
          "ban_log_lines": runs[0][1].count("\n"), "verified_lanes": runs[0][5],
          "identical": same, "seconds": time.perf_counter() - t0})
    check(all(same.values()), "the card's chain equals the CPU chain on the prefix")
    check(runs[0][1].count("\n") > 0 and runs[0][5] > 0,
          "the cross-checked prefix verified cookies and banned")

    main_row = pow_rows[str(min(pow_lanes))]
    one_lane = dispatch_rows[str(min(dispatch_lanes))]
    return [{
        "name": "pow_verify", "route": "cuda",
        "source": "banjax_tpu_torch/csrc/pow_verify.cu",
        "replaces": REPLACES["pow_verify"], "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in pow_rows.values()),
        # the storm's dispatches are mostly of one lane (batch_size_counts)
        "ms": main_row["ms"], "device_ms": main_row["device_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        # one verifier dispatch of one lane through the PowDispatcher
        "dispatch_us": sum(one_lane["new_us"]) / len(one_lane["new_us"]),
        "library_ms": None, "shapes": pow_rows,
    }]


# ------------------------------------------------------------- the service


class HttpClient:
    """One keep-alive HTTP/1.1 connection; `get` returns the raw response
    (head and body, read by its Content-Length)."""

    def __init__(self, port: int):
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=60)
        self.buf = b""

    def get(self, ip: str, host: str, cookie=None) -> bytes:
        head = (f"GET /auth_request HTTP/1.1\r\nHost: {host}\r\nX-Client-IP: {ip}\r\n"
                f"X-Requested-Host: {host}\r\nX-Requested-Path: /\r\n"
                "X-Client-User-Agent: Mozilla/5.0\r\n")
        if cookie is not None:
            head += f"Cookie: deflect_challenge3={cookie}\r\n"
        self.sock.sendall((head + "\r\n").encode())
        while b"\r\n\r\n" not in self.buf:
            self._recv()
        end = self.buf.index(b"\r\n\r\n") + 4
        clen = 0
        for line in self.buf[:end].split(b"\r\n"):
            if line.lower().startswith(b"content-length:"):
                clen = int(line.split(b":", 1)[1])
        while len(self.buf) < end + clen:
            self._recv()
        raw, self.buf = self.buf[: end + clen], self.buf[end + clen:]
        return raw

    def _recv(self) -> None:
        chunk = self.sock.recv(1 << 16)
        if not chunk:
            raise RuntimeError("the server closed a keep-alive connection")
        self.buf += chunk

    def close(self) -> None:
        self.sock.close()


# fresh session and challenge randomness, and the cookies' expiry
# (tests/test_torch_serve.py masks the same way)
RESPONSE_MASKS = (
    (rb"(X-Deflect-Session: )(\S+)", rb"\1MASKED"),
    (rb"(deflect_session=)([^;\r\n]+)", rb"\1MASKED"),
    (rb"(deflect_challenge3=)([^;\r\n]+)", rb"\1MASKED"),
    (rb"[A-Za-z0-9+/=]{40,}", rb"MASKEDB64"),
)


def masked(raw: bytes) -> bytes:
    import re

    for pat, repl in RESPONSE_MASKS:
        raw = re.sub(pat, repl, raw)
    return raw


def service_config(workdir: str, patterns, capacity: int, warm_capacity: int,
                   batch_lines: int, name: str, **keys) -> str:
    """The deploy file with its log paths moved into `workdir`, hmac_secret
    set and SHA_HOST in sitewide_sha_inv_list (as `challenge_config`), the
    generated rules, and the cuts of `tiering` (slots, warm records), then
    `keys`; returns the path of the YAML written."""
    import os

    import yaml

    from banjax_tpu_torch import workload

    with open("deploy/banjax-config.yaml") as f:
        raw = yaml.safe_load(f)
    raw.update(
        regexes_with_rates=yaml.safe_load(
            workload.rules_config(patterns, seed=SEED))["regexes_with_rates"],
        matcher_window_capacity=capacity, warm_tier_capacity=warm_capacity,
        matcher_batch_lines=batch_lines,
        server_log_file=os.path.join(workdir, name + ".log"),
        banning_log_file=os.path.join(workdir, name + ".bans"),
        metrics_log_file=os.path.join(workdir, name + ".metrics"),
        hmac_secret="chip-smoke-secret", sitewide_sha_inv_list={SHA_HOST: "block"},
        standalone_testing=False,
    )
    raw.update(keys)
    open(raw["server_log_file"], "a").close()
    path = os.path.join(workdir, name + ".yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def percentile(xs, q: float):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None


def stamped(part, t=None):
    """A write's lines stamped over the second before `t` (now by default)."""
    t = time.time() if t is None else t
    return [f"{t - 1 + j / len(part):.6f} {x}" for j, x in enumerate(part)]


_FAKE_IPSET = """#!/bin/sh
# a stand-in for ipset(8): the set lives in a file, nothing reaches the kernel
S='{state}'
echo "ipset $*" >> "$S/calls"
case "$1" in
  create) touch "$S/members"; exit 0 ;;
  add) grep -qx "$3" "$S/members" 2>/dev/null || echo "$3" >> "$S/members"; exit 0 ;;
  test) grep -qx "$3" "$S/members" 2>/dev/null; exit $? ;;
  del) grep -vx "$3" "$S/members" > "$S/members.tmp"; mv "$S/members.tmp" "$S/members"; exit 0 ;;
  list) echo "Name: $2"; echo "Type: hash:ip"; echo "Members:"
        sed 's/$/ timeout 600/' "$S/members"; exit 0 ;;
esac
exit 1
"""

_FAKE_IPTABLES = """#!/bin/sh
# a stand-in for iptables(8): the rule lives in a file, nothing reaches the kernel
S='{state}'
echo "iptables $*" >> "$S/calls"
case "$1" in
  -C) [ -s "$S/rules" ]; exit $? ;;
  -I) echo "$*" >> "$S/rules"; exit 0 ;;
esac
exit 1
"""


class FakeNetlinkSocket:
    """Stands in for the netlink batch writer's AF_NETLINK socket: each
    IPSET_CMD_ADD message of a send goes into the fake set's file (so the
    fake `ipset test`/`list` see it, as the kernel's set would show a
    netlink add) and is acked; nothing is sent anywhere."""

    def __init__(self, edge):
        self.edge = edge
        self.entries = []  # (ip, timeout) per message, in order
        self._acks = b""

    def send(self, buf: bytes) -> int:
        import socket
        import struct

        from banjax_tpu_torch.effectors import ipset_netlink as nl

        acks, off = [], 0
        while off + nl.NLMSG_HDRLEN <= len(buf):
            length, _, _, seq, _ = struct.unpack_from("=IHHII", buf, off)
            msg = buf[off : off + length]
            ip = socket.inet_ntoa(msg[-12:-8])
            self.entries.append((ip, struct.unpack(">I", msg[-4:])[0]))
            self.edge.add_member(ip)
            acks.append(struct.pack("=IHHII", 20, nl.NLMSG_ERROR, 0, seq, 0) + struct.pack("=i", 0))
            off += (length + 3) & ~3
        self._acks = b"".join(acks)
        return len(buf)

    def recv(self, _n: int) -> bytes:
        out, self._acks = self._acks, b""
        return out

    def close(self) -> None:
        pass


class FakeKernelEdge:
    """The kernel edge without the kernel: `ipset` and `iptables` scripts
    under `root/bin`, put first on PATH for this process and its children
    (restored by `close`), keeping the set and the DROP rule in files under
    `root/state`; and a `FakeNetlinkSocket` swapped into each app's batch
    writer before its first ban. No ipset or iptables command and no
    netlink message of the smoke run reaches the machine's kernel."""

    def __init__(self, root: str):
        import os
        import shutil
        import threading as _threading

        self.state = os.path.join(root, "state")
        bin_dir = os.path.join(root, "bin")
        for d in (self.state, bin_dir):
            os.makedirs(d, exist_ok=True)
        for name, text in (("ipset", _FAKE_IPSET), ("iptables", _FAKE_IPTABLES)):
            path = os.path.join(bin_dir, name)
            with open(path, "w") as f:
                f.write(text.format(state=self.state))
            os.chmod(path, 0o755)
        self._old_path = os.environ.get("PATH", "")
        os.environ["PATH"] = bin_dir + os.pathsep + self._old_path
        for name in ("ipset", "iptables"):
            check(shutil.which(name) == os.path.join(bin_dir, name),
                  f"the fake {name} comes first on PATH")
        self._lock = _threading.Lock()

    def add_member(self, ip: str) -> None:
        import os

        with self._lock:
            path = os.path.join(self.state, "members")
            have = set(open(path).read().split()) if os.path.exists(path) else set()
            if ip not in have:
                with open(path, "a") as f:
                    f.write(ip + "\n")

    def attach(self, app) -> FakeNetlinkSocket:
        """The app's batch writer sends to a fake socket from here on."""
        check(app.ipset_writer is not None and app.banner.ipset_batching,
              "the app built its netlink batch writer")
        sock = FakeNetlinkSocket(self)
        app.ipset_writer._socket = lambda: sock
        return sock

    def calls(self) -> list:
        import os

        path = os.path.join(self.state, "calls")
        return open(path).read().splitlines() if os.path.exists(path) else []

    def close(self) -> None:
        import os

        os.environ["PATH"] = self._old_path


def kernel_edge_check(app, sock, ban_log: str, timeout_s: float) -> dict:
    """The IPs the app's bans added to the (fake) kernel set must be the
    ban log's IptablesBlock IPs; /is_banned must list one of them and not
    an NginxBlock IP. Returns the figures for the phase's line."""
    rows = [json.loads(r) for r in ban_log.splitlines() if r]
    blocked = {r["client_ip"] for r in rows if r["action"] == "IptablesBlock"} - {"127.0.0.1"}
    nginx = sorted({r["client_ip"] for r in rows if r["action"] == "NginxBlock"} - blocked)
    wait_for(lambda: app.ipset_writer.queue_depth() == 0
             and {ip for ip, _ in sock.entries} >= blocked
             and app.ipset_stats.prom_snapshot()["batch_entries_total"] == len(sock.entries),
             "the ipset adds", timeout_s)
    added = {ip for ip, _ in sock.entries}
    stats = app.ipset_stats.prom_snapshot()
    _, yes = http_json(app.port, "GET", f"/is_banned?ip={min(blocked)}") if blocked else (0, {})
    _, no = http_json(app.port, "GET", f"/is_banned?ip={nginx[0]}") if nginx else (0, {})
    listed = lambda body: {e.split(" ", 1)[0] for e in body.get("banned") or []}  # noqa: E731
    out = {"iptables_block_ips": len(blocked), "nginx_block_ips": len(nginx),
           "ipset_adds": len(sock.entries), "ipset_stats": stats,
           "is_banned_blocked": bool(blocked) and min(blocked) in listed(yes),
           "is_banned_nginx": bool(nginx) and nginx[0] in listed(no)}
    check(blocked and nginx, "the ban log has IptablesBlock and NginxBlock IPs")
    check(added == blocked, f"the ipset adds are the ban log's IptablesBlock IPs: {out}")
    check(stats["fallback_total"] == stats["errors_total"] == stats["queue_shed_total"] == 0
          and stats["batch_entries_total"] == len(sock.entries),
          f"every add went through the netlink batches: {stats}")
    check(out["is_banned_blocked"] and not out["is_banned_nginx"],
          "/is_banned lists an IptablesBlock IP and not an NginxBlock IP")
    return out


def wait_for(cond, what: str, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise RuntimeError(f"timed out waiting for {what}")
        time.sleep(0.0005)


def append_lines(path: str, lines) -> None:
    with open(path, "a") as f:
        f.write("\n".join(lines) + "\n")


def run_service(dev, n_rules, batch_lines, capacity, warm_capacity, writes, rotate_after,
                n_offenders, offender_hits, threads, per_kind, cross_check, warmup_lines,
                edge, alone_requests=256, timeout_s=300.0):
    """The service on device `dev`: `BanjaxApp` from the deploy file tails
    an access log (the writes, one rotation), bans into its ban log and
    decision table, and answers `/auth_request` on an ephemeral port to
    `threads` keep-alive clients; then a reload; then the same lines
    through `TorchMatcher.consume_lines` directly, and a prefix of the
    requests replayed into a `device="cpu"` app. Returns the phase's
    launches of kernels A, B and C, and what the `pipeline` phase sets
    beside its own figures (lines/s, latency, the request prefix and its
    answers). Raises on any failed check."""
    import os
    import tempfile
    import weakref

    import torch

    from banjax_tpu_torch import workload
    from banjax_tpu_torch.cli import BanjaxApp, build_matcher
    from banjax_tpu_torch.crypto.challenge import new_challenge_cookie_at
    from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
    from banjax_tpu_torch.decisions.model import Decision
    from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
    from banjax_tpu_torch.effectors.banner import Banner
    from banjax_tpu_torch.matcher.kernels import fused_match_window as fmw
    from banjax_tpu_torch.matcher.kernels import nfa_match, pow_verify

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    workdir_obj = tempfile.TemporaryDirectory(prefix="service-", dir=os.path.join(here, "build"))
    workdir = workdir_obj.name
    patterns = workload.generate_rules(n_rules, seed=SEED)
    cfg_path = service_config(workdir, patterns, capacity, warm_capacity, batch_lines, "card")
    log_path = os.path.join(workdir, "card.log")

    # the stream: generated traffic with the offenders' lines among it; each
    # write is stamped with the second before its append
    stream = workload.access_log(writes * batch_lines, patterns, time.time(), seed=SEED + 1,
                                 n_offenders=n_offenders, offender_hits=offender_hits)
    stream = [ln.split(" ", 1)[1] for ln in stream]  # "<ip> <rest>"
    offenders = {f"203.0.{k // 250}.{k % 250 + 1}" for k in range(n_offenders)}
    warm = [f"104.0.0.{j % 250 + 1} GET {LOG_HOST} GET /warm/{j} HTTP/1.1 Mozilla/5.0 -"
            for j in range(warmup_lines)]

    def wait(cond, what):
        wait_for(cond, what, timeout_s)

    def append(lines):
        append_lines(log_path, lines)

    nfa_match.KERNEL.launches = fmw.KERNEL.launches = pow_verify.KERNEL.launches = 0
    t0 = time.perf_counter()
    app = BanjaxApp(cfg_path, device=dev)
    sock = edge.attach(app)
    # every batch the tailer hands over: its lines, the clock then, the
    # write it came from, when it was consumed, and the bans it made
    batches, current = [], [None]
    inner = app.tailer.on_lines

    def recording(batch):
        t_in, b0 = time.time(), len(app.banner.bans)
        inner(batch)
        batches.append((batch, t_in, current[0], time.time(), app.banner.bans[b0:]))

    app.tailer.on_lines = recording
    app.start_background(port=0)
    setup_s = time.perf_counter() - t0
    cpu_app = None
    try:
        check(app.port not in (None, 0, 8081), "the app listens on an ephemeral port")
        wait(app.tailer.opened.is_set, "the tailer to open the log")
        consumed = lambda: sum(len(b[0]) for b in batches)  # noqa: E731

        # warm-up: the first batch builds the matcher on the tailer thread
        t_w = time.perf_counter()
        append(stamped(warm))
        wait(lambda: consumed() >= len(warm), "the warm-up batch")
        first_build_s = time.perf_counter() - t_w

        # ---- the log path: the writes, one rotation ----
        appended_at = {}
        done = len(warm)
        app._matcher.clock.reset()
        t_log = time.perf_counter()
        for k in range(writes):
            lines = stamped(stream[k * batch_lines : (k + 1) * batch_lines])
            current[0] = k
            appended_at[k] = time.time()
            append(lines)
            done += len(lines)
            wait(lambda: consumed() >= done, f"write {k + 1}")
            if k + 1 == rotate_after:
                os.replace(log_path, log_path + ".1")
                open(log_path, "w").close()
        log_wall = time.perf_counter() - t_log
        log_batches = list(batches)
        stages = stage_us(app._matcher, writes * batch_lines)
        # each write: append -> first read, each batch's consume, append -> done
        first_read, write_ms = {}, {}
        for _, t_in, k, t_done, _ in log_batches:
            if k is not None:
                first_read.setdefault(k, t_in - appended_at[k])
                write_ms[k] = 1e3 * (t_done - appended_at[k])
        consume_ms = [1e3 * (t_done - t_in) for _, t_in, k, t_done, _ in log_batches if k is not None]
        with open(app.banner._ban_log.name) as f:
            app_ban_log = f.read()
        latency = {}
        for _, _, k, t_done, bans in log_batches:
            for ip, _, _ in bans:
                if ip in offenders and ip not in latency and k is not None:
                    latency[ip] = t_done - appended_at[k]
        check(app.tailer.errors == 0, f"no tailer error ({app.tailer.last_error!r})")
        check(len(latency) == len(offenders), "every offender was banned by the log path")
        kernel_edge = kernel_edge_check(app, sock, app_ban_log, timeout_s)
        # batches over the deploy file's matcher_latency_budget_ms (counted,
        # not breaker failures in the port)
        budget_trips = app._matcher.budget_trips

        # ---- /auth_request: log-path bans (fast-path hits), cookieless
        # challengers and solved cookies (the chain, kernel C) ----
        entries = app.dynamic_lists.format_ip_entries()
        blocked = sorted(ip for ip, e in entries.items()
                         if e.decision in (Decision.NGINX_BLOCK, Decision.IPTABLES_BLOCK))
        challenged = sorted(ip for ip, e in entries.items() if e.decision == Decision.CHALLENGE)
        check(blocked and challenged, "the log path both blocked and challenged")
        now = int(time.time())
        secret, bits = app.config_holder.get().hmac_secret, app.config_holder.get().sha_inv_expected_zero_bits
        t_s = time.perf_counter()
        solved = []
        for j in range(per_kind):
            ip = f"106.{j >> 16}.{(j >> 8) & 255}.{j & 255}"
            solved.append((ip, SHA_HOST, solve(new_challenge_cookie_at(secret, now + 3600, ip), bits), 200))
        solve_s = time.perf_counter() - t_s
        kinds = [
            [(blocked[j % len(blocked)], LOG_HOST, None, 403) for j in range(per_kind)],
            [(ip, LOG_HOST, None, 429) for ip in challenged],
            [(f"105.{j >> 16}.{(j >> 8) & 255}.{j & 255}", SHA_HOST, None, 429)
             for j in range(per_kind)],
            solved,
        ]
        flat = [kind[j] for j in range(max(map(len, kinds))) for kind in kinds if j < len(kind)]
        thread_of, per_thread = {}, [[] for _ in range(threads)]
        for i, req in enumerate(flat):
            per_thread[thread_of.setdefault(req[0], len(thread_of) % threads)].append((i, req))
        answers = [None] * len(flat)
        errors = []

        def client(reqs):
            try:
                c = HttpClient(app.port)
                try:
                    for i, (ip, host, cookie, _) in reqs:
                        answers[i] = c.get(ip, host, cookie)
                finally:
                    c.close()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        workers = [threading.Thread(target=client, args=(r,)) for r in per_thread]
        stats0 = app.serve_stats.snapshot()
        t_r = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout_s)
        req_wall = time.perf_counter() - t_r
        check(not errors and all(not w.is_alive() for w in workers), f"no client failed: {errors[:3]}")
        stats = app.serve_stats.snapshot()
        statuses = [int(a.split(b" ", 2)[1]) for a in answers]
        wrong = [(flat[i][:2], statuses[i], flat[i][3]) for i in range(len(flat))
                 if statuses[i] != flat[i][3]]
        hits = stats["hits_total"] - stats0["hits_total"]
        misses = stats["misses_total"] - stats0["misses_total"]

        # one client alone, request by request: where a request's time goes
        alone = {}
        alone_reqs = {
            "fast_path_block": [(blocked[j % len(blocked)], LOG_HOST, None)
                                for j in range(alone_requests)],
            "chain_cookieless": [(f"107.0.{j >> 8}.{j & 255}", SHA_HOST, None)
                                 for j in range(alone_requests)],
            "chain_solved_kernel_c": [
                (ip, SHA_HOST, solve(new_challenge_cookie_at(secret, now + 3600, ip), bits))
                for ip in (f"108.0.{j >> 8}.{j & 255}" for j in range(alone_requests))],
        }
        c = HttpClient(app.port)
        try:
            for kind, reqs in alone_reqs.items():
                us = []
                for ip, host, cookie in reqs:
                    t_q = time.perf_counter()
                    c.get(ip, host, cookie)
                    us.append(1e6 * (time.perf_counter() - t_q))
                alone[kind] = {"p50_us": percentile(us, 0.5), "p99_us": percentile(us, 0.99)}
        finally:
            c.close()

        # ---- reload: the matcher is closed, then rebuilt on the next batch ----
        mem = {}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            mem["before_reload"] = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        gen0 = app._matcher_generation
        old_matcher = weakref.ref(app._matcher)
        app.reload()
        current[0] = None
        target = consumed() + batch_lines
        append(stamped(stream[:batch_lines]))
        wait(lambda: consumed() >= target, "the batch after the reload")
        check(app._matcher_generation == gen0 + 1, "the reload rebuilt the matcher")
        check(old_matcher() is None, "the old matcher was released before the new one")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            mem["after_reload"] = torch.cuda.memory_allocated(dev)
            mem["peak_across_reload"] = torch.cuda.max_memory_allocated(dev)
        launches = {"nfa_match": nfa_match.KERNEL.launches, "window_scan": fmw.KERNEL.launches,
                    "pow_verify": pow_verify.KERNEL.launches}
        check(app.tailer.errors == 0, f"no tailer error ({app.tailer.last_error!r})")
        tailer_errors = app.tailer.errors
    finally:
        app.stop_background()

    # ---- the same batches through TorchMatcher.consume_lines directly ----
    t_d = time.perf_counter()
    cfg = app.config_holder.get()
    direct_log = io.StringIO()
    direct = build_matcher(cfg, Banner(DynamicDecisionLists(start_sweeper=False), direct_log,
                                       io.StringIO()), StaticDecisionLists(cfg), device=dev)
    for batch, t_in, _, _, _ in log_batches:
        direct.consume_lines(batch, now_unix=t_in)
    direct.close()
    del direct
    direct_s = time.perf_counter() - t_d

    # ---- a prefix of the requests, replayed into an app on the CPU ----
    t_c = time.perf_counter()
    cpu_app = BanjaxApp(service_config(workdir, patterns, capacity, warm_capacity, batch_lines,
                                       "cpu"), device="cpu")
    edge.attach(cpu_app)
    try:
        for ip, e in entries.items():
            cpu_app.dynamic_lists.update(ip, e.expires, e.decision, e.from_baskerville, e.domain)
        cpu_app.start_background(port=0)
        check(cpu_app.port not in (None, 0, 8081, app.port), "the CPU app has its own port")
        c = HttpClient(cpu_app.port)
        try:
            cpu_answers = [c.get(ip, host, cookie) for ip, host, cookie, _ in flat[:cross_check]]
        finally:
            c.close()
        cpu_stats = cpu_app.serve_stats.snapshot()
    finally:
        cpu_app.stop_background()
    replay_diff = [i for i in range(len(cpu_answers))
                   if masked(cpu_answers[i]) != masked(answers[i])]
    cross_s = time.perf_counter() - t_c
    workdir_obj.cleanup()

    lat = sorted(latency.values())
    emit({
        "phase": "service",
        "config": "deploy/banjax-config.yaml (paths in a temp dir, standalone_testing false) "
                  f"with {n_rules} generated rules, {capacity} slots, {warm_capacity} warm records, "
                  f"hmac_secret set, sitewide_sha_inv_list {{{SHA_HOST}: block}}",
        "setup_s": setup_s, "first_batch_with_matcher_build_s": first_build_s,
        "writes": writes, "lines": writes * batch_lines, "rotation_after_write": rotate_after,
        "tailer_batches": len(log_batches) - 1, "log_wall_s": log_wall,
        "lines_per_s": writes * batch_lines / log_wall,
        "append_to_first_read_ms": {"p50": 1e3 * percentile(list(first_read.values()), 0.5),
                                    "max": 1e3 * max(first_read.values())},
        "consume_ms_per_batch": {"p50": percentile(consume_ms, 0.5), "max": max(consume_ms)},
        "append_to_consumed_ms_by_write": [write_ms[k] for k in sorted(write_ms)],
        "host_us_per_line_by_stage": stages,
        "offenders": len(offenders), "line_to_ban_ms": {
            "p50": 1e3 * percentile(lat, 0.5), "p99": 1e3 * percentile(lat, 0.99),
            "min": 1e3 * lat[0], "max": 1e3 * lat[-1]},
        "ban_log_lines": app_ban_log.count("\n"), "direct_ban_log_identical":
            direct_log.getvalue() == app_ban_log, "direct_replay_s": direct_s,
        "requests": len(flat), "threads": threads, "solve_s": solve_s,
        "mix": {"log_path_blocked": per_kind, "log_path_challenged": len(challenged),
                "cookieless_challengers": per_kind, "solved_cookies": per_kind},
        "request_wall_s": req_wall, "requests_per_s": len(flat) / req_wall,
        "one_client_alone": alone,
        "wrong_statuses": len(wrong), "first_wrong": wrong[:3],
        "fastpath_hits": hits, "fastpath_misses": misses, "serve_stats": stats,
        "launches": launches, "device_memory_bytes": mem, "tailer_errors": tailer_errors,
        "budget_trips": budget_trips, "kernel_edge": kernel_edge,
        "cpu_replay": {"requests": len(cpu_answers), "differing": len(replay_diff),
                       "first_differing": replay_diff[:3], "seconds": cross_s,
                       "fastpath_hits": cpu_stats["hits_total"]},
    })
    check(not wrong, "every response has its expected status")
    check(direct_log.getvalue() == app_ban_log and app_ban_log.count("\n") > 0,
          "the tailed ban log equals TorchMatcher.consume_lines on the same lines")
    check(hits == per_kind + len(challenged) and misses == 2 * per_kind,
          "the log-path bans were served by the fast path, the rest by the chain")
    check(stats["faults_total"] == 0 and stats["fail_open_total"] == 0
          and stats["mirror_errors_total"] == 0, "no fast-path fault, fail-open or mirror error")
    check(dev.type != "cuda" or all(v > 0 for v in launches.values()),
          "kernels A, B and C launched in the service phase")
    check(dev.type != "cuda" or abs(mem["after_reload"] - mem["before_reload"])
          <= 0.05 * mem["before_reload"], "device memory is back after the reload")
    check(not replay_diff and cpu_stats["faults_total"] == cpu_stats["fail_open_total"] == 0,
          "the CPU app answers the prefix identically")
    return launches, {
        "lines_per_s": writes * batch_lines / log_wall,
        "line_to_ban_ms": {"p50": 1e3 * percentile(lat, 0.5), "p99": 1e3 * percentile(lat, 0.99)},
        "host_us_per_line_by_stage": stages,
        "prefix": flat[:cross_check], "prefix_answers": answers[:cross_check],
        # what the workers phase replays
        "entries": [(ip, e.expires, int(e.decision), e.from_baskerville, e.domain)
                    for ip, e in entries.items()],
        "flat": flat, "requests_per_s": len(flat) / req_wall, "alone": alone,
        "alone_requests": alone_reqs,
    }


def http_json(port: int, method: str, path: str, body=None):
    """(status, decoded JSON) of one admin request to the app."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def run_pipeline(dev, service, n_rules, batch_lines, capacity, warm_capacity, writes,
                 rotate_after, n_offenders, offender_hits, warmup_lines, drill_lines,
                 drill_recovery_s, drill_probe_s, edge, stamp_base, timeout_s=300.0):
    """The service's app and writes with `pipeline_enabled: true` on device
    `dev`: the tailer submits to the scheduler, whose device thread runs
    kernels A and B and whose drain thread writes the ban log. The ban log
    must equal `TorchMatcher.consume_lines` on the scheduler's batches, the
    service phase's request prefix must answer as it did there, and shed,
    stale, drain-error, breaker-trip, fast-path-fault and tailer-error
    counts must read 0. Then the fault drill on a second pipelined app
    (breaker recovery and probe shortened), through /debug/failpoints:
    `pipeline.submit` for two batches (the ban log stays the synchronous
    path's), then, after a reload, `matcher.device` for
    breaker_failure_threshold firings (the breaker opens, health reads
    degraded, the refused lines are counted exactly, the probe closes it,
    and a later write's bans land). The writes are stamped from
    `stamp_base` (ahead of the clock, so that the `observability` phase can
    append the same lines, fresh). Returns the phase's launches of A, B
    and C, and the writes and their ban log for `observability`. Raises on
    any failed check."""
    import os
    import tempfile

    from banjax_tpu_torch import workload
    from banjax_tpu_torch.cli import BanjaxApp, build_matcher
    from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
    from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
    from banjax_tpu_torch.effectors.banner import Banner
    from banjax_tpu_torch.matcher.kernels import fused_match_window as fmw
    from banjax_tpu_torch.matcher.kernels import nfa_match, pow_verify
    from banjax_tpu_torch.resilience import failpoints

    kernels = {"nfa_match": nfa_match.KERNEL, "window_scan": fmw.KERNEL,
               "pow_verify": pow_verify.KERNEL}
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    workdir_obj = tempfile.TemporaryDirectory(prefix="pipeline-", dir=os.path.join(here, "build"))
    workdir = workdir_obj.name
    patterns = workload.generate_rules(n_rules, seed=SEED)
    stream = workload.access_log(writes * batch_lines, patterns, time.time(), seed=SEED + 1,
                                 n_offenders=n_offenders, offender_hits=offender_hits)
    stream = [ln.split(" ", 1)[1] for ln in stream]
    offenders = {f"203.0.{k // 250}.{k % 250 + 1}" for k in range(n_offenders)}
    warm = [f"104.0.0.{j % 250 + 1} GET {LOG_HOST} GET /warm/{j} HTTP/1.1 Mozilla/5.0 -"
            for j in range(warmup_lines)]

    def start_app(name, **keys):
        path = service_config(workdir, patterns, capacity, warm_capacity, batch_lines, name,
                              pipeline_enabled=True, **keys)
        app = BanjaxApp(path, device=dev)
        rec_sock = edge.attach(app)
        # every drained batch: its lines, when, the write it came from,
        # whether it was processed, and the bans it made
        rec = {"batches": [], "bans": 0, "write": None, "targets": [], "sock": rec_sock}

        def on_results(lines, results):
            bans = app.banner.bans
            new, rec["bans"] = bans[rec["bans"]:], len(bans)
            rec["batches"].append((lines, time.time(), rec["write"], results is not None, new))
            rec["targets"].append(app.pipeline._sizer.target())

        app.pipeline.on_results = on_results
        app.start_background(port=0)
        wait_for(app.tailer.opened.is_set, "the tailer to open the log", timeout_s)
        return app, rec, os.path.join(workdir, name + ".log")

    def drained(rec):
        return sum(len(b[0]) for b in rec["batches"])

    def write(app, rec, log_path, lines, tag, k=None):
        rec["write"] = k
        target = drained(rec) + len(lines)
        t = time.time()
        append_lines(log_path, lines)
        wait_for(lambda: drained(rec) >= target, tag, timeout_s)
        return t

    def replay(cfg, batches):
        """The batches through a synchronous TorchMatcher on the card."""
        log_text = io.StringIO()
        m = build_matcher(cfg, Banner(DynamicDecisionLists(start_sweeper=False), log_text,
                                      io.StringIO()), StaticDecisionLists(cfg), device=dev)
        for lines, t_done, *_ in batches:
            m.consume_lines(lines, now_unix=t_done)
        m.close()
        return log_text.getvalue()

    # ---- the pipelined service: the writes, one rotation, the prefix ----
    t0 = time.perf_counter()
    app, rec, log_path = start_app("pipe")
    setup_s = time.perf_counter() - t0
    try:
        t_w = time.perf_counter()
        write(app, rec, log_path, stamped(warm), "the warm-up batch")
        first_build_s = time.perf_counter() - t_w
        for kern in kernels.values():
            kern.reset_launches()
        app._matcher.clock.reset()
        app.pipeline.stats.reset_e2e()
        st0 = dict(app.pipeline.stats.stage_seconds)
        appended_at = {}
        written = [stamped(stream[k * batch_lines : (k + 1) * batch_lines], stamp_base + 2.0 * k)
                   for k in range(writes)]
        t_log = time.perf_counter()
        ban_bytes = []  # the ban log's size after each write
        for k in range(writes):
            appended_at[k] = write(app, rec, log_path, written[k], f"pipelined write {k + 1}", k)
            ban_bytes.append(os.path.getsize(app.banner._ban_log.name))
            if k + 1 == rotate_after:
                os.replace(log_path, log_path + ".1")
                open(log_path, "w").close()
        log_wall = time.perf_counter() - t_log
        launches = {n: kern.launches for n, kern in kernels.items()}
        by_thread = {n: dict(kern.launches_by_thread) for n, kern in kernels.items()}
        n_lines = writes * batch_lines
        stages = stage_us(app._matcher, n_lines)
        stages_by_thread = {th: {st: v * 1e6 / n_lines for st, v in sorted(d.items())}
                            for th, d in sorted(app._matcher.clock.by_thread.items())}
        pstats = app.pipeline.stats
        busy = {st: (v - st0.get(st, 0.0)) / log_wall
                for st, v in sorted(pstats.stage_seconds.items())}
        workers = {"workers": app.pipeline.encode_workers,
                   "sharded_batches": pstats.encode_sharded_batches,
                   "busy_fraction_of_run": [v / log_wall for v in pstats.worker_seconds],
                   "busy_fraction_of_fanout_ewma": pstats.worker_busy_fractions()}
        latency = {}
        for _, t_done, k, _, bans in rec["batches"]:
            for ip, _, _ in bans:
                if ip in offenders and ip not in latency and k is not None:
                    latency[ip] = t_done - appended_at[k]
        lat = sorted(latency.values())
        targets = rec["targets"][1:]
        n_batches = len(rec["batches"]) - 1
        ring_size = app.pipeline.ring_size
        with open(app.banner._ban_log.name) as f:
            ban_log = f.read()
        kernel_edge = kernel_edge_check(app, rec["sock"], ban_log, timeout_s)
        # the service phase's request prefix, answered by this app
        c = HttpClient(app.port)
        try:
            answers = [c.get(ip, host, cookie) for ip, host, cookie, _ in service["prefix"]]
        finally:
            c.close()
        prefix_diff = [i for i, a in enumerate(answers)
                       if masked(a) != masked(service["prefix_answers"][i])]
        flush_ok = app.pipeline.flush(timeout_s)
        totals = pstats.peek()
        matcher = app._matcher
        counters = {
            "shed": totals["PipelineShedLines"], "stale": totals["PipelineStaleDroppedLines"],
            "drain_errors": totals["PipelineDrainErrorLines"],
            "breaker_trips": matcher.breaker.trip_count, "refused_lines": matcher.refused_lines,
            "fastpath_faults": app.serve_stats.snapshot()["faults_total"],
            "fail_open": app.serve_stats.snapshot()["fail_open_total"],
            "tailer_errors": app.tailer.errors,
        }
        e2e = pstats.e2e_percentiles()
        budget_trips = matcher.budget_trips
        matcher_batches = matcher.stats.peek()
        cfg = app.config_holder.get()
    finally:
        app.stop_background()
    t_d = time.perf_counter()
    direct_log = replay(cfg, rec["batches"])
    direct_s = time.perf_counter() - t_d

    # ---- the fault drill ----
    t_f = time.perf_counter()
    off1 = [x for x in stream if x.startswith("203.0.0.1 ")]
    off2 = [x for x in stream if x.startswith("203.0.0.2 ")]
    filler = [x for x in stream if x.split(" ", 1)[0] not in offenders]
    dapp, drec, dlog = start_app("drill", breaker_recovery_seconds=drill_recovery_s,
                                 matcher_probe_seconds=drill_probe_s)
    drill = {}
    try:
        write(dapp, drec, dlog, stamped(warm), "the drill's warm-up batch")
        code, body = http_json(dapp.port, "POST", "/debug/failpoints",
                               {"arm": [{"name": "pipeline.submit", "count": 2}]})
        check(code == 200 and [a["name"] for a in body["armed"]] == ["pipeline.submit"],
              "/debug/failpoints armed pipeline.submit")
        n_b = len(drec["batches"])
        quarter = len(off1) // 4
        for k in range(4):
            part = (off1[k * quarter : (k + 1) * quarter]
                    + filler[k * drill_lines : (k + 1) * drill_lines])
            write(dapp, drec, dlog, stamped(part), f"drill write {k + 1}")
        s1 = dapp.pipeline.stats.peek()
        drill["submit"] = {
            "batches": len(drec["batches"]) - n_b, "fired": failpoints.fired_count("pipeline.submit"),
            "fallback_batches": s1["PipelineFallbackBatches"],
            "drain_errors": s1["PipelineDrainErrorLines"],
            "breaker_trips": dapp._matcher.breaker.trip_count,
        }
        with open(dapp.banner._ban_log.name) as f:
            submit_ban_log = f.read()
        submit_batches = list(drec["batches"])
        drill_cfg = dapp.config_holder.get()
        # a reload: the matcher (and its breaker) is rebuilt between batches
        gen0 = dapp._matcher_generation
        dapp.reload()
        write(dapp, drec, dlog, stamped(filler[-drill_lines:]), "the batch after the reload")
        check(dapp._matcher_generation == gen0 + 1, "the reload rebuilt the drill's matcher")
        threshold = dapp._matcher.breaker.failure_threshold
        # whether each failed device stage had committed something (the
        # slot-refused rows' host steps): such a batch drains through
        # pipeline_finish instead of a whole rerun
        recovered = []
        recover = dapp._matcher.pipeline_recover
        dapp._matcher.pipeline_recover = lambda st: recovered.append(recover(st)) or recovered[-1]
        code, body = http_json(dapp.port, "POST", "/debug/failpoints",
                               {"arm": [{"name": "matcher.device", "count": threshold}]})
        check(code == 200, "/debug/failpoints armed matcher.device")
        s2 = dapp.pipeline.stats.peek()
        n_b = len(drec["batches"])
        sizes = []
        for k in range(3):
            part = stamped(filler[(4 + k) * drill_lines : (5 + k) * drill_lines])
            sizes.append(len(part))
            write(dapp, drec, dlog, part, f"drill fault write {k + 1}")
        s3 = dapp.pipeline.stats.peek()
        m = dapp._matcher
        code, health = http_json(dapp.port, "GET", "/healthz")
        t_open = time.perf_counter()
        wait_for(lambda: m.breaker.state == "closed", "the probe to close the breaker",
                 5 * drill_recovery_s + 10 * drill_probe_s)
        close_s = time.perf_counter() - t_open
        bans0 = len(dapp.banner.bans)
        write(dapp, drec, dlog, stamped(off2), "the write after the breaker closed")
        late_bans = [b for b in dapp.banner.bans[bans0:] if b[0] == "203.0.0.2"]
        s4 = dapp.pipeline.stats.peek()
        drill["device"] = {
            "batches": len(drec["batches"]) - n_b - 1, "write_lines": sizes,
            "fired": failpoints.fired_count("matcher.device"),
            "healthz": {"code": code, "status": health["status"],
                        "matcher": health["components"]["matcher"]},
            "trips": m.breaker.trip_count, "refused_lines": m.refused_lines,
            "refused_batches": m.refused_batches, "recovered": recovered,
            "failed_lines": s3["PipelineDrainErrorLines"] - s2["PipelineDrainErrorLines"],
            "probe_ok": dapp.pipeline.stats.probe_ok,
            "probe_failed": dapp.pipeline.stats.probe_failed,
            "seconds_to_close": close_s, "late_bans": len(late_bans),
            "accounting": [s4["PipelineAdmittedLines"], s4["PipelineProcessedLines"],
                           s4["PipelineShedLines"], s4["PipelineDrainErrorLines"]],
        }
        failpoints.disarm()
    finally:
        failpoints.disarm()
        dapp.stop_background()
    drill_direct_log = replay(drill_cfg, submit_batches)
    drill_s = time.perf_counter() - t_f
    workdir_obj.cleanup()

    emit({
        "phase": "pipeline",
        "config": f"the service phase's (deploy/banjax-config.yaml, {n_rules} generated rules, "
                  f"{capacity} slots, {warm_capacity} warm records) with pipeline_enabled: true "
                  "and the deploy file's pipeline keys",
        "setup_s": setup_s, "first_batch_with_matcher_build_s": first_build_s,
        "writes": writes, "lines": n_lines, "log_wall_s": log_wall,
        "lines_per_s": {"pipelined": n_lines / log_wall,
                        "synchronous_service_phase": service["lines_per_s"]},
        "line_to_ban_ms": {
            "pipelined": {"p50": 1e3 * percentile(lat, 0.5), "p99": 1e3 * percentile(lat, 0.99)},
            "synchronous_service_phase": service["line_to_ban_ms"]},
        "tailer_read_to_drain_ms": {"n": e2e["n"], "p50": 1e3 * (e2e["p50_s"] or 0.0),
                                    "p99": 1e3 * (e2e["p99_s"] or 0.0)},
        "batches": n_batches,
        "sizer_target": {"min": min(targets), "max": max(targets), "final": targets[-1]},
        "max_inflight_batches": pstats.max_inflight, "ring_size": ring_size,
        "encode": workers, "stage_thread_busy_fraction": busy,
        "host_us_per_line_by_stage": stages, "host_us_per_line_by_thread": stages_by_thread,
        "synchronous_host_us_per_line_by_stage": service["host_us_per_line_by_stage"],
        "launches": launches, "launches_by_thread": by_thread,
        "budget_trips": budget_trips, "matcher_batches": matcher_batches,
        "kernel_edge": kernel_edge,
        "counters": counters, "totals": totals,
        "ban_log_lines": ban_log.count("\n"), "direct_ban_log_identical": direct_log == ban_log,
        "direct_replay_s": direct_s,
        "prefix_requests": len(answers), "prefix_differing": len(prefix_diff),
        "first_differing": prefix_diff[:3], "drill": drill, "drill_s": drill_s,
        "drill_ban_log_lines": submit_ban_log.count("\n"),
        "drill_ban_log_identical": drill_direct_log == submit_ban_log,
    })
    check(flush_ok, "the pipeline drained")
    check(direct_log == ban_log and ban_log.count("\n") > 0,
          "the pipelined ban log equals TorchMatcher.consume_lines on the same batches")
    check(len(latency) == len(offenders), "every offender was banned through the pipeline")
    check(not prefix_diff, "the request prefix answers as in the service phase")
    check(all(v == 0 for v in counters.values()),
          f"shed, stale, drain errors, trips, faults and tailer errors are 0: {counters}")
    check(totals["PipelineAdmittedLines"] == totals["PipelineProcessedLines"]
          + totals["PipelineShedLines"] + totals["PipelineDrainErrorLines"],
          "admitted == processed + shed + failed")
    check(dev.type != "cuda" or (launches["nfa_match"] > 0 and launches["window_scan"] > 0
                                 and by_thread["nfa_match"].get("pipeline-device", 0) > 0
                                 and by_thread["window_scan"].get("pipeline-device", 0) > 0),
          "kernels A and B launched from the scheduler's device thread")
    d1, d2 = drill["submit"], drill["device"]
    check(d1 == {"batches": 4, "fired": 2, "fallback_batches": 2, "drain_errors": 0,
                 "breaker_trips": 0}, f"the pipeline.submit drill's counts: {d1}")
    check(drill_direct_log == submit_ban_log and submit_ban_log.count("\n") > 0,
          "the ban log through the pipeline.submit drill equals the synchronous path's")
    # write 1 fails at submit and again in its rerun or recovery drain (2
    # firings); write 2's firing opens the breaker: rerun whole, it is
    # refused; recovered (it had committed), its drain finishes it. Write
    # 3 is refused at the device stage
    r2 = len(d2["recovered"]) == 2 and d2["recovered"][1]
    check(d2["batches"] == 3 and d2["fired"] == threshold and d2["trips"] == 1
          and len(d2["recovered"]) == 2
          and d2["refused_batches"] == (1 if r2 else 2)
          and d2["refused_lines"] == sizes[2] + (0 if r2 else sizes[1])
          and d2["failed_lines"] == sizes[0] + sizes[2] + (0 if r2 else sizes[1]),
          f"the matcher.device drill's counts: {d2}")
    check(d2["healthz"]["code"] == 200 and d2["healthz"]["status"] == "degraded"
          and d2["healthz"]["matcher"]["status"] == "degraded"
          and "refused" in d2["healthz"]["matcher"].get("detail", ""),
          "health read degraded while the breaker was open")
    check(d2["probe_ok"] >= 1 and d2["late_bans"] > 0,
          "the probe closed the breaker and a later write's bans landed")
    acc = d2["accounting"]
    check(acc[0] == acc[1] + acc[2] + acc[3], "the drill's accounting identity")
    return launches, {"written": written, "rotate_after": rotate_after, "ban_log": ban_log,
                      "ban_log_bytes_after": ban_bytes,
                      "lines_per_s": n_lines / log_wall, "warm": warm,
                      "filler": filler[: 8 * drill_lines], "offenders": sorted(offenders),
                      "capture_lines": filler[-batch_lines // 2:], "stages": stages,
                      "batches": n_batches}


def http_text(port: int, path: str):
    """(status, text, seconds) of one GET to the app."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        t = time.perf_counter()
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode()
        return resp.status, body, time.perf_counter() - t
    finally:
        conn.close()


# kernel A's and B's CUDA function names, as a torch.profiler capture shows them
KERNEL_NAMES = {"nfa_match": ("nfa_carry_kernel", "nfa_free_kernel", "length_order_kernel"),
                "window_scan": ("window_scan_kernel",)}
# the scheduler's spans whose threads launch kernels A and B: the device
# stage (submit, the fused program inside it, collect) and the drain (the
# classic fallback of a gated chunk, and the classic pend)
LAUNCH_SPANS = ("submit", "program-ab-fused", "collect", "drain", "effector-replay")
DEVICE_STAGE_SPANS = ("submit", "program-ab-fused", "collect")


def capture_kernels(trace_path: str) -> dict:
    """Kernels A and B in a torch.profiler Chrome trace: their counts, and
    where each one's launch call (the runtime event with its correlation
    id) lies among the host's record_function spans of the same thread."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kinds = {}
    for e in events:
        kinds[e.get("cat", "")] = kinds.get(e.get("cat", ""), 0) + 1
    kernels = [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"
             and e.get("name") in LAUNCH_SPANS]
    out = {"event_categories": kinds, "kernels": {}, "launch_in_span": {}, "unmatched": []}
    for name, fns in KERNEL_NAMES.items():
        mine = [k for k in kernels if any(fn in k["name"] for fn in fns)]
        out["kernels"][name] = len(mine)
        where = {}
        for k in mine:
            launch = launches.get(k.get("args", {}).get("correlation"))
            if launch is None:
                out["unmatched"].append(k["name"][:60])
                continue
            t0, t1 = launch["ts"], launch["ts"] + launch.get("dur", 0)
            inside = [sp["name"] for sp in spans
                      if sp["pid"] == launch["pid"] and sp["tid"] == launch["tid"]
                      and sp["ts"] <= t0 and t1 <= sp["ts"] + sp["dur"]]
            # the innermost span names where it ran
            label = next((n for n in ("program-ab-fused", "effector-replay", "submit",
                                      "collect", "drain") if n in inside), "none")
            where[label] = where.get(label, 0) + 1
        out["launch_in_span"][name] = where
    return out


def run_observability(dev, pipeline, n_rules, batch_lines, capacity, warm_capacity, scrapes,
                      capture_s, reporter_interval_s, drill_lines, edge, timeout_s=300.0) -> dict:
    """The observability plane on device `dev`: the `pipeline` phase's app
    with `trace_enabled`, `trace_jax_annotations`, `profile`, a flight
    recorder and `metrics_log_file` in a temp dir under build/, and
    `slo_sample_seconds: 1`, appending the `pipeline` phase's 16 writes
    (the same stamped lines). Checks: the ban log is that phase's, byte for
    byte; every batch has its admission -> encode -> submit -> collect ->
    drain spans with consistent parents; each offender's ban has a
    rate_limit provenance record whose trace id the span ring holds;
    `/metrics` parses strictly, declares only registry families and counts
    the lines written; a MetricsReporter at a 1 s interval writes the
    ported keys; no SLO is breached; then a `/debug/torch/trace` capture
    over two more writes (after the timed writes and the SLO reading: the
    profiler slows the host) holds kernels A and B, each launch inside a
    pipeline span;
    a `matcher.device` drill trips the breaker and leaves one loadable
    incident bundle. Returns the phase's launches of A, B and C."""
    import os
    import tempfile
    import threading as _threading

    from banjax_tpu_torch import workload
    from banjax_tpu_torch.cli import BanjaxApp, RegexStatesView
    from banjax_tpu_torch.matcher.kernels import fused_match_window as fmw
    from banjax_tpu_torch.matcher.kernels import nfa_match, pow_verify
    from banjax_tpu_torch.obs import registry
    from banjax_tpu_torch.obs.exposition import parse_text_format
    from banjax_tpu_torch.obs.metrics import MetricsReporter

    kernels = {"nfa_match": nfa_match.KERNEL, "window_scan": fmw.KERNEL,
               "pow_verify": pow_verify.KERNEL}
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    workdir_obj = tempfile.TemporaryDirectory(prefix="observability-",
                                              dir=os.path.join(here, "build"))
    workdir = workdir_obj.name
    patterns = workload.generate_rules(n_rules, seed=SEED)
    offenders = pipeline["offenders"]
    incidents = os.path.join(workdir, "incidents")
    path = service_config(workdir, patterns, capacity, warm_capacity, batch_lines, "obs",
                          pipeline_enabled=True, trace_enabled=True, trace_jax_annotations=True,
                          profile=True, flightrec_dir=incidents,
                          metrics_log_file=os.path.join(workdir, "metrics.log"),
                          slo_sample_seconds=1.0)
    log_path = os.path.join(workdir, "obs.log")
    app = BanjaxApp(path, device=dev)
    sock = edge.attach(app)
    rec = {"batches": []}
    app.pipeline.on_results = lambda lines, results: rec["batches"].append(
        (len(lines), results is not None))

    def drained():
        return sum(n for n, _ in rec["batches"])

    def write(lines, tag):
        target = drained() + len(lines)
        append_lines(log_path, lines)
        wait_for(lambda: drained() >= target, tag, timeout_s)

    app.start_background(port=0)
    setup_s = time.perf_counter() - t_phase
    reporter = None
    try:
        wait_for(app.tailer.opened.is_set, "the tailer to open the log", timeout_s)
        write(stamped(pipeline["warm"]), "the warm-up batch")
        for kern in kernels.values():
            kern.reset_launches()
        app._matcher.clock.reset()
        n_lines, b0 = 0, len(rec["batches"])
        t_log = time.perf_counter()
        for k, lines in enumerate(pipeline["written"]):
            write(lines, f"observed write {k + 1}")
            n_lines += len(lines)
            if k + 1 == pipeline["rotate_after"]:
                os.replace(log_path, log_path + ".1")
                open(log_path, "w").close()
        log_wall = time.perf_counter() - t_log
        stages = stage_us(app._matcher, n_lines)
        budget_trips = app._matcher.budget_trips
        n_batches = len(rec["batches"]) - b0
        with open(app.banner._ban_log.name) as f:
            ban_log = f.read()
        kernel_edge = kernel_edge_check(app, sock, ban_log, timeout_s)

        # ---- spans: one tree a batch ----
        code, trace = http_json(app.port, "GET", "/debug/trace")
        spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
        by_id = {e["args"]["span_id"]: e for e in spans}
        traces = {}
        for e in spans:
            traces.setdefault(e["args"]["trace_id"], []).append(e)
        batch_traces = {t: es for t, es in traces.items() if any(e["name"] == "admission"
                                                                  for e in es)}
        want_parent = {"encode": "admission", "encode-shard": "encode", "submit": "admission",
                       "collect": "admission", "drain": "admission",
                       "program-ab-fused": "submit", "effector-replay": "drain"}
        bad_trees = []
        for t, es in batch_traces.items():
            names = {e["name"] for e in es}
            ok = {"admission", "encode", "submit", "collect", "drain"} <= names
            for e in es:
                parent = by_id.get(e["args"].get("parent_span_id"))
                if e["name"] in want_parent:
                    ok = ok and parent is not None and parent["name"] == want_parent[e["name"]] \
                        and parent["args"]["trace_id"] == t
            if not ok:
                bad_trees.append(sorted(names))
        spans_per_batch = sum(len(es) for es in batch_traces.values()) / max(1, len(batch_traces))

        # ---- provenance: every offender's ban, attributed to a held batch ----
        unattributed = []
        for ip in offenders:
            _, explain = http_json(app.port, "GET", f"/decisions/explain?ip={ip}")
            recs = [r for r in explain["records"] if r["source"] == "rate_limit"]
            if not recs or not all(r["rule"] and r["trace_id"] in traces for r in recs):
                unattributed.append(ip)

        # ---- /metrics, and the 29 s line at a 1 s interval ----
        reporter_path = os.path.join(workdir, "metrics-1s.log")
        reporter = MetricsReporter(
            reporter_path, app.dynamic_lists, RegexStatesView(app), app.failed_challenge_states,
            interval_seconds=reporter_interval_s, matcher_getter=lambda: app._matcher,
            health=app.health, pipeline_getter=lambda: app.pipeline,
            serve_stats=app.serve_stats, ipset_stats=app.ipset_stats)
        reporter.start()
        sketch = app._matcher.traffic_sketch
        pulled0 = sketch.pull_bytes_total if sketch is not None else 0
        scrape_ms, text = [], ""
        for _ in range(scrapes):
            code, text, dt = http_text(app.port, "/metrics")
            check(code == 200, "/metrics answers 200")
            scrape_ms.append(1e3 * dt)
        scrape_d2h = (sketch.pull_bytes_total - pulled0) if sketch is not None else 0
        fams = parse_text_format(text)

        def sample(fam, **labels):
            return [v for _, lab, v in fams.get(fam, {"samples": []})["samples"]
                    if all(lab.get(k) == w for k, w in labels.items())]

        written = len(pipeline["warm"]) + n_lines
        breached = sample("banjax_slo_breached")
        wait_for(lambda: os.path.exists(reporter_path)
                 and open(reporter_path).read().count("\n") >= 2, "two metrics lines",
                 10 * reporter_interval_s + 10)
        reporter.stop()
        rows = [json.loads(r) for r in open(reporter_path).read().splitlines()]
        ported_keys = ("Time", "LenExpiringBlocks", "MatcherLinesTotal", "PipelineAdmittedLines",
                       "DeviceWindowsOccupancy", "MatcherBreakerState", "IpsetBatchEntries",
                       "HealthStatus")

        # ---- the capture, over two more writes (after the timed writes and
        # the SLO reading: a profiler session slows the host's stages) ----
        code, warm_cap = http_json(app.port, "GET", "/debug/torch/trace?seconds=0.2")
        check(code == 200, f"/debug/torch/trace answers: {warm_cap}")  # loads CUPTI
        capture = {}

        def take_capture():
            capture["code"], capture["body"] = http_json(
                app.port, "GET", f"/debug/torch/trace?seconds={capture_s}")

        cap_thread = _threading.Thread(target=take_capture, name="capture")
        cap_thread.start()
        time.sleep(0.25)  # the profiler starts on the server's thread
        captured_writes = []
        extra = pipeline["capture_lines"]
        for k in range(2):
            write(stamped(extra[k * len(extra) // 2 : (k + 1) * len(extra) // 2]),
                  f"captured write {k + 1}")
            if cap_thread.is_alive():
                captured_writes.append(k)
        cap_thread.join(timeout_s)
        launches = {n: kern.launches for n, kern in kernels.items()}
        cap = {}
        if capture.get("code") == 200:
            cap = capture_kernels(capture["body"]["trace_file"])
            keep = os.environ.get("CHIP_SMOKE_KEEP_CAPTURE")
            if keep:
                import shutil

                os.makedirs(keep, exist_ok=True)
                shutil.copy(capture["body"]["trace_file"],
                            os.path.join(keep, "observability-capture.json"))

        # ---- the drill: the breaker trips, one bundle is captured ----
        threshold = app._matcher.breaker.failure_threshold
        code, body = http_json(app.port, "POST", "/debug/failpoints",
                               {"arm": [{"name": "matcher.device", "count": threshold}]})
        check(code == 200, "/debug/failpoints armed matcher.device")
        for k in range(3):
            write(stamped(pipeline["filler"][k * drill_lines : (k + 1) * drill_lines]),
                  f"drill write {k + 1}")
        trips = app._matcher.breaker.trip_count
        code, listing = http_json(app.port, "GET", "/debug/incidents")
        bundles = listing["incidents"]
        loaded = {}
        for b in bundles:
            for fname in b["files"]:
                c, body, _ = http_text(app.port, f"/debug/incidents?name={b['name']}&file={fname}")
                check(c == 200, f"incident file {fname} is served")
                if fname.endswith(".json"):
                    loaded[fname] = sorted(json.loads(body))
                else:
                    loaded[fname] = len(parse_text_format(body))
        from banjax_tpu_torch.resilience import failpoints

        failpoints.disarm()
    finally:
        if reporter is not None:
            reporter.stop()
        app.stop_background()
    workdir_obj.cleanup()
    phase_s = time.perf_counter() - t_phase
    capture_summary = {k: cap.get(k) for k in ("kernels", "launch_in_span", "unmatched")}
    emit({
        "phase": "observability",
        "config": "the pipeline phase's app with trace_enabled, trace_jax_annotations, profile, "
                  "flightrec_dir, metrics_log_file and slo_sample_seconds: 1; provenance and "
                  "SLO on (the JAX defaults)",
        "setup_s": setup_s, "writes": len(pipeline["written"]), "lines": n_lines,
        "log_wall_s": log_wall,
        "lines_per_s": {"observed": n_lines / log_wall, "pipeline_phase": pipeline["lines_per_s"]},
        "ban_log_identical_to_pipeline_phase": ban_log == pipeline["ban_log"],
        "ban_log_lines": ban_log.count("\n"), "kernel_edge": kernel_edge,
        "host_us_per_line_by_stage": {"observed": stages, "pipeline_phase": pipeline["stages"]},
        "budget_trips": budget_trips,
        "batches": {"observed": n_batches, "pipeline_phase": pipeline["batches"]},
        "batch_traces": len(batch_traces),
        "spans_per_batch": spans_per_batch, "bad_trees": bad_trees[:3],
        "offenders_unattributed": unattributed,
        "scrape_ms": {"n": scrapes, "p50": percentile(scrape_ms, 0.5),
                      "p99": percentile(scrape_ms, 0.99), "max": max(scrape_ms)},
        "scrape_families": len(fams), "d2h_bytes_over_scrapes": scrape_d2h,
        "d2h_bytes_per_scrape": scrape_d2h / scrapes,
        "slo_breached": breached, "metrics_lines_1s": len(rows),
        "capture": {"code": capture.get("code"), "seconds": capture_s,
                    "writes_inside": captured_writes,
                    "event_categories": cap.get("event_categories"), **capture_summary},
        "drill": {"trips": trips, "bundles": [(b["name"], b["reason"]) for b in bundles],
                  "bundle_files": loaded},
        "launches": launches, "phase_s": phase_s,
    })
    check(ban_log == pipeline["ban_log"] and ban_log.count("\n") > 0,
          "the ban log equals the pipeline phase's (observability on against off)")
    check(batch_traces and not bad_trees and len(batch_traces) >= len(pipeline["written"]) // 2,
          f"every batch has its span tree: {bad_trees[:2]}")
    check(not unattributed, f"each offender's ban has an attributed provenance record: {unattributed[:3]}")
    check(set(fams) <= set(registry.PROM_FAMILIES), "every /metrics family is declared")
    check(sample("banjax_pipeline_admitted_lines_total") == [float(written)]
          and sample("banjax_pipeline_processed_lines_total") == [float(written)]
          and sample("banjax_matcher_lines_total") == [float(written)],
          "the /metrics lines counters equal the lines written")
    check(len(rows) >= 2 and all(k in r for r in rows for k in ported_keys)
          and all(registry.is_declared_line_key(k) for r in rows for k in r),
          "the 1 s metrics line carries the ported keys")
    check(breached and all(v == 0 for v in breached), f"no SLO is breached: {breached}")
    check(capture.get("code") == 200 and len(captured_writes) >= 2,
          f"the capture ran across two writes: {captured_writes}")
    # (the plain versions on the CPU launch no kernel)
    check(dev.type != "cuda" or (all(cap["kernels"][n] > 0 for n in KERNEL_NAMES)
                                 and not cap["unmatched"]),
          f"the capture holds kernels A and B with their launches: {capture_summary}")
    check(dev.type != "cuda" or all(
        set(w) <= set(LAUNCH_SPANS) and sum(w.get(n, 0) for n in DEVICE_STAGE_SPANS) > 0
        for w in cap["launch_in_span"].values()),
        f"each launch of A and B lies inside a pipeline span: {cap['launch_in_span']}")
    check(trips == 1 and len(bundles) == 1 and set(loaded) == {
        "trace.json", "metrics.prom", "provenance.json", "meta.json", "traffic.json"},
        f"the drill tripped the breaker and left one loadable bundle: {bundles}")
    return launches


# ------------------------------------------------------------ the Kafka channel


BASKERVILLE_NAMES = ("challenge_ip", "block_ip", "challenge_session", "block_session")
TTL_IP_HOST, TTL_SESSION_HOST = "ttl-ip.example", "ttl-session.example"
KAFKA_TTLS = dict(expiring_decision_ttl_seconds=300, block_ip_ttl_seconds=600,
                  block_session_ttl_seconds=900,
                  sites_to_block_ip_ttl_seconds={TTL_IP_HOST: 1200},
                  sites_to_block_session_ttl_seconds={TTL_SESSION_HOST: 1500})


def kafka_commands(n: int, seed: int, malformed_frac: float) -> list:
    """Baskerville commands (JSON bytes): the four names in turn-shuffled
    order on IPs of 198.18.0.0/15 (disjoint from the log's), hosts with
    per-site TTL overrides, session ids with %-escapes and '+', repeats of
    an IP under another name, and `malformed_frac` malformed messages."""
    rng = random.Random(seed)
    hosts = (TTL_IP_HOST, TTL_SESSION_HOST, "kafka-a.example", "kafka-b.example")
    out = []
    for i in range(n):
        if rng.random() < malformed_frac:
            out.append(rng.choice([b"{not json", b"[1, 2]", b'{"Name": "block_ip", "Value": "1.2"}',
                                   b'{"Name": "unknown_cmd", "Value": "198.18.0.1"}']))
            continue
        name = BASKERVILLE_NAMES[rng.randrange(4)]
        j = rng.randrange(n // 2)  # some IPs get two commands
        cmd = {"Name": name, "Value": f"198.{18 + (j >> 16)}.{(j >> 8) & 255}.{j & 255}",
               "host": rng.choice(hosts), "source": "baskerville"}
        if name.endswith("session"):
            cmd["session_id"] = rng.choice([f"s%2B{i}%3D", f"s+{i}", f"plain{i}", f"a%20b{i}"])
        out.append(json.dumps(cmd).encode())
    return out


def expected_commands(raws, cfg) -> tuple:
    """What the lists must hold after `raws`, by the reference's rules
    (kafka.go:176-283), independent of the code under test: per IP and per
    session id the most severe decision (updates are monotonic), its TTL
    and the index of the command that set it. Returns (by ip, by session
    id, well-formed count)."""
    from urllib.parse import unquote_plus

    ips, sessions, ok = {}, {}, 0
    severity = {"challenge": 2, "block": 3}
    for k, raw in enumerate(raws):
        try:
            cmd = json.loads(raw)
        except ValueError:
            continue
        if not isinstance(cmd, dict) or cmd.get("Name") not in BASKERVILLE_NAMES:
            continue
        name, host, value = cmd["Name"], cmd.get("host", ""), cmd.get("Value", "")
        kind, target = name.split("_")
        ttl = cfg.expiring_decision_ttl_seconds if kind == "challenge" else (
            cfg.sites_to_block_ip_ttl_seconds.get(host, cfg.block_session_ttl_seconds)
            if target == "ip" else
            cfg.sites_to_block_session_ttl_seconds.get(host, cfg.block_ip_ttl_seconds))
        if target == "ip":
            if len(value) <= 4:
                continue
            key, table = value, ips
        else:
            key, table = unquote_plus(cmd["session_id"]), sessions
        ok += 1
        if key not in table or severity[kind] > table[key][0]:
            table[key] = (severity[kind], ttl, k, host)
    return ips, sessions, ok


def run_kafka(dev, pipeline, n_rules, batch_lines, capacity, warm_capacity, writes, commands,
              burst, malformed_frac, latency_samples, challenge_ips, edge,
              timeout_s=300.0) -> dict:
    """The Kafka channel on device `dev`: the `pipeline` phase's app and
    stamped writes with `disable_kafka: false` and the writer on, against
    `KafkaBrokerStandIn`. Before each of `writes` writes, a burst of
    `burst` Baskerville commands goes onto the command topic (the reader
    starts at the LAST offset, so the first burst waits for its first
    fetch) and through the pipeline's command lane; `latency_samples`
    commanded IPs a burst are polled on `/auth_request` from the append
    until the answer changes. Checks: every well-formed command is in the
    lists with its decision and expiry (the reference's TTL rules);
    `/auth_request` answers every commanded IP from the fast-path table;
    admitted = processed + shed + failed, with every command drained; the
    ban log is the `pipeline` phase's for the same writes, byte for byte;
    a challenge burst's reports all reach the report topic; a `kafka.send`
    x2 drill delivers the report it held. Returns the launches of A, B
    and C."""
    import os
    import tempfile

    from banjax_tpu_torch import workload
    from banjax_tpu_torch.cli import BanjaxApp
    from banjax_tpu_torch.crypto.challenge import new_challenge_cookie_at
    from banjax_tpu_torch.decisions.model import Decision
    from banjax_tpu_torch.ingest.broker_standin import KafkaBrokerStandIn
    from banjax_tpu_torch.matcher.kernels import fused_match_window as fmw
    from banjax_tpu_torch.matcher.kernels import nfa_match, pow_verify
    from banjax_tpu_torch.resilience import failpoints

    kernels = {"nfa_match": nfa_match.KERNEL, "window_scan": fmw.KERNEL,
               "pow_verify": pow_verify.KERNEL}
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    workdir_obj = tempfile.TemporaryDirectory(prefix="kafka-", dir=os.path.join(here, "build"))
    workdir = workdir_obj.name
    patterns = workload.generate_rules(n_rules, seed=SEED)
    broker = KafkaBrokerStandIn().start()
    path = service_config(workdir, patterns, capacity, warm_capacity, batch_lines, "kafka",
                          pipeline_enabled=True, disable_kafka=False, disable_kafka_writer=False,
                          kafka_brokers=[f"127.0.0.1:{broker.port}"], **KAFKA_TTLS)
    log_path = os.path.join(workdir, "kafka.log")
    app = BanjaxApp(path, device=dev)
    sock = edge.attach(app)
    cfg = app.config_holder.get()
    cmd_topic, rep_topic = cfg.kafka_command_topic, cfg.kafka_report_topic
    raws = kafka_commands(commands, SEED + 5, malformed_frac)
    want_ips, want_sessions, well_formed = expected_commands(raws, cfg)
    # the latency probes: IPs whose first command is the one that sets
    # their final decision, so their answer goes from 200 straight to it
    # (each probe of a challenged IP counts as a failed challenge: the
    # answer check below makes it two, under the threshold)
    first_cmd = {}
    for j, raw in enumerate(raws):
        try:
            value = json.loads(raw).get("Value")
        except (ValueError, AttributeError):
            continue
        first_cmd.setdefault(value, j)
    rec = {"lines": 0}

    def on_results(lines, results):
        rec["lines"] += len(lines)

    app.pipeline.on_results = on_results

    def write(lines, tag):
        target = rec["lines"] + len(lines)
        append_lines(log_path, lines)
        wait_for(lambda: rec["lines"] >= target, tag, timeout_s)

    app.start_background(port=0)
    setup_s = time.perf_counter() - t_phase
    errors = []
    try:
        wait_for(app.tailer.opened.is_set, "the tailer to open the log", timeout_s)
        write(stamped(pipeline["warm"]), "the warm-up batch")
        # commands appended before the reader's first fetch are never read
        wait_for(lambda: broker.fetches.get(cmd_topic, 0) > 0, "the reader's first fetch",
                 timeout_s)
        for kern in kernels.values():
            kern.reset_launches()
        stats = app.pipeline.stats
        items0 = stats.command_items
        appended_at, drain_s, latency = {}, [], []
        n_lines, t_lines = 0, 0.0
        t_run = time.perf_counter()
        for k in range(writes):
            part = raws[k * burst:(k + 1) * burst]
            probes = [(ip, 429 if sev == 2 else 403)
                      for ip, (sev, _, j, _) in sorted(want_ips.items(), key=lambda kv: kv[1][2])
                      if k * burst <= j < (k + 1) * burst and first_cmd[ip] == j][:latency_samples]
            t_a = time.perf_counter()
            appended = broker.append(cmd_topic, part)
            for j in range(k * burst, k * burst + len(part)):
                appended_at[j] = appended
            # command -> answer: poll each probe IP until its answer changes
            c = HttpClient(app.port)
            try:
                pending = dict(probes)
                while pending:
                    for ip, want in list(pending.items()):
                        raw = c.get(ip, "kafka-probe.example")
                        if int(raw.split(b" ", 2)[1]) == want:
                            latency.append(time.perf_counter() - t_a)
                            del pending[ip]
                    if time.perf_counter() - t_a > timeout_s:
                        raise RuntimeError(f"commanded answers did not change: {pending}")
            finally:
                c.close()
            wait_for(lambda: stats.command_items - items0 >= (k + 1) * burst,
                     f"burst {k + 1} through the command lane", timeout_s)
            drain_s.append(time.perf_counter() - t_a)
            t_w = time.perf_counter()
            write(pipeline["written"][k], f"kafka-phase write {k + 1}")
            t_lines += time.perf_counter() - t_w
            n_lines += len(pipeline["written"][k])
        run_s = time.perf_counter() - t_run
        flush_ok = app.pipeline.flush(timeout_s)
        launches = {n: kern.launches for n, kern in kernels.items()}
        totals = stats.peek()
        with open(app.banner._ban_log.name) as f:
            ban_log = f.read()
        want_ban_log = pipeline["ban_log"][:pipeline["ban_log_bytes_after"][writes - 1]]

        # every well-formed command in the lists, with its decision and expiry
        entries = app.dynamic_lists.format_ip_entries()
        sessions = dict(app.dynamic_lists._by_session_id)
        bad_lists = []
        for table, got in ((want_ips, entries), (want_sessions, sessions)):
            for key, (sev, ttl, j, host) in table.items():
                e = got.get(key)
                ok = (e is not None and int(e.decision) == sev and e.from_baskerville
                      and e.domain == host
                      and appended_at[j] + ttl - 1.0 <= e.expires <= time.time() + ttl)
                if not ok:
                    bad_lists.append((key, sev, ttl, e))
        # the fast path answers each commanded IP from the table
        s0 = app.serve_stats.snapshot()
        c = HttpClient(app.port)
        try:
            wrong_answers = [
                (ip, int(raw.split(b" ", 2)[1])) for ip, (sev, *_r) in sorted(want_ips.items())
                for raw in [c.get(ip, "kafka-probe.example")]
                if int(raw.split(b" ", 2)[1]) != (429 if sev == 2 else 403)]
        finally:
            c.close()
        s1 = app.serve_stats.snapshot()
        table_hits = s1["hits_total"] - s0["hits_total"]

        # the chain's reports for a challenge burst: solved cookies pass,
        # cookieless and wrong cookies fail, offenders fail past the
        # threshold and are banned
        threshold = cfg.too_many_failed_challenges_threshold
        now = int(time.time())
        q = challenge_ips
        reqs = []
        for j in range(q):
            ip = f"109.0.0.{j + 1}"
            reqs.append((ip, SHA_HOST, solve(new_challenge_cookie_at(cfg.hmac_secret, now + 3600, ip),
                                             cfg.sha_inv_expected_zero_bits)))
        reqs += [(f"109.0.1.{j + 1}", SHA_HOST, None) for j in range(q // 2)]
        reqs += [(f"109.0.2.{j + 1}", SHA_HOST, "bm90LWEtY29va2ll") for j in range(q // 2)]
        offenders = [f"109.0.3.{j + 1}" for j in range(q // 2)]
        reqs += [(ip, SHA_HOST, None) for _ in range(threshold + 1) for ip in offenders]
        want_reports = {"ip_passed_challenge": q, "ip_banned": len(offenders),
                        "ip_failed_challenge": q + len(offenders) * (threshold + 1)}
        before = len(broker.messages(rep_topic))

        def client(rs):
            try:
                cc = HttpClient(app.port)
                try:
                    for ip, host, cookie in rs:
                        cc.get(ip, host, cookie)
                finally:
                    cc.close()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        # offenders' requests go in order from one client each
        per_client = [[r for r in reqs if r[0] not in offenders][i::8] for i in range(8)]
        for i, ip in enumerate(offenders):
            per_client[i % 8] += [r for r in reqs if r[0] == ip]
        threads = [threading.Thread(target=client, args=(rs,)) for rs in per_client]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout_s)
        want_total = sum(want_reports.values())

        def chain_reports():
            return [json.loads(m) for m in broker.messages(rep_topic)[before:]
                    if json.loads(m)["name"] != "status"]

        try:
            wait_for(lambda: len(chain_reports()) >= want_total, "the burst's reports", 30.0)
        except RuntimeError:
            pass  # counted as dropped below
        got_reports = {}
        for m in chain_reports():
            got_reports[m["name"]] = got_reports.get(m["name"], 0) + 1
        dropped = want_total - sum(got_reports.values())

        # the kafka.send drill: two send failures, the held report delivered
        failpoints.arm("kafka.send", "error", count=2)
        t_d = time.perf_counter()
        mark = f"drill-{time.time()}"
        from banjax_tpu_torch.ingest.reports import report_passed_failed_banned_message

        report_passed_failed_banned_message(cfg, "ip_passed_challenge", "109.0.9.9", mark)
        wait_for(lambda: any(json.loads(m).get("value_site") == mark
                             for m in broker.messages(rep_topic)), "the held report", 30.0)
        drill = {"fired": failpoints.fired_count("kafka.send"),
                 "seconds_to_deliver": time.perf_counter() - t_d}
        failpoints.disarm()
        # the writer reports healthy once its send returned
        wait_for(lambda: app.health.snapshot()["components"]["kafka-writer"]["status"]
                 == "healthy", "the writer's health after the drill", 10.0)
        health = app.health.snapshot()["components"]
    finally:
        failpoints.disarm()
        app.stop_background()
        broker.stop()
    workdir_obj.cleanup()
    phase_s = time.perf_counter() - t_phase
    lat = sorted(latency)
    emit({
        "phase": "kafka",
        "config": "the pipeline phase's app with disable_kafka: false, the writer on, the "
                  "deploy file's topics, a broker stand-in on loopback (modern protocol "
                  f"ladder) and command TTLs {KAFKA_TTLS}",
        "setup_s": setup_s, "writes": writes, "lines": n_lines, "commands": len(raws),
        "well_formed_commands": well_formed, "burst": burst,
        "commands_per_s": len(raws) / sum(drain_s),
        "command_to_answer_ms": {"n": len(lat), "p50": 1e3 * percentile(lat, 0.5),
                                 "p99": 1e3 * percentile(lat, 0.99), "max": 1e3 * lat[-1]},
        "burst_drain_ms": {"p50": 1e3 * percentile(drain_s, 0.5), "max": 1e3 * max(drain_s)},
        "lines_per_s": {"observed": n_lines / t_lines,
                        "pipeline_phase": pipeline["lines_per_s"]},
        "run_s": run_s, "launches": launches, "totals": {
            k: totals[k] for k in ("PipelineAdmittedLines", "PipelineProcessedLines",
                                   "PipelineShedLines", "PipelineDrainErrorLines",
                                   "PipelineCommandItems", "PipelineCommandBatches")},
        "lists": {"ips": len(want_ips), "sessions": len(want_sessions), "wrong": len(bad_lists),
                  "first_wrong": [str(x) for x in bad_lists[:3]]},
        "answers": {"commanded_ips": len(want_ips), "table_hits": table_hits,
                    "wrong": wrong_answers[:3], "n_wrong": len(wrong_answers)},
        "ban_log_lines": ban_log.count("\n"),
        "ban_log_identical_to_pipeline_phase": ban_log == want_ban_log,
        "reports": {"requests": len(reqs), "want": want_reports, "got": got_reports,
                    "dropped": dropped},
        "send_drill": drill, "health": {k: v["status"] for k, v in health.items()},
        "kernel_edge_adds": len(sock.entries), "phase_s": phase_s,
    })
    check(flush_ok and not errors, f"the pipeline drained and no client failed: {errors[:3]}")
    check(not bad_lists, f"every well-formed command is in the lists: {bad_lists[:3]}")
    check(not wrong_answers and table_hits == len(want_ips),
          f"/auth_request answers each commanded IP from the table: {wrong_answers[:3]}")
    check(totals["PipelineAdmittedLines"] == totals["PipelineProcessedLines"]
          + totals["PipelineShedLines"] + totals["PipelineDrainErrorLines"]
          and totals["PipelineCommandItems"] - items0 == len(raws)
          and totals["PipelineShedLines"] == totals["PipelineDrainErrorLines"] == 0,
          "admitted == processed + shed + failed, and every command drained")
    check(ban_log == want_ban_log and ban_log.count("\n") > 0,
          "the ban log equals the pipeline phase's for the same writes")
    check(got_reports == want_reports and dropped == 0,
          f"the report topic holds the burst's reports: {got_reports} != {want_reports}")
    check(drill["fired"] == 2, f"the kafka.send drill fired twice and delivered: {drill}")
    check(health.get("kafka-reader", {}).get("status") == "healthy"
          and health.get("kafka-writer", {}).get("status") == "healthy",
          f"the Kafka loops are healthy: {health}")
    check(dev.type != "cuda" or (launches["nfa_match"] > 0 and launches["window_scan"] > 0),
          "kernels A and B launched in the kafka phase")
    return launches


# ------------------------------------------------------ multi-process serving


def gpu_pids() -> list:
    """The pids that hold a CUDA context on the card, as nvidia-smi lists
    them (pids of the machine's namespace, which may not be this one's)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return sorted(int(x) for x in out.split() if x.strip().isdigit())


def opens_the_card(pid: int) -> bool:
    """Whether process `pid` holds a /dev/nvidia* device open, as every
    process with a CUDA context does."""
    import os

    fd_dir = f"/proc/{pid}/fd"
    for fd in os.listdir(fd_dir):
        try:
            if os.readlink(os.path.join(fd_dir, fd)).startswith("/dev/nvidia"):
                return True
        except OSError:
            pass
    return False


def run_workers(dev, service, n_rules, batch_lines, capacity, warm_capacity, workers, threads,
                alone_requests, lockout_ip, kill_clients, edge, timeout_s=300.0) -> dict:
    """Multi-process serving on device `dev`: the `service` phase's app
    with `http_workers: workers` (SO_REUSEPORT on the port the primary
    bound), its dynamic lists seeded with the service phase's log-path
    bans (broadcast to the workers' replicas, mirrored into the named
    decision table they read). Checks: the service phase's 1,024-request
    prefix from one client answers as the single-process app did; the
    whole request mix from `threads` keep-alive clients answers with the
    expected statuses; one IP failing challenges over fresh connections
    (spread over the processes) is banned at exactly the threshold with
    one ban-log line, and the kernel set holds exactly the ban log's
    IptablesBlock IPs; the cold routes answer through the proxy; a reload
    reaches every process; a SIGKILLed worker is respawned while
    `kill_clients` clients keep going (health reads degraded, then
    healthy, and no request fails but the killed connections' in-flight
    ones); only the primary holds a CUDA context. Returns the launches of
    A, B and C (kernel C from the primary; the workers check PoW on the
    host)."""
    import os
    import re
    import signal
    import tempfile

    from banjax_tpu_torch import workload
    from banjax_tpu_torch.cli import BanjaxApp
    from banjax_tpu_torch.decisions.model import Decision
    from banjax_tpu_torch.matcher.kernels import fused_match_window as fmw
    from banjax_tpu_torch.matcher.kernels import nfa_match, pow_verify

    kernels = {"nfa_match": nfa_match.KERNEL, "window_scan": fmw.KERNEL,
               "pow_verify": pow_verify.KERNEL}
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    workdir_obj = tempfile.TemporaryDirectory(prefix="workers-", dir=os.path.join(here, "build"))
    workdir = workdir_obj.name
    patterns = workload.generate_rules(n_rules, seed=SEED)
    path = service_config(workdir, patterns, capacity, warm_capacity, batch_lines, "workers",
                          http_workers=workers)
    for kern in kernels.values():
        kern.reset_launches()
    app = BanjaxApp(path, device=dev)
    sock = edge.attach(app)
    app.start_background(port=0)
    errors, out = [], {}
    try:
        sup = app._supervisor
        check(sup is not None and sup.n_workers == workers, "the app runs its workers")
        check(sup.wait_ready(timeout_s), "every worker listens on the primary's port")
        setup_s = time.perf_counter() - t_phase
        for ip, expires, decision, from_bask, domain in service["entries"]:
            app.dynamic_lists.update(ip, expires, Decision(decision), from_bask, domain)
        time.sleep(0.5)  # the broadcast datagrams reach the replicas

        # ---- the prefix from one client, as the single-process app answered it
        c = HttpClient(app.port)
        try:
            answers = [c.get(ip, host, cookie) for ip, host, cookie, _ in service["prefix"]]
        finally:
            c.close()
        prefix_diff = [i for i, a in enumerate(answers)
                       if masked(a) != masked(service["prefix_answers"][i])]

        # ---- the whole mix from `threads` keep-alive clients ----
        flat = service["flat"]
        thread_of, per_thread = {}, [[] for _ in range(threads)]
        for i, req in enumerate(flat):
            per_thread[thread_of.setdefault(req[0], len(thread_of) % threads)].append((i, req))
        statuses = [None] * len(flat)
        holders, card_open = [], {}

        def client(reqs):
            try:
                cc = HttpClient(app.port)
                try:
                    for i, (ip, host, cookie, _) in reqs:
                        statuses[i] = int(cc.get(ip, host, cookie).split(b" ", 2)[1])
                finally:
                    cc.close()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        ts = [threading.Thread(target=client, args=(r,)) for r in per_thread]
        t_r = time.perf_counter()
        for t in ts:
            t.start()
        time.sleep(0.5)
        # while the workers serve: who holds the card, and who loaded torch
        with_torch = {pid: "libtorch" in open(f"/proc/{pid}/maps").read() for pid in sup.pids()}
        if dev.type == "cuda":
            holders = gpu_pids()
            card_open = {pid: opens_the_card(pid) for pid in [os.getpid()] + sup.pids()}
        for t in ts:
            t.join(timeout_s)
        req_wall = time.perf_counter() - t_r
        wrong = [(flat[i][:2], statuses[i], flat[i][3]) for i in range(len(flat))
                 if statuses[i] != flat[i][3]]

        # ---- one client alone, by kind ----
        alone = {}
        c = HttpClient(app.port)
        try:
            for kind, reqs in service["alone_requests"].items():
                us = []
                for ip, host, cookie in reqs[:alone_requests]:
                    t_q = time.perf_counter()
                    c.get(ip, host, cookie)
                    us.append(1e6 * (time.perf_counter() - t_q))
                alone[kind] = {"p50_us": percentile(us, 0.5), "p99_us": percentile(us, 0.99)}
        finally:
            c.close()

        # ---- failed challenges across processes: the lockout ----
        cfg = app.config_holder.get()
        threshold = cfg.too_many_failed_challenges_threshold
        def fresh(ip, host, cookie=None):
            cc = HttpClient(app.port)  # a fresh connection each: spread over the processes
            try:
                return int(cc.get(ip, host, cookie).split(b" ", 2)[1])
            finally:
                cc.close()

        lock_statuses = [fresh(lockout_ip, SHA_HOST, "bm90LWEtY29va2ll")
                         for _ in range(threshold + 1)]
        # then every process answers 403 (the ban reaches each replica)
        wait_for(lambda: all(fresh(lockout_ip, SHA_HOST) == 403 for _ in range(2 * workers)),
                 "the lockout's ban in every process", timeout_s)
        wait_for(lambda: app.ipset_writer.queue_depth() == 0
                 and lockout_ip in {ip for ip, _ in sock.entries}, "the lockout's ipset add",
                 timeout_s)
        with open(app.banner._ban_log.name) as f:
            ban_rows = [json.loads(r) for r in f.read().splitlines() if r]
        lock_lines = [r for r in ban_rows if r["client_ip"] == lockout_ip]
        iptables_ips = {r["client_ip"] for r in ban_rows if r["action"] == "IptablesBlock"}
        added = {ip for ip, _ in sock.entries}

        # ---- the cold routes through the proxy, over fresh connections ----
        cold = {}
        for route, want in (("/rate_limit_states", "failed challenges:"),
                            ("/decision_lists", "per_site:"),
                            (f"/is_banned?ip={lockout_ip}", "IptablesBlock"),
                            ("/metrics", f"banjax_http_workers {workers}"),
                            ("/healthz", "worker-supervisor")):
            codes = set()
            for _ in range(2 * (workers + 1)):
                code, body, _ = http_text(app.port, route)
                codes.add(code if want in body else -code)
            cold[route] = sorted(codes)

        # ---- a SIGKILLed worker under load ----
        victim = sup._procs[0]
        kill = {"sent": 0, "failed": 0, "failed_at_s": []}
        stop = threading.Event()
        load_lock = threading.Lock()
        blocked = [e[0] for e in service["entries"] if e[2] >= int(Decision.NGINX_BLOCK)]

        def load(tid):
            cc, n = None, 0
            while not stop.is_set():
                try:
                    if cc is None:
                        cc = HttpClient(app.port)
                    cc.get(blocked[(tid + n) % len(blocked)], LOG_HOST)
                    with load_lock:
                        kill["sent"] += 1
                except (OSError, RuntimeError):
                    with load_lock:
                        kill["failed"] += 1
                        kill["failed_at_s"].append(time.perf_counter() - t_k)
                    cc = None  # the client reconnects, as nginx retries upstream
                n += 1
            if cc is not None:
                cc.close()

        t_k = time.perf_counter()
        ls = [threading.Thread(target=load, args=(t,)) for t in range(kill_clients)]
        for t in ls:
            t.start()
        time.sleep(0.5)
        seen = []
        t_k = time.perf_counter()
        os.kill(victim.pid, signal.SIGKILL)
        respawned = False
        while time.perf_counter() - t_k < 60:
            st = app.health.snapshot()["components"]["worker-supervisor"]["status"]
            if not seen or seen[-1] != st:
                seen.append(st)
            respawned = sup._procs[0].pid != victim.pid and sup.wait_ready(0.05)
            if respawned and st == "healthy" and "degraded" in seen:
                break
            time.sleep(0.05)
        respawn_s = time.perf_counter() - t_k
        time.sleep(0.5)
        stop.set()
        for t in ls:
            t.join(timeout_s)

        # ---- a reload reaches every process ----
        with open(path) as f:
            text = f.read()
        version = "chip-smoke-reload"
        with open(path, "w") as f:
            f.write(re.sub(r"(?m)^config_version: .*$", f"config_version: {version}", text))
        app.reload()
        t_l = time.perf_counter()
        versions = set()
        while time.perf_counter() - t_l < 30:
            versions = {json.loads(http_text(app.port, "/info")[1])["config_version"]
                        for _ in range(3 * (workers + 1))}
            if versions == {version}:
                break
            time.sleep(0.05)
        reload_s = time.perf_counter() - t_l
        launches = {n: kern.launches for n, kern in kernels.items()}
        worker_pids = sup.pids()
        out = {"respawns": sup.respawn_count}
    finally:
        app.stop_background()
    workdir_obj.cleanup()
    phase_s = time.perf_counter() - t_phase
    emit({
        "phase": "workers",
        "config": f"the service phase's app (deploy/banjax-config.yaml) with http_workers: "
                  f"{workers}, on an ephemeral port",
        "cpu_count": os.cpu_count(), "workers": workers, "setup_s": setup_s,
        "seeded_entries": len(service["entries"]),
        "prefix_requests": len(answers), "prefix_differing": len(prefix_diff),
        "first_differing": prefix_diff[:3],
        "requests": len(flat), "threads": threads, "request_wall_s": req_wall,
        "requests_per_s": {"workers": len(flat) / req_wall,
                           "single_process_service_phase": service["requests_per_s"]},
        "one_client_alone": {"workers": alone,
                             "single_process_service_phase": service["alone"]},
        "wrong_statuses": len(wrong), "first_wrong": wrong[:3],
        "lockout": {"statuses": lock_statuses, "threshold": threshold,
                    "ban_log_lines": len(lock_lines)},
        "kernel_edge": {"iptables_block_ips": sorted(iptables_ips), "ipset_adds": sorted(added)},
        "cold_routes": cold, "kill": dict(kill, health=seen, respawn_s=respawn_s,
                                          respawned=respawned),
        "reload": {"versions": sorted(versions), "seconds": reload_s},
        "nvidia_smi_compute_pids": holders, "opens_the_card": card_open,
        "workers_with_torch": with_torch,
        "primary_pid": os.getpid(), "worker_pids": worker_pids,
        "launches": launches, "respawns": out.get("respawns"), "phase_s": phase_s,
    })
    check(not errors, f"no client failed: {errors[:3]}")
    check(not prefix_diff, "the prefix answers as the single-process service phase's app did")
    check(not wrong, f"every response of the mix has its expected status: {wrong[:3]}")
    check(lock_statuses == [429] * threshold + [403] and len(lock_lines) == 1,
          f"the lockout bans at the threshold with one ban-log line: {lock_statuses}")
    check(added == iptables_ips and lockout_ip in added,
          "the ipset adds are the ban log's IptablesBlock IPs")
    check(all(codes == [200] for codes in cold.values()),
          f"the cold routes answer through the proxy: {cold}")
    check(respawned and seen[-1] == "healthy" and "degraded" in seen,
          f"the killed worker was respawned; health went degraded, then healthy: {seen}")
    # a failure is a connection of the killed process (or queued to it),
    # reset at the kill; none may fail later
    check(kill["sent"] > 0 and kill["failed"] <= 2 * kill_clients
          and all(0 <= t < 1.0 for t in kill["failed_at_s"]),
          f"no request failed but the killed connections': {kill}")
    check(versions == {version}, f"the reload reached every process: {versions}")
    # nvidia-smi lists pids of the machine's namespace: one process, and
    # that one the primary by its open device files
    check(dev.type != "cuda" or (card_open.get(os.getpid()) and len(holders) == 1
                                 and not any(card_open[p] for p in worker_pids if p in card_open)),
          f"only the primary holds a CUDA context: {card_open}, nvidia-smi {holders}")
    check(not any(with_torch.values()), f"no worker loaded torch: {with_torch}")
    check(dev.type != "cuda" or launches["pow_verify"] > 0,
          "kernel C launched from the primary")
    return launches


# ---------------------------------------------------------------- fabric

FABRIC_SHARDS = ("a", "b", "c")
FABRIC_VICTIM = "b"


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def prom(port: int) -> dict:
    """One shard's /metrics, parsed strictly."""
    from banjax_tpu_torch.obs.exposition import parse_text_format

    code, text, _ = http_text(port, "/metrics")
    check(code == 200, f"/metrics on :{port} answers: {code}")
    return parse_text_format(text)


def prom_value(parsed: dict, sample: str, **labels) -> float:
    """The sum of a sample name's values (a histogram's `_sum` too)."""
    ent = parsed.get(sample) or parsed.get(sample.rsplit("_", 1)[0]) or {}
    return sum(v for name, lab, v in ent.get("samples", ())
               if name == sample and all(lab.get(k) == x for k, x in labels.items()))


def hist_quantiles(parsed: dict, fam: str, qs=(0.5, 0.99)) -> dict:
    """Bucket-bound quantiles of a histogram family summed over its series
    (the upper bound of the bucket holding each quantile)."""
    ent = parsed.get(fam)
    if not ent:
        return {}
    buckets = {}
    for name, lab, v in ent["samples"]:
        if name == fam + "_bucket":
            le = float("inf") if lab["le"] == "+Inf" else float(lab["le"])
            buckets[le] = buckets.get(le, 0.0) + v
    total = buckets.get(float("inf"), 0.0)
    out = {"count": total}
    for q in qs:
        out[f"p{int(q * 100)}_s"] = next((le for le in sorted(buckets)
                                          if total and buckets[le] >= q * total), None)
    return out


FABRIC_COUNTERS = {
    "local": "banjax_fabric_local_lines_total",
    "forwarded": "banjax_fabric_forwarded_lines_total",
    "received": "banjax_fabric_received_lines_total",
    "shed": "banjax_fabric_shed_lines_total",
    "replayed": "banjax_fabric_replayed_lines_total",
    "skipped": "banjax_fabric_replay_skipped_lines_total",
    "takeovers": "banjax_fabric_takeovers_total",
    "acks": "banjax_fabric_acks_total",
    "replicated": "banjax_fabric_replicated_decisions_total",
    "applied": "banjax_fabric_replicated_applied_total",
}


def expiring_ips(text: str) -> set:
    """The IPs of /decision_lists' dynamic (expiring) section."""
    section = text.split("\nexpiring:\n", 1)[1]
    return {ln[:-1] for ln in section.splitlines() if ln and not ln.startswith("\t")}


def fabric_counts(parsed: dict) -> dict:
    out = {k: prom_value(parsed, fam) for k, fam in FABRIC_COUNTERS.items()}
    out["frames"] = prom_value(parsed, "banjax_fabric_frames_total")
    out["inflight"] = prom_value(parsed, "banjax_fabric_inflight_frames")
    out["frame_bytes"] = prom_value(parsed, "banjax_fabric_frame_bytes_sum")
    return out


class BanLogWatch:
    """Follows ban-log files from a thread of its own: when each line first
    showed, on the smoke's clock."""

    def __init__(self, paths: dict):
        self.paths, self.seen, self._pos = paths, {n: [] for n in paths}, {n: 0 for n in paths}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="ban-watch", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        import os

        while not self._stop.is_set():
            for n, path in self.paths.items():
                if not os.path.exists(path):
                    continue
                with open(path) as f:
                    f.seek(self._pos[n])
                    data = f.read()
                cut = data.rfind("\n") + 1
                if cut:
                    t = time.perf_counter()
                    self._pos[n] += len(data[:cut].encode())
                    self.seen[n] += [(t, ln) for ln in data[:cut].splitlines() if ln]
            self._stop.wait(0.002)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(5)


def run_fabric(dev, n_rules, batch_lines, capacity, warm_capacity, timed_writes,
               captured_writes, after_writes, n_ips, n_offenders, offender_hits, capture_s,
               ban_requests, solved, edge, timeout_s=120.0) -> dict:
    """The decision fabric on device `dev`: three shard processes, each
    `python -m banjax_tpu_torch.cli -config-file shard-X.yaml` with its own
    CUDA context on the one card, on the deploy file's keys at `service`'s
    width with `fabric_enabled: true` and the deploy file's fabric keys
    (vnodes 64, gossip 1 s, suspect 3 s, wire v2, 8 frames in flight, shm
    off), Kafka on against `KafkaBrokerStandIn` with `kafka`'s TTLs, trace
    propagation, fleet metrics and fleet incident capture on, `profile: true`, the fake
    kernel edge first on PATH (and the netlink writer off: no message may
    reach the machine's kernel). Each IP's lines enter through one shard's
    log. `timed_writes` writes a shard (lines/s), `captured_writes` more
    under a `/debug/torch/trace` capture on every shard (kernels A and B
    counted in each shard's own trace) while the request mix goes to one
    shard (replicated bans from its fast path, solved cookies through
    kernel C) and the replicated bans to a second; then one shard is
    SIGKILLed, the survivors take its range over, and `after_writes` go to
    the survivors' logs only. Checks:
    replication, recall 1.0 per IP against a single-process app on `dev`
    fed what entered the survivors (and the victim's acked forwards), the
    accounting, the takeover, the fleet routes, the launches, cleanup.
    Precision is reported, with the frames sent again past the ack deadline,
    the lines their owners drained twice (as JAX does), and the survivors'
    extra ban lines split into repeats of the one process's banned IPs and
    IPs it never banned. Returns the launches of A, B and C read from the
    shards' captures."""
    import os
    import shutil
    import signal
    import tempfile
    import zlib
    from collections import Counter

    import yaml

    from banjax_tpu_torch import workload
    from banjax_tpu_torch.cli import BanjaxApp
    from banjax_tpu_torch.crypto.challenge import new_challenge_cookie_at
    from banjax_tpu_torch.fabric.hashring import ConsistentHashRing
    from banjax_tpu_torch.ingest.broker_standin import KafkaBrokerStandIn
    from banjax_tpu_torch.obs.exposition import parse_text_format

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    workdir_obj = tempfile.TemporaryDirectory(prefix="fabric-", dir=os.path.join(here, "build"))
    workdir = workdir_obj.name
    patterns = workload.generate_rules(n_rules, seed=SEED)
    ids, victim = FABRIC_SHARDS, FABRIC_VICTIM
    survivors = tuple(n for n in ids if n != victim)
    fport = {n: free_port() for n in ids}
    hport = {n: free_port() for n in ids}
    peers = {n: f"127.0.0.1:{fport[n]}" for n in ids}
    broker = KafkaBrokerStandIn().start()
    paths, procs, logs = {}, {}, {}
    for n in ids:
        paths[n] = service_config(
            workdir, patterns, capacity, warm_capacity, batch_lines, f"shard-{n}",
            fabric_enabled=True, fabric_node_id=n, fabric_listen=peers[n], fabric_peers=peers,
            fabric_trace_propagation=True, fleet_metrics_enabled=True,
            flightrec_fleet_capture=True, flightrec_dir=os.path.join(workdir, f"incidents-{n}"),
            disable_kafka=False, kafka_brokers=[f"127.0.0.1:{broker.port}"],
            kafka_max_wait_ms=100, profile=True, ipset_netlink_enabled=False,
            # the kafka phase's TTLs: a replicated block_ip lives
            # block_session_ttl_seconds (the reference's quirk), 0 in the
            # deploy file, under which it expires at once
            **KAFKA_TTLS)
    with open(paths[ids[0]]) as f:
        shard_cfg = yaml.safe_load(f)
    topic = shard_cfg["kafka_command_topic"]
    out = {}
    watch = None
    try:
        t0 = time.perf_counter()
        for n in ids:
            cmd = [sys.executable, "-m", "banjax_tpu_torch.cli", "-config-file", paths[n],
                   "-port", str(hport[n])] + (["-device", "cpu"] if dev.type == "cpu" else [])
            logs[n] = open(os.path.join(workdir, f"shard-{n}.out"), "w")
            procs[n] = subprocess.Popen(cmd, cwd=here, stdout=logs[n], stderr=subprocess.STDOUT)

        def up(n):
            if procs[n].poll() is not None:
                raise RuntimeError(f"shard {n} exited with {procs[n].returncode}")
            try:
                return http_text(hport[n], "/healthz")[0] in (200, 503)
            except OSError:
                return False

        wait_for(lambda: all(up(n) for n in ids), "the shards to serve", timeout_s)
        # every shard's Kafka reader past its first offset: a sync command
        # until each shard's lists hold it
        sync_ip = "192.0.2.254"
        sync = json.dumps({"Name": "block_ip", "Value": sync_ip, "host": LOG_HOST}).encode()

        def synced():
            broker.append(topic, [sync])
            time.sleep(0.2)
            return all(sync_ip in expiring_ips(http_text(hport[n], "/decision_lists")[1])
                       for n in ids)

        wait_for(synced, "every shard's Kafka reader", timeout_s)
        start_s = time.perf_counter() - t0
        card_open = {n: opens_the_card(procs[n].pid) for n in ids} if dev.type == "cuda" else {}

        # ---- the flood: each IP enters through one log; stamped ahead
        # of the clock so that a replay after the takeover is not stale ----
        n_writes = timed_writes + captured_writes + after_writes
        # a tenth more than three logs' writes: the split by IP is uneven
        stream = workload.access_log(33 * n_writes * batch_lines // 10, patterns, time.time(),
                                     seed=SEED + 9, n_ips=n_ips, n_offenders=n_offenders,
                                     offender_hits=offender_hits)
        by_log = {n: [] for n in ids}
        for ln in stream:
            ip_rest = ln.split(" ", 1)[1]
            by_log[ids[zlib.crc32(ip_rest.split(" ", 1)[0].encode()) % 3]].append(ip_rest)
        stamp_base = time.time() + 600.0
        writes = {n: [stamped(by_log[n][k * batch_lines:(k + 1) * batch_lines],
                              stamp_base + 2 * k) for k in range(n_writes)] for n in ids}
        ring = ConsistentHashRing(ids, vnodes=shard_cfg["fabric_vnodes"])
        owner = {}
        for n in ids:
            for part in writes[n]:
                for ln in part:
                    ip = ln.split(" ", 2)[1]
                    if ip not in owner:
                        owner[ip] = ring.owner(ip)
        foreign = {n: sum(owner[ln.split(" ", 2)[1]] != n for part in writes[n] for ln in part)
                   / sum(map(len, writes[n])) for n in ids}
        appended = {n: 0 for n in ids}
        append_at = []  # (perf time, shard, write k)
        watch = BanLogWatch({n: os.path.join(workdir, f"shard-{n}.bans") for n in ids})
        last = {}

        def append_write(n, k):
            append_lines(os.path.join(workdir, f"shard-{n}.log"), writes[n][k])
            appended[n] += len(writes[n][k])
            append_at.append((time.perf_counter(), n, k))

        def settled(live):
            # every line tailed is routed (the ledger), and every window is
            # empty: each forwarded frame was drained by its owner (the ack
            # follows the drain)
            counts = {n: fabric_counts(prom(hport[n])) for n in live}
            last.update(counts)
            return all(c["local"] + c["forwarded"] + c["shed"] + c["skipped"]
                       - c["received"] - c["replayed"] == appended[n] and c["inflight"] == 0
                       for n, c in counts.items())

        def wait_settled(live, what):
            # a scrape of each shard every 50 ms: the polls share the
            # shards' interpreter locks with their matchers
            deadline = time.monotonic() + timeout_s
            while not settled(live):
                if time.monotonic() > deadline:
                    lat = {n: hist_quantiles(prom(hport[n]), "banjax_batch_latency_seconds")
                           for n in live}
                    raise RuntimeError(f"timed out waiting for {what}: {last}; "
                                       f"batch latency {lat}")
                time.sleep(0.05)

        # warm-up: each shard builds its matcher on its first batch, then
        # takes a write's worth of benign lines, all of IPs it owns itself.
        # A frame whose owner is slower than the sender's ack deadline (2x
        # fabric_send_timeout_ms) is sent again, and the owner, which keeps
        # no record of the frames it drained, processes it twice (as in JAX)
        own = {n: [ip for ip in (f"104.{ids.index(n)}.{j >> 8}.{j & 255}"
                                 for j in range(4 * batch_lines)) if ring.owner(ip) == n]
               for n in ids}
        for size in (64, batch_lines):
            for n in ids:
                warm = stamped([f"{ip} GET {LOG_HOST} GET /warm/{j} HTTP/1.1 Mozilla/5.0 -"
                                for j, ip in enumerate(own[n][:size])], stamp_base - 5)
                append_lines(os.path.join(workdir, f"shard-{n}.log"), warm)
                appended[n] += len(warm)
            wait_settled(ids, f"the {size}-line warm-up to settle")
        warm_s = time.perf_counter() - t0 - start_s

        # the timed writes: a write to each log at once, then settle (as
        # `service` waits for each write)
        t_f = time.perf_counter()
        for k in range(timed_writes):
            for n in ids:
                append_write(n, k)
            wait_settled(ids, f"timed write {k + 1} to settle")
        fabric_wall = time.perf_counter() - t_f
        timed_lines = sum(len(writes[n][k]) for n in ids for k in range(timed_writes))
        shed_before = {n: last[n]["shed"] for n in ids}

        # ---- the captured part: a torch.profiler trace on every shard over
        # two writes each and the request mix to shard a ----
        for n in ids:
            code, body = http_json(hport[n], "GET", "/debug/torch/trace?seconds=0.2")
            check(code == 200, f"shard {n}'s /debug/torch/trace answers: {body}")
        caps = {}

        def take(n):
            caps[n] = http_json(hport[n], "GET", f"/debug/torch/trace?seconds={capture_s}")

        cap_threads = [threading.Thread(target=take, args=(n,)) for n in ids]
        for t in cap_threads:
            t.start()
        time.sleep(0.5)  # the profilers start on the shards' server threads
        t_c = time.perf_counter()
        for k in range(timed_writes, timed_writes + captured_writes):
            for n in ids:
                append_write(n, k)
            time.sleep(0.05)
        wait_settled(ids, "the captured writes to settle")
        bans_pre = {n: [ln for _, ln in watch.seen[n]] for n in ids}
        banned = {}  # ip -> the strongest decision of its ban lines
        for ln in (ln for n in ids for ln in bans_pre[n]):
            row = json.loads(ln)
            if banned.get(row["client_ip"]) not in ("NginxBlock", "IptablesBlock"):
                banned[row["client_ip"]] = row["action"]
        check(len(banned) >= 8, f"the flood banned IPs: {len(banned)}")

        # replication: every ban in every shard's lists
        unreplicated = {}

        def replicated():
            for n in ids:
                listed = expiring_ips(http_text(hport[n], "/decision_lists")[1])
                unreplicated[n] = sorted(set(banned) - listed)
            return not any(unreplicated.values())

        try:
            wait_for(replicated, "every ban in every shard's lists", timeout_s)
        except RuntimeError:
            raise RuntimeError(f"bans missing from shards' lists: "
                               f"{ {n: v[:5] for n, v in unreplicated.items()} }") from None
        # the request mix to shard a: bans owned elsewhere (its fast path),
        # solved cookies (the chain, kernel C); and shard c's decision
        # table, with the bans it does not own
        asker = ids[0]

        def ban_reqs(n, limit):
            remote = sorted(ip for ip in banned if owner.get(ip, ring.owner(ip)) != n)
            check(remote, f"shard {n} holds bans another shard minted")
            return [(ip, LOG_HOST, None, 429 if banned[ip] == "Challenge" else 403)
                    for ip in remote[:limit]]

        def ask(n, reqs):
            hits0 = prom_value(prom(hport[n]), "banjax_serve_fastpath_hits_total")
            c = HttpClient(hport[n])
            t_r = time.perf_counter()
            try:
                statuses = [int(c.get(ip, host, cookie).split(b" ", 2)[1])
                            for ip, host, cookie, _ in reqs]
            finally:
                c.close()
            req_s = time.perf_counter() - t_r
            hits = prom_value(prom(hport[n]), "banjax_serve_fastpath_hits_total") - hits0
            return req_s, hits, [(reqs[i][:2], statuses[i], reqs[i][3])
                                 for i in range(len(reqs)) if statuses[i] != reqs[i][3]]

        reqs = ban_reqs(asker, ban_requests)
        now = int(time.time())
        secret, bits = shard_cfg["hmac_secret"], shard_cfg["sha_inv_expected_zero_bits"]
        for j in range(solved):
            ip = f"106.9.{j >> 8}.{j & 255}"
            reqs.append((ip, SHA_HOST, solve(new_challenge_cookie_at(secret, now + 3600, ip),
                                             bits), 200))
        req_s, hits, wrong = ask(asker, reqs)
        other = ids[2]
        other_reqs = ban_reqs(other, ban_requests)
        _, other_hits, other_wrong = ask(other, other_reqs)
        for t in cap_threads:
            t.join(capture_s + timeout_s)
        captured_s = time.perf_counter() - t_c
        captures = {}
        for n in ids:
            code, body = caps.get(n, (0, {}))
            check(code == 200, f"shard {n}'s capture: {body}")
            captures[n] = capture_kernels(body["trace_file"])
            with open(body["trace_file"]) as f:
                events = json.load(f)["traceEvents"]
            captures[n]["kernels"]["pow_verify"] = sum(
                1 for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"
                and "pow_verify_kernel" in e.get("name", ""))
            shutil.rmtree(os.path.dirname(body["trace_file"]), ignore_errors=True)

        # ---- the fleet routes before the kill ----
        code, fleet_text, fleet_s = http_text(hport[asker], "/metrics?fleet=1")
        check(code == 200, f"/metrics?fleet=1 answers: {code}")
        fleet = parse_text_format(fleet_text)
        unreach_before = {lab["instance"]: v for _, lab, v
                          in fleet["banjax_fleet_peer_unreachable"]["samples"]}
        merged_fwd = prom_value(fleet, "banjax_fabric_forwarded_lines_total")
        ack_rtt = hist_quantiles(fleet, "banjax_fabric_ack_rtt_seconds")
        # a ban minted from a forwarded line, explained through shard a:
        # proxied to its owner, its record naming the shard that tailed it
        log_of = {ln.split(" ", 2)[1]: n for n in ids for part in writes[n] for ln in part}
        crossing = sorted(ip for ip in banned
                          if log_of.get(ip) not in (None, owner.get(ip)) and owner[ip] != asker)
        check(crossing, "a ban minted from a forwarded line, owned away from shard a")
        code, explained = http_json(hport[asker], "GET", f"/decisions/explain?ip={crossing[0]}")
        recs = [r for r in explained.get("records", []) if r["source"] == "rate_limit"]
        explain_ok = (code == 200 and explained.get("proxied") is True
                      and explained.get("owning_node") == owner[crossing[0]] and recs
                      and all(r.get("origin_node") == log_of[crossing[0]] for r in recs))

        # ---- the kill: the victim's forwards all acked (settled above) ----
        pre_kill = {n: dict(last[n]) for n in ids}
        t_k = time.perf_counter()
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait(timeout_s)
        code, text, _ = http_text(hport[asker], "/metrics?fleet=1")
        check(code == 200, f"/metrics?fleet=1 after the kill answers: {code}")
        unreach_after = {lab["instance"]: v for _, lab, v
                         in parse_text_format(text)["banjax_fleet_peer_unreachable"]["samples"]}
        wait_for(lambda: all(fabric_counts(prom(hport[n]))["takeovers"] >= 1 for n in survivors),
                 "the survivors' takeover", timeout_s)
        takeover_wall = time.perf_counter() - t_k
        took = {}
        for n in survivors:
            parsed = prom(hport[n])
            took[n] = {
                "detection_sum_s": prom_value(parsed,
                                              "banjax_fabric_membership_detection_seconds_sum"),
                "replay_duration_sum_s": prom_value(
                    parsed, "banjax_fabric_takeover_duration_seconds_sum"),
                "replayed_lines": prom_value(parsed, "banjax_fabric_replayed_lines_total"),
            }

        # ---- the rest of the flood, through the survivors' logs only ----
        t_a = time.perf_counter()
        for k in range(timed_writes + captured_writes, n_writes):
            for n in survivors:
                append_write(n, k)
            time.sleep(0.05)
        last.pop(victim)
        last[victim] = pre_kill[victim]
        wait_settled(survivors, "the survivors to settle")
        after_wall = time.perf_counter() - t_a
        final = {n: dict(last[n]) for n in ids}
        batch_latency = {n: hist_quantiles(prom(hport[n]), "banjax_batch_latency_seconds")
                         for n in survivors}
        time.sleep(0.2)
        watch.stop()
        bans = {n: [ln for _, ln in watch.seen[n]] for n in ids}

        # ---- a single process on the same card, fed what entered the
        # survivors' logs and the victim's acked forwards ----
        fed_pre = [ln for n in survivors for k in range(timed_writes + captured_writes)
                   for ln in writes[n][k]]
        fed_pre += [ln for k in range(timed_writes + captured_writes)
                    for ln in writes[victim][k] if owner[ln.split(" ", 2)[1]] != victim]
        fed_after = [ln for k in range(timed_writes + captured_writes, n_writes)
                     for n in survivors for ln in writes[n][k]]
        ref_path = service_config(workdir, patterns, capacity, warm_capacity, batch_lines, "ref")
        ref = BanjaxApp(ref_path, device=dev)
        edge.attach(ref)
        done = [0]
        inner = ref.tailer.on_lines

        def counting(batch):
            inner(batch)
            done[0] += len(batch)

        ref.tailer.on_lines = counting
        ref.start_background(port=0)
        try:
            wait_for(ref.tailer.opened.is_set, "the single-process app's tailer", timeout_s)
            warm = stamped([f"104.9.0.{j % 250 + 1} GET {LOG_HOST} GET /warm/{j} HTTP/1.1 "
                            "Mozilla/5.0 -" for j in range(64)], stamp_base - 5)
            append_lines(os.path.join(workdir, "ref.log"), warm)
            wait_for(lambda: done[0] >= len(warm), "the single-process app's warm-up", timeout_s)
            t_s = time.perf_counter()
            fed = len(warm)
            # in the fabric's order: what entered before the kill, then after
            for part in [fed_pre[i:i + batch_lines] for i in range(0, len(fed_pre), batch_lines)] \
                    + [fed_after[i:i + batch_lines] for i in range(0, len(fed_after), batch_lines)]:
                append_lines(os.path.join(workdir, "ref.log"), part)
                fed += len(part)
                wait_for(lambda: done[0] >= fed, "the single-process app", timeout_s)
            single_wall = time.perf_counter() - t_s
            batch_latency["single_process"] = hist_quantiles(
                parse_text_format(ref.render_metrics_text()), "banjax_batch_latency_seconds")
            with open(os.path.join(workdir, "ref.bans")) as f:
                ref_bans = f.read().splitlines()
        finally:
            ref.stop_background()

        # recall per IP: every ban of the single process, among the survivors'
        engine = Counter(ln for n in survivors for ln in bans[n])
        oracle = Counter(ref_bans)
        tp = sum((engine & oracle).values())
        recall = tp / sum(oracle.values()) if oracle else 1.0
        precision = tp / sum(engine.values()) if engine else 1.0
        missing = sorted({json.loads(ln)["client_ip"] for ln in (oracle - engine)})
        # the survivors' extra ban lines: repeats of IPs the one process
        # banned too, or IPs it never banned
        oracle_ips = {json.loads(ln)["client_ip"] for ln in oracle}
        extra = list((engine - oracle).elements())
        extra_repeats = sum(json.loads(ln)["client_ip"] in oracle_ips for ln in extra)

        # line -> ban-log latency by hop (each IP's first ban before the kill)
        first_seen = {}
        for n in ids:
            for t, ln in watch.seen[n]:
                ip = json.loads(ln)["client_ip"]
                if ip in owner and ip not in first_seen and t < t_k:
                    first_seen[ip] = t
        lat = {"local": [], "fabric": []}
        for ip, t in first_seen.items():
            ats = [a for a, n, k in append_at if n == log_of.get(ip) and a <= t
                   and any(ln.split(" ", 2)[1] == ip for ln in writes[n][k])]
            if ats:
                lat["local" if log_of[ip] == owner[ip] else "fabric"].append(t - max(ats))

        # ---- an incident on shard a holds its live peer's files: the
        # breaker tripped by matcher.device on a write only shard a owns ----
        threshold = shard_cfg["breaker_failure_threshold"]
        code, _ = http_json(hport[asker], "POST", "/debug/failpoints",
                            {"arm": [{"name": "matcher.device", "count": threshold}]})
        check(code == 200, "/debug/failpoints armed matcher.device on shard a")
        own = [f"104.9.{j >> 8}.{j & 255}" for j in range(4096)]
        own = [ip for ip in own if ring.owner(ip, set(survivors)) == asker][:threshold * 4]
        for j in range(threshold):
            part = stamped([f"{ip} GET {LOG_HOST} GET /drill/{j} HTTP/1.1 Mozilla/5.0 -"
                            for ip in own[j * 4:(j + 1) * 4]], stamp_base + 3 * n_writes)
            append_lines(os.path.join(workdir, f"shard-{asker}.log"), part)
            time.sleep(0.3)
        incidents = []
        wait_for(lambda: incidents.extend(http_json(hport[asker], "GET", "/debug/incidents")[1]
                                          .get("incidents", [])) or incidents,
                 "an incident on shard a", timeout_s)
        files = incidents[0].get("files", [])
        peer_files = sorted(f for f in files if f.startswith("peers/"))
        code, peer_fabric = http_json(
            hport[asker], "GET", f"/debug/incidents?name={incidents[0]['name']}"
            f"&file=peers/{survivors[1]}/fabric.json") if peer_files else (0, {})

        # ---- cleanup: the survivors stop on SIGTERM; nothing is left ----
        for n in survivors:
            procs[n].send_signal(signal.SIGTERM)
        exits = {n: procs[n].wait(timeout_s) for n in ids}
        left = [n for n in ids if procs[n].poll() is None]
        out = {
            "start_s": start_s, "warm_s": warm_s, "foreign_share": foreign,
            "card_open": card_open,
            "lines_per_s": {"fabric_3_shards": timed_lines / fabric_wall,
                            "single_process": (len(fed_pre) + len(fed_after)) / single_wall},
            "timed_lines": timed_lines, "fabric_wall_s": fabric_wall,
            "single_lines": len(fed_pre) + len(fed_after), "single_wall_s": single_wall,
            "forwarded": {n: final[n]["forwarded"] for n in ids},
            "frames": {n: final[n]["frames"] for n in ids},
            "frame_bytes": {n: final[n]["frame_bytes"] for n in ids},
            # frames sent again after the ack deadline, and the lines their
            # owners drained twice
            "retransmits": {n: final[n]["frames"] - final[n]["acks"] for n in ids},
            "lines_drained_twice": sum(final[n]["received"] - final[n]["forwarded"] for n in ids),
            "ack_rtt": ack_rtt, "fleet_scrape_s": fleet_s, "batch_latency": batch_latency,
            "line_to_ban_ms": {hop: {"n": len(xs), "p50": 1e3 * percentile(xs, 0.5) if xs else None,
                                     "p99": 1e3 * percentile(xs, 0.99) if xs else None}
                               for hop, xs in lat.items()},
            "bans": {n: len(bans[n]) for n in ids}, "single_process_bans": len(ref_bans),
            "recall": recall, "precision": precision, "missing_ips": missing[:5],
            "extra_ban_lines": {"repeats_of_banned_ips": extra_repeats,
                                "ips_never_banned": len(extra) - extra_repeats},
            "accounting": {n: final[n] for n in ids}, "shed_before_kill": shed_before,
            "takeover_wall_s": takeover_wall, "takeover": took,
            "replicated_ips": len(banned), "requests": len(reqs), "request_s": req_s,
            "wrong_statuses": wrong[:3], "fast_path_hits": hits,
            "shard_c": {"requests": len(other_reqs), "fast_path_hits": other_hits,
                        "wrong_statuses": other_wrong[:3]},
            "fleet_unreachable_before": unreach_before,
            "fleet_unreachable_after_kill": unreach_after, "fleet_forwarded": merged_fwd,
            "explain": {"ip": crossing[0], "owning_node": explained.get("owning_node"),
                        "proxied": explained.get("proxied"),
                        "origin_nodes": sorted({r.get("origin_node", "") for r in recs})},
            "incident": {"files": len(files), "peer_files": peer_files,
                         "peer_fabric_node": (peer_fabric or {}).get("node_id")},
            "captures": {n: captures[n]["kernels"] for n in ids}, "captured_s": captured_s,
            "after_wall_s": after_wall, "exits": exits, "left": left,
        }
    finally:
        if watch is not None:
            watch.stop()
        for n, p in procs.items():
            if p.poll() is None:
                p.kill()
                p.wait(30)
        for f in logs.values():
            f.close()
        broker.stop()
        if not out:  # the phase failed: show what the shards said, and
            # keep their whole output beside the workdir
            for n in ids:
                path = os.path.join(workdir, f"shard-{n}.out")
                if os.path.exists(path):
                    kept = os.path.join(here, "build", f"fabric-shard-{n}.out")
                    shutil.copyfile(path, kept)
                    with open(path) as f:
                        text = f.read()
                    print(f"shard {n} output (tail; all of it in {kept}):\n{text[-3000:]}",
                          file=sys.stderr)
        workdir_obj.cleanup()
    out["phase_s"] = time.perf_counter() - t_phase
    emit(dict(phase="fabric", config="deploy/banjax-config.yaml at service's width, three "
              "shard processes with fabric_enabled: true", **out))
    acct = out["accounting"]
    check(all(acct[n]["local"] + acct[n]["forwarded"] + acct[n]["shed"] + acct[n]["skipped"]
              - acct[n]["received"] - acct[n]["replayed"] == appended[n] for n in ids),
          "local + forwarded + shed + replay_skipped == received + replayed on every shard")
    check(all(v == 0 for v in shed_before.values()), f"no line shed before the kill: {shed_before}")
    check(all(0.4 < v < 0.9 for v in foreign.values()),
          f"about two thirds of each log's lines are owned elsewhere: {foreign}")
    check(dev.type != "cuda" or all(card_open.values()),
          f"every shard holds its own CUDA context: {card_open}")
    check(not wrong and hits >= len(reqs) - solved,
          f"shard a answers the replicated bans from its fast path: {wrong[:3]}, hits {hits}")
    check(not other_wrong and other_hits >= len(other_reqs),
          f"shard c answers the replicated bans from its fast path: {other_wrong[:3]}, "
          f"hits {other_hits}")
    check(recall == 1.0, f"recall 1.0 against one process: missing {missing[:5]}")
    check(all(out["takeover"][n]["replayed_lines"] > 0 for n in survivors),
          "the survivors replayed their journals")
    check(set(unreach_before) == set(ids) and not any(unreach_before.values()),
          f"/metrics?fleet=1 merges the three live shards: {unreach_before}")
    check(unreach_after.get(victim) == 1, f"/metrics?fleet=1 flags the dead shard: {unreach_after}")
    check(merged_fwd == sum(pre_kill[n]["forwarded"] for n in ids),
          "the fleet's merged forwarded count is the shards' sum")
    check(explain_ok, f"/decisions/explain is proxied, with the origin node: {explained}")
    check(all(f"peers/{survivors[1]}/{fn}" in peer_files
              for fn in ("metrics.prom", "fabric.json", "provenance.json", "trace.json"))
          and out["incident"]["peer_fabric_node"] == survivors[1],
          f"the incident holds the live peer's files: {peer_files}")
    check(not left and all(exits[n] == 0 for n in survivors),
          f"every shard process is gone: {exits}")
    launches = {"nfa_match": sum(captures[n]["kernels"]["nfa_match"] for n in ids),
                "window_scan": sum(captures[n]["kernels"]["window_scan"] for n in ids),
                "pow_verify": sum(captures[n]["kernels"]["pow_verify"] for n in ids)}
    check(dev.type != "cuda" or all(captures[n]["kernels"]["nfa_match"] > 0
                                    and captures[n]["kernels"]["window_scan"] > 0 for n in ids),
          f"kernels A and B launched in every shard: {out['captures']}")
    check(dev.type != "cuda" or captures[asker]["kernels"]["pow_verify"] > 0,
          "kernel C launched on the requests' shard")
    return launches


# ------------------------------------------------------------ the scenario harness


def kernel_libs() -> dict:
    from banjax_tpu_torch.matcher.kernels import fused_match_window as fmw
    from banjax_tpu_torch.matcher.kernels import nfa_match, pow_verify

    return {"nfa_match": nfa_match.KERNEL, "window_scan": fmw.KERNEL,
            "pow_verify": pow_verify.KERNEL}


def launch_counts() -> dict:
    return {name: lib.launches for name, lib in kernel_libs().items()}


def run_scenarios(dev, seed, scale, chaos_episodes, mega_ips, mega_chunk, mega_capacity,
                  mega_sketch_width) -> dict:
    """Every attack shape of `scenarios/shapes.py` at `scale` through
    `ScenarioRunner` on `dev` (TorchMatcher with device windows, the
    pipeline, the SLO engine): log_rotation through the tailer,
    command_flood direct and through the broker stand-in, challenge_storm
    with `challenge_device_verify` (kernel C checks the solvers' cookies),
    one flash_crowd pass under a ChaosSchedule over the pipeline's
    failpoints with a flight recorder. Then the mega rotation
    (`mega_rotating_proxies_stream`) at `mega_ips` distinct IPs through
    `TorchMatcher.consume_lines` in `mega_chunk`-line chunks, with tiering's
    cuts (slots, warm tier, slot admission, a wide sketch). Every clean
    run must equal the oracle (recall and precision 1.0) and hold its
    invariants; the challenge loop must be exact; benign must ban nothing
    and breach no SLO; the chaos pass must close its accounting (refused
    lines in drain errors), leave a bundle per episode and nothing armed,
    with its precision and recall reported; the mega run must give the
    oracle's bans. Returns the launches of A, B and C."""
    import os
    import tempfile
    from collections import Counter

    from banjax_tpu_torch.config import config_from_yaml_text
    from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
    from banjax_tpu_torch.ingest.broker_standin import KafkaBrokerStandIn
    from banjax_tpu_torch.matcher.runner import TorchMatcher
    from banjax_tpu_torch.resilience import failpoints
    from banjax_tpu_torch.scenarios import ChaosSchedule, ScenarioRunner, generate, oracle, shapes
    from banjax_tpu_torch.scenarios.chaos import PIPELINE_POINTS
    from banjax_tpu_torch.scenarios.runtime import RecordingBanner

    here = os.path.dirname(os.path.abspath(__file__))
    workdir_obj = tempfile.TemporaryDirectory(prefix="scenarios-", dir=os.path.join(here, "build"))
    workdir = workdir_obj.name
    for lib in kernel_libs().values():
        lib.reset_launches()
    broker = KafkaBrokerStandIn().start()
    runs = [
        ("flash_crowd", "direct", {}),
        ("slow_drip", "direct", {}),
        ("rotating_proxies", "direct", {}),
        ("command_flood", "direct", {}),
        ("command_flood", "kafka", {"kafka_broker": broker}),
        ("challenge_storm", "direct", {"cfg_overrides": {"challenge_device_verify": True}}),
        ("log_rotation", "tailer", {"via_tailer": True, "tmp_dir": workdir}),
        ("benign", "direct", {}),
        ("flash_crowd", "chaos", {"flightrec_dir": os.path.join(workdir, "flightrec")}),
    ]
    reports = []
    try:
        for name, mode, kw in runs:
            sc = generate(name, seed, scale)
            if mode == "chaos":
                kw["chaos"] = ChaosSchedule(seed, len(sc.events), points=PIPELINE_POINTS,
                                            episodes=chaos_episodes)
            before = launch_counts()
            t0 = time.perf_counter()
            rep = ScenarioRunner(sc, device=dev, **kw).run()
            seconds = time.perf_counter() - t0
            launches = {k: v - before[k] for k, v in launch_counts().items()}
            row = {
                "phase": "scenarios", "shape": name, "mode": mode, "scale": scale,
                "lines": rep.n_lines, "commands": rep.n_commands, "seconds": seconds,
                "feed_s": rep.feed_s, "lines_per_s": rep.lines_per_sec,
                "shed_lines": rep.shed_lines, "drain_error_lines": rep.drain_error_lines,
                "refused_lines": rep.refused_lines, "stale_lines": rep.stale_lines,
                "fallback_batches": rep.fallback_batches,
                "engine_bans": rep.engine_bans, "oracle_bans": rep.oracle_bans,
                "recall": rep.recall, "precision": rep.precision,
                "device_p99_ms": rep.device_p99_ms, "slo_burn_peak": rep.slo_burn_peak,
                "slo_breached": rep.slo_breached, "invariants": rep.invariants,
                "command_items": rep.command_items, "launches": launches,
            }
            if rep.challenge is not None:
                row["challenge"] = rep.challenge
            if mode == "chaos":
                row["episodes"] = [{k: ep[k] for k in ("point", "count", "probability",
                                                       "at_event", "fired")}
                                   | {"bundle": bool(ep["bundle"])} for ep in rep.episodes]
                row["incidents"] = rep.incidents
            emit(row)
            reports.append((name, mode, rep, launches))
    finally:
        broker.stop()
    for name, mode, rep, launches in reports:
        bad = {k: v for k, v in rep.invariants.items() if not v}
        check(not bad, f"scenario {name} ({mode}) holds its invariants: {bad}")
        if mode == "chaos":
            check(rep.invariants.get("bundle_per_episode") is True
                  and sum(ep["fired"] for ep in rep.episodes) > 0
                  and not any(fp.get("count") for fp in failpoints.snapshot()),
                  f"the chaos pass fired, left a bundle per episode and nothing armed: "
                  f"{rep.episodes}")
            continue
        check(rep.recall == 1.0 and rep.precision == 1.0 and rep.shed_lines == 0
              and rep.drain_error_lines == 0,
              f"scenario {name} ({mode}) equals the oracle: recall {rep.recall}, "
              f"precision {rep.precision}, shed {rep.shed_lines}")
        check(rep.oracle_bans > 0 or name == "benign", f"scenario {name} is not vacuous")
        if name == "benign":
            check(rep.engine_bans == 0 and not any(rep.slo_breached.values()),
                  "benign bans nothing and breaches no SLO")
        if name == "challenge_storm":
            ch = rep.challenge
            check(ch["ban_precision"] == 1.0 and ch["ban_recall"] == 1.0
                  and ch["verify_path"] == "device" and ch["solver_passes"] == ch["solvers"] > 0,
                  f"the challenge loop is exact on the device verifier: {ch}")
            check(dev.type != "cuda" or launches["pow_verify"] > 0,
                  f"kernel C checked the solvers' cookies: {launches}")
        if mode in ("kafka", "direct") and name == "command_flood":
            check(rep.command_items == rep.n_commands > 0, f"every command drained ({mode})")
        check(dev.type != "cuda" or (launches["nfa_match"] > 0 and launches["window_scan"] > 0),
              f"kernels A and B launched for {name} ({mode}): {launches}")

    # the mega rotation: consume_lines in device-batch chunks, tiering's cuts
    cfg = config_from_yaml_text(shapes.RULES_YAML)
    cfg.matcher = "tpu"
    cfg.matcher_device_windows = True
    cfg.matcher_batch_lines = mega_chunk
    cfg.matcher_window_capacity = mega_capacity
    cfg.traffic_sketch_enabled = True
    cfg.traffic_sketch_width = mega_sketch_width
    cfg.slot_admission_enabled = True
    cfg.warm_tier_enabled = True
    banner = RecordingBanner()
    m = TorchMatcher(cfg, banner, StaticDecisionLists(cfg), device=dev)
    before = launch_counts()
    n_lines = 0
    sync(dev)
    t0 = time.perf_counter()
    for lines in shapes.mega_rotating_proxies_stream(seed, mega_ips, chunk=mega_chunk):
        m.consume_lines(lines, now_unix=shapes.RUN_NOW)
        n_lines += len(lines)
    sync(dev)
    wall = time.perf_counter() - t0
    mega_launches = {k: v - before[k] for k, v in launch_counts().items()}
    want = oracle.expected_bans(shapes.mega_offenders(seed), config_from_yaml_text(shapes.RULES_YAML))
    precision, recall, _ = oracle.precision_recall(banner.regex_ban_logs, want)
    tiers = m.device_windows.tier_counters()
    emit({"phase": "scenarios", "shape": "mega_rotating_proxies", "mode": "consume_lines",
          "distinct_ips": mega_ips, "chunk": mega_chunk, "lines": n_lines, "wall_s": wall,
          "lines_per_s": n_lines / wall, "engine_bans": len(banner.regex_ban_logs),
          "oracle_bans": len(want), "recall": recall, "precision": precision,
          "reduced": {"matcher_window_capacity": mega_capacity,
                      "traffic_sketch_width": mega_sketch_width},
          "tier_counters": tiers, "host_us_per_line_by_stage": stage_us(m, n_lines),
          "launches": mega_launches})
    m.close()
    check(Counter(banner.regex_ban_logs) == Counter(want) and len(want) > 0,
          f"the mega rotation gives the oracle's bans: {len(banner.regex_ban_logs)} "
          f"against {len(want)}")
    check(tiers["slot_refusals"] > 0, "slot admission refused the rotation's one-off IPs")
    check(dev.type != "cuda" or (mega_launches["nfa_match"] > 0
                                 and mega_launches["window_scan"] > 0),
          f"kernels A and B launched on the mega rotation: {mega_launches}")
    workdir_obj.cleanup()
    return launch_counts()


# ------------------------------------------------------------ the fabric dry run


def run_fabric_dryrun(dev, seed, scale, workers, churn_scale) -> dict:
    """The port's fabric dry run (`fabric/harness.py`): `workers` worker
    processes of `python -m banjax_tpu_torch.fabric.worker`, each a full
    engine with its own CUDA context on the card (the harness passes
    `--device cpu` only for a CPU rehearsal), wire v2, decision
    replication through the broker stand-in. First flash_crowd at `scale`
    with a SIGKILL mid-flood and a rejoin from a snapshot; then a churn
    run at `churn_scale` (gossip detection with the feed paused, a join
    through a seed, a slow node's suspicion refuted, a planned leave).
    Recall 1.0 against the oracle, every ledger closed and the takeover
    complete are gated; precision is reported beside the frames and lines
    sent again past the ack deadline (a resent frame's lines are drained
    twice, as in JAX). No worker may be left running. Returns the
    workers' launches of A, B and C."""
    import os
    import tempfile

    from banjax_tpu_torch.fabric.harness import FabricDryrun

    here = os.path.dirname(os.path.abspath(__file__))
    workdir_obj = tempfile.TemporaryDirectory(prefix="dryrun-", dir=os.path.join(here, "build"))
    device = "cpu" if dev.type == "cpu" else None
    launches = {k: 0 for k in kernel_libs()}
    runs = [("kill_rejoin", dict(scale=scale, kill=True, rejoin=True)),
            ("churn", dict(scale=churn_scale, churn=True))]
    for tag, kw in runs:
        d = FabricDryrun(n_workers=workers, shape="flash_crowd", seed=seed, transport="v2",
                         device=device, log_dir=os.path.join(workdir_obj.name, tag), **kw)
        t0 = time.perf_counter()
        try:
            rep = d.run()
        finally:
            left = [w.wid for w in d.workers.values() if w.proc.poll() is None]
        seconds = time.perf_counter() - t0
        for k, v in rep["launches"].items():
            launches[k] += v
        row = {"phase": "fabric_dryrun", "run": tag, "workers": workers, "seconds": seconds,
               "scale": rep["scale"], "lines": rep["n_lines"], "fed_lines": rep["fed_lines"],
               "acked_lines": rep["acked_lines"], "feed_s": rep["feed_s"],
               "lines_per_s": rep["lines_per_sec"], "recall": rep["recall"],
               "precision": rep["precision"], "engine_bans": rep["engine_bans"],
               "oracle_bans": rep["oracle_bans"], "resent": rep["resent"],
               "duplicates_suppressed": rep["duplicates_suppressed"],
               "takeover": rep["takeover"], "invariants": rep["invariants"],
               "launches": rep["launches"], "workers_left_running": left}
        for k in ("rejoin", "join", "suspect_refute", "leave"):
            if k in rep:
                row[k] = rep[k]
        emit(row)
        bad = {k: v for k, v in rep["invariants"].items() if not v}
        check(not bad, f"the {tag} dry run holds its invariants: {bad}")
        check(rep["recall"] == 1.0 and rep["fed_lines"] == rep["acked_lines"]
              and bool(rep["takeover"]), f"the {tag} dry run kept every ban and took over")
        if tag == "kill_rejoin":
            check(all(rep["rejoin"]["invariants"].values()), f"the rejoin: {rep['rejoin']}")
        else:
            check(all(rep[k]["invariants"].values() for k in ("join", "suspect_refute", "leave")),
                  "the join, the refuted suspicion and the planned leave")
        check(not left, f"no worker is left running: {left}")
        check(dev.type != "cuda" or (rep["launches"].get("nfa_match", 0) > 0
                                     and rep["launches"].get("window_scan", 0) > 0),
              f"kernels A and B launched in the {tag} workers: {rep['launches']}")
    workdir_obj.cleanup()
    return launches


# ------------------------------------------------------------ fused UA matching

# BASELINE config 4 (tests/perf/test_baseline_ladder.py:224-231): its
# default-config-shaped rate rules and UA lists
UA_RATE_RULES = r"""
regexes_with_rates:
  - rule: "All GET requests"
    regex: '^GET'
    interval: 30
    hits_per_interval: 800
    decision: nginx_block
  - rule: "POST flood"
    regex: '^POST'
    interval: 60
    hits_per_interval: 45
    decision: iptables_block
  - rule: "wp-login brute force"
    regex: 'POST [^ ]* POST /wp-login\.php'
    interval: 300
    hits_per_interval: 10
    decision: iptables_block
  - rule: "xmlrpc"
    regex: '(GET|POST) [^ ]* (GET|POST) /xmlrpc\.php'
    interval: 300
    hits_per_interval: 10
    decision: iptables_block
  - rule: "env probe"
    regex: '/\.env'
    interval: 60
    hits_per_interval: 0
    decision: iptables_block
  - rule: "scanner UA"
    regex: '(?i)sqlmap|nikto|nessus'
    interval: 60
    hits_per_interval: 2
    decision: challenge
  - rule: "instant challenge"
    regex: '.*challengeme.*'
    interval: 1
    hits_per_interval: 0
    decision: challenge
"""
UA_LISTS = {"challenge": ["Mozilla/4\\.[0-9]", "scanner"], "nginx_block": ["sqlmap|nikto"]}


def access_log_lines(n: int, now: float, n_ips: int, seed: int = 0) -> list:
    """BASELINE config 4's access-log lines (the ladder's generator)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    hosts = ["example.com", "site.org"]
    paths = ["/", "/index.html", "/api/v1/items", "/news/2026"]
    uas = ["Mozilla/5.0 (X11; Linux x86_64)", "curl/8.1", "sqlmap/1.7"]
    out = []
    for i in range(n):
        ip = f"10.{(i % n_ips) >> 16 & 255}.{(i % n_ips) >> 8 & 255}.{i % n_ips & 255}"
        path = paths[rng.integers(len(paths))]
        method = "GET" if rng.random() < 0.8 else "POST"
        out.append(f"{now:.6f} {ip} {method} {hosts[i % 2]} {method} {path} "
                   f"HTTP/1.1 {uas[rng.integers(len(uas))]} | 200")
    return out


def run_ua_fused(dev, lines, ips, batch) -> dict:
    """BASELINE config 4's shape on `dev`: `lines` access-log lines from
    `ips` distinct IPs. `DeviceUAMatcher` (the UA lists as NFA columns
    after the rate rules, one kernel-A pass a batch): `check_batch` over
    the lines' User-Agents must give `check_ua_decision` for every row, and
    `match_bits` over the lines' rests must give rate columns equal to a
    rate-only kernel-A pass. Then the same lines through a TorchMatcher
    with device windows (auto-sized, as config 4 runs it): the ban
    multiset must equal the oracle's and no slot may be evicted. Rows
    `encode_for_match` sends to the host are evaluated there (the JAX
    semantics) and counted. Returns the launches of A, B and C."""
    from collections import Counter

    from banjax_tpu_torch.config import config_from_yaml_text
    from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
    from banjax_tpu_torch.decisions.ua_lists import build_ua_rules, check_ua_decision
    from banjax_tpu_torch.matcher.fused import DeviceUAMatcher
    from banjax_tpu_torch.matcher.runner import TorchMatcher
    from banjax_tpu_torch.scenarios import oracle, shapes
    from banjax_tpu_torch.scenarios.runtime import RecordingBanner

    rules = build_ua_rules(UA_LISTS)
    cfg = config_from_yaml_text(UA_RATE_RULES)
    rate = [r.regex_string for r in cfg.regexes_with_rates]
    log = access_log_lines(lines, shapes.T0 + 5.0, ips)
    uas = [ln.split(" HTTP/1.1 ")[1].rsplit(" | ", 1)[0] for ln in log]
    rests = [ln.split(" ", 2)[2] for ln in log]
    for lib in kernel_libs().values():
        lib.reset_launches()

    dm = DeviceUAMatcher(rules, backend=dev, extra_rules=rate)
    got = []
    sync(dev)
    t0 = time.perf_counter()
    for s in range(0, lines, batch):
        got += dm.check_batch(uas[s:s + batch])
    sync(dev)
    ua_wall = time.perf_counter() - t0
    ua_host_rows = dm.host_eval_rows
    t0 = time.perf_counter()
    want = [check_ua_decision(rules, ua) for ua in uas]
    serial_wall = time.perf_counter() - t0
    ua_mismatch = sum(a != b for a, b in zip(got, want))

    # match_bits over the rests against a rate-only pass (the rate rules
    # alone compiled for kernel A)
    rate_only = DeviceUAMatcher({}, backend=dev, extra_rules=rate)
    fused_s = rate_s = 0.0
    rate_mismatch = 0
    fused_host_before = dm.host_eval_rows
    for s in range(0, lines, batch):
        part = rests[s:s + batch]
        t0 = time.perf_counter()
        fb = dm.match_bits(part)
        fused_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        rb = rate_only.match_bits(part)
        rate_s += time.perf_counter() - t0
        rate_mismatch += int((fb[:, :len(rate)] != rb).any(axis=1).sum())
    bits_host_rows = dm.host_eval_rows - fused_host_before
    ua_launches = launch_counts()

    # BASELINE config 4's matcher: the same lines, device windows auto-sized
    mcfg = config_from_yaml_text(UA_RATE_RULES)
    mcfg.matcher = "tpu"
    mcfg.matcher_device_windows = True
    mcfg.matcher_window_capacity = 0
    banner = RecordingBanner()
    m = TorchMatcher(mcfg, banner, StaticDecisionLists(mcfg), device=dev)
    sync(dev)
    t0 = time.perf_counter()
    for s in range(0, lines, mcfg.matcher_batch_lines):
        m.consume_lines(log[s:s + mcfg.matcher_batch_lines], now_unix=shapes.RUN_NOW)
    sync(dev)
    m_wall = time.perf_counter() - t0
    dw = m.device_windows
    sc = shapes.Scenario(name="baseline_config4", seed=0, scale=1.0, rules_yaml=UA_RATE_RULES,
                         events=[shapes.LineChunk(tuple(log))], benign=False)
    oracle_bans = oracle.expected_bans(sc, config_from_yaml_text(UA_RATE_RULES))
    evictions, grows, capacity = dw.eviction_count, dw.grow_count, dw.capacity
    m.close()
    launches = launch_counts()
    emit({
        "phase": "ua_fused", "lines": lines, "distinct_ips": ips, "batch": batch,
        "ua_patterns": len(dm._rows), "rate_rules": len(rate),
        "host_rate_rules": [rate[i] for i in rate_only._host_rule_idx],
        "check_batch": {"rows_per_s": lines / ua_wall, "wall_s": ua_wall,
                        "mismatches": ua_mismatch, "host_eval_rows": ua_host_rows,
                        "serial_check_ua_decision_rows_per_s": lines / serial_wall},
        "match_bits": {"rows_per_s": lines / fused_s, "wall_s": fused_s,
                       "rate_only_rows_per_s": lines / rate_s,
                       "rate_column_mismatch_rows": rate_mismatch,
                       "host_eval_rows": bits_host_rows,
                       "rate_only_host_eval_rows": rate_only.host_eval_rows},
        "matcher": {"lines_per_s": lines / m_wall, "wall_s": m_wall,
                    "engine_bans": len(banner.regex_ban_logs), "oracle_bans": len(oracle_bans),
                    "evictions": evictions, "grows": grows, "capacity": capacity},
        "launches": launches, "launches_fused_checks": ua_launches,
    })
    check(ua_mismatch == 0, f"the UA decisions equal check_ua_decision: {ua_mismatch} differ")
    check(rate_mismatch == 0, f"the fused rate columns equal the rate-only pass: "
          f"{rate_mismatch} rows differ")
    check(Counter(banner.regex_ban_logs) == Counter(oracle_bans) and len(oracle_bans) > 0,
          f"config 4's matcher gives the oracle's bans: {len(banner.regex_ban_logs)} "
          f"against {len(oracle_bans)}")
    check(evictions == 0 and (ips <= dw.AUTO_START_CAPACITY or capacity >= ips),
          f"the auto-sized windows held every IP without evicting: {evictions}, {capacity}")
    check(dev.type != "cuda" or (launches["nfa_match"] > 0 and launches["window_scan"] > 0),
          f"kernels A and B launched in the phase: {launches}")
    return launches


# ------------------------------------------------------------ the device mesh


def run_mesh(dev, n_rules, batch_lines, max_line_len, capacity, chunks, n_ips, n_offenders,
             offender_hits, chunks_per_call, grids, matcher_grid) -> tuple:
    """The device mesh (`parallel/mesh.py`) on `dev`, every member on it.

    (a) `ShardedMatchBackend` for each dp x rp grid on the deploy rules
    (rp * k shards, k the least that fits kernel A), on one chunk of
    traffic at 2 % attack (fused two-stage) and one of nothing but attack
    lines (candidate overflow, single-stage fallback): bits identical to
    the same backend on the CPU (plain versions) and to the single-device
    TorchMatcher's `_match_bits`; every member launched kernel A. Kernel A
    at the members' shapes against its plain version, timed.
    (b) A mesh-mode TorchMatcher (`matcher_grid`) over `chunks` chunks and
    the attack chunk: ban log and result keys identical to a single-device
    TorchMatcher fed the same lines, then the same through
    `PipelineScheduler` with nothing shed; lines/s of both.
    (c) The deploy file with `matcher_mesh_devices: 1` gives a 1 x 1 mesh
    on the card. Returns (launches of A, B and C on (b) and (c), kernel A's
    rows at the mesh shapes)."""
    import numpy as np
    import torch
    import yaml

    from banjax_tpu_torch import workload
    from banjax_tpu_torch.config import config_from_yaml_text
    from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
    from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
    from banjax_tpu_torch.effectors.banner import Banner
    from banjax_tpu_torch.matcher import encode
    from banjax_tpu_torch.matcher.kernels import nfa_match, sass_alu
    from banjax_tpu_torch.matcher.prefilter import build_plan
    from banjax_tpu_torch.matcher.runner import OLD_LINE_CUTOFF_SECONDS, TorchMatcher
    from banjax_tpu_torch.matcher.workset import ListWork
    from banjax_tpu_torch.parallel import mesh
    from banjax_tpu_torch.pipeline.scheduler import PipelineScheduler

    cpu = torch.device("cpu")
    patterns = workload.generate_rules(n_rules, seed=SEED)
    now = time.time()
    lines = workload.access_log(
        chunks * batch_lines, patterns, now, seed=SEED, n_ips=n_ips,
        n_offenders=n_offenders, offender_hits=offender_hits,
    )
    attack = workload.attack_lines(batch_lines, patterns, now, seed=SEED)
    burst_at = (chunks // 2) * batch_lines
    lines[burst_at:burst_at] = attack

    def yaml_for(**keys):
        return workload.rules_config(
            patterns, seed=SEED, matcher="tpu", matcher_batch_lines=batch_lines,
            matcher_max_line_len=max_line_len, matcher_device_windows=True,
            matcher_window_capacity=capacity, matcher_prefilter=True,
            pallas_single_kernel="on", **keys,
        )

    def new_matcher(text, **kw):
        cfg = config_from_yaml_text(text)
        log = io.StringIO()
        banner = Banner(DynamicDecisionLists(start_sweeper=False), log, io.StringIO())
        return TorchMatcher(cfg, banner, StaticDecisionLists(cfg), device=dev, **kw), log

    def reset_launches():
        for lib in kernel_libs().values():
            lib.reset_launches()

    single, single_log = new_matcher(yaml_for())

    # ---- (a) the backend on each grid against the CPU and one device ----
    inputs = {}
    for name, chunk in (("traffic", lines[:batch_lines]), ("attack", attack)):
        work = ListWork()
        for i, ln in enumerate(chunk):
            work.append((i, encode.parse_line(ln, now, OLD_LINE_CUTOFF_SECONDS)))
        enc = encode.encode_for_match(single.compiled, [p.rest for _, p in work], max_line_len)
        rows = np.flatnonzero(~enc[2])
        want = single._match_bits(work, enc)[rows]
        want[:, single._host_rule_idx] = 0
        inputs[name] = (enc[0][rows], enc[1][rows], want)
    grid_rows = {}
    shape_rows = {}
    # kernel A's byte-step loop in the SASS, for the members' ALU-pipe bound
    sass = sass_alu.sass_of(nfa_match.KERNEL.path) if dev.type == "cuda" else None
    step_loops = {}
    for dp, rp in grids:
        tag = f"{dp}x{rp}"
        t0 = time.perf_counter()
        compiled = mesh.compile_for_mesh(patterns, rp)
        plan = build_plan(patterns, byte_classes=(compiled.byte_to_class, compiled.n_classes),
                          stage2_shards=compiled.n_shards)
        card = mesh.ShardedMatchBackend(compiled, mesh.make_mesh([dev] * (dp * rp), rp),
                                        max_line_len, plan=plan)
        host = mesh.ShardedMatchBackend(compiled, mesh.make_mesh([cpu] * (dp * rp), rp),
                                        max_line_len, plan=plan)
        setup_s = time.perf_counter() - t0
        row = {"dp": dp, "rp": rp, "shards": compiled.n_shards,
               "shards_per_member": compiled.n_shards // rp,
               "words_per_shard": compiled.words_per_shard,
               "stage2_shards_per_member": plan.stage2.n_shards // rp, "setup_s": setup_s}
        member_shapes = {}
        for name, (cls, lens, want) in inputs.items():
            before = (card.fused_batches, card.fallback_batches)
            ms = []
            for _ in range(2):  # the first call pays one-time costs
                sync(dev)
                t0 = time.perf_counter()
                pend = card.submit(cls, lens)
                got = card.collect(pend)
                sync(dev)
                ms.append(1e3 * (time.perf_counter() - t0))
            # a row's lines, and its candidate slots
            member_shapes[name] = (pend["Bp"] // card.dp, pend["K"])
            t0 = time.perf_counter()
            plain = host.match_bits(cls, lens)
            cpu_s = time.perf_counter() - t0
            row[name] = {
                "lines": int(cls.shape[0]), "first_ms": ms[0], "ms": ms[1], "cpu_plain_s": cpu_s,
                "fused": (card.fused_batches - before[0]) // 2,
                "fallback": (card.fallback_batches - before[1]) // 2,
                "equal_cpu": bool(np.array_equal(got, plain)),
                "equal_single_device": bool(np.array_equal(got, want)),
                "rows_matching": int(got.any(axis=1).sum()),
            }
            check(row[name]["equal_cpu"], f"mesh {tag} ({name}): bits equal the CPU's")
            check(row[name]["equal_single_device"],
                  f"mesh {tag} ({name}): bits equal the single-device matcher's")
        row["fused_batches"], row["fallback_batches"] = card.fused_batches, card.fallback_batches
        row["host_fused_batches"] = host.fused_batches
        row["host_fallback_batches"] = host.fallback_batches
        row["row_launches"], row["member_launches"] = card.row_launches, card.member_launches
        row["last_shard_merge_ms"] = card.last_shard_merge_ms
        grid_rows[tag] = row
        check(card.fused_batches > 0 and card.fallback_batches > 0,
              f"mesh {tag}: fused and fallback batches ({card.fused_batches}, "
              f"{card.fallback_batches})")
        check((2 * host.fused_batches, 2 * host.fallback_batches)
              == (card.fused_batches, card.fallback_batches),
              f"mesh {tag}: the CPU fused and fell back as the card did")
        check(dev.type != "cuda" or (min(card.row_launches) > 0
                                     and min(min(r) for r in card.member_launches) > 0),
              f"mesh {tag}: kernel A launched by every row and member: {card.member_launches}")
        # kernel A at the members' shapes: stage 2 over a row's candidate
        # slots, the single-stage fallback over a row's lines
        b_local, K = member_shapes["attack"]
        for name, slab, src, n in (("stage2_member", card._slabs2[0][0], "attack", K),
                                   ("single_member", card._slabs[0][0], "traffic", b_local)):
            cls_np, lens_np, _ = inputs[src]
            L_p = min(cls_np.shape[1], -(-int(lens_np[:n].max()) // 32) * 32)
            c = torch.from_numpy(np.ascontiguousarray(cls_np[:n, :L_p])).to(dev)
            ln = torch.from_numpy(np.ascontiguousarray(lens_np[:n])).to(dev)
            got = nfa_match.accept_words(slab, c, ln)
            want = nfa_match.accept_words_plain(slab, c, ln)
            sync(dev)
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            check(err == 0, f"kernel A (mesh {tag} {name}) is bit-identical to its plain version")
            bound, by = nfa_bound_ms(slab, c, ln)
            R = nfa_match.lines_per_thread(slab, n, dev)
            key = ("free" if slab.carry_free else "carry", R)
            if sass is not None and key not in step_loops:
                step_loops[key] = sass_alu.count(sass, not slab.carry_free, R)
            alu = step_loops[key]["alu_per_line_byte"] if sass is not None else None
            shape_rows[f"mesh_{tag}_{name}"] = {
                "lines": n, "bytes": L_p, "words": slab.n_words, "shards": slab.n_shards,
                "classes": slab.n_classes, "carry": not slab.carry_free,
                "line_bytes": line_bytes(c, ln), "max_abs_err": err,
                "lines_per_thread": R, "alu_per_line_byte_word": alu,
                "ms": time_ms(lambda: nfa_match.accept_words(slab, c, ln), dev, 20),
                "device_ms": graph_ms(lambda: nfa_match.accept_words(slab, c, ln), dev),
                "host_enqueue_us": host_enqueue_us(
                    lambda: nfa_match.accept_words(slab, c, ln), dev),
                "plain_ms": time_ms(lambda: nfa_match.accept_words_plain(slab, c, ln), dev, 2),
                "bound_ms": bound, "bound_by": by,
                "alu_bound_ms": None if alu is None else nfa_alu_bound_ms(slab, c, ln, alu),
            }
        del card, host

    # ---- (b) the mesh-mode matcher against the single-device one ----
    dp, rp = matcher_grid
    mesh_yaml = yaml_for(matcher_mesh_devices=dp * rp, matcher_mesh_rp=rp)
    calls = [lines[s : s + chunks_per_call * batch_lines]
             for s in range(0, len(lines), chunks_per_call * batch_lines)]

    def drive(m):
        keys = []
        sync(dev)
        t0 = time.perf_counter()
        for batch in calls:
            keys += [result_key(r) for r in m.consume_lines(batch, now_unix=now)]
        sync(dev)
        return keys, time.perf_counter() - t0

    # in turns: one device, the mesh, the pipelined mesh, one device again
    single_keys, single_s = drive(single)
    single.close()
    del single
    reset_launches()
    mm_matcher, mesh_log = new_matcher(mesh_yaml, mesh_devices=[dev] * (dp * rp))
    mm = mm_matcher._mesh_matcher
    check(mm is not None and (mm.dp, mm.rp) == (dp, rp), "the mesh-mode matcher engaged")
    check(mm_matcher._fw_pipeline is None and mm_matcher._prefilter is None,
          "the mesh matcher commits on the classic path")
    mesh_keys, mesh_s = drive(mm_matcher)
    sync_launches = launch_counts()
    sync_row = {"wall_s": mesh_s, "lines_per_s": len(lines) / mesh_s,
                "fused_batches": mm.fused_batches, "fallback_batches": mm.fallback_batches,
                "row_launches": list(mm.row_launches),
                "member_launches": [list(r) for r in mm.member_launches],
                "match_submits": mm.fused_batches + mm.fallback_batches,
                "submit_ms_ewma": mm.submit_ms_ewma, "merge_ms_ewma": mm.merge_ms_ewma,
                "last_shard_merge_ms": mm.last_shard_merge_ms,
                "host_us_per_line_by_stage": stage_us(mm_matcher, len(lines)),
                "launches": sync_launches}
    same_keys = mesh_keys == single_keys
    same_log = mesh_log.getvalue() == single_log.getvalue()
    mm_matcher.close()
    del mm_matcher

    # the same lines through the streaming pipeline
    reset_launches()
    pm, pipe_log = new_matcher(mesh_yaml, mesh_devices=[dev] * (dp * rp))
    drained = []
    sch = PipelineScheduler(lambda: pm, on_results=lambda bl, rs: drained.append(len(bl)),
                            now_fn=lambda: now)
    sch.start()
    sync(dev)
    t0 = time.perf_counter()
    try:
        for s in range(0, len(lines), batch_lines):
            sch.submit(lines[s : s + batch_lines])
        flushed = sch.flush(300)
    finally:
        sch.stop()
    sync(dev)
    pipe_s = time.perf_counter() - t0
    shed = sch.stats.peek()["PipelineShedLines"]
    pipe_launches = launch_counts()
    pipe_row = {"wall_s": pipe_s, "lines_per_s": len(lines) / pipe_s, "batches": len(drained),
                "shed_lines": shed, "fused_batches": pm._mesh_matcher.fused_batches,
                "fallback_batches": pm._mesh_matcher.fallback_batches,
                "launches": pipe_launches}
    same_pipe_log = pipe_log.getvalue() == mesh_log.getvalue()
    pm.close()
    del pm
    again, again_log = new_matcher(yaml_for())
    again_keys, again_s = drive(again)
    same_again = again_keys == single_keys and again_log.getvalue() == single_log.getvalue()
    again.close()
    del again

    # ---- (c) the deploy file's mesh keys: one member on the card ----
    with open("deploy/banjax-config.yaml") as f:
        raw = yaml.safe_load(f)
    raw.update(matcher_mesh_devices=1)
    reset_launches()
    dm, _ = new_matcher(yaml.safe_dump(raw))
    dmm = dm._mesh_matcher
    engaged = dmm is not None and dmm.mesh.grid == ((dev,),)
    res = dm.consume_lines(lines[:batch_lines], now_unix=now) if engaged else []
    deploy_launches = launch_counts()
    deploy_row = {"engaged": engaged, "grid": None if dmm is None else [dmm.dp, dmm.rp],
                  "lines": len(res), "errors": sum(r.error for r in res),
                  "member_launches": None if dmm is None else dmm.member_launches,
                  "launches": deploy_launches}
    dm.close()
    del dm

    emit({"phase": "mesh", "rules": n_rules, "batch_lines": batch_lines,
          "lines": len(lines), "window_slots": capacity, "tolerance": 0, "grids": grid_rows,
          "matcher": {"grid": [dp, rp], "single_device": {
              "wall_s": single_s, "lines_per_s": len(lines) / single_s,
              "again_wall_s": again_s, "again_lines_per_s": len(lines) / again_s,
              "again_identical": same_again},
              "mesh_sync": sync_row, "mesh_pipelined": pipe_row,
              "result_keys_identical": same_keys, "ban_log_identical": same_log,
              "pipelined_ban_log_identical": same_pipe_log,
              "ban_log_lines": mesh_log.getvalue().count("\n")},
          "deploy_1x1": deploy_row})
    check(same_keys and same_log, "the mesh matcher's results and ban log equal one device's")
    check(same_again, "a second single-device matcher wrote the first one's ban log")
    check(mesh_log.getvalue().count("\n") > 0, "the mesh matcher banned the offenders")
    check(flushed and shed == 0 and same_pipe_log,
          f"the pipelined mesh wrote the same ban log, nothing shed ({shed})")
    check(sync_row["fused_batches"] > 0 and sync_row["fallback_batches"] > 0,
          "the mesh matcher fused and fell back")
    check(dev.type != "cuda" or (min(sync_row["row_launches"]) > 0
                                 and min(min(r) for r in sync_row["member_launches"]) > 0
                                 and sync_launches["window_scan"] > 0),
          f"every member of the mesh matcher launched kernel A, and kernel B ran: {sync_row}")
    check(engaged and deploy_row["errors"] == 0, "the deploy file's keys engaged a 1 x 1 mesh")
    check(dev.type != "cuda" or dmm.member_launches[0][0] > 0,
          "the 1 x 1 mesh launched kernel A")
    launches = {k: sync_launches[k] + pipe_launches[k] + deploy_launches[k]
                for k in sync_launches}
    return launches, shape_rows


def run_matcher_modes(dev, n_rules, batch_lines, max_line_len, capacity, chunks, n_ips,
                      n_offenders, offender_hits, chunks_per_call, depths, prefix_lines,
                      cross_check_capacity) -> tuple:
    """The matcher modes beside the single program, on `dev`, each on a
    fresh matcher, in turns in one process, over `mesh`'s traffic (the
    main path's rules and chunks, plus the all-attack chunk):

    (1) the single program (`pallas_single_kernel: on`), synchronous: the
        comparison base;
    (2) the two programs (`pallas_single_kernel: off`), synchronous;
    (3) the same through `PipelineScheduler` at each drain_resolve_depth
        of `depths`;
    (4) host windows (`matcher_device_windows: false`), synchronous and
        pipelined;
    (5) `matcher: cpu` (`CpuMatcher`, Python `re`) on the first
        `prefix_lines` lines, against (1) and (4) on the same prefix.

    Every mode's ban-log bytes and result keys must be (1)'s,
    `format_states` (1)'s for (2)-(3) and, on the prefix, (4)'s for (5);
    nothing may be shed. Before the drives, program A's buffer and
    program B's event buffer on a traffic chunk and the attack chunk
    must equal a two-program matcher's on the CPU (plain versions,
    `cross_check_capacity` slots: the slot numbering is the same),
    tolerance 0. Kernel launches a `consume_lines` call must be the
    predicted ones: A 2 and B 1 a chunk on the single and two-program
    paths, A 2 and B 0 with host windows; the call holding the attack
    chunk adds one single-stage launch of A (its candidates overflow),
    with host windows one a chunk of the call (the whole call reruns
    single-stage); the pipelined runs take the synchronous calls'
    batches, and launch what those did. Reported: lines/s, host µs a line by stage,
    DrainResolveOverlapMs. Returns (the drives' launches of A, B and C,
    the phase's summary)."""
    import dataclasses

    import numpy as np
    import torch

    from banjax_tpu_torch import workload
    from banjax_tpu_torch.cli import build_matcher
    from banjax_tpu_torch.config import config_from_yaml_text
    from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
    from banjax_tpu_torch.decisions.rate_limit import RegexRateLimitStates
    from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
    from banjax_tpu_torch.effectors.banner import Banner
    from banjax_tpu_torch.matcher.cpu_ref import CpuMatcher
    from banjax_tpu_torch.matcher.fused_windows import PipelineOverflow
    from banjax_tpu_torch.pipeline.scheduler import PipelineScheduler

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    patterns = workload.generate_rules(n_rules, seed=SEED)
    now = time.time()
    lines = workload.access_log(
        chunks * batch_lines, patterns, now, seed=SEED, n_ips=n_ips,
        n_offenders=n_offenders, offender_hits=offender_hits,
    )
    attack = workload.attack_lines(batch_lines, patterns, now, seed=SEED)
    burst_at = (chunks // 2) * batch_lines
    lines[burst_at:burst_at] = attack
    per_call = chunks_per_call * batch_lines
    calls = [lines[s : s + per_call] for s in range(0, len(lines), per_call)]
    attack_call = burst_at // per_call
    # one parse of the rules; each mode is a copy with its keys
    base = config_from_yaml_text(workload.rules_config(
        patterns, seed=SEED, matcher="tpu", matcher_batch_lines=batch_lines,
        matcher_max_line_len=max_line_len, matcher_device_windows=True,
        matcher_window_capacity=capacity, matcher_prefilter=True, pallas_single_kernel="on",
    ))

    def new_matcher(device, **keys):
        cfg = dataclasses.replace(base, **keys)
        log = io.StringIO()
        states = RegexRateLimitStates()
        banner = Banner(DynamicDecisionLists(start_sweeper=False), log, io.StringIO())
        m = build_matcher(cfg, banner, StaticDecisionLists(cfg), states, device=device)
        return m, log, states

    def reset_launches():
        for lib in kernel_libs().values():
            lib.reset_launches()

    def states_of(m, states):
        return (m.device_windows or states).format_states()

    # ---- program A's and program B's buffers, card against CPU ----
    t0 = time.perf_counter()
    card, _, _ = new_matcher(dev, pallas_single_kernel="off")
    host, _, _ = new_matcher(cpu, pallas_single_kernel="off",
                             matcher_window_capacity=cross_check_capacity)
    buffers = {}
    subs = []
    for name, chunk in (("traffic", lines[:batch_lines]), ("attack", attack)):
        pair = []
        for m in (card, host):
            st = m.pipeline_begin(chunk, now)
            pair.append((m, m._submit_pipeline_chunk(st["work"], *st["pre"][:2])))
        subs.append((name, pair))
    for name, pair in subs:
        got = []
        for m, e in pair:
            p, fw = e["pend"], m._fw_pipeline
            try:
                fw.resolve(p)
                ok = True
            except PipelineOverflow:
                ok = False
                m.device_windows.release_pins(e["slots"])
                fw.fallback_done(p)
            events = None
            if ok:
                if p.events_copied is not None:
                    p.events_copied.synchronize()
                events = p.events_buf.numpy().tobytes()
                fw.collect(p)
            got.append((ok, p.buf.numpy().tobytes(), events, [int(x) for x in p.flags],
                        np.asarray(e["slots"])))
        (c_ok, c_a, c_b, c_flags, c_slots), (h_ok, h_a, h_b, h_flags, h_slots) = got
        buffers[name] = {"ok": c_ok, "flags": c_flags, "a_bytes": len(c_a),
                         "b_bytes": None if c_b is None else len(c_b),
                         "a_identical": c_a == h_a, "b_identical": c_b == h_b,
                         "slots_identical": bool(np.array_equal(c_slots, h_slots))}
        check(c_ok == h_ok and c_slots.shape == h_slots.shape
              and buffers[name]["slots_identical"],
              f"matcher_modes: the {name} chunk resolved as on the CPU")
        check(c_a == h_a, f"matcher_modes: program A's buffer ({name}) equals the CPU's")
        check(c_b == h_b, f"matcher_modes: program B's event buffer ({name}) equals the CPU's")
    check(buffers["traffic"]["ok"] and not buffers["attack"]["ok"],
          "matcher_modes: the traffic chunk committed, the attack chunk overflowed")
    card.close()
    host.close()
    del card, host
    gc.collect()
    buffers_s = time.perf_counter() - t0

    # ---- the drives ----
    def drive_sync(m):
        keys, per = [], []
        sync(dev)
        t0 = time.perf_counter()
        for batch in calls:
            before = launch_counts()
            keys += [result_key(r) for r in m.consume_lines(batch, now_unix=now)]
            after = launch_counts()
            per.append({k: after[k] - before[k] for k in after})
        sync(dev)
        return keys, time.perf_counter() - t0, per

    def drive_pipelined(m):
        """Every line buffered before the start, taken in the synchronous
        calls' batches (so that a depth-2 drain has later chunks to
        overlap)."""
        collected = []
        sch = PipelineScheduler(
            lambda: m, now_fn=lambda: now, min_batch=per_call, max_batch=per_call,
            on_results=lambda bl, rs: collected.append([result_key(r) for r in rs]))
        for s in range(0, len(lines), batch_lines):
            sch.submit(lines[s : s + batch_lines])
        sync(dev)
        t0 = time.perf_counter()
        sch.start()
        try:
            flushed = sch.flush(300)
        finally:
            sch.stop()
        sync(dev)
        wall = time.perf_counter() - t0
        return ([k for ks in collected for k in ks], wall, flushed,
                sch.stats.peek()["PipelineShedLines"], len(collected))

    rows = {}
    totals = {k: 0 for k in kernel_libs()}
    base_out = None

    def run_mode(tag, pipelined, **keys):
        nonlocal base_out
        m, log, states = new_matcher(dev, **keys)
        gc.collect()
        reset_launches()
        if pipelined:
            got, wall, flushed, shed, batches = drive_pipelined(m)
            per = None
        else:
            got, wall, per = drive_sync(m)
            flushed, shed, batches = True, 0, len(calls)
        launches = launch_counts()
        for k, v in launches.items():
            totals[k] += v
        fw = m._fw_pipeline
        row = {"pipelined": pipelined, "wall_s": wall, "lines_per_s": len(lines) / wall,
               "batches": batches, "shed_lines": shed, "launches": launches,
               "launches_per_call": per,
               "two_program": fw is not None and not fw.single_kernel,
               "device_windows": m.device_windows is not None,
               "fused_chunks": None if fw is None else fw.fused_batches,
               "fallback_chunks": None if fw is None else fw.fallback_batches,
               "pipelined_fused_chunks": m.pipelined_fused_chunks,
               "pipelined_fused_fallbacks": m.pipelined_fused_fallbacks,
               "drain_resolve_depth": m.config.drain_resolve_depth,
               "drain_resolve_overlap_ms": m.drain_resolve_overlap_ms_ewma,
               "host_us_per_line_by_stage": stage_us(m, len(lines)),
               "ban_log_lines": log.getvalue().count("\n")}
        out = (got, log.getvalue(), states_of(m, states))
        if base_out is None:
            base_out = out
        row["result_keys_identical"] = got == base_out[0]
        row["ban_log_identical"] = out[1] == base_out[1]
        row["states_identical"] = out[2] == base_out[2]
        rows[tag] = row
        m.close()
        del m
        check(flushed and shed == 0, f"matcher_modes {tag}: drained, nothing shed ({shed})")
        check(row["result_keys_identical"] and row["ban_log_identical"],
              f"matcher_modes {tag}: result keys and ban log equal the single program's")
        return row

    def check_calls(tag, row, b_per_chunk, attack_extra_a):
        """A and B a consume_lines call: the predicted counts (a CPU
        rehearsal launches nothing, and is not checked)."""
        if dev.type != "cuda" and not any(sum(c.values()) for c in row["launches_per_call"]):
            return
        for i, (batch, got) in enumerate(zip(calls, row["launches_per_call"])):
            n = -(-len(batch) // batch_lines)
            if i == attack_call:
                ok = (got["nfa_match"] == 2 * n + attack_extra_a(n)
                      and (got["window_scan"] >= n if b_per_chunk else got["window_scan"] == 0))
            else:
                ok = got["nfa_match"] == 2 * n and got["window_scan"] == b_per_chunk * n
            check(ok and got["pow_verify"] == 0,
                  f"matcher_modes {tag}: launches of call {i} ({n} chunks) are the "
                  f"predicted ones: {got}")

    single = run_mode("single_sync", False, pallas_single_kernel="on")
    check(single["ban_log_lines"] > 0, "matcher_modes: the single program banned the offenders")
    check_calls("single_sync", single, 1, lambda n: 1)
    two = run_mode("two_program_sync", False, pallas_single_kernel="off")
    check(two["two_program"] and two["fused_chunks"] > 0 and two["fallback_chunks"] > 0,
          "matcher_modes: the two programs committed chunks and fell back on the attack chunk")
    check_calls("two_program_sync", two, 1, lambda n: 1)
    for depth in depths:
        r = run_mode(f"two_program_pipelined_depth{depth}", True, pallas_single_kernel="off",
                     drain_resolve_depth=depth)
        check(r["pipelined_fused_chunks"] > 0 and r["pipelined_fused_fallbacks"] > 0,
              f"matcher_modes depth {depth}: the drain committed chunks through program B "
              "and replayed the attack chunk")
        check(r["launches"] == two["launches"],
              f"matcher_modes depth {depth}: the synchronous calls' launches ({r['launches']})")
    for tag, pipelined in (("host_windows_sync", False), ("host_windows_pipelined", True)):
        r = run_mode(tag, pipelined, matcher_device_windows=False)
        check(not r["device_windows"] and r["fused_chunks"] is None,
              f"matcher_modes {tag}: host windows")
        check(dev.type != "cuda" or (r["launches"]["window_scan"] == 0
                                     and r["launches"]["nfa_match"] > 0),
              f"matcher_modes {tag}: kernel A and no kernel B: {r['launches']}")
        if not pipelined:
            check_calls(tag, r, 0, lambda n: n)
        else:
            check(r["launches"] == rows["host_windows_sync"]["launches"],
                  f"matcher_modes {tag}: the synchronous calls' launches ({r['launches']})")
    for tag, r in rows.items():
        if r["device_windows"]:
            check(r["states_identical"], f"matcher_modes {tag}: format_states equal (1)'s")

    # ---- (5) matcher: cpu on the prefix, against (1) and (4) ----
    prefix = lines[:prefix_lines]
    pre = {}
    for tag, keys, device in (("single", dict(pallas_single_kernel="on"), dev),
                              ("host_windows", dict(matcher_device_windows=False), dev),
                              ("cpu", dict(matcher="cpu"), None)):
        m, log, states = new_matcher(device, **keys)
        reset_launches()
        t0 = time.perf_counter()
        got = [result_key(r) for r in m.consume_lines(prefix, now_unix=now)]
        sync(dev)
        pre[tag] = {"keys": got, "log": log.getvalue(), "states": states_of(m, states),
                    "seconds": time.perf_counter() - t0, "launches": launch_counts(),
                    "class": type(m).__name__}
        m.close()
        del m
    check(pre["cpu"]["class"] == CpuMatcher.__name__, "matcher: cpu built CpuMatcher")
    check(sum(pre["cpu"]["launches"].values()) == 0, "CpuMatcher launched no kernel")
    prefix_row = {
        "lines": len(prefix),
        "seconds": {k: v["seconds"] for k, v in pre.items()},
        "ban_log_lines": pre["cpu"]["log"].count("\n"),
        "result_keys_identical": pre["cpu"]["keys"] == pre["single"]["keys"]
        == pre["host_windows"]["keys"],
        "ban_log_identical": pre["cpu"]["log"] == pre["single"]["log"]
        == pre["host_windows"]["log"],
        "states_identical_host_windows": pre["cpu"]["states"] == pre["host_windows"]["states"],
    }
    check(prefix_row["result_keys_identical"] and prefix_row["ban_log_identical"],
          "matcher_modes: CpuMatcher's results and ban log equal the card's on the prefix")
    check(prefix_row["states_identical_host_windows"],
          "matcher_modes: CpuMatcher's states equal host windows' on the prefix")
    check(prefix_row["ban_log_lines"] > 0, "matcher_modes: the prefix produced bans")

    summary = {"phase": "matcher_modes", "rules": n_rules, "batch_lines": batch_lines,
               "lines": len(lines), "window_slots": capacity, "tolerance": 0,
               "buffers": buffers, "buffers_s": buffers_s, "modes": rows,
               "cpu_prefix": prefix_row, "seconds": time.perf_counter() - t_phase}
    emit(summary)
    return totals, summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import banjax_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kernels, load = run(dev, **FULL)
    tier_launches = run_tiering(dev, **TIERING)
    for k in kernels:
        main = k["launches"]
        k["launches_by_path"] = {"main_path": main, "tiering": tier_launches[k["name"]]}
        k["launches"] = main + tier_launches[k["name"]]
    kernels += run_challenge(dev, **CHALLENGE, load=load)
    import os

    # the service's apps create the kernel's ipset: fakes stand in for it
    edge = FakeKernelEdge(os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                       "fake-kernel-edge"))
    try:
        t0 = time.perf_counter()
        service, service_summary = run_service(dev, **SERVICE, edge=edge)
        emit({"phase": "service_seconds", "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        # the pipeline's writes are stamped ahead of the clock, so that the
        # observability phase can append the same lines, fresh
        pipeline, writes = run_pipeline(dev, service_summary, **PIPELINE, edge=edge,
                                        stamp_base=time.time() + 600.0)
        emit({"phase": "pipeline_seconds", "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        observed = run_observability(dev, writes, **OBSERVABILITY, edge=edge)
        emit({"phase": "observability_seconds", "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        kafka = run_kafka(dev, writes, **KAFKA, edge=edge)
        emit({"phase": "kafka_seconds", "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        served = run_workers(dev, service_summary, **WORKERS, edge=edge)
        emit({"phase": "workers_seconds", "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        fabric = run_fabric(dev, **FABRIC, edge=edge)
        emit({"phase": "fabric_seconds", "seconds": time.perf_counter() - t0})
        calls = edge.calls()
    finally:
        edge.close()
    emit({"phase": "kernel_edge", "fake_calls": len(calls), "first_calls": calls[:3]})
    t0 = time.perf_counter()
    scenarios = run_scenarios(dev, **SCENARIOS)
    emit({"phase": "scenarios_seconds", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    dryrun = run_fabric_dryrun(dev, **FABRIC_DRYRUN)
    emit({"phase": "fabric_dryrun_seconds", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    ua_fused = run_ua_fused(dev, **UA_FUSED)
    emit({"phase": "ua_fused_seconds", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    meshed, mesh_shapes = run_mesh(dev, **MESH)
    emit({"phase": "mesh_seconds", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    modes, _ = run_matcher_modes(dev, **MATCHER_MODES)
    emit({"phase": "matcher_modes_seconds", "seconds": time.perf_counter() - t0})
    for k in kernels:
        k.setdefault("launches_by_path", {"challenge_path": k["launches"]})
        k["launches_by_path"]["service"] = service[k["name"]]
        k["launches_by_path"]["pipeline"] = pipeline[k["name"]]
        k["launches_by_path"]["observability"] = observed[k["name"]]
        k["launches_by_path"]["kafka"] = kafka[k["name"]]
        k["launches_by_path"]["workers"] = served[k["name"]]
        # the fabric's shard processes: counted in their own captures
        k["launches_by_path"]["fabric"] = fabric[k["name"]]
        # the scenario harness, the dry run's workers (their own counts,
        # read over the wire), fused UA matching
        k["launches_by_path"]["scenarios"] = scenarios[k["name"]]
        k["launches_by_path"]["fabric_dryrun"] = dryrun[k["name"]]
        k["launches_by_path"]["ua_fused"] = ua_fused[k["name"]]
        # the device mesh's matchers (the backend checks against the CPU
        # are comparisons, not counted)
        k["launches_by_path"]["mesh"] = meshed[k["name"]]
        # the two programs, host windows and matcher: cpu (the buffers'
        # card-vs-CPU comparison is not counted)
        k["launches_by_path"]["matcher_modes"] = modes[k["name"]]
        k["launches"] += (service[k["name"]] + pipeline[k["name"]] + observed[k["name"]]
                          + kafka[k["name"]] + served[k["name"]] + fabric[k["name"]]
                          + scenarios[k["name"]] + dryrun[k["name"]] + ua_fused[k["name"]]
                          + meshed[k["name"]] + modes[k["name"]])
        if k["name"] == "nfa_match":
            k["shapes"].update(mesh_shapes)
            k["max_abs_err"] = max(r["max_abs_err"] for r in k["shapes"].values())
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
