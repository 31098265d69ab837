#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's main path goes, on one GPU.

    python3 scripts/profile_torch_main_path.py [--chunks N]

Drives `TorchMatcher.consume_lines` on chip_smoke.py's configuration
(1,000 OWASP-CRS-shaped rules, 4,096-line chunks of 256-byte lines,
65,536 window slots; traffic without the all-attack chunk) with the
deploy file's host-tier keys: native parse, native slot manager, traffic
sketch, slot admission at the derived threshold and the warm tier (cut
to 131,072 records). Prints one JSON line per measurement:

* untraced: consume_lines over the first half of the measured chunks,
  with the matcher's host seconds by stage (`StageClock`: gate,
  admission, slots, sketch, chunk, refused, replay) in µs a line;
* trace: a `torch.profiler` trace (CPU + CUDA) of consume_lines over the
  second half — wall time, the summed time of every device event in it
  (kernels and copies), the device idle share (1 - device time / wall),
  device events per chunk, the events that took the most time, and the
  host stages again (under the profiler's own cost);
* the card's name and power limit.

The first chunk is a warm-up and is not measured. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH = 4096


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", type=int, default=16,
                    help="measured 4,096-line chunks (half untraced, half traced)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile: no CUDA device is available", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from banjax_tpu_torch import native, workload
    from banjax_tpu_torch.config import config_from_yaml_text
    from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
    from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
    from banjax_tpu_torch.effectors.banner import Banner
    from banjax_tpu_torch.matcher.kernels import _build, fused_match_window, nfa_match
    from banjax_tpu_torch.matcher.runner import TorchMatcher

    dev = torch.device("cuda", 0)
    _build.build_all([nfa_match.KERNEL, fused_match_window.KERNEL] + native.libraries())
    patterns = workload.generate_rules(1000, seed=7)
    cfg = config_from_yaml_text(workload.rules_config(
        patterns, seed=7, matcher="tpu", matcher_batch_lines=BATCH,
        matcher_max_line_len=256, matcher_device_windows=True,
        matcher_window_capacity=65536, pallas_single_kernel="on",
        matcher_native_parse=True, slotmgr_native=True, traffic_sketch_enabled=True,
        slot_admission_enabled=True, slot_admission_min_estimate=0,
        warm_tier_enabled=True, warm_tier_capacity=131072,
    ))
    now = time.time()
    lines = workload.access_log((args.chunks + 1) * BATCH, patterns, now, seed=7,
                                n_ips=50_000, n_offenders=40, offender_hits=40)
    matcher = TorchMatcher(cfg, Banner(DynamicDecisionLists(start_sweeper=False),
                                       io.StringIO(), io.StringIO()),
                           StaticDecisionLists(cfg), device=dev)
    matcher.consume_lines(lines[:BATCH], now_unix=now)  # warm-up
    measured = lines[BATCH:]

    def stages(n):
        return {k: v * 1e6 / n for k, v in sorted(matcher.clock.seconds.items())}

    def drive(part):
        matcher.clock.reset()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for s in range(0, len(part), 4 * BATCH):
            matcher.consume_lines(part[s : s + 4 * BATCH], now_unix=now)
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    # the first half untraced (the profiler's own cost), the second traced
    half = (args.chunks // 2) * BATCH
    untraced, traced = measured[:half], measured[half:]
    untraced_s = drive(untraced)
    untraced_stages = stages(len(untraced))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s = drive(traced)
    n_chunks = -(-len(traced) // BATCH)
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = per_name.get(e.name, (0, 0.0))
            per_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    device_s = sum(us for _, us in per_name.values()) / 1e6
    top = sorted(per_name.items(), key=lambda kv: kv[1][1], reverse=True)[:10]
    print(json.dumps({"untraced": {"lines": len(untraced), "wall_s": untraced_s,
                                   "lines_per_s": len(untraced) / untraced_s,
                                   "host_us_per_line_by_stage": untraced_stages}}), flush=True)
    print(json.dumps({"trace": {
        "lines": len(traced), "chunks": n_chunks, "wall_s": wall_s,
        "lines_per_s": len(traced) / wall_s, "device_s": device_s,
        "device_idle_share": 1.0 - device_s / wall_s,
        "device_events_per_chunk": sum(n for n, _ in per_name.values()) / n_chunks,
        "top_device": [{"name": name[:80], "count": n, "ms": us / 1e3}
                       for name, (n, us) in top],
        "host_us_per_line_by_stage": stages(len(traced)),
        "tier_counters": matcher.device_windows.tier_counters(),
    }}), flush=True)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(out.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
