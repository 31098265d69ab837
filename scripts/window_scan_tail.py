#!/usr/bin/env python3
"""Kernel B at the ends of its arrays, on the card: for each source of
`csrc/window_scan.cu` given, build it, launch it directly on E events
whose outputs are followed by sentinels, and report which launches wrote
past E and which disagree with the plain version (`fused_match_window.
window_scan_plain`); then time each source at four sizes.

    python3 scripts/window_scan_tail.py                 # the checkout's source
    python3 scripts/window_scan_tail.py --source old.cu --source banjax_tpu_torch/csrc/window_scan.cu

E runs over sizes that cut a thread's group of four events and a last
tile shorter than the block (1 .. 12,289), on the selftest stimulus and
on seeded stimuli with segments of 1 to 5,000 events. Prints one JSON
line per source, one per timing, and the card's name and power limit.
Needs a CUDA device and nvcc.
"""

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from banjax_tpu_torch.matcher.kernels import _build  # noqa: E402
from banjax_tpu_torch.matcher.kernels import fused_match_window as fmw  # noqa: E402

SIZES = (1, 2, 3, 4, 5, 8, 63, 64, 65, 100, 128, 1000, 4095, 4096, 4097, 8191, 8192,
         12288, 12289)
TIMED = (64, 4096, 16384, 65536)
SENTINEL = -123456789
SLACK = 64
P, I = ctypes.c_void_p, ctypes.c_int


def build(source: Path):
    """nvcc `source` with the package's flags into build/window_scan_tail/."""
    text = source.read_bytes()
    out = ROOT / "build" / "window_scan_tail" / (
        f"{source.stem}-{hashlib.sha256(text).hexdigest()[:12]}.so")
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(source)],
                   check=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    lib.window_scan_launch.argtypes = [P] * 16 + [I, I, P]
    lib.window_scan_launch.restype = I
    return lib


def stimulus(E: int, seed: int, seglen: int):
    """The selftest stimulus with boundaries one event in `seglen` and
    one pad in ten, scattered."""
    rng = np.random.default_rng(seed)
    xs = list(fmw.selftest_stimulus(E, seed))
    xs[0] = rng.random(E) < 1.0 / seglen
    xs[10] = rng.random(E) < 0.1
    return xs


def launch(lib, dev, xs, out_rows, ex, E) -> None:
    rc = lib.window_scan_launch(*[t.data_ptr() for t in xs], *out_rows, ex.data_ptr(), E,
                                dev.index, _build.raw_stream(dev))
    if rc:
        raise RuntimeError(f"window_scan_launch returned {rc}")


def check(lib, dev, xs_np, want):
    """(exact, int32 values written past E, bytes written past E)."""
    xs = [torch.from_numpy(x).to(dev) for x in xs_np]
    E = len(xs_np[0])
    out = torch.full((4, E + SLACK), SENTINEL, dtype=torch.int32, device=dev)
    ex = torch.full((E + SLACK,), 7, dtype=torch.uint8, device=dev)
    launch(lib, dev, xs, [out[r].data_ptr() for r in range(4)], ex, E)
    torch.cuda.synchronize(dev)
    got, got_ex = out.cpu(), ex.cpu()
    exact = all(torch.equal(want[r], got[r, :E]) for r in range(4))
    exact = exact and torch.equal(want[4], got_ex[:E].view(torch.bool))
    return exact, int((got[:, E:] != SENTINEL).sum()), int((got_ex[E:] != 7).sum())


def time_ms(lib, dev, E: int, reps: int = 50) -> float:
    xs = [torch.from_numpy(x).to(dev) for x in stimulus(E, 3, 2)]
    out = torch.empty((4, E), dtype=torch.int32, device=dev)
    ex = torch.empty(E, dtype=torch.uint8, device=dev)
    rows = [out[r].data_ptr() for r in range(4)]
    for _ in range(5):
        launch(lib, dev, xs, rows, ex, E)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        launch(lib, dev, xs, rows, ex, E)
    t1.record()
    torch.cuda.synchronize(dev)
    return t0.elapsed_time(t1) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", type=Path,
                    help="a window_scan.cu to test (repeatable; default: the checkout's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("window_scan_tail: no CUDA device is available", file=sys.stderr)
        return 2
    sources = args.source or [ROOT / "banjax_tpu_torch" / "csrc" / "window_scan.cu"]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    libs = [build(s) for s in sources]

    rng = np.random.default_rng(1)
    cases = [(E, 7, 2) for E in SIZES]
    cases += [(int(rng.integers(1, 20000)), s, int(rng.choice([1, 2, 8, 64, 5000])))
              for s in range(40)]
    tally = [{"inexact": [], "past": []} for _ in libs]
    for E, seed, seglen in cases:
        xs_np = stimulus(E, seed, seglen)
        want = fmw.window_scan_plain([torch.from_numpy(x) for x in xs_np])
        for lib, t in zip(libs, tally):
            exact, past_i, past_b = check(lib, dev, xs_np, want)
            if not exact:
                t["inexact"].append([E, seed, seglen])
            if past_i or past_b:
                t["past"].append([E, past_i, past_b])
    for src, t in zip(sources, tally):
        print(json.dumps({"source": str(src), "cases": len(cases),
                          "inexact": len(t["inexact"]), "inexact_cases": t["inexact"],
                          "wrote_past": len(t["past"]),
                          "wrote_past_cases": t["past"]}), flush=True)
    # sources in turns, forward then backward, within one process
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    for E in TIMED:
        for k in order:
            print(json.dumps({"source": str(sources[k]), "E": E,
                              "ms": time_ms(libs[k], dev, E)}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(card.stdout.strip().splitlines()[0] if card.stdout.strip() else "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
