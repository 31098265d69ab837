"""ALU-pipe instructions counted from the SASS of a built library: per
(line byte, NFA word) in kernel A's byte-step loop (`count`), and per lane
of kernel C (`count_pow`).

Runs `cuobjdump -sass` (beside `nvcc`) on the built nfa_match library,
finds the instantiation `nfa_carry_kernel<R, table in shared memory>` or
`nfa_free_kernel<R, ...>`, takes every innermost loop (a backward branch
with none inside it) of it, and keeps the byte-step loop with the fewest
ALU instructions per line byte: the one that runs before any line of the
group has ended (the other checks each line's end). A carry loop steps
one byte per shuffle (one carry exchange a byte for all R lines, and R
class-id extracts, PRMT); a carry-free loop one byte per R table loads
(LDS). `chip_smoke.py` counts the instantiation each of its shapes
runs and divides the count by the card's INT32 rate for kernel A's
`alu_bound_ms`.

Kernel C (`pow_verify_kernel`) is straight-line code, one lane a thread:
its count is every ALU instruction of the kernel but `tail_bits`, which
runs only when a digest's first word is zero: ptxas places it past the
kernel's last EXIT as a subroutine reached by CALL, and a forward branch
skips the call site. `chip_smoke.py` multiplies the count by the lanes
for kernel C's `alu_bound_ms`.

ALU pipe here: LOP3, LOP, SHF, SHL, SHR, PRMT, ISETP, SEL, LEA, IADD3,
IMNMX, VIMNMX, FLO, POPC, BMSK, PLOP3 (IMAD and its moves issue on the FMA
pipe and are not counted; neither are VIADD and VIADDMNMX, whose pipe the
toolkit does not document).
"""

from __future__ import annotations

import re
import subprocess
from collections import Counter
from pathlib import Path

ALU = {"LOP3", "LOP", "SHF", "SHL", "SHR", "PRMT", "ISETP", "SEL", "LEA", "IADD3",
       "IMNMX", "VIMNMX", "FLO", "POPC", "BMSK", "PLOP3"}


def sass_of(library: Path) -> str:
    from banjax_tpu_torch.matcher.kernels._build import _nvcc

    tool = Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def functions(text: str) -> dict:
    """Function name -> [(address, opcode, instruction text)]."""
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name, _, body = chunk.partition("\n")
        ins = []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", body):
            op = re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2)).split()
            if op:
                ins.append((int(m.group(1), 16), op[0].split(".")[0], m.group(2)))
        out[name.strip()] = ins
    return out


def loops(ins):
    """Opcode counts of each innermost loop: from a backward branch's target
    to the branch, with no other backward branch between them."""
    spans = []
    for addr, op, text in ins:
        m = re.search(r"\bBRA (0x[0-9a-f]+)", text)
        if op == "BRA" and m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    for start, end in spans:
        if not any(start <= e < end for _, e in spans):
            yield Counter(o for a, o, _ in ins if start <= a <= end)


def step_loop(ins, R: int, carry: bool):
    """The byte-step loop with the fewest ALU instructions a line byte, or None."""
    best = None
    for c in loops(ins):
        # carry: a shuffle and R class-id extracts (PRMT) a byte; carry-free:
        # R table loads (LDS) a byte, class ids streamed from device memory
        n_bytes = c["SHFL"] if carry else c["LDS"] // R
        if n_bytes == 0 or (c["PRMT"] != R * n_bytes if carry else c["LDG"] == 0):
            continue
        alu = sum(v for k, v in c.items() if k in ALU)
        row = {"bytes_per_iteration": n_bytes, "lines": R, "instructions": sum(c.values()),
               "alu": alu, "alu_per_line_byte": alu / (n_bytes * R),
               "opcodes": dict(c.most_common())}
        if best is None or row["alu_per_line_byte"] < best["alu_per_line_byte"]:
            best = row
    return best


def count(text: str, carry: bool, R: int) -> dict:
    """The step loop of nfa_<carry|free>_kernel<R, true> in SASS `text`;
    raises when the instantiation or its loop is not found."""
    kind = "carry" if carry else "free"
    fns = functions(text)
    # mangled: nfa_<kind>_kernelILi<R>ELb1E = <R, table in shared memory>
    names = [n for n in fns if re.search(rf"nfa_{kind}_kernelILi{R}ELb1E", n)]
    if len(names) != 1:
        raise RuntimeError(f"no single nfa_{kind}_kernel<{R}, true> in the SASS")
    row = step_loop(fns[names[0]], R, carry)
    if row is None:
        raise RuntimeError(f"no byte-step loop in nfa_{kind}_kernel<{R}, true>")
    return row


def count_pow(text: str) -> dict:
    """Kernel C's instructions a lane in SASS `text`: the opcodes of
    pow_verify_kernel's path up to its store, and its ALU-pipe count;
    raises when the kernel is not found. Left out: `tail_bits` (a
    subroutine past the kernel's last EXIT, reached by CALL) and the call
    site that a forward branch skips."""
    fns = functions(text)
    names = [n for n in fns if "pow_verify_kernel" in n]
    if len(names) != 1:
        raise RuntimeError("no single pow_verify_kernel in the SASS")
    ins = fns[names[0]]

    def target(text):
        m = re.search(r"\b(?:BRA|CALL\.\w+(?:\.\w+)*) `?\(?(0x[0-9a-f]+)", text)
        return int(m.group(1), 16) if m else None

    calls = [(a, target(t)) for a, op, t in ins if op == "CALL"]
    sub = min((t for _, t in calls if t is not None), default=None)
    skipped = [(a, target(t)) for a, op, t in ins
               if op == "BRA" and t.startswith("@") and target(t) is not None
               and any(a < c < target(t) for c, _ in calls)]
    kept = [op for a, op, _ in ins
            if (sub is None or a < sub) and not any(lo < a < hi for lo, hi in skipped)]
    c = Counter(kept)
    return {"instructions": sum(c.values()), "alu": sum(v for k, v in c.items() if k in ALU),
            "left_out": len(ins) - len(kept), "opcodes": dict(c.most_common())}
