"""Rule compiler: RE2-subset regexes → packed bit-parallel NFA tensors.

The reference compiles each rate-limit rule with Go's regexp (RE2) at config
load time (the reference's internal/config.go:96-131) and then runs one
regexp.Match per (line, rule) in the tailer hot loop
(the reference's internal/regex_rate_limiter.go:234). This module is the
TPU-first replacement for that hot loop's *compile* side: every rule is
lowered to a Glushkov-style position automaton and all rules are packed
together into a handful of small integer tensors that a single batched
shift-and pass (banjax_tpu/matcher/nfa_jax.py) evaluates for thousands of
lines at once.

Lowering pipeline
-----------------
1. Parse the pattern (RE2 subset: literals, escapes, classes, `.`, anchors,
   groups, alternation, `? * + {m,n}` quantifiers, `(?i)`/`(?s)` flags) into
   an AST.
2. Expand the AST into a set of **branches**: each branch is a concatenation
   of *positions*, where a position is a byte-class plus an optional
   self-loop (self-loops encode `C+`; `C*`/`C?`/`{m,n}` expand into multiple
   branches). `^`/`$` become per-branch anchor flags. Expansion is capped;
   rules that exceed the caps or use constructs with no finite branch form
   (unbounded group repeats, `\b`, `(?m)`, non-ASCII literals) raise
   UnsupportedPattern and fall back per-rule to the host `re` path, exactly
   as SURVEY.md §7.1 prescribes.
3. Assign every position a bit in a packed uint32 word array (branches never
   straddle shard boundaries, so the match kernel can shard the word axis
   across devices), compute global byte equivalence classes over all rule
   charsets, and emit the transition masks.

Match-time semantics (implemented by nfa_jax.match_batch): bit p of state D
is set after consuming byte c iff positions 1..p of p's branch match a
suffix of the input ending at c.  One step is

    D' = (((D << 1) | inject) & B[class(c)]) | (D & B[class(c)] & selfloop)

with the packed shift carrying bit 31 → bit 0 of the next word, masked by
`shift_in` so carries never leak across branch starts.  A rule matches when
any of its branches' accept bits is ever set (`accept_any`), or is set on
the final byte for `$`-anchored branches (`accept_end`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

INF = -1  # open upper bound for repeats

# Expansion caps: a rule exceeding these falls back to the host regex path.
MAX_BRANCHES_PER_RULE = 256
MAX_POSITIONS_PER_RULE = 1024
MAX_GROUP_REPEAT = 16


class UnsupportedPattern(ValueError):
    """Pattern is valid RE2 but has no finite branch form on the device path."""


# ---------------------------------------------------------------------------
# byte sets as 256-bit Python ints (bit b set ⟺ byte b in the set)
# ---------------------------------------------------------------------------

ALL_BYTES = (1 << 256) - 1


def _bit(b: int) -> int:
    return 1 << b


def _range(lo: int, hi: int) -> int:
    return ((1 << (hi + 1)) - 1) ^ ((1 << lo) - 1)


def _from_chars(chars: str) -> int:
    mask = 0
    for ch in chars:
        mask |= _bit(ord(ch))
    return mask


# Python-`re`-on-str semantics restricted to ASCII (the oracle the TPU path
# is differential-tested against is CpuMatcher, which uses Python re; lines
# containing non-ASCII bytes are routed to the host path by the encoder).
DIGIT = _range(0x30, 0x39)
WORD = DIGIT | _range(0x41, 0x5A) | _range(0x61, 0x7A) | _bit(0x5F)
# Python-re \s over ASCII: space, \t\n\r\f\v plus the FS/GS/RS/US controls
# (0x1C-0x1F); \x85/\xa0 are non-ASCII and host-routed by the encoder
SPACE = _from_chars(" \t\n\r\f\v") | _range(0x1C, 0x1F)
DOT_NO_NL = ALL_BYTES & ~_bit(0x0A)

_POSIX_CLASSES = {
    "alnum": DIGIT | _range(0x41, 0x5A) | _range(0x61, 0x7A),
    "alpha": _range(0x41, 0x5A) | _range(0x61, 0x7A),
    "ascii": _range(0x00, 0x7F),
    "blank": _from_chars(" \t"),
    "cntrl": _range(0x00, 0x1F) | _bit(0x7F),
    "digit": DIGIT,
    "graph": _range(0x21, 0x7E),
    "lower": _range(0x61, 0x7A),
    "print": _range(0x20, 0x7E),
    "punct": _range(0x21, 0x2F) | _range(0x3A, 0x40) | _range(0x5B, 0x60) | _range(0x7B, 0x7E),
    "space": SPACE,
    "upper": _range(0x41, 0x5A),
    "word": WORD,
    "xdigit": DIGIT | _range(0x41, 0x46) | _range(0x61, 0x66),
}

_SIMPLE_ESCAPES = {
    "n": _bit(0x0A), "t": _bit(0x09), "r": _bit(0x0D),
    "f": _bit(0x0C), "v": _bit(0x0B), "a": _bit(0x07),
    "d": DIGIT, "D": ALL_BYTES & ~DIGIT,
    "w": WORD, "W": ALL_BYTES & ~WORD,
    "s": SPACE, "S": ALL_BYTES & ~SPACE,
}


def _fold_case(mask: int) -> int:
    """ASCII case folding for (?i)."""
    out = mask
    for b in range(0x41, 0x5B):  # A-Z
        if mask & _bit(b):
            out |= _bit(b + 0x20)
    for b in range(0x61, 0x7B):  # a-z
        if mask & _bit(b):
            out |= _bit(b - 0x20)
    return out


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------
# nodes: ("empty",) | ("cs", mask) | ("cat", [..]) | ("alt", [..])
#        | ("rep", node, m, n) | ("^",) | ("$",)

FLAG_I = 1  # case-insensitive
FLAG_S = 2  # dot matches newline
FLAG_M = 4  # multiline (unsupported on device)


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def error(self, msg: str) -> UnsupportedPattern:
        return UnsupportedPattern(f"{msg} at index {self.i} in {self.p!r}")

    def eof(self) -> bool:
        return self.i >= len(self.p)

    def peek(self) -> str:
        return self.p[self.i] if self.i < len(self.p) else ""

    def next(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self) -> tuple:
        node = self._alt(0)
        if not self.eof():
            raise self.error(f"unexpected {self.peek()!r}")
        return node

    # alternation scope; `flags` may be updated mid-scope by (?i)-style
    # directives, which in RE2 apply to the rest of the enclosing group
    def _alt(self, flags: int) -> tuple:
        box = [flags]
        parts = [self._cat(box)]
        while not self.eof() and self.peek() == "|":
            self.next()
            parts.append(self._cat(box))
        return parts[0] if len(parts) == 1 else ("alt", parts)

    def _cat(self, flagbox: List[int]) -> tuple:
        items: List[tuple] = []
        while not self.eof() and self.peek() not in "|)":
            atom = self._atom(flagbox)
            if atom is None:  # inline flag directive, already applied
                continue
            items.append(self._quantified(atom, flagbox))
        if not items:
            return ("empty",)
        return items[0] if len(items) == 1 else ("cat", items)

    def _quantified(self, atom: tuple, flagbox: List[int]) -> tuple:
        while not self.eof() and self.peek() in "*+?{":
            if self.peek() == "{":
                rep = self._try_counted_repeat()
                if rep is None:  # literal '{'
                    break
                m, n = rep
            else:
                ch = self.next()
                m, n = {"*": (0, INF), "+": (1, INF), "?": (0, 1)}[ch]
            if atom[0] in ("^", "$"):
                raise self.error("quantifier on anchor")
            if not self.eof() and self.peek() == "?":
                self.next()  # lazy quantifier: same language, drop
            # rep-of-rep only arises via groups, e.g. (a?){2} — bare double
            # quantifiers (a**) were already rejected by the Python re
            # compile at config load (schema.RegexWithRate.from_yaml_dict)
            atom = ("rep", atom, m, n)
        return atom

    def _try_counted_repeat(self) -> Optional[Tuple[int, int]]:
        start = self.i
        self.next()  # '{'
        digits = ""
        while not self.eof() and self.peek().isdigit():
            digits += self.next()
        if not digits:
            self.i = start
            return None
        m = int(digits)
        if self.eof():
            self.i = start
            return None
        ch = self.next()
        if ch == "}":
            return m, m
        if ch != ",":
            self.i = start
            return None
        digits2 = ""
        while not self.eof() and self.peek().isdigit():
            digits2 += self.next()
        if self.eof() or self.next() != "}":
            self.i = start
            return None
        if digits2 == "":
            return m, INF
        n = int(digits2)
        if n < m:
            raise self.error("bad repeat bounds")
        return m, n

    def _atom(self, flagbox: List[int]) -> Optional[tuple]:
        flags = flagbox[0]
        ch = self.next()
        if ch == "(":
            return self._group(flagbox)
        if ch == "[":
            return ("cs", self._char_class(flags))
        if ch == ".":
            return ("cs", ALL_BYTES if flags & FLAG_S else DOT_NO_NL)
        if ch == "^":
            if flags & FLAG_M:
                raise self.error("multiline ^ not supported on device")
            return ("^",)
        if ch == "$":
            if flags & FLAG_M:
                raise self.error("multiline $ not supported on device")
            return ("$",)
        if ch == "\\":
            return self._escape(flags)
        if ch in "*+?":
            raise self.error("quantifier with nothing to repeat")
        code = ord(ch)
        if code > 0x7F:
            raise UnsupportedPattern(f"non-ASCII literal {ch!r} in {self.p!r}")
        mask = _bit(code)
        return ("cs", _fold_case(mask) if flags & FLAG_I else mask)

    def _group(self, flagbox: List[int]) -> Optional[tuple]:
        flags = flagbox[0]
        if self.peek() == "?":
            self.next()
            if self.peek() == ":":
                self.next()
                node = self._alt(flags)
            elif self.peek() == "P":
                self.next()
                if self.peek() != "<":
                    raise self.error("unsupported (?P...) form")
                self.next()
                while not self.eof() and self.peek() != ">":
                    self.next()
                if self.eof():
                    raise self.error("unterminated group name")
                self.next()
                node = self._alt(flags)
            elif self.peek() in "imsUx-":
                new_flags, scoped = self._flag_directive(flags)
                if scoped is None:
                    # (?i) — applies to the rest of the group; consume the ')'
                    flagbox[0] = new_flags
                    if self.eof() or self.next() != ")":
                        raise self.error("missing )")
                    return None
                node = scoped
            else:
                raise self.error(f"unsupported group (?{self.peek()}")
        else:
            node = self._alt(flags)
        if self.eof() or self.next() != ")":
            raise self.error("missing )")
        return node

    def _flag_directive(self, flags: int) -> Tuple[int, Optional[tuple]]:
        """(?flags) or (?flags:...) or (?flags-flags...)."""
        negate = False
        while True:
            ch = self.peek()
            if ch == "i":
                flags = (flags & ~FLAG_I) if negate else (flags | FLAG_I)
            elif ch == "s":
                flags = (flags & ~FLAG_S) if negate else (flags | FLAG_S)
            elif ch == "m":
                if not negate:
                    raise UnsupportedPattern("(?m) not supported on device")
                flags &= ~FLAG_M
            elif ch == "U":
                pass  # swap-greediness: same language
            elif ch == "x":
                raise UnsupportedPattern("(?x) free-spacing not supported")
            elif ch == "-":
                negate = True
            elif ch == ":":
                self.next()
                return flags, self._alt(flags)
            elif ch == ")":
                return flags, None
            else:
                raise self.error(f"bad flag {ch!r}")
            self.next()

    def _escape(self, flags: int) -> tuple:
        if self.eof():
            raise self.error("trailing backslash")
        ch = self.next()
        if ch == "A":
            return ("^",)
        if ch in "zZ":  # Go spells it \z, Python \Z; same end-of-text anchor
            return ("$",)
        if ch in "bB":
            raise UnsupportedPattern(f"\\{ch} word boundary not supported on device")
        if ch in "pP":
            raise UnsupportedPattern(f"\\{ch} unicode class not supported on device")
        if ch.isdigit() and ch != "0":
            raise UnsupportedPattern("backreference")  # re2check rejects earlier
        mask = self._escape_mask(ch, flags)
        return ("cs", mask)

    def _escape_mask(self, ch: str, flags: int) -> int:
        if ch in _SIMPLE_ESCAPES:
            mask = _SIMPLE_ESCAPES[ch]
            if flags & FLAG_I and ch in "wW":
                pass  # \w already case-closed
            return mask
        if ch == "x":
            if self.peek() == "{":
                self.next()
                digits = ""
                while not self.eof() and self.peek() != "}":
                    digits += self.next()
                if self.eof():
                    raise self.error("unterminated \\x{")
                self.next()
                code = int(digits, 16)
            else:
                digits = ""
                for _ in range(2):
                    if self.eof():
                        raise self.error("bad \\x escape")
                    digits += self.next()
                code = int(digits, 16)
            if code > 0xFF:
                raise UnsupportedPattern(f"\\x{{{code:x}}} beyond byte range")
            mask = _bit(code)
            return _fold_case(mask) if flags & FLAG_I else mask
        if ch == "0":
            return _bit(0)
        code = ord(ch)
        if code > 0x7F:
            raise UnsupportedPattern(f"non-ASCII escape {ch!r}")
        mask = _bit(code)
        if ch.isalpha():
            return _fold_case(mask) if flags & FLAG_I else mask
        return mask

    def _char_class(self, flags: int) -> int:
        negated = False
        if self.peek() == "^":
            self.next()
            negated = True
        mask = 0
        first = True
        while True:
            if self.eof():
                raise self.error("unterminated character class")
            ch = self.next()
            if ch == "]" and not first:
                break
            first = False
            if ch == "[" and self.peek() == ":":
                # POSIX class [:name:]
                j = self.p.find(":]", self.i)
                if j == -1:
                    raise self.error("unterminated POSIX class")
                name = self.p[self.i + 1 : j]
                neg = name.startswith("^")
                if neg:
                    name = name[1:]
                if name not in _POSIX_CLASSES:
                    raise self.error(f"unknown POSIX class {name!r}")
                m = _POSIX_CLASSES[name]
                mask |= (ALL_BYTES & ~m) if neg else m
                self.i = j + 2
                continue
            if ch == "\\":
                if self.eof():
                    raise self.error("trailing backslash in class")
                esc = self.next()
                if esc in "dDwWsS":
                    mask |= _SIMPLE_ESCAPES[esc]
                    continue
                lo = self._class_single_escape(esc)
            else:
                code = ord(ch)
                if code > 0x7F:
                    raise UnsupportedPattern(f"non-ASCII {ch!r} in class")
                lo = code
            # range?
            if self.peek() == "-" and self.i + 1 < len(self.p) and self.p[self.i + 1] != "]":
                self.next()  # '-'
                ch2 = self.next()
                if ch2 == "\\":
                    hi = self._class_single_escape(self.next())
                else:
                    code2 = ord(ch2)
                    if code2 > 0x7F:
                        raise UnsupportedPattern(f"non-ASCII {ch2!r} in class")
                    hi = code2
                if hi < lo:
                    raise self.error("reversed class range")
                mask |= _range(lo, hi)
            else:
                mask |= _bit(lo)
        if flags & FLAG_I:
            mask = _fold_case(mask)
        if negated:
            mask = ALL_BYTES & ~mask
        return mask

    def _class_single_escape(self, esc: str) -> int:
        single = {"n": 0x0A, "t": 0x09, "r": 0x0D, "f": 0x0C, "v": 0x0B,
                  "a": 0x07, "b": 0x08, "0": 0x00}
        if esc in single:
            return single[esc]
        if esc == "x":
            digits = ""
            if self.peek() == "{":
                self.next()
                while not self.eof() and self.peek() != "}":
                    digits += self.next()
                if self.eof():
                    raise self.error("unterminated \\x{ in class")
                self.next()
            else:
                for _ in range(2):
                    if self.eof():
                        raise self.error("bad \\x escape in class")
                    digits += self.next()
            code = int(digits, 16)
            if code > 0xFF:
                raise UnsupportedPattern("\\x beyond byte range in class")
            return code
        code = ord(esc)
        if code > 0x7F:
            raise UnsupportedPattern(f"non-ASCII escape {esc!r} in class")
        return code


# ---------------------------------------------------------------------------
# Lowering: AST → branches of positions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Pos:
    cs: int          # 256-bit byte set
    loop: bool = False  # self-loop (the position absorbs 1+ repeats)


# branch sequence items: Pos | "^" | "$"
_Seq = Tuple[object, ...]


class _Caps:
    def __init__(self) -> None:
        self.branches = MAX_BRANCHES_PER_RULE
        self.positions = MAX_POSITIONS_PER_RULE

    def check(self, seqs: Sequence[_Seq]) -> Sequence[_Seq]:
        if len(seqs) > self.branches:
            raise UnsupportedPattern(
                f"rule expands to {len(seqs)} branches (cap {self.branches})"
            )
        total = sum(sum(1 for it in s if isinstance(it, Pos)) for s in seqs)
        if total > self.positions:
            raise UnsupportedPattern(
                f"rule expands to {total} positions (cap {self.positions})"
            )
        return seqs


def _lower(node: tuple, caps: _Caps) -> List[_Seq]:
    kind = node[0]
    if kind == "empty":
        return [()]
    if kind == "cs":
        return [(Pos(node[1]),)]
    if kind in ("^", "$"):
        return [(kind,)]
    if kind == "cat":
        seqs: List[_Seq] = [()]
        for child in node[1]:
            child_seqs = _lower(child, caps)
            seqs = caps.check([a + b for a in seqs for b in child_seqs])
        return seqs
    if kind == "alt":
        out: List[_Seq] = []
        for child in node[1]:
            out.extend(_lower(child, caps))
        return list(caps.check(out))
    if kind == "rep":
        return _lower_rep(node, caps)
    raise AssertionError(f"unknown node {kind}")


def _lower_rep(node: tuple, caps: _Caps) -> List[_Seq]:
    _, inner, m, n = node
    alts = _lower(inner, caps)
    if any("^" in a or "$" in a for a in alts):
        # anchors under a repeat: expand finitely below (anchored branches
        # are pruned/validated later); unbounded anchored repeats are dead
        # beyond one iteration, so treat X{m,INF} as X{m,m+1}
        if n == INF:
            n = max(m, 1)
        return _lower_rep_general(alts, m, n, caps)
    if () in alts:
        # (X|ε){m,n} ≡ X{0,n}
        alts = [a for a in alts if a != ()]
        m = 0
        if not alts:
            return [()]
    single = all(len(a) == 1 and isinstance(a[0], Pos) for a in alts)
    if single:
        loops = [a[0].loop for a in alts]
        union = 0
        for a in alts:
            union |= a[0].cs
        if n == INF:
            # (C1|..|Ck){m,∞} with single-byte alternatives ≡ [C∪]{m,∞}
            if m == 0:
                return [(), (Pos(union, loop=True),)]
            return [tuple([Pos(union)] * (m - 1) + [Pos(union, loop=True)])]
        if len(alts) == 1 and loops[0]:
            # (C+){m,n} ≡ C{m,∞} for n ≥ m ≥ 1; (C+){0,n} ≡ C*
            if m == 0:
                return [(), (Pos(union, loop=True),)]
            return [tuple([Pos(union)] * (m - 1) + [Pos(union, loop=True)])]
        if not any(loops):
            # exact finite expansion of a plain byte class
            return list(caps.check([tuple([Pos(union)] * k) for k in range(m, n + 1)]))
        # mixed looped/plain single-byte alternatives with finite n: general
    if n == INF:
        raise UnsupportedPattern("unbounded repeat of a multi-byte group")
    return _lower_rep_general(alts, m, n, caps)


def _lower_rep_general(alts: List[_Seq], m: int, n: int, caps: _Caps) -> List[_Seq]:
    if n > MAX_GROUP_REPEAT:
        raise UnsupportedPattern(f"group repeat bound {n} exceeds cap {MAX_GROUP_REPEAT}")
    out: List[_Seq] = []
    for k in range(m, n + 1):
        seqs: List[_Seq] = [()]
        for _ in range(k):
            seqs = caps.check([a + b for a in seqs for b in alts])
        out.extend(seqs)
    # dedupe identical branches
    seen = set()
    deduped = []
    for s in out:
        if s not in seen:
            seen.add(s)
            deduped.append(s)
    return list(caps.check(deduped))


@dataclasses.dataclass(frozen=True)
class Branch:
    positions: Tuple[Pos, ...]
    anchored_start: bool
    anchored_end: bool


@dataclasses.dataclass
class RuleProgram:
    """One rule lowered to branches (device form) or flagged degenerate."""

    branches: List[Branch]
    always_match: bool = False   # an unanchored-empty branch: matches everything
    empty_only: bool = False     # a `^$` branch: matches only empty input


def _finalize_branch(seq: _Seq) -> Optional[Branch]:
    """Resolve anchors; returns None for dead branches (e.g. `a^b`)."""
    anchored_start = anchored_end = False
    positions: List[Pos] = []
    for item in seq:
        if item == "^":
            if positions:
                return None  # ^ after consuming input: unmatchable
            anchored_start = True
        elif item == "$":
            anchored_end = True
        else:
            if anchored_end:
                return None  # input after $: unmatchable
            positions.append(item)  # type: ignore[arg-type]
    for p in positions:
        if p.cs == 0:
            return None  # empty byte class can never match
    return Branch(tuple(positions), anchored_start, anchored_end)


def compile_rule(pattern: str) -> RuleProgram:
    """Lower one RE2-subset pattern. Raises UnsupportedPattern on fallback."""
    ast = _Parser(pattern).parse()
    caps = _Caps()
    seqs = _lower(ast, caps)
    prog = RuleProgram(branches=[])
    seen = set()
    for seq in seqs:
        br = _finalize_branch(seq)
        if br is None:
            continue
        if not br.positions:
            if br.anchored_start and br.anchored_end:
                prog.empty_only = True
            else:
                # empty match exists in every input (search semantics)
                prog.always_match = True
            continue
        key = (br.positions, br.anchored_start, br.anchored_end)
        if key not in seen:
            seen.add(key)
            prog.branches.append(br)
    if prog.always_match:
        prog.branches = []  # everything else is redundant
        prog.empty_only = False
    return prog


# ---------------------------------------------------------------------------
# Required factors (for the literal prefilter, matcher/prefilter.py)
# ---------------------------------------------------------------------------


def _popcount(cs: int) -> int:
    return bin(cs).count("1")


def required_factors(
    prog: RuleProgram,
    min_len: int = 3,
    max_len: int = 12,
    max_class_size: int = 2,
) -> Optional[List[Tuple[Pos, ...]]]:
    """One necessary consecutive factor per branch, or None.

    A factor is a run of non-self-loop positions whose byte classes are
    narrow (size <= max_class_size, e.g. exact bytes or (?i) case pairs).
    Any match of the branch must contain the factor's classes consecutively,
    so "factor absent => branch cannot match" — the prefilter's soundness
    invariant. Runs break at self-loop positions (`C+` can repeat, so bytes
    around it are not consecutive); truncating a run keeps it necessary.
    Returns None when any branch lacks a qualifying run (the rule must then
    be matched against every line, prefilter or not).
    """
    if prog.always_match or prog.empty_only or not prog.branches:
        return None
    out: List[Tuple[Pos, ...]] = []
    for br in prog.branches:
        best: Tuple[Pos, ...] = ()
        run: List[Pos] = []
        for pos in list(br.positions) + [None]:  # sentinel flush
            if (
                pos is not None
                and not pos.loop
                and _popcount(pos.cs) <= max_class_size
            ):
                run.append(pos)
                continue
            if len(run) > len(best):
                best = tuple(run)
            run = []
        if len(best) < min_len:
            return None
        if len(best) > max_len:
            # middle slice: factor stays necessary, bounded state cost
            start = (len(best) - max_len) // 2
            best = best[start : start + max_len]
        out.append(best)
    return out


def factor_program(factor: Tuple[Pos, ...]) -> RuleProgram:
    """A factor as a one-branch unanchored search program."""
    return RuleProgram(
        branches=[Branch(tuple(Pos(p.cs) for p in factor), False, False)]
    )


# ---------------------------------------------------------------------------
# Packing: all rules → tensors
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompiledRules:
    """Packed transition tensors for the batched shift-and match kernel.

    Word layout: `n_shards * words_per_shard` uint32 words; branch bit runs
    are contiguous and never straddle a shard boundary, so the word axis can
    be sharded across devices with no cross-shard carry.
    """

    n_rules: int
    n_shards: int
    words_per_shard: int
    n_classes: int                  # rows of b_table; class 0 is the pad class
    byte_to_class: np.ndarray       # [256] int32
    b_table: np.ndarray             # [n_classes, W] uint32
    shift_in: np.ndarray            # [W] uint32 — bit may receive a shifted-in bit
    inject_always: np.ndarray       # [W] uint32 — unanchored branch starts
    inject_start: np.ndarray        # [W] uint32 — ^-anchored branch starts (char 0)
    selfloop: np.ndarray            # [W] uint32
    accept_any: np.ndarray          # [W] uint32 — accept bits of unanchored-end branches
    accept_end: np.ndarray          # [W] uint32 — accept bits of $-anchored branches
    acc_word: np.ndarray            # [n_branches] int32 — accept word index per branch
    acc_mask: np.ndarray            # [n_branches] uint32 — accept bit mask per branch
    branch_rule: np.ndarray         # [n_branches] int32
    always_match: np.ndarray        # [n_rules] bool
    empty_only: np.ndarray          # [n_rules] bool
    device_ok: np.ndarray           # [n_rules] bool — False: host regex fallback
    unsupported: Dict[int, str] = dataclasses.field(default_factory=dict)
    # no branch straddles a 32-bit word boundary (pack_programs
    # align_branches=True and every branch fit): the match kernel can then
    # drop the cross-word carry — 3 of ~13 VPU ops per byte column
    carry_free: bool = False

    @property
    def n_words(self) -> int:
        return self.n_shards * self.words_per_shard

    @property
    def n_positions(self) -> int:
        # every position is either branch-initial (an inject bit) or shifted into
        used = self.shift_in | self.inject_always | self.inject_start
        return int(sum(bin(int(w)).count("1") for w in used))


def compile_rules(patterns: Sequence[str], n_shards=1) -> CompiledRules:
    """Compile a full ruleset into one packed tensor set.

    `patterns[i]` keeps rule id `i` end to end, so the caller can map match
    bits straight back to its RegexWithRate list (global + per-site rules
    concatenated, the way runner.py builds it). `n_shards="auto"` picks the
    shard count that minimizes total padded words for the match kernel.
    """
    programs, unsupported = lower_rules(patterns)
    return pack_programs(programs, n_shards=n_shards, unsupported=unsupported)


def lower_rules(patterns: Sequence[str]) -> Tuple[List[Optional[RuleProgram]], Dict[int, str]]:
    """Lower each pattern to its program: (programs, unsupported), a None
    program and its reason for each rule the NFA cannot run. The programs
    can be packed for any shard count (`pack_programs`)."""
    programs: List[Optional[RuleProgram]] = []
    unsupported: Dict[int, str] = {}
    for i, pat in enumerate(patterns):
        try:
            programs.append(compile_rule(pat))
        except UnsupportedPattern as e:
            programs.append(None)
            unsupported[i] = str(e)
    return programs, unsupported


# The Pallas kernel pads each shard's word slab to this multiple. The VPU
# scan cost is ∝ the PADDED word count, so a small automaton (the fused
# prefilter's ~40-word stage 1) wastes 3-4x work at 128. 32 — the int8
# sublane tile, the tightest alignment every in-kernel slice (btab plane
# slices at multiples of W, [W, 8] mask rows, the [W, block] state) still
# satisfies — is the default; BANJAX_NFA_WORD_ALIGN=128 restores the old
# conservative padding if a Mosaic version rejects 32-row slabs.
def _parse_word_align(raw: "str | None") -> int:
    # Invalid values fall back to the default with a warning rather than
    # raising at import time (a typo'd env var must not take down the server).
    try:
        val = int(raw or 32)
    except (TypeError, ValueError):
        val = -1
    if val not in (32, 64, 128):
        if raw not in (None, "", "32"):
            import warnings

            warnings.warn(
                f"BANJAX_NFA_WORD_ALIGN={raw!r}: must be 32, 64, or 128 "
                "(multiples of the int8 sublane tile up to the lane width); "
                "falling back to 32",
                stacklevel=2,
            )
        val = 32
    return val


KERNEL_WORD_ALIGN = _parse_word_align(os.environ.get("BANJAX_NFA_WORD_ALIGN"))
_KERNEL_MAX_WPS = 512      # the kernel's per-shard VMEM comfort budget


def choose_shards(branch_lengths: Sequence[int], align: int = 0) -> int:
    """Exact-cost shard count: simulate the greedy branch packing for each
    candidate and minimize `n_shards * pad(real_words_per_shard, align)` —
    the dot-row count the kernel actually pays (a ceil(total/ns) estimate
    misses the packer's imbalance and can land just past a pad boundary)."""
    if not branch_lengths:
        return 1
    align = align or KERNEL_WORD_ALIGN
    order = sorted(branch_lengths, reverse=True)
    total = sum(order)
    best, best_cost = 1, None
    max_ns = max(1, -(-total // (128 * 32 // 2)))
    for ns in range(1, max_ns + 1):
        bits = [0] * ns
        for ln in order:
            s = min(range(ns), key=bits.__getitem__)
            bits[s] += ln
        wps = -(-max(bits) // 32)
        wps_p = max(align, -(-wps // align) * align)
        if wps_p > _KERNEL_MAX_WPS:
            continue
        cost = ns * wps_p
        if best_cost is None or cost < best_cost:
            best, best_cost = ns, cost
    return best


def pack_programs(
    programs: Sequence[Optional[RuleProgram]],
    n_shards=1,
    unsupported: Optional[Dict[int, str]] = None,
    byte_classes: Optional[Tuple[np.ndarray, int]] = None,
    align_branches: bool = False,
) -> CompiledRules:
    """Pack already-lowered rule programs into the transition tensors.

    Split out of compile_rules so synthetic programs (e.g. the literal
    prefilter's factor automata, matcher/prefilter.py) share the packing
    and the match kernels without a regex round-trip.

    `byte_classes` = (byte_to_class [256] int32, n_classes): use this
    pre-computed byte partition instead of deriving one from the programs'
    charsets. The partition must REFINE every position charset (all bytes of
    a class agree on membership) — e.g. the partition of a superset ruleset.
    This is what lets the two-stage prefilter share one encode pass with the
    full single-stage tensors: all three CompiledRules index the same class
    ids, so lines are classified once (matcher/prefilter.py).

    `align_branches=True` pads branch start bits so no branch of <=32
    positions straddles a word boundary; when every branch then fits,
    `carry_free` is set and the Pallas kernel drops its cross-word carry.
    Worth the padded words for narrow automata (the prefilter's stage 1,
    whose factors are <=12 positions); dense packing stays the default for
    the wide full-ruleset tensors.
    """
    n_rules = len(programs)
    unsupported = dict(unsupported or {})

    # gather branches: (rule_id, branch)
    all_branches: List[Tuple[int, Branch]] = []
    for i, prog in enumerate(programs):
        if prog is None:
            continue
        for br in prog.branches:
            all_branches.append((i, br))

    if n_shards == "auto":
        n_shards = choose_shards([len(b.positions) for _, b in all_branches])

    # shard assignment: greedy balance by bit length, branches atomic
    shard_bits = [0] * n_shards
    shard_members: List[List[int]] = [[] for _ in range(n_shards)]
    order = sorted(range(len(all_branches)),
                   key=lambda k: -len(all_branches[k][1].positions))
    for k in order:
        s = min(range(n_shards), key=lambda j: shard_bits[j])
        shard_members[s].append(k)
        shard_bits[s] += len(all_branches[k][1].positions)

    # bit assignment: per shard, branches in original order for determinism;
    # with align_branches, a <=32-position branch never straddles a word
    local_start: Dict[int, int] = {}
    shard_used = [0] * n_shards
    for s in range(n_shards):
        offset = 0
        for k in sorted(shard_members[s]):
            blen = len(all_branches[k][1].positions)
            if (
                align_branches and blen <= 32 and offset % 32
                and (offset % 32) + blen > 32
            ):
                offset = (offset + 31) // 32 * 32
            local_start[k] = offset
            offset += blen
        shard_used[s] = offset
    words_per_shard = max(1, (max(shard_used) + 31) // 32 if all_branches else 1)
    W = n_shards * words_per_shard
    bit_of_branch_start = [0] * len(all_branches)
    for s in range(n_shards):
        base = s * words_per_shard * 32
        for k in shard_members[s]:
            bit_of_branch_start[k] = base + local_start[k]
    carry_free = bool(all_branches) and all(
        (local_start[k] % 32) + len(all_branches[k][1].positions) <= 32
        for k in range(len(all_branches))
    )

    # byte equivalence classes over all distinct position charsets
    charsets: List[int] = []
    cs_index: Dict[int, int] = {}
    for _, br in all_branches:
        for p in br.positions:
            if p.cs not in cs_index:
                cs_index[p.cs] = len(charsets)
                charsets.append(p.cs)

    if byte_classes is not None:
        byte_to_class, n_classes = byte_classes
        byte_to_class = np.asarray(byte_to_class, dtype=np.int32)
        # refinement check: every class must be uniform w.r.t. every charset,
        # otherwise a representative-byte membership test would be wrong
        for cs in charsets:
            member = np.array([(cs >> b) & 1 for b in range(256)], dtype=np.int64)
            if len(set(zip(byte_to_class.tolist(), member.tolist()))) > len(
                set(byte_to_class.tolist())
            ):
                raise ValueError(
                    "byte_classes does not refine a position charset; "
                    "pack with the partition of a superset ruleset"
                )
    else:
        # signature of byte b = tuple of membership bits; identical signature
        # → same class. Class ids start at 1; 0 is the reserved pad class.
        sig_to_class: Dict[Tuple[int, ...], int] = {}
        byte_to_class = np.zeros(256, dtype=np.int32)
        for b in range(256):
            sig = tuple((cs >> b) & 1 for cs in charsets)
            cls = sig_to_class.get(sig)
            if cls is None:
                cls = len(sig_to_class) + 1
                sig_to_class[sig] = cls
            byte_to_class[b] = cls
        n_classes = len(sig_to_class) + 1

    b_table = np.zeros((n_classes, W), dtype=np.uint64)
    shift_in = np.zeros(W, dtype=np.uint64)
    inject_always = np.zeros(W, dtype=np.uint64)
    inject_start = np.zeros(W, dtype=np.uint64)
    selfloop = np.zeros(W, dtype=np.uint64)
    accept_any = np.zeros(W, dtype=np.uint64)
    accept_end = np.zeros(W, dtype=np.uint64)
    acc_word = np.zeros(len(all_branches), dtype=np.int32)
    acc_mask = np.zeros(len(all_branches), dtype=np.uint64)
    branch_rule = np.zeros(len(all_branches), dtype=np.int32)

    # one representative byte per class for charset membership tests
    class_rep: Dict[int, int] = {}
    for b in range(256):
        class_rep.setdefault(int(byte_to_class[b]), b)

    for k, (rule_id, br) in enumerate(all_branches):
        branch_rule[k] = rule_id
        start_bit = bit_of_branch_start[k]
        for j, pos in enumerate(br.positions):
            bit = start_bit + j
            w, o = bit // 32, bit % 32
            mask = np.uint64(1 << o)
            for cls, rep in class_rep.items():
                if cls == 0:
                    continue
                if (pos.cs >> rep) & 1:
                    b_table[cls, w] |= mask
            if j > 0:
                shift_in[w] |= mask
            else:
                if br.anchored_start:
                    inject_start[w] |= mask
                else:
                    inject_always[w] |= mask
            if pos.loop:
                selfloop[w] |= mask
        last_bit = start_bit + len(br.positions) - 1
        w, o = last_bit // 32, last_bit % 32
        mask = np.uint64(1 << o)
        if br.anchored_end:
            accept_end[w] |= mask
        else:
            accept_any[w] |= mask
        acc_word[k] = w
        acc_mask[k] = mask

    always = np.zeros(n_rules, dtype=bool)
    empty_only = np.zeros(n_rules, dtype=bool)
    device_ok = np.zeros(n_rules, dtype=bool)
    for i, prog in enumerate(programs):
        if prog is None:
            continue
        device_ok[i] = True
        always[i] = prog.always_match
        empty_only[i] = prog.empty_only

    return CompiledRules(
        n_rules=n_rules,
        n_shards=n_shards,
        words_per_shard=words_per_shard,
        n_classes=n_classes,
        byte_to_class=byte_to_class,
        b_table=b_table.astype(np.uint32),
        shift_in=shift_in.astype(np.uint32),
        inject_always=inject_always.astype(np.uint32),
        inject_start=inject_start.astype(np.uint32),
        selfloop=selfloop.astype(np.uint32),
        accept_any=accept_any.astype(np.uint32),
        accept_end=accept_end.astype(np.uint32),
        acc_word=acc_word,
        acc_mask=acc_mask.astype(np.uint32),
        branch_rule=branch_rule,
        always_match=always,
        empty_only=empty_only,
        device_ok=device_ok,
        unsupported=unsupported,
        carry_free=carry_free,
    )
