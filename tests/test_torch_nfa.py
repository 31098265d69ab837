"""The port's NFA match (plain scan, kernel A's wrapper on the CPU) against
the JAX package's `nfa_jax` scan and the Pallas kernel in interpret mode.

Same seeded inputs through both; integer outputs, compared exactly."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from banjax_tpu.matcher import nfa_jax
from banjax_tpu.matcher import rulec as jax_rulec
from banjax_tpu.matcher.kernels import nfa_match as jax_nfa_match
from banjax_tpu_torch import workload
from banjax_tpu_torch.matcher import encode, nfa, rulec
from banjax_tpu_torch.matcher.kernels import nfa_match, sass_alu


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers, and the timing-sensitive tests beside these need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MAX_LEN = 64

SHAPES = [
    r"^GET /admin", r"\.php$", r"(?i)sqlmap", r"a{2,4}b", r"x[0-9]{3}y",
    r"^$", r"(ab|cd){1,2}e", r"foo.*bar$", r"^(GET|POST) [a-z]+\.com ",
    r"[[:digit:]]+\.[[:alpha:]]{2,3}", r"\x41\x42", r"^a+$",
]


def _patterns():
    return workload.generate_rules(24, seed=5) + SHAPES


def _lines():
    rng = random.Random(3)
    pats = _patterns()
    lines = workload.generate_lines(40, pats, seed=9, attack_rate=0.3)
    lines += [workload.synthesize_match(p, rng)[:MAX_LEN] for p in rng.sample(pats, 16)]
    lines += ["", "", "aaaa", "ab", "xyzfoo bar", "GET example.com GET /x.php"]
    lines += ["z" * MAX_LEN, ("GET /admin-" + "a" * MAX_LEN)[:MAX_LEN]]
    assert len(lines) == 64
    return [line[:MAX_LEN] for line in lines]


def _compile(kind, mod):
    """Dense packing (cross-word carries) or word-aligned branches
    (carry_free), compiled by the JAX package's rulec or the port's copy."""
    pats = _patterns()
    if kind == "carry":
        return mod.compile_rules(pats, n_shards=1)
    programs = [mod.compile_rule(p) for p in pats]
    return mod.pack_programs(programs, n_shards="auto", align_branches=True)


@pytest.fixture(scope="module", params=["carry", "carry_free"])
def case(request):
    jc = _compile(request.param, jax_rulec)
    tc = _compile(request.param, rulec)
    assert tc.carry_free == (request.param == "carry_free")
    cls, lens, host_eval = encode.encode_for_match(tc, _lines(), MAX_LEN)
    assert not host_eval.any()
    return jc, tc, cls, lens


def test_rulec_arrays_identical(case):
    jc, tc, _, _ = case
    a, b = dataclasses.asdict(jc), dataclasses.asdict(tc)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_plain_scan_matches_nfa_jax(case):
    jc, tc, cls, lens = case
    want = np.asarray(nfa_jax.nfa_scan(nfa_jax.match_params(jc), cls, lens))
    got = nfa.nfa_scan(nfa.match_params(tc, "cpu"), torch.from_numpy(cls), torch.from_numpy(lens))
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_match_batch_and_packed_match_nfa_jax(case):
    jc, tc, cls, lens = case
    jp, tp = nfa_jax.match_params(jc), nfa.match_params(tc, "cpu")
    want = np.asarray(nfa_jax.match_batch(jp, cls, lens, jc.n_rules))
    got = nfa.match_batch(tp, torch.from_numpy(cls), torch.from_numpy(lens), tc.n_rules)
    assert np.array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    want_p = np.asarray(nfa_jax.match_batch_packed(jp, cls, lens, jc.n_rules))
    got_p = nfa.match_batch_packed(tp, torch.from_numpy(cls), torch.from_numpy(lens), tc.n_rules)
    assert np.array_equal(got_p.numpy(), want_p)


def test_kernel_wrapper_matches_pallas_interpret(case):
    jc, tc, cls, lens = case
    prep = nfa_match.prepare(tc, "cpu")
    c, l = torch.from_numpy(cls), torch.from_numpy(lens)
    raw = nfa_match.accept_words(prep, c, l)
    want_raw = np.asarray(nfa_jax.nfa_scan(nfa_jax.match_params(jc), cls, lens))
    assert np.array_equal(raw.numpy().view(np.uint32), want_raw)
    want = jax_nfa_match.match_batch_pallas(
        jax_nfa_match.prepare(jc), cls, lens, block_b=64, interpret=True
    )
    assert np.array_equal(nfa_match.match_bits(prep, c, l).numpy(), want)


def test_class_ids_past_the_line_end_are_ignored(case):
    """The kernel runs exactly `lens` bytes: garbage past the end of a line
    must not change its words (the encoder writes pad class 0 there)."""
    _, tc, cls, lens = case
    prep = nfa_match.prepare(tc, "cpu")
    noisy = cls.copy()
    rng = np.random.default_rng(1)
    tail = np.arange(cls.shape[1])[None, :] >= lens[:, None]
    noisy[tail] = rng.integers(1, tc.n_classes, size=int(tail.sum()))
    a = nfa_match.accept_words(prep, torch.from_numpy(cls), torch.from_numpy(lens))
    b = nfa_match.accept_words(prep, torch.from_numpy(noisy), torch.from_numpy(lens))
    assert torch.equal(a, b)


def _skewed(cls, lens, n=95, seed=4):
    """n lines (no group size divides it) of skewed length: empty lines,
    full-length lines (reading the pad class past a line's end) and
    everything between, mostly short; the pad class 0 past each end, as
    the encoder writes it (the JAX scan reads those columns)."""
    rng = np.random.default_rng(seed)
    rows = np.resize(np.arange(cls.shape[0]), n)
    ln = (MAX_LEN * rng.random(n) ** 3).astype(np.int32)
    ln[rng.random(n) < 0.1] = 0
    ln[rng.random(n) < 0.1] = MAX_LEN
    ln[:2] = (0, MAX_LEN)
    c = np.array(cls[rows])
    c[np.arange(MAX_LEN)[None, :] >= ln[:, None]] = 0
    return c, ln


def test_plain_scan_matches_nfa_jax_on_a_length_skewed_batch(case):
    jc, tc, cls, lens = case
    c, ln = _skewed(cls, lens)
    want = np.asarray(nfa_jax.nfa_scan(nfa_jax.match_params(jc), c, ln))
    prep = nfa_match.prepare(tc, "cpu")
    got = nfa_match.accept_words(prep, torch.from_numpy(c), torch.from_numpy(ln))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert want.any() and not want[ln == 0].any()


@pytest.mark.cuda
def test_kernel_a_matches_plain_on_the_card_on_skewed_batches(case, cuda_device):
    """Every R on the skewed batch, and a batch beyond one sort tile."""
    _, tc, cls, lens = case
    prep = nfa_match.prepare(tc, cuda_device)
    for n in (95, 4095, 4097 + 4096):
        c, ln = _skewed(cls, lens, n=n)
        c, ln = torch.from_numpy(c).to(cuda_device), torch.from_numpy(ln).to(cuda_device)
        want = nfa_match.accept_words_plain(prep, c, ln)
        for R in nfa_match.LINES_PER_THREAD:
            assert torch.equal(nfa_match.accept_words(prep, c, ln, lines=R), want), (n, R)


def _random_rules(C, n_shards, wps, carry_free, seed):
    """A TorchNfaRules of random uint32 rows, so that every launch shape
    can be reached (single-warp and multi-warp teams, the table in shared
    or device memory). shift_in's bit 0 is clear where the kernel takes no
    carry, as rulec compiles it: each shard's first word, and every word
    of a carry-free ruleset (the plain scan carries across all words)."""
    rng = np.random.default_rng(seed)
    W = n_shards * wps
    table = rng.integers(0, 2**32, (C, W), dtype=np.uint64).astype(np.uint32)
    masks = rng.integers(0, 2**32, (6, W), dtype=np.uint64).astype(np.uint32)
    masks[0] |= rng.integers(0, 2**32, W, dtype=np.uint64).astype(np.uint32)  # dense shift_in
    masks[0, ::wps] &= ~np.uint32(1)
    if carry_free:
        masks[0] &= ~np.uint32(1)
    return nfa_match.TorchNfaRules(
        n_rules=0, n_shards=n_shards, wps=wps, n_classes=C, carry_free=carry_free,
        table=torch.from_numpy(table.view(np.int32)), masks=torch.from_numpy(masks.view(np.int32)),
        table_words=torch.from_numpy(table.astype(np.int64)),
        mask_words=torch.from_numpy(masks.astype(np.int64)),
        acc_word=None, acc_mask=None, branch_rule=None, always_match=None, empty_only=None,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("C,n_shards,wps,carry_free", [
    (40, 3, 20, False),    # one-warp teams: no edge, no named barrier
    (40, 2, 150, False),   # five-warp teams, table in shared memory
    (240, 1, 300, False),  # 288 KB table: read from device memory
    (40, 2, 150, True),
    (240, 1, 300, True),
])
def test_kernel_a_matches_plain_on_random_tables(C, n_shards, wps, carry_free, cuda_device):
    """Every R; class ids and lengths out of range (both sides clamp)."""
    prep = _random_rules(C, n_shards, wps, carry_free, seed=C + wps)
    prep = dataclasses.replace(prep, table=prep.table.to(cuda_device),
                               masks=prep.masks.to(cuda_device),
                               table_words=prep.table_words.to(cuda_device),
                               mask_words=prep.mask_words.to(cuda_device))
    rng = np.random.default_rng(wps)
    B, L = 301, 40
    cls = torch.from_numpy(rng.integers(-2, C + 2, (B, L + 3), dtype=np.int32)).to(cuda_device)
    lens = torch.from_numpy(rng.integers(-1, L + 2, B, dtype=np.int32)).to(cuda_device)
    cls = cls[:, :L]  # strided rows, as match_core passes them
    want = nfa_match.accept_words_plain(prep, cls, lens)
    for R in nfa_match.LINES_PER_THREAD:
        assert torch.equal(nfa_match.accept_words(prep, cls, lens, lines=R), want), R


_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_116nfa_carry_kernelILi2ELb1EEEvPKixS2_
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   SHFL.UP PT, R3, R2, 0x1, RZ ;
        /*0020*/                   PRMT R4, R3, 0x4410, RZ ;
        /*0030*/                   PRMT R5, R3, 0x4432, RZ ;
        /*0040*/                   SHFL.UP PT, R3, R2, 0x1, RZ ;
        /*0050*/                   PRMT R4, R3, 0x4410, RZ ;
        /*0060*/                   PRMT R5, R3, 0x4432, RZ ;
        /*0070*/                   SHFL.UP PT, R3, R2, 0x1, RZ ;
        /*0080*/                   PRMT R4, R3, 0x4410, RZ ;
        /*0090*/                   PRMT R5, R3, 0x4432, RZ ;
        /*00a0*/                   SHFL.UP PT, R3, R2, 0x1, RZ ;
        /*00b0*/                   PRMT R4, R3, 0x4410, RZ ;
        /*00c0*/                   PRMT R5, R3, 0x4410, RZ ;
        /*00d0*/                   LOP3.LUT R6, R4, R5, RZ, 0xc0, !PT ;
        /*00e0*/                   SHFL.UP PT, R3, R2, 0x1, RZ ;
        /*00f0*/                   PRMT R4, R3, 0x4410, RZ ;
        /*0100*/                   PRMT R5, R3, 0x4410, RZ ;
        /*0110*/                   LOP3.LUT R6, R4, R5, RZ, 0xc0, !PT ;
        /*0120*/                   @P0 BRA 0xa0 ;
        /*0130*/                   SHFL.UP PT, R3, R2, 0x1, RZ ;
        /*0140*/                   PRMT R4, R3, 0x4432, RZ ;
        /*0150*/                   PRMT R5, R3, 0x4432, RZ ;
        /*0160*/                   ISETP.GE.AND P1, PT, R7, R8, PT ;
        /*0170*/                   SEL R9, R4, R9, P1 ;
        /*0180*/                   LOP3.LUT R6, R4, R5, RZ, 0xc0, !PT ;
        /*0190*/                   @!P1 BRA 0x130 ;
        /*01a0*/                   @P2 BRA 0x10 ;
        /*01b0*/                   EXIT ;
"""


def test_sass_count_takes_the_cheapest_innermost_byte_step_loop():
    """nfa_carry_kernel<2, true> with two byte-step loops (a shuffle and
    two class-id extracts a byte): 6 ALU instructions for 2 bytes and 5 for
    1 byte, 2 lines a thread. The loop around both (17 for 6 bytes) is not
    innermost and does not count."""
    row = sass_alu.count(_SASS, carry=True, R=2)
    assert (row["bytes_per_iteration"], row["alu"], row["alu_per_line_byte"]) == (2, 6, 1.5)
    with pytest.raises(RuntimeError, match="no single"):
        sass_alu.count(_SASS, carry=True, R=8)


@pytest.mark.cuda
def test_kernel_a_matches_plain_on_the_card(case, cuda_device):
    _, tc, cls, lens = case
    prep = nfa_match.prepare(tc, cuda_device)
    c = torch.from_numpy(cls).to(cuda_device)
    l = torch.from_numpy(lens).to(cuda_device)
    got = nfa_match.accept_words(prep, c, l)
    assert torch.equal(got.cpu(), nfa_match.accept_words_plain(prep, c, l).cpu())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")
