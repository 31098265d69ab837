"""Kernel C (the batched SHA-256 PoW check): the port's plain version
against the JAX kernel's own arithmetic and against hashlib, exactly
(tolerance 0: these are integer bit counts).

The JAX side runs `pow_verify._pow_kernel`, the Pallas kernel's body,
eagerly on numpy refs of the JAX package's own `pack_pow_messages`
layout: the same uint32 arithmetic, round by round, without the
pallas_call. (Through `pallas_call(interpret=True)` the kernel does not
finish within minutes on a CPU, so the port's tests do not take that
route.)"""

import hashlib

import numpy as np
import pytest
import torch

from banjax_tpu.crypto.challenge import count_zero_bits_from_left
from banjax_tpu.matcher.kernels import pow_verify as jax_pow
from banjax_tpu_torch.matcher.kernels import pow_verify, sass_alu

SIZES = (1, 127, 128, 129, 300)


def _degenerate():
    """All zeros, 51 zeros then 0x01, all 0xFF, and payloads whose digest
    starts with at least 10 zero bits (found by search from a seed)."""
    out = [b"\x00" * 52, b"\x00" * 51 + b"\x01", b"\xff" * 52]
    base = bytearray(np.random.default_rng(3).integers(0, 256, 52, np.uint8).tobytes())
    counter = 0
    while len(out) < 6:
        base[44:52] = counter.to_bytes(8, "big")
        if count_zero_bits_from_left(hashlib.sha256(bytes(base)).digest()) >= 10:
            out.append(bytes(base))
        counter += 1
    return out


def _payloads():
    rng = np.random.default_rng(20)
    return [rng.integers(0, 256, 52, np.uint8).tobytes() for _ in range(sum(SIZES))] + _degenerate()


@pytest.fixture(scope="module")
def reference():
    """(payloads, JAX kernel-body counts, hashlib counts) for every case."""
    payloads = _payloads()
    words, n = jax_pow.pack_pow_messages(payloads)
    out = np.zeros((1, words.shape[1]), np.int32)
    jax_pow._pow_kernel(words, out)
    want = [count_zero_bits_from_left(hashlib.sha256(p).digest()) for p in payloads]
    return payloads, out[0, :n].tolist(), want


def _cases():
    start = 0
    for b in SIZES:
        yield f"B{b}", start, start + b
        start += b
    yield "degenerate", start, start + len(_degenerate())


@pytest.mark.parametrize("name,lo,hi", list(_cases()))
def test_plain_version_matches_jax_kernel_and_hashlib(reference, name, lo, hi):
    payloads, jax_bits, want = reference
    got = pow_verify.leading_zero_bits(pow_verify.pack_payloads(payloads[lo:hi], "cpu"))
    assert got.dtype == torch.int32 and got.shape == (hi - lo,)
    assert got.tolist() == jax_bits[lo:hi] == want[lo:hi], name
    if name == "degenerate":
        assert max(want[lo:hi]) >= 10


def test_selftest_passes_on_the_cpu():
    pow_verify.pow_selftest("cpu")


def test_wrapper_refuses_what_the_kernel_does_not_take():
    ok = torch.zeros((4, 52), dtype=torch.uint8)
    with pytest.raises(TypeError):
        pow_verify.leading_zero_bits(ok.to(torch.int32))
    with pytest.raises(ValueError):
        pow_verify.leading_zero_bits(torch.zeros((4, 51), dtype=torch.uint8))
    with pytest.raises(ValueError):
        pow_verify.leading_zero_bits(torch.zeros(52, dtype=torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        pow_verify.leading_zero_bits(torch.zeros((52, 4), dtype=torch.uint8).t())
    with pytest.raises(ValueError, match="unsupported device"):
        pow_verify.leading_zero_bits(torch.zeros((4, 52), dtype=torch.uint8, device="meta"))
    unaligned = torch.zeros(1 + 2 * 52, dtype=torch.uint8)[1:].view(2, 52)
    assert unaligned.is_contiguous()
    with pytest.raises(ValueError, match="4-byte boundary"):
        pow_verify.leading_zero_bits(unaligned)


def test_pack_refuses_a_wrong_length_with_the_jax_message():
    bad = [b"\x01" * 52, b"short"]
    with pytest.raises(ValueError) as jax_err:
        jax_pow.pack_pow_messages(bad)
    with pytest.raises(ValueError) as port_err:
        pow_verify.pack_payloads(bad, "cpu")
    assert str(port_err.value) == str(jax_err.value)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_c_matches_plain_on_the_card(cuda_device):
    payloads = _payloads()
    msg = pow_verify.pack_payloads(payloads, cuda_device)
    got = pow_verify.leading_zero_bits(msg)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), pow_verify.leading_zero_bits_plain(msg).cpu())
    pow_verify.pow_selftest(cuda_device)


def test_dispatcher_refuses_a_cpu_device():
    with pytest.raises(ValueError, match="CUDA device"):
        pow_verify.PowDispatcher(4, "cpu")


def test_payload_check_refuses_a_wrong_length_with_the_pack_message():
    bad = [b"\x01" * 52, b"\x02" * 53]
    with pytest.raises(ValueError) as pack_err:
        pow_verify.pack_payloads(bad, "cpu")
    with pytest.raises(ValueError) as check_err:
        pow_verify.check_payloads(bad)
    assert str(check_err.value) == str(pack_err.value) == "payload 1: want 52 bytes, got 53"


_POW_SASS = """
        Function : _ZN46_GLOBAL__N__fea03135_13_pow_verify_cu_56e01efa17pow_verify_kernelEPKhPii
        /*0000*/                   S2R R0, SR_CTAID.X ;
        /*0010*/                   IMAD R0, R0, c[0x0][0x0], R1 ;
        /*0020*/                   ISETP.GE.AND P0, PT, R0, UR4, PT ;
        /*0030*/               @P0 EXIT ;
        /*0040*/                   LDG.E.CONSTANT R2, desc[UR4][R2.64] ;
        /*0050*/                   PRMT R3, R2, 0x123, RZ ;
        /*0060*/                   SHF.R.W.U32.HI R4, R3, 0x6, R3 ;
        /*0070*/                   LOP3.LUT R5, R4, R3, R2, 0x96, !PT ;
        /*0080*/                   IADD3 R8, R5, 0x6a09e667, R3 ;
        /*0090*/                   FLO.U32 R3, R8 ;
        /*00a0*/                   ISETP.NE.AND P0, PT, R8, RZ, PT ;
        /*00b0*/                   BSSY B0, 0x120 ;
        /*00c0*/                   IADD3 R3, -R3, 0x1f, RZ ;
        /*00d0*/               @P0 BRA 0x110 ;
        /*00e0*/                   VIADD R7, R10, 0xc67178f2 ;
        /*00f0*/                   MOV R10, 0x100 ;
        /*0100*/                   CALL.REL.NOINC 0x140 ;
        /*0110*/                   BSYNC B0 ;
        /*0120*/                   STG.E desc[UR4][R4.64], R3 ;
        /*0130*/                   EXIT ;
        /*0140*/                   VIADD R5, R5, 0xbb67ae85 ;
        /*0150*/                   FLO.U32 R8, R5 ;
        /*0160*/                   ISETP.NE.AND P0, PT, R5, RZ, PT ;
        /*0170*/               @P0 BRA 0x190 ;
        /*0180*/                   IADD3 R8, -R8, 0x1f, RZ ;
        /*0190*/                   RET.REL.NODEC R4 0x0 ;
        /*01a0*/                   BRA 0x1a0;
"""


def test_sass_count_of_kernel_c_leaves_out_the_tail():
    """pow_verify_kernel's path to its store: 8 ALU instructions (ISETP x2,
    PRMT, SHF, LOP3, IADD3 x2, FLO) of 17; the call site its branch skips
    (VIADD, MOV, CALL) and the tail_bits subroutine past the last EXIT
    (from the CALL's target) are left out."""
    row = sass_alu.count_pow(_POW_SASS)
    assert (row["alu"], row["instructions"], row["left_out"]) == (8, 17, 10)
    assert "CALL" not in row["opcodes"] and "RET" not in row["opcodes"]
    with pytest.raises(RuntimeError, match="no single pow_verify_kernel"):
        sass_alu.count_pow(_POW_SASS.replace("pow_verify_kernel", "other_kernel"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [1, 2, 255, 256, "degenerate"])
def test_dispatcher_matches_hashlib_on_the_card(case, cuda_device):
    d = pow_verify.PowDispatcher(256, cuda_device)
    payloads = _degenerate() if case == "degenerate" else _payloads()[:case]
    want = [count_zero_bits_from_left(hashlib.sha256(p).digest()) for p in payloads]
    launches = pow_verify.KERNEL.launches
    assert d.bits(payloads) == want
    assert pow_verify.KERNEL.launches == launches + 1
    # the slots are reused: a smaller batch after a larger one
    assert d.bits(payloads[:1]) == want[:1]


@pytest.mark.cuda
def test_dispatcher_refuses_what_it_does_not_take(cuda_device):
    d = pow_verify.PowDispatcher(2, cuda_device)
    with pytest.raises(ValueError, match="exceed"):
        d.bits([b"\x00" * 52] * 3)
    with pytest.raises(ValueError, match="payload 1: want 52 bytes, got 51"):
        d.bits([b"\x00" * 52, b"\x00" * 51])
    assert d.bits([]) == []
    pow_verify.pow_selftest(cuda_device, d)


@pytest.mark.cuda
def test_mapped_check_takes_pinned_host_memory_only(cuda_device):
    lib = pow_verify.KERNEL.lib()
    pinned = torch.empty(64, dtype=torch.uint8, pin_memory=True)
    pageable = torch.empty(64, dtype=torch.uint8)
    on_card = torch.empty(64, dtype=torch.uint8, device=cuda_device)
    assert lib.pow_verify_check_mapped(pinned.data_ptr(), cuda_device.index or 0) == 0
    assert lib.pow_verify_check_mapped(pageable.data_ptr(), cuda_device.index or 0) != 0
    assert lib.pow_verify_check_mapped(on_card.data_ptr(), cuda_device.index or 0) != 0


@pytest.mark.cuda
def test_a_dispatch_does_not_wait_for_the_current_stream(cuda_device):
    d = pow_verify.PowDispatcher(4, cuda_device)
    payload = _payloads()[0]
    want = count_zero_bits_from_left(hashlib.sha256(payload).digest())
    torch.cuda._sleep(400_000_000)  # ~0.2 s of one thread on the current stream
    queued = torch.cuda.Event()
    queued.record()
    assert d.bits([payload]) == [want]
    assert not queued.query()
    torch.cuda.synchronize()
    assert queued.query()
