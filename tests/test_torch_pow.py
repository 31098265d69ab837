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
from banjax_tpu_torch.matcher.kernels import pow_verify

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
