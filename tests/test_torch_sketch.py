"""The port's traffic sketch (`obs/sketch.py`) against the JAX package's:
the same note_assignments / update / fold_refused / note_rule_events
sequence through both, then identical count-min, HLL and slot -> hash
arrays, host mirror, estimate_ips and pull summaries. Base hashes include
the edge words 0 and 0xFFFFFFFF; the uint32 mix and the HLL rho are also
held to numpy and to a bit-length loop on their own."""

import random

import numpy as np
import pytest
import torch

from banjax_tpu.obs import sketch as jax_sketch
from banjax_tpu_torch.obs import sketch

EDGE = {"edge.zero": 0, "edge.ones": 0xFFFF_FFFF, "edge.msb": 0x8000_0000, "edge.one": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def edge_hashes(monkeypatch):
    """Give four IPs the edge base hashes, in both packages."""
    for mod in (sketch, jax_sketch):
        crc = mod.hash_ip
        monkeypatch.setattr(mod, "hash_ip", lambda ip, crc=crc: EDGE.get(ip, crc(ip)))


def _drive(sk, seed, device_sync=lambda: None):
    rng = random.Random(seed)
    pool = list(EDGE) + [f"10.{i % 3}.{i // 7}.{i}" for i in range(400)]
    for batch in range(8):
        uips = list(dict.fromkeys(rng.sample(pool, 90)))
        slots = np.asarray(rng.sample(range(3000), len(uips)), dtype=np.int32)
        sk.note_assignments(uips, slots)
        rows = np.asarray([rng.choice(slots) for _ in range(200)], dtype=np.int32)
        sk.update(rows, 150 + batch)
        refused = rng.sample(pool, 12)
        sk.fold_refused(refused, np.asarray([rng.randrange(1, 4) for _ in refused]))
        sk.note_rule_events(rng.randrange(-1, 5) for _ in range(30))
        if batch == 4:
            sk.pull(force=True)
    device_sync()
    return pool


def _jax_arrays(sk):
    return {"cm": np.asarray(sk._state[0]), "hll": np.asarray(sk._state[1]),
            "slot_hash": np.asarray(sk._slot_hash_dev)}


@pytest.mark.parametrize("depth, width, p", [(4, 8192, 12), (3, 100, 4), (8, 16, 16)])
def test_sketch_matches_jax(edge_hashes, depth, width, p):
    names = [f"r{i}" for i in range(5)]
    ref = jax_sketch.TrafficSketch(names, depth=depth, width=width, hll_p=p, topk=8)
    got = sketch.TrafficSketch(names, "cpu", depth=depth, width=width, hll_p=p, topk=8)
    pool = _drive(ref, 3)
    _drive(got, 3)
    want = _jax_arrays(ref)
    arrays = got.arrays()
    for k in want:
        assert arrays[k].dtype == want[k].dtype and np.array_equal(arrays[k], want[k]), k
    assert np.array_equal(got._cm_host, ref._cm_host)
    assert np.array_equal(got.estimate_ips(pool), ref.estimate_ips(pool))
    assert got.pull(force=True) == ref.pull(force=True)
    assert np.array_equal(got.estimate_ips(pool), ref.estimate_ips(pool))
    assert [got.estimate_ip(ip) for ip in list(EDGE)] == [ref.estimate_ip(ip) for ip in list(EDGE)]
    assert got.lines_total == ref.lines_total and got.update_count == ref.update_count
    # the edge words landed: their slots hold them
    assert {0, 0xFFFF_FFFF} <= set(arrays["slot_hash"].tolist())


def test_fmix32_and_hll_rho_exact():
    rng = np.random.default_rng(5)
    words = np.concatenate([
        np.asarray([0, 1, 0x7FFF_FFFF, 0x8000_0000, 0xFFFF_FFFE, 0xFFFF_FFFF], dtype=np.uint32),
        rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32),
    ])
    got = sketch.fmix32(torch.from_numpy(words.astype(np.int64))).numpy()
    assert np.array_equal(got, jax_sketch._fmix32_np(words).astype(np.int64))
    for p in (4, 12, 16):
        low = 32 - p
        w = np.concatenate([np.arange(0, 70), (1 << np.arange(low)), (1 << np.arange(low + 1)) - 1,
                            rng.integers(0, 1 << low, 500)]).astype(np.int64)
        want = [low - int(x).bit_length() + 1 for x in w]
        assert sketch.hll_rho(torch.from_numpy(w), low).tolist() == want
        assert sketch.hll_rho(torch.tensor([0]), low).item() == 32 - p + 1


def test_sketch_refuses_bad_geometry():
    for kw in ({"depth": 9}, {"width": 15}, {"hll_p": 17}):
        with pytest.raises(ValueError):
            sketch.TrafficSketch(["r"], "cpu", **kw)


@pytest.mark.cuda
def test_sketch_on_the_card_equals_the_cpu(cuda_device, edge_hashes):
    names = ["a", "b"]
    cpu = sketch.TrafficSketch(names, "cpu")
    card = sketch.TrafficSketch(names, cuda_device)
    _drive(cpu, 9)
    _drive(card, 9, device_sync=torch.cuda.synchronize)
    a, b = cpu.arrays(), card.arrays()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert cpu.pull(force=True) == card.pull(force=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
