"""The port's window recurrence, apply and maintenance steps against the
JAX package's: `lax.scan(windows._window_step)`, the Pallas scan kernel in
interpret mode, `windows._apply_core` and `windows._maintenance_step`,
on the same seeded inputs (state carried across with numpy arrays).
Exact integer comparisons."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banjax_tpu.matcher import windows as jax_windows
from banjax_tpu.matcher.kernels import fused_match_window as jax_fmw
from banjax_tpu_torch import convert
from banjax_tpu_torch.matcher import windows
from banjax_tpu_torch.matcher.kernels import fused_match_window as fmw


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch to one intra-op thread: the suite runs in parallel
    workers, and the timing-sensitive tests beside these need the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NAMES = ("hits", "start_s", "start_ns", "match_type", "exceeded")


def _stimulus(E, seed):
    """Sorted-event-shaped input: long segments, random boundaries (some on
    pads), a pad tail and scattered pads, wrap-prone subsecond values."""
    rng = np.random.default_rng(seed)
    boundary = rng.random(E) < 0.15
    pad = rng.random(E) < 0.1
    pad[-E // 5 :] = True
    return (
        boundary,
        rng.integers(0, 6, E).astype(np.int32),
        rng.integers(0, 40, E).astype(np.int32),
        rng.integers(0, 1_000_000_000, E).astype(np.int32),
        rng.random(E) < 0.7,
        np.sort(rng.integers(0, 60, E)).astype(np.int32),
        rng.integers(0, 1_000_000_000, E).astype(np.int32),
        rng.integers(0, 5, E).astype(np.int32),
        rng.integers(0, 20, E).astype(np.int32),
        rng.integers(0, 1_000_000_000, E).astype(np.int32),
        pad,
    )


def _lax_scan(xs):
    init = (jnp.int32(0), jnp.int32(0), jnp.int32(0))
    _, out = jax.lax.scan(jax_windows._window_step, init, tuple(jnp.asarray(x) for x in xs))
    return [np.asarray(o) for o in out]


def _plain(xs):
    return [o.numpy() for o in fmw.window_scan([torch.from_numpy(x) for x in xs])]


@pytest.mark.parametrize("E,seed", [(64, 0), (200, 1), (512, 2)])
def test_plain_scan_matches_lax_scan(E, seed):
    xs = _stimulus(E, seed)
    for name, w, g in zip(NAMES, _lax_scan(xs), _plain(xs)):
        assert np.array_equal(w, g), name


def _edge(kind, E, seed=5):
    """One carry segment over every event (the serial worst case), every
    event a pad, or a single event."""
    xs = list(_stimulus(E, seed))
    if kind == "one_segment":
        xs[0] = np.zeros(E, dtype=bool)
        xs[0][0] = True
        xs[10] = np.zeros(E, dtype=bool)
    elif kind == "all_pad":
        xs[10] = np.ones(E, dtype=bool)
    else:
        xs = [x[:1].copy() for x in xs]
        xs[10][0] = False
    return tuple(xs)


EDGES = [("one_segment", 300), ("all_pad", 64), ("single", 1)]


@pytest.mark.parametrize("kind,E", EDGES)
def test_plain_scan_matches_lax_scan_on_edge_shapes(kind, E):
    xs = _edge(kind, E)
    for name, w, g in zip(NAMES, _lax_scan(xs), _plain(xs)):
        assert np.array_equal(w, g), name


def test_plain_scan_matches_pallas_interpret_on_selftest_stimulus():
    xs = fmw.selftest_stimulus(64)
    init = (jnp.int32(0),) * 3
    want = jax_fmw.window_scan(interpret=True)(init, tuple(jnp.asarray(x) for x in xs))
    for name, w, g in zip(NAMES, want, _plain(xs)):
        assert np.array_equal(np.asarray(w), g), name
    fmw.scan_selftest("cpu")


CAP, R, B, H = 16, 5, 40, 3


def _state_arrays(rng):
    return {
        "hits": rng.integers(0, 4, CAP * R).astype(np.int32),
        "start_s": rng.integers(95, 100, CAP * R).astype(np.int32),
        "start_ns": rng.integers(0, 1_000_000_000, CAP * R).astype(np.int32),
        "valid": rng.random(CAP * R) < 0.5,
        "ip_seen": rng.random(CAP) < 0.5,
    }


def _port_state(arrays):
    return convert.window_state_from_arrays(arrays, "cpu")


def _jax_state(arrays):
    return jax_windows.DeviceWindowState(**{k: jnp.asarray(v) for k, v in arrays.items()})


@functools.lru_cache(maxsize=None)
def _jax_apply(max_events, gated):
    def run(state, gate, *args):
        return jax_windows._apply_core(
            state, *args, n_rules=R, max_events=max_events,
            gate=gate if gated else None,
        )

    return jax.jit(run)


@pytest.mark.parametrize(
    "gate,max_events", [(None, 64), (True, 64), (False, 64), (None, 24)]
)
def test_apply_core_matches_jax(gate, max_events):
    rng = np.random.default_rng(11)
    arrays = _state_arrays(rng)
    bits = (rng.random((B, R)) < 0.3).astype(np.uint8)
    table = rng.random((H, R)) < 0.8
    host_idx = rng.integers(0, H, B).astype(np.int32)
    slots = rng.integers(0, CAP, B).astype(np.int32)
    ts_s = rng.integers(98, 103, B).astype(np.int32)
    ts_ns = rng.integers(0, 1_000_000_000, B).astype(np.int32)
    limits = rng.integers(0, 4, R).astype(np.int32)
    iv_s = rng.integers(0, 4, R).astype(np.int32)
    iv_ns = rng.integers(0, 1_000_000_000, R).astype(np.int32)
    args = (bits, table, host_idx, slots, ts_s, ts_ns, limits, iv_s, iv_ns)

    j_state, j_out = _jax_apply(max_events, gate is not None)(
        _jax_state(arrays), jnp.bool_(bool(gate)), *(jnp.asarray(a) for a in args)
    )
    t_state = _port_state(arrays)
    t_out = windows._apply_core(
        t_state, *(torch.from_numpy(a) for a in args), n_rules=R,
        max_events=max_events,
        gate=None if gate is None else torch.tensor(bool(gate)),
    )
    assert int((np.asarray(j_out["rule"]) >= 0).sum()) > 0
    for k, v in j_out.items():
        assert np.array_equal(np.asarray(v), t_out[k].numpy()), k
    got = t_state.arrays()
    for k in arrays:
        assert np.array_equal(np.asarray(getattr(j_state, k)), got[k]), k
    if gate is False:
        for k in arrays:
            assert np.array_equal(arrays[k], got[k]), k


def test_maintenance_step_matches_jax():
    rng = np.random.default_rng(12)
    arrays = _state_arrays(rng)
    cap_r = CAP * R
    ev_keys = np.array([3, 4, 7, cap_r, cap_r], dtype=np.int32)
    ev_slots = np.array([1, 9, CAP], dtype=np.int32)
    r_keys = np.array([4, 20, 33, cap_r], dtype=np.int32)
    r_vals = [rng.integers(0, 9, 4).astype(np.int32) for _ in range(3)]
    r_slots = np.array([9, 6, CAP, CAP], dtype=np.int32)
    args = (ev_keys, ev_slots, r_keys, *r_vals, r_slots)
    j_state = jax_windows._maintenance_step(_jax_state(arrays), *(jnp.asarray(a) for a in args))
    t_state = _port_state(arrays)
    windows._maintenance_step(t_state, *(torch.from_numpy(a) for a in args))
    got = t_state.arrays()
    for k in arrays:
        assert np.array_equal(np.asarray(getattr(j_state, k)), got[k]), k


@pytest.mark.cuda
def test_kernel_b_matches_plain_on_the_card(cuda_device):
    for E, seed in ((64, 0), (4096, 3)):
        xs = [torch.from_numpy(x) for x in _stimulus(E, seed)]
        want = fmw.window_scan_plain(xs)
        got = fmw.window_scan([x.to(cuda_device) for x in xs])
        for name, w, g in zip(NAMES, want, got):
            assert torch.equal(w, g.cpu()), name


@pytest.mark.cuda
def test_kernel_b_matches_plain_on_the_card_on_edge_shapes(cuda_device):
    """The serial worst case, all pads, a single event, and E beyond one
    shared-memory tile (4,096 events): by one event and by four tiles."""
    shapes = [_edge(k, E) for k, E in (("one_segment", 4096), ("all_pad", 64), ("single", 1))]
    shapes += [_stimulus(4097, 7), _stimulus(16384 + 3, 6)]
    for xs_np in shapes:
        xs = [torch.from_numpy(x) for x in xs_np]
        want = fmw.window_scan_plain(xs)
        got = fmw.window_scan([x.to(cuda_device) for x in xs])
        for name, w, g in zip(NAMES, want, got):
            assert torch.equal(w, g.cpu()), (name, len(xs[0]))


@pytest.mark.cuda
def test_kernel_b_writes_nothing_past_its_outputs(cuda_device):
    """A launch on E events that cut a thread's group of four (E not a
    multiple of 4, or a last tile shorter than the block) writes its
    outputs and nothing after them: each output row is followed by
    sentinels, and the first E values are the plain version's."""
    from banjax_tpu_torch.matcher.kernels._build import raw_stream

    dev = torch.device("cuda", cuda_device.index or 0)
    slack = 64
    for E in (1, 3, 4, 5, 63, 64, 65, 1000, 4095, 4097, 8191, 12289):
        xs_np = _stimulus(E, E)
        want = fmw.window_scan_plain([torch.from_numpy(x) for x in xs_np])
        xs = [torch.from_numpy(x).to(dev) for x in xs_np]
        out = torch.full((4, E + slack), -123456789, dtype=torch.int32, device=dev)
        ex = torch.full((E + slack,), 7, dtype=torch.uint8, device=dev)
        rows = [out[r].data_ptr() for r in range(4)]
        fmw.KERNEL.call("window_scan_launch", *[x.data_ptr() for x in xs], *rows,
                        ex.data_ptr(), E, dev.index, raw_stream(dev))
        got = out.cpu()
        for r, name in enumerate(NAMES[:4]):
            assert torch.equal(want[r], got[r, :E]), (name, E)
        assert torch.equal(want[4], ex[:E].cpu().view(torch.bool)), ("exceeded", E)
        assert (got[:, E:] == -123456789).all(), ("int32 output written past E", E)
        assert (ex[E:].cpu() == 7).all(), ("exceeded written past E", E)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")
