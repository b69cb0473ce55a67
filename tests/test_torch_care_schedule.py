"""The tile schedule of the ``care_route`` CUDA kernel, on the CPU.

``csrc/care_route.cu`` visits a tile of servers only when its state can
change, and routes each slot from the previous slot's visits.  Its schedule
is mirrored in plain Python by ``kernels.jsaq_route.care_route_tiled``
(change both together); these tests hold the mirror against the plain
per-slot loop ``ref.care_route_ref`` and against the JAX package's Pallas
kernel in interpret mode, on numpy-seeded inputs.  Every output is int32,
so the tolerance is zero: arrays must be equal.  The rows rest and wake:
x in {-1, 0, 1, 3} (x <= 0 makes every tile due every slot under dt, et and
et_rt), rt_period 1 and more, msr 1 and more, horizons 0, 1 and T, a row
with an arrival in every slot and a row with none; the server counts take
K = 1, K below the tile and K not a multiple of it; cap 1 drops jobs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import jsaq_route as tcuda
from repro_torch.kernels import ref as tref

POLICIES = ["jsq", "jsaq"]
KINDS = ["rt", "dt", "et", "et_rt", "exact", "none"]
SLOTS = 40
# (K, tile, cap): one server; K below one tile; K not a multiple of the
# tile, with cap 1; many tiles.
SHAPES = [(1, 4, 1), (5, 8, 2), (23, 4, 1), (64, 8, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Run this file's per-slot loops on one intra-op thread.

    Each operation of ``care_route_ref``'s loop over ``(D, K)`` tensors is
    too small to gain from intra-op threads, which only add a barrier per
    operation; when other processes share the cores, the threads spin at
    each barrier and the main-path shape takes many times longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _rows(seed: int, t: int = SLOTS):
    """Six runs of ``[x, rt_period, msr, horizon]`` and their arrivals."""
    rng = np.random.default_rng(seed)
    params = np.array([
        [-1, 1, 1, t],  # an arrival every slot; every tile due every slot
        [0, 3, 4, t],
        [1, 5, 8, 1],  # horizon 1
        [3, 2, 2, 0],  # horizon 0
        [3, 7, 3, t],  # no arrivals
        [1, 4, 8, t],
    ], np.int32)
    arrive = (rng.random((len(params), t)) < 0.7).astype(np.int32)
    arrive[0] = 1
    arrive[4] = 0
    arrive *= np.arange(t)[None, :] < params[:, 3:4]
    return arrive, params


def _mirror_and_ref(arrive, params, *, tile, **kw):
    a, p = torch.from_numpy(arrive), torch.from_numpy(params)
    got = tcuda.care_route_tiled(a, p, tile=tile, **kw)
    want = tref.care_route_ref(a, p, **kw)
    for g, w in zip(got[:4], want):
        _eq(g.numpy(), w.numpy())
    return got


@pytest.mark.parametrize("k,tile,cap", SHAPES)
@pytest.mark.parametrize("comm", KINDS)
@pytest.mark.parametrize("policy", POLICIES)
def test_mirror_matches_plain_loop(policy, comm, k, tile, cap):
    arrive, params = _rows(seed=k + tile)
    got = _mirror_and_ref(arrive, params, tile=tile, servers=k, cap=cap,
                          policy=policy, comm=comm)
    stats, visits = got[3].numpy(), got[4].numpy()
    assert stats[:, 2].sum() > 0
    assert visits[3] == 0 and visits[2] <= -(-k // tile)  # horizons 0 and 1
    if k == 1:
        assert stats[:, 3].sum() > 0  # one server at cap 1 drops jobs


@pytest.mark.parametrize("comm", KINDS)
@pytest.mark.parametrize("policy", POLICIES)
def test_mirror_matches_pallas(policy, comm):
    arrive, params = _rows(seed=7)
    kw = dict(servers=23, cap=2, policy=policy, comm=comm)
    got = tcuda.care_route_tiled(
        torch.from_numpy(arrive), torch.from_numpy(params), tile=4, **kw
    )
    want = jops.care_route(jnp.asarray(arrive), jnp.asarray(params), interpret=True, **kw)
    for g, w in zip(got[:4], want):
        _eq(g.numpy(), w)


@pytest.mark.parametrize("comm", ["dt", "rt"])
def test_visits_at_main_path_shape(comm):
    # The mean-field cell cut to K = 20,000 and T = 1000: one Bernoulli
    # arrival a slot at load 0.95, jobs of 8 slots, cap 16, rt_period 100,
    # tiles of the kernel's 256 servers (79 tiles).
    d, k, t, period = 2, 20_000, 1000, 100
    tile = tcuda.care_tile(k)
    n_tiles = -(-k // tile)
    arrive = (np.random.default_rng(1).random((d, t)) < 0.95).astype(np.int32)
    params = np.array([[2, period, 8, t], [3, period, 8, t]], np.int32)
    got = _mirror_and_ref(arrive, params, tile=tile, servers=k, cap=16,
                          policy="jsaq", comm=comm)
    visits = got[4].numpy()
    if comm == "dt":
        # about 8 busy servers, all in tile 0: one tile a slot
        assert (visits <= 1.05 * t).all(), visits
    else:
        # every tile wakes once every rt_period slots, and no more
        assert (visits >= n_tiles * (t // period)).all(), visits
        assert (visits <= 2 * t).all(), visits


def test_care_tile_keeps_the_table_in_shared_memory():
    assert tcuda.care_tile(1) == tcuda.CARE_TILE
    assert tcuda.care_tile(1_000_000) == 256
    limit = tcuda.CARE_MAX_TILES * tcuda.CARE_TILE
    assert tcuda.care_tile(limit) == tcuda.CARE_TILE
    assert tcuda.care_tile(limit + 1) == tcuda.CARE_TILE + 32
    for k in (1, 255, 256, 257, 10**6, limit + 1, 10**7, 10**8 + 7):
        tile = tcuda.care_tile(k)
        assert tile % 32 == 0 and -(-k // tile) <= tcuda.CARE_MAX_TILES


def test_schedule_kinds():
    sched = tcuda._care_schedule
    assert sched("dt", 2, 100) == (False, False)
    assert sched("dt", 0, 100) == (False, True)
    assert sched("et", -1, 100) == (False, True)
    assert sched("rt", -5, 100) == (True, False)
    assert sched("rt", 3, 1) == (True, True)
    assert sched("et_rt", 0, 100) == (True, True)
    assert sched("exact", 0, 1) == (False, False)
    assert sched("none", -1, 0) == (False, False)


@pytest.mark.parametrize(
    "comm,x,expect",
    [("rt", 2, lambda k, t, p: k * (t // p)), ("dt", 0, lambda k, t, p: k * t),
     ("dt", 2, lambda k, t, p: 0), ("none", 0, lambda k, t, p: 0)],
)
def test_count_live_at_rest(comm, x, expect):
    # No arrivals: every server rests, so only its triggers count.
    k, t, period = 9, 30, 4
    arrive = torch.zeros((1, t), dtype=torch.int32)
    params = torch.tensor([[x, period, 3, t]], dtype=torch.int32)
    kw = dict(servers=k, cap=4, policy="jsaq", comm=comm)
    out = tref.care_route_ref(arrive, params, count_live=True, **kw)
    assert len(out) == 5 and len(tref.care_route_ref(arrive, params, **kw)) == 4
    assert int(out[4][0]) == expect(k, t, period)


def test_count_live_with_traffic():
    # A server counts in every slot it holds a job (true or emulated), and
    # never more than K a slot.
    arrive, params = _rows(seed=3)
    a, p = torch.from_numpy(arrive), torch.from_numpy(params)
    out = tref.care_route_ref(a, p, servers=6, cap=3, policy="jsq", comm="exact",
                              count_live=True)
    live = out[4].numpy()
    horizons = params[:, 3].clip(0, SLOTS)
    assert (live <= 6 * horizons).all()
    assert (live >= out[3][:, 2].numpy()).all()  # each admitted job is live in its slot
    assert live[3] == 0 and live[4] == 0


def test_mirror_refuses_what_the_kernel_refuses():
    a = torch.ones((1, 4), dtype=torch.int32)
    p = torch.tensor([[3, 5, 4, 4]], dtype=torch.int32)
    with pytest.raises(ValueError, match="tile"):
        tcuda.care_route_tiled(a, p, servers=4, cap=8, policy="jsq", comm="et", tile=0)
    with pytest.raises(ValueError, match="policies"):
        tcuda.care_route_tiled(a, p, servers=4, cap=8, policy="rr", comm="et", tile=4)
    with pytest.raises(ValueError, match="communication kind"):
        tcuda.care_route_tiled(a, p, servers=4, cap=8, policy="jsq", comm="jiq", tile=4)
    with pytest.raises(ValueError, match="servers"):
        tcuda.care_route_tiled(a, p, servers=0, cap=8, policy="jsq", comm="et", tile=4)
