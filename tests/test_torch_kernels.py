"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run the plain PyTorch versions
(``repro_torch.kernels.ref``); they are held against the Pallas kernels
run in interpret mode on the same numpy-seeded inputs.  Every output is
int32 (``serve_route`` adds bools and float32 sums of whole ``+1.0`` steps),
so the tolerance is zero: arrays must be equal.  The CUDA kernels
themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attn as tflash
from repro_torch.kernels import jsaq_route as tcuda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

POLICIES = ["jsq", "jsaq"]
KINDS = ["rt", "dt", "et", "et_rt", "exact", "none"]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _jsaq_both(q: np.ndarray, n: int):
    j_idx, j_q = jops.jsaq_route(jnp.asarray(q), n, interpret=True)
    t_idx, t_q = tops.jsaq_route(torch.from_numpy(q), n)
    _eq(t_idx.numpy(), j_idx)
    _eq(t_q.numpy(), j_q)
    return t_idx.numpy(), t_q.numpy()


class TestJsaqRoute:
    @pytest.mark.parametrize("d,k,n", [(8, 30, 7), (13, 16, 5), (40, 128, 32)])
    def test_matches_pallas(self, d, k, n):
        # (13, 16) is not a multiple of the TPU domain tile: the reference
        # pads rows, the port needs no padding.
        q = np.random.default_rng(d * 1000 + k).integers(0, 50, (d, k), dtype=np.int32)
        _jsaq_both(q, n)

    @pytest.mark.parametrize("k", [130, 200, 300])
    def test_segmented(self, k):
        # K beyond one 128-lane tile: the reference's segmented argmin.
        q = np.random.default_rng(k).integers(0, 50, (8, k), dtype=np.int32)
        _jsaq_both(q, 9)

    def test_pad_lanes_never_win(self):
        q = np.full((8, 130), 10**6, np.int32)
        idx, q_out = _jsaq_both(q, 32)
        assert (idx < 130).all()
        _eq(q_out.sum(axis=1), np.full(8, 130 * 10**6 + 32))

    def test_ties_lowest_index(self):
        q = np.full((8, 260), 7, np.int32)
        q[:, 3] = 1
        q[:, 200] = 1
        idx, _ = _jsaq_both(q, 1)
        _eq(idx[:, 0], np.full(8, 3))
        q2 = np.full((8, 260), 7, np.int32)
        q2[:, 200] = 1
        idx2, _ = _jsaq_both(q2, 1)
        _eq(idx2[:, 0], np.full(8, 200))


def _care_both(policy, comm, *, d, k, t, cap, seed, horizons=None):
    rng = np.random.default_rng(seed)
    arrive = (rng.random((d, t)) < 0.9).astype(np.int32)
    hz = np.full(d, t, np.int32) if horizons is None else np.asarray(horizons, np.int32)
    arrive = arrive * (np.arange(t)[None, :] < hz[:, None])
    x = rng.integers(2, 5, size=d)
    params = np.stack([x, np.full(d, 5), np.full(d, 4), hz], axis=1).astype(np.int32)
    kw = dict(servers=k, cap=cap, policy=policy, comm=comm)
    ref = jops.care_route(jnp.asarray(arrive), jnp.asarray(params), interpret=True, **kw)
    got = tops.care_route(torch.from_numpy(arrive), torch.from_numpy(params), **kw)
    for g, r in zip(got, ref):
        _eq(g.numpy(), r)
    return got


class TestCareRoute:
    @pytest.mark.parametrize("comm", KINDS)
    @pytest.mark.parametrize("policy", POLICIES)
    def test_matches_pallas(self, policy, comm):
        _, _, _, stats = _care_both(
            policy, comm, d=8, k=10, t=300, cap=6, seed=3,
            horizons=[300, 300, 250, 120, 300, 0, 299, 300],
        )
        assert int(stats[:, 2].sum()) > 0

    def test_segmented(self):
        # K beyond one 128-lane tile: the reference's segmented argmin
        # inside the fused slot loop.
        _, _, _, stats = _care_both("jsaq", "dt", d=4, k=200, t=400, cap=8, seed=5)
        assert int(stats[:, 0].sum()) > 0

    def test_drops_and_gap(self):
        # A tiny cap and long jobs force drops.
        arrive = np.ones((2, 200), np.int32)
        params = np.array([[3, 5, 40, 200], [2, 3, 40, 150]], np.int32)
        kw = dict(servers=5, cap=2, policy="jsq", comm="et")
        ref = jops.care_route(jnp.asarray(arrive), jnp.asarray(params), interpret=True, **kw)
        got = tops.care_route(torch.from_numpy(arrive), torch.from_numpy(params), **kw)
        for g, r in zip(got, ref):
            _eq(g.numpy(), r)
        assert (got[3][:, 3].numpy() > 0).all()


def serve_route_state(d, r, a_n, cap, seed):
    """Random serving states with the edge rows of ``chip_smoke.py``.

    Row 0 routes every lane (``n_arr = A``), row 1 has all scores tied,
    row 2 has every ring at ``cap`` (all live lanes drop), row 3 is past
    its horizon (``act = 0``), row 4 has no arrivals; the rest are random.
    """
    rng = np.random.default_rng(seed)
    q_len = rng.integers(0, cap + 1, (d, r)).astype(np.int32)
    q_head = rng.integers(0, cap, (d, r)).astype(np.int32)
    busy = rng.integers(0, 5, (d, r)).astype(np.int32)
    approx = (rng.integers(0, 40, (d, r)) * 0.25).astype(np.float32)
    n_arr = rng.integers(0, a_n + 1, d).astype(np.int32)
    act = np.ones(d, bool)
    tie_u = rng.random((d, a_n), dtype=np.float32)
    n_arr[0] = a_n
    q_len[1], busy[1], approx[1] = 2, 1, 3.0
    q_len[2] = cap
    act[3] = False
    n_arr[4] = 0
    return tie_u, q_len, q_head, busy, approx, n_arr, act


class TestServeRoute:
    @pytest.mark.parametrize("comm", ["et", "exact"])
    @pytest.mark.parametrize("r,a_n,cap", [(16, 24, 8), (200, 40, 16), (130, 1, 4)])
    def test_matches_pallas_row_by_row(self, r, a_n, cap, comm):
        # R=200 and R=130 are not multiples of the TPU's 128-lane tile: the
        # reference pads them, the port needs no padding.  A=1 is one lane.
        d = 6
        state = serve_route_state(d, r, a_n, cap, seed=r + a_n)
        got = tops.serve_route(*map(torch.from_numpy, state), cap=cap, comm=comm)
        jax_route = jax.jit(functools.partial(
            jops.serve_route, cap=cap, comm=comm, interpret=True
        ))
        for row in range(d):
            ref = jax_route(*(jnp.asarray(x[row]) for x in state))
            for g, want in zip(got, ref):
                _eq(g[row].numpy(), want)
        jv, tail, admit, q_len, _, drops = (x.numpy() for x in got)
        assert (drops[2] == state[5][2]) and not admit[2].any()
        assert not admit[3].any() and not admit[4].any()
        np.testing.assert_array_equal(q_len[3:5], state[1][3:5])
        if comm == "et":
            assert jv[1, 0] == 0  # all ties: the lowest index first

    def test_refuses_unknown_comm(self):
        state = serve_route_state(5, 4, 3, 2, seed=0)
        with pytest.raises(ValueError, match="communication kind"):
            tops.serve_route(*map(torch.from_numpy, state), cap=2, comm="jiq")


class TestDispatch:
    def test_cpu_tensor_takes_the_plain_version(self):
        tops.reset_launch_counts()
        q = torch.zeros((2, 5), dtype=torch.int32)
        idx, q_out = tops.jsaq_route(q, 3)
        _eq(idx.numpy(), tref.jsaq_route_ref(q, 3)[0].numpy())
        arrive = torch.ones((2, 20), dtype=torch.int32)
        params = torch.tensor([[3, 5, 4, 20]] * 2, dtype=torch.int32)
        out = tops.care_route(arrive, params, servers=4, cap=8, policy="jsaq", comm="et")
        ref = tref.care_route_ref(arrive, params, servers=4, cap=8, policy="jsaq", comm="et")
        for g, r in zip(out, ref):
            _eq(g.numpy(), r.numpy())
        q, k, v = (torch.ones((1, 4, 2, 8)) for _ in range(3))
        _eq(tops.flash_attention(q, k, v, scale=0.5).numpy(),
            tref.flash_attention_ref(q, k, v, scale=0.5).numpy())
        assert tops.launch_counts() == {"jsaq_route": 0, "care_route": 0, "serve_route": 0,
                                        "serve_slots": 0, "moe_route": 0,
                                        "flash_attention": 0,
                                        "moe_route_bwd": 0, "flash_attention_bwd": 0}

    def test_kernel_binding_refuses_cpu_tensors(self):
        q = torch.zeros((2, 5), dtype=torch.int32)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tcuda.jsaq_route_cuda(q, 1)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tcuda.care_route_cuda(
                q, q[:, :4].contiguous(), servers=4, cap=8, policy="jsaq", comm="et"
            )
        state = [torch.from_numpy(x) for x in serve_route_state(5, 4, 3, 2, seed=0)]
        with pytest.raises(ValueError, match="CUDA tensor"):
            tcuda.serve_route_cuda(*state, cap=2, comm="et")
        q4 = torch.zeros((1, 4, 2, 8))
        with pytest.raises(ValueError, match="CUDA tensor"):
            tflash.flash_attention_cuda(q4, q4, q4, scale=1.0)
        assert tops.launch_counts()["care_route"] == 0
        assert tops.launch_counts()["serve_route"] == 0
        assert tops.launch_counts()["flash_attention"] == 0

    def test_unknown_kinds(self):
        arrive = torch.ones((1, 4), dtype=torch.int32)
        params = torch.tensor([[3, 5, 4, 4]], dtype=torch.int32)
        with pytest.raises(ValueError, match="policies"):
            tops.care_route(arrive, params, servers=4, cap=8, policy="rr", comm="et")
        with pytest.raises(ValueError, match="communication kind"):
            tops.care_route(arrive, params, servers=4, cap=8, policy="jsq", comm="jiq")
