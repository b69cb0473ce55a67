"""The schedules of the ``serve_route`` and ``serve_slots`` CUDA kernels, on the CPU.

``csrc/serve_lanes.cuh`` routes a slot's lanes on one warp (owner ranges of
32-replica sub-blocks, order-preserving keys with ``-0.0`` folded, a
rescan of the bumped sub-block, the chain stopped at the first drop),
mirrored in plain Python by ``kernels.jsaq_route.serve_lanes_warp`` (change
both together).  ``serve_slots_kernel`` in ``csrc/serve_route.cu`` runs the
stages of the engine's per-slot loop (``serve.engine._serve_loop``) in the
loop's order, a chain stage and then a replica stage a slot, so that loop
with its route step through ``serve_lanes_warp`` mirrors its schedule.
These tests hold the mirrors against the plain versions
(``ref.serve_route_ref``, the port's per-slot loop on the CPU) and against
the JAX package (its Pallas kernel in interpret mode, ``serve_one`` with
``route_backend="pallas"``), on numpy-seeded inputs.  Every output is
int32, bool or a float32 sum of whole steps, so the tolerance is zero:
arrays must be equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.serve import engine as jeng
from repro_torch.kernels import jsaq_route as tcuda
from repro_torch.kernels import ref as tref
from repro_torch.serve import engine as teng

REPLICAS = [1, 8, 31, 32, 33, 200, 1024, 1025, 2048]
KINDS = ["rt", "dt", "et", "et_rt", "exact", "none"]
# A small fused serving cell: 8 replicas, rings of 6, rt_period 7.
CELL = dict(
    replicas=8, decode_slots=4, slots=300, load=0.9, x=3, rt_period=7,
    mean_prefill=2, mean_decode=16, queue_cap=6, msr_drain=0.25,
    deterministic_ties=True, route_backend="fused",
)
RATES = (2.0, 1.5, 1.0, 0.5, 1.0, 1.0, 0.7, 1.3)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _lane_state(r: int, a_n: int, cap: int, seed: int):
    """Seven runs: all lanes into an all-ties row; every ring full; past
    the horizon; no lane; ``-0.0`` scores; two random runs."""
    rng = np.random.default_rng(seed)
    d = 7
    q_len = rng.integers(0, cap + 1, (d, r)).astype(np.int32)
    busy = rng.integers(0, 5, (d, r)).astype(np.int32)
    approx = (rng.integers(0, 40, (d, r)) * 0.25).astype(np.float32)
    n_arr = rng.integers(0, a_n + 1, d).astype(np.int32)
    act = np.ones(d, bool)
    q_len[0], busy[0], approx[0], n_arr[0] = 2, 1, 3.0, a_n
    q_len[1], n_arr[1] = cap, a_n
    act[2] = False
    n_arr[3] = 0
    approx[4, ::3] = -0.0
    busy[4, ::3] = 0
    q_len[4, ::3] = 0
    n_arr[4] = a_n
    return [
        torch.from_numpy(x) for x in (
            rng.random((d, a_n), dtype=np.float32), q_len,
            rng.integers(0, cap, (d, r)).astype(np.int32), busy, approx, n_arr, act,
        )
    ]


class TestWarpChain:
    @pytest.mark.parametrize("comm", ["et", "exact"])
    @pytest.mark.parametrize("r", REPLICAS)
    def test_matches_plain_and_pallas(self, r, comm):
        cap, a_n = 6, 24
        state = _lane_state(r, a_n, cap, seed=r)
        got = tcuda.serve_lanes_warp(*state, cap=cap, comm=comm)
        want = tref.serve_route_ref(*state, cap=cap, comm=comm)
        for g, w in zip(got, want):
            _eq(g.numpy(), w.numpy())
        jax_route = jax.jit(functools.partial(
            jops.serve_route, cap=cap, comm=comm, interpret=True
        ))
        for row in range(state[0].shape[0]):
            ref = jax_route(*(jnp.asarray(x[row].numpy()) for x in state))
            for g, w in zip(got, ref):
                _eq(g[row].numpy(), w)
        jv, _, admit, _, _, drops, reads = got
        # A rescan reads a sub-block and, above R = 1024, the owner's minima.
        assert int(reads.max()) == 32 + (-(-r // 1024) if r > 1024 else 0)
        assert int(drops[1]) == a_n and not admit[1].any()
        assert not admit[2].any() and not admit[3].any()
        if comm == "et":
            assert int(jv[0, 0]) == 0  # all ties: the lowest index first
            assert int(jv[4, 0]) == 0  # -0.0 ties with +0.0, broken by index

    def test_key_orders_as_the_floats(self):
        vals = np.array([-np.inf, -3.5, -1.0, -1e-30, -0.0, 0.0, 1e-30, 0.25, 1.0,
                         7.0, 1e30, np.inf], np.float32)
        keys = [tcuda.score_key(v) for v in vals]
        assert keys[4] == keys[5]  # -0.0 == +0.0
        assert all(a < b for a, b in zip(keys[:4] + keys[5:], keys[1:4] + keys[5:][1:]))
        assert max(keys) < 0xFFFFFFFF  # the key of no replica loses to +inf

    def test_chain_stops_at_the_first_drop(self):
        # Ring cap 2: replica 0 fills after two lanes, then every ring holds
        # 2 and the first lane that finds a full ring ends the chain.
        r, cap, a_n = 3, 2, 9
        state = [torch.zeros((1, a_n)), torch.zeros((1, r), dtype=torch.int32),
                 torch.zeros((1, r), dtype=torch.int32), torch.zeros((1, r), dtype=torch.int32),
                 torch.zeros((1, r)), torch.tensor([a_n], dtype=torch.int32),
                 torch.tensor([True])]
        got = tcuda.serve_lanes_warp(*state, cap=cap, comm="et")
        want = tref.serve_route_ref(*state, cap=cap, comm="et")
        for g, w in zip(got, want):
            _eq(g.numpy(), w.numpy())
        assert got[2][0].tolist() == [True] * 6 + [False] * 3
        assert int(got[5][0]) == 3 and got[0][0, 6:].tolist() == [0, 0, 0]


def _mirror_and_loop(monkeypatch, cell: teng.ServeConfig, seeds=(0, 1), horizons=None):
    """The per-slot loop with its route step through the warp-chain mirror
    (serve_slots' schedule) against the plain loop on the same inputs."""
    static = dataclasses.replace(cell.static_part(), trace_occupancy=True)
    runs = teng._grid_runs(list(seeds), static, [cell])
    args = teng._core_args(*runs, "cpu")
    if horizons is not None:
        scn = dataclasses.replace(args.scn, horizon=torch.tensor(horizons, dtype=torch.int32))
        args = args._replace(scn=scn, t_end=min(static.slots, max(max(horizons), 0)))
    want = teng._serve_core(*args)
    calls = []

    def warp_route(*state, cap, comm):
        calls.append(1)
        return tcuda.serve_lanes_warp(*state, cap=cap, comm=comm)[:6]

    with monkeypatch.context() as m:
        m.setattr(teng.kernel_ops, "serve_route", warp_route)
        got = teng._serve_core(*args)
    assert len(calls) == args.t_end  # one chain a slot, all runs at once
    assert got.keys() == want.keys()
    for key, w in want.items():
        if w is None:
            assert got[key] is None, key
        else:
            _eq(got[key].numpy(), w.numpy())
    return runs[0], got


class TestStagedSlots:
    @pytest.mark.parametrize("rates", [False, True])
    @pytest.mark.parametrize("comm", KINDS)
    def test_matches_loop_and_pallas(self, monkeypatch, comm, rates):
        kw = dict(CELL, comm=comm, decode_rates=RATES if rates else None)
        wls, got = _mirror_and_loop(monkeypatch, teng.ServeConfig(**kw), seeds=(7,))
        res = teng.ServeResult.from_run(
            wls[0], got["comp_slot"][0].numpy(), got["msgs"][0], got["total_comp"][0],
            got["dropped"][0], got["final_occ"][0].numpy(), got["occupancy"][0].numpy(),
        )
        ref = jeng.serve_one(
            7, jeng.ServeConfig(**{**kw, "route_backend": "pallas"}), trace_occupancy=True
        )
        for name in ("completed", "offered", "messages", "dropped", "mean_jct", "p99_jct"):
            assert getattr(res, name) == getattr(ref, name), name
        _eq(res.jct_by_rid, ref.jct_by_rid)
        _eq(res.final_occupancy, ref.final_occupancy)
        _eq(res.occupancy, ref.occupancy)
        assert res.completed > 0

    @pytest.mark.parametrize("horizons", [(0, 0), (0, 1), (1, 300), (300, 117)])
    def test_horizons(self, monkeypatch, horizons):
        _, got = _mirror_and_loop(monkeypatch, teng.ServeConfig(**CELL, comm="et_rt"),
                                  horizons=horizons)
        for run, h in enumerate(horizons):
            # Frozen past its horizon: every later occupancy row is the final one.
            assert (got["occupancy"][run, h:] == got["final_occ"][run]).all()

    @pytest.mark.parametrize("r", [31, 33, 200])
    def test_replica_counts(self, monkeypatch, r):
        cell = teng.ServeConfig(**{**CELL, "replicas": r, "slots": 60, "load": 0.5,
                                   "mean_decode": 8}, comm="dt")
        _, got = _mirror_and_loop(monkeypatch, cell)
        assert int(got["total_comp"].sum()) > 0

    def test_drops(self, monkeypatch):
        cell = teng.ServeConfig(**{**CELL, "queue_cap": 2, "decode_slots": 1,
                                   "load": 2.0}, comm="exact")
        _, got = _mirror_and_loop(monkeypatch, cell)
        assert int(got["dropped"].min()) > 0
        assert (got["msgs"] == got["total_comp"]).all()  # exact bills each departure
