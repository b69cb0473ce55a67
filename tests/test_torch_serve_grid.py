"""The port's fused serving backend and ``serve_grid`` against the JAX package.

On the CPU the port's ``"fused"`` backend runs the plain version of the
``serve_route`` kernel once per slot; it must equal the reference's
``"pallas"`` backend (its kernel run interpreted) and both dense backends
field for field.  ``serve_grid`` runs every (cell, seed) pair as one
cell-major run axis and must equal ``serve_one`` per cell and seed, and the
reference's own grid.  Zero tolerance throughout (see
``tests/test_torch_serve_engine.py``).
"""
import numpy as np
import pytest

from repro.serve import engine as jeng
from repro_torch.kernels import ops as tops
from repro_torch.serve import engine as teng

SERVE_BASE = dict(
    replicas=8, decode_slots=4, slots=1500, load=0.9, x=3, rt_period=32,
    mean_prefill=2, mean_decode=16, queue_cap=256, policy="jsaq",
    deterministic_ties=True,
)
SMALL = dict(
    replicas=8, decode_slots=4, slots=800, load=0.9, x=3, rt_period=32,
    mean_prefill=2, mean_decode=16, queue_cap=256,
)
HETERO_21 = (2.0, 2.0, 2.0, 2.0, 1.0, 1.0, 1.0, 1.0)


def assert_same(a, b):
    for name in ("completed", "offered", "messages", "dropped", "mean_jct",
                 "p99_jct", "msgs_per_completion"):
        assert getattr(a, name) == getattr(b, name), name
    np.testing.assert_array_equal(a.jct_by_rid, b.jct_by_rid)
    np.testing.assert_array_equal(a.final_occupancy, b.final_occupancy)


class TestFusedBackend:
    @pytest.mark.parametrize("comm", ["et", "dt", "exact"])
    def test_vs_pallas_and_dense(self, comm):
        ref_pallas = jeng.serve_one(
            7, jeng.ServeConfig(**SERVE_BASE, comm=comm, route_backend="pallas"),
            trace_occupancy=True,
        )
        ref_dense = jeng.serve_one(7, jeng.ServeConfig(**SERVE_BASE, comm=comm))
        tops.reset_launch_counts()
        fused = teng.serve_one(
            7, teng.ServeConfig(**SERVE_BASE, comm=comm, route_backend="fused"),
            trace_occupancy=True, device="cpu",
        )
        assert tops.launch_counts()["serve_route"] == 0  # the plain version ran
        dense = teng.serve_one(7, teng.ServeConfig(**SERVE_BASE, comm=comm), device="cpu")
        for other in (ref_dense, fused, dense):
            assert_same(ref_pallas, other)
        np.testing.assert_array_equal(fused.occupancy, ref_pallas.occupancy)


class TestGrid:
    @pytest.mark.parametrize("backend", ["dense", "fused"])
    def test_cell_major_and_equal_to_serve_one(self, backend):
        # An ET-x ladder plus a shorter-horizon cell padded to the grid's
        # length: one run axis, and every run equals its own serve_one.
        extra = dict(route_backend=backend, deterministic_ties=backend == "fused")
        cells = [
            teng.ServeConfig(**{**SMALL, **kw}, comm="et", **extra)
            for kw in (dict(x=2), dict(x=5), dict(x=4, slots=500, max_slots=800))
        ]
        seeds = [0, 1]
        grid = teng.serve_grid(seeds, cells[0].static_part(), cells, device="cpu")
        assert [len(row) for row in grid] == [2, 2, 2]
        for cell, row in zip(cells, grid):
            for seed, got in zip(seeds, row):
                assert_same(teng.serve_one(seed, cell, device="cpu"), got)

    @pytest.mark.parametrize("policy", ["sqd", "drain", "rr"])
    def test_matches_reference_grid(self, policy):
        # Uniform-ones and 2:1 rate profiles share one static part.
        cells = [
            {**SMALL, "x": x, "policy": policy, "comm": "et",
             "decode_rates": rates, "msr_drain": 0.25}
            for x, rates in ((2, (1.0,) * 8), (4, HETERO_21))
        ]
        jcells = [jeng.ServeConfig(**c) for c in cells]
        tcells = [teng.ServeConfig(**c) for c in cells]
        ref = jeng.serve_grid([0, 1], jcells[0].static_part(), jcells, shard=False)
        got = teng.serve_grid([0, 1], tcells[0].static_part(), tcells, device="cpu")
        for ref_row, got_row in zip(ref, got):
            for r, g in zip(ref_row, got_row):
                assert_same(r, g)
