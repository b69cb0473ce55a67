"""The port's serving engine against the JAX package's, on the same workload.

Both engines draw the workload with the same numpy ``SeedSequence``
streams, so the port's sampler must give byte-identical arrays, and the
port's ``serve_one`` (run with ``device="cpu"``) must give every
``ServeResult`` field of the reference's: the JCT vector in rid order,
completions, offers, messages, drops, final occupancy, mean / p99 JCT and,
under ``trace_occupancy``, the end-of-slot occupancy of every slot.  The
emulated occupancy is float32 on both sides and every product is one IEEE
operation, so the tolerance is zero.  The fused backend, the grid and the
kernel level are in ``tests/test_torch_serve_grid.py`` and
``tests/test_torch_kernels.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serve import engine as jeng
from repro_torch.serve import engine as teng

POLICIES = ["jsaq", "sqd", "rr", "drain"]
KINDS = ["exact", "et", "dt", "rt", "et_rt"]
HETERO_21 = (2.0, 2.0, 2.0, 2.0, 1.0, 1.0, 1.0, 1.0)
NON_DYADIC = (1.5, 4 / 3, 1.0, 0.75, 1.25, 1.0, 2.0, 0.5)
SMALL = dict(
    replicas=8, decode_slots=4, slots=1000, load=0.9, x=3, rt_period=32,
    mean_prefill=2, mean_decode=16, queue_cap=256,
)
FIELDS = [
    "completed", "offered", "messages", "dropped", "mean_jct", "p99_jct",
    "msgs_per_completion",
]


def both(seed, trace=False, **kw):
    """The reference's and the port's ``serve_one`` on one cell."""
    ref = jeng.serve_one(seed, jeng.ServeConfig(**kw), trace_occupancy=trace)
    port_kw = {**kw, "route_backend": "fused"} if kw.get("route_backend") == "pallas" else kw
    got = teng.serve_one(seed, teng.ServeConfig(**port_kw), trace_occupancy=trace,
                         device="cpu")
    return ref, got


def assert_same(ref, got):
    for name in FIELDS:
        assert getattr(got, name) == getattr(ref, name), name
    np.testing.assert_array_equal(got.jct_by_rid, ref.jct_by_rid)
    np.testing.assert_array_equal(got.jct, ref.jct)
    np.testing.assert_array_equal(got.final_occupancy, ref.final_occupancy)
    if ref.occupancy is None:
        assert got.occupancy is None
    else:
        np.testing.assert_array_equal(got.occupancy, ref.occupancy)


class TestSampler:
    @pytest.mark.parametrize("params", [
        dict(replicas=8, decode_slots=4, slots=500, load=0.9, mean_prefill=2,
             mean_decode=16),
        dict(replicas=16, decode_slots=16, slots=300, load=0.7, mean_prefill=4,
             mean_decode=60, rate_scale=1.5),
        dict(replicas=3, decode_slots=2, slots=200, load=2.5, mean_prefill=1,
             mean_decode=3, with_net=True, with_fault=True, with_ack=True),
        dict(replicas=8, decode_slots=1, slots=50, load=0.0),
    ])
    @pytest.mark.parametrize("seed", [0, 7])
    def test_byte_identical(self, params, seed):
        ref = jeng.sample_workload(seed, **params)
        got = teng.sample_workload(seed, **params)
        for f in dataclasses.fields(jeng.ServeWorkload):
            a, b = getattr(ref, f.name), getattr(got, f.name)
            if a is None:
                assert b is None, f.name
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert a.tobytes() == b.tobytes(), f.name
        assert got.total == ref.total

    @pytest.mark.parametrize("kw", [
        dict(),
        dict(decode_rates=HETERO_21, policy="drain", comm="dt"),
        dict(decode_rates=(1.0,) * 8, sqd=4, policy="sqd", x=5),
    ])
    def test_same_key_and_stream(self, kw):
        cell = {**SMALL, **kw}
        assert (teng.ServeConfig(**cell).workload_key()
                == jeng.ServeConfig(**cell).workload_key())
        ref = jeng.workload_for(jeng.ServeConfig(**cell), 3)
        got = teng.workload_for(teng.ServeConfig(**cell), 3)
        np.testing.assert_array_equal(got.work, ref.work)
        np.testing.assert_array_equal(got.tie_u, ref.tie_u)

    def test_from_arrays_copies_the_reference_workload(self):
        ref = jeng.sample_workload(1, replicas=4, decode_slots=2, slots=100,
                                   load=0.8, with_fault=True)
        got = teng.ServeWorkload.from_arrays(ref)
        for f in dataclasses.fields(jeng.ServeWorkload):
            a, b = getattr(ref, f.name), getattr(got, f.name)
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(a, b)
                assert b is not a


class TestSubsetMask:
    @pytest.mark.parametrize("n,d", [(8, 1), (8, 2), (8, 8), (5, 3), (1, 1)])
    def test_matches_reference(self, n, d):
        rng = np.random.default_rng(n * 10 + d)
        u = rng.random((64, teng.SQD_MAX), dtype=np.float32)
        u[0] = 0.0
        u[1] = np.nextafter(np.float32(1), np.float32(0))
        got = teng.subset_mask(torch.from_numpy(u), n, d).numpy()
        for row in range(u.shape[0]):
            np.testing.assert_array_equal(got[row], jeng.subset_mask(u[row], n, d))
        assert (got.sum(1) == d).all()


class TestMatrix:
    @pytest.mark.parametrize("deterministic", [False, True])
    @pytest.mark.parametrize("comm", KINDS)
    @pytest.mark.parametrize("policy", POLICIES)
    def test_matches_reference(self, policy, comm, deterministic):
        ref, got = both(7, trace=True, **SMALL, policy=policy, comm=comm,
                        deterministic_ties=deterministic)
        assert_same(ref, got)
        assert got.dropped == 0 and got.completed > 0.9 * got.offered

    @pytest.mark.parametrize("policy,rates,drain", [
        ("jsaq", HETERO_21, 0.25),
        ("sqd", HETERO_21, 0.25),
        ("rr", HETERO_21, 0.25),
        ("drain", HETERO_21, 0.25),
        ("drain", NON_DYADIC, 0.25),
        ("jsaq", NON_DYADIC, 0.3),
    ])
    def test_decode_rates(self, policy, rates, drain):
        ref, got = both(5, trace=True, **SMALL, policy=policy, comm="et",
                        decode_rates=rates, msr_drain=drain)
        assert_same(ref, got)


class TestShapes:
    @pytest.mark.parametrize("backend", ["dense", "pallas"])
    def test_full_ring_drops_and_conserves(self, backend):
        ref, got = both(
            0, replicas=2, decode_slots=1, slots=400, load=3.0, comm="et", x=2,
            mean_prefill=2, mean_decode=16, queue_cap=8, route_backend=backend,
            deterministic_ties=backend == "pallas",
        )
        assert_same(ref, got)
        assert got.dropped > 0
        assert got.offered - got.dropped == got.completed + int(got.final_occupancy.sum())

    @pytest.mark.parametrize("pad", [
        dict(max_slots=1300),
        dict(max_arrivals=24),
        dict(max_slots=1100, max_arrivals=16),
    ])
    def test_padded_horizon_and_lanes(self, pad):
        ref, got = both(3, trace=True, **SMALL, comm="dt", **pad)
        assert_same(ref, got)
        assert got.occupancy.shape == (pad.get("max_slots", SMALL["slots"]), 8)

    def test_workload_override(self):
        # A reference workload shorter than the cell, handed over as is.
        cell = dict(SMALL, slots=600)
        wl = jeng.sample_workload(11, replicas=8, decode_slots=4, slots=450,
                                  load=0.9, mean_prefill=2, mean_decode=16)
        ref = jeng.serve_one(0, jeng.ServeConfig(**cell), workload=wl)
        got = teng.serve_one(0, teng.ServeConfig(**cell), workload=wl, device="cpu")
        assert_same(ref, got)
        with pytest.raises(ValueError, match="covers"):
            teng.serve_one(0, teng.ServeConfig(**dict(cell, slots=400)),
                           workload=wl, device="cpu")


class TestRefusals:
    @pytest.mark.parametrize("kw,exc,match", [
        (dict(route_backend="fused", policy="sqd"), ValueError, "policy 'jsaq' only"),
        (dict(route_backend="fused"), ValueError, "deterministic_ties"),
        (dict(route_backend="fused", deterministic_ties=True, network="net"),
         NotImplementedError, "route_backend='fused'"),
        (dict(route_backend="pallas"), ValueError, "'dense' or 'fused'"),
        (dict(max_slots=500), ValueError, "max_slots"),
        (dict(policy="sqd", sqd=9), ValueError, "sqd"),
        (dict(decode_rates=(1.0, 2.0)), ValueError, "decode_rates"),
        (dict(policy="random"), ValueError, "unknown policy"),
        (dict(comm="gossip"), ValueError, "unknown communication kind"),
        (dict(network="mesh"), ValueError, "unknown network kind"),
    ])
    def test_static_part(self, kw, exc, match):
        with pytest.raises(exc, match=match):
            teng.ServeConfig(**{**SMALL, **kw}).static_part()

    @pytest.mark.parametrize("kw", [
        dict(network="net", net_delay=3, net_drop=0.1),
        dict(fault="crash", crash_rate=0.02, recover_rate=0.2, suspect_age=6),
        dict(network="net", net_delay=1, net_drop=0.2, transport="ack",
             ack_timeout=4, backoff_base=2.0, max_retries=3, ka_period=8,
             suspect_age=12),
        dict(policy="jiq", comm="jiq"),
        dict(policy="hsq", comm="hsq", x=6),
    ])
    def test_control_plane_and_pull_kinds_run(self, kw):
        # The kinds of items 9 and 10 run on the dense backend, every
        # ServeResult field equal to the reference's.
        ref, got = both(3, **{**SMALL, **kw})
        assert_same(ref, got)
        for name in ("net_drops", "retrans", "token_misses", "token_sum"):
            assert getattr(got, name) == getattr(ref, name), name

    def test_stream_names_its_slice(self):
        static = dataclasses.replace(teng.ServeConfig(**SMALL).static_part(), stream=True)
        with pytest.raises(ValueError, match="serve_stream"):
            teng.serve_grid([0], static, [teng.ServeConfig(**SMALL)], device="cpu")

    def test_grid_shapes(self):
        cell = teng.ServeConfig(**SMALL)
        with pytest.raises(ValueError, match="does not match"):
            teng.serve_grid([0], dataclasses.replace(cell.static_part(), comm="dt"),
                            [cell], device="cpu")
        with pytest.raises(ValueError, match="exceeds"):
            teng.serve_grid([0], dataclasses.replace(cell.static_part(), slots=500),
                            [cell], device="cpu")
        with pytest.raises(ValueError, match="max_arrivals"):
            teng.serve_grid([0], dataclasses.replace(cell.static_part(), max_arrivals=1),
                            [cell], device="cpu")
        with pytest.raises(ValueError, match="max_arrivals"):
            teng.serve_one(0, dataclasses.replace(cell, max_arrivals=1), device="cpu")


class TestDevice:
    def test_default_device_is_the_card(self, monkeypatch):
        cell = teng.ServeConfig(**dict(SMALL, slots=10))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            teng.serve_one(0, cell)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            teng.serve_grid([0], cell.static_part(), [cell])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert teng._resolve_device(None) == torch.device("cuda")
