"""The port's streaming engine (``serve_stream``) against the JAX package's.

The stream sampler's slabs are byte-identical to the reference's, across
block edges, out of order and under diurnal modulation.  The histogram
helpers (``jct_bucket`` on arrays and on int32 tensors, its edges,
quantiles and summary) equal the reference's exactly.  ``serve_stream``
(run with ``device="cpu"``) over every cell of ``tests/test_serve_engine.py``'s
``STREAM_MATRIX`` and chunks {1, 7, 64, 400} gives every counter and the
final occupancy of the reference's ``serve_one`` on ``sampler.full``, and
the whole carry of the reference's ``serve_stream`` leaf by leaf; within
the port any chunking and any resume are identical bit for bit, the float
accumulators included.  Integers and the float32 occupancy estimate match
with zero tolerance.  The float32 running mean and m2 come from Chan's
per-slot combine, whose batch sum of squared deviations XLA and PyTorch
add in their own orders: the mean is held within 1e-6 relative and m2
within 2e-5 relative (the std within 1e-5).  On every cell here (7
cells, warmup 0 and 150) the port's mean and m2 equal the reference's
exactly; the tolerances cover a summation order that may differ.  The degraded control plane's cells are
in ``tests/test_torch_stream_degraded.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import test_serve_engine as _jtests
from repro.core.care import metrics as jmetrics
from repro.serve import engine as jeng
from repro_torch.core.care import comm as comm_lib
from repro_torch.core.care import metrics as tmetrics
from repro_torch.examples import serve_stream as example
from repro_torch.kernels import ops as tops
from repro_torch.serve import engine as teng

STREAM_MATRIX = _jtests.STREAM_MATRIX
CHUNKS = (1, 7, 64, 400)
MEAN_RTOL = 1e-6
M2_RTOL = 2e-5
STD_RTOL = 1e-5
BASE = dict(replicas=6, decode_slots=4, slots=400, load=0.9, queue_cap=256)
FUSED_KNOBS = dict(comm="et", x=4.0, deterministic_ties=True, route_backend="fused")


def cells(**knobs):
    """The reference's and the port's ``ServeConfig`` of one stream cell."""
    jkw = dict(knobs)
    if jkw.get("route_backend") == "fused":
        jkw["route_backend"] = "pallas"
    return jeng.ServeConfig(**{**BASE, **jkw}), teng.ServeConfig(**{**BASE, **knobs})


def port_stream(seed, cell, **kw):
    """The port's serve_stream on a fresh sampler, on the CPU."""
    sampler = teng.StreamSampler(seed, teng.StreamParams.for_cell(cell))
    return teng.serve_stream(seed, cell, sampler=sampler, device="cpu", **kw)


def ref_stream(seed, cell, **kw):
    sampler = jeng.StreamSampler(seed, jeng.StreamParams.for_cell(cell))
    return jeng.serve_stream(seed, cell, sampler=sampler, **kw)


def host(t):
    return t.detach().cpu().numpy()


def assert_close(got, want, rtol, label):
    assert abs(float(got) - float(want)) <= rtol * max(abs(float(want)), 1.0), (
        f"{label}: {float(got)!r} vs {float(want)!r}")


def assert_carry_equals_reference(carry, ref):
    """Every leaf of a port carry (one run) against the reference's
    15-tuple; the float accumulators within the stated tolerances."""
    (q_len, q_head, q_work, q_rid, rem, arid, approx, comm, rr_ptr, sm,
     total_comp, dropped, net, faulted, pull) = ref
    for name, want in (("q_len", q_len), ("q_head", q_head), ("q_work", q_work),
                       ("q_rid", q_rid), ("rem", rem), ("arid", arid),
                       ("approx", approx), ("rr_ptr", rr_ptr),
                       ("total_comp", total_comp), ("dropped", dropped)):
        np.testing.assert_array_equal(host(getattr(carry, name))[0], np.asarray(want),
                                      err_msg=name)
    for f in dataclasses.fields(comm):
        np.testing.assert_array_equal(host(getattr(carry.comm, f.name))[0],
                                      np.asarray(getattr(comm, f.name)), err_msg=f.name)
    got = carry.comp_slot
    for name in ("count", "max_jct", "hist"):
        np.testing.assert_array_equal(host(getattr(got, name))[0],
                                      np.asarray(getattr(sm, name)), err_msg=name)
    assert_close(got.mean[0], sm.mean, MEAN_RTOL, "mean")
    assert_close(got.m2[0], sm.m2, M2_RTOL, "m2")
    if net is None:
        assert carry.net is None
    else:
        assert type(carry.net).__name__ == type(net).__name__
        for f in dataclasses.fields(net):
            np.testing.assert_array_equal(host(getattr(carry.net, f.name))[0],
                                          np.asarray(getattr(net, f.name)), err_msg=f.name)
    if faulted is None:
        assert carry.faulted is None
    else:
        np.testing.assert_array_equal(host(carry.faulted)[0], np.asarray(faulted))
    if pull is None:
        assert carry.pull is None
    else:
        for a, b in zip(carry.pull, pull):
            np.testing.assert_array_equal(host(a)[0], np.asarray(b))


def carry_leaves(carry):
    """Every tensor of a port carry, flattened in a fixed order."""
    out = []

    def walk(x):
        if x is None:
            return
        if torch.is_tensor(x):
            out.append(host(x))
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        else:
            for v in x:
                walk(v)

    walk(carry)
    return out


def assert_same_carry(a, b):
    la, lb = carry_leaves(a), carry_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


class TestSampler:
    @pytest.mark.parametrize("params", [
        dict(),
        dict(diurnal_amp=0.9, diurnal_period=2048),
        dict(with_net=True, with_fault=True, with_ack=True, rate_scale=1.5),
    ])
    def test_slabs_byte_identical(self, params):
        kw = dict(replicas=6, decode_slots=4, load=0.9, **params)
        ref = jeng.StreamSampler(3, jeng.StreamParams(**kw))
        got = teng.StreamSampler(3, teng.StreamParams(**kw))
        # Across block edges (STREAM_BLOCK = 1024) and out of order.
        for t0, t1 in ((2900, 3100), (0, 7), (1023, 1025), (7, 2900), (0, 3000),
                       (5000, 5001)):
            a, b = ref.slab(t0, t1), got.slab(t0, t1)
            for f in dataclasses.fields(jeng.ServeWorkload):
                x, y = getattr(a, f.name), getattr(b, f.name)
                if x is None:
                    assert y is None, f.name
                    continue
                assert x.dtype == y.dtype and x.shape == y.shape, f.name
                assert x.tobytes() == y.tobytes(), (f.name, t0, t1)
        np.testing.assert_array_equal(ref.rate_at(np.arange(4096)),
                                      got.rate_at(np.arange(4096)))

    def test_for_cell_and_prefix_stability(self):
        jcell, tcell = cells(**STREAM_MATRIX[5])
        assert dataclasses.asdict(teng.StreamParams.for_cell(
            tcell, diurnal_amp=0.3, diurnal_period=100)) == dataclasses.asdict(
            jeng.StreamParams.for_cell(jcell, diurnal_amp=0.3, diurnal_period=100))
        params = teng.StreamParams.for_cell(tcell)
        whole = teng.StreamSampler(3, params).full(3000)
        b = teng.StreamSampler(3, params)
        pieces = [b.slab(2900, 3000), b.slab(0, 7), b.slab(7, 2900)]
        for name in ("n_arr", "work", "tie_u", "sub_u", "net_drop_u", "arrival_slot"):
            joined = np.concatenate([getattr(pieces[i], name) for i in (1, 2, 0)])
            np.testing.assert_array_equal(getattr(whole, name), joined, err_msg=name)
        with pytest.raises(ValueError, match="slab"):
            b.slab(5, 5)


I32_MAX = 2**31 - 1
JCTS = sorted({1, 2, 3, 4, 5, 7, 8, 9, 0, -1, -(2**31), I32_MAX, I32_MAX - 1}
              | {v for k in range(2, 31) for v in (2**k - 1, 2**k, 2**k + 1)})


class TestHistogram:
    def test_jct_bucket_numpy_and_tensor(self):
        j = np.array(JCTS, np.int64)
        want = jmetrics.jct_bucket(j)
        got = tmetrics.jct_bucket(j)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        got_t = tmetrics.jct_bucket(torch.tensor(j, dtype=torch.int32))
        assert got_t.dtype == torch.int32
        np.testing.assert_array_equal(host(got_t), want)
        # Every bucket between its edges, the top one included.
        edges = tmetrics.jct_bucket_edges()
        np.testing.assert_array_equal(edges, jmetrics.jct_bucket_edges())
        lo = edges[:-1].clip(max=I32_MAX)
        np.testing.assert_array_equal(tmetrics.jct_bucket(lo), np.arange(tmetrics.HIST_BUCKETS))
        assert tmetrics.HIST_BUCKETS == jmetrics.HIST_BUCKETS

    @pytest.mark.parametrize("seed", [0, 1])
    def test_quantiles_and_summary(self, seed):
        rng = np.random.default_rng(seed)
        jct = rng.integers(1, 5000, 3000)
        hist = np.bincount(tmetrics.jct_bucket(jct), minlength=tmetrics.HIST_BUCKETS)
        qs = (0.0, 0.5, 0.9, 0.99, 0.999, 1.0)
        np.testing.assert_array_equal(tmetrics.log_hist_quantiles(hist, qs),
                                      jmetrics.log_hist_quantiles(hist, qs))
        args = (jct.size, float(jct.mean()), float(jct.var() * jct.size), int(jct.max()), hist)
        assert tmetrics.stream_summary(*args) == jmetrics.stream_summary(*args)

    def test_zero_count(self):
        zero = np.zeros(tmetrics.HIST_BUCKETS, np.int64)
        np.testing.assert_array_equal(tmetrics.log_hist_quantiles(zero, (0.5, 0.99)),
                                      np.zeros(2))
        for args in ((0, 0.0, 0.0, 0, zero), (0, 0.0, 0.0, 17, zero),
                     (5, 3.0, 1.0, 9, zero)):
            assert tmetrics.stream_summary(*args) == jmetrics.stream_summary(*args)


class TestStreamMetrics:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_update_matches_the_reference(self, seed):
        """Slot after slot of random completion batches (some empty), two
        runs at once: integers equal, mean and m2 within tolerance."""
        rng = np.random.default_rng(seed)
        got = teng.StreamMetrics.init(2)
        want = [jeng.StreamMetrics.init(), jeng.StreamMetrics.init()]
        for _ in range(40):
            jct = rng.integers(1, 400, (2, 6, 4)).astype(np.int32)
            meas = rng.random((2, 6, 4)) < rng.choice([0.0, 0.1, 0.5])
            before = got
            got = got.update(torch.from_numpy(jct), torch.from_numpy(meas))
            for d in range(2):
                want[d] = want[d].update(jax.numpy.asarray(jct[d]), jax.numpy.asarray(meas[d]))
                if not meas[d].any():  # an exact no-op
                    for f in dataclasses.fields(got):
                        assert torch.equal(getattr(got, f.name)[d], getattr(before, f.name)[d])
        for d in range(2):
            for name in ("count", "max_jct", "hist"):
                np.testing.assert_array_equal(host(getattr(got, name))[d],
                                              np.asarray(getattr(want[d], name)))
            assert_close(got.mean[d], want[d].mean, MEAN_RTOL, "mean")
            assert_close(got.m2[d], want[d].m2, M2_RTOL, "m2")


class TestStreamEngine:
    @pytest.mark.parametrize("knobs", STREAM_MATRIX, ids=[str(i) for i in range(7)])
    def test_chunk_invariant_and_matches_the_reference(self, knobs):
        jcell, tcell = cells(**knobs)
        wl = jeng.StreamSampler(3, jeng.StreamParams.for_cell(jcell)).full(jcell.slots)
        fixed = jeng.serve_one(3, jcell, workload=wl)
        ref = ref_stream(3, jcell, chunk=64)
        assert_carry_equals_reference(
            port_stream(3, tcell, chunk=64).state.carry, ref.state.carry)
        first = None
        for chunk in CHUNKS:
            res = port_stream(3, tcell, chunk=chunk)
            for name in ("completed", "messages", "dropped", "net_drops", "offered",
                         "token_misses", "token_sum", "retrans", "slots"):
                assert getattr(res, name) == getattr(fixed, name, getattr(ref, name)), name
            np.testing.assert_array_equal(res.final_occupancy, fixed.final_occupancy)
            assert res.count == fixed.completed == ref.count  # warmup 0: all measured
            assert res.max_jct == ref.max_jct
            np.testing.assert_array_equal(res.hist, ref.hist)
            assert_close(res.mean_jct, ref.mean_jct, MEAN_RTOL, "mean_jct")
            assert_close(res.std_jct, ref.std_jct, STD_RTOL, "std_jct")
            if first is None:
                first = res
            else:  # bit for bit within the port, the float accumulators included
                assert_same_carry(res.state.carry, first.state.carry)
                assert (res.mean_jct, res.std_jct) == (first.mean_jct, first.std_jct)

    def test_metrics_match_host_recomputation(self):
        _, cell = cells()
        wl = teng.StreamSampler(7, teng.StreamParams.for_cell(cell)).full(cell.slots)
        fixed = teng.serve_one(7, cell, workload=wl, device="cpu")
        res = port_stream(7, cell, chunk=64)
        jct = fixed.jct
        assert res.count == jct.size and res.max_jct == int(jct.max())
        np.testing.assert_array_equal(
            res.hist, np.bincount(tmetrics.jct_bucket(jct), minlength=tmetrics.HIST_BUCKETS))
        assert_close(res.mean_jct, jct.mean(), 1e-4, "mean")
        assert_close(res.std_jct, jct.std(), 1e-3, "std")
        s = res.jct_summary()
        assert s["count"] == jct.size and s["max"] == int(jct.max())
        for q, key in ((0.5, "p50"), (0.99, "p99")):
            exact = np.quantile(jct, q)
            assert abs(s[key] - exact) <= 0.25 * exact + 1.0

    def test_warmup(self):
        jcell, cell = cells()
        wl = teng.StreamSampler(3, teng.StreamParams.for_cell(cell)).full(cell.slots)
        fixed = teng.serve_one(3, cell, workload=wl, device="cpu")
        warm = 200
        res = port_stream(3, cell, chunk=64, warmup=warm)
        ref = ref_stream(3, jcell, chunk=64, warmup=warm)
        assert res.completed == fixed.completed and res.messages == fixed.messages
        done = fixed.jct_by_rid >= 0
        comp_t = wl.arrival_slot[done] + fixed.jct_by_rid[done] - 1
        measured = fixed.jct_by_rid[done][comp_t >= warm]
        assert res.count == measured.size == ref.count
        assert res.max_jct == int(measured.max()) == ref.max_jct
        np.testing.assert_array_equal(
            res.hist, np.bincount(tmetrics.jct_bucket(measured),
                                  minlength=tmetrics.HIST_BUCKETS))
        assert_close(res.mean_jct, ref.mean_jct, MEAN_RTOL, "mean_jct")
        assert_close(res.std_jct, ref.std_jct, STD_RTOL, "std_jct")
        assert_carry_equals_reference(res.state.carry, ref.state.carry)

    def test_all_completions_in_warmup(self):
        _, cell = cells(slots=100)
        res = port_stream(3, cell, chunk=32, warmup=10**6)
        assert res.count == 0 and res.completed > 0
        assert res.mean_jct == 0.0 and res.std_jct == 0.0
        assert res.jct_summary() == {"count": 0, "mean": 0.0, "std": 0.0, "p50": 0.0,
                                     "p90": 0.0, "p99": 0.0, "p999": 0.0, "max": 0}

    @pytest.mark.parametrize("knobs", [dict(), FUSED_KNOBS], ids=["dense", "fused"])
    def test_resume_matches_one_segment(self, knobs):
        _, cell = cells(**knobs)
        one = port_stream(3, cell, chunk=64)
        sampler = teng.StreamSampler(3, teng.StreamParams.for_cell(cell))
        r1 = teng.serve_stream(3, cell, chunk=64, sampler=sampler, slots=160, device="cpu")
        r2 = teng.serve_stream(3, cell, chunk=64, state=r1.state, slots=cell.slots - 160,
                               device="cpu")
        for name in ("slots", "offered", "completed", "messages", "dropped", "count",
                     "mean_jct", "std_jct", "max_jct"):
            assert getattr(r2, name) == getattr(one, name), name
        np.testing.assert_array_equal(r2.final_occupancy, one.final_occupancy)
        np.testing.assert_array_equal(r2.hist, one.hist)
        assert_same_carry(r2.state.carry, one.state.carry)
        # A host snapshot of the carry resumes the same way.
        r1b = teng.serve_stream(3, cell, chunk=64, slots=160, device="cpu")
        kept = comm_lib.restore_state(comm_lib.snapshot_state(r1b.state.carry))
        state = dataclasses.replace(r1b.state, carry=kept)
        r3 = teng.serve_stream(3, cell, chunk=64, state=state, slots=cell.slots - 160,
                               device="cpu")
        assert_same_carry(r3.state.carry, one.state.carry)

    def test_validation(self):
        _, cell = cells()
        with pytest.raises(ValueError, match="slots"):
            port_stream(3, cell, slots=0)
        with pytest.raises(ValueError, match="chunk"):
            port_stream(3, cell, chunk=0)
        with pytest.raises(ValueError, match="int32"):
            port_stream(3, cell, slots=2**31)
        res = port_stream(3, cell, slots=10)
        with pytest.raises(ValueError, match="lies on"):
            teng.serve_stream(3, cell, state=res.state, slots=5, device="meta")

    def test_default_device_is_the_card(self, monkeypatch):
        _, cell = cells(slots=10)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            teng.serve_stream(0, cell)

    def test_diurnal_stream_matches_the_reference(self):
        jcell, cell = cells(comm="dt", x=3.0)
        kw = dict(chunk=100, warmup=50, diurnal_amp=0.8, diurnal_period=128)
        res = teng.serve_stream(5, cell, device="cpu", **kw)
        ref = jeng.serve_stream(5, jcell, **kw)
        assert (res.offered, res.completed, res.messages, res.count, res.max_jct) == (
            ref.offered, ref.completed, ref.messages, ref.count, ref.max_jct)
        np.testing.assert_array_equal(res.hist, ref.hist)
        assert_carry_equals_reference(res.state.carry, ref.state.carry)


class TestFusedStream:
    def test_matches_the_reference_pallas_stream(self):
        """The fused backend's CPU path (its kernel's plain version) against
        the reference's pallas stream, its kernel run interpreted."""
        jcell, cell = cells(**FUSED_KNOBS)
        ref = ref_stream(3, jcell, chunk=64, warmup=40)
        tops.reset_launch_counts()
        res = port_stream(3, cell, chunk=64, warmup=40)
        assert tops.launch_counts()["serve_slots"] == 0  # the CPU runs no kernel
        assert_carry_equals_reference(res.state.carry, ref.state.carry)
        for name in ("completed", "messages", "dropped", "count", "max_jct"):
            assert getattr(res, name) == getattr(ref, name), name
        dense = port_stream(3, dataclasses.replace(cell, route_backend="dense"),
                            chunk=64, warmup=40)
        assert_same_carry(res.state.carry, dense.state.carry)

    @pytest.mark.parametrize("knobs", [
        dict(policy="sqd"),
        dict(policy="rr", deterministic_ties=True),
        dict(deterministic_ties=False),
        dict(deterministic_ties=True, network="net", net_delay=2),
        dict(deterministic_ties=True, fault="crash", crash_rate=0.1, recover_rate=0.1),
    ])
    def test_refuses_what_the_pallas_stream_refuses(self, knobs):
        jcell = jeng.ServeConfig(**{**BASE, "route_backend": "pallas", **knobs})
        cell = teng.ServeConfig(**{**BASE, "route_backend": "fused", **knobs})
        with pytest.raises(Exception) as want:
            jeng.serve_stream(3, jcell, chunk=64)
        with pytest.raises(type(want.value)):
            teng.serve_stream(3, cell, chunk=64, device="cpu")


class TestExample:
    def test_cpu_soak(self, capsys):
        out = example.main(["--device", "cpu", "--slots", "2000", "--chunk", "512"])
        res = out["result"]
        assert res.slots == 2000 and res.count > 0
        assert res.offered == res.completed + res.dropped + int(res.final_occupancy.sum())
        assert 0 < out["summary"]["p50"] <= out["summary"]["p99"] <= out["summary"]["max"]
        assert "steady-state JCT" in capsys.readouterr().out
