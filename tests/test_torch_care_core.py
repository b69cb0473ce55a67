"""The port's CARE protocol core against the JAX package, on the same inputs.

Inputs are made with numpy from a seed (or, for the samplers, drawn by
JAX's own key so that both sides see the reference's uniforms) and passed
to both packages as arrays.  Every output compared here is an integer, a
bool mask, or an index chosen by comparisons of the same float32 values,
so the tolerance is zero: arrays must be equal.  The one exception is
the Gumbel transform itself (two float32 logarithms, whose library
implementations may differ by an ulp), held to 2e-6; the tie-breaks
built on Gumbels are compared exactly, on the reference's own values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.care import approx as japprox
from repro.core.care import comm as jcomm
from repro.core.care import slotted_sim as jsim
from repro.serve import engine as jserve
from repro.core.care import routing as jrouting
from repro.core.care import workload as jworkload
from repro_torch.core.care import approx as tapprox
from repro_torch.core.care import comm as tcomm
from repro_torch.core.care import routing as troute
from repro_torch.core.care import slotted_sim as tsim
from repro_torch.core.care import workload as tworkload
from repro_torch.serve import engine as serve_engine
from test_torch_slotted_policies import _assert_same, _port_on_bridge

PUSH_KINDS = ["rt", "dt", "et", "et_rt", "exact", "none"]
K = 16
STEPS = 60


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(torch_value, jax_value):
    np.testing.assert_array_equal(torch_value.numpy(), np.asarray(jax_value))


class TestCommEvaluate:
    @pytest.mark.parametrize("hooks", [False, True])
    @pytest.mark.parametrize("kind", PUSH_KINDS)
    def test_masks_and_counts(self, kind, hooks):
        rng = np.random.default_rng(11)
        errs = rng.integers(0, 5, size=(STEPS, K), dtype=np.int32)
        deps = rng.integers(0, 3, size=(STEPS, K), dtype=np.int32) * (
            rng.random((STEPS, K)) < 0.4
        )
        deps = deps.astype(np.int32)
        can = rng.random((STEPS, K)) < 0.8
        force = rng.random((STEPS, K)) < 0.05
        jcfg = jcomm.CommConfig(kind=kind, x=jnp.int32(3), rt_period=jnp.int32(7))
        tcfg = tcomm.CommConfig(kind=kind, x=3, rt_period=7)
        js = jcomm.CommState.init(K)
        ts = tcomm.CommState.init(K)
        for t in range(STEPS):
            kw_j = kw_t = {}
            if hooks:
                kw_j = dict(can_send=jnp.asarray(can[t]), force=jnp.asarray(force[t]))
                kw_t = dict(can_send=_t(can[t]), force=_t(force[t]))
            count = t % 5 != 0
            jtrig, js = jcomm.evaluate(
                js, jcfg, jnp.asarray(errs[t]), jnp.asarray(deps[t]),
                count_msgs=count, **kw_j,
            )
            ttrig, ts = tcomm.evaluate(
                ts, tcfg, _t(errs[t]), _t(deps[t]), count_msgs=count, **kw_t
            )
            _eq(ttrig, jtrig)
            _eq(ts.deps_since_msg, js.deps_since_msg)
            _eq(ts.slots_since_msg, js.slots_since_msg)
            _eq(ts.msgs, js.msgs)
        if kind != "none":
            assert int(ts.msgs) > 0

    def test_batched_thresholds(self):
        # One threshold per batch row, as the simulator's run axis has it.
        rng = np.random.default_rng(2)
        errs = rng.integers(0, 6, size=(3, K), dtype=np.int32)
        x = np.array([[2], [3], [5]], np.int32)
        cfg = tcomm.CommConfig(kind="et", x=_t(x), rt_period=4)
        trig, state = tcomm.evaluate(
            tcomm.CommState.init(K, (3,)), cfg, _t(errs),
            torch.zeros((3, K), dtype=torch.int32),
        )
        for row in range(3):
            jtrig, jstate = jcomm.evaluate(
                jcomm.CommState.init(K),
                jcomm.CommConfig(kind="et", x=jnp.int32(x[row, 0]), rt_period=4),
                jnp.asarray(errs[row]), jnp.zeros((K,), jnp.int32),
            )
            _eq(trig[row], jtrig)
            _eq(state.msgs[row], jstate.msgs)

    def test_pull_kinds_name_their_slice(self):
        # The serving tier's pull kinds: the token pool's counters and every
        # result against the reference's serve_one.
        kw = dict(policy="jiq", comm="jiq", slots=300, replicas=6, decode_slots=4,
                  load=0.9, mean_prefill=2, mean_decode=12, queue_cap=128)
        ref = jserve.serve_one(4, jserve.ServeConfig(**kw))
        got = serve_engine.serve_one(4, serve_engine.ServeConfig(**kw), device="cpu")
        assert (got.token_misses, got.token_sum, got.messages) == (
            ref.token_misses, ref.token_sum, ref.messages)
        np.testing.assert_array_equal(got.jct_by_rid, ref.jct_by_rid)
        assert got.token_sum > 0


class TestApprox:
    @pytest.mark.parametrize("kind", ["basic", "msr", "msr_x"])
    def test_emulation_steps(self, kind):
        rng = np.random.default_rng(5)
        jcfg = japprox.ApproxConfig(kind=kind, msr_slots=jnp.int32(4), x=jnp.int32(3))
        tcfg = tapprox.ApproxConfig(kind=kind, msr_slots=4, x=3)
        q0 = rng.integers(0, 4, size=K, dtype=np.int32)
        js = japprox.EmuState.init(jnp.asarray(q0), jcfg)
        ts = tapprox.EmuState.init(_t(q0), tcfg)
        for t in range(STEPS):
            sel = np.zeros(K, bool)
            if rng.random() < 0.8:
                sel[rng.integers(K)] = True
            active = bool(rng.random() < 0.9)
            q_true = rng.integers(0, 6, size=K, dtype=np.int32)
            trig = rng.random(K) < 0.1
            js = japprox.emu_arrival_masked(js, jnp.asarray(sel), jcfg)
            ts = tapprox.emu_arrival_masked(ts, _t(sel), tcfg)
            js = japprox.emu_drain_slot(js, jcfg, active=jnp.asarray(active))
            ts = tapprox.emu_drain_slot(ts, tcfg, active=torch.tensor(active))
            _eq(tapprox.approximation_error(ts, _t(q_true)),
                japprox.approximation_error(js, jnp.asarray(q_true)))
            js = japprox.emu_message_reset(js, jnp.asarray(q_true), jnp.asarray(trig), jcfg)
            ts = tapprox.emu_message_reset(ts, _t(q_true), _t(trig), tcfg)
            for field in ("q_app", "head_rem", "emu_deps"):
                _eq(getattr(ts, field), getattr(js, field))

    def test_single_arrival(self):
        jcfg = japprox.ApproxConfig(kind="msr", msr_slots=5)
        tcfg = tapprox.ApproxConfig(kind="msr", msr_slots=5)
        q0 = np.array([0, 2, 0, 1], np.int32)
        js = japprox.emu_arrival(japprox.EmuState.init(jnp.asarray(q0), jcfg), 2, jcfg)
        ts = tapprox.emu_arrival(tapprox.EmuState.init(_t(q0), tcfg), 2, tcfg)
        _eq(ts.q_app, js.q_app)
        _eq(ts.head_rem, js.head_rem)


class TestRouting:
    @pytest.mark.parametrize("deterministic", [True, False])
    @pytest.mark.parametrize("policy", ["jsq", "jsaq", "rr"])
    def test_route(self, policy, deterministic):
        rng = np.random.default_rng(17)
        rr = np.int32(0)
        trr = torch.tensor(0, dtype=torch.int32)
        for t in range(40):
            # Small values so that ties are common.
            q_true = rng.integers(0, 3, size=K, dtype=np.int32)
            q_app = rng.integers(0, 3, size=K, dtype=np.int32)
            key = jax.random.key(int(rng.integers(1 << 30)))
            g = np.asarray(jax.random.gumbel(key, (K,)))
            js, rr = jrouting.route(
                policy, jnp.asarray(q_true), jnp.asarray(q_app), jnp.asarray(rr),
                key, deterministic=deterministic,
            )
            ts, trr = troute.route(
                policy, _t(q_true), _t(q_app), trr, _t(g),
                deterministic=deterministic,
            )
            assert int(ts) == int(js)
            assert int(trr) == int(rr)

    @pytest.mark.parametrize("policy", ["jsaq", "rr"])
    def test_masked(self, policy):
        rng = np.random.default_rng(3)
        rr = jnp.int32(5)
        trr = torch.tensor(5, dtype=torch.int32)
        for _ in range(20):
            q = rng.integers(0, 3, size=K, dtype=np.int32)
            mask = rng.random(K) < 0.3
            key = jax.random.key(int(rng.integers(1 << 30)))
            js, rr = jrouting.route(
                policy, jnp.asarray(q), jnp.asarray(q), rr, key,
                deterministic=True, mask=jnp.asarray(mask),
            )
            ts, trr = troute.route(
                policy, _t(q), _t(q), trr, deterministic=True, mask=_t(mask)
            )
            assert int(ts) == int(js)
            assert int(trr) == int(rr)

    def test_later_policies_name_their_slice(self):
        # SQ(2) under a network routes on queues net_delay slots stale and
        # bills its queries on the wire, as the reference does.
        kw = dict(servers=K, slots=400, load=0.9, mean_service=8, policy="sq2",
                  comm="none", network="net", net_delay=3, buffer_cap=64)
        rj = jsim.simulate(jax.random.key(5), jsim.SimConfig(**kw))
        rt, _ = _port_on_bridge(5, kw)
        _assert_same(rt, rj, control_plane=True)
        assert rt.messages >= 4 * rt.arrivals


class TestWorkload:
    @pytest.mark.parametrize("kind,mean", [
        ("geometric", 8), ("geometric", 30), ("deterministic", 8),
        ("deterministic", 2.5),
    ])
    def test_service_sizes_from_the_same_uniforms(self, kind, mean):
        # service_sizes draws uniform(key, (n,), f32, 1e-7, 1-1e-7); the
        # port is fed those very uniforms.
        key = jax.random.key(int(np.random.default_rng(int(mean * 10)).integers(1 << 30)))
        n = 4096
        jsp = jworkload.ServiceProcess.create(kind, mean)
        tsp = tworkload.ServiceProcess.create(kind, mean)
        assert np.float32(jsp.geo_log1p) == tsp.geo_log1p
        assert int(jsp.msr_slots) == int(tsp.msr_slots)
        u = jax.random.uniform(
            key, (n,), jnp.float32, tworkload.SIZE_U_MIN, tworkload.SIZE_U_MAX
        )
        ref = jworkload.service_sizes(key, n, jsp)
        got = tworkload.service_sizes(
            _t(u), kind, torch.tensor(tsp.mean), torch.tensor(tsp.geo_log1p)
        )
        _eq(got, ref)

    @pytest.mark.parametrize("load", [0.3, 0.9, 0.95])
    def test_bernoulli_from_the_same_uniforms(self, load):
        key = jax.random.key(int(load * 100))
        u = jax.random.uniform(key, (5000,), jnp.float32)
        ref = jworkload.bernoulli_arrivals(key, 5000, jnp.float32(load))
        got = tworkload.bernoulli_arrivals(_t(u), torch.tensor(np.float32(load)))
        _eq(got, ref)

    @pytest.mark.parametrize("rates", [
        (1.0, 2.0, 0.5, 0.25), (1.5, 4 / 3, 0.75, 0.3), (0.1, 0.7, 2.5, 3.0),
    ])
    def test_service_units_match(self, rates):
        # The credit schedule is float32 arithmetic on both sides; the
        # port takes the slot index as a float32 tensor.
        r = np.asarray(rates, np.float32)
        slots = np.arange(5000, dtype=np.float32)
        got = tworkload.service_units(_t(slots)[:, None], _t(r)[None, :])
        ref = jworkload.service_units(jnp.asarray(slots)[:, None], jnp.asarray(r)[None, :])
        _eq(got, ref)
        _eq(got, jworkload.service_units(slots[:, None], r[None, :], xp=np))
        np.testing.assert_allclose(got.numpy().mean(0), r, atol=1e-3)

    def test_gumbel_from_the_same_uniforms(self):
        # Float results of log: equal up to one ulp per log, so this one
        # is held to a float32 tolerance; the argmax decisions built on
        # Gumbels are compared exactly above, on the reference's values.
        key = jax.random.key(4)
        tiny = float(np.finfo(np.float32).tiny)
        u = jax.random.uniform(key, (2000,), jnp.float32, tiny, 1.0)
        ref = jax.random.gumbel(key, (2000,))
        got = tworkload.gumbel(_t(u))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6, atol=2e-6)

    def test_generator_samplers(self):
        gen = torch.Generator().manual_seed(0)
        u = tworkload.uniforms(gen, (200_000,), minval=1e-7, maxval=1 - 1e-7)
        assert float(u.min()) >= 1e-7 and float(u.max()) < 1.0
        sp = tworkload.ServiceProcess.create("geometric", 30)
        sizes = tworkload.service_sizes(u, sp.kind, sp.mean, sp.geo_log1p)
        assert int(sizes.min()) >= 1
        assert abs(float(sizes.float().mean()) - 30.0) < 0.5
        arr = tworkload.bernoulli_arrivals(tworkload.uniforms(gen, (200_000,)), 0.9)
        assert abs(float(arr.float().mean()) - 0.9) < 0.005

    def test_heavy_tails_name_their_slice(self):
        # Pareto sizes on servers the fault process slows down, against the
        # reference on its draws.
        assert tworkload.ServiceProcess.create("pareto", 30).kind == "pareto"
        kw = dict(servers=K, slots=400, load=0.8, mean_service=8, service="pareto",
                  fault="slow", crash_rate=0.02, recover_rate=0.1, slow_factor=0.5,
                  buffer_cap=64)
        rj = jsim.simulate(jax.random.key(5), jsim.SimConfig(**kw))
        rt, _ = _port_on_bridge(5, kw)
        _assert_same(rt, rj, control_plane=True)
