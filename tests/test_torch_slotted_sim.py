"""The port's slotted simulator against the JAX package's, on the same draws.

The bridge runs the reference's own workload draw (``slotted_sim._prep``
on ``jax.random.key(seed)``) and exports the arrivals, the job sizes and,
for random ties, the per-slot Gumbels the reference draws from its slot
keys.  The port's core (``run_draws``) consumes those arrays, so the two
simulators see identical inputs.  Every ``SimResult`` field is an integer,
an integer array, or a ratio of two integers computed the same way, so the
tolerance is zero: fields must be equal.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.care import metrics as jmetrics
from repro.core.care import slotted_sim as jsim
from repro_torch.core.care import metrics as tmetrics
from repro_torch.core.care import slotted_sim as tsim
from repro_torch.core.care import theory as ttheory

POLICIES = ["jsq", "jsaq"]
KINDS = ["et", "dt", "rt", "et_rt", "exact", "none"]
FIELDS = [
    "arrivals", "departures", "messages", "max_aq", "max_queue", "overflow",
    "msgs_per_departure", "queue_gap_sup", "dropped",
]


def _cfg(policy, comm, **kw):
    base = dict(
        servers=12, slots=500, load=0.9, mean_service=8, x=3, rt_rate=0.05,
        policy=policy, comm=comm, approx="msr", service="deterministic",
        buffer_cap=64, deterministic_ties=True,
    )
    base.update(kw)
    return base


def _jax_cfg(**kw):
    return jsim.SimConfig(**kw)


def _torch_cfg(**kw):
    if kw.get("route_backend") == "pallas":
        kw = {**kw, "route_backend": "fused"}
    return tsim.SimConfig(**kw)


def _bridge(seed, jcfg):
    """The reference's draws for one (seed, cell), as torch tensors."""
    static, scn = jcfg.static_part(), jcfg.scenario()
    arrive, sizes, slot_keys, _active = jsim._prep(jax.random.key(seed), static, scn)[:4]
    gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (static.servers,)))(slot_keys)
    return (
        torch.from_numpy(np.array(arrive))[None],
        torch.from_numpy(np.array(sizes))[None],
        torch.from_numpy(np.array(gumbel))[None],
    )


def _port_on_bridge(seed, kw, **over):
    jcfg = _jax_cfg(**kw)
    tcfg = _torch_cfg(**{**kw, **over})
    arrive, sizes, gumbel = _bridge(seed, jcfg)
    static = tcfg.static_part()
    raw = tsim.run_draws(arrive, sizes, static, tcfg.scenario(), gumbel=gumbel)
    return tsim.results(arrive, raw)[0], raw


def _assert_same(rt, rj):
    for f in FIELDS:
        assert getattr(rt, f) == getattr(rj, f), f
    np.testing.assert_array_equal(rt.per_server_arrivals, rj.per_server_arrivals)
    np.testing.assert_array_equal(rt.final_q, rj.final_q)
    np.testing.assert_array_equal(rt.jct, rj.jct)
    # The reference's slice-2 counters stay zero in the kinds ported here.
    for f in ("net_drops", "retrans", "token_misses", "token_sum"):
        assert getattr(rj, f, 0) == 0, f


class TestDenseParity:
    @pytest.mark.parametrize("comm", KINDS)
    @pytest.mark.parametrize("policy", POLICIES)
    def test_matrix(self, policy, comm):
        # Deterministic ties: also the fused backend on the same draws
        # must agree with the reference's dense run.
        kw = _cfg(policy, comm)
        rj = jsim.simulate(jax.random.key(7), _jax_cfg(**kw))
        rt, raw = _port_on_bridge(7, kw)
        _assert_same(rt, rj)
        assert rj.jct.size > 0
        rf, raw_f = _port_on_bridge(7, kw, route_backend="fused")
        for f in FIELDS:
            assert getattr(rf, f) == getattr(rj, f), f
        np.testing.assert_array_equal(raw_f["routed"], raw["routed"])

    @pytest.mark.parametrize("kw", [
        dict(policy="jsaq", comm="et", approx="basic"),
        dict(policy="jsaq", comm="dt", approx="msr_x"),
        dict(policy="jsq", comm="et_rt", approx="msr"),
        dict(policy="jsaq", comm="exact", approx="msr_x", x=2),
        dict(policy="rr", comm="et", approx="basic"),
    ])
    def test_geometric_random_ties(self, kw):
        cell = _cfg(kw.pop("policy"), kw.pop("comm"), service="geometric",
                    deterministic_ties=False, mean_service=10, **kw)
        rj = jsim.simulate(jax.random.key(3), _jax_cfg(**cell))
        rt, _ = _port_on_bridge(3, cell)
        _assert_same(rt, rj)

    def test_overflow_and_padded_horizon(self):
        # A small FIFO drops arrivals; max_slots pads the loop past the
        # horizon, whose slots must be frozen.
        cell = _cfg("jsaq", "et", servers=4, buffer_cap=4, load=0.95,
                    service="geometric", mean_service=12, slots=300,
                    max_slots=400, deterministic_ties=False)
        rj = jsim.simulate(jax.random.key(5), _jax_cfg(**cell))
        rt, _ = _port_on_bridge(5, cell)
        _assert_same(rt, rj)
        assert rt.dropped > 0

    def test_batched_runs_match_the_reference_grid(self):
        # Several cells and seeds in one batched run axis, cell-major.
        cells = [_cfg("jsaq", "dt", x=x, slots=300) for x in (2, 4)]
        seeds = [3, 5]
        jstatic = _jax_cfg(**cells[0]).static_part()
        jgrid = jsim.simulate_grid(
            seeds, jstatic, [_jax_cfg(**c).scenario() for c in cells], shard=False
        )
        draws = [_bridge(s, _jax_cfg(**c)) for c in cells for s in seeds]
        arrive = torch.cat([d[0] for d in draws])
        sizes = torch.cat([d[1] for d in draws])
        runs = [_torch_cfg(**c).scenario() for c in cells for _ in seeds]
        raw = tsim.run_draws(arrive, sizes, _torch_cfg(**cells[0]).static_part(), runs)
        got = tsim.results(arrive, raw)
        for c in range(2):
            for s in range(2):
                _assert_same(got[c * 2 + s], jgrid[c][s])


class TestFusedParity:
    @pytest.mark.parametrize("policy,comm,servers", [
        ("jsaq", "dt", 12), ("jsq", "exact", 12), ("jsaq", "et_rt", 12),
        ("jsaq", "dt", 200),
    ])
    def test_vs_reference_pallas(self, policy, comm, servers):
        kw = _cfg(policy, comm, servers=servers, route_backend="pallas", slots=400)
        rj = jsim.simulate(jax.random.key(11), _jax_cfg(**kw))
        rt, _ = _port_on_bridge(11, kw)
        _assert_same(rt, rj)
        assert rt.jct.size == 0  # the fused kernel carries no FIFO ring

    @pytest.mark.parametrize("bad", [
        dict(policy="rr"),
        dict(approx="basic"),
        dict(service="geometric"),
        dict(deterministic_ties=False),
        dict(service_rates=tuple([1.0] * 11 + [2.0])),
    ])
    def test_refuses_what_the_reference_refuses(self, bad):
        kw = {**_cfg("jsaq", "dt", slots=50), **bad}
        with pytest.raises(ValueError, match="route_backend='pallas'"):
            jsim.simulate(jax.random.key(0), _jax_cfg(**kw, route_backend="pallas"))
        with pytest.raises(ValueError, match="route_backend='fused'"):
            tsim.simulate(0, _torch_cfg(**kw, route_backend="fused"), device="cpu")

    @pytest.mark.parametrize("bad", [dict(network="net"), dict(class_mix=(1.0, 1.0))])
    def test_refuses_control_plane_and_classes(self, bad):
        cfg = _torch_cfg(**_cfg("jsaq", "dt", slots=50), route_backend="fused", **bad)
        assert cfg.static_part().route_backend == "fused"
        with pytest.raises(NotImplementedError, match="route_backend='fused'"):
            tsim.simulate(0, cfg, device="cpu")


class TestPortEntryPoints:
    def test_grid_is_cell_major(self):
        cells = [tsim.SimConfig(**_cfg("jsaq", "et", x=x, slots=200,
                                       service="geometric",
                                       deterministic_ties=False))
                 for x in (2, 4)]
        grid = tsim.simulate_grid(
            [3, 5, 8], cells[0].static_part(), [c.scenario() for c in cells],
            device="cpu",
        )
        for c, cell in enumerate(cells):
            for s, seed in enumerate([3, 5, 8]):
                one = tsim.simulate(seed, cell, device="cpu")
                _assert_same(grid[c][s], one)
        assert grid[0][0].messages != grid[1][0].messages

    def test_fused_equals_dense_on_port_draws(self):
        cell = tsim.SimConfig(**_cfg("jsaq", "dt", servers=150, slots=400))
        dense = tsim.simulate_batch([1, 2], cell, device="cpu")
        fused = tsim.simulate_batch(
            [1, 2], dataclasses.replace(cell, route_backend="fused"), device="cpu"
        )
        for d, f in zip(dense, fused):
            for name in FIELDS:
                assert getattr(d, name) == getattr(f, name), name

    @pytest.mark.parametrize("comm,approx", [
        ("et", "msr"), ("et", "basic"), ("dt", "basic"), ("dt", "msr_x"),
    ])
    @pytest.mark.parametrize("x", [2, 3, 5])
    def test_theorem_2_3(self, comm, approx, x):
        cell = tsim.SimConfig(servers=10, slots=500, load=0.95, mean_service=10,
                              policy="jsaq", comm=comm, approx=approx, x=x)
        r = tsim.simulate(4, cell, device="cpu")
        assert r.max_aq <= ttheory.max_error_bound(x, comm, approx) == x - 1
        assert r.messages > 0

    def test_later_kinds_name_their_slice(self):
        # The degraded control plane on the port's own draws: its streams
        # come after every other, so a zero-operand cell replays the "none"
        # cell; each kind conserves jobs and its grid equals simulate.
        base = _cfg("jsaq", "et", slots=300, service="geometric",
                    deterministic_ties=False)
        plain = tsim.simulate(3, tsim.SimConfig(**base), device="cpu")
        for zero in (dict(network="net"), dict(fault="crash")):
            r = tsim.simulate(3, tsim.SimConfig(**{**base, **zero}), device="cpu")
            _assert_same(r, plain)
        # An instant lossless ack wire changes nothing but bills an ack a
        # message.
        r = tsim.simulate(3, tsim.SimConfig(**base, network="net", transport="ack",
                                            ack_timeout=1), device="cpu")
        assert r.messages == 2 * plain.messages
        _assert_same(dataclasses.replace(r, messages=plain.messages,
                                         msgs_per_departure=plain.msgs_per_departure),
                     plain)
        for kinds in (dict(network="net", net_delay=2, net_drop=0.2),
                      dict(fault="crash", crash_rate=0.02, recover_rate=0.2,
                           suspect_age=8),
                      dict(fault="slow", crash_rate=0.02, recover_rate=0.2,
                           slow_factor=0.5),
                      dict(network="net", net_delay=2, policy="sq2", comm="none"),
                      dict(network="net", net_delay=1, net_drop=0.3, transport="ack",
                           ack_timeout=3, backoff_base=2.0, max_retries=2)):
            cell = tsim.SimConfig(**{**base, **kinds})
            grid = tsim.simulate_grid([3, 4], cell.static_part(), [cell.scenario()],
                                      device="cpu")[0]
            for r in grid:
                assert r.arrivals == r.departures + int(r.final_q.sum())
            one = tsim.simulate(4, cell, device="cpu")
            for f in dataclasses.fields(tsim.SimResult):
                np.testing.assert_array_equal(getattr(grid[1], f.name),
                                              getattr(one, f.name), f.name)
            if cell.net_drop:
                assert one.net_drops > 0

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid here")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsim.simulate(0, tsim.SimConfig(**_cfg("jsaq", "et", slots=20)))

    def test_metrics_match_the_reference(self):
        kw = _cfg("jsq", "et", service="geometric", deterministic_ties=False)
        rj = jsim.simulate(jax.random.key(2), _jax_cfg(**kw))
        rt, _ = _port_on_bridge(2, kw)
        assert tmetrics.jct_summary(rt.jct) == jmetrics.jct_summary(rj.jct)
        assert tmetrics.mean_jct(rt.jct) == jmetrics.mean_jct(rj.jct)
        g_t, c_t = tmetrics.ccdf(rt.jct)
        g_j, c_j = jmetrics.ccdf(rj.jct)
        np.testing.assert_array_equal(g_t, g_j)
        np.testing.assert_array_equal(c_t, c_j)
        for policy in ("jsq", "jsaq", "sq2", "rr"):
            assert tmetrics.relative_communication(rt, policy) == (
                jmetrics.relative_communication(rj, policy)
            )
        assert tmetrics.jct_summary(np.array([]))["count"] == 0
