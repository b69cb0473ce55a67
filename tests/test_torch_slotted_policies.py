"""The slotted simulator's policies and workloads against the JAX package.

SQ(d) and random routing, the pull policies JIQ / hsq with their token
pool, MMPP and diurnal arrivals, Pareto and Weibull sizes, heterogeneous
service rates (rate-aware or not) and arrival classes with affinity masks.

The bridge extends ``tests/test_torch_slotted_sim.py``'s: it runs the
reference's own workload draw (``slotted_sim._prep``) and exports, from
each slot key, the draws the reference's policies consume: the Gumbels of
random ties (``gumbel(key, (K,))``), SQ(d)'s subset and its Gumbels
(``split(key)``, then ``permutation(key_perm, K)[:d]`` and
``gumbel(key_tie, (d,))``), the random policy's ``randint(key, (), 0,
n_eligible)`` (under the control plane, whose suspect mask sets the eligible
count each slot, the two 32-bit words ``bits`` of ``split(key)`` that
``randint`` draws), the class stream (``_prep``'s fifth output), and the control
plane's uniforms from its per-slot net and fault keys (``_prep``'s later
outputs): ``uniform`` of ``split(nkey)`` (drop, jitter) under
fire-and-forget or of ``split(nkey, 3)`` (drop, jitter, the ``(4, K)`` ack
and keepalive draws) under ack, and ``uniform(fkey, (K,))``.  The port's
core (``run_draws``) consumes them, so both simulators see identical
inputs.  Every ``SimResult`` field is an integer, an integer array or a
ratio of two integers computed the same way: the tolerance is zero.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.care import metrics as jmetrics
from repro.core.care import slotted_sim as jsim
from repro_torch.core.care import metrics as tmetrics
from repro_torch.core.care import slotted_sim as tsim

K = 12
FIELDS = [
    "arrivals", "departures", "messages", "max_aq", "max_queue", "overflow",
    "msgs_per_departure", "queue_gap_sup", "dropped", "net_drops", "retrans",
    "token_misses", "token_sum",
]
HALF_A = tuple([True] * 8 + [False] * 4)
HALF_B = tuple([False] * 4 + [True] * 8)
TWO_CLASSES = dict(class_mix=(0.5, 0.5), class_affinity=(HALF_A, HALF_B))
RATES = tuple([1.5] * 6 + [0.5] * 6)
# tests/test_care_sim.py's TestConstrainedRouting fleet of 10.
GROUP_A = tuple([True] * 5 + [False] * 5)
GROUP_B = tuple([False] * 5 + [True] * 5)


def _cell(**kw):
    base = dict(servers=K, slots=500, load=0.9, mean_service=12, x=3,
                rt_rate=0.05, policy="jsaq", comm="et", approx="msr",
                buffer_cap=64)
    base.update(kw)
    return base


# name -> SimConfig fields: every new static kind, and every policy under
# a two-class affinity mask.
CELLS = {
    "sq2": _cell(policy="sq2", comm="none"),
    "sqd3_dt": _cell(policy="sqd", sqd=3, comm="dt"),
    "sqd_wider_than_fleet": _cell(policy="sqd", sqd=40, comm="none", slots=200),
    "random": _cell(policy="random", comm="none"),
    "jiq": _cell(policy="jiq", comm="jiq", load=0.8),
    "hsq": _cell(policy="hsq", comm="hsq"),
    "hsq_lowest_index_ties": _cell(policy="hsq", comm="hsq", x=2,
                                   deterministic_ties=True),
    "mmpp_jsaq_et": _cell(arrival="mmpp", burst_intensity=1.7),
    "mmpp_diurnal_sq2": _cell(policy="sq2", comm="none", arrival="mmpp",
                              load=0.5, burst_intensity=1.7, diurnal_amp=0.1,
                              diurnal_period=100),
    "diurnal_jsq": _cell(policy="jsq", comm="exact", diurnal_amp=0.1,
                         diurnal_period=64),
    "pareto_1.5": _cell(service="pareto", service_tail=1.5, load=0.95),
    "pareto_3_msr_x": _cell(service="pareto", service_tail=3.0, approx="msr_x",
                            comm="dt"),
    "weibull_0.5": _cell(service="weibull", service_tail=0.5),
    "rates_rate_aware": _cell(service_rates=RATES, load=0.95),
    "rates_not_rate_aware": _cell(service_rates=RATES, rate_aware=False,
                                  policy="jsq", comm="none"),
    "rates_sq2": _cell(service_rates=RATES, policy="sq2", comm="none"),
    "rates_jiq": _cell(service_rates=RATES, policy="jiq", comm="jiq"),
    "rates_lowest_index_ties_et_rt": _cell(service_rates=RATES, comm="et_rt",
                                           service="deterministic",
                                           deterministic_ties=True),
    "one_constrained_class": _cell(class_mix=(1.0,), class_affinity=(HALF_A,)),
    **{
        f"classes_{p}": _cell(policy=p, comm=c, sqd=3, **TWO_CLASSES)
        for p, c in (("jsq", "none"), ("jsaq", "et"), ("sq2", "none"),
                     ("sqd", "none"), ("rr", "none"), ("random", "none"),
                     ("jiq", "jiq"), ("hsq", "hsq"))
    },
    "classes_mmpp_rates_random": _cell(policy="random", comm="none",
                                       arrival="mmpp", service_rates=RATES,
                                       class_mix=(0.2, 0.3, 0.5),
                                       class_affinity=(HALF_A, HALF_B,
                                                       tuple([True] * K))),
    # tests/test_care_sim.py:171-215, at 500 slots.
    "care_sim_single_class_affinity": _cell(
        servers=10, load=0.8, class_mix=(1.0,), class_affinity=(GROUP_A,)),
    "care_sim_two_class_split": _cell(
        servers=10, load=0.8, class_mix=(0.5, 0.5),
        class_affinity=(GROUP_A, GROUP_B)),
    "care_sim_all_true_single_class": _cell(
        servers=10, class_mix=(1.0,), class_affinity=(tuple([True] * 10),)),
    "care_sim_affinity_with_pull": _cell(
        servers=10, load=0.7, policy="jiq", comm="jiq", class_mix=(0.5, 0.5),
        class_affinity=(GROUP_A, GROUP_B)),
}


@functools.partial(jax.jit, static_argnums=(1,))
def _slot_gumbels(slot_keys, k):
    return jax.vmap(lambda key: jax.random.gumbel(key, (k,)))(slot_keys)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _slot_subsets(slot_keys, k, d):
    def one(key):
        key_perm, key_tie = jax.random.split(key)
        sample = jax.random.permutation(key_perm, k)[:d]
        return sample, jax.random.gumbel(key_tie, (sample.shape[0],))

    return jax.vmap(one)(slot_keys)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _slot_net_uniforms(net_keys, k, ack):
    def one(key):
        if ack:
            kd, kj, ka = jax.random.split(key, 3)
            return (jax.random.uniform(kd, (k,), jnp.float32),
                    jax.random.uniform(kj, (k,), jnp.float32),
                    jax.random.uniform(ka, (4, k), jnp.float32))
        kd, kj = jax.random.split(key)
        return (jax.random.uniform(kd, (k,), jnp.float32),
                jax.random.uniform(kj, (k,), jnp.float32))

    return jax.vmap(one)(net_keys)


@functools.partial(jax.jit, static_argnums=(1,))
def _slot_fault_uniforms(fault_keys, k):
    return jax.vmap(lambda key: jax.random.uniform(key, (k,), jnp.float32))(fault_keys)


@jax.jit
def _slot_rand_bits(slot_keys):
    # The two 32-bit words randint(key, ...) draws: bits of split(key).
    def one(key):
        k1, k2 = jax.random.split(key)
        return jnp.stack([jax.random.bits(k1, (), jnp.uint32),
                          jax.random.bits(k2, (), jnp.uint32)])

    return jax.vmap(one)(slot_keys)


@jax.jit
def _slot_randints(slot_keys, n_eligible):
    return jax.vmap(
        lambda key, n: jax.random.randint(key, (), 0, n, jnp.int32)
    )(slot_keys, n_eligible)


def _bridge(seed, jcfg):
    """The reference's draws for one (seed, cell): ``(arrive, sizes,
    draws)`` as torch tensors with a leading run axis of 1, ``draws`` the
    keyword draws of ``run_draws``."""
    static, scn = jcfg.static_part(), jcfg.scenario()
    prep = jsim._prep(jax.random.key(seed), static, scn)
    arrive, sizes, slot_keys = prep[:3]
    rest = list(prep[4:])
    k, t = static.servers, static.slots
    draws = {}
    if static.classes > 1:
        draws["classes"] = np.asarray(rest.pop(0))
    if static.network != "none":
        u = _slot_net_uniforms(rest.pop(0), k, static.transport == "ack")
        for name, v in zip(("net_drop_u", "net_jit_u", "ack_u"), u):
            draws[name] = np.asarray(v)
    if static.fault != "none":
        draws["fault_u"] = np.asarray(_slot_fault_uniforms(rest.pop(0), k))
    if static.policy in ("jsq", "jsaq", "jiq", "hsq") and not static.deterministic_ties:
        draws["gumbel"] = np.asarray(_slot_gumbels(slot_keys, k))
    if static.policy in ("sq2", "sqd"):
        d = 2 if static.policy == "sq2" else static.sqd
        subset, gum = _slot_subsets(slot_keys, k, d)
        draws["subset"] = np.asarray(subset).astype(np.int32)
        draws["subset_gumbel"] = np.asarray(gum)
    if static.policy == "random" and (static.network != "none" or static.fault != "none"):
        draws["rand_bits"] = np.asarray(_slot_rand_bits(slot_keys)).astype(np.int64)
    elif static.policy == "random":
        aff = np.asarray(scn.class_affinity)
        if static.classes > 1:
            n_elig = aff.sum(-1)[draws["classes"]]
        elif static.constrained:
            n_elig = np.full((t,), aff[0].sum())
        else:
            n_elig = np.full((t,), k)
        draws["rand_pick"] = np.asarray(
            _slot_randints(slot_keys, jnp.asarray(n_elig, jnp.int32))
        )
    as_t = lambda a: torch.from_numpy(np.array(a))[None]  # noqa: E731
    return as_t(arrive), as_t(sizes), {n: as_t(v) for n, v in draws.items()}


def _port_on_bridge(seed, kw, **over):
    jcfg = jsim.SimConfig(**kw)
    tcfg = tsim.SimConfig(**{**kw, **over})
    arrive, sizes, draws = _bridge(seed, jcfg)
    raw = tsim.run_draws(arrive, sizes, tcfg.static_part(), tcfg.scenario(), **draws)
    return tsim.results(arrive, raw)[0], raw


def _assert_same(rt, rj, control_plane=False):
    for f in FIELDS:
        assert getattr(rt, f) == getattr(rj, f), f
    np.testing.assert_array_equal(rt.per_server_arrivals, rj.per_server_arrivals)
    np.testing.assert_array_equal(rt.final_q, rj.final_q)
    np.testing.assert_array_equal(rt.jct, rj.jct)
    if not control_plane:
        assert rj.net_drops == 0 and rj.retrans == 0


@pytest.mark.parametrize("name", list(CELLS))
def test_dense_matches_the_reference(name):
    kw = CELLS[name]
    rj = jsim.simulate(jax.random.key(7), jsim.SimConfig(**kw))
    rt, raw = _port_on_bridge(7, kw)
    _assert_same(rt, rj)
    assert rj.jct.size > 0
    cfg = tsim.SimConfig(**kw)
    static = cfg.static_part()
    routed = raw["routed"][0].numpy()
    if (static.classes > 1 or static.constrained) and static.policy not in ("sq2", "sqd"):
        # No arrival leaves its class's affinity (SQ(d) may: a subset with
        # no eligible server falls back to the whole subset).
        aff = np.asarray(cfg.scenario().class_affinity)
        _, _, draws = _bridge(7, jsim.SimConfig(**kw))
        cls = draws["classes"][0].numpy() if "classes" in draws else np.zeros_like(routed)
        ok = routed < 0
        ok |= aff[cls, np.maximum(routed, 0)]
        assert ok.all()
    if static.policy in ("jiq", "hsq"):
        assert 0 <= rt.token_misses <= rt.arrivals + rt.dropped
        assert rt.token_sum > 0


def test_fused_runs_mmpp_and_diurnal_arrivals_as_the_reference_pallas_does():
    # The reference's pallas backend takes arrivals as an input, so it runs
    # MMPP and diurnal cells; the port's fused backend follows it.
    kw = _cell(arrival="mmpp", burst_intensity=1.7, diurnal_amp=0.02,
               diurnal_period=50, service="deterministic", mean_service=8,
               deterministic_ties=True, comm="dt", load=0.55)
    rj = jsim.simulate(jax.random.key(11), jsim.SimConfig(**kw, route_backend="pallas"))
    rt, raw_f = _port_on_bridge(11, kw, route_backend="fused")
    for f in FIELDS:
        assert getattr(rt, f) == getattr(rj, f), f
    np.testing.assert_array_equal(rt.final_q, rj.final_q)
    _, raw_d = _port_on_bridge(11, kw)
    np.testing.assert_array_equal(raw_f["routed"], raw_d["routed"])


def test_batched_classes_and_rates_match_the_reference_grid():
    # Several cells (mixes, affinities, rates) and seeds in one run axis.
    cells = [
        _cell(policy="random", comm="none", service_rates=RATES, **TWO_CLASSES),
        _cell(policy="random", comm="none", service_rates=tuple(reversed(RATES)),
              class_mix=(0.9, 0.1), class_affinity=(HALF_B, HALF_A)),
    ]
    seeds = [3, 5]
    jstatic = jsim.SimConfig(**cells[0]).static_part()
    jgrid = jsim.simulate_grid(
        seeds, jstatic, [jsim.SimConfig(**c).scenario() for c in cells], shard=False
    )
    bridged = [_bridge(s, jsim.SimConfig(**c)) for c in cells for s in seeds]
    arrive = torch.cat([b[0] for b in bridged])
    sizes = torch.cat([b[1] for b in bridged])
    draws = {n: torch.cat([b[2][n] for b in bridged]) for n in bridged[0][2]}
    runs = [tsim.SimConfig(**c).scenario() for c in cells for _ in seeds]
    raw = tsim.run_draws(arrive, sizes, tsim.SimConfig(**cells[0]).static_part(),
                         runs, **draws)
    got = tsim.results(arrive, raw)
    for c in range(2):
        for s in range(2):
            _assert_same(got[c * 2 + s], jgrid[c][s])


NEW_KINDS = {
    "sq2": dict(policy="sq2", comm="none"),
    "sqd": dict(policy="sqd", sqd=3, comm="none"),
    "random": dict(policy="random", comm="none"),
    "jiq": dict(policy="jiq", comm="jiq"),
    "hsq": dict(policy="hsq", comm="hsq"),
    "pareto": dict(service="pareto", service_tail=1.5),
    "weibull": dict(service="weibull", service_tail=0.5),
    "rates": dict(service_rates=RATES),
    "classes": TWO_CLASSES,
    "one_constrained_class": dict(class_mix=(1.0,), class_affinity=(HALF_A,)),
}


@pytest.mark.parametrize("name", list(NEW_KINDS))
def test_fused_refuses_what_the_reference_pallas_refuses(name):
    kw = {**_cell(service="deterministic", mean_service=8, slots=50,
                  deterministic_ties=True, comm="dt"), **NEW_KINDS[name]}
    with pytest.raises((ValueError, NotImplementedError)) as ref:
        jsim.simulate(jax.random.key(0), jsim.SimConfig(**kw, route_backend="pallas"))
    with pytest.raises(ref.type, match="route_backend='fused'"):
        tsim.simulate(0, tsim.SimConfig(**kw, route_backend="fused"), device="cpu")


@pytest.mark.parametrize("bad", [
    dict(network="net", net_delay=3, net_drop=0.2),
    dict(fault="crash", crash_rate=0.01, recover_rate=0.1, suspect_age=10),
    dict(fault="slow", crash_rate=0.01, recover_rate=0.1, slow_factor=0.5),
    dict(network="net", net_delay=2, policy="sq2", comm="none"),
    dict(fault="crash", crash_rate=0.01, recover_rate=0.1, suspect_age=8,
         policy="jiq", comm="jiq"),
    dict(network="net", net_delay=2, net_drop=0.2, suspect_age=3, policy="random",
         comm="rt"),
    dict(fault="crash", crash_rate=0.02, recover_rate=0.1, suspect_age=6,
         policy="random", comm="rt", **TWO_CLASSES),
])
def test_the_control_plane_still_names_item_9(bad):
    # The control plane's kinds with the policies of this file, every
    # SimResult field against the reference on its draws.
    kw = _cell(**bad)
    rj = jsim.simulate(jax.random.key(7), jsim.SimConfig(**kw))
    rt, _ = _port_on_bridge(7, kw)
    _assert_same(rt, rj, control_plane=True)
    assert rt.arrivals == rt.departures + int(rt.final_q.sum())


@pytest.mark.parametrize("bad,match", [
    (dict(policy="jiq", comm="et"), "requires comm='jiq'"),
    (dict(policy="hsq", comm="exact"), "comm='exact'"),
    (dict(policy="jsaq", comm="hsq"), "token channel"),
    (dict(policy="hsq", comm="hsq", rt_rate=-0.5), "token_refresh"),
    (dict(load=0.95, diurnal_amp=0.5), "peak"),
    (dict(load=0.3, diurnal_amp=1.5), "amp"),
    (dict(arrival="mmpp", load=0.6, burst_intensity=1.6, diurnal_amp=0.5), "mmpp"),
    (dict(class_affinity=(HALF_A,)), "requires class_mix"),
    (dict(class_mix=(0.5, 0.5), class_affinity=(HALF_A, tuple([False] * K))),
     "no eligible server"),
    (dict(class_mix=(0.5, 0.5), class_affinity=(HALF_A,)), "shape"),
    (dict(class_mix=(0.5, -0.5)), "positive sum"),
    (dict(service="pareto", service_tail=1.0), "tail"),
    (dict(service="weibull", service_tail=0.0), "shape"),
])
def test_invalid_cells_raise_as_the_reference_does(bad, match):
    kw = _cell(slots=20, **bad)
    with pytest.raises(ValueError, match=match):
        jsim.simulate(jax.random.key(0), jsim.SimConfig(**kw))
    with pytest.raises(ValueError, match=match):
        tsim.simulate(0, tsim.SimConfig(**kw), device="cpu")


def test_diurnal_peak_is_checked_where_a_cell_meets_an_mmpp_grid():
    # A cell built without the arrival kind meets its mmpp StaticConfig.
    jscn = jsim.Scenario.create(servers=30, load=0.6, burst_intensity=1.6,
                                diurnal_amp=0.5)
    tscn = tsim.Scenario.create(servers=30, load=0.6, burst_intensity=1.6,
                                diurnal_amp=0.5)
    with pytest.raises(ValueError, match="peak"):
        jsim.simulate_grid([0], jsim.SimConfig(arrival="mmpp", load=0.6).static_part(),
                           [jscn])
    with pytest.raises(ValueError, match="peak"):
        tsim.simulate_grid([0], tsim.SimConfig(arrival="mmpp", load=0.6).static_part(),
                           [tscn], device="cpu")


def test_port_entry_points_run_every_new_kind():
    # simulate / simulate_grid on the port's own draws: a run per kind,
    # conservation, Prop 6.8 under ET and the affinity kept.
    for name, kw in NEW_KINDS.items():
        cfg = tsim.SimConfig(**_cell(slots=300, arrival="mmpp", burst_intensity=1.5,
                                     diurnal_amp=0.05, diurnal_period=100,
                                     load=0.6, **kw))
        r0, r1 = tsim.simulate_batch([1, 2], cfg, device="cpu")
        for r in (r0, r1):
            assert r.arrivals == r.departures + int(r.final_q.sum()), name
            if cfg.comm == "et":
                assert r.max_aq <= cfg.x - 1, name
        if cfg.class_affinity is not None and len(cfg.class_affinity) == 1:
            assert int(r0.per_server_arrivals[~np.array(HALF_A)].sum()) == 0
        assert tsim.simulate(2, cfg, device="cpu").jct.tolist() == r1.jct.tolist()


def test_metrics_match_the_reference():
    kw = CELLS["jiq"]
    rj = jsim.simulate(jax.random.key(7), jsim.SimConfig(**kw))
    rt, _ = _port_on_bridge(7, kw)
    for args in ((rt.token_sum, rt.token_misses, 500, rt.arrivals), (0, 0, 0, 0),
                 (5, 0, 10, 0), (0, 3, 0, 4)):
        assert tmetrics.token_summary(*args) == jmetrics.token_summary(*args)
    other, _ = _port_on_bridge(7, CELLS["random"])
    for a, b in ((rt.jct, other.jct), (other.jct, rt.jct), (rt.jct, np.array([]))):
        assert tmetrics.ccdf_dominates(a, b) == jmetrics.ccdf_dominates(a, b)
    for policy in ("sqd", "random", "jiq"):
        assert tmetrics.relative_communication(rt, policy, sqd=3) == (
            jmetrics.relative_communication(rj, policy, sqd=3)
        )
