"""The degraded control plane on both simulators against the JAX package.

Slotted tier: every cell of ``tests/test_faults.py``'s ``_SLOTTED_CELLS``
plus its JIQ ack repair cell, on the reference's own draws (the bridge of
``tests/test_torch_slotted_policies.py`` exports the per-slot net, ack and
fault uniforms from its key streams), every ``SimResult`` field equal to
the reference's ``simulate_grid``.  Serving tier: every cell of its
``_MATRIX`` on the same ``ServeWorkload``, every ``ServeResult`` field
equal to the reference's ``serve_one`` and its numpy ``run_serving_sim``.
Both tiers: a zero-operand ``net`` cell equals the ``none`` cell bit for
bit, and under a suspect mask no arrival goes to a suspect server while a
healthy one is eligible.  Every field is an integer, an integer array or a
ratio of integers computed the same way: the tolerance is zero.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import test_faults as _faults
from repro.core.care import slotted_sim as jsim
from repro.serve import engine as jeng
from repro_torch.core.care import slotted_sim as tsim
from repro_torch.serve import engine as teng
from test_torch_slotted_policies import _bridge

SLOTTED_BASE = dict(servers=8, slots=3000, load=0.9, mean_service=10, comm="et", x=3)
JIQ_ACK = dict(servers=8, slots=4000, load=0.9, mean_service=10, policy="jiq",
               comm="jiq", network="net", net_delay=2, net_drop=0.25, transport="ack",
               ack_timeout=5, backoff_base=2.0, max_retries=6)
SLOTTED = {f"cell{i}": {**SLOTTED_BASE, **kw} for i, kw in enumerate(_faults._SLOTTED_CELLS)}
SLOTTED["jiq_ack_repair"] = JIQ_ACK
SERVE_BASE = dict(replicas=6, decode_slots=4, slots=400, load=0.9, queue_cap=256)


def _same_fields(got, want, cls, label=""):
    for f in dataclasses.fields(cls):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name),
                                      err_msg=f"{label} {f.name}")


def _port_run(seed, kw):
    arrive, sizes, draws = _bridge(seed, jsim.SimConfig(**kw))
    cfg = tsim.SimConfig(**kw)
    raw = tsim.run_draws(arrive, sizes, cfg.static_part(), cfg.scenario(), **draws)
    return tsim.results(arrive, raw)[0], raw


@pytest.mark.parametrize("name", list(SLOTTED))
def test_slotted_cell_matches_the_reference_grid(name):
    kw = SLOTTED[name]
    jcfg = jsim.SimConfig(**kw)
    rj = jsim.simulate_grid([13], jcfg.static_part(), [jcfg.scenario()], shard=False)[0][0]
    rt, raw = _port_run(13, kw)
    _same_fields(rt, rj, tsim.SimResult, name)
    assert rt.arrivals == rt.departures + int(rt.final_q.sum())
    if kw.get("net_drop"):
        assert rt.net_drops > 0
    if kw.get("transport") == "ack" and kw.get("net_drop"):
        assert rt.retrans > 0
    if kw.get("policy") == "sq2":
        assert rt.messages >= 4 * rt.arrivals
    if kw.get("fault") == "crash" and kw.get("policy", "jsaq") in ("jsq", "jsaq"):
        # Checked at every routed arrival: none went to a suspect server
        # while some server was healthy, and such arrivals occurred.
        assert int(raw["suspect_routes"][0]) == 0
        assert int(raw["masked_routes"][0]) > 0


@pytest.mark.parametrize("knobs", _faults._MATRIX)
def test_serving_cell_matches_the_reference(knobs):
    cell = jeng.ServeConfig(**SERVE_BASE, **knobs)
    wl = jeng.workload_for(cell, 3)
    numpy_ref = jeng.run_serving_sim(
        cell.engine_config(), slots=cell.slots, load=cell.load,
        mean_decode=cell.mean_decode, mean_prefill=cell.mean_prefill, seed=3,
        workload=wl,
    )
    ref = jeng.serve_one(3, cell)
    got = teng.serve_one(3, teng.ServeConfig(**SERVE_BASE, **knobs), device="cpu")
    _same_fields(got, ref, jeng.ServeResult, str(knobs))
    np.testing.assert_array_equal(got.jct_by_rid, numpy_ref["jct_by_rid"])
    np.testing.assert_array_equal(got.final_occupancy, numpy_ref["final_occupancy"])
    for name in ("messages", "net_drops", "retrans", "token_misses", "token_sum"):
        assert getattr(got, name) == numpy_ref[name], name


class TestZeroOperandIdentity:
    def test_slotted_net_zero_operands_bit_identical(self):
        base = dict(servers=8, slots=3000, load=0.9, mean_service=10, policy="jsaq",
                    comm="et", x=3)
        r0, _ = _port_run(7, base)
        for zero in (dict(network="net"),
                     dict(fault="crash", crash_rate=0.0, recover_rate=0.0)):
            r1, _ = _port_run(7, {**base, **zero})
            _same_fields(r1, r0, tsim.SimResult, str(zero))
        # And the port's own draws: the control plane's streams come after
        # every other one, so the "none" cell replays.
        cfg = tsim.SimConfig(**base)
        plain = tsim.simulate(7, cfg, device="cpu")
        net = tsim.simulate(7, dataclasses.replace(cfg, network="net"), device="cpu")
        _same_fields(net, plain, tsim.SimResult)

    def test_serving_net_zero_operands_bit_identical(self):
        base = dict(replicas=6, decode_slots=4, slots=600, load=0.9, queue_cap=256)
        r0 = teng.serve_one(11, teng.ServeConfig(**base), device="cpu")
        ref = jeng.serve_one(11, jeng.ServeConfig(**base))
        for zero in (dict(network="net"), dict(fault="crash")):
            r1 = teng.serve_one(11, teng.ServeConfig(**base, **zero), device="cpu")
            _same_fields(r1, r0, teng.ServeResult, str(zero))
            assert r1.net_drops == 0
        np.testing.assert_array_equal(r0.jct_by_rid, ref.jct_by_rid)


def _engineered(slots, crash_at, recover_at, target, **kw):
    cell = dict(replicas=6, decode_slots=3, slots=slots, load=0.9, mean_prefill=2,
                mean_decode=8, queue_cap=256, x=2, **kw)
    wl = jeng.sample_workload(0, replicas=6, decode_slots=3, slots=slots, load=0.9,
                              mean_prefill=2, mean_decode=8,
                              with_net=kw.get("network", "none") != "none",
                              with_fault=True)
    wl.fault_u[:] = 0.9  # no transition at rate 0.5 ...
    wl.fault_u[crash_at, target] = 0.0  # ... but these two
    wl.fault_u[recover_at, target] = 0.0
    return cell, wl


@pytest.mark.parametrize("policy,comm,extra", _faults.TestDegradedInvariants._POLICY_SUSPECT)
def test_engineered_outage_routes_around_the_suspect(policy, comm, extra):
    # tests/test_faults.py's engineered crash of replica 2 (slots 40-160),
    # held against the reference's numpy dispatcher; the counters of the
    # suspect mask show no request went to a suspect replica while a
    # healthy one was eligible (SQ(d) may: its sampled subset can hold
    # suspects only).
    cell, wl = _engineered(200, 40, 160, 2, policy=policy, comm=comm,
                           fault="crash", crash_rate=0.5, recover_rate=0.5,
                           suspect_age=4, **extra)
    jcell = jeng.ServeConfig(**cell)
    ref = jeng.run_serving_sim(jcell.engine_config(), slots=200, load=0.9,
                               mean_decode=8, mean_prefill=2, seed=0, workload=wl)
    port = teng.ServeConfig(**cell)
    got = teng.serve_one(0, port, workload=wl, device="cpu")
    np.testing.assert_array_equal(got.jct_by_rid, ref["jct_by_rid"])
    assert got.messages == ref["messages"] and got.token_sum == ref["token_sum"]
    static = dataclasses.replace(port.static_part(), max_arrivals=8)
    args = teng._core_args([teng.ServeWorkload.from_arrays(wl)], [port], static, 1024,
                           torch.device("cpu"))
    out = teng._serve_core(*args)
    if policy != "sqd":
        assert int(out["suspect_routes"][0]) == 0
    if policy != "jiq":
        assert int(out["masked_routes"][0]) > 0
    assert got.offered == got.completed + int(got.final_occupancy.sum())
