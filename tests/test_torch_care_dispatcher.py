"""The port's per-request dispatcher against the JAX package's numpy one.

``CareDispatcher`` / ``run_serving_sim`` of the port (``device="cpu"``)
must return every field of the reference's ``run_serving_sim`` on the same
``ServeWorkload``: the JCT vectors, the counters, the final occupancy, the
occupancy at checkpoints and the finished requests (rid, arrival, start,
finish, in completion order).  Both sides carry the emulated occupancy in
float32 and draw nothing of their own, so the tolerance is zero.

Cells: the policy x comm x ties matrix of ``tests/test_torch_serve_engine.py``
(cut from 1000 to 600 slots to keep this file near a minute), its 2:1 and
non-dyadic rates, every knob set of ``tests/test_faults.py``'s ``_MATRIX``,
the JIQ / hsq token pools, SQ(d) under suspect masking, ring growth past
``queue_cap``, the ``rng`` fallback and the ``model_fn`` hook.
"""
import dataclasses

import numpy as np
import pytest
import torch

import test_faults as _faults
from repro.serve import engine as jeng
from repro_torch.serve import engine as teng

POLICIES = ["jsaq", "sqd", "rr", "drain"]
KINDS = ["exact", "et", "dt", "rt", "et_rt"]
HETERO_21 = (2.0, 2.0, 2.0, 2.0, 1.0, 1.0, 1.0, 1.0)
NON_DYADIC = (1.5, 4 / 3, 1.0, 0.75, 1.25, 1.0, 2.0, 0.5)
SMALL = dict(
    replicas=8, decode_slots=4, slots=600, load=0.9, x=3, rt_period=32,
    mean_prefill=2, mean_decode=16, queue_cap=256,
)
SERVE_BASE = dict(replicas=6, decode_slots=4, slots=400, load=0.9, queue_cap=256)


def _requests(reqs):
    return [(r.rid, r.arrival, r.prefill_cost, r.decode_len, r.started, r.finished)
            for r in reqs]


def assert_same(got: dict, want: dict, label: str = ""):
    assert got.keys() == want.keys()
    for name, value in want.items():
        if name == "requests":
            assert _requests(got[name]) == _requests(value), label
        elif name == "occupancy":
            assert got[name].keys() == value.keys(), label
            for slot, occ in value.items():
                np.testing.assert_array_equal(got[name][slot], occ, err_msg=f"{label} {slot}")
        else:
            np.testing.assert_array_equal(got[name], value, err_msg=f"{label} {name}")
            if isinstance(value, np.ndarray):
                assert got[name].dtype == value.dtype, f"{label} {name}"
            else:
                assert type(got[name]) is type(value), f"{label} {name}"


def both(kw: dict, seed: int = 7, checkpoints=(0, 17, 299)):
    """The reference's and the port's ``run_serving_sim`` on one cell's
    cached workload (the reference's, which the port copies in)."""
    cell = jeng.ServeConfig(**kw)
    args = dict(slots=cell.slots, load=cell.load, mean_prefill=cell.mean_prefill,
                mean_decode=cell.mean_decode, seed=seed,
                workload=jeng.workload_for(cell, seed), checkpoints=checkpoints)
    want = jeng.run_serving_sim(cell.engine_config(), **args)
    got = teng.run_serving_sim(teng.ServeConfig(**kw).engine_config(), device="cpu", **args)
    return got, want


class TestMatrix:
    @pytest.mark.parametrize("deterministic", [False, True])
    @pytest.mark.parametrize("comm", KINDS)
    @pytest.mark.parametrize("policy", POLICIES)
    def test_matches_reference(self, policy, comm, deterministic):
        got, want = both({**SMALL, "policy": policy, "comm": comm,
                          "deterministic_ties": deterministic})
        assert_same(got, want, f"{policy}/{comm}/{deterministic}")
        assert got["completed"] > 0.8 * got["offered"]

    @pytest.mark.parametrize("policy,rates,drain", [
        ("jsaq", HETERO_21, 0.25),
        ("sqd", HETERO_21, 0.25),
        ("rr", HETERO_21, 0.25),
        ("drain", HETERO_21, 0.25),
        ("drain", NON_DYADIC, 0.25),
        ("jsaq", NON_DYADIC, 0.3),
    ])
    def test_decode_rates(self, policy, rates, drain):
        got, want = both({**SMALL, "policy": policy, "comm": "et",
                          "decode_rates": rates, "msr_drain": drain}, seed=5)
        assert_same(got, want, f"{policy} {rates}")


@pytest.mark.parametrize("knobs", _faults._MATRIX)
def test_degraded_cell_matches_reference(knobs):
    got, want = both({**SERVE_BASE, **knobs}, seed=3, checkpoints=(5, 200))
    assert_same(got, want, str(knobs))
    assert got["offered"] == got["completed"] + int(got["final_occupancy"].sum())


@pytest.mark.parametrize("policy", ["jiq", "hsq"])
def test_pull_token_pool_matches_reference(policy):
    got, want = both({**SMALL, "policy": policy, "comm": policy, "x": 3.0})
    assert_same(got, want, policy)
    assert got["token_misses"] > 0 and got["token_sum"] > 0


class TestSqdSuspectMasking:
    """The reference's SQ(d) x suspect-mask cases (``tests/test_serve_engine.py``
    ``TestSqdSuspectFallback``) on the port's dispatcher."""

    def _dispatcher(self, suspect: np.ndarray) -> teng.CareDispatcher:
        cfg = teng.EngineConfig(
            num_replicas=6, decode_slots=2, policy="sqd", sqd=2, comm="et",
            suspect_age=4, fault="crash", crash_rate=0.01, recover_rate=0.1,
        )
        disp = teng.CareDispatcher(cfg, device="cpu")
        # Age the suspect replicas past the bound through the trigger clock.
        disp.comm = dataclasses.replace(
            disp.comm, slots_since_msg=torch.from_numpy(np.where(suspect, 9, 0).astype(np.int32)))
        return disp

    def _route(self, disp, u):
        req = teng.Request(rid=0, arrival=0, prefill_cost=1, decode_len=1)
        return disp.route(req, now=0, u=np.float32(u), sub_u=np.zeros(teng.SQD_MAX, np.float32))

    def test_all_suspect_subset_falls_back_to_raw_sample(self):
        disp = self._dispatcher(np.array([True, True, False, False, False, False]))
        assert self._route(disp, 0.0) in (0, 1)
        np.testing.assert_array_equal(disp.last_subset.numpy(),
                                      [True, True, False, False, False, False])

    def test_partial_overlap_excludes_suspect_member(self):
        for u in (0.0, 0.5, 0.999):
            disp = self._dispatcher(np.array([True, False, False, False, False, False]))
            assert self._route(disp, u) == 1

    def test_aggressive_suspicion_matches_reference(self):
        got, want = both({**SMALL, "policy": "sqd", "comm": "et", "network": "net",
                          "net_delay": 3, "suspect_age": 1})
        assert_same(got, want, "suspect_age=1")


def _drive(disp, requests_by_slot, slots):
    """Route and step a dispatcher by hand; returns (slot, replica) routes
    and the finished requests."""
    routes, finished = [], []
    for now in range(slots):
        for req in requests_by_slot.get(now, []):
            routes.append(disp.route(dataclasses.replace(req), now))
        finished.extend(disp.step(now))
    return routes, finished


def test_rings_grow_past_queue_cap_without_dropping():
    # 2 replicas of one decode slot at 3x their capacity, rings of 4: the
    # rings double (4 -> 8 -> ... ) and nothing is dropped.  The rng
    # fallback (no u given) draws the tie uniforms on both sides.
    cfg = dict(num_replicas=2, decode_slots=1, comm="et", et_x=2)
    rng = np.random.default_rng(0)
    by_slot = {}
    rid = 0
    for now in range(300):
        for _ in range(int(rng.poisson(0.3))):
            by_slot.setdefault(now, []).append(
                jeng.Request(rid=rid, arrival=now, prefill_cost=1, decode_len=int(rng.integers(1, 12))))
            rid += 1
    ref = jeng.CareDispatcher(jeng.EngineConfig(**cfg), seed=4, queue_cap=4)
    port = teng.CareDispatcher(teng.EngineConfig(**cfg), seed=4, queue_cap=4, device="cpu")
    port_by_slot = {t: [teng.Request(**dataclasses.asdict(r)) for r in reqs]
                    for t, reqs in by_slot.items()}
    want = _drive(ref, by_slot, 300)
    got = _drive(port, port_by_slot, 300)
    assert got[0] == want[0]
    assert _requests(got[1]) == _requests(want[1])
    np.testing.assert_array_equal(port.true_occupancy().numpy(), ref.true_occupancy())
    assert port._qcap == ref._qcap > 4
    assert port.messages == ref.messages
    assert len(got[1]) + int(port.true_occupancy().sum()) == rid


@pytest.mark.parametrize("policy", ["jsaq", "sqd", "hsq"])
def test_rng_fallback_draws_as_the_reference(policy):
    comm = "hsq" if policy == "hsq" else "et"
    cfg = dict(num_replicas=5, decode_slots=2, policy=policy, comm=comm, sqd=3)
    ref = jeng.CareDispatcher(jeng.EngineConfig(**cfg), seed=11)
    port = teng.CareDispatcher(teng.EngineConfig(**cfg), seed=11, device="cpu")
    by_slot = {t: [jeng.Request(rid=3 * t + i, arrival=t, prefill_cost=1, decode_len=3)
                   for i in range(3)] for t in range(40)}
    port_by_slot = {t: [teng.Request(**dataclasses.asdict(r)) for r in reqs]
                    for t, reqs in by_slot.items()}
    want = _drive(ref, by_slot, 60)
    got = _drive(port, port_by_slot, 60)
    assert got[0] == want[0]
    assert _requests(got[1]) == _requests(want[1])
    assert port.token_sum == ref.token_sum and port.token_misses == ref.token_misses


def test_model_fn_is_called_once_a_slot_after_the_step():
    seen = []
    cfg = teng.EngineConfig(num_replicas=4, decode_slots=2)
    out = teng.run_serving_sim(cfg, slots=50, load=0.8, mean_prefill=2, mean_decode=6,
                               seed=1, model_fn=seen.append, checkpoints=(49,), device="cpu")
    assert seen == list(range(50))
    want = jeng.run_serving_sim(jeng.EngineConfig(num_replicas=4, decode_slots=2), slots=50,
                                load=0.8, mean_prefill=2, mean_decode=6, seed=1,
                                checkpoints=(49,))
    # Without a workload both sample their own, byte-identical streams.
    assert_same(out, want)
    np.testing.assert_array_equal(out["occupancy"][49], out["final_occupancy"])


def test_the_ports_own_workload_equals_the_copied_one():
    kw = {**SMALL, "slots": 200, "policy": "sqd", "network": "net", "net_delay": 2}
    cell = teng.ServeConfig(**kw)
    args = dict(slots=cell.slots, load=cell.load, mean_prefill=cell.mean_prefill,
                mean_decode=cell.mean_decode, seed=2, device="cpu")
    own = teng.run_serving_sim(cell.engine_config(), workload=teng.workload_for(cell, 2), **args)
    copied = teng.run_serving_sim(cell.engine_config(),
                                  workload=jeng.workload_for(jeng.ServeConfig(**kw), 2), **args)
    assert_same(own, copied)


class TestPickMinTied:
    def test_matches_reference_enumeration(self):
        rng = np.random.default_rng(0)
        for _ in range(200):
            n = int(rng.integers(1, 12))
            occ = rng.integers(0, 4, size=n).astype(np.float32)
            u = np.float32(rng.random())
            mask = rng.random(n) < 0.6 if rng.random() < 0.5 else None
            for det in (False, True):
                assert teng.pick_min_tied(occ, u, mask=mask, deterministic=det) == \
                    jeng.pick_min_tied(occ, u, mask=mask, deterministic=det)

    def test_edge_cases(self):
        occ = np.array([3.0, 1.0, 2.0, 0.0], np.float32)
        assert teng.pick_min_tied(occ, 0.3, mask=np.zeros(4, bool)) == -1
        assert teng.pick_min_tied(occ, 0.9, mask=np.array([1, 0, 0, 0], bool)) == 0
        ties = np.zeros(4, np.float32)
        assert teng.pick_min_tied(ties, np.float32(0.999)) == 3
        assert teng.pick_min_tied(ties, np.float32(0.999), deterministic=True) == 0


class TestConfig:
    @pytest.mark.parametrize("kw", [
        dict(),
        dict(comm="dt", x=5.0),
        dict(comm="et_rt", x=2.5, rt_period=9),
        dict(policy="hsq", comm="hsq", x=3.0),
        _faults._MATRIX[-1],
    ])
    def test_engine_config_and_comm_config(self, kw):
        ref = jeng.ServeConfig(**SERVE_BASE, **kw).engine_config()
        got = teng.ServeConfig(**SERVE_BASE, **kw).engine_config()
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        a, b = got.comm_config(), ref.comm_config()
        assert (a.kind, a.x, a.rt_period) == (b.kind, b.x, b.rt_period)

    @pytest.mark.parametrize("kw,match", [
        (dict(policy="sqd", sqd=9), "sqd"),
        (dict(decode_rates=(1.0, 2.0)), "decode_rates"),
        (dict(comm="exact", network="net"), "instant delivery"),
        (dict(policy="jiq", comm="et"), "requires comm"),
        (dict(comm="nope"), "unknown comm mode"),
    ])
    def test_rejects_what_the_reference_rejects(self, kw, match):
        with pytest.raises(ValueError, match=match):
            jeng.CareDispatcher(jeng.EngineConfig(**kw))
        with pytest.raises(ValueError, match=match):
            teng.CareDispatcher(teng.EngineConfig(**kw), device="cpu")

    def test_step_needs_the_control_plane_rows(self):
        disp = teng.CareDispatcher(teng.EngineConfig(fault="crash"), device="cpu")
        with pytest.raises(ValueError, match="fault_u"):
            disp.step(0)
        with pytest.raises(ValueError, match="fault_u stream"):
            teng.run_serving_sim(teng.EngineConfig(fault="crash"), slots=10, device="cpu",
                                 workload=teng.sample_workload(0, replicas=8, decode_slots=16,
                                                               slots=10, load=0.5))
