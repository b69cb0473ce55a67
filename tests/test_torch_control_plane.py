"""The port's degraded control plane against the JAX package, on the same inputs.

``comm.net_step`` / ``comm.net_step_ack`` and ``workload.fault_transitions``
/ ``faulted_service_units`` run batched in the port (a leading run axis,
one operand set a run) and per run in the reference's numpy namespace
(``xp=np``), from the same seeded states and uniforms, over many slots.
Every state field and output is an integer, a bool or a float32 produced
by the same single operations (the payload is copied, the backoff ladder
multiplied), so the tolerance is zero.  ``tests/test_faults.py``'s unit
cases (``TestNetStep``, ``TestAckTransport``, ``TestSnapshotPromotion``)
are restated on the port, and its ``TestValidation`` field lists are held
against the port's config entry points.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_faults as _faults
from repro.core.care import comm as jcomm
from repro.core.care import workload as jworkload
from repro_torch.core.care import comm as tcomm
from repro_torch.core.care import routing as troute
from repro_torch.core.care import slotted_sim as tsim
from repro_torch.core.care import workload as tworkload
from repro_torch.serve import engine as teng

K = 9
SLOTS = 400
# One operand set a run: (delay, jitter, drop).
WIRES = [(0, 0, 0.0), (0, 2, 0.3), (3, 0, 0.1), (2, 3, 0.5), (5, 1, 0.0)]
# (ack_timeout, backoff_base, max_retries, ka_period) a run, one of them
# pushing the backoff ladder to its 2^30 clamp.
ACKS = [(1, 1.0, 0, 0), (4, 2.0, 3, 5), (2, 1.5, 8, 0), (1, 3e9, 40, 3), (6, 2.0, 1, 1)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _col(values, dtype):
    return torch.tensor(values, dtype=dtype)[:, None]


def _same_state(port, refs, label):
    for f in dataclasses.fields(port):
        got = getattr(port, f.name).numpy()
        want = np.stack([np.asarray(getattr(r, f.name)) for r in refs])
        np.testing.assert_array_equal(got, want, err_msg=f"{label} {f.name}")


def _inputs(rng, b, payload_dtype):
    trig = rng.random((b, K)) < 0.3
    if payload_dtype == np.float32:
        payload = rng.integers(0, 40, (b, K)).astype(np.float32) * np.float32(0.25)
    else:
        payload = rng.integers(0, 40, (b, K)).astype(np.int32)
    can = rng.random((b, K)) < 0.9
    return trig, payload, can


@pytest.mark.parametrize("payload_dtype", [np.int32, np.float32])
@pytest.mark.parametrize("crash", [False, True])
def test_net_step_matches_the_reference(payload_dtype, crash):
    rng = np.random.default_rng(17 + crash)
    b = len(WIRES)
    delay, jitter, drop = (list(v) for v in zip(*WIRES))
    tcfg = tcomm.NetworkConfig("net", delay=_col(delay, torch.int32),
                               jitter=_col(jitter, torch.int32),
                               drop=_col(drop, torch.float32))
    jcfgs = [jcomm.NetworkConfig("net", delay=np.int32(d), jitter=np.int32(j),
                                 drop=np.float32(p)) for d, j, p in WIRES]
    tstate = tcomm.NetState.init(K, (b,), payload_dtype=_t(np.zeros(1, payload_dtype)).dtype)
    jstates = [jcomm.NetState.init(K, xp=np, payload_dtype=payload_dtype) for _ in WIRES]
    delivered_any = dropped_any = 0
    for t in range(SLOTS):
        trig, payload, can = _inputs(rng, b, payload_dtype)
        du = rng.random((b, K), dtype=np.float32)
        ju = rng.random((b, K), dtype=np.float32)
        out = tcomm.net_step(tstate, tcfg, _t(trig), _t(payload), _t(du), _t(ju),
                             can_send=_t(can) if crash else None)
        tstate = out[3]
        for r in range(b):
            ref = jcomm.net_step(jstates[r], jcfgs[r], trig[r], payload[r], du[r],
                                 ju[r], xp=np, can_send=can[r] if crash else None)
            jstates[r] = ref[3]
            for i in range(3):
                np.testing.assert_array_equal(out[i][r].numpy(), np.asarray(ref[i]),
                                              err_msg=f"slot {t} run {r} out {i}")
        _same_state(tstate, jstates, f"slot {t}")
        delivered_any += int(out[0].sum())
    dropped_any = int(tstate.drops.sum())
    assert delivered_any > 0 and dropped_any > 0


@pytest.mark.parametrize("crash", [False, True])
def test_net_step_ack_matches_the_reference(crash):
    rng = np.random.default_rng(29 + crash)
    b = len(WIRES)
    delay, jitter, drop = (list(v) for v in zip(*WIRES))
    timeout, base, retries, ka = (list(v) for v in zip(*ACKS))
    tcfg = tcomm.NetworkConfig(
        "net", delay=_col(delay, torch.int32), jitter=_col(jitter, torch.int32),
        drop=_col(drop, torch.float32), transport="ack",
        ack_timeout=_col(timeout, torch.int32), backoff_base=_col(base, torch.float32),
        max_retries=_col(retries, torch.int32), ka_period=_col(ka, torch.int32),
    )
    jcfgs = [
        jcomm.NetworkConfig("net", delay=np.int32(d), jitter=np.int32(j),
                            drop=np.float32(p), transport="ack",
                            ack_timeout=np.int32(a), backoff_base=np.float32(bb),
                            max_retries=np.int32(m), ka_period=np.int32(kp))
        for (d, j, p), (a, bb, m, kp) in zip(WIRES, ACKS)
    ]
    tstate = tcomm.AckNetState.init(K, (b,), payload_dtype=torch.float32)
    jstates = [jcomm.AckNetState.init(K, xp=np, payload_dtype=np.float32) for _ in WIRES]
    gave_up = False
    for t in range(SLOTS):
        trig, payload, can = _inputs(rng, b, np.float32)
        du = rng.random((b, K), dtype=np.float32)
        ju = rng.random((b, K), dtype=np.float32)
        au = rng.random((b, 4, K), dtype=np.float32)
        out = tcomm.net_step_ack(tstate, tcfg, _t(trig), _t(payload), _t(du), _t(ju),
                                 _t(au), can_send=_t(can) if crash else None)
        tstate = out[3]
        for r in range(b):
            ref = jcomm.net_step_ack(jstates[r], jcfgs[r], trig[r], payload[r], du[r],
                                     ju[r], au[r], xp=np,
                                     can_send=can[r] if crash else None)
            jstates[r] = ref[3]
            for i in range(3):
                np.testing.assert_array_equal(out[i][r].numpy(), np.asarray(ref[i]),
                                              err_msg=f"slot {t} run {r} out {i}")
        _same_state(tstate, jstates, f"slot {t}")
        gave_up = gave_up or bool(tstate.gave_up.any())
    assert int(tstate.retrans.sum()) > 0 and gave_up
    # The 3e9 ladder is held at its clamp.
    assert float(tstate.backoff[3].max()) == 2.0**30


@pytest.mark.parametrize("rates", [None, (1.0, 2.0, 0.5, 0.25, 1.5, 4 / 3, 0.75, 3.0, 1.0)])
@pytest.mark.parametrize("kind", ["crash", "slow"])
def test_fault_process_matches_the_reference(kind, rates):
    rng = np.random.default_rng(5)
    crash = np.array([0.0, 0.05, 0.3], np.float32)
    recover = np.array([0.5, 0.2, 0.9], np.float32)
    slow = np.array([0.5, 0.25, 1.0], np.float32)
    r_np = None if rates is None else np.asarray(rates, np.float32)
    faulted = np.zeros((3, K), bool)
    tfaulted = _t(faulted)
    for t in range(300):
        u = rng.random((3, K), dtype=np.float32)
        tfaulted, trec = tworkload.fault_transitions(
            tfaulted, _t(u), _t(crash)[:, None], _t(recover)[:, None])
        nominal = 1 if r_np is None else jworkload.service_units(t, r_np, xp=np)
        tunits = tworkload.faulted_service_units(
            torch.tensor(float(t)), tfaulted, nominal if r_np is None else _t(nominal),
            kind, _t(slow)[:, None], rates=None if r_np is None else _t(r_np))
        for r in range(3):
            jf, jrec = jworkload.fault_transitions(faulted[r], u[r], crash[r], recover[r],
                                                   xp=np)
            faulted[r] = jf
            np.testing.assert_array_equal(trec[r].numpy(), jrec)
            want = jworkload.faulted_service_units(
                t, jf, np.ones(K, np.int32) if r_np is None else nominal, kind,
                slow[r], rates=r_np, xp=np)
            np.testing.assert_array_equal(tunits[r].numpy(), want)
        np.testing.assert_array_equal(tfaulted.numpy(), faulted)
    assert faulted.any() and not faulted.all()


@pytest.mark.parametrize("n", [1, 2, 3, 7, 30, 65536, 65537, 100_000, 2**31 - 1])
def test_randint_from_bits_is_the_references_randint(n):
    # The random policy under a suspect mask draws from each slot's
    # eligible count: the port takes the two words randint draws and
    # repeats its uint32 arithmetic (wraps above 2^16 included).
    keys = jax.random.split(jax.random.key(n % 1000), 300)

    def words(key):
        k1, k2 = jax.random.split(key)
        return jnp.stack([jax.random.bits(k1, (), jnp.uint32),
                          jax.random.bits(k2, (), jnp.uint32)])

    bits = np.asarray(jax.vmap(words)(keys)).astype(np.int64)
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, n, jnp.int32))(keys))
    got = troute.randint_from_bits(_t(bits), torch.tensor(n))
    np.testing.assert_array_equal(got.numpy(), want)
    # And from an eligible mask, the pick-th eligible server.
    mask = torch.from_numpy(np.random.default_rng(n % 97).random((300, 12)) < 0.4)
    picked = troute.route_random(None, mask, _t(bits))
    n_elig = torch.where(mask.any(-1), mask.sum(-1), 12)
    r = troute.randint_from_bits(_t(bits), n_elig)
    eligible = torch.where(mask.any(-1, keepdim=True), mask, True)
    for row in range(300):
        assert int(picked[row]) == int(torch.nonzero(eligible[row])[int(r[row]), 0])


# ---------------------------------------------------------------------------
# tests/test_faults.py's unit cases, restated on the port.
# ---------------------------------------------------------------------------


def _ncfg(delay=0, jitter=0, drop=0.0):
    return tcomm.NetworkConfig("net", delay=delay, jitter=jitter, drop=drop)


def _drive(cfg, triggers, payloads, drop_u=None, jit_u=None):
    state = tcomm.NetState.init(1, payload_dtype=torch.float32)
    out = []
    for t in range(len(triggers)):
        du = torch.full((1,), 0.99 if drop_u is None else drop_u[t])
        ju = torch.full((1,), 0.0 if jit_u is None else jit_u[t])
        delivered, payload, sent, state = tcomm.net_step(
            state, cfg, torch.tensor([triggers[t]]), torch.tensor([payloads[t]]), du, ju)
        out.append((bool(delivered[0]), float(payload[0]), int(sent)))
    return out, state


class TestNetStep:
    def test_zero_delay_is_instant(self):
        out, _ = _drive(_ncfg(), [True, False], [5.0, 9.0])
        assert out[0] == (True, 5.0, 1) and out[1][0] is False

    def test_delay_applies_send_time_snapshot(self):
        out, _ = _drive(_ncfg(delay=3), [True] + [False] * 4, [5.0] + [9.0] * 4)
        assert [o[0] for o in out] == [False, False, False, True, False]
        assert out[3][1] == 5.0 and sum(o[2] for o in out) == 1

    def test_piggyback_batches_triggers_behind_in_flight(self):
        out, _ = _drive(_ncfg(delay=2), [True, True, False, False, False],
                        [5.0, 6.0, 7.0, 8.0, 9.0])
        assert [o[0] for o in out] == [False, False, True, False, True]
        assert out[2][1] == 5.0 and out[4][1] == 7.0
        assert sum(o[2] for o in out) == 2

    def test_drop_costs_a_message_and_is_never_delivered(self):
        out, state = _drive(_ncfg(delay=2, drop=0.5), [True, False, False, False],
                            [5.0] * 4, drop_u=[0.1, 0.99, 0.99, 0.99])
        assert not any(o[0] for o in out)
        assert sum(o[2] for o in out) == 1 and int(state.drops) == 1

    def test_jitter_bounds_delivery_window(self):
        late, _ = _drive(_ncfg(delay=2, jitter=3), [True] + [False] * 7, [5.0] * 8,
                         jit_u=[0.999] * 8)
        early, _ = _drive(_ncfg(delay=2, jitter=3), [True] + [False] * 7, [5.0] * 8,
                          jit_u=[0.0] * 8)
        assert [o[0] for o in late].index(True) == 5
        assert [o[0] for o in early].index(True) == 2

    def test_age_is_slots_since_delivery(self):
        out, state = _drive(_ncfg(delay=2), [True] + [False] * 4, [5.0] * 5)
        assert [o[0] for o in out] == [False, False, True, False, False]
        assert int(state.age[0]) == 2

    def test_crash_wipes_queued_piggyback(self):
        cfg = _ncfg(delay=3)
        state = tcomm.NetState.init(1, payload_dtype=torch.float32)
        du, ju = torch.full((1,), 0.99), torch.zeros(1)

        def step(trig, payload, can_send=None):
            return tcomm.net_step(
                state, cfg, torch.tensor([trig]), torch.tensor([payload]), du, ju,
                can_send=None if can_send is None else torch.tensor([can_send]))

        _, _, s0, state = step(True, 5.0)
        _, _, _, state = step(True, 6.0)
        assert bool(state.pending[0])
        _, _, _, state = step(False, 7.0, can_send=False)
        assert not bool(state.pending[0])
        sent_after = 0
        for _ in range(5):
            _, _, sent, state = step(False, 8.0, can_send=False)
            sent_after += int(sent)
        assert int(s0) == 1 and sent_after == 0


def _ack_cfg(delay=0, jitter=0, drop=0.0, timeout=4, base=2.0, retries=8, ka=0):
    return tcomm.NetworkConfig("net", delay=delay, jitter=jitter, drop=drop,
                               transport="ack", ack_timeout=timeout,
                               backoff_base=base, max_retries=retries, ka_period=ka)


def _ack_step(state, cfg, trig, payload, drop_u=0.99, can_send=None):
    ack_u = torch.tensor([[0.99], [0.0], [0.99], [0.0]])
    return tcomm.net_step_ack(
        state, cfg, torch.tensor([trig]), torch.tensor([payload]),
        torch.full((1,), drop_u), torch.zeros(1), ack_u,
        can_send=None if can_send is None else torch.tensor([can_send]))


def _ack_state():
    return tcomm.AckNetState.init(1, payload_dtype=torch.float32)


class TestAckTransport:
    def test_round_trip_closes_window_and_bills_the_ack(self):
        cfg, state, log = _ack_cfg(delay=2, timeout=10), _ack_state(), []
        for t in range(6):
            delivered, payload, sent, state = _ack_step(state, cfg, t == 0, float(t + 5))
            log.append((bool(delivered[0]), float(payload[0]), int(sent)))
        assert [d for d, _, _ in log] == [False, False, True, False, False, False]
        assert log[2][1] == 5.0 and sum(s for _, _, s in log) == 2
        assert int(state.retrans) == 0 and int(state.awaiting[0]) == -1
        assert not bool(state.gave_up[0])

    def test_dropped_data_retransmits_fresh_snapshot(self):
        cfg, state, out = _ack_cfg(drop=0.5, timeout=2), _ack_state(), []
        for t, du in enumerate([0.1, 0.99, 0.99]):
            delivered, payload, sent, state = _ack_step(state, cfg, t == 0, float(t + 5),
                                                        drop_u=du)
            out.append((bool(delivered[0]), float(payload[0])))
        assert out[0] == (False, 0.0) and out[1][0] is False and out[2] == (True, 7.0)
        assert int(state.retrans) == 1 and int(state.drops) == 1
        assert not bool(state.gave_up[0])

    def test_backoff_grows_and_abandon_marks_self_suspect(self):
        cfg = _ack_cfg(drop=0.9, timeout=1, base=2.0, retries=1)
        state, sent_log = _ack_state(), []
        for t in range(6):
            _, _, sent, state = _ack_step(state, cfg, t == 0, 5.0, drop_u=0.0)
            sent_log.append(int(sent))
        assert sent_log == [1, 1, 0, 0, 0, 0] and bool(state.gave_up[0])
        assert int(state.retrans) == 1 and int(state.drops) == 2
        assert int(state.awaiting[0]) == -1

    def test_keepalives_fire_on_period_and_reset_last_heard(self):
        cfg, state, ages, sent_log = _ack_cfg(ka=3), _ack_state(), [], []
        for _ in range(7):
            _, _, sent, state = _ack_step(state, cfg, False, 5.0)
            ages.append(int(state.ka_age[0]))
            sent_log.append(int(sent))
        assert sent_log == [0, 0, 1, 0, 0, 1, 0] and ages == [1, 2, 0, 1, 2, 0, 1]

    def test_crashed_server_goes_silent_and_window_holds(self):
        cfg = _ack_cfg(drop=0.9, timeout=1, base=1.0, retries=8, ka=2)
        _, _, s0, state = _ack_step(_ack_state(), cfg, True, 5.0, drop_u=0.0)
        assert int(s0) == 1
        for _ in range(4):
            _, _, sent, state = _ack_step(state, cfg, False, 6.0, can_send=False)
            assert int(sent) == 0
        assert int(state.awaiting[0]) == 0 and int(state.retrans) == 0
        delivered, payload, _, state = _ack_step(state, cfg, False, 7.0, drop_u=0.99)
        assert bool(delivered[0]) and float(payload[0]) == 7.0
        assert int(state.retrans) == 1

    def test_keepalive_silence_of_crashed_server_raises_ka_age(self):
        cfg, state = _ack_cfg(ka=2), _ack_state()
        for _ in range(6):
            _, _, _, state = _ack_step(state, cfg, False, 5.0, can_send=False)
        assert int(state.ka_age[0]) == 6


class TestSnapshotPromotion:
    def test_counters_promote_and_round_trip(self):
        near = np.iinfo(np.int32).max - 10
        state = dataclasses.replace(
            tcomm.AckNetState.init(4), drops=torch.tensor(near, dtype=torch.int32),
            retrans=torch.tensor(near - 5, dtype=torch.int32))
        snap = tcomm.snapshot_state(state)
        assert snap.drops.dtype == np.int64 and snap.retrans.dtype == np.int64
        assert int(snap.drops) + int(snap.retrans) == 2 * near - 5
        assert snap.timer.dtype == np.int32
        back = tcomm.restore_state(snap)
        assert back.drops.dtype == torch.int32 and int(back.drops) == near
        # The reference takes the port's snapshot, field for field.
        ref = jcomm.restore_state(jcomm.AckNetState(**dataclasses.asdict(snap)), xp=np)
        assert int(ref.drops) == near

    def test_restore_saturates_instead_of_wrapping(self):
        snap = tcomm.snapshot_state(tcomm.NetState.init(2))
        snap = dataclasses.replace(snap, drops=np.int64(np.iinfo(np.int32).max) + 1000)
        assert int(tcomm.restore_state(snap).drops) == np.iinfo(np.int32).max

    def test_batched_counters_and_control_plane_init(self):
        # With a run axis the running totals are (N,) and still promote.
        comm, net, faulted = tcomm.control_plane_init(
            5, network="net", fault="crash", transport="ack", batch=(3,))
        tree = (comm, net, faulted, None)
        snap = tcomm.snapshot_state(tree)
        assert snap[0].msgs.dtype == np.int64 and snap[0].msgs.shape == (3,)
        assert snap[1].retrans.dtype == np.int64 and snap[1].ka_age.dtype == np.int32
        assert snap[2].shape == (3, 5) and snap[3] is None
        back = tcomm.restore_state(snap)
        assert back[1].drops.dtype == torch.int32 and back[3] is None
        assert isinstance(back[1], tcomm.AckNetState)
        jcomm_, jnet, jfault = jcomm.control_plane_init(5, network="net", fault="crash",
                                                        transport="ack", xp=np)
        for f in dataclasses.fields(jnet):
            np.testing.assert_array_equal(getattr(net, f.name)[0].numpy(),
                                          np.asarray(getattr(jnet, f.name)).astype(
                                              getattr(net, f.name).numpy().dtype))
        assert tcomm.control_plane_init(5)[1:] == (None, None)
        assert isinstance(tcomm.control_plane_init(5, network="net")[1], tcomm.NetState)


# ---------------------------------------------------------------------------
# Validation: tests/test_faults.py's field lists on the port's entry points.
# ---------------------------------------------------------------------------


def _cases(test, i=0):
    return test.pytestmark[i].args[1]


class TestValidation:
    @pytest.mark.parametrize(
        "knobs,field", _cases(_faults.TestValidation.test_serving_rejects_named_field))
    def test_serving_rejects_named_field(self, knobs, field):
        cell = teng.ServeConfig(replicas=4, decode_slots=2, slots=50, **knobs)
        with pytest.raises(ValueError, match=field):
            cell.static_part()

    @pytest.mark.parametrize(
        "knobs,field", _cases(_faults.TestValidation.test_slotted_rejects_named_field))
    def test_slotted_rejects_named_field(self, knobs, field):
        with pytest.raises(ValueError, match=field):
            tsim.simulate(0, tsim.SimConfig(servers=4, slots=100, **knobs), device="cpu")

    @pytest.mark.parametrize("knobs,match", _cases(
        _faults.TestValidation.test_serving_rejects_invalid_pull_pairing))
    def test_serving_rejects_invalid_pull_pairing(self, knobs, match):
        cell = teng.ServeConfig(replicas=4, decode_slots=2, slots=50, **knobs)
        with pytest.raises(ValueError, match=match):
            cell.static_part()

    @pytest.mark.parametrize("knobs,match", _cases(
        _faults.TestValidation.test_slotted_rejects_invalid_pull_pairing))
    def test_slotted_rejects_invalid_pull_pairing(self, knobs, match):
        with pytest.raises(ValueError, match=match):
            tsim.simulate(0, tsim.SimConfig(servers=4, slots=100, **knobs), device="cpu")

    def test_exact_comm_cannot_compose_with_network(self):
        with pytest.raises(ValueError, match="exact"):
            tsim.SimConfig(comm="exact", network="net").static_part()
        with pytest.raises(ValueError, match="exact"):
            teng.ServeConfig(comm="exact", network="net").static_part()

    def test_stale_ring_capacity_guards_query_policies(self):
        cfg = tsim.SimConfig(servers=4, slots=100, policy="jsq", network="net",
                             net_delay=40, net_delay_cap=32)
        with pytest.raises(ValueError, match="net_delay_cap"):
            tsim.simulate(0, cfg, device="cpu")

    def test_operands_meet_their_kinds_in_a_grid(self):
        # A cell built without its kinds meets the StaticConfig in the grid.
        static = tsim.SimConfig(servers=4, slots=50).static_part()
        for scn, field in ((tsim.Scenario.create(0.5, servers=4, network="net",
                                                 net_delay=2), "net_delay"),
                           (tsim.Scenario.create(0.5, servers=4, fault="crash",
                                                 crash_rate=0.1, recover_rate=0.1),
                            "crash_rate")):
            with pytest.raises(ValueError, match=field):
                tsim.simulate_grid([0], static, [scn], device="cpu")

    def test_fused_backends_refuse_degraded_kinds(self):
        slotted = tsim.SimConfig(servers=8, slots=100, policy="jsq",
                                 service="deterministic", route_backend="fused",
                                 deterministic_ties=True, network="net", net_delay=2)
        with pytest.raises(NotImplementedError, match="network='net'"):
            tsim.simulate(0, slotted, device="cpu")
        serving = teng.ServeConfig(route_backend="fused", deterministic_ties=True,
                                   fault="crash", crash_rate=0.1, recover_rate=0.5)
        with pytest.raises(NotImplementedError, match="fault='crash'"):
            serving.static_part()
        with pytest.raises(ValueError, match="policy 'jsaq' only"):
            teng.ServeConfig(route_backend="fused", deterministic_ties=True,
                             policy="jiq", comm="jiq").static_part()
