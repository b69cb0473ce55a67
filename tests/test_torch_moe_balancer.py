"""The port's CARE expert balancer against ``repro.core.moe_balancer``.

Every function runs on the same numpy-seeded state in both packages.
Means over the expert axis may sum in another order, so float leaves are
compared within rtol 1e-6 / atol 1e-5: the leaves reach ~30, where one
float32 ulp is 1.9e-6, and the zero-mean step of the integral bias
subtracts such values, so a few ulps show as an absolute error near zero.
Step counters and trigger decisions must be equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import CareConfig as JCare
from repro.core import moe_balancer as jbal
from repro_torch.configs.base import CareConfig as TCare
from repro_torch.core import moe_balancer as tbal

TOL = dict(rtol=1e-6, atol=1e-5)
FIELDS = ("load_approx", "true_load", "true_counts", "bias", "steps_since_sync")


def _states(shape, seed, steps=0):
    """The same random state in both packages."""
    rng = np.random.default_rng(seed)
    leaves = {f: rng.uniform(0, 20, shape).astype(np.float32) for f in FIELDS[:4]}
    j = jbal.BalancerState(**{f: jnp.asarray(v) for f, v in leaves.items()},
                           steps_since_sync=jnp.asarray(steps, jnp.int32))
    t = tbal.BalancerState(**{f: torch.from_numpy(v) for f, v in leaves.items()},
                           steps_since_sync=torch.tensor(steps, dtype=torch.int32))
    return j, t


def _close(t_state, j_state):
    for f in FIELDS:
        got, want = getattr(t_state, f).numpy(), np.asarray(getattr(j_state, f))
        assert got.shape == want.shape and got.dtype == want.dtype, f
        np.testing.assert_allclose(got, want, **TOL, err_msg=f)


CARES = [
    dict(),
    dict(bias_alpha=2.0, bias_clip=0.5, gamma=0.2, drain=0.5),
    dict(enabled=False),
]
SHAPES = [(2, 8), (3, 160), (2, 2, 4, 16)]


@pytest.mark.parametrize("care", CARES)
@pytest.mark.parametrize("shape", SHAPES)
def test_selection_bias(care, shape):
    j, t = _states(shape, seed=len(shape) + shape[-1])
    got = tbal.selection_bias(t, TCare(**care)).numpy()
    np.testing.assert_allclose(got, np.asarray(jbal.selection_bias(j, JCare(**care))), **TOL)


@pytest.mark.parametrize("care", CARES[:2])
@pytest.mark.parametrize("shape", SHAPES)
def test_post_step_update_three_steps(care, shape):
    j, t = _states(shape, seed=shape[-1])
    rng = np.random.default_rng(7)
    for _ in range(3):
        counts = rng.integers(0, 30, shape).astype(np.float32)
        j = jbal.post_step_update(j, jnp.asarray(counts), JCare(**care))
        t = tbal.post_step_update(t, torch.from_numpy(counts), TCare(**care))
        _close(t, j)
    assert int(t.steps_since_sync) == 3


@pytest.mark.parametrize("shape", SHAPES)
def test_sync(shape):
    # 4-D state: per-dispatcher rows snap to the mean over dispatchers.
    j, t = _states(shape, seed=11, steps=5)
    t2 = tbal.sync(t, TCare())
    _close(t2, jbal.sync(j, JCare()))
    assert int(t2.steps_since_sync) == 0 and not t2.true_counts.any()
    if len(shape) == 4:
        rows = t2.load_approx.reshape(shape[0], -1, shape[-1])
        assert torch.equal(rows, rows[:, :1].expand_as(rows))


@pytest.mark.parametrize("x", [1, 3, 8])
def test_needs_sync_dt(x):
    j, t = _states((2, 8), seed=x)
    for step in range(x + 2):
        j2 = dataclasses.replace(j, steps_since_sync=jnp.asarray(step, jnp.int32))
        t2 = dataclasses.replace(t, steps_since_sync=torch.tensor(step, dtype=torch.int32))
        got = bool(tbal.needs_sync(t2, TCare(comm="dt", x=x)))
        assert got == bool(jbal.needs_sync(j2, JCare(comm="dt", x=x))) == (step >= x)


@pytest.mark.parametrize("x", [1, 2, 4])
@pytest.mark.parametrize("shape", [(2, 8), (2, 2, 4, 16)])
def test_needs_sync_et(x, shape):
    # Errors spread from 0 to ~3 mean loads: each threshold is met by some
    # seeds and missed by others.
    fired = set()
    for seed in range(6):
        j, t = _states(shape, seed=seed)
        scale = np.float32(seed * 0.15)
        j = dataclasses.replace(j, load_approx=j.true_load * (1 + scale))
        t = dataclasses.replace(t, load_approx=t.true_load * (1 + scale))
        got = bool(tbal.needs_sync(t, TCare(comm="et", x=x)))
        assert got == bool(jbal.needs_sync(j, JCare(comm="et", x=x)))
        fired.add(got)
    if x == 1:
        assert fired == {False, True}


def test_exact_state_never_fires_et():
    j, t = _states((2, 8), seed=0)
    t = dataclasses.replace(t, load_approx=t.true_load.clone())
    assert not bool(tbal.needs_sync(t, TCare(comm="et", x=1)))


@pytest.mark.parametrize("seed", [0, 1])
def test_balance_metrics(seed):
    counts = np.random.default_rng(seed).integers(0, 100, 160).astype(np.int32)
    got = tbal.balance_metrics(torch.from_numpy(counts))
    want = jbal.balance_metrics(jnp.asarray(counts))
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5)


def test_init_is_zero_on_the_requested_device():
    s = tbal.BalancerState.init(2, 160, device="cpu")
    j = jbal.BalancerState.init(2, 160)
    _close(s, j)
    assert s.load_approx.device.type == "cpu"
