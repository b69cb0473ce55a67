"""The port's workload samplers against the JAX package's, on identical uniforms.

Each sampler of ``repro_torch.core.care.workload`` is a function of given
uniforms.  These tests draw the uniforms the reference's sampler draws
from its key, feed them to the port and compare:

* MMPP arrivals (the port's cumulative-sum parity against the
  reference's ``lax.scan`` over the chain): equal bit for bit, with and
  without a diurnal ``mod``;
* the diurnal ``mod``: within 2 float32 ulp of its scale 1.0, i.e.
  2 * 2**-23 (torch's and XLA's ``sin`` may differ by an ulp); Bernoulli
  arrivals under it equal except where ``|u - p| < 1e-6``;
* Pareto and Weibull sizes: equal, except entries that differ by exactly 1
  where the continuous value lies within 4 ulp of an integer (``pow`` and
  ``log`` may differ by an ulp, and ``ceil`` turns that into a whole slot
  at an integer edge);
* class ids: equal.

The port's own draws (``torch.Generator``) are held in distribution, in
the way of ``tests/test_workload_stats.py``, with fixed seeds: the SQ(d)
subsets and the random policy's picks.  A last test pins the draws of the
kinds that were ported before, so that their cells replay.
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.core.care import workload as jwork
from repro_torch.core.care import slotted_sim as tsim
from repro_torch.core.care import workload as twork

T = 20_000


def _t(a):
    return torch.from_numpy(np.array(a))


def _ulps(a, b):
    """Distance in float32 ulps (same-sign finite values)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("load,intensity,stay,amp", [
    (0.5, 1.6, 0.98, 0.0), (0.9, 1.7, 0.98, 0.0), (0.3, 2.5, 0.9, 0.0),
    (0.4, 1.6, 0.98, 0.3), (0.55, 1.7, 0.5, 0.05),
])
def test_mmpp_arrivals_bit_for_bit(load, intensity, stay, amp):
    key = jax.random.key(int(load * 100))
    lam_hi = np.float32(min(intensity * load, 1.0))
    lam_lo = np.float32(max(2.0 * load - min(intensity * load, 1.0), 0.0))
    mod = jwork.diurnal_modulation(jnp.arange(T, dtype=jnp.int32),
                                   jnp.float32(amp), jnp.float32(700.0))
    ref = jwork.mmpp_arrivals_from_rates(
        key, T, lam_hi, lam_lo, np.float32(stay), mod=None if amp == 0 else mod
    )
    k_switch, k_arr = jax.random.split(key)
    u_switch = _t(jax.random.uniform(k_switch, (T,)))
    u_arr = _t(jax.random.uniform(k_arr, (T,)))
    got = twork.mmpp_arrivals_from_rates(
        u_switch, u_arr, _t(lam_hi), _t(lam_lo), _t(np.float32(stay)),
        None if amp == 0 else _t(mod),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < T


@pytest.mark.parametrize("amp,period", [(0.0, 333.0), (0.1, 2000.0), (0.5, 97.5),
                                        (1.0, 24.0)])
def test_diurnal_modulation_and_arrivals(amp, period):
    t_idx = np.arange(T, dtype=np.int32)
    ref = np.asarray(jwork.diurnal_modulation(jnp.asarray(t_idx), jnp.float32(amp),
                                              jnp.float32(period)))
    got = twork.diurnal_modulation(_t(t_idx), _t(np.float32(amp)),
                                   _t(np.float32(period))).numpy()
    assert got.dtype == np.float32
    if amp == 0:
        assert np.all(got == 1.0) and np.all(ref == 1.0)
    assert np.abs(got - ref).max() <= 2 * 2.0**-23
    load = np.float32(0.45)
    key = jax.random.key(3)
    ref_arr = np.asarray(jwork.bernoulli_arrivals(key, T, load, mod=jnp.asarray(ref)))
    u = np.asarray(jax.random.uniform(key, (T,)))
    got_arr = twork.bernoulli_arrivals(_t(u), _t(load), _t(got)).numpy()
    near = np.abs(u - load * ref) < 1e-6
    np.testing.assert_array_equal(got_arr[~near], ref_arr[~near])
    assert near.sum() < 5


@pytest.mark.parametrize("kind,mean,tail", [
    ("pareto", 30.0, 1.5), ("pareto", 30.0, 3.0), ("pareto", 8.0, 1.1),
    ("weibull", 30.0, 0.5), ("weibull", 12.0, 2.0), ("weibull", 30.0, 1.0),
])
def test_heavy_tailed_sizes(kind, mean, tail):
    n = 200_000
    key = jax.random.key(int(mean * tail))
    jsp = jwork.ServiceProcess.create(kind, mean, tail)
    tsp = twork.ServiceProcess.create(kind, mean, tail)
    for f in ("mean", "tail", "geo_log1p", "msr_slots", "scale", "inv_tail"):
        assert np.asarray(getattr(jsp, f)) == getattr(tsp, f), f
        assert np.asarray(getattr(jsp, f)).dtype == np.asarray(getattr(tsp, f)).dtype, f
    ref = np.asarray(jwork.service_sizes(key, n, jsp))
    u = jax.random.uniform(key, (n,), jnp.float32, 1e-7, 1.0 - 1e-7)
    raw_fn = jwork.pareto_raw if kind == "pareto" else jwork.weibull_raw
    raw = np.asarray(raw_fn(u, jsp.scale, jsp.inv_tail))
    got = twork.service_sizes(_t(u), kind, _t(tsp.mean), _t(tsp.geo_log1p),
                              _t(tsp.scale), _t(tsp.inv_tail)).numpy()
    assert got.dtype == np.int32 and got.min() >= 1
    diff = got != ref
    edge = _ulps(raw, np.round(raw)) <= 4
    assert np.all(np.abs(got[diff].astype(np.int64) - ref[diff]) == 1)
    assert np.all(edge[diff])
    assert diff.sum() <= 20


@pytest.mark.parametrize("mix", [(1.0,), (0.5, 0.5), (0.2, 0.3, 0.5),
                                 (3.0, 0.0, 1.0), (0.1, 0.1, 0.1, 0.7)])
def test_arrival_classes(mix):
    key = jax.random.key(len(mix))
    mix32 = np.asarray(mix, np.float32)
    ref = np.asarray(jwork.arrival_classes(key, T, jnp.asarray(mix32)))
    u = _t(jax.random.uniform(key, (T,), jnp.float32))
    got = twork.arrival_classes(u, _t(mix32)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    # A run axis: one mix a row.
    both = twork.arrival_classes(torch.stack([u, u]), _t(np.stack([mix32, mix32])))
    np.testing.assert_array_equal(both.numpy(), np.stack([ref, ref]))


@pytest.mark.parametrize("k,d", [(30, 2), (30, 3), (12, 12), (5, 1), (100_000, 2)])
def test_subsets_are_distinct_with_uniform_marginals(k, d):
    t = 60_000 if k < 1000 else 4000
    gen = torch.Generator().manual_seed(k + d)
    sub = twork.distinct_subsets(gen, t, k, d).numpy()
    assert sub.shape == (t, d) and sub.dtype == np.int32
    assert sub.min() >= 0 and sub.max() < k
    srt = np.sort(sub, 1)
    assert np.all(srt[:, 1:] != srt[:, :-1])
    if k < 1000:
        counts = np.bincount(sub.ravel(), minlength=k)
        assert stats.chisquare(counts).pvalue > 1e-3
    if d == 2 and k < 1000:
        # Every pair equally likely too (Floyd's subsets are uniform).
        pairs = np.bincount(srt[:, 0] * k + srt[:, 1], minlength=k * k)
        pairs = pairs.reshape(k, k)[np.triu_indices(k, 1)]
        assert stats.chisquare(pairs).pvalue > 1e-3


def test_random_picks_are_uniform_over_the_eligible_set():
    k = 12
    aff = (tuple([True] * 8 + [False] * 4), tuple([False] * 9 + [True] * 3))
    cfg = tsim.SimConfig(servers=k, slots=40_000, policy="random", comm="none",
                         class_mix=(0.5, 0.5), class_affinity=aff)
    _, _, draws = tsim.draw_workload([0, 1], cfg.static_part(), [cfg.scenario()],
                                     torch.device("cpu"))
    pick, cls = draws["rand_pick"].numpy(), draws["classes"].numpy()
    assert pick.dtype == np.int32 and set(draws) == {"rand_pick", "classes"}
    for c, n_elig in enumerate((8, 3)):
        counts = np.bincount(pick[cls == c], minlength=n_elig)
        assert counts.size == n_elig
        assert stats.chisquare(counts).pvalue > 1e-3
    assert abs((cls == 0).mean() - 0.5) < 0.01
    # Unconstrained: uniform over the whole fleet.
    plain = tsim.SimConfig(servers=k, slots=40_000, policy="random", comm="none")
    _, _, draws = tsim.draw_workload([0], plain.static_part(), [plain.scenario()],
                                     torch.device("cpu"))
    counts = np.bincount(draws["rand_pick"].numpy().ravel(), minlength=k)
    assert counts.size == k and stats.chisquare(counts).pvalue > 1e-3


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


# The draws of draw_workload([0, 3], ...) for cells of the kinds ported
# before the policies and workloads of this module: (arrivals, sizes and
# Gumbels) digest, arrivals, sum of sizes.  Recorded from the draws as
# they were before those kinds were added, so that every earlier cell
# replays its draws.
REPLAY = {
    "jsaq_geometric_random_ties": (
        dict(servers=6, slots=300, policy="jsaq", comm="et"),
        ("bd0660d450d7d0c7", 576, 18629)),
    "jsq_deterministic_lowest_ties": (
        dict(servers=6, slots=300, policy="jsq", comm="dt", service="deterministic",
             mean_service=8, deterministic_ties=True),
        ("872001995f47fc8c", 576, 4800)),
    "rr_padded_horizon": (
        dict(servers=5, slots=200, max_slots=260, policy="rr", comm="none", load=0.7),
        ("e459bf94be3b144f", 293, 15383)),
    "fused": (
        dict(servers=6, slots=300, policy="jsaq", comm="dt", service="deterministic",
             mean_service=8, deterministic_ties=True, route_backend="fused"),
        ("e2e365227139f2ec", 576, None)),
}


@pytest.mark.parametrize("name", list(REPLAY))
def test_earlier_kinds_replay_their_draws(name):
    kw, (digest, n_arr, size_sum) = REPLAY[name]
    cfg = tsim.SimConfig(**kw)
    arrive, sizes, draws = tsim.draw_workload(
        [0, 3], cfg.static_part(), [cfg.scenario()], torch.device("cpu")
    )
    assert set(draws) <= {"gumbel"}
    assert _digest(arrive, sizes, draws.get("gumbel")) == digest
    assert int(arrive.sum()) == n_arr
    assert (None if sizes is None else int(sizes.sum())) == size_sum
