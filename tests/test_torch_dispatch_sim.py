"""The port's multi-dispatcher MoE dispatch simulation against the JAX package.

The port's step takes its standard normals as inputs; the bridge below
replays the reference's key splits (``_sim_core``: ``k_base, k_scan =
split(key)``, the skew from ``k_base``, one key a step from ``k_scan``, each
split into the walk's and the noise's) and hands the same normals to
``run_draws``.  Per-step routed counts, per-step backlog and gap, the
largest error and the message count must equal the reference's on every
regime at a small width (E 16, D 3, T 32, k 4, 120 steps).

Tolerance.  None is applied, and the reason it can be zero is stated here:
XLA on the CPU folds ``drift * sqrt(2)`` (the normal's own scale) into one
constant and contracts the walk's and the noise's multiply-adds into fused
multiply-adds, so the port's preference walk and logits, built from the
rounded normals, can differ from the reference's by an ulp.  Those ulps
enter only the scores, where they would change a count only by flipping a
near-tie at the k-th place; the counts are asserted equal step by step, and
every quantity downstream of them (queues, bias, error, trigger) is then
computed in the reference's float32 order (``dispatch_sim`` module
docstring).  At widths whose mean XLA sums in another order (E = 64) the
backlog and bias can differ in the last bits; that width runs on the card,
held against the port's own CPU run (``chip_smoke.py`` phase 3c).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import dispatch_sim as jds
from repro_torch.core import dispatch_sim as tds

SMALL = dict(experts=16, dispatchers=3, tokens_per_step=32, top_k=4, steps=120)
REGIMES = {
    "exact": dict(comm="exact", x=1),
    "dt3": dict(comm="dt", x=3),
    "et2": dict(comm="et", x=2),
    "et4": dict(comm="et", x=4),
    "off": dict(comm="off"),
    "no_bias": dict(comm="off", enabled=False),
}


def _bridge(seed: int, cfg: jds.DispatchSimConfig):
    """The reference's raw normals: ``(base (E,), walk (S, D, E), noise (S, D, T, E))``."""
    d, e, t = cfg.dispatchers, cfg.experts, cfg.tokens_per_step
    k_base, k_scan = jax.random.split(jax.random.key(seed))
    base = np.asarray(jax.random.normal(k_base, (e,)))
    walk, noise = [], []
    for skey in jax.random.split(k_scan, cfg.steps):
        k1, k2 = jax.random.split(skey)
        walk.append(np.asarray(jax.random.normal(k1, (d, e))))
        noise.append(np.asarray(jax.random.normal(k2, (d, t, e))))
    return base, np.stack(walk), np.stack(noise)


def _port(seeds, kw):
    """The port's ``run_draws`` on the reference's normals, one run a seed."""
    cfg = tds.DispatchSimConfig(**kw)
    bridged = [_bridge(s, jds.DispatchSimConfig(**kw)) for s in seeds]
    base = torch.from_numpy(np.stack([b[0] for b in bridged]))
    walk = torch.from_numpy(np.stack([b[1] for b in bridged]))
    noise = torch.from_numpy(np.stack([b[2] for b in bridged]))
    draws = ((walk[:, s], noise[:, s]) for s in range(cfg.steps))
    return tds.run_draws(base, draws, cfg), cfg


def _reference_with_counts(seed: int, cfg: jds.DispatchSimConfig, monkeypatch):
    """The reference's outputs and its per-step ``(D, E)`` counts, recorded
    from inside its scan by a callback on ``lax.top_k``'s indices."""
    seen = []
    top_k = jax.lax.top_k

    def recording_top_k(score, k):
        vals, idx = top_k(score, k)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), idx, ordered=True)
        return vals, idx

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    out = jax.jit(jds._sim_core, static_argnums=(1,))(jax.random.key(seed), cfg)
    jax.effects_barrier()
    monkeypatch.undo()
    backlog, gap, errs, msgs = (np.asarray(o) for o in out)
    counts = np.stack([
        np.stack([np.bincount(row.ravel(), minlength=cfg.experts) for row in idx])
        for idx in seen
    ]).astype(np.float32)
    return backlog, gap, errs, int(msgs), counts


@pytest.mark.parametrize("name", list(REGIMES))
def test_regime_matches_the_reference_step_by_step(name, monkeypatch):
    kw = {**SMALL, **REGIMES[name]}
    jcfg = jds.DispatchSimConfig(**kw)
    backlog, gap, errs, msgs, counts = _reference_with_counts(0, jcfg, monkeypatch)
    # The recording callback leaves the reference's numbers as they were.
    plain = jds.simulate(0, jcfg)
    np.testing.assert_array_equal(plain.gap, gap)
    assert plain.messages == msgs
    raw, cfg = _port([0], kw)
    np.testing.assert_array_equal(raw["counts"][0].numpy(), counts)
    np.testing.assert_array_equal(raw["backlog"][0].numpy(), backlog)
    np.testing.assert_array_equal(raw["gap"][0].numpy(), gap)
    np.testing.assert_array_equal(raw["err"][0].numpy(), errs)
    assert int(raw["msgs"][0]) == msgs
    got = tds.results(raw, cfg)[0]
    for f in dataclasses.fields(jds.DispatchSimResult):
        want = getattr(plain, f.name)
        if f.name == "transient_gap" and np.isnan(want):
            assert np.isnan(got.transient_gap)
        else:
            np.testing.assert_array_equal(getattr(got, f.name), want, err_msg=f.name)
    if name == "exact":
        assert msgs == cfg.dispatchers * cfg.steps
    if name in ("off", "no_bias"):
        assert msgs == 0


def test_batch_of_seeds_matches_each_reference_seed():
    kw = {**SMALL, "comm": "et", "x": 2}
    raw, cfg = _port([3, 11], kw)
    want = jds.dispatch_batch([3, 11], jds.DispatchSimConfig(**kw))
    for i, ref in enumerate(want):
        np.testing.assert_array_equal(raw["gap"][i].numpy(), ref.gap)
        np.testing.assert_array_equal(raw["backlog"][i].numpy(), ref.backlog)
        assert int(raw["msgs"][i]) == ref.messages
        assert float(raw["err"][i].max()) == ref.max_err


def test_planted_ties_go_to_the_lowest_index(monkeypatch):
    # No skew, walk or noise: every score of the first step ties, and the
    # top-k takes experts 0..k-1 for every token, as lax.top_k does.
    kw = {**SMALL, "comm": "et", "x": 2, "base_skew": 0.0, "drift": 0.0, "noise": 0.0}
    raw, cfg = _port([0], kw)
    first = raw["counts"][0, 0].numpy()
    want = np.zeros((cfg.dispatchers, cfg.experts), np.float32)
    want[:, : cfg.top_k] = cfg.tokens_per_step
    np.testing.assert_array_equal(first, want)
    _, gap, _, msgs, counts = _reference_with_counts(0, jds.DispatchSimConfig(**kw),
                                                     monkeypatch)
    np.testing.assert_array_equal(raw["counts"][0].numpy(), counts)
    np.testing.assert_array_equal(raw["gap"][0].numpy(), gap)
    assert int(raw["msgs"][0]) == msgs


def test_config_maps_onto_the_shared_core():
    for kw in REGIMES.values():
        ref = jds.DispatchSimConfig(**SMALL, **kw)
        got = tds.DispatchSimConfig(**SMALL, **kw)
        assert got.mu == ref.mu
        a, b = got.comm_config(), ref.comm_config()
        assert (a.kind, a.x, a.rt_period) == (b.kind, b.x, b.rt_period)
    with pytest.raises(ValueError, match="unknown comm mode"):
        tds.DispatchSimConfig(comm="sometimes").comm_config()


def test_own_sampler_batch_equals_single_runs():
    cfg = tds.DispatchSimConfig(**{**SMALL, "steps": 60, "comm": "et", "x": 2})
    batch = tds.dispatch_batch([0, 5], cfg, device="cpu")
    for seed, got in zip((0, 5), batch):
        one = tds.simulate(seed, cfg, device="cpu")
        np.testing.assert_array_equal(got.gap, one.gap)
        np.testing.assert_array_equal(got.backlog, one.backlog)
        assert (got.messages, got.max_err) == (one.messages, one.max_err)
    assert batch[0].messages > 0 and np.isfinite(batch[0].tail_gap)
    with pytest.raises(ValueError, match="cover 5 steps"):
        tds.run_draws(torch.zeros(1, cfg.experts),
                      iter([(torch.zeros(1, 3, 16), torch.zeros(1, 3, 32, 16))] * 5), cfg)
