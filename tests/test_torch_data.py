"""The port's data pipeline (``data/pipeline.py``) and elastic plans
(``train/elastic.py``) against the JAX package's on the CPU.

Tokens and labels at several steps, seeds, vocabularies, shard splits and
after ``skip_to``; the hash alone on numpy-seeded counters (equal); the
Zipf map on 2e6 uniforms.  The Zipf map takes a float32 power: the port
takes it correctly rounded, XLA's ``pow`` is not always, and a token moves
only where that ulp crosses an integer boundary.  This test found 0 of the
2e6 uniforms' tokens different at a vocabulary of 512 and 2 at 49,152 (each
by one id), and holds the bound of 10 in 2e6; every token of the batches
below is equal.  ``plan_mesh``, ``remesh_plan`` and
``StragglerMonitor`` on the same inputs give equal results.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro.train import elastic as jel
from repro_torch.data import pipeline as tpipe
from repro_torch.train import elastic as tel


def test_hash_is_equal():
    x = np.random.default_rng(0).integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(tpipe._hash_u32(x), np.asarray(jpipe._hash_u32(jnp.asarray(x))))


@pytest.mark.parametrize("vocab", [512, 49152])
def test_zipf_map_differs_at_most_at_ulp_edges(vocab):
    u = np.random.default_rng(vocab).random(2_000_000)
    got = tpipe._zipf_map(u, vocab, 1.2)
    want = np.asarray(jpipe._zipf_map(jnp.asarray(u), vocab, 1.2))
    diff = got != want
    assert diff.sum() <= 10, diff.sum()  # 5e-6 of the draws
    assert np.all(np.abs(got[diff].astype(np.int64) - want[diff]) == 1)


@pytest.mark.parametrize("vocab,seq,gb,seed", [(512, 32, 4, 0), (49152, 256, 8, 0),
                                               (102400, 64, 6, 3)])
def test_batches_equal_over_steps(vocab, seq, gb, seed):
    jc = jpipe.DataConfig(vocab_size=vocab, seq_len=seq, global_batch=gb, seed=seed)
    tc = tpipe.DataConfig(vocab_size=vocab, seq_len=seq, global_batch=gb, seed=seed)
    for step in (0, 1, 7, 1000):
        want, got = jpipe.global_batch_at(step, jc), tpipe.global_batch_at(step, tc)
        for key in ("tokens", "labels"):
            assert got[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("dp_size", [1, 2, 4])
def test_shards_and_skip_to(dp_size):
    cfg = tpipe.DataConfig(vocab_size=512, seq_len=16, global_batch=8)
    jcfg = jpipe.DataConfig(vocab_size=512, seq_len=16, global_batch=8)
    for rank in range(dp_size):
        tl = tpipe.ShardedLoader(cfg, rank, dp_size)
        jl = jpipe.ShardedLoader(jcfg, rank, dp_size)
        for _ in range(2):
            np.testing.assert_array_equal(next(tl)["tokens"], next(jl)["tokens"])
        tl.skip_to(9)
        jl.skip_to(9)
        np.testing.assert_array_equal(next(tl)["labels"], next(jl)["labels"])
        assert tl.step == jl.step == 10
    full = tpipe.global_batch_at(3, cfg)["tokens"]
    rows = [tpipe.shard_batch_at(3, cfg, r, dp_size)["tokens"] for r in range(dp_size)]
    np.testing.assert_array_equal(np.stack(rows, 1).reshape(full.shape), full)
    with pytest.raises(ValueError):
        tpipe.shard_batch_at(0, cfg, 0, 3)


@pytest.mark.parametrize("chips,kw", [(512, {}), (300, {}), (16, {}), (1000, dict(
    model_axis=8, chips_per_pod=128, global_batch=96)), (40, dict(model_axis=4, global_batch=6))])
def test_plan_mesh_and_remesh_equal(chips, kw):
    got, want = tel.plan_mesh(chips, **kw), jel.plan_mesh(chips, **kw)
    assert (got.pods, got.data, got.model, got.dropped_chips, got.chips) == (
        want.pods, want.data, want.model, want.dropped_chips, want.chips)
    old_t, old_j = tel.plan_mesh(512), jel.plan_mesh(512)
    assert tel.remesh_plan(old_t, got) == jel.remesh_plan(old_j, want)
    with pytest.raises(ValueError):
        tel.plan_mesh(3)


def test_straggler_monitor_equal():
    rng = np.random.default_rng(0)
    times = 1.0 + 0.05 * rng.standard_normal((40, 6))
    times[20:, 4] *= 2.5  # host 4 turns slow
    tm, jm = tel.StragglerMonitor(6, evict_after=3), jel.StragglerMonitor(6, evict_after=3)
    for row in times:
        for h, t in enumerate(row):
            assert tm.host_report(h, float(t)) == jm.host_report(h, float(t))
        assert tm.evictions() == jm.evictions()
    assert tm.message_rate == jm.message_rate
    assert 4 in tm.evictions() or tm.strikes[4] > 0
