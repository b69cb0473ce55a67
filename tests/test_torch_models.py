"""The port's model blocks against ``repro.models`` on the CPU.

Each block runs in both packages on the same numpy-seeded input, with the
JAX package's random weights carried across by
``repro_torch.models.convert.params_from_jax``.  Everything is float32 and
the sums run in another order (blocked matmuls, softmax), so outputs are
compared within rtol 1e-4 / atol 1e-5: a few float32 ulps of the
accumulated dot products of width <= 256 at the reduced sizes.  Routed
expert ids and counts must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import flash as jflash
from repro.models import mla as jmla
from repro.models import model as jmodel
from repro_torch.configs import get_config as tget
from repro_torch.models import common as tcommon
from repro_torch.models import convert
from repro_torch.models import ffn as tffn
from repro_torch.models import flash as tflash
from repro_torch.models import mla as tmla
from torch_ranks import one_rank

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "deepseek-v2-236b"


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _models(**overrides):
    """The reduced config's JAX parameters and the port's copy of them."""
    jcfg = dataclasses.replace(jget(ARCH).reduced(), **overrides)
    tcfg = dataclasses.replace(tget(ARCH).reduced(), **overrides)
    jp = jmodel.init_params(jax.random.key(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def models():
    return _models()


def _layer(jp, i):
    return jax.tree.map(lambda a: a[i], jp["layers"])


def test_rms_norm():
    x, s = _rand((3, 5, 64), 0), _rand((64,), 1)
    _close(tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))


@pytest.mark.parametrize("theta", [10_000.0, 1e6])
def test_apply_rope_interleaved(theta):
    x = _rand((2, 7, 3, 16), 2)
    pos = np.random.default_rng(3).integers(0, 5000, (2, 7)).astype(np.int32)
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    # Position 0 is the identity, and the pairs are (0, 1), (2, 3), ...
    x0 = torch.from_numpy(x)
    assert torch.equal(tcommon.apply_rope(x0, torch.zeros((2, 7), dtype=torch.int32), theta), x0)


@pytest.mark.parametrize(
    "t,kv_block,window,softcap",
    [(32, None, None, 0.0), (64, 16, None, 0.0), (64, 16, 20, 0.0), (64, 32, None, 30.0)],
)
def test_flash_sdpa_dense_and_blocked(t, kv_block, window, softcap):
    # kv_block=None with T=32 takes the dense path; a small kv_block reaches
    # the blocked online softmax.
    b, h, kvh, dh = 2, 4, 2, 16
    q, k, v = (_rand(s, i) for i, s in enumerate([(b, t, h, dh), (b, t, kvh, dh), (b, t, kvh, dh)]))
    kw = dict(scale=dh ** -0.5, causal=True, window=window, softcap=softcap, kv_block=kv_block)
    got = tflash.flash_sdpa(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    _close(got, jflash.flash_sdpa(*(jnp.asarray(a) for a in (q, k, v)), **kw))


def test_flash_sdpa_non_causal():
    q, k, v = _rand((1, 8, 2, 8), 5), _rand((1, 8, 2, 8), 6), _rand((1, 8, 2, 8), 7)
    kw = dict(scale=0.3, causal=False)
    got = tflash.flash_sdpa(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    _close(got, jflash.flash_sdpa(*(jnp.asarray(a) for a in (q, k, v)), **kw))


def test_mla_full_and_decode(models):
    jcfg, tcfg, jp, tp = models
    jl, tl = _layer(jp, 0)["attn"], tp.layers[0].attn
    x = _rand((2, 12, tcfg.d_model), 8)
    jo, jc = jmla.mla_full(jl, jnp.asarray(x), jcfg, return_cache=True, cache_len=16)
    to, tc = tmla.mla_full(tl, torch.from_numpy(x), tcfg, return_cache=True, cache_len=16)
    _close(to, jo)
    for name in ("ckv", "k_rope"):
        _close(tc[name], jc[name])
    xt = _rand((2, 1, tcfg.d_model), 9)
    jo, jc = jmla.mla_decode(jl, jnp.asarray(xt), jc, jnp.int32(12), jcfg)
    to, tc = tmla.mla_decode(tl, torch.from_numpy(xt), tc, 12, tcfg)
    _close(to, jo)
    for name in ("ckv", "k_rope"):
        _close(tc[name], jc[name])


@pytest.mark.parametrize("pos", [15, 16, 40])
def test_mla_decode_clamps_past_the_cache(models, pos):
    # lax.dynamic_update_slice clamps its start: a position at or past the
    # cache's end overwrites the last row.
    jcfg, tcfg, jp, tp = models
    jl, tl = _layer(jp, 0)["attn"], tp.layers[0].attn
    r, dr = tcfg.kv_lora_rank, tcfg.qk_rope_head_dim
    ckv, kr = _rand((2, 16, r), 10), _rand((2, 16, dr), 11)
    xt = _rand((2, 1, tcfg.d_model), 12)
    jo, jc = jmla.mla_decode(jl, jnp.asarray(xt), {"ckv": jnp.asarray(ckv), "k_rope": jnp.asarray(kr)},
                             jnp.int32(pos), jcfg)
    tc = {"ckv": torch.from_numpy(ckv.copy()), "k_rope": torch.from_numpy(kr.copy())}
    to, tc = tmla.mla_decode(tl, torch.from_numpy(xt), tc, pos, tcfg)
    _close(to, jo)
    for name in ("ckv", "k_rope"):
        _close(tc[name], jc[name])
    np.testing.assert_array_equal(tc["ckv"][:, :15].numpy(), ckv[:, :15])
    assert not np.array_equal(tc["ckv"][:, 15].numpy(), ckv[:, 15])


def test_dense_ffn(models):
    jcfg, tcfg, jp, tp = models
    x = _rand((2, 5, tcfg.d_model), 13)
    got = tffn.dense_ffn(tp.head_layers["0"].ffn, torch.from_numpy(x), tcfg)
    _close(got, jffn.dense_ffn(jp["head_layers"]["0"]["ffn"], jnp.asarray(x), jcfg))


def _spy_routes(monkeypatch):
    """Record each (idx, weights, counts) the JAX package's MoE layers route
    and each (idx, weights, counts, pos) the port's route and place."""
    seen = {"jax": [], "torch": []}
    j_route, t_route = jffn._route, tffn._route

    def j_spy(logits, bias, cfg):
        out = j_route(logits, bias, cfg)
        seen["jax"].append([np.asarray(a) for a in out])
        return out

    def t_spy(logits, bias, cfg):
        out = t_route(logits, bias, cfg)
        seen["torch"].append([a.numpy() for a in out])
        return out

    monkeypatch.setattr(jffn, "_route", j_spy)
    monkeypatch.setattr(tffn, "_route", t_spy)
    return seen


def _reference_positions(idx: np.ndarray, e: int) -> np.ndarray:
    """The reference's capacity positions (``repro/models/ffn.py:110-114``)
    on the JAX package's ids."""
    onehot = jax.nn.one_hot(jnp.asarray(idx).reshape(-1), e, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    return np.asarray(jnp.sum(pos * onehot, axis=1))


@pytest.mark.parametrize("factor", [4.0, 1.0])
@pytest.mark.parametrize("biased", [False, True])
def test_moe_ffn(monkeypatch, factor, biased):
    # factor 1.0 gives capacity T*k/E, so a skewed gate overflows experts:
    # their (token, slot) pairs go to the sink row in both packages.
    jcfg, tcfg, jp, tp = _models(moe_capacity_factor=factor)
    seen = _spy_routes(monkeypatch)
    x = _rand((2, 16, tcfg.d_model), 14)
    bias = _rand((tcfg.n_routed_experts,), 15, scale=2.0 if biased else 0.0)
    for layer in range(len(tp.layers)):
        jy, jcnt = jffn.moe_ffn(_layer(jp, layer)["moe"], jnp.asarray(x), jnp.asarray(bias), jcfg)
        ty, tcnt = tffn.moe_ffn(tp.layers[layer].moe, torch.from_numpy(x), torch.from_numpy(bias),
                                tcfg)
        _close(ty, jy)
        np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
        assert tcnt.dtype == torch.float32
    for (ti, tw, tc, tpos), (ji, jw, jc) in zip(seen["torch"], seen["jax"], strict=True):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_allclose(tw, jw, **TOL)
        np.testing.assert_array_equal(tpos, _reference_positions(ji, tcfg.n_routed_experts))
    cap = tffn._capacity(32, tcfg.moe_top_k, tcfg.n_routed_experts, factor)
    over = max(int(c.max()) for _, _, c, _ in seen["torch"]) > cap
    assert over == (factor == 1.0), (cap, [c.max() for _, _, c, _ in seen["torch"]])


@pytest.mark.parametrize("t,k,e,factor", [(32, 2, 8, 1.0), (2048, 6, 160, 1.5), (4, 6, 160, 1.5)])
def test_capacity(t, k, e, factor):
    assert tffn._capacity(t, k, e, factor) == jffn._capacity(t, k, e, factor)


def test_moe_takes_a_parallel_context(models, tmp_path):
    """On a (1, 1) mesh (one expert-parallel rank: the reference's
    single-device path) ``moe_ffn`` gives the ``ctx=None`` result and the
    counts as one dispatcher's ``(1, 1, E)`` row."""
    _, tcfg, _, tp = models
    x = torch.from_numpy(_rand((2, 16, tcfg.d_model), 14))
    bias = torch.from_numpy(_rand((tcfg.n_routed_experts,), 15, scale=2.0))
    want_y, want_c = tffn.moe_ffn(tp.layers[0].moe, x, bias, tcfg)
    with one_rank(tmp_path / "store", tcfg.n_routed_experts) as ctx:
        y, c = tffn.moe_ffn(tp.layers[0].moe, x, bias.reshape(1, 1, -1), tcfg, ctx)
    assert torch.equal(y, want_y)
    assert torch.equal(c, want_c.reshape(1, 1, -1))
