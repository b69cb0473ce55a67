"""The port's dense GQA serving slice against ``repro.models.model`` on the CPU.

``init_params`` weights of the reduced config of each dense GQA arch
(float32) are carried across by ``params_from_jax``; then ``prefill`` and
one ``decode_step`` run in both packages on the same numpy-seeded tokens.
The prompt (24 tokens) is longer than the reduced Gemma2's window (16), so
its local layers mask in prefill, and the decode step at position 24 lies
past the window.  The port's prefill goes through ``ops.flash_attention``
(its plain version on the CPU) in every layer; the JAX scan passes a traced
window, so the reference runs its plain blocked attention.

Tolerance: logits and caches within rtol 1e-4 / atol 1e-5, that of
``tests/test_torch_model_serve.py``: both run in float32, and the matmuls
and softmax sums run in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import model as jmodel
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops as tops
from repro_torch.models import convert
from repro_torch.models import model as tmodel

TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["gemma2-9b", "qwen3-0.6b", "qwen1.5-4b", "smollm-135m", "chameleon-34b"]
B, S, CACHE = 2, 24, 28


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(JAX config, port config, JAX params, port model)."""
    jcfg, tcfg = jget(request.param).reduced(), tget(request.param).reduced()
    jp = jmodel.init_params(jax.random.key(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, seed=1, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s)).astype(np.int32)


def _close_cache(tc, jc):
    assert tc.keys() == jc.keys() == {"scan"}
    assert tc["scan"].keys() == jc["scan"].keys() == {"k", "v"}
    for name, t in tc["scan"].items():
        assert tuple(t.shape) == jc["scan"][name].shape, name
        np.testing.assert_allclose(t.numpy(), np.asarray(jc["scan"][name]), **TOL, err_msg=name)


def test_prefill_and_decode_match_jax(arch):
    jcfg, tcfg, jp, tp = arch
    tok = _tokens(tcfg)
    jl, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(tok)}, jcfg, cache_len=CACHE)
    tops.reset_launch_counts()
    tl, tc = tmodel.prefill(tp, {"tokens": torch.from_numpy(tok)}, tcfg, cache_len=CACHE)
    assert tops.launch_counts()["flash_attention"] == 0  # the plain version on the CPU
    assert tl.shape == (B, tcfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_cache(tc, jc)

    nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    jl, jc = jmodel.decode_step(jp, jnp.asarray(nxt), jc, jnp.int32(S), jcfg)
    tl, tc2 = tmodel.decode_step(tp, torch.from_numpy(nxt), tc, S, tcfg)
    assert tc2 is tc  # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_cache(tc, jc)


def test_prefill_then_decode_equals_longer_prefill(arch):
    # logits(prefill over S) against logits(prefill over S-1, then one
    # decode_step at S-1), as tests/test_arch_smoke.py checks the JAX package.
    _, tcfg, _, tp = arch
    tok = torch.from_numpy(_tokens(tcfg, seed=3))
    full, _ = tmodel.prefill(tp, {"tokens": tok}, tcfg, cache_len=CACHE)
    _, cache = tmodel.prefill(tp, {"tokens": tok[:, :-1]}, tcfg, cache_len=CACHE)
    step, _ = tmodel.decode_step(tp, tok[:, -1], cache, S - 1, tcfg)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=2e-2, atol=2e-2)


def test_init_decode_cache_layout(arch):
    jcfg, tcfg, jp, tp = arch
    jc = jmodel.init_decode_cache(jp, jcfg, B, CACHE)
    tc = tmodel.init_decode_cache(tp, tcfg, B, CACHE)
    _close_cache(tc, jc)
    shape = (tcfg.num_layers, B, CACHE, tcfg.num_kv_heads, tcfg.resolved_head_dim)
    assert tuple(tc["scan"]["k"].shape) == shape and tc["scan"]["k"].dtype == torch.float32


def test_decode_from_an_empty_cache_matches_jax(arch):
    jcfg, tcfg, jp, tp = arch
    tok = _tokens(tcfg, seed=2)[:, 0]
    jc = jmodel.init_decode_cache(jp, jcfg, B, CACHE)
    tc = tmodel.init_decode_cache(tp, tcfg, B, CACHE)
    jl, _ = jmodel.decode_step(jp, jnp.asarray(tok), jc, jnp.int32(0), jcfg)
    tl, _ = tmodel.decode_step(tp, torch.from_numpy(tok), tc, 0, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_converter_maps_leaves_one_to_one(arch):
    jcfg, tcfg, jp, tp = arch
    flat = dict(convert._flatten(jax.tree.map(np.asarray, jp)))
    stacked = [name for name in flat if name.startswith("layers.")]
    params = dict(tp.named_parameters())
    assert len(params) == len(flat) + (tcfg.num_layers - 1) * len(stacked)
    for name, arr in flat.items():
        if name in stacked:
            for i in range(tcfg.num_layers):
                np.testing.assert_array_equal(
                    params[f"layers.{i}.{name[len('layers.'):]}"].numpy(), arr[i])
        else:
            np.testing.assert_array_equal(params[name].numpy(), arr)
    attn = {n.split(".")[-1] for n in params if ".attn." in n}
    want = {"wq", "wk", "wv", "wo"}
    want |= {"bq", "bk", "bv"} if tcfg.qkv_bias else set()
    want |= {"q_norm", "k_norm"} if tcfg.qk_norm else set()
    assert attn == want
    assert ("lm_head" in params) != tcfg.tie_embeddings
    assert any(".ln1_post." in n for n in params) == tcfg.post_norms


def test_init_params_on_the_cpu(arch):
    _, tcfg, _, tp = arch
    fresh = tmodel.init_params(torch.Generator(device="cpu").manual_seed(0), tcfg, device="cpu")
    shapes = {n: (p.shape, p.dtype) for n, p in fresh.named_parameters()}
    assert shapes == {n: (p.shape, p.dtype) for n, p in tp.named_parameters()}
