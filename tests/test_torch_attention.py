"""The port's grouped-query attention against ``repro.models.attention``.

For the reduced config of each dense GQA arch (float32), ``init_attention``
weights are copied into the port's :class:`Attention`; ``attention_full``
(prefill with its cache) and then ``attention_decode`` at a position past
the window run in both packages on the same numpy-seeded input; so do
whisper's options: cross-attention (``attention_full(kv_src=...)`` with S
!= T, ``precompute_cross_kv``, ``cross_attention_decode``) and non-causal
self-attention without RoPE (``causal=False``, ``use_rope=False``, and
``attention_decode(use_rope=False)``).  The JAX side runs with
``use_pallas_attention=True`` and a Python-int window, which is the branch
that reaches its Pallas kernel (in interpret mode on the CPU); the port's
``attention_full`` always goes through ``ops.flash_attention``, whose
plain version runs on a CPU tensor.

Tolerance: rtol 1e-4 / atol 1e-5, that of ``tests/test_torch_model_serve.py``:
both run in float32, and the matmuls and softmax sums run in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tfm

TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["gemma2-9b", "qwen3-0.6b", "qwen1.5-4b", "smollm-135m", "chameleon-34b"]
B, S, CACHE, WINDOW = 2, 256, 260, 16


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(JAX config, port config, JAX params, port module)."""
    jcfg = dataclasses.replace(jget(request.param).reduced(), use_pallas_attention=True)
    tcfg = tget(request.param).reduced()
    jp = jattn.init_attention(jcommon.KeyGen(jax.random.key(3)), jcfg)
    if jcfg.qkv_bias:  # init gives zero biases; make them count
        rng = np.random.default_rng(9)
        jp = {**jp, **{n: jnp.asarray(rng.standard_normal(jp[n].shape).astype(np.float32) * 0.1)
                       for n in ("bq", "bk", "bv")}}
    tp = tattn.Attention(tcfg, device="cpu")
    tp.load_state_dict({n: torch.from_numpy(np.array(a)) for n, a in jp.items()})
    return jcfg, tcfg, jp, tp


def _x(cfg, seed, s=S):
    return np.random.default_rng(seed).standard_normal((B, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("window", [WINDOW, tfm.BIG_WINDOW], ids=["window16", "big_window"])
def test_full_then_decode_match_jax(arch, window, monkeypatch):
    jcfg, tcfg, jp, tp = arch
    x = _x(tcfg, 1)
    calls = []
    pallas = jops.flash_attention
    monkeypatch.setattr(jops, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or pallas(*a, **kw))
    jo, jc = jattn.attention_full(jp, jnp.asarray(x), jcfg, window=window,
                                  return_cache=True, cache_len=CACHE)
    assert [c["window"] for c in calls] == [window]  # the JAX side ran its Pallas kernel
    before = tops.launch_counts()["flash_attention"]
    to, tc = tattn.attention_full(tp, torch.from_numpy(x), tcfg, window=window,
                                  return_cache=True, cache_len=CACHE)
    assert tops.launch_counts()["flash_attention"] == before  # the plain version on the CPU
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == (B, CACHE, tcfg.num_kv_heads, tcfg.resolved_head_dim)
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)

    x1 = _x(tcfg, 2, 1)
    for pos in (S, CACHE + 2):  # past the window; past the cache (the row clamps)
        jo, jc = jattn.attention_decode(jp, jnp.asarray(x1), jc, jnp.int32(pos), jcfg,
                                        window=window)
        to, tc = tattn.attention_decode(tp, torch.from_numpy(x1), tc, pos, tcfg, window=window)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)


def test_window_masks_in_prefill(arch):
    # The local window moves the output of every row past it.
    _, tcfg, _, tp = arch
    x = torch.from_numpy(_x(tcfg, 3, 64))
    local, _ = tattn.attention_full(tp, x, tcfg, window=WINDOW)
    glob, _ = tattn.attention_full(tp, x, tcfg, window=tfm.BIG_WINDOW)
    torch.testing.assert_close(local[:, :WINDOW], glob[:, :WINDOW], rtol=0, atol=0)
    assert float((local[:, WINDOW:] - glob[:, WINDOW:]).abs().min()) > 0


def _spy_flash(monkeypatch):
    """Record the options of every JAX Pallas and port flash_attention call."""
    calls = {"jax": [], "torch": []}
    for side, mod in (("jax", jops), ("torch", tops)):
        real = mod.flash_attention
        monkeypatch.setattr(mod, "flash_attention",
                            lambda *a, _real=real, _side=side, **kw:
                            calls[_side].append(kw) or _real(*a, **kw))
    return calls


def test_cross_attention_matches_jax(arch, monkeypatch):
    # S = 128 queries against T = 256 encoder rows (both multiples of 128,
    # so the JAX side runs its Pallas kernel): non-causal, no RoPE, no window.
    jcfg, tcfg, jp, tp = arch
    x, enc = _x(tcfg, 4, 128), _x(tcfg, 5, 256)
    calls = _spy_flash(monkeypatch)
    jo, _ = jattn.attention_full(jp, jnp.asarray(x), jcfg, window=WINDOW, kv_src=jnp.asarray(enc),
                                 causal=False, use_rope=False)
    to, tc = tattn.attention_full(tp, torch.from_numpy(x), tcfg, window=WINDOW,
                                  kv_src=torch.from_numpy(enc), causal=False, use_rope=False)
    assert [(c["causal"], c["window"]) for c in calls["jax"]] == [(False, None)]
    assert [(c["causal"], c["window"]) for c in calls["torch"]] == [(False, None)]
    assert tc is None and tuple(to.shape) == x.shape
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)

    jkv = jattn.precompute_cross_kv(jp, jnp.asarray(enc), jcfg)
    tkv = tattn.precompute_cross_kv(tp, torch.from_numpy(enc), tcfg)
    for name in ("k", "v"):
        assert tuple(tkv[name].shape) == (B, 256, tcfg.num_kv_heads, tcfg.resolved_head_dim)
        np.testing.assert_allclose(tkv[name].numpy(), np.asarray(jkv[name]), **TOL)
    x1 = _x(tcfg, 6, 1)
    jo = jattn.cross_attention_decode(jp, jnp.asarray(x1), jkv, jcfg)
    to = tattn.cross_attention_decode(tp, torch.from_numpy(x1), tkv, tcfg)
    assert len(calls["torch"]) == 1  # decode stays plain
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_noncausal_self_attention_without_rope_matches_jax(arch, monkeypatch):
    # Whisper's encoder (causal=False, use_rope=False: the window is not
    # passed) and its decoder's self-attention (causal, use_rope=False),
    # prefill and a decode step.
    jcfg, tcfg, jp, tp = arch
    x = _x(tcfg, 7)
    calls = _spy_flash(monkeypatch)
    jo, _ = jattn.attention_full(jp, jnp.asarray(x), jcfg, window=WINDOW, causal=False,
                                 use_rope=False)
    to, _ = tattn.attention_full(tp, torch.from_numpy(x), tcfg, window=WINDOW, causal=False,
                                 use_rope=False)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    jo, jc = jattn.attention_full(jp, jnp.asarray(x), jcfg, window=tfm.BIG_WINDOW,
                                  use_rope=False, return_cache=True, cache_len=CACHE)
    to, tc = tattn.attention_full(tp, torch.from_numpy(x), tcfg, window=tfm.BIG_WINDOW,
                                  use_rope=False, return_cache=True, cache_len=CACHE)
    assert [(c["causal"], c["window"]) for c in calls["torch"]] == [
        (False, None), (True, tfm.BIG_WINDOW)] == [(c["causal"], c["window"]) for c in calls["jax"]]
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    x1 = _x(tcfg, 8, 1)
    jo, jc = jattn.attention_decode(jp, jnp.asarray(x1), jc, jnp.int32(S), jcfg,
                                    window=tfm.BIG_WINDOW, use_rope=False)
    to, tc = tattn.attention_decode(tp, torch.from_numpy(x1), tc, S, tcfg,
                                    window=tfm.BIG_WINDOW, use_rope=False)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)
    # RoPE moves the output: the option is not ignored
    rope, _ = tattn.attention_full(tp, torch.from_numpy(x), tcfg, window=tfm.BIG_WINDOW)
    assert float((rope - to).abs().max()) > 1e-3
