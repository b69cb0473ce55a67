"""The plain backward versions of the two kernels that training runs,
``ref.flash_attention_bwd_ref`` and ``ref.moe_route_weights_vjp_ref``,
against ``jax.vjp`` of the JAX package's plain versions on the CPU, on
numpy-seeded inputs: causal, windowed with a softcap, non-causal with
S != T, rows with no key, S = 1; softmax and sigmoid gates, a top-k of
every expert, and all-tied logits.  Tolerance: rtol 1e-5 (both float32,
sums in another order).  The CUDA kernels are held against these on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 9).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

FLASH_BWD_CASES = [
    # b, s, t, h, kvh, dh, dv, kw
    (1, 40, 40, 4, 2, 16, 16, dict(causal=True)),
    (2, 33, 33, 6, 2, 8, 12, dict(causal=True, window=7, softcap=5.0)),
    (1, 17, 50, 4, 4, 8, 8, dict(causal=False)),
    (1, 60, 20, 2, 1, 8, 8, dict(causal=True, window=5)),  # rows 24.. have no key
    (1, 1, 9, 3, 1, 4, 4, dict(causal=True)),
]


@pytest.mark.parametrize("b,s,t,h,kvh,dh,dv,kw", FLASH_BWD_CASES)
def test_flash_attention_bwd_ref_matches_jax_vjp(b, s, t, h, kvh, dh, dv, kw):
    rng = np.random.default_rng(s * t)
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, kvh, dv)).astype(np.float32)
    do = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    scale = dh ** -0.5
    _, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(q, k, v, scale=scale, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = tref.flash_attention_bwd_ref(*(torch.from_numpy(x) for x in (q, k, v, do)),
                                       scale=scale, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gate_fn", ["softmax", "sigmoid"])
@pytest.mark.parametrize("t,e,k,ties", [(37, 16, 4, False), (5, 8, 8, False), (9, 6, 3, True)])
def test_moe_route_weights_vjp_ref_matches_jax(gate_fn, t, e, k, ties):
    rng = np.random.default_rng(t * e)
    logits = np.zeros((t, e), np.float32) if ties else rng.standard_normal((t, e)).astype(
        np.float32)
    bias = (0.1 * rng.standard_normal(e)).astype(np.float32)
    gw = rng.standard_normal((t, k)).astype(np.float32)
    idx = np.asarray(jref.moe_route_ref(jnp.asarray(logits), jnp.asarray(bias), k, gate_fn)[0])
    _, vjp = jax.vjp(lambda x: jref.moe_route_ref(x, jnp.asarray(bias), k, gate_fn)[1],
                     jnp.asarray(logits))
    (want,) = vjp(jnp.asarray(gw))
    got = tref.moe_route_weights_vjp_ref(torch.from_numpy(logits), torch.from_numpy(idx.copy()),
                                         torch.from_numpy(gw), gate_fn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    if gate_fn == "sigmoid":  # the experts not chosen take nothing
        chosen = np.zeros((t, e), bool)
        np.put_along_axis(chosen, idx, True, axis=1)
        assert np.all(got.numpy()[~chosen] == 0)
