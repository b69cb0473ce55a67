"""The plain log-sum-exp that the flash forward kernels write for the
backward, ``ref.flash_attention_lse_ref``, against the JAX package on the
CPU, on numpy-seeded inputs: ``jax.scipy.special.logsumexp`` of the scores
built as ``repro/kernels/ref.py:25-56`` builds them (float32, filled,
softcapped, scaled), ``+inf`` on a row with no key; and ``exp(s - lse) @ v``
against ``jref.flash_attention_ref``'s output on every row that has a key.
The cases are ``tests/test_torch_kernel_grads.py``'s: causal, windowed with
a softcap, non-causal with S != T, rows with no key, S = 1.  Tolerance:
rtol 1e-5 (both float32, sums in another order).  The forward kernels'
``lse`` is held against this plain version on the card
(``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

FLASH_LSE_CASES = [
    # b, s, t, h, kvh, dh, dv, kw
    (1, 40, 40, 4, 2, 16, 16, dict(causal=True)),
    (2, 33, 33, 6, 2, 8, 12, dict(causal=True, window=7, softcap=5.0)),
    (1, 17, 50, 4, 4, 8, 8, dict(causal=False)),
    (1, 60, 20, 2, 1, 8, 8, dict(causal=True, window=5)),  # rows 24.. have no key
    (1, 1, 9, 3, 1, 4, 4, dict(causal=True)),
]


def _jax_scores(q, k, *, scale, causal=True, window=None, softcap=0.0):
    """The filled scores ``(B, S, KVH, G, T)`` and the ``(S,)`` rows that
    have a key, as ``repro/kernels/ref.py:25-56`` builds them."""
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, dh)
    sc = jnp.einsum("bskgd,btkd->bskgt", qg, k, preferred_element_type=jnp.float32) * scale
    if softcap:
        sc = softcap * jnp.tanh(sc / softcap)
    has_key = np.ones(s, bool)
    if causal:
        qpos = jnp.arange(s, dtype=jnp.int32)[None, :, None, None, None]
        kpos = jnp.arange(t, dtype=jnp.int32)[None, None, None, None, :]
        ok = kpos <= qpos
        if window is not None:
            ok = ok & (qpos - kpos < window)
        sc = jnp.where(ok, sc, -1e30)
        has_key = np.asarray(ok.any(axis=-1)).reshape(s)
    return sc, has_key


def _inputs(b, s, t, h, kvh, dh, dv):
    rng = np.random.default_rng(7 * s + t)
    return (rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, dh), (b, t, kvh, dh), (b, t, kvh, dv)))


@pytest.mark.parametrize("b,s,t,h,kvh,dh,dv,kw", FLASH_LSE_CASES)
def test_flash_attention_lse_ref_matches_jax_logsumexp(b, s, t, h, kvh, dh, dv, kw):
    q, k, _ = _inputs(b, s, t, h, kvh, dh, dv)
    scale = dh ** -0.5
    sc, has_key = _jax_scores(jnp.asarray(q), jnp.asarray(k), scale=scale, **kw)
    want = np.asarray(jax.scipy.special.logsumexp(sc, axis=-1)).reshape(b, s, h)
    want = np.where(has_key[None, :, None], want, np.inf).transpose(0, 2, 1)
    got = tref.flash_attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k), scale=scale,
                                       **kw)
    assert got.shape == (b, h, s) and got.dtype == torch.float32
    np.testing.assert_array_equal(np.isinf(got.numpy()), ~has_key[None, None, :].repeat(
        h, axis=1).repeat(b, axis=0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("b,s,t,h,kvh,dh,dv,kw", FLASH_LSE_CASES)
def test_exp_of_scores_less_lse_gives_the_attention_output(b, s, t, h, kvh, dh, dv, kw):
    q, k, v = _inputs(b, s, t, h, kvh, dh, dv)
    scale = dh ** -0.5
    sc, has_key = _jax_scores(jnp.asarray(q), jnp.asarray(k), scale=scale, **kw)
    lse = tref.flash_attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k), scale=scale,
                                       **kw).numpy()
    g = h // kvh
    # lse (B, H, S) -> (B, S, KVH, G, 1), against the scores' layout
    lse5 = lse.transpose(0, 2, 1).reshape(b, s, kvh, g, 1)
    p = np.exp(np.asarray(sc) - lse5)
    out = np.einsum("bskgt,btkd->bskgd", p, v).reshape(b, s, h, dv)
    want = np.asarray(jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               scale=scale, **kw))
    np.testing.assert_allclose(out[:, has_key], want[:, has_key], rtol=1e-5, atol=1e-5)
    assert np.all(p[:, ~has_key] == 0)  # no key: the backward's p is 0
