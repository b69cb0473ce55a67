"""The port's ``ops.flash_attention`` against the JAX package, on the CPU.

On a CPU tensor the port's wrapper runs its plain version
(``repro_torch.kernels.ref.flash_attention_ref``); it is held against the
JAX Pallas kernel in interpret mode (``repro.kernels.ops.flash_attention(...,
interpret=True)``) and against the JAX oracle ``repro.kernels.ref.
flash_attention_ref``, on the same numpy-seeded inputs.  The cases are
those of ``tests/test_flash_kernel.py``; ragged shapes, which the Pallas
kernel refuses and the port's kernel takes, are held against the JAX
oracle only.  Tolerances: 2e-5 in float32 and 2e-2 in bfloat16 (those of
``tests/test_flash_kernel.py``): the sums run in another order and, in
bfloat16, the probabilities round before the product with V.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _qkv(seed, b, s, t, h, kvh, dh, dv):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, dh), (b, t, kvh, dh), (b, t, kvh, dv))]


def _port(arrays, dtype, **kw):
    ts = [torch.from_numpy(a).to(dtype) for a in arrays]
    before = tops.launch_counts()["flash_attention"]
    out = tops.flash_attention(*ts, **kw)
    assert tops.launch_counts()["flash_attention"] == before  # the plain version
    return out.float().numpy()


def _jax(arrays, dtype, fn, **kw):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    out = fn(*(jnp.asarray(a, jdt) for a in arrays), **kw)
    return np.asarray(out.astype(jnp.float32))


def _check(arrays, dtype, pallas: bool, **kw):
    kw.setdefault("scale", 1.0 / arrays[0].shape[-1] ** 0.5)
    got = _port(arrays, dtype, **kw)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    want = _jax(arrays, dtype, jref.flash_attention_ref, **kw)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if pallas:
        want = _jax(arrays, dtype, jops.flash_attention, interpret=True, **kw)
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    b, s, h, _ = arrays[0].shape
    assert got.shape == (b, s, h, arrays[2].shape[-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("s,t", [(128, 128), (128, 256), (256, 128)])
def test_causal(dtype, s, t):
    _check(_qkv(0, 2, s, t, 4, 4, 64, 64), dtype, True, causal=True)


@pytest.mark.parametrize("g", [2, 4])
def test_gqa(g):
    _check(_qkv(1, 1, 128, 256, 4, 4 // g, 32, 32), torch.float32, True, causal=True)


def test_window():
    _check(_qkv(2, 1, 256, 256, 2, 2, 64, 64), torch.float32, True, causal=True, window=100)


def test_softcap():
    _check(_qkv(3, 1, 128, 128, 2, 2, 64, 64), torch.float32, True, causal=True, softcap=50.0)


def test_non_causal():
    _check(_qkv(4, 1, 128, 256, 2, 2, 64, 128), torch.float32, True, causal=False)


@pytest.mark.parametrize(
    "b,s,t,h,kvh,dh,dv,kw",
    [
        (1, 96, 128, 2, 2, 64, 64, dict(causal=True)),
        (1, 200, 200, 4, 2, 32, 32, dict(causal=True, window=37, softcap=50.0)),
        (2, 1, 300, 4, 2, 16, 16, dict(causal=False)),
        (1, 1, 300, 4, 2, 16, 16, dict(causal=True, window=1 << 30)),
        (1, 300, 100, 2, 1, 16, 16, dict(causal=True, window=20)),  # rows with no key
        (1, 130, 70, 6, 2, 8, 12, dict(causal=True)),  # GQA 3, dv != dh
    ],
    ids=["s96", "window37_softcap", "s1_non_causal", "s1_big_window", "s_over_t_window",
         "gqa3"],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ragged_shapes_against_the_oracle(b, s, t, h, kvh, dh, dv, kw, dtype):
    _check(_qkv(5, b, s, t, h, kvh, dh, dv), dtype, False, **kw)


def test_plain_version_keeps_the_jax_numerics():
    # bf16 p before the PV product, float32 scores, output in q's dtype.
    arrays = _qkv(6, 1, 64, 64, 2, 2, 32, 32)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    out = tref.flash_attention_ref(q, k, v, scale=0.2, causal=True)
    assert out.dtype == torch.bfloat16
    want = jref.flash_attention_ref(*(jnp.asarray(a, jnp.bfloat16) for a in arrays),
                                    scale=0.2, causal=True)
    np.testing.assert_array_equal(
        out.float().numpy(), np.asarray(want).astype(ml_dtypes.bfloat16).astype(np.float32)
    )


def test_window_must_be_a_positive_int():
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 1, 8, 8, 2, 2, 8, 8))
    for bad in (0, -3, 2.5, 1 << 31):
        with pytest.raises(ValueError, match="window"):
            tops.flash_attention(q, k, v, scale=1.0, window=bad)
