"""The port's AdamW (``optim/adamw.py``) and error-feedback compression
(``optim/compression.py``) against the JAX package's on the CPU.

The same numpy-seeded parameters, gradients and moments go through both:
the schedule over warmup, the cosine and its end; global-norm clipping on
and off; several AdamW steps over float32 and bfloat16 parameters (float32
moments); top-k compression with the residual carried over steps, and a
tensor whose k-th magnitude is tied (``>=`` keeps every tie).

Tolerance: float32 within rtol 1e-6 / atol 1e-7 (the same operations in
the same order; XLA's and PyTorch's ``pow`` may differ by an ulp in the
bias corrections); bfloat16 parameters within one bfloat16 ulp (rtol
2**-7), since a float32 difference that small can round either way; the
compression masks and kept counts equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp

CFG = dict(lr=1e-2, warmup_steps=3, total_steps=9, weight_decay=0.1, clip_norm=1.0)
SHAPES = {"a": (4, 6), "b": (7,), "c": (2, 3, 5)}


class _Params(torch.nn.Module):
    def __init__(self, arrays: dict, dtype):
        super().__init__()
        for n, a in arrays.items():
            self.register_parameter(n, torch.nn.Parameter(torch.from_numpy(a).to(dtype)))


def _arrays(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {n: (scale * rng.standard_normal(s)).astype(np.float32) for n, s in SHAPES.items()}


@pytest.mark.parametrize("step", [0, 1, 2, 3, 5, 9, 20])
def test_schedule_matches_jax(step):
    for cfg in (CFG, dict(CFG, warmup_steps=0, total_steps=1)):
        want = float(jadamw.schedule(jnp.int32(step), jadamw.OptimConfig(**cfg)))
        got = float(tadamw.schedule(torch.tensor(step, dtype=torch.int32),
                                    tadamw.OptimConfig(**cfg)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_norm_matches_jax(scale):
    g = _arrays(1, scale)
    jg, jn = jadamw.clip_by_global_norm({n: jnp.asarray(a) for n, a in g.items()}, 1.0)
    tg, tn = tadamw.clip_by_global_norm({n: torch.from_numpy(a) for n, a in g.items()}, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for n in g:
        np.testing.assert_allclose(tg[n].numpy(), np.asarray(jg[n]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_steps_match_jax(dtype):
    cfg = dict(CFG)
    jcfg, tcfg = jadamw.OptimConfig(**cfg), tadamw.OptimConfig(**cfg)
    p0 = _arrays(0)
    jp = {n: jnp.asarray(a).astype(dtype) for n, a in p0.items()}
    tp = _Params(p0, getattr(torch, dtype))
    js, ts = jadamw.init(jp), tadamw.init(tp)
    for step in range(5):
        g = _arrays(10 + step, scale=3.0 if step == 1 else 0.1)  # step 1 clips
        jp, js, jm = jadamw.update({n: jnp.asarray(a).astype(dtype) for n, a in g.items()},
                                   js, jp, jcfg)
        tg = {n: torch.from_numpy(a).to(getattr(torch, dtype)) for n, a in g.items()}
        _, ts, tm = tadamw.update(tg, ts, tp, tcfg)
        assert int(ts.step) == int(js.step) == step + 1 and ts.step.dtype == torch.int32
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        for n in SHAPES:
            np.testing.assert_allclose(ts.m[n].numpy(), np.asarray(js.m[n]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(ts.v[n].numpy(), np.asarray(js.v[n]), rtol=1e-6,
                                       atol=1e-9)
            got = getattr(tp, n).detach().float().numpy()
            want = np.asarray(jp[n].astype(jnp.float32))
            rtol = 1e-6 if dtype == "float32" else 2.0**-7
            np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)


def test_compression_matches_jax_over_steps():
    jr = jcomp.init({n: jnp.zeros(s) for n, s in SHAPES.items()})
    tr = tcomp.init(_Params({n: np.zeros(s, np.float32) for n, s in SHAPES.items()},
                            torch.float32))
    for step in range(3):
        g = _arrays(20 + step)
        js, jr, jst = jcomp.compress({n: jnp.asarray(a) for n, a in g.items()}, jr, 0.2)
        ts, tr, tst = tcomp.compress({n: torch.from_numpy(a) for n, a in g.items()}, tr, 0.2)
        for n in SHAPES:
            np.testing.assert_array_equal(ts[n].numpy() != 0, np.asarray(js[n]) != 0)
            np.testing.assert_allclose(ts[n].numpy(), np.asarray(js[n]), rtol=1e-6)
            np.testing.assert_allclose(tr[n].numpy(), np.asarray(jr[n]), rtol=1e-6, atol=1e-7)
        assert float(tst["compressed_bytes"]) == float(jst["compressed_bytes"])
        assert tst["dense_bytes"] == jst["dense_bytes"]
        np.testing.assert_allclose(float(tst["kept_fraction"]), float(jst["kept_fraction"]))


def test_compression_keeps_ties():
    g = np.array([3.0, -3.0, 1.0, 3.0, 0.5, -2.0, 3.0, 0.0], np.float32)  # k = 2, four 3s
    js, _, jst = jcomp.compress({"x": jnp.asarray(g)}, {"x": jnp.zeros(8)}, 0.25)
    ts, tr, tst = tcomp.compress({"x": torch.from_numpy(g)}, {"x": torch.zeros(8)}, 0.25)
    np.testing.assert_array_equal(ts["x"].numpy(), np.asarray(js["x"]))
    assert float(tst["kept_fraction"]) == float(jst["kept_fraction"]) == 0.5
    np.testing.assert_array_equal(tr["x"].numpy(), np.where(np.abs(g) == 3.0, 0.0, g))
