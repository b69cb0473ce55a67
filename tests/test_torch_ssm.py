"""The port's recurrent mixers (``repro_torch.models.ssm``), LayerNorm and
sinusoidal positions against ``repro.models.ssm`` / ``repro.models.common``.

Every input is drawn with numpy from a seed and handed to both packages in
float32.  The WKV6 cases are those of ``tests/test_wkv_chunked.py`` (``(S,
chunk)`` in (64, 32), (128, 32), (96, 16), (64, 64), and its strong-decay
case); ``rwkv_time_mix`` runs at S = 64 (the chunked form) and 65 (the
sequential scan), with and without a carried state and shift, and at every
tested S both packages must take the same form.

Tolerance: rtol 1e-4 / atol 1e-5, that of ``tests/test_torch_model_serve.py``:
both run in float32, and the contractions sum in another order.  Two
exceptions keep the reference's own tolerances from
``tests/test_wkv_chunked.py``.  The chunked WKV form itself, 2e-4: its
relative decays are exponentials of differences of cumulative log-decay
sums, which amplify each rounding, so the reference's chunked form is
5e-5 to 1.1e-4 off a float64 sequential scan on these inputs (and the
port's 2.5e-5 to 6.2e-5), and two float32 chunked forms that sum in other
orders differ by as much; each port case is also held within 2e-4 of the
float64 scan.  The strong-decay case, 2e-3, since its decays reach e^-30.
``sinusoidal_positions`` is the same numpy code on both sides and must be
equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro_torch.configs import get_config as tget
from repro_torch.models import common as tcommon
from repro_torch.models import ssm as tssm

TOL = dict(rtol=1e-4, atol=1e-5)
CHUNK_TOL = dict(rtol=2e-4, atol=2e-4)
STRONG_TOL = dict(rtol=2e-3, atol=2e-3)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol, err_msg=msg)


def _wkv_inputs(seed, b, s, h, n, decay_scale=1.0):
    """r, k, v, lw (= -exp(decay) <= 0), u, s0 as numpy float32."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    r, k, v = normal(b, s, h, n), normal(b, s, h, n), normal(b, s, h, n)
    lw = -np.exp(decay_scale * normal(b, s, h, n)).astype(np.float32)
    return r, k, v, lw, 0.5 * normal(h, n), normal(b, h, n, n)


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _scan64(r, k, v, lw, u, state):
    """The WKV6 recurrence in float64, one token a step (lw clamped at -30,
    as the chunked form clamps it)."""
    r, k, v, u, state = (a.double() for a in (r, k, v, u, state))
    w = torch.exp(torch.clamp(lw.double(), min=-30.0))
    out = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        out.append(torch.einsum("bhn,bhnm->bhm", r[:, t], state + u[None, :, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(out, 1), state


def test_wkv6_scan_matches_jax():
    (r, k, v, lw, u, s0), (tr, tk, tv, tlw, tu, ts0) = _both(_wkv_inputs(0, 2, 40, 3, 8))
    jo, js = jssm._wkv6_scan(r, k, v, jnp.exp(lw), u, s0)
    to, ts = tssm._wkv6_scan(tr, tk, tv, torch.exp(tlw), tu, ts0)
    assert to.dtype == ts.dtype == torch.float32
    _close(to, jo)
    _close(ts, js)


@pytest.mark.parametrize("s,chunk", [(64, 32), (128, 32), (96, 16), (64, 64)])
def test_wkv6_chunked_matches_jax(s, chunk):
    (r, k, v, lw, u, s0), (tr, tk, tv, tlw, tu, ts0) = _both(_wkv_inputs(s + chunk, 2, s, 3, 8))
    jo, js = jssm._wkv6_chunked(r, k, v, lw, u, s0, chunk=chunk)
    to, ts = tssm._wkv6_chunked(tr, tk, tv, tlw, tu, ts0, chunk=chunk)
    _close(to, jo, CHUNK_TOL)
    _close(ts, js, CHUNK_TOL)
    # ... and against the float64 recurrence
    so, ss = _scan64(tr, tk, tv, tlw, tu, ts0)
    np.testing.assert_allclose(to.double().numpy(), so.numpy(), **CHUNK_TOL)
    np.testing.assert_allclose(ts.double().numpy(), ss.numpy(), **CHUNK_TOL)


def test_wkv6_chunked_strong_decay_matches_jax():
    (r, k, v, lw, u, s0), (tr, tk, tv, tlw, tu, ts0) = _both(
        _wkv_inputs(1, 1, 64, 2, 8, decay_scale=3.0))
    assert float(tlw.min()) < -30  # the clamp is exercised
    jo, js = jssm._wkv6_chunked(r, k, v, lw, u, s0, chunk=32)
    to, ts = tssm._wkv6_chunked(tr, tk, tv, tlw, tu, ts0, chunk=32)
    assert bool(torch.isfinite(to).all())
    _close(to, jo, STRONG_TOL)
    _close(ts, js, STRONG_TOL)


def test_wkv6_chunked_refuses_a_ragged_sequence():
    _, (tr, tk, tv, tlw, tu, ts0) = _both(_wkv_inputs(2, 1, 40, 2, 8))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssm._wkv6_chunked(tr, tk, tv, tlw, tu, ts0, chunk=32)


@pytest.fixture(scope="module")
def rwkv():
    """(JAX config, port config, JAX time-mix and channel-mix params, port
    modules holding the same values)."""
    jcfg, tcfg = jget("rwkv6-1.6b").reduced(), tget("rwkv6-1.6b").reduced()
    kg = jcommon.KeyGen(jax.random.key(0))
    jtm, jcm = jssm.init_rwkv_time_mix(kg, jcfg), jssm.init_rwkv_channel_mix(kg, jcfg)
    ttm = tssm.RWKVTimeMix(tcfg, device="cpu")
    tcm = tssm.RWKVChannelMix(tcfg, device="cpu")
    for jp, tp in ((jtm, ttm), (jcm, tcm)):
        tp.load_state_dict({n: torch.from_numpy(np.array(a)) for n, a in jp.items()})
    return jcfg, tcfg, jtm, jcm, ttm, tcm


def _spy_forms(monkeypatch):
    """Record which WKV form each package takes."""
    forms = {"jax": [], "torch": []}
    for side, mod in (("jax", jssm), ("torch", tssm)):
        for name in ("_wkv6_scan", "_wkv6_chunked"):
            real = getattr(mod, name)

            def spy(*a, _real=real, _side=side, _name=name, **kw):
                forms[_side].append(_name)
                return _real(*a, **kw)

            monkeypatch.setattr(mod, name, spy)
    return forms


@pytest.mark.parametrize("s", [1, 32, 64, 65, 96])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_rwkv_time_mix_matches_jax(rwkv, monkeypatch, s, carried):
    jcfg, tcfg, jtm, _, ttm, _ = rwkv
    b, d = 2, tcfg.d_model
    h, n = d // tcfg.rwkv_head_dim, tcfg.rwkv_head_dim
    rng = np.random.default_rng(s)
    x = (0.5 * rng.standard_normal((b, s, d))).astype(np.float32)
    state = shift = None
    if carried:
        state = rng.standard_normal((b, h, n, n)).astype(np.float32)
        shift = rng.standard_normal((b, d)).astype(np.float32)
    forms = _spy_forms(monkeypatch)
    jo, js, jshift = jssm.rwkv_time_mix(
        jtm, jnp.asarray(x), jcfg,
        state=None if state is None else jnp.asarray(state),
        shift_prev=None if shift is None else jnp.asarray(shift))
    to, ts, tshift = tssm.rwkv_time_mix(
        ttm, torch.from_numpy(x), tcfg,
        state=None if state is None else torch.from_numpy(state),
        shift_prev=None if shift is None else torch.from_numpy(shift))
    chunked = s % tssm.WKV_CHUNK == 0 and s > tssm.WKV_CHUNK
    assert forms["torch"] == forms["jax"] == ["_wkv6_chunked" if chunked else "_wkv6_scan"]
    assert ts.dtype == torch.float32 and tuple(ts.shape) == (b, h, n, n)
    _close(to, jo)
    _close(ts, js)
    _close(tshift, jshift)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_rwkv_channel_mix_matches_jax(rwkv, carried):
    jcfg, tcfg, _, jcm, _, tcm = rwkv
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 20, tcfg.d_model)).astype(np.float32)
    shift = rng.standard_normal((2, tcfg.d_model)).astype(np.float32) if carried else None
    jo, jshift = jssm.rwkv_channel_mix(jcm, jnp.asarray(x), jcfg,
                                       shift_prev=None if shift is None else jnp.asarray(shift))
    to, tshift = tssm.rwkv_channel_mix(tcm, torch.from_numpy(x), tcfg,
                                       shift_prev=None if shift is None else torch.from_numpy(shift))
    _close(to, jo)
    _close(tshift, jshift)


def test_group_norm_uses_population_variance():
    rng = np.random.default_rng(3)
    out = rng.standard_normal((2, 5, 3, 4)).astype(np.float32)
    want = (out - out.mean(-1, keepdims=True)) / np.sqrt(out.var(-1, keepdims=True)
                                                         + tssm.GROUP_NORM_EPS)
    got = tssm._group_norm(torch.from_numpy(out)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    bessel = (out - out.mean(-1, keepdims=True)) / np.sqrt(out.var(-1, ddof=1, keepdims=True)
                                                           + tssm.GROUP_NORM_EPS)
    assert np.abs(got - bessel).max() > 0.1  # n = 4: dividing by n - 1 is far off


@pytest.fixture(scope="module")
def hymba():
    jcfg, tcfg = jget("hymba-1.5b").reduced(), tget("hymba-1.5b").reduced()
    jp = jssm.init_mamba(jcommon.KeyGen(jax.random.key(1)), jcfg)
    rng = np.random.default_rng(11)  # a non-zero conv bias, so that it counts
    jp = {**jp, "conv_b": jnp.asarray(0.1 * rng.standard_normal(jp["conv_b"].shape),
                                      jnp.float32)}
    tp = tssm.Mamba(tcfg, device="cpu")
    tp.load_state_dict({n: torch.from_numpy(np.array(a)) for n, a in jp.items()})
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_causal_conv_matches_jax(hymba, carried):
    _, tcfg, jp, tp = hymba
    di, kk = tcfg.ssm_expand * tcfg.d_model, tcfg.conv_kernel
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, di)).astype(np.float32)
    st = rng.standard_normal((2, kk - 1, di)).astype(np.float32) if carried else None
    jy, jst = jssm._causal_conv(jnp.asarray(x), jp["conv"], jp["conv_b"],
                                None if st is None else jnp.asarray(st))
    ty, tst = tssm._causal_conv(torch.from_numpy(x), tp.conv, tp.conv_b,
                                None if st is None else torch.from_numpy(st))
    _close(ty, jy)
    _close(tst, jst, dict(rtol=0, atol=0))  # the tail is copied, not computed
    assert tuple(tst.shape) == (2, kk - 1, di)


@pytest.mark.parametrize("s", [1, 24, tssm.MAMBA_CHUNK + 3])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_mamba_matches_jax(hymba, s, carried):
    jcfg, tcfg, jp, tp = hymba
    d = tcfg.d_model
    di, kk, n = tcfg.ssm_expand * d, tcfg.conv_kernel, tcfg.ssm_state
    rng = np.random.default_rng(s + 100 * carried)
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    st = cst = None
    if carried:
        st = rng.standard_normal((2, di, n)).astype(np.float32)
        cst = rng.standard_normal((2, kk - 1, di)).astype(np.float32)
    jo, js, jc = jssm.mamba(jp, jnp.asarray(x), jcfg,
                            state=None if st is None else jnp.asarray(st),
                            conv_state=None if cst is None else jnp.asarray(cst))
    to, ts, tc = tssm.mamba(tp, torch.from_numpy(x), tcfg,
                            state=None if st is None else torch.from_numpy(st),
                            conv_state=None if cst is None else torch.from_numpy(cst))
    assert ts.dtype == torch.float32 and tuple(ts.shape) == (2, di, n)
    _close(to, jo)
    _close(ts, js)
    _close(tc, jc)


@pytest.mark.parametrize("chunk", [1, 5, 7])
def test_mamba_chunks_equal_one_pass(hymba, chunk):
    """The scan in chunks carries the state across them: the outputs and
    the final state equal those of one pass over the whole sequence."""
    _, tcfg, _, tp = hymba
    d = tcfg.d_model
    di, n = tcfg.ssm_expand * d, tcfg.ssm_state
    rng = np.random.default_rng(chunk)
    x = torch.from_numpy(rng.standard_normal((2, 24, d)).astype(np.float32))
    st = torch.from_numpy(rng.standard_normal((2, di, n)).astype(np.float32))
    one = tssm.mamba(tp, x, tcfg, state=st, chunk=24)
    got = tssm.mamba(tp, x, tcfg, state=st, chunk=chunk)
    for g, w in zip(got, one):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_mamba_float32_leaves_in_a_bfloat16_model():
    cfg = tget("hymba-1.5b").reduced()
    cfg = type(cfg)(**{**cfg.__dict__, "param_dtype": "bfloat16"})
    p = tssm.Mamba(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert {n: t.dtype for n, t in p.named_parameters() if t.dtype == torch.float32} == {
        "dt_bias": torch.float32, "a_log": torch.float32, "d_skip": torch.float32}
    tm = tssm.RWKVTimeMix(type(cfg)(**{**tget("rwkv6-1.6b").reduced().__dict__,
                                       "param_dtype": "bfloat16"}), device="cpu")
    assert {n for n, t in tm.named_parameters() if t.dtype == torch.float32} == {"w0", "u"}


def test_softplus_matches_jax():
    x = np.linspace(-60.0, 60.0, 2401, dtype=np.float32)
    _close(tssm.softplus(torch.from_numpy(x)), jax.nn.softplus(jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(2, 7, 128), (3, 1, 64)])
def test_layer_norm_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = (3.0 + 2.0 * rng.standard_normal(shape)).astype(np.float32)
    scale = rng.standard_normal(shape[-1:]).astype(np.float32)
    bias = rng.standard_normal(shape[-1:]).astype(np.float32)
    want = jcommon.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-5)
    got = tcommon.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(bias), 1e-5)
    _close(got, want)
    # bfloat16 in, bfloat16 out, with float32 statistics
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tcommon.layer_norm(xb, torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("length,dim", [(1500, 768), (448, 768), (16, 128), (5, 6)])
def test_sinusoidal_positions_match_jax(length, dim):
    want = jcommon.sinusoidal_positions(length, dim)
    got = tcommon.sinusoidal_positions(length, dim)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    table = tcommon.sinusoidal_table(length, dim, torch.float32, torch.device("cpu"))
    np.testing.assert_array_equal(table.numpy(), want)
    # built once per (length, dim, dtype, device) and shared
    assert tcommon.sinusoidal_table(length, dim, torch.float32, torch.device("cpu")) is table
    assert tcommon.sinusoidal_table(length, dim, torch.bfloat16,
                                    torch.device("cpu")).dtype == torch.bfloat16
