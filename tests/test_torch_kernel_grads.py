"""The plain backward versions of the two kernels that training runs,
``ref.flash_attention_bwd_ref`` and ``ref.moe_route_weights_vjp_ref``,
against ``jax.vjp`` of the JAX package's plain versions on the CPU, on
numpy-seeded inputs: causal, windowed with a softcap, non-causal with
S != T, rows with no key, S = 1; softmax and sigmoid gates, a top-k of
every expert, and all-tied logits.  Tolerance: rtol 1e-5 (both float32,
sums in another order).  The CUDA kernels are held against these on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 9).

``kernels/moe_route.moe_route_bwd_tiled``, the MoE backward kernel's
schedule in plain torch (its tiling of tokens and lanes, the k-term sums,
dg scattered in slot order), is held against ``jax.vjp`` of the JAX
package's router at the same tolerance, and against
``ref.moe_route_weights_vjp_ref`` on routes that name an expert twice
(JAX's top-k never does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import moe_route as tmoe
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


# t, e, k, all-tied logits: E 6 / 8 / 16 / 67 / 160 (1, 2 and 4 lanes a
# token, 8 lanes of 3 and 5 chunks), T not a multiple of a block's tokens,
# k = E, and E < 4 (one lane, a scalar row).
MOE_BWD_TILED_CASES = [(37, 16, 4, False), (5, 8, 8, False), (9, 6, 3, True), (70, 6, 6, False),
                       (40, 67, 5, False), (19, 67, 67, False), (33, 67, 8, True),
                       (150, 16, 16, True), (7, 3, 3, False), (50, 160, 6, False),
                       (1, 160, 6, False)]


@pytest.mark.parametrize("gate_fn", ["softmax", "sigmoid"])
@pytest.mark.parametrize("t,e,k,ties", MOE_BWD_TILED_CASES)
def test_moe_route_bwd_tiled_matches_jax(gate_fn, t, e, k, ties):
    rng = np.random.default_rng(t * e + k)
    logits = np.zeros((t, e), np.float32) if ties else rng.standard_normal((t, e)).astype(
        np.float32)
    bias = (0.1 * rng.standard_normal(e)).astype(np.float32)
    gw = rng.standard_normal((t, k)).astype(np.float32)
    idx = np.asarray(jref.moe_route_ref(jnp.asarray(logits), jnp.asarray(bias), k, gate_fn)[0])
    _, vjp = jax.vjp(lambda x: jref.moe_route_ref(x, jnp.asarray(bias), k, gate_fn)[1],
                     jnp.asarray(logits))
    (want,) = vjp(jnp.asarray(gw))
    got = tmoe.moe_route_bwd_tiled(torch.from_numpy(logits), torch.from_numpy(idx.copy()),
                                   torch.from_numpy(gw), gate_fn=gate_fn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    if gate_fn == "sigmoid":  # the experts not chosen take an exact 0
        chosen = np.zeros((t, e), bool)
        np.put_along_axis(chosen, idx, True, axis=1)
        assert np.all(got.numpy()[~chosen] == 0)


def _dup_route(rng, t: int, e: int, k: int) -> np.ndarray:
    """Distinct experts a token, then repeats: every other token names its
    first expert again in its last slot, every third names slot 1's in slot
    0, and with k >= 4 every fifth names one expert in three slots."""
    idx = np.argsort(rng.random((t, e)), axis=1)[:, :k].astype(np.int32)
    if k >= 2:
        idx[::2, -1] = idx[::2, 0]
        idx[::3, 0] = idx[::3, 1]
    if k >= 4:
        idx[::5, 1:4] = idx[::5, 2:3]
    return idx


@pytest.mark.parametrize("gate_fn", ["softmax", "sigmoid"])
@pytest.mark.parametrize("t,e,k", [(40, 16, 4), (23, 67, 5), (64, 160, 6), (9, 8, 8), (5, 3, 3)])
def test_moe_route_bwd_tiled_sums_repeated_experts(gate_fn, t, e, k):
    rng = np.random.default_rng(7 * t + e)
    logits = torch.from_numpy(rng.standard_normal((t, e)).astype(np.float32))
    idx = torch.from_numpy(_dup_route(rng, t, e, k))
    gw = torch.from_numpy(rng.standard_normal((t, k)).astype(np.float32))
    assert any(len(set(row)) < k for row in idx.tolist())
    got = tmoe.moe_route_bwd_tiled(logits, idx, gw, gate_fn=gate_fn)
    want = tref.moe_route_weights_vjp_ref(logits, idx, gw, gate_fn)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-7)
    if gate_fn == "sigmoid":
        chosen = np.zeros((t, e), bool)
        np.put_along_axis(chosen, idx.numpy(), True, axis=1)
        assert np.all(got.numpy()[~chosen] == 0)


def test_moe_bwd_tiling_sizes_lanes_by_experts():
    """Every chunk has one owner, a token takes at most 8 lanes (a power of
    two, so its butterfly stays in the warp), and only a lane's last chunk
    can fall past the row: at E 160 and 256, 8 lanes x 5 and x 8 chunks."""
    assert tmoe.moe_bwd_tiling(160) == (8, 5) and tmoe.moe_bwd_tiling(256) == (8, 8)
    for e in range(1, tmoe.MAX_EXPERTS + 1):
        lanes, per_lane = tmoe.moe_bwd_tiling(e)
        chunks = -(-e // 4)
        assert lanes in (1, 2, 4, 8) and lanes * per_lane >= chunks > lanes * (per_lane - 1), e
        assert tmoe.MOE_BWD_THREADS % lanes == 0
