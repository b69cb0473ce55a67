"""The port's MoE serving slice against ``repro.models.model`` on the CPU.

``init_params`` weights of the reduced DeepSeek-V2 and -V3 configs
(float32) are carried across by ``params_from_jax``; then ``prefill`` and
one ``decode_step`` run in both packages on the same numpy-seeded tokens,
with no bias and with a CARE bias from the balancer.  The JAX side routes
through its oracle (``use_pallas_router=False``) and through the Pallas
kernel in interpret mode (``True``); the port routes through
``ops.moe_route``'s plain version.

Tolerance: logits and caches within rtol 1e-4 / atol 1e-5.  Both run in
float32; the port's matmuls and softmax sums run in another order, which
costs a few ulps per accumulated dot product, and three blocks compound
them.  Routed expert ids, counts and capacity positions must be equal;
that is meaningful only where no two candidate scores are within the
rounding noise, so a guard first asserts that the reference's top-(k+1)
scores of every token are at least 1e-3 apart and names the token if not.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import get_config as jget
from repro.core import moe_balancer as jbal
from repro.models import ffn as jffn
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.configs import get_config as tget
from repro_torch.core import moe_balancer as tbal
from repro_torch.models import convert
from repro_torch.models import ffn as tffn
from repro_torch.models import model as tmodel

TOL = dict(rtol=1e-4, atol=1e-5)
MARGIN = 1e-3
ARCHS = ["deepseek-v2-236b", "deepseek-v3-671b"]
B, S, CACHE = 2, 16, 20


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(arch, JAX config, port config, JAX params, port model)."""
    name = request.param
    jcfg, tcfg = jget(name).reduced(), tget(name).reduced()
    jp = jmodel.init_params(jax.random.key(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return name, jcfg, tcfg, jp, tp


def _tokens(cfg, seed=1, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s)).astype(np.int32)


def _care_bias(jcfg, tcfg):
    """A CARE selection bias after three steps of skewed counts, computed
    by both balancers (which must agree); the JAX one is returned."""
    l, e = tmodel.num_scanned_layers(tcfg), tcfg.n_routed_experts
    js, ts = jbal.BalancerState.init(l, e), tbal.BalancerState.init(l, e, device="cpu")
    rng = np.random.default_rng(5)
    for _ in range(3):
        counts = rng.poisson(np.linspace(1, 40, e), (l, e)).astype(np.float32)
        js = jbal.post_step_update(js, jnp.asarray(counts), jcfg.care)
        ts = tbal.post_step_update(ts, torch.from_numpy(counts), tcfg.care)
    jb = np.asarray(jbal.selection_bias(js, jcfg.care))
    np.testing.assert_allclose(tbal.selection_bias(ts, tcfg.care).numpy(), jb, rtol=1e-6, atol=1e-5)
    assert np.abs(jb).max() > 0.5  # large enough to move the selection
    return jb


def _spy(monkeypatch):
    seen = {"jax": [], "torch": []}
    j_route, t_route = jffn._route, tffn._route

    def j_spy(logits, bias, cfg):
        out = j_route(logits, bias, cfg)
        seen["jax"].append((np.asarray(logits) - np.asarray(bias)[None], [np.asarray(a) for a in out]))
        return out

    def t_spy(logits, bias, cfg):
        out = t_route(logits, bias, cfg)
        seen["torch"].append([a.numpy() for a in out])
        return out

    monkeypatch.setattr(jffn, "_route", j_spy)
    monkeypatch.setattr(tffn, "_route", t_spy)
    return seen


def _check_routes(seen, k):
    assert len(seen["torch"]) == len(seen["jax"]) > 0
    for call, ((score, (ji, jw, jc)), (ti, tw, tc, tpos)) in enumerate(
            zip(seen["jax"], seen["torch"])):
        top = -np.sort(-score, axis=1)[:, : k + 1]
        gaps = top[:, :-1] - top[:, 1:]
        tok, slot = np.unravel_index(np.argmin(gaps), gaps.shape)
        assert gaps.min() > MARGIN, (
            f"route call {call}: token {tok}'s scores {slot} and {slot + 1} are "
            f"{gaps.min():.2e} apart, inside the rounding noise; pick another seed"
        )
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_allclose(tw, jw, **TOL)
        # The capacity positions, as the reference computes them on its ids
        # (repro/models/ffn.py:110-114).
        onehot = jax.nn.one_hot(jnp.asarray(ji).reshape(-1), score.shape[1], dtype=jnp.int32)
        jpos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=1)
        np.testing.assert_array_equal(tpos, np.asarray(jpos))


def _close_cache(tc, jc):
    assert tc.keys() == jc.keys()
    for part in tc:
        t_leaves = dict(convert._flatten(tc[part]))
        j_leaves = dict(convert._flatten(jc[part]))
        assert t_leaves.keys() == j_leaves.keys()
        for name, t in t_leaves.items():
            assert tuple(t.shape) == j_leaves[name].shape, (part, name)
            np.testing.assert_allclose(t.numpy(), np.asarray(j_leaves[name]), **TOL,
                                       err_msg=f"{part}.{name}")


@pytest.mark.parametrize("biased", [False, True], ids=["no_bias", "care_bias"])
@pytest.mark.parametrize("pallas", [False, True], ids=["jax_oracle", "jax_pallas"])
def test_prefill_and_decode_match_jax(arch, monkeypatch, pallas, biased):
    _, jcfg, tcfg, jp, tp = arch
    jcfg = dataclasses.replace(jcfg, use_pallas_router=pallas)
    bias = _care_bias(jcfg, tcfg) if biased else None
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else torch.from_numpy(bias.copy())
    seen = _spy(monkeypatch)
    tok = _tokens(tcfg)

    # Without jit the reference's layer scan runs in Python, so the spy sees
    # concrete routes.
    with jax.disable_jit():
        jl, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(tok)}, jcfg, cache_len=CACHE, bias=jb)
    tl, tc = tmodel.prefill(tp, {"tokens": torch.from_numpy(tok)}, tcfg, cache_len=CACHE, bias=tb)
    assert tl.shape == (B, tcfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_cache(tc, jc)

    nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    with jax.disable_jit():
        jl, jc = jmodel.decode_step(jp, jnp.asarray(nxt), jc, jnp.int32(S), jcfg, bias=jb)
    tl, tc = tmodel.decode_step(tp, torch.from_numpy(nxt), tc, S, tcfg, bias=tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_cache(tc, jc)
    # One route per MoE layer for the prefill and one for the decode step.
    assert len(seen["torch"]) == 2 * tmodel.num_scanned_layers(tcfg)
    _check_routes(seen, tcfg.moe_top_k)


def test_decode_past_the_cache_clamps(arch):
    # A decode position past the cache writes the last row, as
    # lax.dynamic_update_slice clamps; the mask still uses the position.
    _, jcfg, tcfg, jp, tp = arch
    tok = _tokens(tcfg, seed=2)
    nxt = tok[:, 0]
    with jax.disable_jit():  # op by op: cheaper here than compiling the scan
        _, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(tok)}, jcfg, cache_len=S)
        jl, jc = jmodel.decode_step(jp, jnp.asarray(nxt), jc, jnp.int32(S + 3), jcfg)
    _, tc = tmodel.prefill(tp, {"tokens": torch.from_numpy(tok)}, tcfg, cache_len=S)
    before = tc["scan"]["ckv"].clone()
    tl, tc = tmodel.decode_step(tp, torch.from_numpy(nxt), tc, S + 3, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_cache(tc, jc)
    assert torch.equal(tc["scan"]["ckv"][:, :, : S - 1], before[:, :, : S - 1])
    assert not torch.equal(tc["scan"]["ckv"][:, :, S - 1], before[:, :, S - 1])


def test_prefill_then_decode_equals_longer_prefill(arch):
    # The port's own consistency check, as tests/test_arch_smoke.py makes
    # it for the JAX package: logits(prefill over S) against
    # logits(prefill over S-1, then one decode_step at S-1).
    _, _, tcfg, _, tp = arch
    tok = torch.from_numpy(_tokens(tcfg, seed=3))
    full, _ = tmodel.prefill(tp, {"tokens": tok}, tcfg, cache_len=S + 4)
    _, cache = tmodel.prefill(tp, {"tokens": tok[:, :-1]}, tcfg, cache_len=S + 4)
    step, _ = tmodel.decode_step(tp, tok[:, -1], cache, S - 1, tcfg)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=2e-2, atol=2e-2)


def test_init_decode_cache_layout(arch):
    _, jcfg, tcfg, jp, tp = arch
    jc = jmodel.init_decode_cache(jp, jcfg, B, CACHE)
    tc = tmodel.init_decode_cache(tp, tcfg, B, CACHE)
    _close_cache(tc, jc)


def test_converter_maps_leaves_one_to_one(arch):
    _, jcfg, tcfg, jp, tp = arch
    flat = dict(convert._flatten(jax.tree.map(np.asarray, jp)))
    n_layers = tmodel.num_scanned_layers(tcfg)
    stacked = [name for name in flat if name.startswith("layers.")]
    params = dict(tp.named_parameters())
    assert len(params) == len(flat) + (n_layers - 1) * len(stacked)
    for name, arr in flat.items():
        if name in stacked:
            for i in range(n_layers):
                port_name = f"layers.{i}.{name[len('layers.'):]}"
                np.testing.assert_array_equal(params[port_name].numpy(), arr[i])
        else:
            np.testing.assert_array_equal(params[name].numpy(), arr)
    for p in params.values():
        assert p.dtype == torch.float32 and not p.requires_grad


def test_converter_refuses_a_mismatched_tree(arch):
    _, jcfg, tcfg, jp, _ = arch
    tree = jax.tree.map(np.asarray, jp)
    del tree["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        convert.params_from_jax(tree, tcfg, "cpu")
    tree = jax.tree.map(np.asarray, jp)
    tree["embed"] = tree["embed"][:, :-1]
    with pytest.raises(ValueError, match="embed"):
        convert.params_from_jax(tree, tcfg, "cpu")


def test_init_params_on_the_cpu(arch):
    # Random init through the port's own generator: the same tree of names,
    # shapes and dtypes as the JAX package's, truncated at 2 sigma.
    _, _, tcfg, _, tp = arch
    gen = torch.Generator(device="cpu").manual_seed(0)
    fresh = tmodel.init_params(gen, tcfg, device="cpu")
    shapes = {n: (p.shape, p.dtype) for n, p in fresh.named_parameters()}
    assert shapes == {n: (p.shape, p.dtype) for n, p in tp.named_parameters()}
    assert float(fresh.embed.abs().max()) <= 0.04 + 1e-7
    with pytest.raises(ValueError, match="generator"):
        tmodel.init_params(gen, tcfg, device="meta")


@pytest.mark.parametrize(
    "options",
    [dict(post_norms=True), dict(embed_scale=True, final_softcap=30.0),
     dict(tie_embeddings=True), dict(act="gelu", glu=False)],
    ids=["post_norms", "embed_scale_softcap", "tied", "gelu_no_glu"],
)
def test_config_options_match_jax(options):
    # Options of the shared ModelConfig that no DeepSeek config sets; the
    # port follows the reference on each of them.
    jcfg = dataclasses.replace(jget("deepseek-v2-236b").reduced(), **options)
    tcfg = dataclasses.replace(tget("deepseek-v2-236b").reduced(), **options)
    jp = jmodel.init_params(jax.random.key(1), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tok = _tokens(tcfg, seed=4)
    with jax.disable_jit():
        jl, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(tok)}, jcfg, cache_len=CACHE)
        jl2, _ = jmodel.decode_step(jp, jnp.asarray(tok[:, 0]), jc, jnp.int32(S), jcfg)
    tl, tc = tmodel.prefill(tp, {"tokens": torch.from_numpy(tok)}, tcfg, cache_len=CACHE)
    tl2, _ = tmodel.decode_step(tp, torch.from_numpy(tok[:, 0]), tc, S, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)


def test_registry_serves_every_jax_architecture():
    # The port's registry holds the JAX package's ten ids, in its order, with
    # every config field equal apart from the JAX package's two use_pallas_*
    # switches; each family builds a model.
    assert tuple(tconfigs.ARCH_IDS) == tuple(jconfigs.ARCH_IDS) and len(jconfigs.ARCH_IDS) == 10
    for name in jconfigs.ARCH_IDS:
        want = {k: v for k, v in dataclasses.asdict(jget(name)).items()
                if k not in ("use_pallas_router", "use_pallas_attention")}
        assert dataclasses.asdict(tget(name)) == want, name
    for family in ("ssm", "hybrid", "audio"):
        cfg = next(tget(n).reduced() for n in tconfigs.ARCH_IDS if tget(n).family == family)
        model = tmodel.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        assert len(model.layers) == cfg.num_layers
    with pytest.raises(KeyError, match="unknown arch"):
        tget("mamba-2.8b")
