"""The port's training loss and every parameter's gradient against
``repro.models.model.train_loss`` under ``jax.value_and_grad`` on the CPU:
the dense and MoE families here (SmolLM-135M, Gemma2-9B, DeepSeek-V2 and
DeepSeek-V3 with its MTP head and sigmoid gates), the attention-free,
hybrid and encoder-decoder ones in ``tests/test_torch_train_loss_families.py``
with the same checks.

``init_params`` weights of each reduced config (float32) are carried across
by ``params_from_jax``; the same numpy-seeded tokens, labels (some masked
with -1) and, for whisper, frame embeddings go through both packages.  The
JAX package trains through its plain router and attention
(``use_pallas_router`` / ``use_pallas_attention`` False); the port's CPU
path runs the kernels' plain versions, differentiated by autograd.

Tolerance: the loss and each gradient leaf within rtol 1e-4 / atol 1e-5
after scaling by the leaf's largest magnitude (both run in float32 with the
matmuls and softmax sums in another order); routed counts equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import model as jmodel
from repro_torch.configs import get_config as tget
from repro_torch.models import common, convert
from repro_torch.models import model as tmodel
from repro_torch.train import train_loop

ARCHS = ["smollm-135m", "gemma2-9b", "deepseek-v2-236b", "deepseek-v3-671b"]
B, S = 2, 24
RTOL, ATOL = 1e-4, 1e-5


def batch_for(cfg, seed: int = 3, b: int = B, s: int = S) -> dict:
    """numpy tokens, labels (a few masked with -1) and whisper's frames."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :3] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return batch


def bias_for(cfg, seed: int = 4):
    """A nonzero (L_scan, E) selection bias for a MoE config, else None."""
    if not cfg.moe:
        return None
    rng = np.random.default_rng(seed)
    return (0.05 * rng.standard_normal(
        (cfg.num_layers - cfg.first_dense_layers, cfg.n_routed_experts))).astype(np.float32)


def close_leaves(got: dict, want_tree, label: str) -> None:
    """Port tensors by name against a JAX tree, leaf by leaf."""
    want = convert.port_leaves(jax.tree.map(np.asarray, want_tree))
    assert got.keys() == want.keys(), label
    for name, g in got.items():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.detach().numpy() / scale, w / scale, rtol=RTOL,
                                   atol=ATOL, err_msg=f"{label} {name}")


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg, tcfg = jget(request.param).reduced(), tget(request.param).reduced()
    jp = jmodel.init_params(jax.random.key(0), jcfg)
    tp = train_loop.trainable(convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                                      "cpu"))
    return jcfg, tcfg, jp, tp


def test_train_loss_and_grads_match_jax(arch):
    jcfg, tcfg, jp, tp = arch
    batch, bias = batch_for(tcfg), bias_for(tcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbias = None if bias is None else jnp.asarray(bias)

    def jloss(p):
        return jmodel.train_loss(p, jbatch, jcfg, None, jbias)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbias = None if bias is None else torch.from_numpy(bias)
    tl, taux = tmodel.train_loss(tp, tbatch, tcfg, None, tbias)
    named = dict(tp.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(tl, list(named.values()))))

    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)
    np.testing.assert_allclose(float(taux["loss_main"].detach()), float(jaux["loss_main"]),
                               rtol=RTOL)
    if tcfg.mtp:
        np.testing.assert_allclose(float(taux["loss_mtp"].detach()), float(jaux["loss_mtp"]),
                                   rtol=RTOL)
    if tcfg.moe:
        np.testing.assert_array_equal(taux["counts"].numpy(), np.asarray(jaux["counts"]))
    else:
        assert taux["counts"] is None
    close_leaves(grads, jg, tcfg.name)


def test_remat_gives_the_same_grads(arch):
    import dataclasses

    _, tcfg, _, tp = arch
    batch = {k: torch.from_numpy(v) for k, v in batch_for(tcfg, seed=7).items()}
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        loss, _ = tmodel.train_loss(tp, batch, cfg)
        out.append((loss, torch.autograd.grad(loss, list(tp.parameters()))))
    assert float(out[0][0].detach()) == float(out[1][0].detach())
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cross_entropy_masks_and_caps():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 20
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[1, 2:] = -1
    from repro.models import common as jcommon

    for cap in (0.0, 30.0):
        want = float(jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), cap))
        got = float(common.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                         cap))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    none = -np.ones((2, 5), np.int32)
    assert float(common.cross_entropy(torch.from_numpy(logits), torch.from_numpy(none))) == 0.0


def test_param_count_matches_jax(arch):
    jcfg, tcfg, jp, tp = arch
    from repro.models import common as jcommon

    assert common.param_count(tp) == jcommon.param_count(jp)


def test_grad_dtype_barrier_casts_the_cotangent():
    x = torch.ones(3, dtype=torch.bfloat16, requires_grad=True)
    y = common.grad_dtype_barrier(x)
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad(y.float().sum() * 3.0, x)
    assert g.dtype == torch.bfloat16 and torch.equal(g, torch.full((3,), 3.0,
                                                                   dtype=torch.bfloat16))
    with torch.no_grad():
        assert common.grad_dtype_barrier(x) is x
