"""The port's training loss and every parameter's gradient against the
JAX package's for the attention-free (RWKV6-1.6B), hybrid (Hymba-1.5B) and
encoder-decoder (Whisper-small) families, with the checks and tolerance of
``tests/test_torch_train_loss.py``; Mamba's scan under autograd keeps its
states in a list, the serving path writes them in place.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import model as jmodel
from repro_torch.configs import get_config as tget
from repro_torch.models import convert, ssm
from repro_torch.train import train_loop
from test_torch_train_loss import (
    test_param_count_matches_jax,
    test_remat_gives_the_same_grads,
    test_train_loss_and_grads_match_jax,
)

ARCHS = ["rwkv6-1.6b", "hymba-1.5b", "whisper-small"]
__all__ = ["test_train_loss_and_grads_match_jax", "test_remat_gives_the_same_grads",
           "test_param_count_matches_jax"]


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg, tcfg = jget(request.param).reduced(), tget(request.param).reduced()
    jp = jmodel.init_params(jax.random.key(0), jcfg)
    tp = train_loop.trainable(convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                                      "cpu"))
    return jcfg, tcfg, jp, tp


def test_mamba_under_grad_equals_the_serving_scan():
    cfg = tget("hymba-1.5b").reduced()
    gen = torch.Generator().manual_seed(0)
    p = ssm.Mamba(cfg, device="cpu", generator=gen)
    x = torch.randn((2, 40, cfg.d_model), generator=gen)
    with torch.no_grad():
        want = ssm.mamba(p, x, cfg, chunk=16)
    p.requires_grad_(True)
    got = ssm.mamba(p, x, cfg, chunk=16)
    for g, w in zip(got, want):
        assert torch.equal(g.detach(), w)
    (gw,) = torch.autograd.grad(got[0].square().sum(), [p.w_in])
    assert torch.isfinite(gw).all() and float(gw.abs().sum()) > 0
