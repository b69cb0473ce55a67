"""Carry a JAX parameter tree across to the port.

The JAX package keeps a nested dict of arrays and stacks the scanned
layers on a leading axis (``layers/<leaf>`` and whisper's
``enc_layers/<leaf>``, of shape ``(L, ...)``); the port keeps one
:class:`~repro_torch.models.model.Model` with a module per layer.
:func:`params_from_jax` maps each JAX leaf to the parameter of the same
dotted name, splitting a stacked leaf on axis 0 into ``layers.<l>.<leaf>``
(``enc_layers.<l>.<leaf>``), and refuses a tree whose leaves and the
model's parameters do not match one to one in name, shape and dtype (the
float32 leaves of a bfloat16 model, such as RWKV's ``w0`` and ``u`` and
Mamba's ``a_log``, stay float32 on both sides).  :func:`train_state_from_jax`
carries a whole JAX ``TrainState`` across the same way (parameters, AdamW's
``m``, ``v`` and ``step``, the balancer and the step), so that both packages
train from one state.  Under a parallel context :func:`params_from_jax`
gives this rank's blocks of the leaves its tensor- and expert-parallel
layout splits (``partitioning.take_blocks``), and :func:`whole_model`
turns a rank's model back into whole leaves.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.care.slotted_sim import _resolve_device
from repro_torch.models import partitioning
from repro_torch.models.model import Model
from repro_torch.models.partitioning import STACKED


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{prefix}{key}.")
    else:
        yield prefix[:-1], tree


def _tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, which torch cannot read
        return torch.from_numpy(np.array(arr).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def port_leaves(tree) -> dict[str, torch.Tensor]:
    """The JAX tree as ``{port parameter name: CPU tensor}``."""
    out = {}
    for name, arr in _flatten(tree):
        t = _tensor(arr)
        head, _, rest = name.partition(".")
        if head in STACKED:
            for i in range(t.shape[0]):
                out[f"{head}.{i}.{rest}"] = t[i]
        else:
            out[name] = t
    return out


def params_from_jax(tree, cfg: ModelConfig, device=None, ctx=None) -> Model:
    """A :class:`Model` on ``device`` (None means the CUDA card) holding the
    values of the JAX parameter tree ``tree`` (nested dicts of numpy
    arrays, as ``jax.tree.map(np.asarray, params)`` gives); under a
    context, this rank's blocks of them."""
    dev = _resolve_device(device)
    return partitioning.take_blocks(_load(port_leaves(tree), cfg, dev), cfg, ctx)


def whole_model(params: Model, cfg: ModelConfig, ctx=None) -> Model:
    """A :class:`Model` of the whole leaves of a rank's ``params`` (its
    blocks gathered over the axes that split them), on the same device;
    ``params`` itself when it holds no block."""
    if not params.tp_specs:
        return params
    whole = _load(partitioning.whole_leaves(params, ctx), cfg, params.embed.device)
    return whole.requires_grad_(params.embed.requires_grad)


def _load(leaves: dict, cfg: ModelConfig, dev) -> Model:
    """A :class:`Model` on ``dev`` holding ``{port name: tensor}``."""
    model = Model(cfg, device=dev)
    params = dict(model.named_parameters())
    if leaves.keys() != params.keys():
        raise ValueError(
            f"JAX leaves without a port parameter: {sorted(leaves.keys() - params.keys())}; "
            f"port parameters without a JAX leaf: {sorted(params.keys() - leaves.keys())}"
        )
    for name, p in params.items():
        src = leaves[name]
        if src.shape != p.shape or src.dtype != p.dtype:
            raise ValueError(
                f"{name}: JAX {tuple(src.shape)} {src.dtype} != port {tuple(p.shape)} {p.dtype}"
            )
        p.data.copy_(src)
    return model


def train_state_from_jax(jstate, cfg: ModelConfig, device=None):
    """A ``train.train_loop.TrainState`` on ``device`` (None means the CUDA
    card) holding the values of the JAX ``TrainState`` ``jstate`` (its
    leaves anything ``np.asarray`` takes); the parameters take gradients."""
    from repro_torch.core.moe_balancer import BalancerState
    from repro_torch.optim.adamw import OptState
    from repro_torch.train.train_loop import TrainState, trainable

    dev = _resolve_device(device)

    def tree(t):
        return {k: tree(v) for k, v in t.items()} if isinstance(t, dict) else np.asarray(t)

    def scalar(x):
        return torch.from_numpy(np.array(np.asarray(x))).to(dev)

    params = trainable(params_from_jax(tree(jstate.params), cfg, dev))
    names = [n for n, _ in params.named_parameters()]

    def moments(t):
        leaves = port_leaves(tree(t))
        return {n: leaves[n].to(device=dev, dtype=torch.float32).contiguous() for n in names}

    opt = OptState(m=moments(jstate.opt.m), v=moments(jstate.opt.v),
                   step=scalar(jstate.opt.step))
    bal = None
    if jstate.balancer is not None:
        b = jstate.balancer
        bal = BalancerState(**{f: scalar(getattr(b, f)) for f in (
            "load_approx", "true_load", "true_counts", "bias", "steps_since_sync")})
    return TrainState(params=params, opt=opt, balancer=bal, step=scalar(jstate.step))
