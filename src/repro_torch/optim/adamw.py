"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule: float32 moments over bfloat16 or float32 parameters.

Port of ``repro/optim/adamw.py``.  Parameters are a model's named
parameters; the moments and gradients are dicts keyed by the same names.
The arithmetic is the reference's, in its order, in float32, on the
parameters' device (no host synchronisation); :func:`update` writes the
new parameters and moments in place under ``torch.no_grad`` (the JAX
package returns new arrays).

ZeRO-1: under a parallel context the moments follow
``models/partitioning.moment_specs``, keyed by the JAX leaves' paths (a
scanned layer's leaf stacked on its layer axis): each rank keeps only its
block of each leaf's moments, updates that block of the parameter from
the whole gradient, and gathers the parameter whole again (where GSPMD
inserts the same all-gather in the reference).  A leaf the rank holds a
TP or expert block of (``partitioning.take_blocks``) has moments of its dp
block of that block (``partitioning.moment_specs``; an expert block split
over ``data`` keeps them whole).  The arithmetic is the same elementwise,
so the result equals the unsharded update; the clipping norm sums each
block's squares over the axes that split it and counts every whole leaf
once.  :func:`gather_state` gives whole moments, one per parameter
of the whole model, on every rank; a checkpoint gathers them one leaf at
a time onto rank 0 instead (``ckpt.checkpoint``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import parallel
from repro_torch.models.partitioning import STACKED, block_names, jax_param_paths


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


@dataclasses.dataclass
class OptState:
    m: dict[str, torch.Tensor]  # float32, one per parameter (or per JAX leaf under specs)
    v: dict[str, torch.Tensor]
    step: torch.Tensor  # () int32
    specs: dict | None = None  # {JAX path: Spec}: the moments' ZeRO-1 layout


def _leaves(params: torch.nn.Module) -> dict[str, tuple[list[str], bool]]:
    """``{JAX path: (port parameter names in layer order, stacked)}``."""
    names = jax_param_paths({n: n for n, _ in params.named_parameters()})
    return {path: (ns, path.split("/", 1)[0] in STACKED) for path, ns in names.items()}


def _whole(tensors: list, stacked: bool) -> torch.Tensor:
    return torch.stack(tensors) if stacked else tensors[0]


def init(params: torch.nn.Module, ctx=None, specs: dict | None = None) -> OptState:
    """Zero moments: whole, one per parameter, or with ``specs`` (and the
    ``ctx`` they were made for) this rank's block of each JAX leaf's."""
    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device
    if specs is None:
        zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for n, p in named.items()}
    else:
        zeros = {}
        for path, (names, stacked) in _leaves(params).items():
            shape = _whole([named[n] for n in names], stacked).shape
            block = parallel.block_shape(specs[path], shape, ctx)
            zeros[path] = torch.zeros(block, dtype=torch.float32, device=dev)
    return OptState(
        m=zeros,
        v={n: torch.zeros_like(z) for n, z in zeros.items()},
        step=torch.zeros((), dtype=torch.int32, device=dev),
        specs=specs,
    )


def gather_state(state: OptState, params: torch.nn.Module, ctx) -> OptState:
    """The whole moments, one per parameter of the whole model, of a ZeRO-1
    state over a rank's ``params`` (each block's moments gathered over the
    axes its block splits too); a state without specs is returned as it
    is."""
    if state.specs is None:
        return state
    tp = block_names(params)
    m, v = {}, {}
    for path, (names, stacked) in _leaves(params).items():
        for whole, blocks in ((m, state.m), (v, state.v)):
            t = parallel.gather(blocks[path], state.specs[path], ctx)
            for i, n in enumerate(names):
                whole[n] = t[i] if stacked else t
                if n in tp:
                    whole[n] = parallel.gather(whole[n], tp[n], ctx)
    return OptState(m=m, v=v, step=state.step)


def schedule(step: torch.Tensor, cfg: OptimConfig) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac * lr`` (float32)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _sum_squares(tensors):
    total = None
    for g in tensors:
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return total


def global_norm(tensors, split=(), ctx=None) -> torch.Tensor:
    """The norm of ``tensors`` and of the blocks ``split`` (``(tensor,
    spec)`` pairs: this rank's blocks, their squares summed over the axes
    each spec splits, one sum for each set of axes)."""
    total = _sum_squares(tensors)
    by_axes: dict[tuple, list] = {}
    for g, spec in split:
        used = parallel.spec_axes(spec)
        by_axes.setdefault(tuple(a for a in ctx.shape if a in used), []).append(g)
    for axes, blocks in by_axes.items():
        part = parallel.group_reduce(_sum_squares(blocks), ctx, axes)
        total = part if total is None else total + part
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict, max_norm: float, split: dict | None = None, ctx=None):
    """``(clipped grads, norm)``: each gradient times ``min(1, max_norm /
    (norm + 1e-9))`` in its own dtype.  ``split``: ``{name: spec}`` of the
    gradients that are this rank's blocks (``partitioning.block_names``),
    whose squares are summed over the axes that split them."""
    split = split or {}
    norm = global_norm([g for n, g in grads.items() if n not in split],
                       [(g, split[n]) for n, g in grads.items() if n in split], ctx)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


@torch.no_grad()
def update(grads: dict, state: OptState, params: torch.nn.Module, cfg: OptimConfig, ctx=None):
    """One AdamW step on ``params`` and ``state``, both in place.  Returns
    ``(params, state, {"grad_norm", "lr"})``, the metrics 0-d float32
    tensors on the device.  A ZeRO-1 state (``state.specs``) needs the
    ``ctx`` its specs were made for, and the whole gradients on every
    rank."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, block_names(params), ctx)
    step = state.step + 1
    lr = schedule(step, cfg)
    b1, b2 = cfg.betas
    bc1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(b2, step.to(torch.float32))

    def adam(p, g, m, v):
        g32 = g.to(torch.float32)
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * torch.square(g32))
        mhat = m / bc1
        vhat = v / bc2
        p32 = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype)

    if state.specs is None:
        for name, p in params.named_parameters():
            p.copy_(adam(p, grads[name], state.m[name], state.v[name]))
    else:
        named = dict(params.named_parameters())
        for path, (names, stacked) in _leaves(params).items():
            spec = state.specs[path]
            p = _whole([named[n] for n in names], stacked)
            idx = parallel.shard_index(spec, p.shape, ctx)
            g = _whole([grads[n] for n in names], stacked)
            t = parallel.gather(adam(p[idx], g[idx], state.m[path], state.v[path]), spec, ctx)
            for i, n in enumerate(names):
                named[n].copy_(t[i] if stacked else t)
    state.step = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
