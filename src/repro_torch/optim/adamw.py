"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule: float32 moments over bfloat16 or float32 parameters.

Port of ``repro/optim/adamw.py``.  Parameters are a model's named
parameters; the moments and gradients are dicts keyed by the same names.
The arithmetic is the reference's, in its order, in float32, on the
parameters' device (no host synchronisation); :func:`update` writes the
new parameters and moments in place under ``torch.no_grad`` (the JAX
package returns new arrays).
"""
from __future__ import annotations

import dataclasses
import math

import torch


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
    m: dict[str, torch.Tensor]  # float32, one per parameter
    v: dict[str, torch.Tensor]
    step: torch.Tensor  # () int32


def init(params: torch.nn.Module) -> OptState:
    named = dict(params.named_parameters())
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in named.items()}
    dev = next(iter(named.values())).device
    return OptState(
        m=zeros,
        v={n: torch.zeros_like(z) for n, z in zeros.items()},
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


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


def global_norm(tensors) -> torch.Tensor:
    total = None
    for g in tensors:
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict, max_norm: float):
    """``(clipped grads, norm)``: each gradient times ``min(1, max_norm /
    (norm + 1e-9))`` in its own dtype."""
    norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


@torch.no_grad()
def update(grads: dict, state: OptState, params: torch.nn.Module, cfg: OptimConfig):
    """One AdamW step on ``params`` and ``state``, both in place.  Returns
    ``(params, state, {"grad_norm", "lr"})``, the metrics 0-d float32
    tensors on the device."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = schedule(step, cfg)
    b1, b2 = cfg.betas
    bc1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(b2, step.to(torch.float32))
    for name, p in params.named_parameters():
        g32 = grads[name].to(torch.float32)
        m, v = state.m[name], state.v[name]
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * torch.square(g32))
        mhat = m / bc1
        vhat = v / bc2
        p32 = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
    state.step = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
