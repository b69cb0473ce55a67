"""Shared model building blocks: norms, RoPE, initialisers, dtype policy.

Port of ``repro/models/common.py``.  Parameters are created on their
device, in their own dtype, from an explicit ``torch.Generator`` (the JAX
package's ``KeyGen``); a layer stack is a list of modules, one per layer,
where the JAX package stacks leaves for ``lax.scan``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import parallel


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}[
        name
    ]


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def dense_init(
    gen: torch.Generator | None, shape, dtype: torch.dtype, device, scale: float = 0.02
) -> torch.nn.Parameter:
    """``scale`` times a standard normal truncated to [-2, 2], cast to
    ``dtype``, drawn on ``device`` from ``gen``.  With ``gen=None`` the
    parameter is left uninitialised, to be filled by the caller
    (``models/convert.py``)."""
    if gen is None:
        return _param(torch.empty(shape, dtype=dtype, device=device))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return _param(t.mul_(scale).to(dtype))


def ones_init(shape, dtype: torch.dtype, device) -> torch.nn.Parameter:
    return _param(torch.ones(shape, dtype=dtype, device=device))


def zeros_init(shape, dtype: torch.dtype, device) -> torch.nn.Parameter:
    return _param(torch.zeros(shape, dtype=dtype, device=device))


def _param(t: torch.Tensor) -> torch.nn.Parameter:
    # Created without a gradient, so that serving records no graph;
    # ``train.train_loop.init_state`` turns it on for the model it trains.
    return torch.nn.Parameter(t, requires_grad=False)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *, offset: float = 0.0):
    """RMSNorm in float32.  ``offset=1.0`` gives the gemma-style
    ``(1 + scale)`` parameterisation."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (offset + scale.to(torch.float32))).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5):
    """LayerNorm with float32 statistics (population variance); scale and
    bias applied in float32, the result cast back to ``x``'s dtype."""
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


def softcap(x: torch.Tensor, cap: float):
    """Gemma2 logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotate pairs ``(x[..., ::2], x[..., 1::2])`` -- the interleaved
    convention, not the half split of most PyTorch code.

    x: ``(..., S, H, Dh)``; positions: broadcastable to ``(..., S)``.
    """
    dh = x.shape[-1]
    freqs = torch.from_numpy(rope_frequencies(dh, theta).astype(np.float32)).to(x.device)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., 0::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    out = torch.stack([y1, y2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """Whisper-style sinusoidal embeddings ``(length, dim)``, float32."""
    log_timescale = np.log(10_000.0) / (dim // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(dim // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def sinusoidal_table(length: int, dim: int, dtype: torch.dtype, device) -> torch.Tensor:
    """:func:`sinusoidal_positions` cast to ``dtype`` on ``device``, built
    once per ``(length, dim, dtype, device)`` and shared by every caller,
    so a decode step copies nothing from the host.  Read it; never write
    to it."""
    return torch.from_numpy(sinusoidal_positions(length, dim)).to(device=device, dtype=dtype)


# --------------------------------------------------------------------------
# activations
# --------------------------------------------------------------------------


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    raise ValueError(name)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


class _GradDtypeBarrier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct.to(ctx.dtype)


def grad_dtype_barrier(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; backward casts the cotangent to ``x.dtype``.

    Placed at block boundaries, as the JAX package places it, so activation
    gradients flow in the compute dtype.  PyTorch's autograd already hands
    each input its own dtype's gradient, so this only states the contract;
    outside a graph (serving) it returns ``x`` itself."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _GradDtypeBarrier.apply(x)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, final_cap: float = 0.0,
                  ctx=None, split_vocab: bool = False):
    """Token-mean cross entropy in float32; labels < 0 are masked out.

    Under a context whose ranks each hold their block of the rows
    (``ParallelContext.split``) it is this rank's summed token losses over
    the whole batch's unmasked count (summed over dp), so that the ranks'
    values sum to the whole batch's token mean.  With ``split_vocab`` the
    logits are this TP rank's block of the vocabulary's columns: the
    maximum and the sum of the exponentials are taken over the TP group
    and the gold logit comes from the rank that holds it, so the result is
    the whole vocabulary's loss on every TP rank without gathering the
    logits."""
    logits = logits.to(torch.float32)
    if final_cap:
        logits = softcap(logits, final_cap)
    mask = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, min=0).long()
    if split_vocab:
        vl = logits.shape[-1]
        local = safe - ctx.tp_index * vl
        own = (local >= 0) & (local < vl)
        m = parallel.tp_max(logits.amax(dim=-1), ctx)
        sumexp = parallel.tp_reduce(torch.exp(logits - m[..., None]).sum(dim=-1), ctx)
        logz = m + torch.log(sumexp)
        gold = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
        gold = parallel.tp_reduce(torch.where(own, gold, 0.0), ctx)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    count = mask.sum()
    if ctx is not None:
        count = ctx.dp_sum(count)
    return nll.sum() / torch.clamp(count, min=1.0)


def param_count(params: torch.nn.Module) -> int:
    return int(sum(p.numel() for p in params.parameters()))
