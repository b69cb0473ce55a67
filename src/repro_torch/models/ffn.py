"""Feed-forward blocks: dense (GLU / plain) and the CARE-routed MoE.

Port of ``repro/models/ffn.py`` for one device (``ctx=None``): route ->
scatter tokens into per-expert capacity buffers -> expert matmuls ->
weighted gather-combine.  Routing always goes through
:func:`repro_torch.kernels.ops.moe_route`, which launches the Hopper
kernel for a CUDA tensor and runs its plain version for a CPU one; the
kernel also returns each (token, slot)'s position in its expert's buffer,
so no one-hot or cumsum runs on the card.  Counts
are returned per layer; the CARE balancer (``core/moe_balancer.py``)
consumes them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.mla import refuse_ctx


class DenseFFN(nn.Module):
    """Dense (GLU) FFN parameters, named as the JAX leaves (``init_dense_ffn``)."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None, d_ff: int | None = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        pdt = common.dtype_of(cfg.param_dtype)
        out_scale = 0.02 / max(cfg.num_layers, 1) ** 0.5
        self.w_in = common.dense_init(generator, (d, f), pdt, device)
        self.w_out = common.dense_init(generator, (f, d), pdt, device, scale=out_scale)
        if cfg.glu:
            self.w_gate = common.dense_init(generator, (d, f), pdt, device)


def dense_ffn(p: DenseFFN, x: torch.Tensor, cfg: ModelConfig):
    act = common.activation(cfg.act)
    h = act(x @ p.w_in)
    if cfg.glu:
        h = h * (x @ p.w_gate)
    return h @ p.w_out


class MoEFFN(nn.Module):
    """MoE parameters (``init_moe_ffn``): a float32 gate even in a bfloat16
    model, stacked expert weights ``(E, D, F)`` / ``(E, F, D)``, and the
    shared experts as one dense FFN of width ``moe_d_ff * n_shared``."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_routed_experts, cfg.moe_d_ff
        pdt = common.dtype_of(cfg.param_dtype)
        out_scale = 0.02 / max(cfg.num_layers, 1) ** 0.5
        self.gate = common.dense_init(generator, (d, e), torch.float32, device)
        self.w_in = common.dense_init(generator, (e, d, f), pdt, device)
        self.w_gate_h = common.dense_init(generator, (e, d, f), pdt, device)
        self.w_out = common.dense_init(generator, (e, f, d), pdt, device, scale=out_scale)
        if cfg.n_shared_experts:
            self.shared = DenseFFN(
                cfg, device=device, generator=generator,
                d_ff=cfg.moe_d_ff * cfg.n_shared_experts,
            )


def _route(logits: torch.Tensor, bias: torch.Tensor, cfg: ModelConfig):
    """``(idx, weights, counts, pos)`` from one ``moe_route`` call."""
    return ops.moe_route(logits, bias, cfg.moe_top_k, gate_fn=cfg.gate_fn)


def _capacity(t_loc: int, k: int, e: int, factor: float) -> int:
    cap = int(max(4, -(-t_loc * k * factor // e)))
    return min(cap, t_loc * k)


def _moe_local(xt: torch.Tensor, bias: torch.Tensor, p: MoEFFN, cfg: ModelConfig):
    """MoE body on one device.  xt: ``(T, D)`` tokens, bias ``(E,)``.

    Returns ``(y (T, D), counts (E,) float32)``.  A (token, slot) pair
    past its expert's capacity goes to a sink row and contributes nothing.
    """
    t_loc, d = xt.shape
    e, k = cfg.n_routed_experts, cfg.moe_top_k
    cdt = common.dtype_of(cfg.compute_dtype)

    logits = xt.to(torch.float32) @ p.gate
    # pos: each (token, slot)'s position within its expert's capacity buffer.
    idx, weights, counts, pos = _route(logits, bias, cfg)  # (t,k),(t,k),(E,),(t*k,)

    cap = _capacity(t_loc, k, e, cfg.moe_capacity_factor)
    flat_e = idx.reshape(-1)  # (t*k,) int32
    keep = pos < cap
    lin = torch.where(keep, flat_e * cap + pos, e * cap).long()  # overflow -> sink row

    buf = torch.zeros((e * cap + 1, d), dtype=cdt, device=xt.device)
    tok_rows = xt.to(cdt).repeat_interleave(k, dim=0)  # (t*k, D)
    buf.index_add_(0, lin, tok_rows)
    work = buf[: e * cap].reshape(e, cap, d)

    act = common.activation(cfg.act)
    h = act(torch.einsum("end,edf->enf", work, p.w_in))
    h = h * torch.einsum("end,edf->enf", work, p.w_gate_h)
    out = torch.einsum("enf,efd->end", h, p.w_out)

    back = torch.cat([out.reshape(e * cap, d), out.new_zeros((1, d))], dim=0)
    picked = back[lin]  # (t*k, D); sink row is zero
    w_flat = (weights.reshape(-1, 1) * keep[:, None]).to(cdt)
    y = torch.sum((picked * w_flat).reshape(t_loc, k, d), dim=1)
    return y, counts.to(torch.float32)


def moe_ffn(p: MoEFFN, x: torch.Tensor, bias: torch.Tensor, cfg: ModelConfig, ctx=None):
    """MoE forward on one device.

    Args:
      p: layer params.  x: ``(B, S, D)``.  bias: the CARE selection bias,
        ``(E,)`` (a per-dispatcher ``(..., E)`` bias is averaged over its
        rows, as the JAX package's single-device path does).

    Returns:
      ``(y (B, S, D), counts (E,) float32)``.
    """
    refuse_ctx(ctx)
    b, s, d = x.shape
    bias_flat = bias.reshape(-1, cfg.n_routed_experts).mean(dim=0)
    y, counts = _moe_local(x.reshape(b * s, d), bias_flat, p, cfg)
    y = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + dense_ffn(p.shared, x, cfg)
    return y, counts
