"""Multi-head Latent Attention (DeepSeek V2/V3).

Port of ``repro/models/mla.py``.  The KV cache stores only the compressed
latent (``kv_lora_rank``) plus one shared RoPE key head.

* :func:`mla_full` -- the expanded computation for prefill: per-head K/V
  are materialised once over the sequence and attended through
  :func:`repro_torch.models.flash.flash_sdpa`.
* :func:`mla_decode` -- the absorbed computation: ``W_uk`` is folded into
  the query and ``W_uv`` into the output, so one token attends MQA-style
  against the compressed cache.

Under a parallel context the expanded per-head K and V carry the JAX
package's head-sharding hints (``parallel.hint``, which moves nothing).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, flash, parallel


class MLA(nn.Module):
    """MLA parameters, named as the JAX leaves (``init_mla``)."""

    def __init__(self, cfg: ModelConfig, *, device, generator: torch.Generator | None = None):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        r = cfg.kv_lora_rank
        pdt = common.dtype_of(cfg.param_dtype)
        init = lambda shape, **kw: common.dense_init(generator, shape, pdt, device, **kw)  # noqa: E731
        self.w_dkv = init((d, r + dr))
        self.kv_norm = common.ones_init((r,), pdt, device)
        self.w_uk = init((r, h * dn))
        self.w_uv = init((r, h * dv))
        self.wo = init((h * dv, d), scale=0.02 / max(cfg.num_layers, 1) ** 0.5)
        if cfg.q_lora_rank:
            self.w_dq = init((d, cfg.q_lora_rank))
            self.q_norm = common.ones_init((cfg.q_lora_rank,), pdt, device)
            self.w_uq = init((cfg.q_lora_rank, h * (dn + dr)))
        else:
            self.wq = init((d, h * (dn + dr)))


def _queries(p: MLA, x: torch.Tensor, cfg: ModelConfig):
    h = cfg.num_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        cq = common.rms_norm(x @ p.w_dq, p.q_norm, cfg.norm_eps)
        q = cq @ p.w_uq
    else:
        q = x @ p.wq
    q = q.reshape(*x.shape[:-1], h, dn + dr)
    return q[..., :dn], q[..., dn:]  # (B,S,H,dn), (B,S,H,dr)


def _latents(p: MLA, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """Compressed kv latent and rotated shared rope key."""
    r = cfg.kv_lora_rank
    ckv_full = x @ p.w_dkv
    ckv = common.rms_norm(ckv_full[..., :r], p.kv_norm, cfg.norm_eps)
    k_rope = ckv_full[..., r:][..., None, :]  # (B,S,1,dr) shared head
    k_rope = common.apply_rope(k_rope, positions, cfg.rope_theta)
    return ckv, k_rope[..., 0, :]  # (B,S,R), (B,S,dr)


def mla_full(
    p: MLA,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor | None = None,
    return_cache: bool = False,
    cache_len: int = 0,
    ctx=None,
):
    """Expanded MLA for prefill (causal, global attention).

    x: ``(B, S, D)``.  Returns ``(out (B, S, D), cache)``; the cache is
    ``{"ckv": (B, cache_len, R), "k_rope": (B, cache_len, dr)}`` with the
    first S rows filled, or None without ``return_cache``.
    """
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]

    q_nope, q_rope = _queries(p, x, cfg)
    q_rope = common.apply_rope(q_rope, positions, cfg.rope_theta)
    ckv, k_rope = _latents(p, x, cfg, positions)

    k_nope = (ckv @ p.w_uk).reshape(b, s, h, dn)
    v = (ckv @ p.w_uv).reshape(b, s, h, dv)
    dp, tp = (ctx.dp_axes, ctx.tp_axis) if ctx is not None else (None, None)
    shard = lambda a: parallel.hint(a, ctx, dp, None, tp, None)  # noqa: E731
    q = shard(torch.cat([q_nope, q_rope], dim=-1))
    k = shard(torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1))
    v = shard(v)

    scale = 1.0 / (dn + dr) ** 0.5
    out = flash.flash_sdpa(q, k, v, scale=scale, q_positions=positions, causal=True)
    out = parallel.hint(out, ctx, dp, None, tp) @ p.wo
    out = parallel.hint(out, ctx, dp, tp)  # reduce-scatter landing (SP)

    if not return_cache:
        return out, None
    if s > cache_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {cache_len}")
    r = cfg.kv_lora_rank
    ckv_c = torch.zeros((b, cache_len, r), dtype=ckv.dtype, device=x.device)
    kr_c = torch.zeros((b, cache_len, dr), dtype=k_rope.dtype, device=x.device)
    ckv_c[:, :s] = ckv
    kr_c[:, :s] = k_rope
    return out, {"ckv": ckv_c, "k_rope": kr_c}


def mla_decode(p: MLA, x: torch.Tensor, cache: dict, pos: int, cfg: ModelConfig):
    """Absorbed single-token decode against the compressed cache.

    x: ``(B, 1, D)``; ``pos`` the new token's position.  The token's
    latents are written into ``cache`` in place, at row ``pos`` clamped to
    the cache as ``lax.dynamic_update_slice`` clamps it (a ``pos`` past the
    cache overwrites the last row); the mask keeps keys ``<= pos``.
    Returns ``(out (B, 1, D), cache)``.
    """
    b = x.shape[0]
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    dev = x.device
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=dev)

    q_nope, q_rope = _queries(p, x, cfg)  # (B,1,H,dn),(B,1,H,dr)
    q_rope = common.apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_t, kr_t = _latents(p, x, cfg, positions)  # (B,1,R),(B,1,dr)

    ckv, k_rope = cache["ckv"], cache["k_rope"]
    t = ckv.shape[1]
    row = min(max(int(pos), 0), t - 1)
    ckv[:, row : row + 1] = ckv_t.to(ckv.dtype)
    k_rope[:, row : row + 1] = kr_t.to(k_rope.dtype)

    # Absorb W_uk into the query: q_eff[h] = W_uk[h] @ q_nope[h]  (R,)
    w_uk = p.w_uk.reshape(r, h, dn)
    q_eff = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)  # (B,1,H,R)

    scale = 1.0 / (dn + dr) ** 0.5
    scores = (
        torch.einsum("bshr,btr->bhst", q_eff.float(), ckv.float())
        + torch.einsum("bshd,btd->bhst", q_rope.float(), k_rope.float())
    ) * scale
    kpos = torch.arange(t, dtype=torch.int32, device=dev)[None, None, None, :]
    scores = torch.where(kpos <= pos, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)

    ctx = torch.einsum("bhst,btr->bshr", probs, ckv)  # (B,1,H,R)
    w_uv = p.w_uv.reshape(r, h, dv)
    out = torch.einsum("bshr,rhd->bshd", ctx, w_uv).reshape(b, 1, h * dv)
    out = out @ p.wo
    return out, {"ckv": ckv, "k_rope": k_rope}
