"""Multi-head Latent Attention (DeepSeek V2/V3).

Port of ``repro/models/mla.py``.  The KV cache stores only the compressed
latent (``kv_lora_rank``) plus one shared RoPE key head.

* :func:`mla_full` -- the expanded computation for prefill: per-head K/V
  are materialised once over the sequence and attended through
  :func:`repro_torch.models.flash.flash_sdpa`.
* :func:`mla_decode` -- the absorbed computation: ``W_uk`` is folded into
  the query and ``W_uv`` into the output, so one token attends MQA-style
  against the compressed cache.

Under a TP context whose TP group has several ranks and whose heads divide
over it (``partitioning.tp_layout``), each rank holds its heads' columns
of ``w_uq`` (or ``wq``), ``w_uk`` and ``w_uv``, their rows of ``wo`` and
its column block of ``w_dq``; ``w_dkv``, ``kv_norm`` and ``q_norm`` stay
whole.  It computes its heads only and sums its rows of ``wo``'s product
over the TP group; the reference lands that product with a
sequence-parallel reduce-scatter, the port keeps the residual stream
whole and all-reduces it (the same sums, in another order).  The
compressed cache is the rank's ``cache_specs`` block of the rows where
they divide over TP (``kv_split="seq"``): decode gathers every head's
absorbed query over TP, scores it against the rank's rows and combines the
partial softmaxes by their log-sum-exp in float32.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, flash, parallel, partitioning


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


def _queries(p: MLA, x: torch.Tensor, cfg: ModelConfig, ctx=None):
    """The query heads of the columns ``p`` holds: ``(B,S,H,dn)``,
    ``(B,S,H,dr)``.  ``ctx``: a TP context whose ranks each project their
    own heads.  ``w_dq``'s column block of ``cq`` is then gathered with
    ``parallel.all_gather``, whose adjoint sums every rank's heads' share
    of ``cq``'s gradient over the group before it takes the block; the
    whole ``q_norm`` (and a whole ``w_dq``) has its gradient summed over
    TP."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        w_dq = p.w_dq
        if ctx is not None and w_dq.shape[-1] == cfg.q_lora_rank:
            w_dq = parallel.tp_copy(w_dq, ctx)
        cq = x @ w_dq
        if cq.shape[-1] < cfg.q_lora_rank:
            cq = parallel.all_gather(cq, ctx.group(ctx.tp_axis), cq.dim() - 1)
        cq = common.rms_norm(cq, parallel.tp_copy(p.q_norm, ctx), cfg.norm_eps)
        q = cq @ p.w_uq
    else:
        q = x @ p.wq
    q = q.reshape(*x.shape[:-1], -1, dn + dr)
    return q[..., :dn], q[..., dn:]


def _latents(p: MLA, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor, ctx=None):
    """Compressed kv latent and rotated shared rope key.  ``ctx``: a TP
    context whose ranks each use the latents for their own heads, so that
    the whole ``w_dkv``'s and ``kv_norm``'s gradients are summed over TP."""
    r = cfg.kv_lora_rank
    ckv_full = x @ parallel.tp_copy(p.w_dkv, ctx)
    ckv = common.rms_norm(ckv_full[..., :r], parallel.tp_copy(p.kv_norm, ctx), cfg.norm_eps)
    k_rope = ckv_full[..., r:][..., None, :]  # (B,S,1,dr) shared head
    k_rope = common.apply_rope(k_rope, positions, cfg.rope_theta)
    return ckv, k_rope[..., 0, :]  # (B,S,R), (B,S,dr)


def _rank_heads(cfg: ModelConfig, ctx) -> tuple[int, int, object]:
    """``(first head, heads, TP context)`` of this rank: its block of the
    heads under a layout that splits them (the context then sums the
    rank's work over TP), else every head and no context."""
    lay = partitioning.tp_layout(cfg, ctx)
    if lay is None or not lay.heads:
        return 0, cfg.num_heads, None
    hl = cfg.num_heads // lay.size
    return ctx.tp_index * hl, hl, ctx


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
    first S rows filled, or None without ``return_cache``.  Under a TP
    context that splits the heads the rank computes its heads and the
    cache is its block of the rows where ``partitioning.kv_cache_split``
    says ``"seq"``.
    """
    b, s, _ = x.shape
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    _, hl, tctx = _rank_heads(cfg, ctx)
    x = parallel.tp_copy(x, tctx)

    q_nope, q_rope = _queries(p, x, cfg, tctx)
    q_rope = common.apply_rope(q_rope, positions, cfg.rope_theta)
    ckv, k_rope = _latents(p, x, cfg, positions, tctx)

    k_nope = (ckv @ p.w_uk).reshape(b, s, hl, dn)
    v = (ckv @ p.w_uv).reshape(b, s, hl, dv)
    dp, tp = (ctx.dp_axes, ctx.tp_axis) if ctx is not None else (None, None)
    shard = lambda a: parallel.hint(a, ctx, dp, None, tp, None)  # noqa: E731
    q = shard(torch.cat([q_nope, q_rope], dim=-1))
    k = shard(torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, hl, dr)], dim=-1))
    v = shard(v)

    scale = 1.0 / (dn + dr) ** 0.5
    out = flash.flash_sdpa(q, k, v, scale=scale, q_positions=positions, causal=True)
    # The reference's sequence-parallel landing is a reduce-scatter; the
    # port's residual stream stays whole, so the rows of wo all-reduce.
    out = parallel.tp_reduce(parallel.hint(out, ctx, dp, None, tp) @ p.wo, tctx)

    if not return_cache:
        return out, None
    if s > cache_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {cache_len}")
    lo, rows = 0, cache_len
    if partitioning.kv_cache_split(cfg, ctx, cache_len) == "seq":
        rows = cache_len // ctx.tp_size
        lo = ctx.tp_index * rows
    hi = min(lo + rows, s)
    n = max(hi - lo, 0)
    r = cfg.kv_lora_rank
    ckv_c = torch.zeros((b, rows, r), dtype=ckv.dtype, device=x.device)
    kr_c = torch.zeros((b, rows, dr), dtype=k_rope.dtype, device=x.device)
    ckv_c[:, :n] = ckv[:, lo:lo + n]
    kr_c[:, :n] = k_rope[:, lo:lo + n]
    return out, {"ckv": ckv_c, "k_rope": kr_c}


def decode_queries(p: MLA, x: torch.Tensor, pos: int, cfg: ModelConfig, ctx=None):
    """The one-token decode's absorbed queries of the heads ``p`` holds,
    ``W_uk`` folded in (``q_eff (B,1,H,R)``, ``q_rope (B,1,H,dr)``), and the
    token's latents to write (``(B,1,R)``, ``(B,1,dr)``)."""
    b = x.shape[0]
    dn, r = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _queries(p, x, cfg, ctx)  # (B,1,H,dn),(B,1,H,dr)
    q_rope = common.apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_t, kr_t = _latents(p, x, cfg, positions, ctx)  # (B,1,R),(B,1,dr)
    # Absorb W_uk into the query: q_eff[h] = W_uk[h] @ q_nope[h]  (R,)
    w_uk = p.w_uk.reshape(r, -1, dn)
    q_eff = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)  # (B,1,H,R)
    return q_eff, q_rope, ckv_t, kr_t


def absorbed_scores(q_eff, q_rope, ckv, k_rope, kpos, pos: int, cfg: ModelConfig):
    """Float32 scores ``(B, H, 1, T)`` of the absorbed queries against the
    cache rows ``ckv`` ``(B,T,R)`` / ``k_rope`` ``(B,T,dr)`` at positions
    ``kpos`` ``(T,)``; keys past ``pos`` masked to -1e30."""
    scale = 1.0 / (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** 0.5
    scores = (
        torch.einsum("bshr,btr->bhst", q_eff.float(), ckv.float())
        + torch.einsum("bshd,btd->bhst", q_rope.float(), k_rope.float())
    ) * scale
    return torch.where(kpos[None, None, None, :] <= pos, scores, -1e30)


def partial_softmax(scores, ckv, m):
    """A block of rows' share of the softmax against the shift ``m`` (the
    maximum over every block): ``(sum of exp(scores - m) (B,H,1), its
    products with the block's latents (B,1,H,R))``, float32."""
    e = torch.exp(scores - m)
    return e.sum(dim=-1), torch.einsum("bhst,btr->bshr", e, ckv.float())


def decode_out(p: MLA, ctx_r: torch.Tensor, cfg: ModelConfig):
    """The context ``(B,1,H,R)`` of the heads ``p`` holds through their
    ``W_uv`` and rows of ``wo``: ``(B, 1, D)``, not yet summed over TP."""
    b, _, hl, r = ctx_r.shape
    w_uv = p.w_uv.reshape(r, hl, cfg.v_head_dim)
    out = torch.einsum("bshr,rhd->bshd", ctx_r, w_uv).reshape(b, 1, hl * cfg.v_head_dim)
    return out @ p.wo


def mla_decode(p: MLA, x: torch.Tensor, cache: dict, pos: int, cfg: ModelConfig, ctx=None,
               kv_split: str | None = None):
    """Absorbed single-token decode against the compressed cache.

    x: ``(B, 1, D)``; ``pos`` the new token's position.  The token's
    latents are written into ``cache`` in place, at row ``pos`` clamped to
    the cache as ``lax.dynamic_update_slice`` clamps it (a ``pos`` past the
    cache overwrites the last row); the mask keeps keys ``<= pos``.
    Returns ``(out (B, 1, D), cache)``.

    Under a TP context the rank's heads are its block where the layout
    splits them, and the cache its block of the rows where ``kv_split`` is
    ``"seq"`` (``partitioning.kv_cache_split``): every head's absorbed
    query is gathered over TP, the rank writes the new latents only where
    ``pos`` falls in its block, every head's partial softmax over its rows
    is combined over TP by its log-sum-exp in float32, and the rank keeps
    its heads for its ``W_uv`` block and rows of ``wo``, summed over TP.
    """
    if kv_split not in (None, "seq") or (
            kv_split is not None and partitioning.tp_layout(cfg, ctx) is None):
        raise ValueError(f"an MLA cache split {kv_split!r} under the context {ctx}")
    h0, hl, tctx = _rank_heads(cfg, ctx)
    q_eff, q_rope, ckv_t, kr_t = decode_queries(p, x, pos, cfg, tctx)

    ckv, k_rope = cache["ckv"], cache["k_rope"]
    rows = ckv.shape[1]
    lo, t = (ctx.tp_index * rows, rows * ctx.tp_size) if kv_split == "seq" else (0, rows)
    row = min(max(int(pos), 0), t - 1)
    if lo <= row < lo + rows:
        ckv[:, row - lo : row - lo + 1] = ckv_t.to(ckv.dtype)
        k_rope[:, row - lo : row - lo + 1] = kr_t.to(k_rope.dtype)

    kpos = torch.arange(lo, lo + rows, dtype=torch.int32, device=x.device)
    if kv_split == "seq":
        if tctx is not None:
            q_eff = parallel.tp_gather(q_eff, ctx, dim=2)
            q_rope = parallel.tp_gather(q_rope, ctx, dim=2)
        scores = absorbed_scores(q_eff, q_rope, ckv, k_rope, kpos, pos, cfg)
        m = parallel.tp_max(scores.amax(dim=-1, keepdim=True), ctx)
        den, num = partial_softmax(scores, ckv, m)
        den, num = parallel.tp_reduce(den, ctx), parallel.tp_reduce(num, ctx)
        ctx_r = (num / den.permute(0, 2, 1)[..., None]).to(x.dtype)[:, :, h0:h0 + hl]
    else:
        scores = absorbed_scores(q_eff, q_rope, ckv, k_rope, kpos, pos, cfg)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx_r = torch.einsum("bhst,btr->bshr", probs, ckv)  # (B,1,H,R)
    out = parallel.tp_reduce(decode_out(p, ctx_r, cfg), tctx)
    return out, {"ckv": ckv, "k_rope": k_rope}
