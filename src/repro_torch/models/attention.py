"""Grouped-query attention with the zoo's option set.

Port of ``repro/models/attention.py``.  Options (all driven by
ModelConfig): GQA/MHA, QKV bias (qwen1.5), per-head qk-RMSNorm (qwen3 /
chameleon), logit soft-capping and local/global alternation (gemma2), RoPE
with configurable theta, cross-attention (whisper's decoder).

* :func:`attention_full` -- self- or cross-attention over a whole
  sequence: always through :func:`repro_torch.kernels.ops.flash_attention`,
  which launches the Hopper kernel for a CUDA tensor and runs its plain
  version for a CPU one.  That includes whisper's non-causal encoder and
  its cross-attention against ``T = encoder_seq`` keys.  The port's layer
  loops pass each layer's window as a Python int, so this is the JAX
  package's ``use_pallas_attention`` branch (``attention.py:116-127``) for
  every layer: the window goes to the kernel only with ``causal``, and the
  kernel masks by row and key index.  With ``return_cache`` it writes K
  and V into a ``(B, cache_len, KVH, dh)`` cache.
* :func:`attention_decode` -- one token against the cache (updated in
  place), and :func:`cross_attention_decode` -- one token against the
  encoder's precomputed K and V (:func:`precompute_cross_kv`): plain
  PyTorch as in the JAX package, where decode never reached the Pallas
  kernel.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common, parallel, partitioning

class Attention(nn.Module):
    """Attention parameters, named as the JAX leaves and drawn in
    ``init_attention``'s order: ``wq``, ``wk``, ``wv``, ``wo``, then the
    zero biases ``bq``/``bk``/``bv`` and the unit ``q_norm``/``k_norm``."""

    def __init__(self, cfg: ModelConfig, *, device, generator: torch.Generator | None = None):
        super().__init__()
        d, dh = cfg.d_model, cfg.resolved_head_dim
        h, kvh = cfg.num_heads, cfg.num_kv_heads
        pdt = common.dtype_of(cfg.param_dtype)
        init = lambda shape, **kw: common.dense_init(generator, shape, pdt, device, **kw)  # noqa: E731
        self.wq = init((d, h * dh))
        self.wk = init((d, kvh * dh))
        self.wv = init((d, kvh * dh))
        self.wo = init((h * dh, d), scale=0.02 / max(cfg.num_layers, 1) ** 0.5)
        if cfg.qkv_bias:
            self.bq = common.zeros_init((h * dh,), pdt, device)
            self.bk = common.zeros_init((kvh * dh,), pdt, device)
            self.bv = common.zeros_init((kvh * dh,), pdt, device)
        if cfg.qk_norm:
            self.q_norm = common.ones_init((dh,), pdt, device)
            self.k_norm = common.ones_init((dh,), pdt, device)


def _project_q(p: Attention, x: torch.Tensor, cfg: ModelConfig, ctx=None):
    """The query heads of the ``wq`` columns ``p`` holds.  ``ctx``: a TP
    context whose ranks each project their own heads, so that the whole
    ``q_norm``'s gradient is summed over the TP group."""
    q = x @ p.wq
    if cfg.qkv_bias:
        q = q + p.bq
    q = q.reshape(*x.shape[:-1], -1, cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = common.rms_norm(q, parallel.tp_copy(p.q_norm, ctx), cfg.norm_eps)
    return q


def _project_kv(p: Attention, kv_src: torch.Tensor, cfg: ModelConfig, ctx=None,
                heads: range | None = None):
    """The KV heads of the ``wk`` / ``wv`` columns ``p`` holds, or with
    ``heads`` those KV heads of whole ``wk`` / ``wv``.  ``ctx``: a TP
    context whose ranks each use part of the whole leaves they read
    (``k_norm``, and ``wk``, ``wv``, ``bk``, ``bv`` with ``heads``), so
    that their gradients are summed over the TP group."""
    dh = cfg.resolved_head_dim
    w = {n: getattr(p, n) for n in ("wk", "wv", "bk", "bv") if hasattr(p, n)}
    if heads is not None:
        cols = slice(heads.start * dh, heads.stop * dh)
        w = {n: parallel.tp_copy(t, ctx)[..., cols] for n, t in w.items()}
    k, v = kv_src @ w["wk"], kv_src @ w["wv"]
    if cfg.qkv_bias:
        k, v = k + w["bk"], v + w["bv"]
    shape = (*kv_src.shape[:-1], -1, dh)
    k, v = k.reshape(shape), v.reshape(shape)
    if cfg.qk_norm:
        k = common.rms_norm(k, parallel.tp_copy(p.k_norm, ctx), cfg.norm_eps)
    return k, v


def _project_qkv(p: Attention, x: torch.Tensor, kv_src: torch.Tensor, cfg: ModelConfig):
    return (_project_q(p, x, cfg), *_project_kv(p, kv_src, cfg))


def _rank_heads(cfg: ModelConfig, lay, rank: int) -> tuple[int, int, range]:
    """``(first query head, query heads, KV heads they use)`` of TP rank
    ``rank`` under the layout ``lay`` (every head without a head split).
    ``tp_layout`` splits the query heads only where each rank's use whole
    groups of KV heads or share one, so the KV heads are consecutive."""
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    if lay is None or not lay.heads:
        return 0, h, range(kvh)
    hl = h // lay.size
    h0, g = rank * hl, h // kvh
    return h0, hl, range(h0 // g, (h0 + hl - 1) // g + 1)


def _scale(cfg: ModelConfig, dh: int) -> float:
    return cfg.query_scale or 1.0 / dh**0.5


def _scores(q, k, mask, cfg: ModelConfig):
    """Float32 scores ``(B, Kv, G, S, T)`` of q ``(B,S,H,Dh)`` against k
    ``(B,T,Kv,Dh)``, soft-capped, masked to -1e30."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * _scale(cfg, dh)
    if cfg.attn_softcap:
        scores = common.softcap(scores, cfg.attn_softcap)
    return torch.where(mask, scores, -1e30)


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """q: ``(B,S,H,Dh)``, k, v: ``(B,T,Kv,Dh)``, mask broadcast to
    ``(B,1,1,S,T)``.  Float32 scores and softmax, probabilities in q's
    dtype, as the JAX ``_sdpa``."""
    b, s, h, dh = q.shape
    probs = torch.softmax(_scores(q, k, mask, cfg), dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h * dh)


def _sdpa_seq_split(q, k, v, mask, cfg: ModelConfig, ctx):
    """:func:`_sdpa` of every head over the TP group's sequence blocks of
    k and v (this rank's block here, ``mask`` over its rows): each rank's
    partial softmax, combined by its log-sum-exp (the group's maximum,
    then the sums of the exponentials and of their products with v, in
    float32)."""
    b, s, h, dh = q.shape
    scores = _scores(q, k, mask, cfg)
    m = parallel.tp_max(scores.amax(dim=-1, keepdim=True), ctx)
    e = torch.exp(scores - m)
    den = parallel.tp_reduce(e.sum(dim=-1), ctx)  # (B, Kv, G, S)
    num = parallel.tp_reduce(torch.einsum("bkgst,btkd->bskgd", e, v.float()), ctx)
    out = num / den.permute(0, 3, 1, 2)[..., None]
    return out.to(q.dtype).reshape(b, s, h * dh)


def attention_full(
    p: Attention,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    window: int | None,
    kv_src: torch.Tensor | None = None,
    causal: bool = True,
    use_rope: bool = True,
    return_cache: bool = False,
    cache_len: int = 0,
    ctx=None,
):
    """Full-sequence attention.  x: ``(B, S, D)``; ``kv_src`` ``(B, T, D)``
    makes it cross-attention (keys and values from ``kv_src``, no RoPE).
    RoPE at positions ``0..S-1`` applies to self-attention with
    ``use_rope``.  ``window`` (a Python int: keys with ``q_pos - k_pos
    < window`` attend, or None) applies only with ``causal``.  Returns
    ``(out (B, S, D), cache)``; the cache is ``{"k", "v"}`` of ``(B,
    cache_len, KVH, dh)`` with the first T rows filled, or None without
    ``return_cache``.

    Under a TP context (``partitioning.tp_layout``) whose query heads
    divide over TP, each rank projects its query heads and the KV heads
    they use (cross-attention: from ``kv_src``, which every rank holds
    whole), runs the kernel on those, multiplies by its rows of ``wo`` and
    sums the result over the TP group.  Its cache is its ``cache_specs``
    block (``partitioning.kv_cache_split`` of ``cache_len`` rows): its KV
    heads, or its block of the rows of every KV head."""
    b, s, _ = x.shape
    self_attn = kv_src is None
    t = x.shape[1] if self_attn else kv_src.shape[1]
    lay = partitioning.tp_layout(cfg, ctx)
    rank = ctx.tp_index if lay is not None else 0
    _, _, kv_heads = _rank_heads(cfg, lay, rank)
    part = lay is not None and lay.heads  # this rank computes its heads only
    tctx = ctx if part else None
    x = parallel.tp_copy(x, tctx)
    kv_src = x if self_attn else parallel.tp_copy(kv_src, tctx)
    q = _project_q(p, x, cfg, tctx)
    k, v = _project_kv(p, kv_src, cfg, tctx, None if not part or lay.kv else kv_heads)
    if use_rope and self_attn:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(
        q, k, v, scale=_scale(cfg, q.shape[-1]), causal=causal,
        window=window if causal else None, softcap=cfg.attn_softcap,
    )
    out = parallel.tp_reduce(out.reshape(b, s, -1) @ p.wo, tctx)
    if not return_cache:
        return out, None
    if t > cache_len:
        raise ValueError(f"a sequence of {t} tokens does not fit a cache of {cache_len}")
    split = partitioning.kv_cache_split(cfg, ctx, cache_len) if lay is not None else None
    lo, rows = 0, cache_len
    if split == "seq":
        rows = cache_len // lay.size
        lo = rank * rows
    hi = min(lo + rows, t)
    if part and not lay.kv:  # k and v hold the rank's KV heads: project every one
        k, v = _project_kv(p, kv_src[:, lo:hi], cfg)
        if use_rope and self_attn:
            positions = torch.arange(lo, hi, dtype=torch.int32, device=x.device)[None, :]
            k = common.apply_rope(k, positions, cfg.rope_theta)
    else:
        k, v = k[:, lo:hi], v[:, lo:hi]
    kvh, dh = k.shape[2], k.shape[3]
    kc = torch.zeros((b, rows, kvh, dh), dtype=k.dtype, device=x.device)
    vc = torch.zeros((b, rows, kvh, dh), dtype=v.dtype, device=x.device)
    kc[:, : max(hi - lo, 0)] = k
    vc[:, : max(hi - lo, 0)] = v
    return out, {"k": kc, "v": vc}


def _attend_cache(p: Attention, q, kc, vc, mask, cfg: ModelConfig, ctx, kv_split):
    """One token's queries ``q`` (the rank's heads under a head split)
    against a rank's block of a cache (``kv_split`` of
    ``partitioning.kv_cache_split``), times its rows of ``wo``, summed over
    TP where the heads split.  By KV heads (``"heads"``): the rank attends
    its heads.  By rows (``"seq"``): the queries of every head are
    gathered, every head's partial softmax over the rank's rows is
    combined over TP by its log-sum-exp, and the rank keeps its heads.
    Whole (None): the rank attends its heads against the KV heads they
    use."""
    lay = partitioning.tp_layout(cfg, ctx)
    rank = ctx.tp_index if lay is not None else 0
    h0, hl, kv_heads = _rank_heads(cfg, lay, rank)
    part = lay is not None and lay.heads
    if (kv_split == "heads") != (lay is not None and lay.kv):
        raise ValueError(f"a cache split {kv_split!r} under the layout {lay}")
    if kv_split == "seq":
        if part:
            q = parallel.tp_gather(q, ctx, dim=2)
        out = _sdpa_seq_split(q, kc, vc, mask, cfg, ctx)
        if part:
            dh = cfg.resolved_head_dim
            out = out[..., h0 * dh : (h0 + hl) * dh]
    elif part and not lay.kv:
        used = slice(kv_heads.start, kv_heads.stop)
        out = _sdpa(q, kc[:, :, used], vc[:, :, used], mask, cfg)
    else:
        out = _sdpa(q, kc, vc, mask, cfg)
    return parallel.tp_reduce(out @ p.wo, ctx if part else None)


def attention_decode(p: Attention, x: torch.Tensor, cache: dict, pos: int, cfg: ModelConfig, *,
                     window: int, use_rope: bool = True, ctx=None, kv_split: str | None = None):
    """One-token decode.  x: ``(B, 1, D)``; cache ``k``/``v``: ``(B, T, Kv,
    Dh)``, written in place at row ``pos`` clamped to the cache as
    ``lax.dynamic_update_slice`` clamps it; the mask keeps keys with
    ``k_pos <= pos`` and ``pos - k_pos < window``.  Returns ``(out (B, 1,
    D), cache)``.

    Under a TP context the cache is this rank's block (``kv_split`` of
    ``partitioning.kv_cache_split``); a cache split by rows takes the new
    K and V only on the rank whose rows hold ``pos``.  The attention
    itself is :func:`_attend_cache`'s."""
    b = x.shape[0]
    lay = partitioning.tp_layout(cfg, ctx)
    rank = ctx.tp_index if lay is not None else 0
    q, k, v = _project_qkv(p, x, x, cfg)
    if use_rope:
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    rows = kc.shape[1]
    lo, t = (rank * rows, rows * lay.size) if kv_split == "seq" else (0, rows)
    row = min(max(int(pos), 0), t - 1)
    if lo <= row < lo + rows:
        kc[:, row - lo : row - lo + 1] = k.to(kc.dtype)
        vc[:, row - lo : row - lo + 1] = v.to(vc.dtype)
    kpos = torch.arange(lo, lo + rows, dtype=torch.int32, device=x.device)
    mask = ((kpos <= pos) & (pos - kpos < window))[None, None, None, None, :]
    return _attend_cache(p, q, kc, vc, mask, cfg, ctx, kv_split), {"k": kc, "v": vc}


def cross_attention_decode(p: Attention, x: torch.Tensor, cross_cache: dict, cfg: ModelConfig,
                           ctx=None, kv_split: str | None = None):
    """Decode-time cross-attention: x ``(B, 1, D)`` against the encoder's
    precomputed ``cross_cache`` ``k``/``v`` ``(B, T, KVH, dh)``, every key
    attended.  Under a TP context the cross cache is the rank's block
    (``kv_split`` of ``partitioning.kv_cache_split`` of the encoder's
    rows), attended as :func:`_attend_cache` attends it."""
    k, v = cross_cache["k"], cross_cache["v"]
    mask = torch.ones((1, 1, 1, 1, k.shape[1]), dtype=torch.bool, device=x.device)
    return _attend_cache(p, _project_q(p, x, cfg), k, v, mask, cfg, ctx, kv_split)


def precompute_cross_kv(p: Attention, enc_out: torch.Tensor, cfg: ModelConfig):
    """The encoder output ``(B, T, D)`` projected to ``{"k", "v"}`` of
    ``(B, T, KVH, dh)`` once, for whisper's decode."""
    k, v = _project_kv(p, enc_out, cfg)
    return {"k": k, "v": v}
