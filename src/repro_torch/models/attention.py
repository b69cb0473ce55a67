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
from repro_torch.models import common

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


def _project_q(p: Attention, x: torch.Tensor, cfg: ModelConfig):
    q = x @ p.wq
    if cfg.qkv_bias:
        q = q + p.bq
    q = q.reshape(*x.shape[:-1], cfg.num_heads, cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = common.rms_norm(q, p.q_norm, cfg.norm_eps)
    return q


def _project_kv(p: Attention, kv_src: torch.Tensor, cfg: ModelConfig):
    k, v = kv_src @ p.wk, kv_src @ p.wv
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    shape = (*kv_src.shape[:-1], cfg.num_kv_heads, cfg.resolved_head_dim)
    k, v = k.reshape(shape), v.reshape(shape)
    if cfg.qk_norm:
        k = common.rms_norm(k, p.k_norm, cfg.norm_eps)
    return k, v


def _project_qkv(p: Attention, x: torch.Tensor, kv_src: torch.Tensor, cfg: ModelConfig):
    return (_project_q(p, x, cfg), *_project_kv(p, kv_src, cfg))


def _scale(cfg: ModelConfig, dh: int) -> float:
    return cfg.query_scale or 1.0 / dh**0.5


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """q: ``(B,S,H,Dh)``, k, v: ``(B,T,Kv,Dh)``, mask broadcast to
    ``(B,1,1,S,T)``.  Float32 scores and softmax, probabilities in q's
    dtype, as the JAX ``_sdpa``."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * _scale(cfg, dh)
    if cfg.attn_softcap:
        scores = common.softcap(scores, cfg.attn_softcap)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h * dh)


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
):
    """Full-sequence attention.  x: ``(B, S, D)``; ``kv_src`` ``(B, T, D)``
    makes it cross-attention (keys and values from ``kv_src``, no RoPE).
    RoPE at positions ``0..S-1`` applies to self-attention with
    ``use_rope``.  ``window`` (a Python int: keys with ``q_pos - k_pos
    < window`` attend, or None) applies only with ``causal``.  Returns
    ``(out (B, S, D), cache)``; the cache is ``{"k", "v"}`` of ``(B,
    cache_len, KVH, dh)`` with the first T rows filled, or None without
    ``return_cache``."""
    b, s, _ = x.shape
    self_attn = kv_src is None
    kv_src = x if self_attn else kv_src
    t = kv_src.shape[1]
    q, k, v = _project_qkv(p, x, kv_src, cfg)
    if use_rope and self_attn:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(
        q, k, v, scale=_scale(cfg, q.shape[-1]), causal=causal,
        window=window if causal else None, softcap=cfg.attn_softcap,
    )
    out = out.reshape(b, s, -1) @ p.wo
    if not return_cache:
        return out, None
    if t > cache_len:
        raise ValueError(f"a sequence of {t} tokens does not fit a cache of {cache_len}")
    kvh, dh = k.shape[2], k.shape[3]
    kc = torch.zeros((b, cache_len, kvh, dh), dtype=k.dtype, device=x.device)
    vc = torch.zeros((b, cache_len, kvh, dh), dtype=v.dtype, device=x.device)
    kc[:, :t] = k
    vc[:, :t] = v
    return out, {"k": kc, "v": vc}


def attention_decode(p: Attention, x: torch.Tensor, cache: dict, pos: int, cfg: ModelConfig, *,
                     window: int, use_rope: bool = True):
    """One-token decode.  x: ``(B, 1, D)``; cache ``k``/``v``: ``(B, T, Kv,
    Dh)``, written in place at row ``pos`` clamped to the cache as
    ``lax.dynamic_update_slice`` clamps it; the mask keeps keys with
    ``k_pos <= pos`` and ``pos - k_pos < window``.  Returns ``(out (B, 1,
    D), cache)``."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, x, cfg)
    if use_rope:
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    t = kc.shape[1]
    row = min(max(int(pos), 0), t - 1)
    kc[:, row : row + 1] = k.to(kc.dtype)
    vc[:, row : row + 1] = v.to(vc.dtype)
    kpos = torch.arange(t, dtype=torch.int32, device=x.device)
    mask = ((kpos <= pos) & (pos - kpos < window))[None, None, None, None, :]
    out = _sdpa(q, kc, vc, mask, cfg) @ p.wo
    return out, {"k": kc, "v": vc}


def cross_attention_decode(p: Attention, x: torch.Tensor, cross_cache: dict, cfg: ModelConfig):
    """Decode-time cross-attention: x ``(B, 1, D)`` against the encoder's
    precomputed ``cross_cache`` ``k``/``v`` ``(B, T, KVH, dh)``, every key
    attended."""
    k, v = cross_cache["k"], cross_cache["v"]
    mask = torch.ones((1, 1, 1, 1, k.shape[1]), dtype=torch.bool, device=x.device)
    return _sdpa(_project_q(p, x, cfg), k, v, mask, cfg) @ p.wo


def precompute_cross_kv(p: Attention, enc_out: torch.Tensor, cfg: ModelConfig):
    """The encoder output ``(B, T, D)`` projected to ``{"k", "v"}`` of
    ``(B, T, KVH, dh)`` once, for whisper's decode."""
    k, v = _project_kv(p, enc_out, cfg)
    return {"k": k, "v": v}
