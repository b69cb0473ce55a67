"""Block definitions for every family.

Port of ``repro/models/transformer.py``: the dense / MoE / VLM block
(:class:`LMBlock`, MLA for DeepSeek V2/V3, grouped-query attention for
Gemma2, Qwen, SmolLM, Chameleon), RWKV-6's (:class:`RWKVBlock`), Hymba's
parallel attention + Mamba block (:class:`HymbaBlock`) and Whisper's
encoder and decoder blocks (:class:`EncoderBlock`, :class:`DecoderBlock`).
The JAX package scans one weight-stacked layer body with a traced
per-layer window; here a stack is a list of block modules, the callers
loop over it and pass each layer's window as a Python int.  The ssm and
audio families use LayerNorm (a :class:`Norm` with a bias), the others
RMSNorm.

Modes: "train" (no cache), "prefill" (returns the cache) and "decode" (one
token, cache in / out).  Each full-sequence block ends in
``common.grad_dtype_barrier`` where the JAX package has it; :func:`run_layer`
is ``scan_stack``'s ``remat``: ``torch.utils.checkpoint`` around a layer.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, ffn, mla, parallel, ssm

BIG_WINDOW = 1 << 30
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    l = cfg.num_layers
    w = np.full((l,), BIG_WINDOW, np.int32)
    if cfg.layer_pattern == "alt_local_global" and cfg.sliding_window:
        w[0::2] = cfg.sliding_window  # even layers local (gemma2)
    elif cfg.layer_pattern == "mostly_local" and cfg.sliding_window:
        w[:] = cfg.sliding_window
        for g in cfg.global_layers:
            if g < l:
                w[g] = BIG_WINDOW
    return w


def check_supported(cfg: ModelConfig) -> None:
    """The port runs every family of the JAX package."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}; known: {FAMILIES}")


# --------------------------------------------------------------------------
# block init
# --------------------------------------------------------------------------


class Norm(nn.Module):
    """Norm parameters (``_norm_params``): ``{"scale"}`` for RMSNorm,
    ``{"scale", "bias"}`` for LayerNorm."""

    def __init__(self, cfg: ModelConfig, *, device, bias: bool = False):
        super().__init__()
        pdt = common.dtype_of(cfg.param_dtype)
        self.scale = common.ones_init((cfg.d_model,), pdt, device)
        if bias:
            self.bias = common.zeros_init((cfg.d_model,), pdt, device)


def uses_layer_norm(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "audio")


def _norm(p: Norm, x: torch.Tensor, cfg: ModelConfig):
    if hasattr(p, "bias"):
        return common.layer_norm(x, p.scale, p.bias, cfg.norm_eps)
    return common.rms_norm(x, p.scale, cfg.norm_eps)


class LMBlock(nn.Module):
    """One pre-norm block (``init_lm_block``): ``ln1``, ``ln2``, ``attn``
    (MLA or GQA), the post-norms if any, and ``ffn`` (dense) or ``moe``."""

    def __init__(self, cfg: ModelConfig, *, moe_layer: bool, device, generator=None):
        super().__init__()
        check_supported(cfg)
        ln = uses_layer_norm(cfg)
        self.ln1 = Norm(cfg, device=device, bias=ln)
        self.ln2 = Norm(cfg, device=device, bias=ln)
        if cfg.use_mla:
            self.attn = mla.MLA(cfg, device=device, generator=generator)
        else:
            self.attn = attention.Attention(cfg, device=device, generator=generator)
        if cfg.post_norms:
            self.ln1_post = Norm(cfg, device=device, bias=ln)
            self.ln2_post = Norm(cfg, device=device, bias=ln)
        if moe_layer:
            self.moe = ffn.MoEFFN(cfg, device=device, generator=generator)
        else:
            self.ffn = ffn.DenseFFN(cfg, device=device, generator=generator)


class RWKVBlock(nn.Module):
    """``init_rwkv_block``: LayerNorms ``ln1`` / ``ln2``, time mix ``tm``,
    channel mix ``cm``."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        self.ln1 = Norm(cfg, device=device, bias=True)
        self.ln2 = Norm(cfg, device=device, bias=True)
        self.tm = ssm.RWKVTimeMix(cfg, device=device, generator=generator)
        self.cm = ssm.RWKVChannelMix(cfg, device=device, generator=generator)


class HymbaBlock(nn.Module):
    """``init_hymba_block``: RMSNorms ``ln1`` / ``ln2``, attention and Mamba
    heads side by side, the dense FFN, and the bare scales of the two
    branches' output norms."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        pdt = common.dtype_of(cfg.param_dtype)
        self.ln1 = Norm(cfg, device=device)
        self.ln2 = Norm(cfg, device=device)
        self.attn = attention.Attention(cfg, device=device, generator=generator)
        self.mamba = ssm.Mamba(cfg, device=device, generator=generator)
        self.ffn = ffn.DenseFFN(cfg, device=device, generator=generator)
        self.attn_out_norm = common.ones_init((cfg.d_model,), pdt, device)
        self.ssm_out_norm = common.ones_init((cfg.d_model,), pdt, device)


class EncoderBlock(nn.Module):
    """``init_encoder_block``: whisper's encoder layer (LayerNorms,
    non-causal attention without RoPE, dense FFN)."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        self.ln1 = Norm(cfg, device=device, bias=True)
        self.ln2 = Norm(cfg, device=device, bias=True)
        self.attn = attention.Attention(cfg, device=device, generator=generator)
        self.ffn = ffn.DenseFFN(cfg, device=device, generator=generator)


class DecoderBlock(nn.Module):
    """``init_decoder_block``: whisper's decoder layer (causal
    self-attention ``attn``, cross-attention ``cross`` after ``ln_x``,
    dense FFN)."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        self.ln1 = Norm(cfg, device=device, bias=True)
        self.ln_x = Norm(cfg, device=device, bias=True)
        self.ln2 = Norm(cfg, device=device, bias=True)
        self.attn = attention.Attention(cfg, device=device, generator=generator)
        self.cross = attention.Attention(cfg, device=device, generator=generator)
        self.ffn = ffn.DenseFFN(cfg, device=device, generator=generator)


# --------------------------------------------------------------------------
# block forward
# --------------------------------------------------------------------------


def run_layer(cfg: ModelConfig, fn, *args):
    """``fn(*args)``; with ``cfg.remat`` and a graph being recorded, under
    non-reentrant ``torch.utils.checkpoint``, so that the layer's
    activations are recomputed in the backward instead of kept.  ``fn``
    must not read loop variables late: bind them (``functools.partial``)."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _ffn_part(p: LMBlock, x, cfg: ModelConfig, ctx, bias, moe_layer: bool):
    h = _norm(p.ln2, x, cfg)
    if moe_layer:
        f, counts = ffn.moe_ffn(p.moe, h, bias, cfg, ctx)
    else:
        f = ffn.dense_ffn(p.ffn, h, cfg, ctx)
        counts = _zero_counts(cfg, ctx, x.device)
    if cfg.post_norms:
        f = _norm(p.ln2_post, f, cfg)
    return x + f, counts


def lm_block_full(
    p: LMBlock,
    x: torch.Tensor,
    cfg: ModelConfig,
    ctx=None,
    *,
    window,
    bias,
    moe_layer: bool,
    return_cache: bool = False,
    cache_len: int = 0,
):
    """Full-sequence block.  Returns ``(x, cache, counts)``.  ``window``
    (a Python int) masks GQA attention; MLA attends globally.  Under a TP
    context of the dense decoder the attention and the FFN compute this
    rank's heads and hidden units (``partitioning.tp_layout``), MLA's
    heads and the MoE layer's shared experts too, and the cache is its
    block."""
    h = _norm(p.ln1, x, cfg)
    if cfg.use_mla:
        a, cache = mla.mla_full(
            p.attn, h, cfg, return_cache=return_cache, cache_len=cache_len, ctx=ctx
        )
    else:
        a, cache = attention.attention_full(
            p.attn, h, cfg, window=window, return_cache=return_cache, cache_len=cache_len,
            ctx=ctx,
        )
    if cfg.post_norms:
        a = _norm(p.ln1_post, a, cfg)
    x, counts = _ffn_part(p, x + a, cfg, ctx, bias, moe_layer)
    return common.grad_dtype_barrier(x), cache, counts


def _zero_counts(cfg: ModelConfig, ctx, device):
    e = max(cfg.n_routed_experts, 1)
    shape = (e,) if ctx is None else (ctx.dp_size, ctx.tp_size, e)
    return torch.zeros(shape, dtype=torch.float32, device=device)


def lm_block_decode(
    p: LMBlock, x, cache, pos, cfg: ModelConfig, ctx=None, *, window, bias, moe_layer,
    kv_split: str | None = None,
):
    """One-token block against its cache (updated in place; under a TP
    context this rank's block, ``kv_split`` as
    ``partitioning.kv_cache_split`` gave it).  Returns ``(x, cache,
    counts)``."""
    h = _norm(p.ln1, x, cfg)
    if cfg.use_mla:
        a, cache = mla.mla_decode(p.attn, h, cache, pos, cfg, ctx, kv_split)
    else:
        a, cache = attention.attention_decode(p.attn, h, cache, pos, cfg, window=window,
                                              ctx=ctx, kv_split=kv_split)
    if cfg.post_norms:
        a = _norm(p.ln1_post, a, cfg)
    x, counts = _ffn_part(p, x + a, cfg, ctx, bias, moe_layer)
    return x, cache, counts


def rwkv_block(p: RWKVBlock, x: torch.Tensor, cfg: ModelConfig, state: dict | None = None,
               ctx=None):
    """``state``: None (zeros) or ``{"wkv", "tm_shift", "cm_shift"}``.
    Returns ``(x, new state)``.  Under a TP context the time and channel
    mix compute the rank's heads and hidden units, and the state is the
    rank's block (``ssm.rwkv_time_mix``); the residual stream stays whole
    and carries the reference's sequence-parallel hints (``(B, S/tp, D)``),
    which move nothing."""
    st = state or {}
    dp, tp = (ctx.dp_axes, ctx.tp_axis) if ctx is not None else (None, None)
    sp = lambda a: parallel.hint(a, ctx, dp, tp)  # noqa: E731
    x = sp(x)
    h, wkv, tm_shift = ssm.rwkv_time_mix(
        p.tm, _norm(p.ln1, x, cfg), cfg, state=st.get("wkv"), shift_prev=st.get("tm_shift"),
        ctx=ctx)
    x = sp(x + sp(h))
    h, cm_shift = ssm.rwkv_channel_mix(p.cm, _norm(p.ln2, x, cfg), cfg,
                                       shift_prev=st.get("cm_shift"), ctx=ctx)
    new = {"wkv": wkv, "tm_shift": tm_shift, "cm_shift": cm_shift}
    return common.grad_dtype_barrier(sp(x + h)), new


def hymba_block(p: HymbaBlock, x: torch.Tensor, cfg: ModelConfig, *, window: int, mode: str,
                cache: dict | None = None, pos: int | None = None, cache_len: int = 0,
                ctx=None, kv_split: str | None = None):
    """Attention and Mamba on the same normed input, fused as ``0.5 *
    (rms(attn) + rms(ssm))``.  ``mode`` "prefill" returns the layer's cache
    ``{"k", "v", "ssm", "conv"}``; "decode" takes it (K and V written in
    place) and returns the new one; "train" returns None.  Under a TP
    context the attention, Mamba and the FFN compute the rank's heads,
    channels and hidden units and return summed outputs, which the two
    output norms then act on; the cache is the rank's block (``kv_split``
    the KV cache's, from ``partitioning.kv_cache_split``)."""
    h = _norm(p.ln1, x, cfg)
    st = cache or {}
    if mode == "decode":
        a, kv = attention.attention_decode(p.attn, h, {"k": st["k"], "v": st["v"]}, pos, cfg,
                                           window=window, ctx=ctx, kv_split=kv_split)
    else:
        a, kv = attention.attention_full(p.attn, h, cfg, window=window,
                                         return_cache=(mode == "prefill"), cache_len=cache_len,
                                         ctx=ctx)
    s, ssm_state, conv_state = ssm.mamba(p.mamba, h, cfg, state=st.get("ssm"),
                                         conv_state=st.get("conv"), ctx=ctx)
    fused = 0.5 * (common.rms_norm(a, p.attn_out_norm, cfg.norm_eps)
                   + common.rms_norm(s, p.ssm_out_norm, cfg.norm_eps))
    x = x + fused
    x = common.grad_dtype_barrier(x + ffn.dense_ffn(p.ffn, _norm(p.ln2, x, cfg), cfg, ctx))
    if mode == "train":
        return x, None
    return x, {"ssm": ssm_state, "conv": conv_state, **(kv or {})}


def encoder_block(p: EncoderBlock, x: torch.Tensor, cfg: ModelConfig, ctx=None):
    h = _norm(p.ln1, x, cfg)
    a, _ = attention.attention_full(p.attn, h, cfg, window=BIG_WINDOW, causal=False,
                                    use_rope=False, ctx=ctx)
    x = x + a
    return common.grad_dtype_barrier(x + ffn.dense_ffn(p.ffn, _norm(p.ln2, x, cfg), cfg, ctx))


def decoder_block(p: DecoderBlock, x: torch.Tensor, enc_out: torch.Tensor | None,
                  cfg: ModelConfig, *, mode: str, cache: dict | None = None,
                  pos: int | None = None, cache_len: int = 0, ctx=None,
                  kv_split: str | None = None, cross_split: str | None = None):
    """Causal self-attention (no RoPE), cross-attention on the encoder
    output, dense FFN.  "prefill" attends ``enc_out`` through the kernel
    and returns the layer's cache ``{"k", "v", "cross_k", "cross_v"}``;
    "decode" attends the cached ``cross_k`` / ``cross_v`` (``enc_out`` is
    not used) and writes K and V in place; "train" returns None.  Under a
    TP context each attention and the FFN compute the rank's heads and
    hidden units, and the caches are the rank's blocks (``kv_split`` the
    self cache's, ``cross_split`` the cross cache's)."""
    st = cache or {}
    h = _norm(p.ln1, x, cfg)
    if mode == "decode":
        a, kv = attention.attention_decode(p.attn, h, {"k": st["k"], "v": st["v"]}, pos, cfg,
                                           window=BIG_WINDOW, use_rope=False, ctx=ctx,
                                           kv_split=kv_split)
    else:
        a, kv = attention.attention_full(p.attn, h, cfg, window=BIG_WINDOW, use_rope=False,
                                         return_cache=(mode == "prefill"), cache_len=cache_len,
                                         ctx=ctx)
    x = x + a
    h = _norm(p.ln_x, x, cfg)
    if mode == "decode":
        cross_kv = {"k": st["cross_k"], "v": st["cross_v"]}
        c = attention.cross_attention_decode(p.cross, h, cross_kv, cfg, ctx, cross_split)
    else:
        # The cross K / V come back as the call's cache, projected once.
        c, cross_kv = attention.attention_full(p.cross, h, cfg, window=BIG_WINDOW,
                                               kv_src=enc_out, causal=False, use_rope=False,
                                               return_cache=(mode == "prefill"),
                                               cache_len=enc_out.shape[1], ctx=ctx)
    x = x + c
    x = common.grad_dtype_barrier(x + ffn.dense_ffn(p.ffn, _norm(p.ln2, x, cfg), cfg, ctx))
    if mode == "train":
        return x, None
    return x, {**(kv or {}), "cross_k": cross_kv["k"], "cross_v": cross_kv["v"]}
