"""Block definitions of the dense / MoE / VLM language models.

Port of the dense/moe part of ``repro/models/transformer.py``: a block's
attention is MLA (DeepSeek V2/V3) or grouped-query attention (Gemma2,
Qwen, SmolLM, Chameleon).  The JAX package scans one weight-stacked layer
body with a traced per-layer window; here a stack is a list of
:class:`LMBlock` modules, the callers loop over it and pass each layer's
window as a Python int.  The rwkv, hymba and whisper blocks come with
ROADMAP item 13.

Modes: "prefill" (returns the cache) and "decode" (one token, cache in /
out).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, ffn, mla

BIG_WINDOW = 1 << 30
ITEM_13 = "ROADMAP item 13 (the rwkv, hymba and whisper blocks)"


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
    """The port runs the dense / moe / vlm families, with MLA or GQA."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(f"the {cfg.family!r} family's blocks come with {ITEM_13}")


# --------------------------------------------------------------------------
# block init
# --------------------------------------------------------------------------


class Norm(nn.Module):
    """RMSNorm parameters ``{"scale"}`` (``_norm_params``).  The LayerNorm
    variant belongs to the ssm / audio families (ROADMAP item 13)."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.scale = common.ones_init((cfg.d_model,), common.dtype_of(cfg.param_dtype), device)


def _norm(p: Norm, x: torch.Tensor, cfg: ModelConfig):
    return common.rms_norm(x, p.scale, cfg.norm_eps)


class LMBlock(nn.Module):
    """One pre-norm block (``init_lm_block``): ``ln1``, ``ln2``, ``attn``
    (MLA or GQA), the post-norms if any, and ``ffn`` (dense) or ``moe``."""

    def __init__(self, cfg: ModelConfig, *, moe_layer: bool, device, generator=None):
        super().__init__()
        check_supported(cfg)
        self.ln1 = Norm(cfg, device=device)
        self.ln2 = Norm(cfg, device=device)
        if cfg.use_mla:
            self.attn = mla.MLA(cfg, device=device, generator=generator)
        else:
            self.attn = attention.Attention(cfg, device=device, generator=generator)
        if cfg.post_norms:
            self.ln1_post = Norm(cfg, device=device)
            self.ln2_post = Norm(cfg, device=device)
        if moe_layer:
            self.moe = ffn.MoEFFN(cfg, device=device, generator=generator)
        else:
            self.ffn = ffn.DenseFFN(cfg, device=device, generator=generator)


# --------------------------------------------------------------------------
# block forward
# --------------------------------------------------------------------------


def _ffn_part(p: LMBlock, x, cfg: ModelConfig, ctx, bias, moe_layer: bool):
    h = _norm(p.ln2, x, cfg)
    if moe_layer:
        f, counts = ffn.moe_ffn(p.moe, h, bias, cfg, ctx)
    else:
        f = ffn.dense_ffn(p.ffn, h, cfg)
        counts = _zero_counts(cfg, x.device)
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
    (a Python int) masks GQA attention; MLA attends globally."""
    h = _norm(p.ln1, x, cfg)
    if cfg.use_mla:
        a, cache = mla.mla_full(
            p.attn, h, cfg, return_cache=return_cache, cache_len=cache_len, ctx=ctx
        )
    else:
        mla.refuse_ctx(ctx)
        a, cache = attention.attention_full(
            p.attn, h, cfg, window=window, return_cache=return_cache, cache_len=cache_len
        )
    if cfg.post_norms:
        a = _norm(p.ln1_post, a, cfg)
    x, counts = _ffn_part(p, x + a, cfg, ctx, bias, moe_layer)
    return x, cache, counts


def _zero_counts(cfg: ModelConfig, device):
    return torch.zeros((max(cfg.n_routed_experts, 1),), dtype=torch.float32, device=device)


def lm_block_decode(
    p: LMBlock, x, cache, pos, cfg: ModelConfig, ctx=None, *, window, bias, moe_layer
):
    """One-token block against its cache (updated in place).  Returns
    ``(x, cache, counts)``."""
    mla.refuse_ctx(ctx)
    h = _norm(p.ln1, x, cfg)
    if cfg.use_mla:
        a, cache = mla.mla_decode(p.attn, h, cache, pos, cfg)
    else:
        a, cache = attention.attention_decode(p.attn, h, cache, pos, cfg, window=window)
    if cfg.post_norms:
        a = _norm(p.ln1_post, a, cfg)
    x, counts = _ffn_part(p, x + a, cfg, ctx, bias, moe_layer)
    return x, cache, counts
