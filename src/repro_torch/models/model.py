"""Top-level model API for serving: init / prefill / decode.

Port of the dense/moe part of ``repro/models/model.py``.  Parameter names
follow the JAX tree::

  embed        (V, D)
  head_layers  {"0": block, ...}   leading dense layers of a MoE model
  layers       one block per scanned layer (the JAX package stacks them)
  final_norm
  lm_head      (D, V) unless tied
  mtp          the multi-token-prediction head (training only; held so
               that every JAX leaf has its tensor)

The cache keeps the JAX layout: for MLA ``{"scan": {"ckv": (L, B, T, R),
"k_rope": (L, B, T, dr)}, "head": {"0": {"ckv": (B, T, R), ...}}}``; for
grouped-query attention ``{"scan": {"k": (L, B, T, KVH, dh), "v": ...}}``.
:func:`decode_step` writes the new token's rows into it in place.
Entry points run on the CUDA card unless given ``device="cpu"``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.care.slotted_sim import _resolve_device
from repro_torch.models import common
from repro_torch.models import transformer as tfm


def num_scanned_layers(cfg: ModelConfig) -> int:
    return cfg.num_layers - (cfg.first_dense_layers if cfg.moe else 0)


class MTPHead(nn.Module):
    """DeepSeek-V3's multi-token-prediction head (consumed by training)."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        pdt = common.dtype_of(cfg.param_dtype)
        self.proj = common.dense_init(generator, (2 * cfg.d_model, cfg.d_model), pdt, device)
        self.block = tfm.LMBlock(cfg, moe_layer=False, device=device, generator=generator)
        self.norm = tfm.Norm(cfg, device=device)


class Model(nn.Module):
    """All parameters of a dense / moe / vlm model (``init_params``).

    With ``generator=None`` the parameters are left uninitialised, for
    ``models/convert.py`` to fill; otherwise they are drawn on ``device``
    from the generator, in the JAX package's order.
    """

    def __init__(self, cfg: ModelConfig, *, device, generator: torch.Generator | None = None):
        super().__init__()
        tfm.check_supported(cfg)
        pdt = common.dtype_of(cfg.param_dtype)
        kw = dict(device=device, generator=generator)
        self.embed = common.dense_init(generator, (cfg.vocab_size, cfg.d_model), pdt, device)
        self.final_norm = tfm.Norm(cfg, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = common.dense_init(
                generator, (cfg.d_model, cfg.vocab_size), pdt, device
            )
        if cfg.moe and cfg.first_dense_layers:
            self.head_layers = nn.ModuleDict({
                str(i): tfm.LMBlock(cfg, moe_layer=False, **kw)
                for i in range(cfg.first_dense_layers)
            })
        self.layers = nn.ModuleList(
            tfm.LMBlock(cfg, moe_layer=cfg.moe, **kw) for _ in range(num_scanned_layers(cfg))
        )
        if cfg.mtp:
            self.mtp = MTPHead(cfg, **kw)


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None) -> Model:
    """Random parameters drawn from ``generator`` on ``device`` (None means
    the CUDA card), each created in its own dtype on the device."""
    dev = _resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, parameters go to {dev}")
    return Model(cfg, device=dev, generator=generator)


# --------------------------------------------------------------------------
# embedding / head
# --------------------------------------------------------------------------


def embed_tokens(params: Model, tokens: torch.Tensor, cfg: ModelConfig):
    cdt = common.dtype_of(cfg.compute_dtype)
    x = params.embed[tokens].to(cdt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=cdt, device=x.device)
    return x


def lm_head(params: Model, x: torch.Tensor, cfg: ModelConfig):
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return (x @ w.to(x.dtype)).to(torch.float32)


def _bias_zeros(cfg: ModelConfig, device):
    l = num_scanned_layers(cfg)
    e = max(cfg.n_routed_experts, 1)
    return torch.zeros((l, e), dtype=torch.float32, device=device)


def _windows(cfg: ModelConfig):
    w = tfm.layer_windows(cfg)
    if cfg.moe and cfg.first_dense_layers:
        return w[cfg.first_dense_layers :]
    return w


def _logits(params: Model, x: torch.Tensor, cfg: ModelConfig):
    x = tfm._norm(params.final_norm, x, cfg)
    logits = lm_head(params, x, cfg)[:, 0, :]
    if cfg.final_softcap:
        logits = common.softcap(logits, cfg.final_softcap)
    return logits


# --------------------------------------------------------------------------
# prefill / decode
# --------------------------------------------------------------------------


def prefill(params: Model, batch: dict, cfg: ModelConfig, ctx=None, cache_len: int = 0,
            bias: torch.Tensor | None = None):
    """Full-sequence forward building a decode cache.

    ``batch["tokens"]``: ``(B, S)`` token ids on the parameters' device;
    ``bias``: ``(L_scan, E)`` CARE selection bias (None for zeros).
    Returns ``(last-token logits (B, V) float32, cache)``.
    """
    tokens = batch["tokens"]
    cache_len = cache_len or tokens.shape[1]
    x = embed_tokens(params, tokens, cfg)
    cache: dict = {}
    if cfg.moe and cfg.first_dense_layers:
        cache["head"] = {}
        for i in range(cfg.first_dense_layers):
            x, c, _ = tfm.lm_block_full(
                params.head_layers[str(i)], x, cfg, ctx, window=tfm.BIG_WINDOW,
                bias=None, moe_layer=False, return_cache=True, cache_len=cache_len,
            )
            cache["head"][str(i)] = c
    if bias is None:
        bias = _bias_zeros(cfg, x.device)
    scan = []
    for p, w, b in zip(params.layers, _windows(cfg), bias):
        x, c, _ = tfm.lm_block_full(
            p, x, cfg, ctx, window=int(w), bias=b, moe_layer=cfg.moe,
            return_cache=True, cache_len=cache_len,
        )
        scan.append(c)
    cache["scan"] = {name: torch.stack([c[name] for c in scan]) for name in scan[0]}
    return _logits(params, x[:, -1:, :], cfg), cache


def init_decode_cache(params: Model, cfg: ModelConfig, batch: int, cache_len: int, ctx=None):
    """Zero cache for decode without a prefill."""
    tfm.check_supported(cfg)
    cdt = common.dtype_of(cfg.compute_dtype)
    dev = params.embed.device
    if not cfg.use_mla:
        shape = (num_scanned_layers(cfg), batch, cache_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return {"scan": {"k": torch.zeros(shape, dtype=cdt, device=dev),
                         "v": torch.zeros(shape, dtype=cdt, device=dev)}}

    def zeros(*lead):
        return {
            "ckv": torch.zeros((*lead, batch, cache_len, cfg.kv_lora_rank), dtype=cdt, device=dev),
            "k_rope": torch.zeros(
                (*lead, batch, cache_len, cfg.qk_rope_head_dim), dtype=cdt, device=dev
            ),
        }

    cache = {"scan": zeros(num_scanned_layers(cfg))}
    if cfg.moe and cfg.first_dense_layers:
        cache["head"] = {str(i): zeros() for i in range(cfg.first_dense_layers)}
    return cache


def decode_step(params: Model, tokens: torch.Tensor, cache: dict, pos: int, cfg: ModelConfig,
                ctx=None, bias: torch.Tensor | None = None):
    """One decode step.  tokens: ``(B,)``; ``pos``: the next position.

    The cache is updated in place.  Returns ``(logits (B, V), cache)``.
    """
    x = embed_tokens(params, tokens[:, None], cfg)
    if cfg.moe and cfg.first_dense_layers:
        for i in range(cfg.first_dense_layers):
            x, _, _ = tfm.lm_block_decode(
                params.head_layers[str(i)], x, cache["head"][str(i)], pos, cfg, ctx,
                window=tfm.BIG_WINDOW, bias=None, moe_layer=False,
            )
    if bias is None:
        bias = _bias_zeros(cfg, x.device)
    scan = cache["scan"]
    for l, (p, w, b) in enumerate(zip(params.layers, _windows(cfg), bias)):
        layer_cache = {name: t[l] for name, t in scan.items()}
        x, _, _ = tfm.lm_block_decode(
            p, x, layer_cache, pos, cfg, ctx, window=int(w), bias=b, moe_layer=cfg.moe
        )
    return _logits(params, x, cfg), cache
