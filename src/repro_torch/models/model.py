"""Top-level model API: init / train loss / prefill / decode, every family.

Port of ``repro/models/model.py``.  Parameter names follow the JAX tree::

  embed           (V, D)
  ln_in           RWKV's pre-norm (ssm family)
  head_layers     {"0": block, ...}   leading dense layers of a MoE model
  layers          one block per scanned layer (the JAX package stacks them)
  enc_layers      whisper's encoder blocks (stacked in the JAX package too)
  final_norm / enc_final_norm
  lm_head         (D, V) unless tied
  mtp             DeepSeek-V3's multi-token-prediction head (training only)

The cache keeps the JAX layout, ``{"scan": {...}}`` of ``(L, ...)``
tensors: for MLA ``{"ckv": (L, B, T, R), "k_rope": (L, B, T, dr)}`` plus
``"head": {"0": {"ckv": (B, T, R), ...}}``; for grouped-query attention
``{"k": (L, B, T, KVH, dh), "v": ...}``; hymba adds ``"ssm": (L, B, Di, N)``
(float32) and ``"conv": (L, B, K-1, Di)``; whisper adds ``"cross_k"`` /
``"cross_v"`` ``(L, B, T_enc, KVH, dh)``; RWKV holds ``"wkv": (L, B, H, n,
n)`` (float32), ``"tm_shift"`` and ``"cm_shift"`` ``(L, B, D)``.
:func:`decode_step` writes the new state into it in place.
Entry points run on the CUDA card unless given ``device="cpu"``.

Under a parallel context whose TP group has several ranks, a model of
any family (``partitioning.tp_layout``) holds this rank's blocks of the
leaves ``partitioning.local_specs`` lists (``init_params(..., ctx=)``,
``partitioning.take_blocks``; ``Model.tp_specs`` records them), computes
its heads, channels, hidden units and vocabulary columns (a MoE model
looks up its ``D`` columns of the embedding and gathers them), and keeps
its ``cache_specs`` block of every cache leaf
(``partitioning.tp_cache_specs``).  A KV cache split over TP is marked
``"kv_split"``, ``"heads"`` or ``"seq"`` (``partitioning.kv_cache_split``;
MLA's compressed cache splits only by rows), Whisper's cross cache
``"cross_split"`` alike.  A MoE model holds its block of the routed experts
wherever the EP group has several ranks, split over TP or not.  The
logits of :func:`prefill` and :func:`decode_step` are gathered whole;
training never gathers them.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.care.slotted_sim import _resolve_device
from repro_torch.models import common, parallel, partitioning
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
    """All parameters of a model of any family (``init_params``).

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
        self.final_norm = tfm.Norm(cfg, device=device, bias=tfm.uses_layer_norm(cfg))
        if not cfg.tie_embeddings:
            self.lm_head = common.dense_init(
                generator, (cfg.d_model, cfg.vocab_size), pdt, device
            )
        fam = cfg.family
        if fam == "ssm":
            self.ln_in = tfm.Norm(cfg, device=device, bias=True)
            blocks = [tfm.RWKVBlock(cfg, **kw) for _ in range(cfg.num_layers)]
        elif fam == "hybrid":
            blocks = [tfm.HymbaBlock(cfg, **kw) for _ in range(cfg.num_layers)]
        elif fam == "audio":
            self.enc_layers = nn.ModuleList(
                tfm.EncoderBlock(cfg, **kw) for _ in range(cfg.encoder_layers))
            self.enc_final_norm = tfm.Norm(cfg, device=device, bias=True)
            blocks = [tfm.DecoderBlock(cfg, **kw) for _ in range(cfg.num_layers)]
        else:  # dense / moe / vlm
            if cfg.moe and cfg.first_dense_layers:
                self.head_layers = nn.ModuleDict({
                    str(i): tfm.LMBlock(cfg, moe_layer=False, **kw)
                    for i in range(cfg.first_dense_layers)
                })
            blocks = [tfm.LMBlock(cfg, moe_layer=cfg.moe, **kw)
                      for _ in range(num_scanned_layers(cfg))]
        self.layers = nn.ModuleList(blocks)
        if cfg.mtp:
            self.mtp = MTPHead(cfg, **kw)
        self.tp_specs: dict = {}  # {JAX path: Spec} of the leaves held as blocks


def check_blocks(params: Model, cfg: ModelConfig, ctx) -> None:
    """Raise unless ``params`` holds the blocks the context's layout asks
    for (``partitioning.local_specs``)."""
    want = partitioning.local_specs(cfg, ctx)
    if params.tp_specs != want:
        raise ValueError(
            f"the parameters hold blocks of {sorted(params.tp_specs)}, the context's layout "
            f"{sorted(want)}; take the rank's blocks with partitioning.take_blocks")


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None, ctx=None) -> Model:
    """Random parameters drawn from ``generator`` on ``device`` (None means
    the CUDA card), each created in its own dtype on the device; under a
    context, this rank's blocks of them (every rank draws the whole leaves
    from the same generator state)."""
    dev = _resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, parameters go to {dev}")
    return partitioning.take_blocks(Model(cfg, device=dev, generator=generator), cfg, ctx)


# --------------------------------------------------------------------------
# embedding / head
# --------------------------------------------------------------------------


def _split_vocab(cfg: ModelConfig, ctx) -> bool:
    """Whether each TP rank holds its block of the vocabulary's logits."""
    lay = partitioning.tp_layout(cfg, ctx)
    return lay is not None and lay.vocab


def _embed_rows(params: Model, tokens: torch.Tensor, cfg: ModelConfig, ctx=None):
    """The embedding's rows of ``tokens`` in the compute dtype.  Under a TP
    context that splits the vocabulary each rank looks up the ids in its
    rows (others zero) and the rows are summed over the TP group; under
    one that splits ``embed``'s ``D`` columns (a MoE model's ``embed_d``)
    each rank looks up its columns and they are gathered over the group
    (every rank's gradient of the whole is the same, so each keeps its
    columns' share)."""
    cdt = common.dtype_of(cfg.compute_dtype)
    lay = partitioning.tp_layout(cfg, ctx)
    split = lay.embed if lay is not None else None
    if split == "rows":
        vl = params.embed.shape[0]
        local = tokens - ctx.tp_index * vl
        own = ((local >= 0) & (local < vl))[..., None]
        rows = params.embed[local.clamp(0, vl - 1)]
        x = parallel.tp_reduce(torch.where(own, rows, 0), ctx).to(cdt)
    elif split == "cols":
        x = parallel.tp_gather(params.embed[tokens], ctx, dim=-1).to(cdt)
    else:
        x = params.embed[tokens].to(cdt)
    return x


def embed_tokens(params: Model, tokens: torch.Tensor, cfg: ModelConfig, ctx=None):
    """Token embeddings (:func:`_embed_rows`), scaled where the config
    says, through RWKV's pre-norm."""
    cdt = common.dtype_of(cfg.compute_dtype)
    x = _embed_rows(params, tokens, cfg, ctx)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=cdt, device=x.device)
    if cfg.family == "ssm":
        x = tfm._norm(params.ln_in, x, cfg)
    return x


def lm_head(params: Model, x: torch.Tensor, cfg: ModelConfig, ctx=None):
    """Float32 logits; under a TP context that splits the vocabulary, this
    rank's columns of them."""
    x = parallel.tp_copy(x, ctx if _split_vocab(cfg, ctx) else None)
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return (x @ w.to(x.dtype)).to(torch.float32)


def _bias_zeros(cfg: ModelConfig, ctx, device):
    l = num_scanned_layers(cfg)
    e = max(cfg.n_routed_experts, 1)
    shape = (l, e) if ctx is None else (l, ctx.dp_size, ctx.tp_size, e)
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _windows(cfg: ModelConfig):
    w = tfm.layer_windows(cfg)
    if cfg.moe and cfg.first_dense_layers:
        return w[cfg.first_dense_layers :]
    return w


def _logits(params: Model, x: torch.Tensor, cfg: ModelConfig, ctx=None):
    x = tfm._norm(params.final_norm, x, cfg)
    logits = lm_head(params, x, cfg, ctx)[:, 0, :]
    if _split_vocab(cfg, ctx):
        logits = parallel.tp_gather(logits, ctx, dim=-1)
    if cfg.final_softcap:
        logits = common.softcap(logits, cfg.final_softcap)
    return logits


# --------------------------------------------------------------------------
# whisper's encoder and decoder embedding
# --------------------------------------------------------------------------


def _whisper_encode(params: Model, frames: torch.Tensor, cfg: ModelConfig, ctx=None):
    """Frame embeddings ``(B, T_enc, D)`` (the conv front end is a stub in
    the JAX package too) plus sinusoidal positions, through the encoder."""
    cdt = common.dtype_of(cfg.compute_dtype)
    pos = common.sinusoidal_table(frames.shape[1], cfg.d_model, cdt, frames.device)
    x = frames.to(cdt) + pos[None]
    for p in params.enc_layers:
        x = tfm.run_layer(cfg, functools.partial(tfm.encoder_block, cfg=cfg, ctx=ctx), p, x)
    return tfm._norm(params.enc_final_norm, x, cfg)


def _whisper_embed_dec(params: Model, tokens: torch.Tensor, cfg: ModelConfig, ctx=None):
    """Decoder token embeddings plus sinusoidal positions ``0..S-1``."""
    cdt = common.dtype_of(cfg.compute_dtype)
    x = _embed_rows(params, tokens, cfg, ctx)
    return x + common.sinusoidal_table(tokens.shape[1], cfg.d_model, cdt, x.device)[None]


def _stack(caches: list[dict]) -> dict:
    return {name: torch.stack([c[name] for c in caches]) for name in caches[0]}


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def _rwkv_train(p, x, cfg, ctx):
    return tfm.rwkv_block(p, x, cfg, ctx=ctx)[0]


def _hymba_train(p, x, cfg, ctx, window):
    return tfm.hymba_block(p, x, cfg, window=window, mode="train", ctx=ctx)[0]


def _lm_train(p, x, b, cfg, ctx, window, moe_layer):
    x, _, counts = tfm.lm_block_full(p, x, cfg, ctx, window=window, bias=b, moe_layer=moe_layer)
    return x, counts


def _decoder_train(p, x, enc_out, cfg, ctx):
    return tfm.decoder_block(p, x, enc_out, cfg, mode="train", ctx=ctx)[0]


def _run_train_stack(params: Model, x: torch.Tensor, cfg: ModelConfig, ctx, bias):
    """The layer stack of a training forward.  Returns ``(x, counts)``:
    ``counts`` the ``(L_scan, E)`` float32 routed counts of a MoE model
    (``(L_scan, DP, TP, E)`` under a context), else None.  ``cfg.remat``
    recomputes each scanned layer in the backward
    (:func:`transformer.run_layer`)."""
    fam = cfg.family
    if fam == "ssm":
        for p in params.layers:
            x = tfm.run_layer(cfg, functools.partial(_rwkv_train, cfg=cfg, ctx=ctx), p, x)
        return x, None
    if fam == "hybrid":
        for p, w in zip(params.layers, tfm.layer_windows(cfg)):
            fn = functools.partial(_hymba_train, cfg=cfg, ctx=ctx, window=int(w))
            x = tfm.run_layer(cfg, fn, p, x)
        return x, None
    if fam == "audio":
        raise AssertionError("audio is handled in train_loss")
    if cfg.moe and cfg.first_dense_layers:
        for i in range(cfg.first_dense_layers):
            x, _, _ = tfm.lm_block_full(
                params.head_layers[str(i)], x, cfg, ctx, window=tfm.BIG_WINDOW, bias=None,
                moe_layer=False,
            )
    if bias is None:
        bias = _bias_zeros(cfg, ctx, x.device)
    counts = []
    for p, w, b in zip(params.layers, _windows(cfg), bias):
        fn = functools.partial(_lm_train, cfg=cfg, ctx=ctx, window=int(w), moe_layer=cfg.moe)
        x, c = tfm.run_layer(cfg, fn, p, x, b)
        counts.append(c)
    return x, (torch.stack(counts) if cfg.moe else None)


def train_loss(params: Model, batch: dict, cfg: ModelConfig, ctx=None,
               bias: torch.Tensor | None = None):
    """Token-mean cross entropy of next-token prediction.

    ``batch``: ``{"tokens", "labels"}`` ``(B, S)`` on the parameters' device
    (labels < 0 are masked), plus whisper's ``"frames"``; under a context,
    this rank's rows (``ParallelContext.take_rows``).  ``bias``: the
    ``(L_scan, E)`` CARE selection bias of a MoE model, ``(L_scan, DP, TP,
    E)`` under a context (None for zeros).
    Returns ``(loss, aux)``: ``aux["counts"]`` the per-layer routed counts
    (MoE) or None, ``aux["loss_main"]``, and with DeepSeek-V3's MTP head
    ``aux["loss_mtp"]``, added to the loss with weight 0.3.  Where each
    rank holds its block of the rows, every term is this rank's share of
    the whole batch's token mean (``common.cross_entropy``): the shares sum
    over dp to the mean."""
    check_blocks(params, cfg, ctx)
    if cfg.family == "audio":
        return _whisper_train_loss(params, batch, cfg, ctx)
    tokens, labels = batch["tokens"], batch["labels"]
    x = embed_tokens(params, tokens, cfg, ctx)
    x, counts = _run_train_stack(params, x, cfg, ctx, bias)
    h_final = x
    x = tfm._norm(params.final_norm, x, cfg)
    loss = common.cross_entropy(lm_head(params, x, cfg, ctx), labels, cfg.final_softcap, ctx,
                                _split_vocab(cfg, ctx))
    aux = {"counts": counts, "loss_main": loss}
    if cfg.mtp:
        mtp = params.mtp
        nxt = embed_tokens(params, tokens, cfg, ctx)[:, 1:, :]
        h = torch.cat(
            [common.rms_norm(h_final[:, :-1, :], mtp.norm.scale, cfg.norm_eps), nxt], dim=-1
        ) @ mtp.proj
        h, _, _ = tfm.lm_block_full(mtp.block, h, cfg, ctx, window=tfm.BIG_WINDOW, bias=None,
                                    moe_layer=False)
        h = tfm._norm(params.final_norm, h, cfg)
        mtp_loss = common.cross_entropy(lm_head(params, h, cfg, ctx), labels[:, 1:],
                                        cfg.final_softcap, ctx, _split_vocab(cfg, ctx))
        aux["loss_mtp"] = mtp_loss
        loss = loss + 0.3 * mtp_loss
    return loss, aux


def _whisper_train_loss(params: Model, batch: dict, cfg: ModelConfig, ctx):
    enc_out = _whisper_encode(params, batch["frames"], cfg, ctx)
    x = _whisper_embed_dec(params, batch["tokens"], cfg, ctx)
    for p in params.layers:
        x = tfm.run_layer(cfg, functools.partial(_decoder_train, cfg=cfg, ctx=ctx), p, x, enc_out)
    x = tfm._norm(params.final_norm, x, cfg)
    loss = common.cross_entropy(lm_head(params, x, cfg, ctx), batch["labels"], ctx=ctx,
                                split_vocab=_split_vocab(cfg, ctx))
    return loss, {"counts": None, "loss_main": loss}


# --------------------------------------------------------------------------
# prefill / decode
# --------------------------------------------------------------------------


def prefill(params: Model, batch: dict, cfg: ModelConfig, ctx=None, cache_len: int = 0,
            bias: torch.Tensor | None = None):
    """Full-sequence forward building a decode cache.

    ``batch["tokens"]``: ``(B, S)`` token ids on the parameters' device
    (whisper's decoder prompt), and for whisper ``batch["frames"]``: ``(B,
    T_enc, D)`` frame embeddings; ``bias``: ``(L_scan, E)`` CARE selection
    bias of a MoE model, ``(L_scan, DP, TP, E)`` under a context (None for
    zeros).  Returns ``(last-token logits (B, V) float32, cache)``.  Under a
    context the batch, the logits and the cache are this rank's rows.
    """
    tokens = batch["tokens"]
    cache_len = cache_len or tokens.shape[1]
    fam = cfg.family
    check_blocks(params, cfg, ctx)
    if fam in ("ssm", "hybrid", "audio"):
        scan = []
        enc_len = 0
        if fam == "audio":
            enc_out = _whisper_encode(params, batch["frames"], cfg, ctx)
            enc_len = enc_out.shape[1]
            x = _whisper_embed_dec(params, tokens, cfg, ctx)
            for p in params.layers:
                x, c = tfm.decoder_block(p, x, enc_out, cfg, mode="prefill", cache_len=cache_len,
                                         ctx=ctx)
                scan.append(c)
        elif fam == "ssm":
            x = embed_tokens(params, tokens, cfg, ctx)
            for p in params.layers:
                x, c = tfm.rwkv_block(p, x, cfg, ctx=ctx)
                scan.append(c)
        else:
            x = embed_tokens(params, tokens, cfg, ctx)
            for p, w in zip(params.layers, tfm.layer_windows(cfg)):
                x, c = tfm.hymba_block(p, x, cfg, window=int(w), mode="prefill",
                                       cache_len=cache_len, ctx=ctx)
                scan.append(c)
        cache = {"scan": _stack(scan), **_splits(cfg, ctx, cache_len, enc_len)}
        return _logits(params, x[:, -1:, :], cfg, ctx), cache
    x = embed_tokens(params, tokens, cfg, ctx)
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
        bias = _bias_zeros(cfg, ctx, x.device)
    scan = []
    for p, w, b in zip(params.layers, _windows(cfg), bias):
        x, c, _ = tfm.lm_block_full(
            p, x, cfg, ctx, window=int(w), bias=b, moe_layer=cfg.moe,
            return_cache=True, cache_len=cache_len,
        )
        scan.append(c)
    cache["scan"] = _stack(scan)
    cache.update(_splits(cfg, ctx, cache_len))
    return _logits(params, x[:, -1:, :], cfg, ctx), cache


def _splits(cfg: ModelConfig, ctx, cache_len: int, enc_len: int = 0) -> dict:
    """The cache's marks of how its KV caches split over TP:
    ``"kv_split"`` for the self cache of ``cache_len`` rows and Whisper's
    ``"cross_split"`` for its cross cache of ``enc_len`` rows
    (``partitioning.kv_cache_split``), each only where it splits."""
    out = {"kv_split": partitioning.kv_cache_split(cfg, ctx, cache_len)}
    if cfg.family == "audio":
        out["cross_split"] = partitioning.kv_cache_split(cfg, ctx, enc_len)
    return {k: v for k, v in out.items() if v is not None}


def init_decode_cache(params: Model, cfg: ModelConfig, batch: int, cache_len: int, ctx=None):
    """Zero cache for decode without a prefill.  ``batch`` is the global
    batch; under a context the cache holds this rank's rows of it (the dp
    entry of ``partitioning.cache_specs``: its block where they divide over
    dp, else all of them) and, under TP, its ``cache_specs`` block of each
    leaf (``partitioning.tp_cache_specs``)."""
    tfm.check_supported(cfg)
    if ctx is not None:
        batch = ctx.local_rows(batch)
    cdt = common.dtype_of(cfg.compute_dtype)
    l = num_scanned_layers(cfg)
    fam = cfg.family

    def whole(shape, dtype=cdt):
        return torch.empty(shape, dtype=dtype, device="meta")

    if fam == "ssm":
        h, n = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        cache = {"scan": {"wkv": whole((l, batch, h, n, n), torch.float32),
                          "tm_shift": whole((l, batch, cfg.d_model)),
                          "cm_shift": whole((l, batch, cfg.d_model))}}
    elif not cfg.use_mla:
        kv = (l, batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        scan = {"k": whole(kv), "v": whole(kv)}
        if fam == "hybrid":
            di = cfg.ssm_expand * cfg.d_model
            scan["ssm"] = whole((l, batch, di, cfg.ssm_state), torch.float32)
            scan["conv"] = whole((l, batch, cfg.conv_kernel - 1, di))
        elif fam == "audio":
            cross = (l, batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
            scan["cross_k"], scan["cross_v"] = whole(cross), whole(cross)
        cache = {"scan": scan}
    else:
        def mla(*lead):
            return {"ckv": whole((*lead, batch, cache_len, cfg.kv_lora_rank)),
                    "k_rope": whole((*lead, batch, cache_len, cfg.qk_rope_head_dim))}

        cache = {"scan": mla(l)}
        if cfg.moe and cfg.first_dense_layers:
            cache["head"] = {str(i): mla() for i in range(cfg.first_dense_layers)}
    dev = params.embed.device

    def block(t, spec):
        if isinstance(t, dict):
            return {k: block(v, spec[k]) for k, v in t.items()}
        return torch.zeros(parallel.block_shape(spec, t.shape, ctx), dtype=t.dtype, device=dev)

    cache = block(cache, partitioning.tp_cache_specs(cache, cfg, ctx))
    return {**cache, **_splits(cfg, ctx, cache_len, cfg.encoder_seq)}


def _write_back(scan: dict, l: int, new: dict) -> None:
    """Layer ``l``'s new state into the stacked cache, in place (K and V
    were written there by the attention already).  Memory is compared by
    storage and offset: a fake tensor (``launch/dryrun.py``) has no data
    pointer."""
    for name, t in new.items():
        dst = scan[name][l]
        same = (t.untyped_storage()._cdata == dst.untyped_storage()._cdata
                and t.storage_offset() == dst.storage_offset())
        if not same:
            dst.copy_(t)


def decode_step(params: Model, tokens: torch.Tensor, cache: dict, pos: int, cfg: ModelConfig,
                ctx=None, bias: torch.Tensor | None = None):
    """One decode step.  tokens: ``(B,)``; ``pos``: the next position.

    The cache is updated in place.  Returns ``(logits (B, V), cache)``.
    Under a context the tokens, the cache and the logits are this rank's
    rows; ``ctx.for_batch`` of the global batch says whether they are a
    block of it.
    """
    fam = cfg.family
    scan = cache["scan"]
    check_blocks(params, cfg, ctx)
    kv_split = cache.get("kv_split")
    if fam in ("ssm", "hybrid", "audio"):
        if fam == "audio":
            cdt = common.dtype_of(cfg.compute_dtype)
            x = _embed_rows(params, tokens[:, None], cfg, ctx)
            # The whole self cache's rows (a rank's block of them when split).
            cache_len = scan["k"].shape[2] * (ctx.tp_size if kv_split == "seq" else 1)
            row = min(max(int(pos), 0), cache_len - 1)  # as dynamic_slice_in_dim clamps
            x = x + common.sinusoidal_table(cache_len, cfg.d_model, cdt, x.device)[row]
        else:
            x = embed_tokens(params, tokens[:, None], cfg, ctx)
        windows = tfm.layer_windows(cfg)
        for l, p in enumerate(params.layers):
            layer_cache = {name: t[l] for name, t in scan.items()}
            if fam == "ssm":
                x, new = tfm.rwkv_block(p, x, cfg, state=layer_cache, ctx=ctx)
            elif fam == "hybrid":
                x, new = tfm.hymba_block(p, x, cfg, window=int(windows[l]), mode="decode",
                                         cache=layer_cache, pos=pos, ctx=ctx, kv_split=kv_split)
            else:
                x, new = tfm.decoder_block(p, x, None, cfg, mode="decode", cache=layer_cache,
                                           pos=pos, ctx=ctx, kv_split=kv_split,
                                           cross_split=cache.get("cross_split"))
            _write_back(scan, l, new)
        return _logits(params, x, cfg, ctx), cache
    x = embed_tokens(params, tokens[:, None], cfg, ctx)
    if cfg.moe and cfg.first_dense_layers:
        for i in range(cfg.first_dense_layers):
            x, _, _ = tfm.lm_block_decode(
                params.head_layers[str(i)], x, cache["head"][str(i)], pos, cfg, ctx,
                window=tfm.BIG_WINDOW, bias=None, moe_layer=False,
                kv_split=kv_split,
            )
    if bias is None:
        bias = _bias_zeros(cfg, ctx, x.device)
    for l, (p, w, b) in enumerate(zip(params.layers, _windows(cfg), bias)):
        layer_cache = {name: t[l] for name, t in scan.items()}
        x, _, _ = tfm.lm_block_decode(
            p, x, layer_cache, pos, cfg, ctx, window=int(w), bias=b, moe_layer=cfg.moe,
            kv_split=kv_split,
        )
    return _logits(params, x, cfg, ctx), cache
