"""Partitioning rules: parameter / activation / cache specs.

Port of ``repro/models/partitioning.py``.  Rule-based mapping from the
JAX package's parameter-tree paths to layouts (:class:`parallel.Spec`, one
entry per dimension as ``PartitionSpec``):

* TP ('model' axis): attention heads, FFN hidden, vocab;
* EP: routed experts over (data, model) when divisible, else (model,) with
  FSDP weight sharding over 'data' (models/parallel.py);
* DP ('pod','data'): batch dims of activations, KV caches, and -- under
  ZeRO-1 -- the Adam moments (sharded over the first dp-divisible axis).

Everything degrades to replication when a dimension is not divisible, so
the same rules drive one device, the 256-chip pod and the 512-chip
multi-pod mesh.

The port's parameters are a ``Model`` of one module a layer; the rules
walk them by the JAX leaves' '/'-joined paths (:func:`jax_param_paths`),
a scanned layer's leaf stacked on a leading layer axis as the JAX tree
stacks it (``layers/attn/wq`` is ``(L, D, H dh)``).  :func:`param_specs`
and :func:`zero1_specs` return ``{JAX path: Spec}``; :func:`batch_specs`,
:func:`cache_specs` and :func:`balancer_specs` return their input's
structure with a spec in place of each tensor.

A rank's eager layout under tensor parallelism (:func:`tp_layout`,
:func:`local_specs`) differs from :func:`param_specs` by design.  GSPMD
may split a flat dimension anywhere that divides, e.g. SmolLM-135M's
``wq`` columns (9 heads of 64) over 16 ranks into blocks of 36 columns,
0.56 of a head; eager code computes a head on one rank, so the eager
layout splits only whole heads (query heads where they divide over TP,
KV heads where those divide too, MLA's heads, RWKV's WKV heads) and
keeps a leaf whole otherwise.  Mamba's ``w_in`` ``(D, 2 Di)`` holds
``xi``'s channels and then ``z``'s: where :func:`param_specs` gives the
first half of the ranks ``xi`` only, a rank here holds the same block of
both halves (``Spec(None, tp, parts=2)``).  The routed experts are held
as :func:`param_specs` lays them out (:func:`expert_specs`) wherever the
EP group has several ranks.  The numbers are the reference's either way;
only which rank holds which columns differs.  Every cache leaf is its
:func:`cache_specs` block over TP (:func:`tp_cache_specs`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import parallel
from repro_torch.models.parallel import (ParallelContext, divisible, mesh_shape, placements,
                                         spec_axes)
from repro_torch.models.parallel import Spec as P

STACKED = ("layers", "enc_layers")  # JAX subtrees stacked on a leading layer axis

# Leaf-name -> spec template for *unstacked* (single-layer) params.
#   "col"  : shard last dim over TP        (D, X) -> P(None, tp)
#   "row"  : shard first dim over TP       (X, D) -> P(tp, None)
#   "vec"  : shard the only dim over TP
#   "rep"  : replicate
_RULES = {
    "embed": "embed",
    "lm_head": "col",
    "wq": "col", "wk": "col", "wv": "col", "wg": "col", "wr": "col",
    "w_in": "col", "w_gate": "col", "w_gate_h": "col",
    "w_dq": "col", "w_uq": "col", "w_uk": "col", "w_uv": "col",
    "w_dkv": "rep", "maa_w1": "rep", "decay_w1": "rep", "w_x": "row_first",
    "wo": "row", "w_out": "row", "w_dt": "col", "proj": "rep",
    "conv": "col", "conv_b": "vec", "a_log": "row_first", "d_skip": "vec",
    "dt_bias": "vec", "bq": "vec", "bk": "vec", "bv": "vec",
    "u": "row_first", "gate": "rep",
    "maa_w2": "rep", "decay_w2": "rep",
}
# channel-mix weights (parent key "cm") have transposed roles.
_CM_RULES = {"wk": "col", "wv": "row", "wr": "col"}


def _base_spec(rule: str, ndim: int, tp: str) -> P:
    if rule == "embed":
        return P(tp, None)
    if rule == "embed_d":
        # d_model-sharded embedding, only for untied-head MoE archs: the
        # token gather is local per chip.
        return P(None, tp)
    if rule == "col":
        return P(*([None] * (ndim - 1)), tp)
    if rule in ("row", "row_first"):
        return P(tp, *([None] * (ndim - 1)))
    if rule == "vec":
        return P(tp)
    return P(*([None] * ndim))


def _divisible(spec: P, shape, mesh) -> P:
    """Downgrade any axis whose dimension is not divisible on the mesh."""
    return divisible(spec, shape, mesh_shape(mesh))


def jax_param_paths(named: dict) -> dict[str, list]:
    """``{JAX path: [port tensor, ...]}`` of ``{port name: tensor}``: a
    stacked leaf lists its layers' tensors in layer order, any other one
    its single tensor."""
    out: dict[str, list] = {}
    for name, t in named.items():
        head, _, rest = name.partition(".")
        if head in STACKED:
            layer, _, leaf = rest.partition(".")
            key = f"{head}/{leaf.replace('.', '/')}"
            out.setdefault(key, []).append((int(layer), t))
        else:
            out[name.replace(".", "/")] = [(0, t)]
    return {k: [t for _, t in sorted(v, key=lambda e: e[0])] for k, v in out.items()}


def leaf_shapes(params) -> dict[str, tuple]:
    """``{JAX path: shape}`` of a ``Model`` (or ``{port name: tensor}``), a
    stacked leaf with its leading layer axis; ``{JAX path: shape}`` is
    returned as it is."""
    if isinstance(params, dict) and all(isinstance(v, tuple) for v in params.values()):
        return params
    named = dict(params.named_parameters()) if hasattr(params, "named_parameters") else params
    shapes = {}
    for path, ts in jax_param_paths(named).items():
        lead = (len(ts),) if path.split("/", 1)[0] in STACKED else ()
        shapes[path] = (*lead, *ts[0].shape)
    return shapes


def param_specs(abstract_params, cfg: ModelConfig, ctx: ParallelContext) -> dict[str, P]:
    """``{JAX path: Spec}`` of a model's parameters (whole ones, or
    ``{JAX path: whole shape}``; :func:`whole_shapes` of a rank's)."""
    tp = ctx.tp_axis

    def rule_for(keys, shape):
        name = keys[-1]
        ndim = len(shape)
        stacked = "layers" in keys or "enc_layers" in keys
        in_moe = "moe" in keys and "shared" not in keys
        in_cm = "cm" in keys

        if in_moe and name in ("w_in", "w_gate_h", "w_out"):
            if ctx.fsdp_axis is not None:
                # (E, D, F) / (E, F, D): experts over TP, D/F over fsdp axis
                if name == "w_out":
                    spec = P(tp, None, ctx.fsdp_axis)
                else:
                    spec = P(tp, ctx.fsdp_axis, None)
            else:
                spec = P(ctx.ep_axes, None, None)
        elif in_moe and name == "gate":
            spec = P(None, None)
        elif in_cm and name in _CM_RULES:
            spec = _base_spec(_CM_RULES[name], ndim - (1 if stacked else 0), tp)
        else:
            rule = _RULES.get(name, "rep")
            if rule == "embed" and cfg.moe and not cfg.tie_embeddings:
                rule = "embed_d"
            spec = _base_spec(rule, ndim - (1 if stacked else 0), tp)

        if stacked:
            spec = P(None, *spec)
        return _divisible(spec, shape, ctx.mesh)

    return {path: rule_for(path.split("/"), shape)
            for path, shape in leaf_shapes(abstract_params).items()}


def zero1_specs(param_spec_tree: dict, abstract_params, ctx: ParallelContext) -> dict[str, P]:
    """Adam-moment specs: param spec + shard one free axis over the dp axes.

    The first axis that is (a) unsharded in the param spec and (b) divisible
    by the dp product gets the dp axes -- ZeRO-1 partitioning.
    """
    dp = ctx.dp_axes
    dp_size = ctx.dp_size
    shapes = leaf_shapes(abstract_params)

    def widen(spec: P, shape):
        entries = list(tuple(spec) + (None,) * (len(shape) - len(spec)))
        used = set()
        for e in entries:
            if e is None:
                continue
            used.update(e if isinstance(e, tuple) else (e,))
        if used & set(dp):
            return _divisible(P(*entries), shape, ctx.mesh)
        for i, (dim, cur) in enumerate(zip(shape, entries)):
            if cur is None and dim % dp_size == 0 and dim >= dp_size:
                entries[i] = dp if len(dp) > 1 else dp[0]
                break
        return _divisible(P(*entries), shape, ctx.mesh)

    return {path: widen(spec, shapes[path]) for path, spec in param_spec_tree.items()}


def batch_specs(abstract_batch: dict, ctx: ParallelContext) -> dict:
    """Shard the batch dim over dp when divisible; everything else rep."""
    dp = ctx.dp_axes if len(ctx.dp_axes) > 1 else ctx.dp_axes[0]

    def spec(leaf):
        if len(leaf.shape) == 0:
            return P()
        s = P(dp, *([None] * (len(leaf.shape) - 1)))
        return _divisible(s, leaf.shape, ctx.mesh)

    return {k: spec(v) for k, v in abstract_batch.items()}


_CACHE_RULES = {
    # KV caches (B, S, Kv, Dh): prefer head sharding over TP; fall back to
    # sequence sharding when the head count does not divide (gemma2 kv=8,
    # hymba kv=5 on a 16-wide TP axis).
    "k": "kv",
    "v": "kv",
    "cross_k": "kv",
    "cross_v": "kv",
    # MLA compressed caches (B, S, R): shard the sequence.
    "ckv": ("dp", "tp", None),
    "k_rope": ("dp", "tp", None),
    "wkv": ("dp", "tp", None, None),
    "tm_shift": ("dp", "tp"),
    "cm_shift": ("dp", "tp"),
    "ssm": ("dp", "tp", None),
    "conv": ("dp", None, "tp"),
}


def cache_specs(abstract_cache: dict, ctx: ParallelContext) -> dict:
    """The cache's nested dicts (``{"scan": ..., "head": ...}``) with a spec
    in place of each tensor."""
    dp = ctx.dp_axes if len(ctx.dp_axes) > 1 else ctx.dp_axes[0]
    tp = ctx.tp_axis
    tp_size = ctx.tp_size

    def spec(keys, leaf):
        name = keys[-1]
        shape = tuple(leaf.shape)
        tpl = _CACHE_RULES.get(name)
        if tpl is None:
            return P(*([None] * len(shape)))
        stacked = "scan" in keys
        if tpl == "kv":
            b, s, kvh = shape[1 if stacked else 0:][:3]
            if kvh % tp_size == 0:
                entries = [dp, None, tp, None]
            elif s % tp_size == 0:
                entries = [dp, tp, None, None]
            else:
                entries = [dp, None, None, None]
        else:
            entries = [dp if e == "dp" else tp if e == "tp" else None for e in tpl]
        if stacked:
            entries = [None] + entries
        entries = entries[: len(shape)] + [None] * (len(shape) - len(entries))
        return _divisible(P(*entries), shape, ctx.mesh)

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + [k]) for k, v in tree.items()}
        return spec(keys, tree)

    return walk(abstract_cache, [])


def balancer_specs(abstract_state, ctx: ParallelContext) -> dict:
    """``{field: Spec}`` of a ``BalancerState``: (L, DP, TP, E) leaves one
    row per dispatcher, sharded in place."""
    dp = ctx.dp_axes if len(ctx.dp_axes) > 1 else ctx.dp_axes[0]

    def spec(leaf):
        if len(leaf.shape) == 4:
            return _divisible(P(None, dp, ctx.tp_axis, None), leaf.shape, ctx.mesh)
        return P(*([None] * len(leaf.shape)))

    return {f.name: spec(getattr(abstract_state, f.name))
            for f in dataclasses.fields(abstract_state)}


def to_shardings(spec_tree, mesh):
    """The tree with each spec replaced by its DTensor placements on
    ``mesh`` (``parallel.placements``), the counterpart of
    ``NamedSharding``."""
    if isinstance(spec_tree, P):
        return placements(spec_tree, mesh)
    return {k: to_shardings(v, mesh) for k, v in spec_tree.items()}


# --------------------------------------------------------------------------
# a rank's eager layout under tensor and expert parallelism
# --------------------------------------------------------------------------

TP_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """What each rank of a TP group of ``size`` holds a block of."""

    size: int
    heads: bool  # query heads: wq's (MLA: w_uq's, w_uk's, w_uv's) columns, wo's rows
    kv: bool  # KV heads: wk's, wv's, bk's and bv's columns
    ffn: bool  # a dense FFN's (RWKV: the channel mix's) hidden units
    vocab: bool  # vocabulary: lm_head's columns (a tied head's: embed's rows)
    embed: str | None = None  # embed's "rows" (vocabulary) or "cols" (embed_d), else whole
    q_lora: bool = False  # MLA's w_dq columns
    shared: bool = False  # the shared experts' hidden units
    wkv: bool = False  # RWKV's WKV heads: the time mix's wr/wk/wv/wg columns, u and wo rows
    shift: bool = False  # RWKV's token-shift caches by their D columns
    ssm: bool = False  # Mamba's inner channels


def tp_layout(cfg: ModelConfig, ctx: ParallelContext | None) -> TPLayout | None:
    """The layout over a TP group of several ranks, else None (no context,
    or one TP rank).  KV heads split where both head counts divide over
    TP; query heads where ``num_heads`` does and, with the KV heads whole,
    each rank's query heads use whole groups of KV heads or share one
    (every config's do); MLA's heads where ``num_heads`` divides, and
    ``w_dq``'s columns with them where ``q_lora_rank`` does too; a dense
    FFN's and the shared experts' hidden units where each one's own width
    divides.  RWKV's WKV heads where their count divides, its channel mix
    where both ``d_ff`` and ``d_model`` do (``wr``'s output is ``D``
    wide), its shift caches where ``d_model`` does; Mamba's inner channels
    where ``ssm_expand * d_model`` does.  A MoE model with an untied head
    holds ``embed`` by its ``D`` columns (the reference's ``embed_d``),
    any other by vocabulary rows; a dimension that does not divide stays
    whole."""
    if ctx is None or not ctx.tp_split or cfg.family not in TP_FAMILIES:
        return None
    tp, h = ctx.tp_size, cfg.num_heads
    vocab = cfg.vocab_size % tp == 0
    if cfg.family == "ssm":
        d = cfg.d_model
        return TPLayout(size=tp, heads=False, kv=False, ffn=cfg.d_ff % tp == 0 and d % tp == 0,
                        vocab=vocab, embed="rows" if vocab else None,
                        wkv=(d // cfg.rwkv_head_dim) % tp == 0, shift=d % tp == 0)
    if cfg.use_mla:
        heads, kv = h % tp == 0, False
    else:
        kvh = cfg.num_kv_heads
        kv = h % tp == 0 and kvh % tp == 0
        hl, g = h // tp, h // kvh
        heads = kv or (h % tp == 0 and (hl % g == 0 or g % hl == 0))
    if cfg.moe and not cfg.tie_embeddings:
        embed = "cols" if cfg.d_model % tp == 0 else None
    else:
        embed = "rows" if vocab else None
    shared = cfg.moe_d_ff * cfg.n_shared_experts if cfg.moe else 0
    return TPLayout(size=tp, heads=heads, kv=kv, ffn=cfg.d_ff % tp == 0, vocab=vocab,
                    embed=embed,
                    q_lora=cfg.use_mla and heads and bool(cfg.q_lora_rank)
                    and cfg.q_lora_rank % tp == 0,
                    shared=bool(shared) and shared % tp == 0,
                    ssm=cfg.family == "hybrid" and (cfg.ssm_expand * cfg.d_model) % tp == 0)


def expert_specs(ctx: ParallelContext) -> tuple[P, P, P]:
    """The layouts of a MoE layer's ``(w_in, w_gate_h, w_out)``
    (:func:`param_specs`): ``(E/ep, D, F)`` over the EP axes, or under
    EP+FSDP ``(E/tp, D/fsdp, F)`` and ``(E/tp, F, D/fsdp)``."""
    if ctx.fsdp_axis is not None:
        w = P(ctx.tp_axis, ctx.fsdp_axis, None)
        return w, w, P(ctx.tp_axis, None, ctx.fsdp_axis)
    w = P(ctx.ep_axes, None, None)
    return w, w, w


def _block_prefixes(cfg: ModelConfig) -> list[tuple[str, bool]]:
    """``(JAX path prefix, stacked)`` of each block's leaves."""
    out = [("layers", True)]
    if cfg.family == "audio":
        out.append(("enc_layers", True))
    if cfg.moe:
        out += [(f"head_layers/{i}", False) for i in range(cfg.first_dense_layers)]
    if cfg.mtp:
        out.append(("mtp/block", False))
    return out


def local_specs(cfg: ModelConfig, ctx: ParallelContext | None) -> dict[str, P]:
    """``{JAX path: Spec}`` of the leaves a rank holds a block of
    (:func:`tp_layout`); every leaf not listed is whole on every rank.

    Unlike :func:`param_specs` it splits only whole heads: ``wq``, ``bq``
    and ``wo``'s rows by query heads where ``num_heads % tp == 0`` (and
    the KV heads they use are whole groups or one); ``wk``,
    ``wv``, ``bk`` and ``bv`` by KV heads where ``num_kv_heads % tp == 0``
    too (else whole, and a rank reads the KV heads its query heads use);
    the same for Whisper's cross-attention (``cross``) and its encoder's
    (``enc_layers``); MLA's ``w_uq`` (or ``wq``), ``w_uk`` and ``w_uv`` by
    columns and ``wo`` by rows, and ``w_dq`` by columns; ``w_in`` /
    ``w_gate`` by columns and ``w_out`` by rows of each FFN whose hidden
    units divide (a dense layer's, the MTP block's, the shared experts');
    RWKV's time mix by WKV heads (``wr``, ``wk``, ``wv``, ``wg`` by
    columns, ``u`` and ``wo`` by rows) and its channel mix as the
    reference's ``_CM_RULES`` (``wk`` and ``wr`` by columns, ``wv`` by
    rows); Mamba by inner channels (``w_in``'s same block of its ``xi`` and
    ``z`` halves, ``conv``, ``w_dt`` by columns, ``conv_b``, ``dt_bias``,
    ``d_skip``, ``w_x``, ``a_log`` and ``w_out`` by rows); ``embed``'s rows
    and an untied ``lm_head``'s columns where ``vocab_size % tp == 0``, or
    a MoE model's ``embed`` by its ``D`` columns.  The same leaves of the
    leading dense layers (``head_layers/<i>``) and of DeepSeek-V3's MTP
    block, unstacked.  Norms, ``q_norm``, ``k_norm``, ``kv_norm``,
    ``w_dkv``, the router's ``gate``, RWKV's token-shift and decay LoRAs
    (``mu_x``, ``mu``, ``maa_w1``, ``maa_w2``, ``w0``, ``decay_w1``,
    ``decay_w2``), its group norm and ``mu_k`` / ``mu_r`` stay whole.  The
    routed experts are :func:`expert_specs`' blocks wherever the EP group
    has several ranks, TP split or not."""
    out = {}
    lay = tp_layout(cfg, ctx)
    if lay is not None:
        tp = ctx.tp_axis
        for prefix, stacked in _block_prefixes(cfg):
            lead = (None,) if stacked else ()
            col, row, vec = P(*lead, None, tp), P(*lead, tp, None), P(*lead, tp)
            if cfg.family == "ssm":
                tm, cm = f"{prefix}/tm/", f"{prefix}/cm/"
                if lay.wkv:
                    out.update({tm + n: col for n in ("wr", "wk", "wv", "wg")})
                    out.update({tm + "u": row, tm + "wo": row})
                if lay.ffn:
                    out.update({cm + "wk": col, cm + "wv": row, cm + "wr": col})
                continue
            if lay.ssm:
                mb = f"{prefix}/mamba/"
                out.update({mb + "w_in": P(*lead, None, tp, parts=2), mb + "conv": col,
                            mb + "w_dt": col, mb + "w_x": row, mb + "a_log": row,
                            mb + "w_out": row})
                out.update({mb + n: vec for n in ("conv_b", "dt_bias", "d_skip")})
            cross = cfg.family == "audio" and prefix == "layers"
            for attn in [f"{prefix}/attn/"] + ([f"{prefix}/cross/"] if cross else []):
                out.update(_attn_specs(cfg, lay, attn, col, row, vec))
            moe_layer = cfg.moe and prefix == "layers"
            ffn = f"{prefix}/moe/shared/" if moe_layer else f"{prefix}/ffn/"
            if (lay.shared if moe_layer else lay.ffn):
                out.update({ffn + "w_in": col, ffn + "w_out": row})
                if cfg.glu:
                    out[ffn + "w_gate"] = col
        if lay.embed == "rows":
            out["embed"] = P(tp, None)
        elif lay.embed == "cols":
            out["embed"] = P(None, tp)
        if lay.vocab and not cfg.tie_embeddings:
            out["lm_head"] = P(None, tp)
    if cfg.moe and ctx is not None and ctx.ep_size > 1:
        e, d, f = cfg.n_routed_experts, cfg.d_model, cfg.moe_d_ff
        for name, spec, shape in zip(("w_in", "w_gate_h", "w_out"), expert_specs(ctx),
                                     ((e, d, f), (e, d, f), (e, f, d))):
            out[f"layers/moe/{name}"] = P(None, *divisible(spec, shape, ctx.shape))
    return out


def _attn_specs(cfg: ModelConfig, lay: TPLayout, attn: str, col: P, row: P, vec: P) -> dict:
    """The split leaves of one attention (``attn`` its path prefix)."""
    out = {}
    if lay.heads and cfg.use_mla:
        q = ["w_uq"] if cfg.q_lora_rank else ["wq"]
        out.update({attn + n: col for n in (*q, "w_uk", "w_uv")})
        out[attn + "wo"] = row
        if lay.q_lora:
            out[attn + "w_dq"] = col
    elif lay.heads:
        out.update({attn + "wq": col, attn + "wo": row})
        if cfg.qkv_bias:
            out[attn + "bq"] = vec
    if lay.kv:
        out.update({attn + "wk": col, attn + "wv": col})
        if cfg.qkv_bias:
            out.update({attn + "bk": vec, attn + "bv": vec})
    return out


def port_specs(names, specs: dict[str, P]) -> dict[str, P]:
    """``{port name: Spec of that tensor}`` of the names whose JAX leaf is in
    ``specs`` (a stacked leaf's spec without its layer axis)."""
    out = {}
    for path, ns in jax_param_paths({n: n for n in names}).items():
        if path in specs:
            spec = specs[path]
            for n in ns:
                stacked = path.split("/", 1)[0] in STACKED
                out[n] = P(*spec[1:], parts=spec.parts[1:]) if stacked else spec
    return out


def block_names(params) -> dict[str, P]:
    """``{port name: Spec}`` of the parameters of which ``params`` (a
    ``Model``) holds a block (:func:`take_blocks`)."""
    return port_specs([n for n, _ in params.named_parameters()], getattr(params, "tp_specs", {}))


def _set_param(module: torch.nn.Module, name: str, t: torch.Tensor) -> None:
    *path, leaf = name.split(".")
    for key in path:
        module = getattr(module, key)
    old = getattr(module, leaf)
    setattr(module, leaf, torch.nn.Parameter(t, requires_grad=old.requires_grad))


@torch.no_grad()
def take_blocks(params, cfg: ModelConfig, ctx: ParallelContext | None):
    """``params`` (a ``Model`` of whole leaves) with each leaf of
    :func:`local_specs` replaced by this rank's block of it, in place;
    records the layout as ``params.tp_specs``.  Returns ``params``."""
    specs = local_specs(cfg, ctx)
    for name, spec in port_specs([n for n, _ in params.named_parameters()], specs).items():
        t = params.get_parameter(name)
        _set_param(params, name, parallel.take_block(t, spec, ctx).clone())
    params.tp_specs = specs
    return params


@torch.no_grad()
def whole_leaves(params, ctx: ParallelContext | None) -> dict[str, torch.Tensor]:
    """``{port name: whole tensor}`` of a rank's ``Model``: each block
    gathered over the axes that split it, every other parameter as it
    is."""
    blocks = block_names(params)
    return {n: parallel.gather(t.detach(), blocks[n], ctx) if n in blocks else t.detach()
            for n, t in params.named_parameters()}


def whole_shapes(params, ctx: ParallelContext | None) -> dict[str, tuple]:
    """``{JAX path: whole shape}`` of a rank's ``Model``."""
    shapes = leaf_shapes(params)
    specs = getattr(params, "tp_specs", {})
    out = {}
    for path, shape in shapes.items():
        entries = tuple(specs.get(path, ())) + (None,) * len(shape)
        out[path] = tuple(d * ctx.size(e) if e is not None else d
                          for d, e in zip(shape, entries))
    return out


def moment_specs(params, cfg: ModelConfig, ctx: ParallelContext) -> dict[str, P]:
    """ZeRO-1 specs of a rank's ``Model``'s moments, relative to the tensor
    it holds: :func:`zero1_specs` of the whole leaves, less every entry of a
    leaf the rank holds a block of that splits a dimension the block splits
    or over an axis the block splits (its moments are its dp block of that
    block where a dp axis is left, else the whole block: an expert block
    over ``data`` keeps its moments whole)."""
    shapes = whole_shapes(params, ctx)
    z = zero1_specs(param_specs(shapes, cfg, ctx), shapes, ctx)
    local = getattr(params, "tp_specs", {})
    out = {}
    for path, spec in z.items():
        if path in local:
            used = spec_axes(local[path])
            lent = tuple(local[path]) + (None,) * (len(spec) - len(local[path]))
            spec = P(*(None if le is not None or spec_axes((e,)) & used else e
                       for e, le in zip(spec, lent)))
        out[path] = spec
    return out


def kv_cache_split(cfg: ModelConfig, ctx: ParallelContext | None, cache_len: int) -> str | None:
    """How a rank of the TP group holds the KV cache of ``cache_len`` rows
    (:func:`cache_specs`' TP entry; Whisper's cross cache of ``cache_len``
    encoder rows alike): ``"heads"`` (its block of the KV heads), ``"seq"``
    (its block of the rows, every KV head; MLA's ``ckv`` and ``k_rope``
    rows) or None (whole, no TP split, or RWKV, which has no KV cache)."""
    if tp_layout(cfg, ctx) is None or cfg.family == "ssm":
        return None
    if cfg.use_mla:
        ckv = torch.empty((1, 1, cache_len, cfg.kv_lora_rank), device="meta")
        spec = cache_specs({"scan": {"ckv": ckv}}, ctx)["scan"]["ckv"]
        return "seq" if spec[2] == ctx.tp_axis else None
    k = torch.empty((1, 1, cache_len, cfg.num_kv_heads, 1), device="meta")
    spec = cache_specs({"scan": {"k": k}}, ctx)["scan"]["k"]
    return "seq" if spec[2] == ctx.tp_axis else "heads" if spec[3] == ctx.tp_axis else None


def tp_cache_specs(cache: dict, cfg: ModelConfig, ctx: ParallelContext | None) -> dict:
    """The cache's nested dicts with each tensor's layout over the TP group:
    :func:`cache_specs`' TP entries, every other entry None (a rank's dp
    rows are ``ParallelContext.local_rows``'); every entry None where
    :func:`tp_layout` is None.  Non-tensor leaves (``"kv_split"``) are
    left out."""
    tensors = {k: v for k, v in cache.items() if isinstance(v, (dict, torch.Tensor))}
    if tp_layout(cfg, ctx) is None:
        return _map_tree(tensors, lambda t: P(*([None] * t.dim())))
    specs = cache_specs(tensors, ctx)

    def tp_only(spec):
        return P(*(e if e == ctx.tp_axis else None for e in spec))

    return _map_tree(specs, tp_only, leaf=lambda x: isinstance(x, P))


def _map_tree(tree, fn, leaf=lambda x: not isinstance(x, dict)):
    if leaf(tree):
        return fn(tree)
    return {k: _map_tree(v, fn, leaf) for k, v in tree.items()}
