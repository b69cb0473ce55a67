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
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.models.parallel import ParallelContext, divisible, mesh_shape, placements
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
    stacked leaf with its leading layer axis."""
    named = dict(params.named_parameters()) if hasattr(params, "named_parameters") else params
    shapes = {}
    for path, ts in jax_param_paths(named).items():
        lead = (len(ts),) if path.split("/", 1)[0] in STACKED else ()
        shapes[path] = (*lead, *ts[0].shape)
    return shapes


def param_specs(abstract_params, cfg: ModelConfig, ctx: ParallelContext) -> dict[str, P]:
    """``{JAX path: Spec}`` of a model's parameters."""
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
