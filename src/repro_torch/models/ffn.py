"""Feed-forward blocks: dense (GLU / plain) and the expert-parallel MoE.

Port of ``repro/models/ffn.py``: route locally -> scatter tokens into
per-expert capacity buffers -> all_to_all over the EP axes -> expert
matmuls -> all_to_all back -> weighted gather-combine.  Routing always goes
through :func:`repro_torch.kernels.ops.moe_route`, which launches the
Hopper kernel for a CUDA tensor and runs its plain version for a CPU one;
the kernel also returns each (token, slot)'s position in its expert's
buffer, so no one-hot or cumsum runs on the card.

Under a parallel context each rank holds its dp block of the batch's rows
(``models/parallel.py``).  Where the mesh divides the batch, the sequence
and the experts (the reference's manual region), each rank is one
dispatcher: it takes its ``S/TP`` block of its rows' positions, its bias
row and its experts' block of the weights (``models/partitioning``'s
layout, gathered over the FSDP axis when E divides only the TP axis),
exchanges capacity buffers with ``all_to_all_single`` over the EP group
and returns its rows' ``y`` (gathered over the TP group) with ``(DP, TP,
E)`` per-dispatcher counts.  Counts are never reduced here: the CARE
balancer's sparse sync (``core/moe_balancer.py``) is the only place global
counts are formed.
"""
from __future__ import annotations

import types

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common, parallel, partitioning


class DenseFFN(nn.Module):
    """Dense (GLU) FFN parameters, named as the JAX leaves (``init_dense_ffn``)."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None, d_ff: int | None = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        pdt = common.dtype_of(cfg.param_dtype)
        out_scale = 0.02 / max(cfg.num_layers, 1) ** 0.5
        self.w_in = common.dense_init(generator, (d, f), pdt, device)
        self.w_out = common.dense_init(generator, (f, d), pdt, device, scale=out_scale)
        if cfg.glu:
            self.w_gate = common.dense_init(generator, (d, f), pdt, device)


def dense_ffn(p: DenseFFN, x: torch.Tensor, cfg: ModelConfig, ctx=None):
    """The (GLU) FFN.  Under a TP context of the dense decoder whose hidden
    units divide over TP (``partitioning.tp_layout``), ``p`` holds this
    rank's columns of ``w_in`` / ``w_gate`` and rows of ``w_out``, and the
    product is summed over the TP group."""
    lay = partitioning.tp_layout(cfg, ctx)
    tctx = ctx if lay is not None and lay.ffn else None
    x = parallel.tp_copy(x, tctx)
    act = common.activation(cfg.act)
    h = act(x @ p.w_in)
    if cfg.glu:
        h = h * (x @ p.w_gate)
    return parallel.tp_reduce(h @ p.w_out, tctx)


class MoEFFN(nn.Module):
    """MoE parameters (``init_moe_ffn``): a float32 gate even in a bfloat16
    model, stacked expert weights ``(E, D, F)`` / ``(E, F, D)``, and the
    shared experts as one dense FFN of width ``moe_d_ff * n_shared``."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_routed_experts, cfg.moe_d_ff
        pdt = common.dtype_of(cfg.param_dtype)
        out_scale = 0.02 / max(cfg.num_layers, 1) ** 0.5
        self.gate = common.dense_init(generator, (d, e), torch.float32, device)
        self.w_in = common.dense_init(generator, (e, d, f), pdt, device)
        self.w_gate_h = common.dense_init(generator, (e, d, f), pdt, device)
        self.w_out = common.dense_init(generator, (e, f, d), pdt, device, scale=out_scale)
        if cfg.n_shared_experts:
            self.shared = DenseFFN(
                cfg, device=device, generator=generator,
                d_ff=cfg.moe_d_ff * cfg.n_shared_experts,
            )


def _route(logits: torch.Tensor, bias: torch.Tensor, cfg: ModelConfig):
    """``(idx, weights, counts, pos)`` from one ``moe_route`` call."""
    return ops.moe_route(logits, bias, cfg.moe_top_k, gate_fn=cfg.gate_fn)


def _capacity(t_loc: int, k: int, e: int, factor: float) -> int:
    cap = int(max(4, -(-t_loc * k * factor // e)))
    return min(cap, t_loc * k)


def _moe_local(xt: torch.Tensor, bias: torch.Tensor, p, cfg: ModelConfig,
               ctx: parallel.ParallelContext | None = None,
               rows: parallel.ParallelContext | None = None):
    """Per-rank MoE body.  xt: ``(T, D)`` local tokens, bias ``(E,)``.

    Expert weights in ``p`` are this rank's blocks: ``(E_loc, D, F)`` under
    pure EP sharding, or ``(E_loc, D/fsdp, F)`` under EP+FSDP (gathered
    here); all E of them without a context.  Returns ``(y (T, D), counts
    (E,) float32)``.  A (token, slot) pair past its expert's capacity goes
    to a sink row and contributes nothing.  With ``rows`` (a context whose
    dp ranks hold the batch's other rows) the capacity, the positions and
    the counts are the whole batch's, as one device computes them on it:
    the dp group's counts are gathered and the earlier ranks' tokens come
    first in each expert's buffer.
    """
    t_loc, d = xt.shape
    e, k = cfg.n_routed_experts, cfg.moe_top_k
    cdt = common.dtype_of(cfg.compute_dtype)

    w_in_l, w_gate_l, w_out_l = p.w_in, p.w_gate_h, p.w_out
    if ctx is not None and ctx.fsdp_axis is not None:
        # Expert weights are FSDP-sharded on the D/F dim: gather per layer.
        g = ctx.group(ctx.fsdp_axis)
        w_in_l = parallel.all_gather(w_in_l, g, 1)
        w_gate_l = parallel.all_gather(w_gate_l, g, 1)
        w_out_l = parallel.all_gather(w_out_l, g, 2)

    logits = xt.to(torch.float32) @ p.gate
    # pos: each (token, slot)'s position within its expert's capacity buffer.
    idx, weights, counts, pos = _route(logits, bias, cfg)  # (t,k),(t,k),(E,),(t*k,)
    flat_e = idx.reshape(-1)  # (t*k,) int32

    t_all = t_loc
    if rows is not None:
        every = [torch.empty_like(counts) for _ in range(rows.dp_size)]
        dist.all_gather(every, counts.contiguous(), group=rows.group(rows.dp_axes))
        every = torch.stack(every)
        before = every[: rows.index(rows.dp_axes)].sum(dim=0).to(pos.dtype)
        pos = pos + before[flat_e.long()]
        counts = every.sum(dim=0)
        t_all = t_loc * rows.dp_size
    cap = _capacity(t_all, k, e, cfg.moe_capacity_factor)
    keep = pos < cap
    lin = torch.where(keep, flat_e * cap + pos, e * cap).long()  # overflow -> sink row

    buf = torch.zeros((e * cap + 1, d), dtype=cdt, device=xt.device)
    tok_rows = xt.to(cdt).repeat_interleave(k, dim=0)  # (t*k, D)
    buf.index_add_(0, lin, tok_rows)
    buf = buf[: e * cap]

    ep = ctx.ep_size if ctx is not None else 1
    e_loc = e // ep
    if ep > 1:
        group = ctx.group(ctx.ep_axes)
        # (EP, E_loc*cap, D) in rank order: block [j] goes to rank j, and
        # block [j] of what comes back came from rank j.
        recv = parallel.all_to_all(buf, group).reshape(ep, e_loc, cap, d)
        work = recv.transpose(0, 1).reshape(e_loc, ep * cap, d)
    else:
        work = buf.reshape(e, cap, d)

    act = common.activation(cfg.act)
    h = act(torch.einsum("end,edf->enf", work, w_in_l))
    h = h * torch.einsum("end,edf->enf", work, w_gate_l)
    out = torch.einsum("enf,efd->end", h, w_out_l)

    if ep > 1:
        out = out.reshape(e_loc, ep, cap, d).transpose(0, 1).reshape(e * cap, d)
        back = parallel.all_to_all(out, group)
    else:
        back = out.reshape(e * cap, d)

    back = torch.cat([back, back.new_zeros((1, d))], dim=0)
    picked = back[lin]  # (t*k, D); sink row is zero
    w_flat = (weights.reshape(-1, 1) * keep[:, None]).to(cdt)
    y = torch.sum((picked * w_flat).reshape(t_loc, k, d), dim=1)
    return y, counts.to(torch.float32)


def _expert_specs(ctx: parallel.ParallelContext):
    """The layouts of ``(w_in, w_gate_h, w_out)`` (``partitioning.param_specs``)."""
    if ctx.fsdp_axis is not None:
        w = parallel.Spec(ctx.tp_axis, ctx.fsdp_axis, None)
        return w, w, parallel.Spec(ctx.tp_axis, None, ctx.fsdp_axis)
    w = parallel.Spec(ctx.ep_axes, None, None)
    return w, w, w


def _moe_manual(p: MoEFFN, x: torch.Tensor, bias: torch.Tensor, cfg: ModelConfig,
                ctx: parallel.ParallelContext):
    """The reference's ``shard_map`` region: this rank's dispatcher on its
    block of the tokens; ``y`` of ``x``'s rows, counts ``(DP, TP, E)``.

    Where each rank holds its dp block of the rows (``ctx.split``, or dp
    1), the dispatcher takes its positions block of them and ``y`` is
    gathered over the TP group; where every rank holds the whole batch, it
    takes its ``(B/DP, S/TP)`` block and ``y`` is gathered over the grid."""
    b, s, d = x.shape
    dp, tp = ctx.dp_size, ctx.tp_size
    sl = s // tp
    cols = [slice(j * sl, (j + 1) * sl) for j in range(tp)]
    if ctx.whole_batch:
        group, bl = ctx.group(ctx.grid_axes), b // dp
        # Group rank r is dispatcher (r // TP, r % TP): its rows and positions.
        blocks = [(slice(i * bl, (i + 1) * bl), c) for i in range(dp) for c in cols]
    else:
        group, bl = ctx.group(ctx.tp_axis), b
        blocks = [(slice(None), c) for c in cols]
    me = ctx.index(ctx.grid_axes)
    # Every rank of the group holds the same rows and whole weights: the
    # blocks' gradients are summed over the group.  Over the TP group that
    # leaves each dp rank its rows' share, which the train step sums over
    # dp with every other gradient (each is summed once).
    weights = {}
    for name, spec in zip(("w_in", "w_gate_h", "w_out"), _expert_specs(ctx)):
        w = getattr(p, name)
        weights[name] = parallel.scatter(w, parallel.shard_index(spec, w.shape, ctx), group)
    local = types.SimpleNamespace(gate=parallel.scatter(p.gate, (), group), **weights)
    x_loc = parallel.scatter(x, blocks[dist.get_rank(group)], group)
    y, counts = _moe_local(x_loc.reshape(bl * sl, d), bias[me // tp, me % tp], local, cfg, ctx)
    y = parallel.gather_blocks(y.reshape(bl, sl, d), group, blocks, (b, s, d))
    grid = ctx.group(ctx.grid_axes)
    rows = [torch.empty_like(counts) for _ in range(dp * tp)]
    dist.all_gather(rows, counts, group=grid)
    return y, torch.stack(rows).reshape(dp, tp, cfg.n_routed_experts)


def moe_ffn(p: MoEFFN, x: torch.Tensor, bias: torch.Tensor, cfg: ModelConfig,
            ctx: parallel.ParallelContext | None = None):
    """Expert-parallel MoE forward.

    Args:
      p: layer params.  x: ``(B, S, D)``, this rank's rows under a context
        (``models/parallel.py``).  bias: per-dispatcher CARE selection bias
        -- ``(E,)`` when ctx is None, else ``(DP, TP, E)``, one row per
        dispatcher.  ctx: parallel context (None = one device).

    Returns:
      ``(y, counts)``: y ``(B, S, D)``; counts -- ``(E,)`` float32 local
      counts when ctx is None, else ``(DP, TP, E)`` per-dispatcher counts
      (no cross-device reduction here; the CARE balancer syncs sparsely).
    """
    b, s, d = x.shape
    manual = (
        ctx is not None
        and s % ctx.tp_size == 0
        and (ctx.split or b % ctx.dp_size == 0)  # the global batch divides over dp
        and ctx.ep_size > 1
    )
    if not manual:
        # One device, and the decode path (tokens too few to shard over
        # TP): the reference's one-device computation on the whole batch,
        # averaged bias rows.  Where each rank holds its rows, it computes
        # them with the whole batch's capacity, positions and counts.
        bias_flat = bias.reshape(-1, cfg.n_routed_experts).mean(dim=0)
        rows = ctx if ctx is not None and ctx.split else None
        y, counts = _moe_local(x.reshape(b * s, d), bias_flat, p, cfg, rows=rows)
        y = y.reshape(b, s, d)
        if ctx is not None:
            counts = (counts[None, None, :] / (ctx.dp_size * ctx.tp_size)).expand(
                ctx.dp_size, ctx.tp_size, cfg.n_routed_experts)
    else:
        y, counts = _moe_manual(p, x, bias, cfg, ctx)
    if cfg.n_shared_experts:
        y = y + dense_ffn(p.shared, x, cfg)
    return y, counts
