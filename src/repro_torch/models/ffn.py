"""Feed-forward blocks: dense (GLU / plain) and the expert-parallel MoE.

Port of ``repro/models/ffn.py``: route locally -> scatter tokens into
per-expert capacity buffers -> all_to_all over the EP axes -> expert
matmuls -> all_to_all back -> weighted gather-combine.  Routing always goes
through :func:`repro_torch.kernels.ops.moe_route`, which launches the
Hopper kernel for a CUDA tensor and runs its plain version for a CPU one;
the kernel also returns each (token, slot)'s position in its expert's
buffer, so no one-hot or cumsum runs on the card.

Under a parallel context each rank holds its dp block of the batch's rows
(``models/parallel.py``) and, wherever the EP group has several ranks, its
block of the routed experts (``partitioning.expert_specs``: its experts,
or under EP+FSDP its experts' block of ``D``, gathered over the FSDP axis
for each layer).  Where the mesh divides the batch, the sequence and the
experts (the reference's manual region), each rank is one dispatcher: it
takes its ``S/TP`` block of its rows' positions and its bias row,
exchanges capacity buffers with ``all_to_all_single`` over the EP group
and returns its rows' ``y`` (gathered over the TP group) with ``(DP, TP,
E)`` per-dispatcher counts.  Elsewhere (decode, or a sequence that does
not divide over TP) each rank routes the whole batch as one device does,
multiplies only its own experts' buffers and sums ``y`` over the EP
group.  Counts are never reduced here: the CARE balancer's sparse sync
(``core/moe_balancer.py``) is the only place global counts are formed.
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
        self.d_ff = f  # the whole width, of which a TP rank may hold a block
        pdt = common.dtype_of(cfg.param_dtype)
        out_scale = 0.02 / max(cfg.num_layers, 1) ** 0.5
        self.w_in = common.dense_init(generator, (d, f), pdt, device)
        self.w_out = common.dense_init(generator, (f, d), pdt, device, scale=out_scale)
        if cfg.glu:
            self.w_gate = common.dense_init(generator, (d, f), pdt, device)


def dense_ffn(p: DenseFFN, x: torch.Tensor, cfg: ModelConfig, ctx=None):
    """The (GLU) FFN.  Where ``p`` holds this rank's block of the hidden
    units (``partitioning.local_specs``: columns of ``w_in`` / ``w_gate``,
    rows of ``w_out``), the product is summed over the TP group of
    ``ctx``."""
    tctx = ctx if p.w_in.shape[-1] < p.d_ff else None
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
               ctx: parallel.ParallelContext | None = None, first: int = 0):
    """Per-rank MoE body.  xt: ``(T, D)`` local tokens, bias ``(E,)``.

    With ``ctx`` (the manual region) the expert weights in ``p`` are this
    rank's blocks: ``(E_loc, D, F)`` under pure EP sharding, or ``(E_loc,
    D/fsdp, F)`` under EP+FSDP (gathered here), and buffers of every
    expert cross the EP group.  Without it ``p`` holds experts ``first ..
    first + E_loc`` (all E on one device) and only theirs are filled and
    multiplied: the tokens' share of ``y`` those experts give.  Returns
    ``(y (T, D), counts (E,) float32)``.  A (token, slot) pair past its
    expert's capacity, or routed to an expert ``p`` does not hold, goes to
    a sink row and contributes nothing.
    """
    t_loc, d = xt.shape
    e, k = cfg.n_routed_experts, cfg.moe_top_k
    cdt = common.dtype_of(cfg.compute_dtype)

    w_in_l, w_gate_l, w_out_l = p.w_in, p.w_gate_h, p.w_out
    if ctx is not None and w_in_l.shape[1] < d:
        # Expert weights are FSDP-sharded on the D/F dim: gather per layer.
        g = ctx.group(ctx.fsdp_axis)
        w_in_l = parallel.all_gather(w_in_l, g, 1)
        w_gate_l = parallel.all_gather(w_gate_l, g, 1)
        w_out_l = parallel.all_gather(w_out_l, g, 2)

    logits = xt.to(torch.float32) @ p.gate
    # pos: each (token, slot)'s position within its expert's capacity buffer.
    idx, weights, counts, pos = _route(logits, bias, cfg)  # (t,k),(t,k),(E,),(t*k,)
    flat_e = idx.reshape(-1)  # (t*k,) int32

    cap = _capacity(t_loc, k, e, cfg.moe_capacity_factor)
    ep = ctx.ep_size if ctx is not None else 1
    held = e if ep > 1 else w_in_l.shape[0]  # experts with a buffer here
    slot = flat_e - first
    keep = pos < cap
    if held < e:  # only experts first .. first + held have a buffer here
        keep = keep & (slot >= 0) & (slot < held)
    lin = torch.where(keep, slot * cap + pos, held * cap).long()  # overflow -> sink row

    buf = torch.zeros((held * cap + 1, d), dtype=cdt, device=xt.device)
    tok_rows = xt.to(cdt).repeat_interleave(k, dim=0)  # (t*k, D)
    buf.index_add_(0, lin, tok_rows)
    buf = buf[: held * cap]

    e_loc = e // ep
    if ep > 1:
        group = ctx.group(ctx.ep_axes)
        # (EP, E_loc*cap, D) in rank order: block [j] goes to rank j, and
        # block [j] of what comes back came from rank j.
        recv = parallel.all_to_all(buf, group).reshape(ep, e_loc, cap, d)
        work = recv.transpose(0, 1).reshape(e_loc, ep * cap, d)
    else:
        work = buf.reshape(held, cap, d)

    act = common.activation(cfg.act)
    h = act(torch.einsum("end,edf->enf", work, w_in_l))
    h = h * torch.einsum("end,edf->enf", work, w_gate_l)
    out = torch.einsum("enf,efd->end", h, w_out_l)

    if ep > 1:
        out = out.reshape(e_loc, ep, cap, d).transpose(0, 1).reshape(e * cap, d)
        back = parallel.all_to_all(out, group)
    else:
        back = out.reshape(held * cap, d)

    back = torch.cat([back, back.new_zeros((1, d))], dim=0)
    picked = back[lin]  # (t*k, D); sink row is zero
    w_flat = (weights.reshape(-1, 1) * keep[:, None]).to(cdt)
    y = torch.sum((picked * w_flat).reshape(t_loc, k, d), dim=1)
    return y, counts.to(torch.float32)


def _check_expert_blocks(p: MoEFFN, cfg: ModelConfig, ctx: parallel.ParallelContext) -> None:
    e_loc = cfg.n_routed_experts // ctx.ep_size
    if p.w_in.shape[0] != e_loc:
        raise ValueError(
            f"the layer holds {p.w_in.shape[0]} experts, a rank of an EP group of "
            f"{ctx.ep_size} holds {e_loc}: take its blocks (partitioning.take_blocks)")


def _moe_held(p: MoEFFN, x: torch.Tensor, bias: torch.Tensor, cfg: ModelConfig,
              ctx: parallel.ParallelContext):
    """The one-device computation on the whole batch under a context whose
    ranks hold their expert blocks: ``y`` of ``x``'s rows, counts ``(E,)``.

    Where each rank holds its dp block of the rows, the dp group's rows are
    gathered first.  Every rank routes the whole batch alike (the whole
    batch's capacity, positions and drops), fills and multiplies only its
    experts' buffers (gathered over the FSDP axis), and the partial ``y``
    is summed over the EP group; the rank keeps its rows.

    Gradients: ``y``'s is summed over the dp axes the EP group spans (the
    ranks whose experts serve each other's rows) and is then the same on
    every rank of the EP group, so each rank's share of ``x``'s and the
    router ``gate``'s gradients is summed over the EP group (``gate``'s over
    TP only where the train step's dp sum adds the rest); an expert block's
    is complete over the rows its EP group routes, and summed over the
    ranks that hold other rows (the FSDP gather's adjoint, the train
    step's dp sum over the axes the block does not split)."""
    b, s, d = x.shape
    e = cfg.n_routed_experts
    t = b * s
    xt = x.reshape(t, d)
    if ctx.split:
        n = ctx.dp_size
        blocks = [(slice(i * t, (i + 1) * t),) for i in range(n)]
        xt = parallel.gather_blocks(xt, ctx.group(ctx.dp_axes), blocks, (n * t, d))
    xt = parallel.group_copy(xt, ctx, ctx.ep_axes)
    local = types.SimpleNamespace(
        gate=parallel.group_copy(p.gate, ctx, ctx.tp_axis if ctx.split else ctx.ep_axes),
        w_in=p.w_in, w_gate_h=p.w_gate_h, w_out=p.w_out)
    first = 0
    if ctx.ep_size > 1:
        _check_expert_blocks(p, cfg, ctx)
        spec = partitioning.expert_specs(ctx)[0]
        first = parallel.shard_index(spec, (e, d, cfg.moe_d_ff), ctx)[0].start
    if p.w_in.shape[1] < d:
        group = ctx.group(ctx.fsdp_axis)
        if ctx.split:  # the FSDP ranks hold other rows: their shares are summed
            local.w_in, local.w_gate_h, local.w_out = (
                parallel.all_gather(w, group, dim) for w, dim in
                ((p.w_in, 1), (p.w_gate_h, 1), (p.w_out, 2)))
        else:  # every FSDP rank computes the same whole gradient
            local.w_in, local.w_gate_h, local.w_out = (
                parallel.gather_same(w, group, dim) for w, dim in
                ((p.w_in, 1), (p.w_gate_h, 1), (p.w_out, 2)))
    y, counts = _moe_local(xt, bias, local, cfg, first=first)
    y = parallel.group_reduce(y, ctx, ctx.ep_axes)
    if ctx.split:
        i = ctx.index(ctx.dp_axes)
        rows = (slice(i * t, (i + 1) * t),)
        spanned = tuple(a for a in ctx.dp_axes if a in ctx.ep_axes)
        if ctx.size(spanned) > 1:
            y = parallel.scatter(y, rows, ctx.group(spanned))
        else:
            y = y[rows]
    return y, counts


def _moe_manual(p: MoEFFN, x: torch.Tensor, bias: torch.Tensor, cfg: ModelConfig,
                ctx: parallel.ParallelContext):
    """The reference's ``shard_map`` region: this rank's dispatcher on its
    block of the tokens; ``y`` of ``x``'s rows, counts ``(DP, TP, E)``.

    Where each rank holds its dp block of the rows (``ctx.split``, or dp
    1), the dispatcher takes its positions block of them and ``y`` is
    gathered over the TP group; where every rank holds the whole batch, it
    takes its ``(B/DP, S/TP)`` block and ``y`` is gathered over the grid.
    The expert weights are the rank's blocks as it holds them."""
    _check_expert_blocks(p, cfg, ctx)
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
    # Every rank of the group holds the same rows and the whole gate: the
    # blocks' gradients are summed over the group.  Over the TP group that
    # leaves each dp rank its rows' share, which the train step sums over
    # dp with every other whole leaf's.
    local = types.SimpleNamespace(gate=parallel.scatter(p.gate, (), group), w_in=p.w_in,
                                  w_gate_h=p.w_gate_h, w_out=p.w_out)
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
        # averaged bias rows.  Under a context whose ranks hold expert
        # blocks or rows of their own, each rank computes its experts'
        # share of the whole batch (:func:`_moe_held`).
        bias_flat = bias.reshape(-1, cfg.n_routed_experts).mean(dim=0)
        if ctx is None or (ctx.ep_size == 1 and not ctx.split):
            y, counts = _moe_local(x.reshape(b * s, d), bias_flat, p, cfg)
        else:
            y, counts = _moe_held(p, x, bias_flat, cfg, ctx)
        y = y.reshape(b, s, d)
        if ctx is not None:
            counts = (counts[None, None, :] / (ctx.dp_size * ctx.tp_size)).expand(
                ctx.dp_size, ctx.tp_size, cfg.n_routed_experts)
    else:
        y, counts = _moe_manual(p, x, bias, cfg, ctx)
    if cfg.n_shared_experts:
        y = y + dense_ffn(p.shared, x, cfg, ctx)
    return y, counts
