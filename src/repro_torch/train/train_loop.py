"""Train step: loss -> grads -> AdamW -> CARE balancer advance.

Port of ``repro/train/train_loop.py``.  Two programs implement the
paper's sparse synchronisation at the framework level:

* ``make_train_step(..., sync=False)`` -- the balancer advances by local
  emulation (the paper's approximation component);
* ``make_train_step(..., sync=True)`` -- it also snaps the approximation
  to the exact counts (the paper's "message").

The host loop (``launch/train.py``) picks one per step from the DT-x
schedule or the ET-x trigger the previous step returned.  Microbatch
gradients are summed in float32 and the optimiser is applied once.  On the
card the step runs the Hopper kernels forward and backward
(``flash_attention``, ``moe_route``); the plain versions run only on the
CPU.  The step writes the parameters, moments and balancer of the state it
is given in place and returns it with its step advanced.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import moe_balancer
from repro_torch.models import model, partitioning
from repro_torch.optim import adamw


@dataclasses.dataclass
class TrainState:
    params: model.Model
    opt: adamw.OptState
    balancer: moe_balancer.BalancerState | None
    step: torch.Tensor  # () int32


def trainable(params: model.Model) -> model.Model:
    """Turn on the gradient of every parameter of ``params`` (serving
    creates them without, so that it records no graph)."""
    return params.requires_grad_(True)


def init_state(generator: torch.Generator, cfg: ModelConfig, ctx=None, *,
               device=None) -> TrainState:
    """A fresh state on ``device`` (None means the CUDA card): parameters
    drawn from ``generator`` (on the same device), zero moments, a zero
    ``(L_scan, E)`` balancer for a MoE model.  Under a parallel context
    the balancer has one row per dispatcher, ``(L_scan, DP, TP, E)``, the
    parameters are this rank's TP and expert blocks
    (``partitioning.take_blocks``), and each rank keeps its ZeRO-1 block of
    the moments (``partitioning.moment_specs``)."""
    params = trainable(model.init_params(generator, cfg, device, ctx))
    dev = params.embed.device
    bal = None
    if cfg.moe:
        bal = moe_balancer.BalancerState.init(
            model.num_scanned_layers(cfg), cfg.n_routed_experts, dev,
            dispatchers=() if ctx is None else (ctx.dp_size, ctx.tp_size))
    specs = None
    if ctx is not None:
        specs = partitioning.moment_specs(params, cfg, ctx)
    return TrainState(
        params=params,
        opt=adamw.init(params, ctx, specs),
        balancer=bal,
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _grads(loss: torch.Tensor, params: dict) -> dict:
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), got)}


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.OptimConfig,
    ctx=None,
    *,
    sync: bool = False,
    microbatches: int = 1,
):
    """The step ``step_fn(state, batch) -> (state, metrics)``.

    ``batch``: ``{"tokens", "labels"}`` (and whisper's ``"frames"``), numpy
    arrays or tensors, moved to the parameters' device.  ``metrics``:
    ``loss``, ``sync_trigger`` (0-d bool), ``grad_norm`` and ``lr``, 0-d
    tensors on the device.  ``sync`` selects the balancer-sync program.
    Under a parallel context ``ctx`` the batch is this rank's rows:
    ``ctx.take_rows(batch, microbatches)`` of the global batch, stepped
    under ``ctx.for_batch(rows, microbatches)``, so that microbatch ``i``
    of every rank is its dp block of the reference's microbatch ``i``.  The
    loss is the whole batch's token mean, each gradient is summed over the
    dp group once, and AdamW clips by the summed gradients' norm and
    updates this rank's ZeRO-1 block of each parameter, then gathers the
    parameter whole; the MoE layers exchange tokens over the mesh
    (``models/ffn.py``).  Under tensor parallelism a split leaf's gradient
    is the rank's block of the whole one and a whole leaf's is already
    equal on every TP rank, so the sum stays over dp only; an expert
    block's is complete over the dp axes it splits (the EP exchange and
    the FSDP gather bring every row's share), so it is summed over the
    other dp axes only.  AdamW's norm sums each block's squares over the
    axes that split it.  ``loss`` is the same on every rank."""

    def step_fn(state: TrainState, batch: dict):
        params = dict(state.params.named_parameters())
        dev = state.params.embed.device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        bias = None
        if cfg.moe and state.balancer is not None:
            bias = moe_balancer.selection_bias(state.balancer, cfg.care)

        if microbatches == 1:
            loss, aux = model.train_loss(state.params, batch, cfg, ctx, bias)
            grads = _grads(loss, params)
            loss = loss.detach()
            counts = aux["counts"]
        else:
            rows = next(iter(batch.values())).shape[0] // microbatches
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            counts = (torch.zeros_like(state.balancer.true_counts)
                      if state.balancer is not None else None)
            for i in range(microbatches):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                mb_loss, aux = model.train_loss(state.params, mb, cfg, ctx, bias)
                for n, g in _grads(mb_loss, params).items():
                    grads[n] += g.to(torch.float32)
                loss = loss + mb_loss.detach()
                if counts is not None and aux["counts"] is not None:
                    counts = counts + aux["counts"]
            grads = {n: g / microbatches for n, g in grads.items()}
            loss = loss / microbatches

        if ctx is not None:
            # Each rank's loss and gradients are its rows' shares of the
            # whole batch's, summed over the dp axes a held block does not
            # split; no collective is issued when it holds them all.
            blocks = partitioning.block_names(state.params)
            grads = {n: ctx.dp_sum(g.contiguous(), blocks.get(n)) for n, g in grads.items()}
            loss = ctx.dp_sum(loss.clone())
        _, opt, opt_metrics = adamw.update(grads, state.opt, state.params, opt_cfg, ctx)

        balancer = state.balancer
        trigger = torch.zeros((), dtype=torch.bool, device=dev)
        if balancer is not None and counts is not None:
            balancer = moe_balancer.post_step_update(balancer, counts.detach(), cfg.care)
            trigger = moe_balancer.needs_sync(balancer, cfg.care)
            if sync:
                balancer = moe_balancer.sync(balancer, cfg.care)

        metrics = {"loss": loss, "sync_trigger": trigger, **opt_metrics}
        return TrainState(params=state.params, opt=opt, balancer=balancer,
                          step=state.step + 1), metrics

    return step_fn
