"""One CPU rank of a gloo job for the port's expert-parallel tests.

Run by ``tests/test_torch_moe_ep.py``, one process a rank::

    python tests/torch_ranks.py RANK WORLD DIR

``DIR/job.pt`` holds the job (``torch.save``); the rank joins the others
through the file store ``DIR/store``, builds the job's DeviceMesh and
parallel context, runs the job and writes its results to
``DIR/out<RANK>.pt``.  Jobs:

* ``"moe"``: one ``moe_ffn`` layer under the context on the job's ``x``,
  bias rows and weights, then the gradient of ``sum(y * cot)`` with
  respect to ``x`` and every weight;
* ``"model"``: a reduced DeepSeek-V2 (parameters from the job's seed) under
  the context and without one: prefill and two decode steps, then one
  train step each from the same state on the same batch.

:func:`one_rank` gives a test a context on a (1, 1) mesh in its own
process (a world-size-1 gloo group).
"""
import contextlib
import dataclasses
import sys
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor

from repro_torch.launch import mesh as tmesh
from repro_torch.models import ffn, model, parallel
from repro_torch.optim import adamw
from repro_torch.train import train_loop


@contextlib.contextmanager
def one_rank(store: Path, num_experts: int = 0):
    """A world-size-1 gloo group on the file store ``store`` and the context
    of a (1, 1) mesh over it; the group ends on exit."""
    tmesh.init_ranks("cpu", rank=0, world_size=1, init_method=f"file://{store}")
    try:
        yield tmesh.make_context(tmesh.make_debug_mesh((1, 1), "cpu"), num_experts)
    finally:
        dist.destroy_process_group()


def _moe(job, ctx):
    cfg = job["cfg"]
    p = ffn.MoEFFN(cfg, device="cpu")
    p.load_state_dict(job["params"])
    p.requires_grad_(True)
    x = job["x"].clone().requires_grad_(True)
    y, counts = ffn.moe_ffn(p, x, job["bias"], cfg, ctx)
    (y * job["cot"]).sum().backward()
    grads = {n: t.grad.clone() for n, t in p.named_parameters()}
    return {"y": y.detach(), "counts": counts, "x_grad": x.grad.clone(), "grads": grads,
            "hint": _hint(ctx)}


def _hint(ctx):
    """``parallel.hint`` on DTensors of x's layout ``(dp, tp, None)``: laid
    out as the hint asks (a dimension that does not divide whole), and
    not.  Returns ``(returned the same tensor, refused the other)``."""
    dp, tp = ctx.dp_axes, ctx.tp_axis
    shape = (ctx.dp_size * 2, ctx.tp_size * 2 + 1, 4)  # dim 1 does not divide over tp > 1
    spec = parallel.divisible((dp, tp), shape, ctx.shape)
    right = distribute_tensor(torch.ones(shape), ctx.mesh, parallel.placements(spec, ctx.mesh))
    wrong = distribute_tensor(torch.ones(shape), ctx.mesh, [Shard(2)] * len(ctx.shape))
    same = parallel.hint(right, ctx, dp, tp) is right
    try:
        parallel.hint(wrong, ctx, dp, tp)
        refused = False
    except ValueError:
        refused = True
    return same, refused


def _serve(params, cfg, tokens, ctx):
    logits, cache = model.prefill(params, {"tokens": tokens}, cfg, ctx,
                                  cache_len=tokens.shape[1] + 2)
    out = [logits]
    for i in range(2):
        tok = torch.argmax(out[-1], dim=-1)
        logits, cache = model.decode_step(params, tok, cache, tokens.shape[1] + i, cfg, ctx)
        out.append(logits)
    return torch.stack(out)


def _model(job, ctx):
    cfg, opt_cfg, batch = job["cfg"], job["opt"], job["batch"]
    out = {}
    for name, c in (("ctx", ctx), ("none", None)):
        state = train_loop.init_state(torch.Generator().manual_seed(job["seed"]), cfg, c,
                                      device="cpu")
        with torch.no_grad():
            out[f"{name}_serve"] = _serve(state.params, cfg, batch["tokens"], c)
        step = train_loop.make_train_step(cfg, opt_cfg, c, sync=job["sync"])
        state, metrics = step(state, batch)
        out[f"{name}_metrics"] = {k: v.detach().clone() for k, v in metrics.items()}
        out[f"{name}_params"] = {n: t.detach().clone() for n, t in state.params.named_parameters()}
        opt = adamw.gather_state(state.opt, state.params, c)
        out[f"{name}_m"] = {n: t.clone() for n, t in opt.m.items()}
        out[f"{name}_v"] = {n: t.clone() for n, t in opt.v.items()}
        out[f"{name}_balancer"] = {f.name: getattr(state.balancer, f.name).clone()
                                   for f in dataclasses.fields(state.balancer)}
        out[f"{name}_opt_blocks"] = {n: tuple(t.shape) for n, t in state.opt.m.items()}
    return out


def main(rank: int, world: int, work: Path) -> None:
    job = torch.load(work / "job.pt", weights_only=False)
    tmesh.init_ranks("cpu", rank=rank, world_size=world, init_method=f"file://{work / 'store'}")
    try:
        dmesh = init_device_mesh("cpu", job["mesh"], mesh_dim_names=job["axes"])
        ctx = tmesh.make_context(dmesh, job["cfg"].n_routed_experts)
        out = {"moe": _moe, "model": _model}[job["kind"]](job, ctx)
        out["ctx"] = {"ep_axes": ctx.ep_axes, "fsdp_axis": ctx.fsdp_axis,
                      "grid": ctx.index(ctx.grid_axes)}
        torch.save(out, work / f"out{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
