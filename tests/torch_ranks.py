"""One CPU rank of a gloo job for the port's expert-parallel tests.

Run by ``tests/test_torch_moe_ep.py``, one process a rank::

    python tests/torch_ranks.py RANK WORLD DIR

``DIR/job.pt`` holds the job (``torch.save``); the rank joins the others
through the file store ``DIR/store``, builds the job's DeviceMesh and
parallel context, runs the job and writes its results to
``DIR/out<RANK>.pt``.  Jobs:

* ``"moe"``: one ``moe_ffn`` layer under the context on this rank's rows
  of the job's ``x`` (its dp block), bias rows and weights, then the
  gradient of ``sum(y * cot)`` with respect to ``x`` and every weight;
  ``y`` and ``x``'s gradient are gathered over dp and the weights'
  gradients summed over dp, as the train step sums them;
* ``"model"``: a reduced DeepSeek-V2 (parameters from the job's seed) under
  the context (on this rank's rows) and without one: prefill and two
  decode steps (the context's logits gathered over dp), then one train
  step each from the same state on the same batch;
* ``"dp"``: for each of the job's cases (a config, initial parameters,
  global batches, microbatches), train steps and serving under the
  context's views of the batch: ``"split"`` (``ctx.for_batch``: this
  rank's rows where they divide over dp), ``"whole"`` (every rank holds
  the whole batch) and ``"none"`` (no context); see :func:`_dp_case`.

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
    rows = ctx.take_rows({"x": job["x"], "cot": job["cot"]})
    x = rows["x"].clone().requires_grad_(True)
    y, counts = ffn.moe_ffn(p, x, job["bias"], cfg, ctx)
    (y * rows["cot"]).sum().backward()
    grads = {n: ctx.dp_sum(t.grad.clone()) for n, t in p.named_parameters()}
    return {"y": _gather_rows(y.detach(), ctx), "counts": counts,
            "x_grad": _gather_rows(x.grad, ctx), "grads": grads, "hint": _hint(ctx)}


def _gather_rows(t, ctx):
    """The whole batch from every dp rank's rows of it."""
    return parallel.gather(t.detach(), parallel.Spec(ctx.dp_axes), ctx) if ctx.split else t


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
        rows = batch if c is None else c.take_rows(batch)
        with torch.no_grad():
            served = _serve(state.params, cfg, rows["tokens"], c)
            out[f"{name}_serve"] = served if c is None else _gather_rows(
                served.transpose(0, 1), c).transpose(0, 1)
        step = train_loop.make_train_step(cfg, opt_cfg, c, sync=job["sync"])
        state, metrics = step(state, rows)
        out[f"{name}_metrics"] = {k: v.detach().clone() for k, v in metrics.items()}
        out[f"{name}_params"] = {n: t.detach().clone() for n, t in state.params.named_parameters()}
        opt = adamw.gather_state(state.opt, state.params, c)
        out[f"{name}_m"] = {n: t.clone() for n, t in opt.m.items()}
        out[f"{name}_v"] = {n: t.clone() for n, t in opt.v.items()}
        out[f"{name}_balancer"] = {f.name: getattr(state.balancer, f.name).clone()
                                   for f in dataclasses.fields(state.balancer)}
        out[f"{name}_opt_blocks"] = {n: tuple(t.shape) for n, t in state.opt.m.items()}
    return out


def _state_of(state, c) -> dict:
    """Parameters, whole moments and the balancer of a train state."""
    opt = adamw.gather_state(state.opt, state.params, c)
    out = {"params": {n: t.detach().clone() for n, t in state.params.named_parameters()},
           "m": {n: t.clone() for n, t in opt.m.items()},
           "v": {n: t.clone() for n, t in opt.v.items()}}
    if state.balancer is not None:
        out["balancer"] = {f.name: getattr(state.balancer, f.name).clone()
                           for f in dataclasses.fields(state.balancer)}
    return out


def _dp_case(case, ctx) -> dict:
    """One case of a ``"dp"`` job, for each of ``case["runs"]``.

    Every run starts from the case's initial parameters (``case["params"]``,
    a state dict; else drawn from ``case["seed"]``).  ``train``: one train
    step a global batch of ``case["batches"]`` with the balancer-sync flags
    of ``case["syncs"]`` at ``case["micro"]`` microbatches; the metrics of
    each step (with the balancer's ``true_counts``), then the state.  ``serve``: a prefill of the first batch's
    tokens and two greedy decode steps.  ``decode``: one decode step of
    the first batch's first tokens from a zero cache.  Under a context
    every input is this rank's rows and every output its rows' (the
    logits are not gathered); the run ``"rows"`` takes this rank's rows
    with no context."""
    cfg, m = case["cfg"], case.get("micro", 1)
    ctx = tmesh.make_context(ctx.mesh, cfg.n_routed_experts if cfg.moe else 0)
    batches = case["batches"]
    rows = batches[0]["tokens"].shape[0]
    out = {}
    for run in case["runs"]:
        c = {"split": ctx.for_batch(rows, m), "whole": ctx.with_whole_batch(), "none": None,
             "rows": None}[run]
        take = ctx.for_batch(rows, m) if run == "rows" else c
        state = train_loop.init_state(torch.Generator().manual_seed(case.get("seed", 0)), cfg, c,
                                      device="cpu")
        if case.get("params") is not None:
            with torch.no_grad():
                state.params.load_state_dict(case["params"])
        r = {"whole": c is not None and c.whole_batch}
        first = batches[0] if take is None else take.take_rows(batches[0], m)
        r["rows"] = first["tokens"].shape[0]
        with torch.no_grad():
            if "serve" in case["do"]:
                r["serve"] = _serve(state.params, cfg, first["tokens"], c)
            if "decode" in case["do"]:
                cache = model.init_decode_cache(state.params, cfg, r["rows"] if run == "rows"
                                                else rows, 4, c)
                r["cache_rows"] = next(iter(cache["scan"].values())).shape[1]
                r["decode"] = model.decode_step(state.params, first["tokens"][:, 0], cache, 0,
                                                cfg, c)[0]
        if "train" in case["do"]:
            r["metrics"] = []
            for batch, sync in zip(batches, case["syncs"]):
                step = train_loop.make_train_step(cfg, case["opt"], c, sync=sync, microbatches=m)
                state, metrics = step(state, batch if c is None else c.take_rows(batch, m))
                r["metrics"].append({k: v.detach().clone() for k, v in metrics.items()})
                if state.balancer is not None:
                    r["metrics"][-1]["true_counts"] = state.balancer.true_counts.clone()
            r.update(_state_of(state, c))
        out[run] = r
    return out


def _dp(job, ctx):
    rows = torch.arange(job["rows"])
    try:
        ctx.take_rows({"t": torch.arange(ctx.dp_size + 1)})
        refused = False
    except ValueError:
        refused = True
    return {"cases": {name: _dp_case(case, ctx) for name, case in job["cases"].items()},
            "take_rows": {m: ctx.take_rows({"t": rows}, m)["t"] for m in (1, 2)},
            "take_rows_refused": refused,
            "whole_rows": ctx.for_batch(ctx.dp_size + 1).take_rows({"t": rows})["t"]}


def main(rank: int, world: int, work: Path) -> None:
    job = torch.load(work / "job.pt", weights_only=False)
    tmesh.init_ranks("cpu", rank=rank, world_size=world, init_method=f"file://{work / 'store'}")
    try:
        dmesh = init_device_mesh("cpu", job["mesh"], mesh_dim_names=job["axes"])
        ctx = tmesh.make_context(dmesh, job["cfg"].n_routed_experts if "cfg" in job else 0)
        out = {"moe": _moe, "model": _model, "dp": _dp}[job["kind"]](job, ctx)
        out["ctx"] = {"ep_axes": ctx.ep_axes, "fsdp_axis": ctx.fsdp_axis,
                      "grid": ctx.index(ctx.grid_axes), "dp": ctx.index(ctx.dp_axes)}
        torch.save(out, work / f"out{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
