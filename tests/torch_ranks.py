"""One CPU rank of a gloo job for the port's expert-parallel tests.

Run by ``tests/test_torch_moe_ep.py``, one process a rank::

    python tests/torch_ranks.py RANK WORLD DIR

``DIR/job.pt`` holds the job (``torch.save``); the rank joins the others
through the file store ``DIR/store``, builds the job's DeviceMesh and
parallel context, runs the job and writes its results to
``DIR/out<RANK>.pt``.  Jobs:

* ``"moe"``: one ``moe_ffn`` layer under the context on this rank's rows
  of the job's ``x`` (its dp block), bias rows and weights (its expert
  blocks), then the gradient of ``sum(y * cot)`` with respect to ``x``
  and every weight; ``y`` and ``x``'s gradient are gathered over dp and
  the weights' gradients summed over dp as the train step sums them, each
  expert block's then gathered whole;
* ``"model"``: a reduced DeepSeek-V2 (parameters from the job's seed) under
  the context (on this rank's rows) and without one: prefill and two
  decode steps (the context's logits gathered over dp), then one train
  step each from the same state on the same batch;
* ``"dp"``: for each of the job's cases (a config, initial parameters,
  global batches, microbatches), train steps and serving under the
  context's views of the batch: ``"split"`` (``ctx.for_batch``: this
  rank's rows where they divide over dp), ``"whole"`` (every rank holds
  the whole batch) and ``"none"`` (no context); see :func:`_dp_case`;
* ``"tp"``: for each of the job's cases (a config of any family, the JAX
  package's initial parameters, global batches), tensor parallelism over
  ``model`` (and a MoE model's expert blocks, under the context
  ``make_context`` gives its experts): the rank's blocks of the
  parameters, two train steps under the context, the state gathered
  whole, a prefill and two decode steps, a decode from a zero cache and
  an optional longer prefill against ``ctx=None``, and a checkpoint saved
  under the context (each leaf gathered onto rank 0, which writes it) and
  restored into a fresh state's blocks; see :func:`_tp_case`.

:func:`one_rank` gives a test a context on a (1, 1) mesh in its own
process (a world-size-1 gloo group).
"""
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor

from repro_torch.ckpt import checkpoint
from repro_torch.launch import mesh as tmesh
from repro_torch.models import convert, ffn, model, parallel, partitioning
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
    # The rank's expert blocks (partitioning.expert_specs) where EP splits them.
    specs = {}
    if ctx.ep_size > 1:
        specs = dict(zip(("w_in", "w_gate_h", "w_out"), partitioning.expert_specs(ctx)))
        with torch.no_grad():
            for name, spec in specs.items():
                w = getattr(p, name)
                setattr(p, name, torch.nn.Parameter(w[parallel.shard_index(spec, w.shape, ctx)]))
    p.requires_grad_(True)
    rows = ctx.take_rows({"x": job["x"], "cot": job["cot"]})
    x = rows["x"].clone().requires_grad_(True)
    y, counts = ffn.moe_ffn(p, x, job["bias"], cfg, ctx)
    (y * rows["cot"]).sum().backward()
    # Summed over dp as the train step sums them, each block gathered whole.
    grads = {}
    for n, t in p.named_parameters():
        g = ctx.dp_sum(t.grad.clone(), specs.get(n))
        grads[n] = parallel.gather(g, specs[n], ctx) if n in specs else g
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
        out[f"{name}_params"] = {n: t.detach().clone() for n, t in
                                 convert.whole_model(state.params, cfg, c).named_parameters()}
        opt = adamw.gather_state(state.opt, state.params, c)
        out[f"{name}_m"] = {n: t.clone() for n, t in opt.m.items()}
        out[f"{name}_v"] = {n: t.clone() for n, t in opt.v.items()}
        out[f"{name}_balancer"] = {f.name: getattr(state.balancer, f.name).clone()
                                   for f in dataclasses.fields(state.balancer)}
        out[f"{name}_opt_blocks"] = {n: tuple(t.shape) for n, t in state.opt.m.items()}
    return out


def _state_of(state, cfg, c) -> dict:
    """Whole parameters and moments, and the balancer, of a train state."""
    opt = adamw.gather_state(state.opt, state.params, c)
    whole = convert.whole_model(state.params, cfg, c)
    out = {"params": {n: t.detach().clone() for n, t in whole.named_parameters()},
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
        if case.get("params") is not None:  # whole leaves: keep the rank's blocks
            blocks = partitioning.block_names(state.params)
            with torch.no_grad():
                for n, t in state.params.named_parameters():
                    w = case["params"][n]
                    t.copy_(parallel.take_block(w, blocks[n], c) if n in blocks else w)
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
            r.update(_state_of(state, cfg, c))
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


def _tp_state(params, cfg, c) -> train_loop.TrainState:
    """A train state over a rank's ``params`` (fresh moments)."""
    params = train_loop.trainable(params)
    specs = None if c is None else partitioning.moment_specs(params, cfg, c)
    return train_loop.TrainState(params=params, opt=adamw.init(params, c, specs), balancer=None,
                                 step=torch.zeros((), dtype=torch.int32))


def _cache_layout(cache: dict) -> tuple:
    """``({mark: value} of the cache's split marks (``"kv_split"``,
    ``"cross_split"``), {path: shape} of every leaf)`` of a decode
    cache."""
    shapes = {}
    for part, tree in cache.items():
        if isinstance(tree, str):
            continue
        for key, t in tree.items():
            if isinstance(t, dict):
                shapes.update({f"{part}/{key}/{n}": tuple(v.shape) for n, v in t.items()})
            else:
                shapes[f"{part}/{key}"] = tuple(t.shape)
    return {k: v for k, v in cache.items() if isinstance(v, str)}, shapes


def _tp_case(case, ctx, work: Path) -> dict:
    """One case of a ``"tp"`` job.  ``case["tree"]``: the JAX package's
    parameters (numpy); ``case["batches"]``: global batches.  Returns the
    shapes of the blocks this rank holds and of their whole leaves; the
    metrics of one train step a batch under the context and the state
    gathered whole; this rank's rows of the logits of a prefill (cache of
    ``case["cache_len"]``; Whisper's frames from the batch) and two greedy
    decode steps, under the context and without one, with the cache's
    split marks and shapes; a decode step from a zero cache both ways;
    with ``case["long"]`` (global tokens), a prefill of them both ways;
    with ``case["ckpt"]``, whether the
    checkpoint saved under the context is rank 0's alone and equals a
    whole state's, and whether restoring it into a fresh state's blocks
    gives the trained state's blocks back bit for bit."""
    cfg = case["cfg"]
    batches = case["batches"]
    rows = batches[0]["tokens"].shape[0]
    c = tmesh.make_context(ctx.mesh, cfg.n_routed_experts if cfg.moe else 0).for_batch(rows)
    out = {}
    state = _tp_state(convert.params_from_jax(case["tree"], cfg, "cpu", c), cfg, c)
    whole = convert.params_from_jax(case["tree"], cfg, "cpu")
    out["blocks"] = {n: (tuple(t.shape), tuple(whole.get_parameter(n).shape))
                     for n, t in state.params.named_parameters()}
    out["tp_specs"] = dict(state.params.tp_specs)
    mine = [c.take_rows(b) for b in batches]
    with torch.no_grad():
        for name, cc, p, first in (("ctx", c, state.params, mine[0]),
                                   ("none", None, whole, batches[0])):
            inputs = {k: v for k, v in first.items() if k != "labels"}
            logits, cache = model.prefill(p, inputs, cfg, cc, cache_len=case["cache_len"])
            served = [logits]
            for i in range(2):
                logits, cache = model.decode_step(p, served[-1].argmax(-1), cache,
                                                  first["tokens"].shape[1] + i, cfg, cc)
                served.append(logits)
            out[f"{name}_serve"] = torch.stack(served)
            out[f"{name}_cache"] = _cache_layout(cache)
            zero = model.init_decode_cache(p, cfg, rows, case["cache_len"], cc)
            out[f"{name}_zero_cache"] = _cache_layout(zero)
            out[f"{name}_zero"] = model.decode_step(p, first["tokens"][:, 0], zero, 3, cfg, cc)[0]
            if case.get("long") is not None:
                long = case["long"] if cc is None else c.take_rows({"t": case["long"]})["t"]
                out[f"{name}_long"] = model.prefill(p, {"tokens": long}, cfg, cc)[0]
    step = train_loop.make_train_step(cfg, case["opt"], c)
    out["metrics"] = []
    for b in mine:
        state, metrics = step(state, b)
        out["metrics"].append({k: v.detach().clone() for k, v in metrics.items()})
    full = dataclasses.replace(state, params=convert.whole_model(state.params, cfg, c),
                               opt=adamw.gather_state(state.opt, state.params, c))
    out["params"] = {n: t.detach().clone() for n, t in full.params.named_parameters()}
    out["m"], out["v"] = full.opt.m, full.opt.v
    if case.get("held"):
        out["held"] = _held_grads(case, cfg, c)
    if case.get("ckpt"):
        directory = work / "ckpt"
        written = checkpoint.save(state, directory, 2, ctx=c)
        out["ckpt_written"] = (written is not None) == (dist.get_rank() == 0)
        if written is not None:  # the file a whole state's save writes
            want, dtypes = checkpoint.flatten(full)
            data = np.load(written / "arrays.npz")
            manifest = json.loads((written / "manifest.json").read_text())["arrays"]
            out["ckpt_written"] &= (sorted(data.files) == sorted(want) and all(
                np.array_equal(data[k], a) and manifest[k]["dtype"] == dtypes[k]
                for k, a in want.items()))
        dist.barrier()
        fresh = _tp_state(model.init_params(torch.Generator().manual_seed(5), cfg, "cpu", c),
                          cfg, c)
        fresh, at = checkpoint.restore(fresh, directory, ctx=c)
        same = at == 2 and int(fresh.step) == int(state.step) == 2
        for n, t in state.params.named_parameters():
            same &= torch.equal(t, fresh.params.get_parameter(n))
        for part in ("m", "v"):
            for k, t in getattr(state.opt, part).items():
                same &= torch.equal(t, getattr(fresh.opt, part)[k])
        out["ckpt_same"] = same
    return out


def _held_grads(case, cfg, c) -> dict:
    """``train_loss`` and its gradients (each rank's share summed over dp
    as the train step sums it, blocks gathered whole) on the first batch
    cut to ``S - 1`` positions, which do not divide over TP, so that every
    MoE layer takes the one-device path on the rank's expert blocks:
    under the split context, under its whole-batch view and without one."""
    batch = {k: v[:, :-1] for k, v in case["batches"][0].items()}
    out = {}
    for name, cc in (("split", c), ("whole", c.with_whole_batch()), ("none", None)):
        params = train_loop.trainable(convert.params_from_jax(case["tree"], cfg, "cpu", cc))
        named = dict(params.named_parameters())
        loss, _ = model.train_loss(params, batch if cc is None else cc.take_rows(batch), cfg, cc)
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        loss = loss.detach()
        if cc is not None:
            blocks = partitioning.block_names(params)
            loss = cc.dp_sum(loss.clone())
            grads = {n: cc.dp_sum(g.contiguous(), blocks.get(n)) for n, g in grads.items()}
            grads = {n: parallel.gather(g, blocks[n], cc) if n in blocks else g
                     for n, g in grads.items()}
        out[name] = {"loss": loss, "grads": grads}
    return out


def _tp(job, ctx, work: Path) -> dict:
    cases = {name: _tp_case(case, ctx, work) for name, case in job["cases"].items()}
    return {"cases": cases, "tp": ctx.index(ctx.tp_axis)}


def main(rank: int, world: int, work: Path) -> None:
    job = torch.load(work / "job.pt", weights_only=False)
    tmesh.init_ranks("cpu", rank=rank, world_size=world, init_method=f"file://{work / 'store'}")
    try:
        dmesh = init_device_mesh("cpu", job["mesh"], mesh_dim_names=job["axes"])
        ctx = tmesh.make_context(dmesh, job["cfg"].n_routed_experts if "cfg" in job else 0)
        if job["kind"] == "tp":
            out = _tp(job, ctx, work)
        else:
            out = {"moe": _moe, "model": _model, "dp": _dp}[job["kind"]](job, ctx)
        out["ctx"] = {"ep_axes": ctx.ep_axes, "fsdp_axis": ctx.fsdp_axis,
                      "grid": ctx.index(ctx.grid_axes), "dp": ctx.index(ctx.dp_axes)}
        torch.save(out, work / f"out{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
