"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake tensors.

Port of ``repro/launch/dryrun.py``, which lowers and compiles each cell
with XLA onto 512 forced host devices.  The port compiles nothing: for each
cell this module

  1. starts a fake process group of 256 (``pod16x16``) or 512
     (``pod2x16x16``) ranks as rank 0 (``torch.distributed``'s ``fake``
     backend: collectives complete at once and move nothing) and a
     ``DeviceMesh`` over it with the production mesh's axes
     (``launch/mesh.make_production_mesh``);
  2. builds the parallel context with ``make_context``;
  3. under ``FakeTensorMode`` (no memory, no card) builds the parameters
     and the optimizer state this rank holds (its TP blocks of a dense
     decoder's split leaves, every other leaf whole; ZeRO-1 blocks of the
     moments) and this rank's rows of every input (its dp block of the
     batch, of each microbatch, and of the decode cache, and its
     ``cache_specs`` block of a dense decoder's KV cache), then runs the
     train step (with ``remat`` and the microbatches of
     :func:`microbatches_for`), the prefill or one decode step;
  4. records ``FlopCounterMode``'s FLOPs and the op trace of
     ``launch/op_analysis.py`` (FLOPs, bytes, collective bytes by kind and
     by group, dp or TP, arguments and the peak of temporaries);
  5. writes ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json`` with
     the JAX package's keys (``launch/roofline.py`` reads both) and
     ``collectives_by_group``.

The numbers are one rank's.  Each rank holds its dp block of the rows, as
the reference's chip does (``partitioning.batch_specs``, ``cache_specs``'
dp entry).  Every family computes its blocks over ``model``
(``partitioning.tp_layout``: heads, RWKV's WKV heads, Mamba's channels,
hidden units and vocabulary columns), whole heads only, so SmolLM's 9
heads, Hymba's 25 and Whisper's 12 stay whole on 16 ranks and a rank
does more attention work than the reference's chip.

The fake tensors claim the CUDA device and go through the card's path:
``kernels/ops.py`` sends them to the kernels' operators, whose fake
implementations give the outputs' shapes and launch nothing.  A PyTorch
built without CUDA cannot record autograd on a tensor that claims the CUDA
device (the autograd engine asks the CUDA runtime for streams), so there
the fake tensors claim the CPU; the ops are the same, since ``ops.py``
routes every fake tensor to the kernels' operators.

A shape refusal, a collective the mesh cannot run or an exception in the
step fails the cell -- a fault of the port, not of the dry run.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod-only | --single-pod-only]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import moe_balancer
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import make_context, make_production_mesh
from repro_torch.models import model, partitioning
from repro_torch.optim import adamw
from repro_torch.train import train_loop

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def cell_config(arch: str, shape: ShapeConfig) -> ModelConfig:
    cfg = get_config(arch)
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, remat=True)
    return cfg


def microbatches_for(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if shape.kind != "train":
        return 1
    return 8 if cfg.d_model >= 2048 else 1


def trace_device() -> torch.device:
    """The device the fake tensors claim: the card's, unless this PyTorch
    was built without CUDA (see the module's docstring)."""
    return torch.device("cuda" if torch.backends.cuda.is_built() else "cpu")


@contextlib.contextmanager
def fake_world(multi_pod: bool):
    """A fake process group of the production mesh's size, this process its
    rank 0, and a ``DeviceMesh`` over it with the mesh's axes; the group is
    torn down on exit."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        raise RuntimeError("a dry run starts its own process group; one is already running")
    shape = make_production_mesh(multi_pod=multi_pod)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape.sizes))
    try:
        # The mesh's devices are only ranks here; its tensors are fake and
        # claim trace_device().
        yield init_device_mesh("cpu", shape.sizes, mesh_dim_names=shape.axis_names)
    finally:
        dist.destroy_process_group()


def input_specs(arch: str, shape_name: str, *, device="meta", params=None) -> dict:
    """Stand-ins for every model input of the cell at its global shapes:
    tensors on ``device`` (``meta`` by default: shapes and dtypes, no
    memory), the decode cache from ``model.init_decode_cache`` (on
    ``params``' device; a model is built on ``device`` when none is given).
    :func:`lower_cell` takes each rank's rows of them."""
    shape = SHAPES[shape_name]
    cfg = cell_config(arch, shape)
    b, s = shape.global_batch, shape.seq_len
    dev = torch.device(device)

    def sds(shp, dt=torch.int32):
        return torch.empty(shp, dtype=dt, device=dev)

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": sds((b, s))}
        if shape.kind == "train":
            batch["labels"] = sds((b, s))
        if cfg.family == "audio":
            batch["frames"] = sds((b, cfg.encoder_seq, cfg.d_model), torch.float32)
        return {"batch": batch}
    # decode: one new token against a cache of seq_len.
    if params is None:
        params = model.Model(cfg, device=dev)
    return {
        "tokens": sds((b,)),
        "cache": model.init_decode_cache(params, cfg, b, s),
        "pos": s - 1,  # the last row: the step attends over the whole cache
    }


def fake_params(cfg: ModelConfig, ctx, dev) -> model.Model:
    """The parameters one rank holds (uninitialised), built under the
    caller's ``FakeTensorMode``: its TP and expert blocks of the leaves its
    layout splits, every other leaf whole."""
    return partitioning.take_blocks(model.Model(cfg, device=dev), cfg, ctx)


def fake_train_state(cfg: ModelConfig, ctx, dev) -> train_loop.TrainState:
    """The train state one rank holds, built under the caller's
    ``FakeTensorMode``: :func:`fake_params`, the ZeRO-1 blocks of the
    moments under a context, the balancer of a MoE model."""
    params = train_loop.trainable(fake_params(cfg, ctx, dev))
    specs = None
    if ctx is not None:
        specs = partitioning.moment_specs(params, cfg, ctx)
    bal = None
    if cfg.moe:
        bal = moe_balancer.BalancerState.init(
            model.num_scanned_layers(cfg), cfg.n_routed_experts, dev,
            dispatchers=() if ctx is None else (ctx.dp_size, ctx.tp_size))
    return train_loop.TrainState(
        params=params, opt=adamw.init(params, ctx, specs), balancer=bal,
        step=torch.zeros((), dtype=torch.int32, device=dev))


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool, sync_variant: bool = False,
               keep_ops: bool = False):
    """Trace one cell on this rank's rows; returns ``(trace, mesh_shape,
    cfg, scan_trips)``, ``trace`` the dict of :func:`trace_step`."""
    shape = SHAPES[shape_name]
    cfg = cell_config(arch, shape)
    mb = microbatches_for(cfg, shape)
    with fake_world(multi_pod) as mesh:
        ctx = make_context(mesh, cfg.n_routed_experts if cfg.moe else 0)
        ctx = ctx.for_batch(shape.global_batch, mb)
        from torch._subclasses.fake_tensor import FakeTensorMode

        # Tables the model builds from numpy (RoPE's frequencies) enter as
        # real CPU tensors and are made fake on the way in.
        with FakeTensorMode(allow_non_fake_inputs=True):
            dev = trace_device()
            if shape.kind == "train":
                state = fake_train_state(cfg, ctx, dev)
                batch = rank_rows(input_specs(arch, shape_name, device=dev)["batch"], ctx, mb)
                step = train_loop.make_train_step(
                    cfg, adamw.OptimConfig(), ctx, sync=sync_variant, microbatches=mb)
                args = (state, batch)

                def call():
                    return step(state, batch)
            elif shape.kind == "prefill":
                params = fake_params(cfg, ctx, dev)
                batch = rank_rows(input_specs(arch, shape_name, device=dev)["batch"], ctx)
                args = (params, batch)

                def call():
                    return model.prefill(params, batch, cfg, ctx, cache_len=shape.seq_len)
            else:
                params = fake_params(cfg, ctx, dev)
                spec = input_specs(arch, shape_name, device=dev, params=params)
                tokens = rank_rows({"tokens": spec["tokens"]}, ctx)["tokens"]
                cache = model.init_decode_cache(params, cfg, shape.global_batch, shape.seq_len,
                                                ctx)
                args = (params, tokens, cache)

                def call():
                    return model.decode_step(params, tokens, cache, spec["pos"], cfg, ctx)
            trace = trace_step(call, args, keep_ops=keep_ops, groups=rank_groups(ctx))
    return trace, make_production_mesh(multi_pod=multi_pod), cfg, [model.num_scanned_layers(cfg)]


def rank_groups(ctx) -> dict:
    """``{"dp": group, "tp": group}`` of a context, and ``"ep"`` where the
    EP group is neither, for the op recorder's collective bytes by group
    (the FSDP gathers of DeepSeek-V2's experts run over ``data``, the dp
    group of one pod)."""
    out = {"dp": ctx.group(ctx.dp_axes), "tp": ctx.group(ctx.tp_axis)}
    if ctx.ep_axes not in (ctx.dp_axes, (ctx.tp_axis,)):
        out["ep"] = ctx.group(ctx.ep_axes)
    return out


def rank_rows(batch: dict, ctx, microbatches: int = 1) -> dict:
    """``ctx.take_rows`` of a global batch, each leaf a tensor of its own
    (a view would hold the global batch's storage among the arguments)."""
    return {k: t.clone() for k, t in ctx.take_rows(batch, microbatches).items()}


def trace_step(call, arguments, *, keep_ops: bool = False, groups: dict | None = None) -> dict:
    """Run ``call()`` once under ``FlopCounterMode`` and the op recorder
    (``groups``: its process groups by name, :func:`rank_groups`).
    Returns ``{"flops": FlopCounterMode's total, "analysis": the op
    trace's dict, "output_bytes": new buffers in the result, "seconds",
    "rows": each op's charge (``OpRecorder.rows``; with ``keep_ops``),
    "kernel_calls": ``OpRecorder.kernel_calls``}``."""
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.perf_counter()
    arguments = _plain(arguments)
    with (FlopCounterMode(display=False) as fc,
          op_analysis.OpRecorder(arguments, keep_ops=keep_ops, groups=groups) as rec):
        out = call()
    seconds = time.perf_counter() - t0
    args = {op_analysis.storage_key(t) for t in op_analysis.tensors_of(arguments)}
    new = {op_analysis.storage_key(t): op_analysis.buffer_bytes(t)
           for t in op_analysis.tensors_of(_plain(out))
           if op_analysis.storage_key(t) not in args}
    return {"flops": float(fc.get_total_flops()), "analysis": rec.result(),
            "output_bytes": int(sum(new.values())), "seconds": seconds, "rows": rec.rows,
            "kernel_calls": rec.kernel_calls}


def _plain(tree):
    """Dataclass states (``TrainState``, ``OptState``, ``BalancerState``)
    as dicts, so their tensors can be listed."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _plain(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    if isinstance(tree, (list, tuple)):
        return [_plain(x) for x in tree]
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def cell_record(trace: dict, mesh, scan_trips) -> dict:
    """The fields of an ``ok`` record (the JAX package's keys) from a trace
    (:func:`trace_step`) on ``mesh`` (a ``parallel.MeshShape``)."""
    analysis = trace["analysis"]
    return dict(
        ok=True,
        lower_s=round(trace["seconds"], 2),
        compile_s=0.0,  # nothing is compiled: the step runs eagerly
        memory={
            "argument_size_in_bytes": int(analysis["argument_bytes"]),
            "output_size_in_bytes": trace["output_bytes"],
            "temp_size_in_bytes": int(analysis["peak_bytes"]),
            # No counterpart: the port's kernels are built once, not per cell.
            "generated_code_size_in_bytes": 0,
        },
        cost={"flops": trace["flops"], "bytes accessed": analysis["bytes"]},
        hlo_flops=analysis["flops"],
        hlo_bytes=analysis["bytes"],
        hlo_bytes_hbm=analysis["bytes_hbm"],
        hlo_bytes_hbm_v2=analysis["bytes_hbm_v2"],
        collectives=analysis["collectives"],
        collectives_by_group=analysis["collectives_by_group"],
        scan_trips=scan_trips,
        num_devices=math.prod(mesh.sizes),
        n_ops=analysis["n_ops"],
        trace_device=trace_device().type,
    )


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: Path,
             sync_variant: bool = False, force: bool = False) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{arch}__{shape_name}__{mesh_name}" + ("__sync" if sync_variant else "")
    out_path = out_dir / f"{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "sync_variant": sync_variant, "ok": False,
    }
    try:
        trace, mesh, _cfg, scan_trips = lower_cell(
            arch, shape_name, multi_pod=multi_pod, sync_variant=sync_variant
        )
        rec.update(cell_record(trace, mesh, scan_trips))
        print(
            f"[dryrun] OK  {tag}  lower={rec['lower_s']}s compile={rec['compile_s']}s "
            f"flops={rec['cost'].get('flops', 0):.3e}"
        )
    except Exception as e:  # noqa: BLE001 -- the record carries the failure
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] FAIL {tag}: {rec['error'][:200]}")
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--sync-variant", action="store_true")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    meshes = [False, True]
    if args.multi_pod_only:
        meshes = [True]
    if args.single_pod_only:
        meshes = [False]

    if args.all:
        todo = [(arch, shape_name) for arch, shape_name, _skip in cells()]
    else:
        todo = [(args.arch, args.shape)]

    n_ok = n_fail = 0
    for arch, shape_name in todo:
        for mp in meshes:
            rec = run_cell(
                arch, shape_name, multi_pod=mp, out_dir=out_dir,
                force=args.force, sync_variant=args.sync_variant,
            )
            n_ok += int(rec["ok"])
            n_fail += int(not rec["ok"])
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
