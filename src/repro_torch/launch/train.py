"""End-to-end training driver with fault tolerance and the CARE sync schedule.

Port of ``repro/launch/train.py``.  Flow:

  1. build (or restore) the ``TrainState``; the data stream seeks to the
     restored step;
  2. two step programs: ``step`` (no balancer sync) and ``step_sync``;
  3. per step the host picks one: DT-x fires every x steps, ET-x when the
     previous step's 1-bit trigger was set (the paper's server-side
     adaptive pattern: the full count sync happens only then);
  4. atomic checkpoints every ``--ckpt-every`` steps; ``--crash-at N``
     exits with code 42 after step N (and its checkpoint), and running the
     same command again resumes from the latest checkpoint;
  5. a ``StragglerMonitor`` consumes the per-step times.

With ``--mesh DATA,MODEL`` the run takes a parallel context
(``launch/mesh.py``) over the ranks of ``torchrun``'s environment (one
rank without it): NCCL on the card, gloo on the CPU.  Each rank steps on
its dp block of every step's global batch (contiguous rows of each
microbatch; the whole batch where they do not divide over dp), the step
sums the gradients over dp, a model of any family computes its heads,
channels, hidden units and vocabulary columns over the ``MODEL`` ranks of
the TP group (``partitioning.tp_layout``), each rank holds its block of
the routed experts, MoE layers exchange
tokens over the mesh and AdamW keeps ZeRO-1 blocks of the moments.  A
checkpoint holds whole leaves, gathered over TP and dp for rank 0 to
write; a run restores each rank's blocks of it.

Usage (the card unless ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/run1
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
      --arch deepseek-v2-236b --mesh 2,2 --batch 4 --seq 32
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \\
      --arch gemma2-9b --mesh 1,2 --batch 4 --seq 32
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
      --arch hymba-1.5b --mesh 1,4 --batch 4 --seq 32
"""
import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.ckpt import checkpoint
from repro_torch.configs import get_config
from repro_torch.core.care.slotted_sim import _resolve_device
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import adamw
from repro_torch.train import train_loop
from repro_torch.train.elastic import StragglerMonitor


def build(arch: str, *, reduced: bool, seq: int, batch: int, steps: int, lr: float):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    opt_cfg = adamw.OptimConfig(lr=lr, total_steps=steps,
                                warmup_steps=min(100, steps // 10 + 1))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch)
    return cfg, opt_cfg, data_cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (default: reduced smoke size)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="simulate a failure at this step (testing)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    ap.add_argument("--mesh", default="",
                    help="DATA,MODEL: train under a parallel context on this mesh")
    args = ap.parse_args(argv)

    cfg, opt_cfg, data_cfg = build(
        args.arch, reduced=not args.full_size, seq=args.seq,
        batch=args.batch, steps=args.steps, lr=args.lr,
    )
    dev = _resolve_device(args.device)
    ctx, started = None, False
    if args.mesh:
        started = mesh_lib.init_ranks(dev)
        shape = tuple(int(a) for a in args.mesh.split(","))
        ctx = mesh_lib.make_context(mesh_lib.make_debug_mesh(shape, dev),
                                    cfg.n_routed_experts if cfg.moe else 0)
    try:
        return _run(args, cfg, opt_cfg, data_cfg, dev, ctx)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, cfg, opt_cfg, data_cfg, dev, ctx):
    lead = ctx is None or dist.get_rank() == 0
    log = print if lead else (lambda *a, **k: None)

    def save(state, step):
        checkpoint.save(state, args.ckpt_dir, step, ctx=ctx)

    state = train_loop.init_state(torch.Generator(device=dev).manual_seed(0), cfg, ctx, device=dev)
    start_step = 0
    if args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir) is not None:
        state, start_step = checkpoint.restore(state, args.ckpt_dir, ctx=ctx)
        log(f"[train] restored checkpoint at step {start_step}")

    loader = ShardedLoader(data_cfg, start_step=start_step)  # the global batch
    if ctx is not None:
        ctx = ctx.for_batch(data_cfg.global_batch, args.microbatches)
    step_fn = train_loop.make_train_step(
        cfg, opt_cfg, ctx, sync=False, microbatches=args.microbatches)
    step_sync_fn = train_loop.make_train_step(
        cfg, opt_cfg, ctx, sync=True, microbatches=args.microbatches)

    monitor = StragglerMonitor(num_hosts=1)
    care = cfg.care
    pending_sync = False
    losses, step_s = [], []
    syncs = 0
    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = next(loader)
        if ctx is not None:
            batch = ctx.take_rows({k: torch.from_numpy(v) for k, v in batch.items()},
                                  args.microbatches)
        t0 = time.time()
        use_sync = cfg.moe and (
            pending_sync if care.comm == "et" else (step + 1) % care.x == 0
        )
        fn = step_sync_fn if use_sync else step_fn
        syncs += int(bool(use_sync))
        state, metrics = fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        pending_sync = bool(metrics["sync_trigger"])
        losses.append(loss)
        step_s.append(time.time() - t0)
        monitor.host_report(0, step_s[-1])

        if args.log_every and (step + 1) % args.log_every == 0:
            log(f"[train] step {step+1} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.2f}"
                  + (f" sync={use_sync}" if cfg.moe else ""))
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save(state, step + 1)
        if args.crash_at == step + 1:
            log(f"[train] simulated crash at step {step+1}")
            raise SystemExit(42)

    dt = time.time() - t_start
    n = args.steps - start_step
    log(f"[train] done: {n} steps in {dt:.1f}s "
          f"({dt/max(n,1)*1e3:.0f} ms/step), final loss {losses[-1]:.4f}, "
          f"first loss {losses[0]:.4f}"
          + (f", balancer syncs {syncs}/{n}" if cfg.moe else ""))
    if args.ckpt_dir:
        save(state, args.steps)
    return {"final_loss": losses[-1], "first_loss": losses[0], "syncs": syncs,
            "losses": losses, "step_s": step_s, "start_step": start_step}


if __name__ == "__main__":
    main()
