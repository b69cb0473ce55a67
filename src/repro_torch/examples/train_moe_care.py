"""End-to-end driver: train a MoE LM with the CARE expert balancer.

Port of ``examples/train_moe_care.py``, on the card unless ``--device
cpu``.  It runs the training substrate on a DeepSeek-V2-family model:

* data pipeline -> train step -> AdamW;
* the CARE balancer: a skewed gate is rebalanced by the JSAQ PI bias
  driven by the *approximated* expert load, with exact-count syncs fired
  sparsely by the ET trigger (the paper's server-side adaptive pattern);
* fault tolerance: an atomic checkpoint every ``--ckpt-every`` steps, a
  simulated crash at the midpoint, and a restore-and-resume.

The default config is the reduced DeepSeek-V2 family; ``--full-size``
takes the published one.

Usage:
  PYTHONPATH=src python -m repro_torch.examples.train_moe_care --steps 200
"""
import argparse
import dataclasses
import json
import shutil
import tempfile

import torch

from repro_torch.ckpt import checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import CareConfig
from repro_torch.core import moe_balancer
from repro_torch.core.care.slotted_sim import _resolve_device
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.kernels import ops
from repro_torch.optim import adamw
from repro_torch.train import train_loop

GATE_SKEW = 1.5


def build_state(cfg, dev, seed: int = 0):
    state = train_loop.init_state(torch.Generator(device=dev).manual_seed(seed), cfg,
                                  device=dev)
    # Inject a persistent expert skew -- the imbalance the balancer must fix.
    e = cfg.n_routed_experts
    mult = torch.ones((e,), dtype=torch.float32, device=dev)
    mult[0] += GATE_SKEW
    mult[1] += 0.7 * GATE_SKEW
    with torch.no_grad():
        for layer in state.params.layers:
            layer.moe.gate.mul_(mult[None, :])
    return state


def train(cfg, steps, ckpt_dir, dev, *, batch, seq, ckpt_every, crash_at=None):
    opt_cfg = adamw.OptimConfig(lr=3e-4, total_steps=steps, warmup_steps=10)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch)

    start = checkpoint.latest_step(ckpt_dir)
    if start is None:
        state, start = build_state(cfg, dev), 0
    else:
        state, start = checkpoint.restore(build_state(cfg, dev), ckpt_dir)
        print(f"  [restore] resumed from checkpoint at step {start}")

    loader = ShardedLoader(data_cfg, start_step=start)
    step_fn = train_loop.make_train_step(cfg, opt_cfg, None, sync=False)

    syncs, imb_first, imb_last = 0, None, None
    pending = False
    for step in range(start, steps):
        prev = state.balancer.true_counts
        state, metrics = step_fn(state, next(loader))
        counts = (state.balancer.true_counts - prev).cpu()
        imb = float((counts.max(-1).values / (counts.mean(-1) + 1e-9)).mean())
        imb_first = imb if imb_first is None else imb_first
        imb_last = imb
        if pending:  # ET trigger raised last step -> sync now (1-bit flag)
            state = dataclasses.replace(
                state, balancer=moe_balancer.sync(state.balancer, cfg.care))
            syncs += 1
        pending = bool(metrics["sync_trigger"])
        if (step + 1) % 25 == 0:
            print(f"  step {step+1:4d}  loss {float(metrics['loss']):.4f}  "
                  f"expert max/mean {imb:.2f}  syncs {syncs}")
        if (step + 1) % ckpt_every == 0:
            checkpoint.save(state, ckpt_dir, step + 1)
        if crash_at is not None and step + 1 == crash_at:
            print(f"  [crash] simulated failure at step {step+1}")
            return {"crashed": True, "imb_first": imb_first}
    return {"crashed": False, "imb_first": imb_first, "imb_last": imb_last,
            "syncs": syncs, "loss": float(metrics["loss"])}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--arch", default="deepseek-v2-236b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    args = ap.parse_args(argv)

    dev = _resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, care=CareConfig(enabled=True, comm="et", x=2), remat=False)

    ckpt_dir = tempfile.mkdtemp(prefix="care_moe_")
    try:
        crash = args.steps // 2
        print(f"[train] {cfg.name} on {dev}: {args.steps} steps, simulated crash at {crash}")
        r0 = train(cfg, args.steps, ckpt_dir, dev, batch=args.batch, seq=args.seq,
                   ckpt_every=args.ckpt_every, crash_at=crash)
        assert r0["crashed"], "expected the simulated crash"
        print("[train] relaunching after crash (restores latest checkpoint)")
        r = train(cfg, args.steps, ckpt_dir, dev, batch=args.batch, seq=args.seq,
                  ckpt_every=args.ckpt_every)
        print(f"\n[done] expert imbalance {r0['imb_first']:.2f} -> {r['imb_last']:.2f} "
              f"(1.0 = perfect) with {r['syncs']} balancer syncs over "
              f"{args.steps} steps; final loss {r['loss']:.4f}")
        if r["syncs"] == 0 and cfg.care.comm == "et":
            print("      (0 syncs is the expected ET outcome here: a single "
                  "in-process dispatcher\n       observes every arrival, so "
                  "its emulation error is exactly zero -- Remark 4.6.)")
        print(f"[launches] {json.dumps(ops.launch_counts())}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
