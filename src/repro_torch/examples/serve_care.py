"""Serve a model with batched requests through the CARE dispatcher.

The counterpart of the JAX package's ``examples/serve_care.py``: the
paper's own setting at the serving tier.  Requests are jobs, replica groups
are servers, and the front end routes each request by JSAQ over
*approximated* per-replica occupancy.  Replicas mirror the dispatcher's
emulation and send a correction only when the error reaches x (ET-x).

Three parts:

1. **Real decode**: a SmolLM model is prefilled on a batch of prompts and
   decoded greedily -- the port's ``model.prefill`` / ``model.decode_step``.
   On the card SmolLM-135M at its published widths (30 layers, d_model
   576, 9 heads / 3 KV heads of width 64, bf16; the prefill launches the
   ``flash_attention`` kernel once a layer), on the CPU the reduced config.
2. **Dispatch at scale**: the serving engine runs the regime ladder (exact
   / ET-x / DT-x / RT-r) and the policy suite (SQ(2) and round robin under
   ET, drain-time-aware JSAQ under 2:1 replica speeds), one ``serve_grid``
   call per static kind, thresholds and rate profiles as per-run operands;
   it compares the dispatchers on job completion time and messages per
   completion (paper Figs 8-12 at the systems tier).
3. **Golden replay**: the per-request ``CareDispatcher`` (the pluggable
   path, with a per-slot ``model_fn`` hook) replays the ET-4 cell through
   ``run_serving_sim`` and must give the grid's messages and JCT vector.

Usage (from the repository root; the card unless ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.examples.serve_care
  PYTHONPATH=src python -m repro_torch.examples.serve_care --device cpu --slots 1000
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import model
from repro_torch.serve import engine
from repro_torch.serve.engine import ServeConfig


def real_decode_demo(device, num_prompts: int = 4, prompt_len: int = 16,
                     gen_len: int = 12) -> dict:
    """Greedy batched generation through the port's model code path."""
    cfg = get_config("smollm-135m")
    if device.type != "cuda":
        cfg = cfg.reduced()
    params = model.init_params(torch.Generator(device=device).manual_seed(0), cfg, device)
    tokens = torch.randint(0, cfg.vocab_size, (num_prompts, prompt_len),
                           generator=torch.Generator(device=device).manual_seed(1),
                           device=device)
    cache_len = prompt_len + gen_len
    before = ops.launch_counts()["flash_attention"]
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens}, cfg, cache_len=cache_len)
    prefill_launches = ops.launch_counts()["flash_attention"] - before
    out = [torch.argmax(logits, dim=-1)]
    before = ops.launch_counts()["flash_attention"]
    for i in range(gen_len - 1):
        logits, cache = model.decode_step(params, out[-1], cache, prompt_len + i, cfg)
        out.append(torch.argmax(logits, dim=-1))
    decode_launches = ops.launch_counts()["flash_attention"] - before
    gen = torch.stack(out, dim=1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    assert gen.shape == (num_prompts, gen_len)
    assert bool(torch.isfinite(logits).all())
    print(f"[decode] generated {tuple(gen.shape)} tokens with batched greedy decode "
          f"({cfg.name}, {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_dtype}) in {wall:.2f} s; sample row: {gen[0, :8].tolist()}...")
    print(f"[decode] flash_attention launches: {prefill_launches} in the prefill, "
          f"{decode_launches} in {gen_len - 1} decode steps")
    return dict(tokens=gen.cpu(), prefill_launches=prefill_launches,
                decode_launches=decode_launches, layers=cfg.num_layers, wall_s=wall)


def dispatch_cells(slots: int, load: float) -> list:
    """The comparison's named cells."""
    # MSR drain = decode_slots / mean_work = 0.25: the emulation runs at the
    # nominal per-replica completion rate.
    work = dict(slots=slots, load=load, mean_prefill=4, mean_decode=60, msr_drain=0.25)
    hetero = (2.0, 2.0, 2.0, 2.0, 1.0, 1.0, 1.0, 1.0)  # 2:1 speeds
    return [
        ("exact", ServeConfig(comm="exact", **work)),
        ("ET-4 (CARE)", ServeConfig(comm="et", x=4, **work)),
        ("ET-8 (CARE)", ServeConfig(comm="et", x=8, **work)),
        ("DT-4", ServeConfig(comm="dt", x=4, **work)),
        ("RT-16", ServeConfig(comm="rt", rt_period=16, **work)),
        # The policy suite over the same ET trigger: SQ(2) and round robin
        # over CARE state, and the drain-time-aware router under 2:1
        # speeds.  The uniform RR control carries explicit all-ones rates,
        # so it shares the 2:1 cell's call (rates are per-run operands).
        ("ET-4 SQ(2)", ServeConfig(comm="et", x=4, policy="sqd", **work)),
        ("ET-4 RR", ServeConfig(comm="et", x=4, policy="rr", decode_rates=(1.0,) * 8, **work)),
        ("ET-4 RR 2:1", ServeConfig(comm="et", x=4, policy="rr", decode_rates=hetero, **work)),
        ("ET-4 drain 2:1",
         ServeConfig(comm="et", x=4, policy="drain", decode_rates=hetero, **work)),
    ]


def dispatch_comparison(slots: int, load: float, device) -> dict:
    print(f"\n[dispatch] {slots} slots at load {load}, 8 replica groups x 16 "
          f"decode slots (one serve_grid call per static kind)")
    named = dispatch_cells(slots, load)
    groups: dict = {}
    for i, (_, cell) in enumerate(named):
        groups.setdefault(cell.static_part(), []).append(i)
    results: dict = {}
    t0 = time.perf_counter()
    for static, idxs in groups.items():
        grid = engine.serve_grid([0], static, [named[i][1] for i in idxs], device=device)
        for i, row in zip(idxs, grid):
            results[i] = row[0]
    grid_s = time.perf_counter() - t0
    print(f"{len(named)} cells ran as {len(groups)} serve_grid calls "
          f"(thresholds and rates are per-run operands) in {grid_s:.1f} s")
    print(f"{'dispatcher':<14} {'mean JCT':>9} {'p99 JCT':>9} {'msgs/completion':>16}")
    for i, (name, _) in enumerate(named):
        r = results[i]
        print(f"{name:<14} {r.mean_jct:9.1f} {r.p99_jct:9.1f} "
              f"{r.msgs_per_completion:16.3f}")

    # The per-request dispatcher is the pluggable model_fn path and the
    # golden reference: replay the ET-4 cell through it, bit for bit.
    cell = named[1][1]
    t0 = time.perf_counter()
    ref = engine.run_serving_sim(
        cell.engine_config(), slots=cell.slots, load=cell.load,
        mean_prefill=cell.mean_prefill, mean_decode=cell.mean_decode,
        seed=0, workload=engine.workload_for(cell, 0), device=device,
    )
    replay_s = time.perf_counter() - t0
    grid_et4 = results[1]
    assert ref["messages"] == grid_et4.messages
    assert np.array_equal(ref["jct_by_rid"], grid_et4.jct_by_rid)
    print(f"\n[golden] CareDispatcher replay of ET-4: {ref['messages']} messages, "
          f"JCT vector bit-identical to the serve_grid run ({replay_s:.1f} s, "
          f"{ref['offered']} routed requests)")
    print("\nReading: the ET dispatcher matches the exact-state JCT "
          "distribution while replicas\nmessage the front-end only on "
          "emulation-error threshold crossings.")
    return dict(names=[n for n, _ in named], cells=[c for _, c in named],
                results=[results[i] for i in range(len(named))], calls=len(groups),
                grid_s=grid_s, replay=ref, replay_s=replay_s)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=20_000)
    ap.add_argument("--load", type=float, default=0.9)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = engine._resolve_device(args.device)
    decode = real_decode_demo(device)
    dispatch = dispatch_comparison(args.slots, args.load, device)
    return dict(decode=decode, dispatch=dispatch)


if __name__ == "__main__":
    main()
