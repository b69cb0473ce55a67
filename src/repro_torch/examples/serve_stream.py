"""Soak a serving cell through the segment engine in bounded memory.

The counterpart of the JAX package's ``examples/serve_stream.py``.  The
paper's claims (asymptotically optimal JCT at sparse message rates) are
steady-state statements, so they want traces far past what the
fixed-horizon engine holds.  ``engine.serve_stream`` runs the same
dynamics chunk by chunk: the engine state resumes from chunk to chunk (on
the card one ``serve_slots`` launch a chunk, the fused backend), while the
host samples the next chunk's slab during the current one.  Memory is
O(chunk), not O(slots).

This runs a diurnal soak (the arrival rate modulated sinusoidally over a
simulated day) at high load, discards a warmup of 10% of the horizon, and
prints the steady-state JCT quantiles (from the log-bucket histogram) and
the long-run message rate.  ``--memory-probe`` first runs a soak 10 times
shorter under ``tracemalloc`` and prints both host peaks: a bounded engine
keeps them level.

Usage (from the repository root; the card unless ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.examples.serve_stream
  PYTHONPATH=src python -m repro_torch.examples.serve_stream --slots 10000000
  PYTHONPATH=src python -m repro_torch.examples.serve_stream --device cpu --slots 2000
"""
from __future__ import annotations

import argparse
import time
import tracemalloc

import torch

from repro_torch.serve import engine


def _soak(args, cell, slots: int):
    """One soak of ``slots`` slots; returns the result and its wall."""
    warmup = args.warmup if args.warmup is not None else slots // 10
    period = args.diurnal_period or max(slots // 4, 1)
    t0 = time.perf_counter()
    res = engine.serve_stream(
        args.seed, cell, chunk=args.chunk, warmup=warmup, slots=slots,
        diurnal_amp=args.diurnal_amp, diurnal_period=period, device=args.device,
    )
    if res.state.carry.q_len.is_cuda:
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0, warmup, period


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=1_000_000)
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--warmup", type=int, default=None,
                    help="slots discarded from the JCT accumulators "
                         "(default: 10%% of the horizon)")
    ap.add_argument("--load", type=float, default=0.95)
    ap.add_argument("--replicas", type=int, default=16)
    ap.add_argument("--comm", default="et")
    ap.add_argument("--x", type=float, default=4.0)
    ap.add_argument("--diurnal-amp", type=float, default=0.3)
    ap.add_argument("--diurnal-period", type=int, default=0,
                    help="slots per simulated day (default: horizon / 4)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--memory-probe", action="store_true",
                    help="first soak slots / 10 under tracemalloc, then the "
                         "soak itself, and print both host peaks")
    args = ap.parse_args(argv)

    cell = engine.ServeConfig(
        replicas=args.replicas, decode_slots=8, slots=args.slots, load=args.load,
        comm=args.comm, x=args.x, queue_cap=512, route_backend="fused",
        deterministic_ties=True,
    )
    out = {}
    if args.memory_probe:
        probe = max(args.slots // 10, 1)
        _soak(args, cell, 2 * args.chunk)  # build the kernel outside the traces
        tracemalloc.start()
        _soak(args, cell, probe)
        out["peak_probe_mb"] = tracemalloc.get_traced_memory()[1] / 2**20
        tracemalloc.reset_peak()
    res, wall, warmup, period = _soak(args, cell, args.slots)
    if args.memory_probe:
        out["peak_soak_mb"] = tracemalloc.get_traced_memory()[1] / 2**20
        tracemalloc.stop()
        # An O(horizon) leak would show as a ~10x peak.
        out["bounded_memory"] = out["peak_soak_mb"] <= 1.5 * out["peak_probe_mb"] + 32
    dev = res.state.carry.q_len.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[stream] {args.slots:,} slots on {where} (fused), chunk="
          f"{args.chunk}, warmup={warmup:,}, load={args.load}, comm={args.comm}-"
          f"{args.x:g}, diurnal amp={args.diurnal_amp} period={period:,}")
    s = res.jct_summary()
    print(f"[stream] done in {wall:.1f}s ({res.slots / wall:,.0f} slots/s)")
    print(f"  offered={res.offered:,} completed={res.completed:,} "
          f"dropped={res.dropped:,} net_drops={res.net_drops:,}")
    print(f"  steady-state JCT (n={s['count']:,}, warmup-discarded): "
          f"mean={s['mean']:.1f} p50={s['p50']:.0f} p90={s['p90']:.0f} "
          f"p99={s['p99']:.0f} p999={s['p999']:.0f} max={s['max']}")
    print(f"  messages={res.messages:,} ({res.msgs_per_slot:.3f}/slot, "
          f"{res.msgs_per_completion:.3f}/completion)")
    if args.memory_probe:
        print(f"  host peak (tracemalloc): probe of {max(args.slots // 10, 1):,} slots "
              f"{out['peak_probe_mb']:.2f} MB, soak {out['peak_soak_mb']:.2f} MB, "
              f"bounded {out['bounded_memory']}")
    out.update(result=res, wall_s=wall, summary=s)
    return out


if __name__ == "__main__":
    main()
