"""Quickstart: the paper's result in one run.

The counterpart of the JAX package's ``examples/quickstart.py``.  It runs
the paper's own simulation setting (Section 9: K=30 servers, load 0.95,
Geometric(1/K) services) and compares Join-the-Shortest-Approximated-Queue
under ET-x + MSR -- the paper's recommended sparse-communication design --
against the exact-state JSQ, SQ(2) and Round Robin baselines, on the *same*
arrival and size sample paths.

Cells are grouped by their static part (policy, comm and approximation
kinds): each group is one ``simulate_grid`` call, whose runs advance
together on one leading run axis, so the ET-x ladder is one call.  Every
cell runs on the slotted simulator's dense backend (geometric sizes).

Expected outcome (paper Figs 3/10/12): ET-3 + MSR matches SQ(2) while
using ~10% of JSQ's messages, and still beats Round Robin below 2%.

Usage (from the repository root; the card unless ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.examples.quickstart [--slots 100000]
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu --slots 2000
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.care import metrics, slotted_sim
from repro_torch.core.care.slotted_sim import SimConfig, exact_state_messages


def jct_stats(res) -> str:
    s = metrics.jct_summary(res.jct)  # zero-completion safe
    return f"mean={s['mean']:7.1f}  p50={s['p50']:6.0f}  p99={s['p99']:7.0f}"


def simulate_cells(cfgs, seed: int, device=None):
    """Run every cell, one ``simulate_grid`` call per static part.

    Returns one ``SimResult`` per config, in order, and the number of
    calls.  Cells sharing a ``StaticConfig`` (the ET-x ladder: x is a
    per-run operand) share one call.
    """
    groups: dict = {}
    for i, cfg in enumerate(cfgs):
        groups.setdefault(cfg.static_part(), []).append(i)
    results = [None] * len(cfgs)
    for static, idxs in groups.items():
        grid = slotted_sim.simulate_grid(
            [seed], static, [cfgs[i].scenario() for i in idxs], device=device
        )
        for i, cell in zip(idxs, grid):
            results[i] = cell[0]
    return results, len(groups)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=100_000)
    ap.add_argument("--load", type=float, default=0.95)
    ap.add_argument("--servers", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    base = dict(servers=args.servers, slots=args.slots, load=args.load)
    seed = 7  # same seed => same arrivals & job sizes for every policy

    policies = [
        ("JSQ (exact state)", SimConfig(policy="jsq", comm="none", **base)),
        ("SQ(2)", SimConfig(policy="sq2", comm="none", **base)),
        ("Round Robin", SimConfig(policy="rr", comm="none", **base)),
        ("JSAQ ET-2 + MSR", SimConfig(policy="jsaq", comm="et", x=2, approx="msr", **base)),
        ("JSAQ ET-3 + MSR", SimConfig(policy="jsaq", comm="et", x=3, approx="msr", **base)),
        ("JSAQ ET-5 + MSR", SimConfig(policy="jsaq", comm="et", x=5, approx="msr", **base)),
        ("JSAQ ET-8 + MSR", SimConfig(policy="jsaq", comm="et", x=8, approx="msr", **base)),
        ("JSAQ DT-3 + MSR-3", SimConfig(policy="jsaq", comm="dt", x=3, approx="msr_x", **base)),
    ]

    t0 = time.perf_counter()
    results, n_calls = simulate_cells([cfg for _, cfg in policies], seed, args.device)
    wall = time.perf_counter() - t0
    dev = torch.device(args.device) if args.device else torch.device("cuda")
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"K={args.servers} servers, load={args.load}, {args.slots} slots "
          f"(identical inputs per policy;\n{len(policies)} cells ran as {n_calls} "
          f"simulate_grid calls, one per static kind, on {where} in {wall:.1f} s)\n")
    print(f"{'policy':<20} {'JCT (slots)':<38} {'msgs/dep':>9} {'rel comm':>9} {'max AQ':>7}")
    jsq_msgs = None
    rows = []
    for (name, cfg), res in zip(policies, results):
        msgs = exact_state_messages(res, cfg.policy, cfg.sqd)
        if jsq_msgs is None:
            jsq_msgs = max(msgs, 1)
        rel = msgs / jsq_msgs
        rows.append(dict(name=name, policy=cfg.policy, comm=cfg.comm, x=cfg.x,
                         messages=msgs, rel_comm=rel, max_aq=res.max_aq, result=res))
        print(
            f"{name:<20} {jct_stats(res):<38} "
            f"{msgs / max(res.departures, 1):9.3f} {rel:9.2%} {res.max_aq:7d}"
        )
    print(
        "\nReading: ET-x + MSR holds the approximation error at <= x-1 "
        "(Thm 2.3) while the\nmessage rate decays quadratically in x "
        "(Thms 2.4/2.5) -- JSQ-like completion times\nat a few percent of "
        "the exact-state communication."
    )
    print("\nNext: python -m repro_torch.examples.serve_care    (CARE request dispatcher)"
          "\n      python -m repro_torch.examples.serve_stream  (steady-state serving soak)")
    return dict(rows=rows, calls=n_calls, wall_s=wall)


if __name__ == "__main__":
    main()
