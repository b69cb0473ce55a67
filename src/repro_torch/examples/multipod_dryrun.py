"""Trace one (arch x shape) cell on the 512-rank production mesh.

The counterpart of the JAX package's ``examples/multipod_dryrun.py``.
Shows the public launch API: start a fake process group of the production
mesh's size, build the parallel context, stand in fake tensors for every
parameter and input (no memory, no card), run the train / prefill / decode
step once through the card's path, and read back the memory, FLOPs and
collective bytes one rank of the port needs (``launch/dryrun.py``), at the
H100 peaks of ``launch/roofline.py``.

This is the "would it run on the cluster?" proof: a shape the kernels
refuse or a collective the mesh cannot run fails here, on a laptop, before
any card time is spent.

Usage (from the repository root):
  PYTHONPATH=src python -m repro_torch.examples.multipod_dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.examples.multipod_dryrun --arch deepseek-v2-236b --shape decode_32k
"""
from __future__ import annotations

import argparse

from repro_torch.launch import dryrun, model_stats, roofline

CLOSING = "traces cleanly; the sharding is coherent for this mesh."


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--single-pod", action="store_true",
                    help="16x16 (256 ranks) instead of 2x16x16 (512)")
    args = ap.parse_args(argv)

    multi_pod = not args.single_pod
    mesh_name = "2x16x16 (pod,data,model)" if multi_pod else "16x16 (data,model)"
    print(f"[dryrun] tracing {args.arch} / {args.shape} onto {mesh_name}")

    trace, mesh, cfg, scan_trips = dryrun.lower_cell(args.arch, args.shape, multi_pod=multi_pod)
    rec = {"arch": args.arch, "shape": args.shape, "mesh": mesh_name,
           **dryrun.cell_record(trace, mesh, scan_trips)}
    analysis = trace["analysis"]

    gib = 1 << 30
    print(f"  chips:                {rec['num_devices']}")
    print(f"  per-rank arguments:   {analysis['argument_bytes'] / gib:8.2f} GiB")
    print(f"  per-rank temporaries: {analysis['peak_bytes'] / gib:8.2f} GiB")
    print(f"  per-rank op flops:    {analysis['flops']:.3e}")
    print(f"  per-rank HBM bytes:   {analysis['bytes_hbm']:.3e}")
    coll = analysis["collectives"]
    print(f"  collective bytes/rank: {coll['total']:.3e}  "
          f"({', '.join(f'{k}={v:.2e}' for k, v in sorted(coll.items()) if k != 'total')})")
    for group, kinds in sorted(analysis["collectives_by_group"].items()):
        print(f"    over {group}: {kinds['total']:.3e}  ("
              + ", ".join(f"{k}={v:.2e}" for k, v in sorted(kinds.items()) if k != "total")
              + ")")
    print(f"  FlopCounterMode flops: {trace['flops']:.3e}  ({analysis['n_ops']} ops traced "
          f"in {trace['seconds']:.1f} s)")
    cell = roofline.cell_roofline(rec, model_stats.count_active_params(cfg))
    print(f"  roofline at H100 peaks: compute {cell.compute_s:.3e} s, memory "
          f"{cell.memory_s:.3e} s, collective {cell.collective_s:.3e} s ({cell.dominant})")
    print(f"\n  -> {CLOSING}")
    return {"trace": trace, "roofline": cell}


if __name__ == "__main__":
    main()
