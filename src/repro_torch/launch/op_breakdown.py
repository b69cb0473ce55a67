"""Where do the roofline bytes come from?  Bytes and FLOPs by call path.

Counterpart of ``repro/launch/hlo_breakdown.py``: traces one cell
(``launch/dryrun.py``), charges each op as ``launch/op_analysis.py`` does,
and attributes the charges to the chain of the port's functions that ran
the op (the counterpart of an HLO computation: every layer's body under
one name, its op count standing for the loop's trips) and to the largest
single ops -- enough to decide what to optimise next without a card.

Usage:
  python -m repro_torch.launch.op_breakdown --arch rwkv6-1.6b --shape train_4k
"""
from __future__ import annotations

import argparse
from collections import defaultdict

from repro_torch.launch.roofline import HBM_BW


def breakdown(rows, top_comps: int = 6, top_instr: int = 6, hbm_bw: float = HBM_BW) -> str:
    """A report of ``rows`` (``OpRecorder.rows``: ``(bytes_hbm, flops, op,
    where)``): the total, the ``top_comps`` paths with the most bytes and,
    under each, its ``top_instr`` largest ops."""
    agg: dict[str, list[float]] = defaultdict(lambda: [0.0, 0.0, 0])
    detail: dict[str, list] = defaultdict(list)
    for b, flops, op, where in rows:
        ent = agg[where]
        ent[0] += b
        ent[1] += flops
        ent[2] += 1
        detail[where].append((b, flops, op))
    total = sum(v[0] for v in agg.values())
    total_flops = sum(v[1] for v in agg.values())
    out = [f"total bytes_hbm: {total:.3e}  ({total / hbm_bw:.2f}s at {hbm_bw / 1e12:.2f} TB/s)"
           f"  flops: {total_flops:.3e}"]
    for where, (b, flops, n) in sorted(agg.items(), key=lambda kv: -kv[1][0])[:top_comps]:
        out.append(f"\n== {where}  (ops={n}): {b:.3e}  [{b / max(total, 1e-30):.0%}]"
                   f"  flops {flops:.3e}")
        for ob, of, op in sorted(detail[where], key=lambda r: -r[0])[:top_instr]:
            out.append(f"   {ob:.2e} {of:.2e} {op}")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top-comps", type=int, default=6)
    ap.add_argument("--top-instr", type=int, default=6)
    args = ap.parse_args(argv)

    from repro_torch.launch import dryrun

    trace, _mesh, _cfg, _scan_trips = dryrun.lower_cell(
        args.arch, args.shape, multi_pod=args.multi_pod, keep_ops=True
    )
    print(breakdown(trace["rows"], args.top_comps, args.top_instr))


if __name__ == "__main__":
    main()
