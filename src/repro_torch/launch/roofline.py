"""Roofline terms from dry-run records, at one H100's peaks.

Port of ``repro/launch/roofline.py``.  Instead of a measured step time,
each (arch x shape x mesh) cell's three terms come from its dry-run record
(``launch/dryrun.py``):

    compute    = FLOPs_per_rank / peak_flops
    memory     = HBM_bytes_per_rank / hbm_bw
    collective = collective_bytes_per_rank / link_bw

The peaks are arguments of :func:`cell_roofline` and :func:`full_table`;
their defaults are one H100 SXM's published dense peaks: 989e12 FLOP/s in
bfloat16 on the tensor cores, 3.35e12 B/s of HBM and 450e9 B/s of NVLink
each way.  The collective term charges one rank's link with all its
collective bytes, the conservative estimate.

The records keep the JAX package's keys (``hlo_flops``,
``hlo_bytes_hbm_v2``, ``collectives``, ``memory.temp_size_in_bytes``,
``num_devices``, ...), so one :func:`full_table` reads the artifacts of
both packages.  In the port's records these keys hold the op trace's counts
(``launch/op_analysis.py``): what one rank of the port runs, per step.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

PEAK_FLOPS = 989e12  # bf16 dense, tensor cores, per card
HBM_BW = 3.35e12  # bytes/s per card
LINK_BW = 450e9  # bytes/s of NVLink, each way

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# Tokens processed per step, per shape (global).
_SHAPE_TOKENS = {
    "train_4k": 256 * 4096,
    "prefill_32k": 32 * 32768,
    "decode_32k": 128,  # one new token per sequence
    "long_500k": 1,
}
_TRAIN_SHAPES = {"train_4k"}


@dataclasses.dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float  # 6ND / 2ND (global)
    hlo_flops_chip: float
    useful_ratio: float  # model_flops / (hlo_flops_chip * chips)
    step_s: float  # max of the three terms
    mfu: float  # model_flops / (chips * peak * step_s)
    coll_bytes: float
    hbm_bytes: float
    temp_bytes: int
    note: str = ""
    tag: str = ""


def load_artifacts(pattern: str = "*.json", art_dir: Path | None = None) -> list[dict]:
    art_dir = art_dir or ARTIFACTS
    recs = []
    for p in sorted(Path(art_dir).glob(pattern)):
        rec = json.loads(p.read_text())
        if rec.get("ok"):
            recs.append(rec)
    return recs


def model_flops_for(arch: str, shape: str, n_active: int) -> float:
    tokens = _SHAPE_TOKENS.get(shape, 1)
    per_token = 6.0 if shape in _TRAIN_SHAPES else 2.0
    return per_token * n_active * tokens


def _note(c: "CellRoofline") -> str:
    if c.dominant == "collective":
        return (
            "collective-bound: reshard/weight gathers dominate; move the "
            "offending operand onto the mesh axis it is consumed on or "
            "overlap the gather with the preceding layer's compute"
        )
    if c.dominant == "memory":
        if "decode" in c.shape or "long" in c.shape:
            return (
                "memory-bound (expected for decode: weights+KV read per "
                "token); raise per-chip batch or shrink the KV working set "
                "(GQA/MLA already help) to amortise the weight stream"
            )
        return (
            "memory-bound: working set streams from HBM; fuse, widen the "
            "per-chip tile or raise arithmetic intensity (larger per-device "
            "batch) to move toward the compute roof"
        )
    if c.useful_ratio < 0.5:
        return (
            "compute-bound but low useful ratio: remat recompute and/or "
            "padding dominate FLOPs; relax the checkpoint policy or align "
            "tile shapes to reclaim headroom"
        )
    return (
        "compute-bound with high useful ratio: near the practical roof; "
        "remaining headroom is kernel efficiency (tensor-core utilisation)"
    )


def cell_roofline(rec: dict, n_active: int, *, peak_flops: float = PEAK_FLOPS,
                  hbm_bw: float = HBM_BW, link_bw: float = LINK_BW) -> CellRoofline:
    chips = rec["num_devices"]
    flops_chip = float(rec.get("hlo_flops") or rec["cost"].get("flops", 0.0))
    # Prefer the v2 estimate when present; fall back to the baseline metric
    # so old artifacts stay readable.
    bytes_chip = float(
        rec.get("hlo_bytes_hbm_v2")
        or rec.get("hlo_bytes_hbm")
        or rec.get("hlo_bytes")
        or rec["cost"].get("bytes accessed", 0.0)
    )
    coll = float(rec["collectives"].get("total", 0.0))
    terms = {
        "compute": flops_chip / peak_flops,
        "memory": bytes_chip / hbm_bw,
        "collective": coll / link_bw,
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops_for(rec["arch"], rec["shape"], n_active)
    step_s = max(terms.values())
    c = CellRoofline(
        arch=rec["arch"],
        shape=rec["shape"],
        mesh=rec["mesh"],
        chips=chips,
        compute_s=terms["compute"],
        memory_s=terms["memory"],
        collective_s=terms["collective"],
        dominant=dominant,
        model_flops=mf,
        hlo_flops_chip=flops_chip,
        useful_ratio=mf / max(flops_chip * chips, 1e-30),
        step_s=step_s,
        mfu=mf / (chips * peak_flops * max(step_s, 1e-30)),
        coll_bytes=coll,
        hbm_bytes=bytes_chip,
        temp_bytes=rec["memory"]["temp_size_in_bytes"],
        tag=f"{rec['arch']}__{rec['shape']}__{rec['mesh']}",
    )
    c.note = _note(c)
    return c


def active_params_table() -> dict[str, int]:
    """6ND 'N' per arch: total params for dense, active for MoE."""
    from repro_torch.configs import ARCH_IDS, get_config  # late: keeps module light
    from repro_torch.launch import model_stats

    return {arch: model_stats.count_active_params(get_config(arch)) for arch in ARCH_IDS}


def full_table(art_dir: Path | None = None, **peaks) -> list[CellRoofline]:
    """Every ``ok`` record of ``art_dir`` that is not a sync variant;
    ``peaks``: ``peak_flops``, ``hbm_bw``, ``link_bw`` (the H100's by
    default)."""
    n_active = active_params_table()
    return [cell_roofline(rec, n_active[rec["arch"]], **peaks)
            for rec in load_artifacts(art_dir=art_dir) if not rec.get("sync_variant")]


def markdown_table(cells: list[CellRoofline]) -> str:
    hdr = (
        "| cell | chips | compute (s) | memory (s) | collective (s) | "
        "dominant | useful 6ND/HLO | roofline MFU |\n"
        "|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for c in cells:
        lines.append(
            f"| {c.arch} / {c.shape} / {c.mesh} | {c.chips} "
            f"| {c.compute_s:.3e} | {c.memory_s:.3e} | {c.collective_s:.3e} "
            f"| **{c.dominant}** | {c.useful_ratio:.2f} | {c.mfu:.1%} |"
        )
    return hdr + "\n".join(lines)
