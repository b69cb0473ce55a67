"""The port's roofline (``launch/roofline.py``) against the JAX package's.

On the same records and with the reference's peaks passed in (TPU v5e:
197e12 FLOP/s, 819e9 B/s, 50e9 B/s a link), every field of every cell
equals the reference's, ``dominant`` and the note included (the note's
last words name the tensor cores where the reference names the MXU).  The
defaults are one H100 SXM's published dense peaks (989e12 FLOP/s bf16,
3.35e12 B/s HBM, 450e9 B/s of NVLink each way), and ``full_table`` reads a
directory the port's dry run wrote.
"""
import dataclasses

import pytest

from repro.launch import roofline as jroof
from repro_torch.launch import dryrun, roofline

V5E = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)


def _rec(arch, shape, flops, hbm, coll, chips=256, **extra):
    return {"arch": arch, "shape": shape, "mesh": "pod16x16", "num_devices": chips,
            "hlo_flops": flops, "hlo_bytes_hbm_v2": hbm, "collectives": {"total": coll},
            "memory": {"temp_size_in_bytes": 12345}, "cost": {}, **extra}


RECORDS = [
    _rec("smollm-135m", "train_4k", 7.817e13, 1.303e13, 3.781e10),  # memory-bound
    _rec("qwen3-0.6b", "train_4k", 5.0e15, 1.0e12, 1.0e9),  # compute, low useful ratio
    _rec("gemma2-9b", "train_4k", 3.0e14, 1.0e12, 1.0e9),  # compute, high useful ratio
    _rec("deepseek-v2-236b", "decode_32k", 1.0e12, 8.0e11, 5.0e11, chips=512),  # collective
    _rec("rwkv6-1.6b", "decode_32k", 1.0e9, 1.0e11, 1.0e6),  # memory-bound decode
    {**_rec("hymba-1.5b", "prefill_32k", 0.0, 0.0, 2.0e9),
     "hlo_flops": None, "hlo_bytes_hbm_v2": None, "hlo_bytes": 4.0e12,
     "cost": {"flops": 9.0e14, "bytes accessed": 1.0}},  # fallbacks to older keys
]


@pytest.mark.parametrize("rec", RECORDS, ids=lambda r: f"{r['arch']}/{r['shape']}")
def test_cells_equal_the_reference_at_its_peaks(rec):
    n_active = 1_000_000_000
    got = dataclasses.asdict(roofline.cell_roofline(rec, n_active, **V5E))
    want = dataclasses.asdict(jroof.cell_roofline(rec, n_active))
    assert got.pop("note").replace("tensor-core", "MXU") == want.pop("note")
    assert got == want


def test_defaults_are_the_h100_peaks():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)
    rec = RECORDS[0]
    assert roofline.cell_roofline(rec, 10) == roofline.cell_roofline(
        rec, 10, peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)
    assert roofline.cell_roofline(rec, 10).compute_s == rec["hlo_flops"] / 989e12


def test_model_flops_and_markdown_match_the_reference():
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert roofline.model_flops_for("x", shape, 7) == jroof.model_flops_for("x", shape, 7)
    cells = [roofline.cell_roofline(r, 10**9, **V5E) for r in RECORDS]
    jcells = [jroof.cell_roofline(r, 10**9) for r in RECORDS]
    assert roofline.markdown_table(cells) == jroof.markdown_table(jcells)


def test_full_table_reads_the_port_dry_run(tmp_path):
    rec = dryrun.run_cell("smollm-135m", "decode_32k", multi_pod=False, out_dir=tmp_path)
    assert rec["ok"], rec.get("error")
    (tmp_path / "failed.json").write_text('{"ok": false}')  # skipped, as the reference does
    cells = roofline.full_table(tmp_path)
    assert [c.tag for c in cells] == ["smollm-135m__decode_32k__pod16x16"]
    assert cells[0] == roofline.cell_roofline(rec, roofline.active_params_table()["smollm-135m"])
    assert cells[0].compute_s == rec["hlo_flops"] / roofline.PEAK_FLOPS
