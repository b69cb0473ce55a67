"""The port's dry run (``launch/dryrun.py``) and its registry functions.

``cells()`` and ``get_shape`` equal the JAX package's; every cell's
``input_specs`` has the reference's leaves, shapes and dtypes (the decode
cache from ``init_decode_cache`` included; the reference's cache does not
read its context, so its specs are taken without a mesh).  One SmolLM-135M
cell of each kind and one MoE cell (DeepSeek-V2 decode) trace on the
256-rank mesh and write ``ok`` records that ``roofline.cell_roofline``
reads, with no kernel built or launched; a train record's collectives hold
the gradients' all-reduce over dp.  A rank of the 256-rank mesh (dp 16)
traces its 1/16 of the reduced SmolLM's step: its FLOPs are the same
rank's trace of the whole batch's over 16, below the one-device trace's
over 16 by the work its TP group divides.
"""
import dataclasses
import os

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import cells as jcells
from repro.configs import get_shape as jget_shape
from repro_torch.configs import cells, get_shape
from repro_torch.kernels import _build, ops
from repro_torch.launch import dryrun, model_stats, roofline
from repro_torch.launch.mesh import make_context, make_production_mesh
from repro_torch.models import model, partitioning
from repro_torch.models.parallel import ParallelContext
from repro_torch.optim import adamw
from repro_torch.train import train_loop


@pytest.fixture(scope="module")
def jdryrun():
    # The reference module sets XLA_FLAGS for 512 host devices when it is
    # imported; keep that from leaking into this process's environment.
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as module
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return module


def test_cells_and_shapes_equal_the_reference():
    assert cells() == jcells() and cells(True) == jcells(True)
    for _arch, shape, _skip in cells(True):
        assert get_shape(shape) == type(get_shape(shape))(**vars(jget_shape(shape)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in jcells()])
def test_input_specs_equal_the_reference(arch, shape, jdryrun):
    got = _leaves(dryrun.input_specs(arch, shape))
    want = _leaves(jdryrun.input_specs(arch, shape, None))
    assert sorted(got) == sorted(want)
    for name, spec in want.items():
        t = got[name]
        assert isinstance(spec, jax.ShapeDtypeStruct), name
        if name == "/pos":  # a traced int32 scalar there, a Python int in the port
            assert spec.shape == () and str(spec.dtype) == "int32"
            assert isinstance(t, int) and 0 <= t < dryrun.SHAPES[shape].seq_len
            continue
        assert tuple(t.shape) == spec.shape, name
        assert str(t.dtype).removeprefix("torch.") == str(spec.dtype), name


@pytest.fixture
def no_kernel(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a dry run built a kernel")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    ops.reset_launch_counts()
    yield
    assert not any(ops.launch_counts().values())


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


@pytest.mark.parametrize("arch,shape", [
    ("smollm-135m", "train_4k"), ("smollm-135m", "prefill_32k"),
    ("smollm-135m", "decode_32k"), ("deepseek-v2-236b", "decode_32k"),
])
def test_cell_writes_an_ok_record(arch, shape, tmp_path, no_kernel):
    rec = dryrun.run_cell(arch, shape, multi_pod=False, out_dir=tmp_path)
    assert rec["ok"], rec.get("traceback")
    assert (tmp_path / f"{arch}__{shape}__pod16x16.json").exists()
    assert rec["num_devices"] == 256 and rec["trace_device"] in ("cuda", "cpu")
    assert rec["hlo_flops"] == rec["cost"]["flops"] > 0  # op trace == FlopCounterMode
    assert rec["hlo_bytes"] >= rec["hlo_bytes_hbm"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0 and rec["memory"]["temp_size_in_bytes"] > 0
    if dryrun.SHAPES[shape].kind == "train":  # ZeRO-1: AdamW gathers each parameter
        assert rec["collectives"]["all-gather"] > 0
        # Each rank holds its rows: the step sums every (bf16) gradient it
        # holds (its TP blocks, every other leaf whole) over dp.
        cfg = dryrun.get_config(arch)
        split = partitioning.port_specs(
            [n for n, _ in model.Model(cfg, device="meta").named_parameters()],
            partitioning.local_specs(cfg, ParallelContext(mesh=make_production_mesh())))
        held = sum(t.numel() // (16 if n in split else 1)
                   for n, t in model.Model(cfg, device="meta").named_parameters())
        assert rec["collectives_by_group"]["dp"]["all-reduce"] >= 2 * held
    if arch.startswith("deepseek"):
        # A rank holds its blocks: MLA's heads, the shared experts, embed's
        # columns, 10 of the 160 experts' 1/16 of D (EP over model, FSDP
        # over data), and 1/256 of the compressed cache (rows over dp, the
        # sequence over TP); each multiplies only its experts' buffers.
        assert rec["memory"]["argument_size_in_bytes"] <= 6.5e9
        assert rec["hlo_flops"] <= 1.0e12
        cfg = dryrun.cell_config(arch, dryrun.SHAPES[shape])
        ctx = make_context(make_production_mesh(), cfg.n_routed_experts)
        b, s = dryrun.SHAPES[shape].global_batch, dryrun.SHAPES[shape].seq_len
        meta = model.Model(cfg, device="meta")
        rank = model.init_decode_cache(meta, cfg, b, s, ctx)
        assert rank.pop("kv_split") == "seq"
        whole = model.init_decode_cache(meta, cfg, b, s)
        assert _nbytes(rank) * 256 == _nbytes(whole)
    cell = roofline.cell_roofline(rec, model_stats.count_active_params(dryrun.get_config(arch)))
    assert cell.tag == f"{arch}__{shape}__pod16x16" and cell.step_s > 0
    assert not torch.distributed.is_initialized()


def test_main_runs_both_meshes(tmp_path, no_kernel):
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "smollm-135m__decode_32k__pod16x16.json", "smollm-135m__decode_32k__pod2x16x16.json"]
    rec = dryrun.run_cell("smollm-135m", "decode_32k", multi_pod=True, out_dir=tmp_path)
    assert rec["num_devices"] == 512  # read back, not traced again


def test_a_failed_cell_is_recorded(tmp_path, monkeypatch):
    def boom(*args, **kwargs):
        raise ValueError("refused")

    monkeypatch.setattr(dryrun.model, "decode_step", boom)
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--single-pod-only",
                        "--out", str(tmp_path)]) == 1
    rec = dryrun.run_cell("smollm-135m", "decode_32k", multi_pod=False, out_dir=tmp_path)
    assert not rec["ok"] and rec["error"] == "ValueError: refused" and "traceback" in rec
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("micro", [1, 2])
def test_a_rank_traces_its_share_of_the_batch(micro, no_kernel):
    """The reduced SmolLM's train step on a rank's rows of a 32 x 64 batch at
    the 256-rank mesh (dp 16, TP 16) counts 1/16 of the FLOPs of the same
    rank's trace of the whole batch (``ctx.with_whole_batch()``: its TP
    blocks, every row), within 0.1%, less than 1/16 of one device's trace
    of the whole batch (the FFN's hidden units and the vocabulary divide
    over TP; its 4 heads stay whole on 16 ranks), and all-reduces its
    gradients (float32 here) over dp only where it holds its rows."""
    cfg = dataclasses.replace(dryrun.get_config("smollm-135m").reduced(), remat=True)
    rows, seq = 32, 64

    def trace(ctx, groups=None):
        with FakeTensorMode(allow_non_fake_inputs=True):
            dev = dryrun.trace_device()
            state = dryrun.fake_train_state(cfg, ctx, dev)
            batch = {k: torch.empty((rows, seq), dtype=torch.int32, device=dev)
                     for k in ("tokens", "labels")}
            if ctx is not None and ctx.split:
                batch = dryrun.rank_rows(batch, ctx, micro)
                assert batch["tokens"].shape == (rows // 16, seq)
            step = train_loop.make_train_step(cfg, adamw.OptimConfig(), ctx, microbatches=micro)
            return dryrun.trace_step(lambda: step(state, batch), (state, batch), groups=groups)

    one = trace(None)
    with dryrun.fake_world(False) as mesh:
        ctx = make_context(mesh, 0).for_batch(rows, micro)
        assert ctx.split and ctx.dp_size == 16 and ctx.tp_size == 16
        rank = trace(ctx, dryrun.rank_groups(ctx))
        whole = trace(ctx.with_whole_batch(), dryrun.rank_groups(ctx))
    assert rank["flops"] == pytest.approx(whole["flops"] / 16, rel=1e-3)
    assert rank["flops"] < 0.9 * one["flops"] / 16
    assert one["analysis"]["collectives"]["total"] == 0
    assert "all-reduce" not in whole["analysis"]["collectives_by_group"]["dp"]
    by_group = rank["analysis"]["collectives_by_group"]
    held = sum(t.numel() for t in dryrun.fake_params(cfg, ctx, "meta").parameters())
    assert by_group["dp"]["all-reduce"] >= 4 * held
    assert by_group["tp"]["all-reduce"] > 0
