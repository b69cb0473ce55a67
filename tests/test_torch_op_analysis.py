"""The op trace's roofline numerators (``launch/op_analysis.py``).

One test for each rule of ``tests/test_hlo_analysis.py``, on eager ops:
a matrix product's FLOPs; a loop of 12 products counted 12 times (the
reference's caller-hint case has no counterpart: an eager loop records
every trip, so ``scan_trips`` is unused); all-reduce bytes under a fake
process group; a per-step slice of an ``(S, ...)`` buffer charged as the
slice, not the buffer; an in-place slice update charged as the update; a
hand-written kernel charged its inputs and outputs; a gather charged its
result.  Then the model-level FLOPs of train, prefill and decode at the
reduced SmolLM-135M and DeepSeek-V2 configs (2 layers, one device) against
``hlo_analysis.analyze_module`` of the JAX package's own lowering.  The
tolerance is 2%; the measured gap is 0 for all six (every product and the
attention kernels' dense formula count what the reference's dots count),
so the test holds equality.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jget
from repro.launch import hlo_analysis
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.train import train_loop as jloop
from repro_torch.configs import get_config as tget
from repro_torch.core import moe_balancer
from repro_torch.kernels import ops
from repro_torch.launch import op_analysis
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_loop as tloop


def _record(fn, *args):
    with op_analysis.OpRecorder(args) as rec:
        fn(*args)
    return rec.result()


def test_simple_matmul():
    res = _record(torch.matmul, torch.ones(128, 256), torch.ones(256, 512))
    assert res["flops"] == 2 * 128 * 512 * 256


def test_loop_of_matmuls_counts_each_trip():
    def loop(x, y):
        for _ in range(12):
            x = x @ y
        return x

    res = _record(loop, torch.ones(64, 64), torch.ones(64, 64))
    assert res["flops"] == 12 * 2 * 64 * 64 * 64


def test_all_reduce_bytes_under_a_fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        res = _record(dist.all_reduce, torch.ones(1024))
    finally:
        dist.destroy_process_group()
    assert res["collectives"]["all-reduce"] == 1024 * 4
    assert res["collectives"]["total"] == 1024 * 4


def test_per_step_slice_charges_the_slice_not_the_buffer():
    def scan(buf):
        for i in range(buf.shape[0]):
            buf[i].clone()

    res = _record(scan, torch.ones(4096, 128))
    # per trip: read the slice, write its copy; the view itself is free.
    assert res["bytes_hbm"] == 4096 * 128 * 4 * 2
    # The raw metric keeps the conservative full-buffer accounting.
    assert res["bytes"] > res["bytes_hbm"] * 100


def test_inplace_slice_update_charges_the_update():
    def update(cache, rows, u, idx):
        cache[:, 7:8] = u  # a KV-cache row: a view, then copy_
        rows[idx] = u[:, 0]  # index_put_

    res = _record(update, torch.zeros(2, 4096, 128), torch.zeros(4096, 128),
                  torch.ones(2, 1, 128), torch.tensor([3, 9]))
    # each: read the update, write it (the views are free).
    assert res["bytes_hbm"] == 2 * (2 * 128 * 4) + 2 * (2 * 128 * 4)


def test_kernel_charges_inputs_and_outputs():
    with FakeTensorMode():
        q = torch.empty(2, 256, 8, 64, dtype=torch.bfloat16)
        k = torch.empty(2, 256, 2, 64, dtype=torch.bfloat16)
        res = _record(lambda: ops.flash_attention(q, k, k, scale=0.125))
        logits, bias = torch.empty(512, 160), torch.empty(160)
        route = _record(lambda: ops.moe_route(logits, bias, 6))
    qb, kb = 2 * 256 * 8 * 64 * 2, 2 * 256 * 2 * 64 * 2
    assert res["bytes_hbm"] == qb + 2 * kb + qb  # q, k, v in; out
    assert res["flops"] == 2 * 2 * 8 * 256 * 256 * (64 + 64)
    want = 512 * 160 * 4 + 160 * 4 + 512 * 6 * (4 + 4 + 4) + 160 * 4
    assert route["bytes_hbm"] == want and route["flops"] == 0


def test_gather_charges_its_result():
    with FakeTensorMode():
        table, idx = torch.empty(50000, 512), torch.zeros(64, dtype=torch.long)
        res = _record(lambda: table[idx])
        sel = _record(lambda: torch.index_select(table, 0, idx))
    assert res["bytes_hbm"] == sel["bytes_hbm"] == 2 * 64 * 512 * 4


def test_peak_counts_temporaries_until_their_last_reference():
    def step(x):
        a = x * 2  # 4 KB
        b = a + 1  # 4 KB, a still alive
        del a
        return b * 3  # 4 KB, b alive until the end

    res = _record(step, torch.ones(1024))
    assert res["argument_bytes"] == 4096
    assert res["peak_bytes"] == 2 * 4096


B, S = 2, 64


def _ref_flops(arch: str, kind: str) -> float:
    cfg = jget(arch).reduced()
    if kind == "train":
        cfg = dataclasses.replace(cfg, remat=True)
    i32 = jnp.int32
    if kind == "train":
        state = jax.eval_shape(lambda key: jloop.init_state(key, cfg), jax.random.key(0))
        batch = {"tokens": jax.ShapeDtypeStruct((B, S), i32),
                 "labels": jax.ShapeDtypeStruct((B, S), i32)}
        lowered = jax.jit(jloop.make_train_step(cfg, jadamw.OptimConfig())).lower(state, batch)
    else:
        params = jax.eval_shape(lambda key: jmodel.init_params(key, cfg), jax.random.key(0))
        if kind == "prefill":
            lowered = jax.jit(lambda p, b: jmodel.prefill(p, b, cfg, None, cache_len=S)).lower(
                params, {"tokens": jax.ShapeDtypeStruct((B, S), i32)})
        else:
            cache = jax.eval_shape(lambda: jmodel.init_decode_cache(None, cfg, B, S, None))
            lowered = jax.jit(
                lambda p, t, c, pos: jmodel.decode_step(p, t, c, pos, cfg, None)
            ).lower(params, jax.ShapeDtypeStruct((B,), i32), cache,
                    jax.ShapeDtypeStruct((), i32))
    hlo = lowered.compile().as_text()
    return hlo_analysis.analyze_module(hlo, [jmodel.num_scanned_layers(cfg)])["flops"]


def _port_flops(arch: str, kind: str) -> float:
    cfg = tget(arch).reduced()
    if kind == "train":
        cfg = dataclasses.replace(cfg, remat=True)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = tmodel.Model(cfg, device="cpu").requires_grad_(kind == "train")
        tokens = torch.zeros((B, S), dtype=torch.int32)
        if kind == "train":
            bal = (moe_balancer.BalancerState.init(tmodel.num_scanned_layers(cfg),
                                                   cfg.n_routed_experts, "cpu")
                   if cfg.moe else None)
            state = tloop.TrainState(params=params, opt=tadamw.init(params), balancer=bal,
                                     step=torch.zeros((), dtype=torch.int32))
            step = tloop.make_train_step(cfg, tadamw.OptimConfig())
            res = _record(lambda: step(state, {"tokens": tokens, "labels": tokens}))
        elif kind == "prefill":
            res = _record(lambda: tmodel.prefill(params, {"tokens": tokens}, cfg, cache_len=S))
        else:
            cache = tmodel.init_decode_cache(params, cfg, B, S)
            res = _record(lambda: tmodel.decode_step(
                params, torch.zeros((B,), dtype=torch.int32), cache, S - 1, cfg))
    return res["flops"]


# Measured gap (port / reference - 1) per kind: 0 for each of the six.
@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-236b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_equal_the_reference_lowering(arch, kind):
    assert _port_flops(arch, kind) == _ref_flops(arch, kind)
