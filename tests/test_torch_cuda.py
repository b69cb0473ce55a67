"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports nothing of JAX, so that it runs on the machine with the
card: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.  Every
output is an integer, a bool or a float32 sum of whole ``+1.0`` steps, and
must be equal, except ``moe_route``'s combine weights: within rtol 1e-5 /
atol 1e-6 of the plain version (the JAX package's own tolerance for its
router kernel), since the softmax sums run in another order, and
``flash_attention``'s output: within 2e-5 in float32 (the CUDA-core
kernel) and 2e-2 in bfloat16 (the tensor-core kernel;
``tests/test_flash_kernel.py``'s tolerances), since its dot products and
row sums run in another order, and its log-sum-exp within
``FLASH_LSE_TOL`` (1e-4) of ``ref.flash_attention_lse_ref``, +inf on the
same rows; the reduced hybrid, attention-free and
encoder-decoder models' logits and caches, card against CPU in float32,
within 1e-4 (cuBLAS and the kernel sum in other orders); and stream-mode ``serve_slots``' float32
running mean and m2, within 1e-6 / 2e-5 relative of the dense stream on
the CPU (``STREAM_MEAN_RTOL``, ``STREAM_M2_RTOL``), since each slot's
squared deviations are summed in the kernel's order.  The per-request
dispatcher and ``dispatch_sim`` launch no kernel; they are held card ==
CPU on the same workload or draws, every field equal.  The two backward
kernels of training: ``flash_attention``'s dq, dk and dv against
``ref.flash_attention_bwd_ref`` within ``FLASH_BWD_TOL`` of the largest
of the three: 1e-4 in float32, 2e-2 in bfloat16, whose reference rounds p
and the products to bfloat16 where the kernel sums in float32 (and rounds
dS to bfloat16 for its tensor-core products), two calls equal bit for bit; and
``moe_route``'s logits gradient against ``ref.moe_route_weights_vjp_ref``
within atol 1e-6 / rtol 1e-5 (softmax sums in another order); a train
step on the card against the same step on the CPU (float32, reduced
configs), every float within 1e-4 of its leaf's largest magnitude and the
routed counts equal (``train_step_card_vs_cpu``).  The four kernels as
``torch.library`` operators: on fake copies of the inputs each gives
outputs of its real launch's shapes, dtypes and strides and launches
nothing, a real CUDA tensor launches once a call, and the refusals still
raise (``TestKernelOperators``).  The TP families' split arithmetic at
published width, bf16, the ranks simulated in one process
(``TestTPBlocksOnCard``; ``chip_smoke.py`` phase 10 runs the same helpers
at 2 x 2048 tokens): RWKV6's and Mamba's blocks summed within
``TP_BLOCKS_TOL`` (1e-2) of the largest magnitude of the whole layer's,
Whisper's attention on a rank's heads equal to the whole call's bit for
bit.  Where there is no card, each test skips with a reason.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import dispatch_sim
from repro_torch.core.care import slotted_sim
from repro_torch.kernels import jsaq_route as tcuda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import model as tmodel
from repro_torch.serve import engine as serve_engine

POLICIES = ["jsq", "jsaq"]
KINDS = ["rt", "dt", "et", "et_rt", "exact", "none"]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# serve_slots against the dense backend (its plain version), here and in
# chip_smoke.py's phase 2: name -> (ServeConfig fields over SLOTS_BASE, the
# two runs' horizons or None).  R in {1, 8, 31, 32, 33, 200, 1024, 1025,
# 2048}; the six push kinds; decode rates; rem and arid in shared memory
# and, at 2048 replicas x 16 decode slots ("device_memory"), in device
# scratch; rings of 2 that drop ("drops"); horizons 0, 1 and mixed.
SLOTS_BASE = dict(
    replicas=64, decode_slots=4, slots=120, load=0.9, x=2, rt_period=5,
    mean_prefill=2, mean_decode=8, msr_drain=0.5, queue_cap=16,
    deterministic_ties=True, route_backend="fused",
)
SLOTS_CASES = {
    "r1_none": (dict(replicas=1, comm="none", load=0.5), None),
    "r8_drops_exact": (dict(replicas=8, decode_slots=1, queue_cap=2, load=2.0,
                            comm="exact"), None),
    "r31_horizons_0_1": (dict(replicas=31, comm="et"), (0, 1)),
    "r32_mixed_horizons_dt": (dict(replicas=32, comm="dt"), (120, 57)),
    "r33_rt_rates": (dict(replicas=33, comm="rt",
                          decode_rates=tuple(0.5 + (i % 4) * 0.5 for i in range(33))), None),
    "r200_et_rt_rates": (dict(replicas=200, comm="et_rt", load=0.5,
                              decode_rates=tuple(1.0 + (i % 3) * 0.5 for i in range(200))), None),
    "r1024_et_shared_memory": (dict(replicas=1024, decode_slots=16, load=0.1, slots=80,
                                    comm="et"), None),
    "r1025_exact": (dict(replicas=1025, load=0.3, mean_decode=30, comm="exact"), None),
    "r2048_dt_device_memory": (dict(replicas=2048, decode_slots=16, load=0.05, slots=60,
                                    comm="dt"), None),
}


I32_MAX = 2**31 - 1
# jsaq_route's cases: here against its plain version on the card, in
# tests/test_torch_jsaq_schedule.py for the level fill's CPU mirror, and
# (JSAQ_CARD) in chip_smoke.py's phase 2.  JSAQ_CASES cover negatives, ties,
# staircases (the most rounds), K = 1, N = 0, N much larger than K and rows
# whose fill reaches INT32_MAX, so that server 0 wraps and takes the rest.
JSAQ_CASES = ("random_with_negatives", "all_ties", "staircase_i", "staircase_2i",
              "one_far_below", "k1", "n0", "n_much_larger_than_k", "ties_in_levels",
              "smoke_row", "reaches_int32_max", "int32_max_below_fill", "int32_extremes",
              "fill_ends_on_a_level")
# At chip_smoke.py's JSAQ_SHAPE (D, K, N) = (64, 1000, 256) with an all-ties
# row; a staircase batch of that shape; the wide shape; a work space too
# large for shared memory (device scratch); D = 16, K = 1e5 with a work
# space just under and just over what H100 lets a block opt in to.
JSAQ_CARD = ("smoke_shape", "staircase_batch", "wide", "scratch", "smem_limit_below",
             "smem_limit_above")


def jsaq_case(case: str) -> tuple[np.ndarray, int]:
    """(D, K) int32 rows and N of a jsaq_route case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "random_with_negatives":
        q, n = rng.integers(-40, 40, (6, 200)), 96
    elif case == "all_ties":
        q, n = np.full((3, 130), -7), 300
    elif case == "staircase_i":
        q, n = np.tile(np.arange(300), (2, 1)), 256
    elif case == "staircase_2i":
        q, n = np.tile(2 * np.arange(150), (2, 1)), 200
    elif case == "one_far_below":
        q, n = np.full((2, 64), 500), 520
        q[:, 37] = 0
    elif case == "k1":
        q, n = rng.integers(-5, 5, (4, 1)), 50
    elif case == "n0":
        q, n = rng.integers(0, 9, (3, 20)), 0
    elif case == "n_much_larger_than_k":
        q, n = rng.integers(0, 20, (3, 5)), 900
    elif case == "ties_in_levels":
        q, n = rng.integers(0, 4, (5, 90)) * 3, 128
    elif case == "smoke_row":  # JSAQ_SHAPE's rows, cut to D = 4
        q, n = rng.integers(0, 50, (4, 1000)), 256
    elif case == "reaches_int32_max":  # every server reaches INT32_MAX, then 0 wraps
        q, n = I32_MAX - rng.integers(0, 4, (3, 12)), 40
        q[1] = I32_MAX
    elif case == "int32_max_below_fill":  # a server at INT32_MAX the fill never reaches
        q, n = rng.integers(0, 10, (2, 40)), 64
        q[:, 5] = I32_MAX
    elif case == "int32_extremes":
        q, n = rng.integers(-(2**31), 2**31, (3, 16)), 30
        q[:, :6] = I32_MAX - rng.integers(0, 3, (3, 6))
    elif case == "fill_ends_on_a_level":  # rem = 0; in row 1 a server starts at L
        q, n = np.array([[0, 0, 1, 5, 5], [3, 1, 1, 2, 9]]), 5
    elif case == "smoke_shape":
        q, n = rng.integers(0, 50, (64, 1000)), 256
        q[0] = 7
    elif case == "staircase_batch":  # rising and falling staircases, 23 rounds a row
        i = np.arange(1000)
        q, n = np.stack([(i if r % 2 == 0 else 999 - i) + r for r in range(64)]), 256
    elif case == "wide":
        q, n = rng.integers(0, 50, (16, 100_000)), 4096
    elif case == "scratch":  # 3 N + 3 rounds ints a row: past any shared memory
        q, n = np.tile(np.arange(50), (4, 1)), 20_000
    elif case in ("smem_limit_below", "smem_limit_above"):  # 230,340 and 236,364 bytes
        q, n = rng.integers(0, 50, (16, 100_000)), 19_000 if case.endswith("below") else 19_500
    else:
        raise KeyError(case)
    return q.astype(np.int32), n


def slots_vs_dense(dev, static, cell, horizons=None, seeds=(0, 1)):
    """serve_slots (the fused backend on the card) against the dense
    backend on the same inputs, every output of ``_serve_core``, with one
    ``serve_slots`` launch and no ``serve_route`` launch.  Returns the
    kernel's outputs, the ``_serve_core`` arguments and the dense
    backend's seconds; fails on any difference."""
    args = serve_engine._core_args(
        *serve_engine._grid_runs(list(seeds), static, [cell]), dev)
    if horizons is not None:
        hz = torch.tensor(horizons, dtype=torch.int32, device=dev)
        args = args._replace(scn=dataclasses.replace(args.scn, horizon=hz),
                             t_end=min(args.static.slots, max(max(horizons), 0)))
    tops.reset_launch_counts()
    fused = serve_engine._serve_core(*args)
    torch.cuda.synchronize()
    counts = tops.launch_counts()
    assert counts["serve_slots"] == 1 and counts["serve_route"] == 0, counts
    t0 = time.perf_counter()
    dense = serve_engine._serve_core(
        *args._replace(static=dataclasses.replace(args.static, route_backend="dense")))
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    assert fused.keys() == dense.keys()
    for key, want in dense.items():
        if want is None:
            assert fused[key] is None, key
        else:
            _eq(fused[key].cpu().numpy(), want.cpu().numpy())
    return fused, args, dense_s


# serve_slots in stream mode: each SLOTS_CASES run cut into uneven chunks
# (a chunk of 1 slot, one of 17, one of 39, then the rest, each resuming
# the carry the last one left), with the warmup gate at slot 10 in run 0.
# The float32 accumulators mean and m2 sum each slot's squared deviations
# in the kernel's order (a thread's decode slots, a warp's tree, the warps
# in order), not PyTorch's: they are held within STREAM_MEAN_RTOL and
# STREAM_M2_RTOL of the CPU; every other carry field is equal.
STREAM_CUTS = (1, 18, 57)
STREAM_WARMUP = (10, 0)
STREAM_MEAN_RTOL = 1e-6
STREAM_M2_RTOL = 2e-5
# A degraded cell of tests/test_serve_engine.py's STREAM_MATRIX (crash
# faults with suspect masking under ET+RT), dense on the card and the CPU.
STREAM_DEGRADED = dict(replicas=6, decode_slots=4, slots=400, load=0.9, queue_cap=256,
                       policy="jsaq", comm="et_rt", fault="crash", crash_rate=0.02,
                       recover_rate=0.2, suspect_age=10)


def stream_carry_equal(got, want, label: str = "") -> None:
    """Two stream carries (any devices): every field equal, the float
    accumulators within the stream tolerances."""
    def leaves(x, path):
        if x is None:
            return []
        if torch.is_tensor(x):
            return [(path, x.cpu())]
        if dataclasses.is_dataclass(x):
            return [leaf for f in dataclasses.fields(x)
                    for leaf in leaves(getattr(x, f.name), f"{path}.{f.name}")]
        return [leaf for i, v in enumerate(x) for leaf in leaves(v, f"{path}[{i}]")]

    a, b = leaves(got, "carry"), leaves(want, "carry")
    assert [p for p, _ in a] == [p for p, _ in b], label
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, f"{label} {path}"
        if path.endswith(("comp_slot.mean", "comp_slot.m2")):
            rtol = STREAM_MEAN_RTOL if path.endswith("mean") else STREAM_M2_RTOL
            tol = rtol * y.double().abs().clamp_min(1.0)
            assert bool(((x.double() - y.double()).abs() <= tol).all()), (
                f"{label} {path}: {x.tolist()} vs {y.tolist()}")
        else:
            _eq(x.numpy(), y.numpy())


def stream_vs_dense(dev, cell, horizons=None, seeds=(0, 1), cuts=STREAM_CUTS):
    """serve_slots in stream mode on the card (the fused backend, one launch
    a chunk) against the dense stream on the CPU, the slots of ``cell``'s
    runs cut at ``cuts`` and each chunk resuming the last one's carry.
    Returns the card's carry, its launches and the CPU's seconds; fails on
    any difference beyond the stream tolerances."""
    wls, runs, static, _ = serve_engine._grid_runs(list(seeds), cell.static_part(), [cell])
    static = dataclasses.replace(static, stream=True, trace_occupancy=False)
    carries, launches, cpu_s = [], 0, 0.0
    for where, backend in ((dev, "fused"), (torch.device("cpu"), "dense")):
        args = serve_engine._core_args(wls, runs, static, 0, where)
        d = args.work.shape[1]
        hz = horizons if horizons is not None else (cell.slots,) * d
        scn = dataclasses.replace(
            args.scn, horizon=torch.tensor(hz, dtype=torch.int32, device=where),
            warmup=torch.tensor(STREAM_WARMUP[:d], dtype=torch.int32, device=where))
        t_end = min(static.slots, max(max(hz), 0))
        st = dataclasses.replace(static, route_backend=backend)
        carry = serve_engine._engine_init(st, 0, d, where)
        bounds = sorted({0, t_end, *(c for c in cuts if 0 < c < t_end)})
        tops.reset_launch_counts()
        t0 = time.perf_counter()
        for c0, c1 in zip(bounds[:-1], bounds[1:]):
            sl = slice(c0, c1)
            carry = serve_engine._serve_core(
                args.n_arr[sl], args.work[sl], args.tie_u[sl], args.rid[sl],
                args.sub_u[sl], scn, st, 0, c1 - c0, args.live_lanes[sl], None,
                carry, c0)
        if where.type == "cuda":
            torch.cuda.synchronize()
            counts = tops.launch_counts()
            launches = counts["serve_slots"]
            assert launches == len(bounds) - 1 and counts["serve_route"] == 0, counts
        else:
            cpu_s = time.perf_counter() - t0
        carries.append(carry)
    stream_carry_equal(carries[0], carries[1], cell.comm)
    return carries[0], launches, cpu_s


# The slotted tier's policies and workloads on the dense backend: name ->
# SimConfig fields over POLICY_BASE, one static kind each; the card run
# equals the CPU run on the same draws.
_HALF_A = tuple([True] * 20 + [False] * 10)
_HALF_B = tuple([False] * 10 + [True] * 20)
_RATES = tuple([1.5] * 15 + [0.5] * 15)
POLICY_BASE = dict(servers=30, slots=300, load=0.9, mean_service=30, x=3,
                   rt_rate=0.02, policy="jsaq", comm="et", approx="msr")
POLICY_CASES = {
    "sq2": dict(policy="sq2", comm="none"),
    "sqd3": dict(policy="sqd", sqd=3, comm="dt"),
    "random": dict(policy="random", comm="none"),
    "jiq": dict(policy="jiq", comm="jiq"),
    "hsq": dict(policy="hsq", comm="hsq"),
    "hsq_lowest_index_ties": dict(policy="hsq", comm="hsq", deterministic_ties=True),
    "mmpp": dict(arrival="mmpp", burst_intensity=1.7, load=0.55),
    "mmpp_diurnal_sq2": dict(policy="sq2", comm="none", arrival="mmpp",
                             burst_intensity=1.7, load=0.5, diurnal_amp=0.1,
                             diurnal_period=100),
    "pareto": dict(service="pareto", service_tail=1.5),
    "weibull": dict(service="weibull", service_tail=0.5),
    "rates_rate_aware": dict(service_rates=_RATES),
    "rates_jsq_not_rate_aware": dict(service_rates=_RATES, rate_aware=False,
                                     policy="jsq", comm="exact"),
    "one_constrained_class": dict(class_mix=(1.0,), class_affinity=(_HALF_A,)),
    "classes_random": dict(policy="random", comm="none", class_mix=(0.5, 0.5),
                           class_affinity=(_HALF_A, _HALF_B)),
    "classes_jiq_rates": dict(policy="jiq", comm="jiq", service_rates=_RATES,
                              class_mix=(0.3, 0.7), class_affinity=(_HALF_A, _HALF_B)),
}


# The degraded control plane on the dense backend (fire-and-forget and ack
# wires, crash and slow faults, SQ(2)'s stale queries, JIQ's tokens on the
# wire): name -> SimConfig fields over POLICY_BASE.
_NET = dict(network="net", net_delay=2, net_jitter=1, net_drop=0.2)
_ACK = dict(transport="ack", ack_timeout=5, backoff_base=2.0, max_retries=4,
            ka_period=16, suspect_age=24)
DEGRADED_CASES = {
    "net_care": _NET,
    "net_sq2_stale": dict(policy="sq2", comm="rt", rt_rate=1e-3, network="net",
                          net_delay=4),
    "ack_care": dict(**_NET, **_ACK),
    "ack_jiq": dict(policy="jiq", comm="jiq", **_NET, **_ACK),
    "crash": dict(fault="crash", crash_rate=0.005, recover_rate=0.1, suspect_age=20),
    "slow_rates": dict(fault="slow", crash_rate=0.01, recover_rate=0.1,
                       slow_factor=0.5, service_rates=_RATES),
    "net_crash_jsq": dict(policy="jsq", comm="et", network="net", net_delay=6,
                          fault="crash", crash_rate=0.005, recover_rate=0.1,
                          suspect_age=16),
    "ack_crash_hsq": dict(policy="hsq", comm="hsq", **_NET, **_ACK, fault="crash",
                          crash_rate=0.005, recover_rate=0.1),
}
# The serving tier's control plane and pull policies on the dense backend:
# name -> ServeConfig fields over SERVE_DEGRADED_BASE.
SERVE_DEGRADED_BASE = dict(replicas=8, decode_slots=4, slots=300, load=0.9, x=3,
                           rt_period=16, mean_prefill=2, mean_decode=12,
                           queue_cap=128)
SERVE_DEGRADED_CASES = {
    "jiq": dict(policy="jiq", comm="jiq"),
    "hsq": dict(policy="hsq", comm="hsq", x=4),
    "net_sqd": dict(policy="sqd", sqd=3, network="net", net_delay=3, net_drop=0.1,
                    suspect_age=8),
    "crash_rr": dict(policy="rr", fault="crash", crash_rate=0.02, recover_rate=0.2,
                     suspect_age=6),
    "slow_drain": dict(policy="drain", decode_rates=(1.0, 0.5) * 4, fault="slow",
                       crash_rate=0.05, recover_rate=0.2, slow_factor=0.5),
    "ack_crash_et_rt": dict(comm="et_rt", network="net", net_delay=3, net_drop=0.15,
                            transport="ack", ack_timeout=4, backoff_base=1.5,
                            max_retries=2, ka_period=8, suspect_age=10,
                            fault="crash", crash_rate=0.02, recover_rate=0.2),
    "ack_jiq": dict(policy="jiq", comm="jiq", network="net", net_delay=2,
                    net_drop=0.2, transport="ack", ack_timeout=5, backoff_base=2.0,
                    max_retries=6),
}


def fused_vs_dense(dev, static, scn, seeds=(0, 1)) -> dict:
    """The slotted fused backend (one ``care_route`` launch) against the
    dense one on the same draws, decision for decision: every output of
    ``run_draws`` but the JCT's ``comp_slot`` equal.  Returns the dense
    outputs."""
    arrive, sizes, _ = slotted_sim.draw_workload(list(seeds), static, [scn], dev)
    dense = slotted_sim.run_draws(arrive, sizes, static, scn)
    before = tops.launch_counts()["care_route"]
    fused = slotted_sim.run_draws(
        arrive, None, dataclasses.replace(static, route_backend="fused"), scn)
    assert tops.launch_counts()["care_route"] == before + (arrive.is_cuda)
    for name, value in dense.items():
        if name != "comp_slot":
            assert torch.equal(value.int(), fused[name].int()), name
    assert int((dense["routed"] >= 0).sum()) > 0
    return dense


# MMPP arrivals under a diurnal curve, which the fused backend takes as the
# reference's pallas backend does: (StaticConfig fields, Scenario.create
# arguments) of the fused == dense case here and in chip_smoke.py phase 4.
MMPP_FUSED = (
    dict(servers=200, slots=2000, policy="jsaq", comm="dt", approx="msr",
         buffer_cap=16, service="deterministic", deterministic_ties=True,
         arrival="mmpp"),
    dict(load=0.55, x=3, mean_service=8, service="deterministic", horizon=2000,
         burst_intensity=1.7, diurnal_amp=0.05, diurnal_period=500, arrival="mmpp"),
)


def same_results(got, want, label: str) -> None:
    """Every ``SimResult`` field equal."""
    for f in dataclasses.fields(slotted_sim.SimResult):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b), f"{label} {f.name}"
        else:
            assert a == b, f"{label} {f.name}: {a} != {b}"


def grid_vs_cpu(dev, seeds, static, cells, raw_on_card=False):
    """One ``simulate_grid`` call on the card against ``run_draws`` on the
    CPU on the same draws (drawn again on the card, then moved): every
    ``SimResult`` field equal.  Returns the card's results, its seconds,
    the CPU's seconds, and the CPU's draws and ``run_draws`` outputs; with
    ``raw_on_card``, ``run_draws`` also runs on the card's draws and every
    one of its outputs must equal the CPU's, and those are returned."""
    seeds, cells = list(seeds), list(cells)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = slotted_sim.simulate_grid(seeds, static, cells, device=dev)
    card_s = time.perf_counter() - t0
    arrive, sizes, draws = slotted_sim.draw_workload(seeds, static, cells, dev)
    arrive = arrive.cpu()
    sizes = None if sizes is None else sizes.cpu()
    draws = {name: v.cpu() for name, v in draws.items()}
    runs = [scn for scn in cells for _ in seeds]
    t0 = time.perf_counter()
    raw = slotted_sim.run_draws(arrive, sizes, static, runs, **draws)
    cpu_s = time.perf_counter() - t0
    cpu = slotted_sim.results(arrive, raw)
    for c, row in enumerate(grid):
        for i, r in enumerate(row):
            same_results(r, cpu[c * len(seeds) + i], f"cell {c} seed {seeds[i]}")
    if raw_on_card:
        card_draws = slotted_sim.draw_workload(seeds, static, cells, dev)
        card_raw = slotted_sim.run_draws(*card_draws[:2], static, runs, **card_draws[2])
        for name, value in raw.items():
            _eq(card_raw[name].cpu().numpy(), value.numpy())
        raw = {name: value.cpu() for name, value in card_raw.items()}
    return grid, card_s, cpu_s, draws, raw


# The per-request dispatcher (CareDispatcher / run_serving_sim) on the card
# against the CPU, here and in chip_smoke.py's phase 3c: examples/serve_care's
# cell (8 replicas x 16 decode slots, load 0.9, mean prefill 4 and decode 60,
# MSR drain 0.25, ET-4) under the policies and control planes named here.
DISPATCH_BASE = dict(replicas=8, decode_slots=16, load=0.9, mean_prefill=4,
                     mean_decode=60, msr_drain=0.25, comm="et", x=4)
_HETERO_21 = (2.0,) * 4 + (1.0,) * 4
DISPATCH_CELLS = {
    "et4": dict(),
    "sqd": dict(policy="sqd"),
    "rr_21": dict(policy="rr", decode_rates=_HETERO_21),
    "drain_21": dict(policy="drain", decode_rates=_HETERO_21),
    "jiq": dict(policy="jiq", comm="jiq"),
    "hsq": dict(policy="hsq", comm="hsq"),
    "ack": dict(network="net", net_delay=2, net_jitter=1, net_drop=0.1, transport="ack",
                ack_timeout=8, backoff_base=2.0, max_retries=6, suspect_age=8),
    "crash": dict(fault="crash", crash_rate=0.005, recover_rate=0.1, suspect_age=20),
}


def dispatch_cell(name: str, slots: int):
    """The ``ServeConfig`` of ``DISPATCH_CELLS[name]`` over ``DISPATCH_BASE``."""
    return serve_engine.ServeConfig(**{**DISPATCH_BASE, **DISPATCH_CELLS[name]}, slots=slots)


# The fields a dispatcher run shares with a ServeResult of serve_one.
DISPATCH_VS_SERVE = ("jct_by_rid", "messages", "final_occupancy", "net_drops", "retrans",
                     "token_misses", "token_sum")


def _sim_args(cell, seed: int) -> dict:
    return dict(slots=cell.slots, load=cell.load, mean_prefill=cell.mean_prefill,
                mean_decode=cell.mean_decode, seed=seed,
                workload=serve_engine.workload_for(cell, seed))


def dispatcher_card_vs_cpu(dev, cell, seed: int = 0):
    """``run_serving_sim`` of ``cell`` on the card against the CPU on the
    same workload: every returned field equal.  Returns the card's output
    and both walls in seconds."""
    args = _sim_args(cell, seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = serve_engine.run_serving_sim(cell.engine_config(), device=dev, **args)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = serve_engine.run_serving_sim(cell.engine_config(), device="cpu", **args)
    cpu_s = time.perf_counter() - t0
    for name, value in cpu.items():
        if name == "requests":
            assert [(r.rid, r.started, r.finished) for r in card[name]] == \
                [(r.rid, r.started, r.finished) for r in value], name
        elif name == "occupancy":
            assert card[name].keys() == value.keys()
            for slot, occ in value.items():
                _eq(card[name][slot], occ)
        else:
            _eq(card[name], value)
    return card, card_s, cpu_s


def dispatcher_vs_serve_one(dev, cell, got: dict, seed: int = 0):
    """A dispatcher run against ``serve_one`` of the same cell on the card,
    on the same workload (the cell must drop nothing): the JCT vector, the
    messages, the final occupancy and the control counters equal.  Returns
    ``serve_one``'s result and wall in seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = serve_engine.serve_one(seed, cell, workload=serve_engine.workload_for(cell, seed),
                                 device=dev)
    serve_s = time.perf_counter() - t0
    assert res.dropped == 0
    for name in DISPATCH_VS_SERVE:
        _eq(got[name], getattr(res, name))
    return res, serve_s


# dispatch_sim on the card against the CPU on the card's draws (drawn on the
# card, then moved), here at a small width and in chip_smoke.py's phase 3c at
# bench_moe_balance's section B.
DISPATCH_SIM_SMALL = dict(experts=16, dispatchers=3, tokens_per_step=32, top_k=4,
                          steps=120, comm="et", x=2)


def dispatch_sim_card_vs_cpu(dev, cfg, seeds):
    """``dispatch_batch`` of ``seeds`` on the card, and ``run_draws`` on the
    CPU on the same draws: every output equal.  Returns the card's results
    and both walls in seconds."""
    seeds = list(seeds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = dispatch_sim.dispatch_batch(seeds, cfg, device=dev)
    card_s = time.perf_counter() - t0
    base, draws = dispatch_sim.sample_draws(seeds, cfg, dev)
    t0 = time.perf_counter()
    raw = dispatch_sim.run_draws(base.cpu(), ((w.cpu(), n.cpu()) for w, n in draws), cfg)
    cpu_s = time.perf_counter() - t0
    for got, want in zip(card, dispatch_sim.results(raw, cfg)):
        for f in dataclasses.fields(dispatch_sim.DispatchSimResult):
            np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name),
                                          err_msg=f.name)
    return card, card_s, cpu_s


def _moe_equal(got, logits, bias, k: int, gate_fn: str) -> None:
    """The router's four outputs against the plain versions: ids, counts
    and positions equal, weights within rtol 1e-5 / atol 1e-6."""
    idx, weights, counts = tref.moe_route_ref(logits, bias, k, gate_fn)
    _eq(got[0].cpu().numpy(), idx.cpu().numpy())
    _eq(got[2].cpu().numpy(), counts.cpu().numpy())
    _eq(got[3].cpu().numpy(), tref.moe_positions_ref(idx, logits.shape[1]).cpu().numpy())
    np.testing.assert_allclose(got[1].cpu().numpy(), weights.cpu().numpy(), rtol=1e-5, atol=1e-6)


# The forward kernel's cases (b, s, t, h, kvh, dh, dv, dtype, options): the
# output and, with return_lse, each row's log-sum-exp against the plain versions.
FLASH_FWD_CASES = [
    (2, 128, 128, 4, 4, 64, 64, torch.float32, dict(causal=True)),
    (2, 128, 256, 4, 4, 64, 64, torch.bfloat16, dict(causal=True)),
    (1, 128, 256, 4, 2, 32, 32, torch.float32, dict(causal=True)),  # GQA 2
    (1, 128, 256, 4, 1, 32, 32, torch.float32, dict(causal=True)),  # GQA 4
    (1, 256, 256, 9, 3, 64, 64, torch.bfloat16, dict(causal=True)),  # GQA 3
    (1, 256, 256, 2, 2, 64, 64, torch.float32, dict(causal=True, window=100)),
    (1, 128, 128, 2, 2, 64, 64, torch.float32, dict(causal=True, softcap=50.0)),
    (1, 128, 256, 2, 2, 64, 128, torch.float32, dict(causal=False)),
    (1, 200, 200, 4, 2, 256, 256, torch.bfloat16,
     dict(causal=True, window=37, softcap=50.0)),
    (1, 200, 200, 4, 2, 256, 256, torch.float32, dict(causal=True, window=1 << 30)),
    (2, 1, 300, 4, 2, 128, 128, torch.bfloat16, dict(causal=False)),
    # queries past T + window have no key: the dense softmax averages all keys
    (1, 300, 100, 2, 1, 64, 64, torch.float32, dict(causal=True, window=20)),
    (1, 77, 45, 3, 3, 4, 8, torch.float32, dict(causal=True)),
    # float32 at the model's widths off the 64 x 32 tiles, and dh 4 with GQA 3
    (1, 333, 517, 4, 2, 256, 256, torch.float32,
     dict(causal=True, window=100, softcap=50.0)),
    (1, 77, 45, 6, 2, 4, 8, torch.float32, dict(causal=True)),
    # bfloat16 (the tensor-core kernel): ragged S and T off the 128 x 64 tiles
    (1, 77, 45, 3, 3, 64, 128, torch.bfloat16, dict(causal=True)),
    (1, 45, 77, 2, 1, 128, 64, torch.bfloat16, dict(causal=False, softcap=50.0)),
    (2, 200, 200, 4, 2, 128, 128, torch.bfloat16,
     dict(causal=True, window=37, softcap=50.0)),
    (1, 130, 127, 2, 2, 64, 64, torch.bfloat16, dict(causal=True, window=66)),
    # S = 1 against a long T: one query row of a 128-row block
    (2, 1, 4000, 4, 2, 256, 256, torch.bfloat16, dict(causal=False, softcap=50.0)),
    (1, 1, 4000, 4, 1, 128, 128, torch.bfloat16, dict(causal=True)),
    (1, 1, 1, 16, 8, 256, 256, torch.bfloat16, dict(causal=True)),
    # bfloat16 rows past T + window have no key and average all keys
    (1, 300, 100, 2, 1, 64, 64, torch.bfloat16, dict(causal=True, window=20)),
    (1, 200, 163, 2, 2, 256, 256, torch.bfloat16, dict(causal=True, window=37)),
    (1, 256, 256, 2, 2, 256, 256, torch.bfloat16, dict(causal=True, window=2**31 - 1)),
    # Hymba: GQA group 5 (25 heads over 5), dh 64, window 1024 and
    # global (its 2**30), ragged S = T = 1100 past the window
    (1, 1100, 1100, 25, 5, 64, 64, torch.bfloat16, dict(causal=True, window=1024)),
    (1, 1100, 1100, 25, 5, 64, 64, torch.bfloat16, dict(causal=True, window=1 << 30)),
    (1, 1100, 1100, 25, 5, 64, 64, torch.float32, dict(causal=True, window=1024)),
    (1, 1100, 1100, 25, 5, 64, 64, torch.float32, dict(causal=True)),
    # Whisper: the encoder, S = T = 1500 non-causal at 12 heads, and
    # the cross-attention of 432 decoder rows against its 1500 frames
    (2, 1500, 1500, 12, 12, 64, 64, torch.bfloat16, dict(causal=False)),
    (1, 1500, 1500, 12, 12, 64, 64, torch.float32, dict(causal=False)),
    (2, 432, 1500, 12, 12, 64, 64, torch.bfloat16, dict(causal=False)),
    (1, 432, 1500, 12, 12, 64, 64, torch.float32, dict(causal=False)),
]
# The forward's log-sum-exp against ref.flash_attention_lse_ref: within 1e-4
# absolute (float32 scores summed in another order; in bfloat16 exp2 and the
# softcap's tanh by ex2.approx / rcp.approx, ~5e-7 softcap a score), +inf on
# exactly the rows with no key.
FLASH_LSE_TOL = 1e-4


# The backward kernels' cases, here and in chip_smoke.py's phase 9: name ->
# (B, S, T, H, KVH, dh, dv, dtype, options).  SmolLM-135M's training shape
# at B = 1; Gemma2's dh 256 with its window and softcap, and a window that
# masks; Hymba's GQA group of 5 with its local window; Whisper's encoder
# and cross-attention (non-causal, S != T); float32; odd float32 widths;
# S = 1; rows with no key (causal, S > T - 1 + window); dh 128 with a window
# and ragged tiles (S = T = 1100, GQA 4).
FLASH_BWD_CASES = {
    "smollm_path": (1, 2048, 2048, 9, 3, 64, 64, "bfloat16", dict(causal=True)),
    "gemma2_dh256": (1, 1024, 1024, 16, 8, 256, 256, "bfloat16",
                     dict(causal=True, window=4096, softcap=50.0)),
    "gemma2_window_masks": (1, 600, 600, 4, 2, 256, 256, "bfloat16",
                            dict(causal=True, window=100, softcap=50.0)),
    "hymba_gqa5_local": (1, 1536, 1536, 25, 5, 64, 64, "bfloat16",
                         dict(causal=True, window=1024)),
    "whisper_encoder": (1, 1500, 1500, 12, 12, 64, 64, "bfloat16", dict(causal=False)),
    "whisper_cross": (2, 432, 1500, 12, 12, 64, 64, "bfloat16", dict(causal=False)),
    "float32": (2, 512, 512, 9, 3, 64, 64, "float32", dict(causal=True)),
    "float32_window_softcap": (1, 300, 300, 4, 2, 256, 256, "float32",
                               dict(causal=True, window=100, softcap=50.0)),
    "float32_odd_widths": (2, 200, 160, 4, 2, 36, 44, "float32", dict(causal=False)),
    "s1": (2, 1, 64, 4, 2, 64, 64, "float32", dict(causal=True)),
    "s1_bf16": (3, 1, 70, 4, 4, 128, 128, "bfloat16", dict(causal=False)),
    "rows_with_no_key": (2, 300, 100, 4, 2, 64, 64, "float32", dict(causal=True, window=50)),
    "rows_with_no_key_bf16": (1, 300, 100, 4, 2, 64, 64, "bfloat16",
                              dict(causal=True, window=50)),
    "dh128_window_ragged": (2, 1100, 1100, 8, 2, 128, 128, "bfloat16",
                            dict(causal=True, window=512)),
}
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def flash_bwd_inputs(case: str, dev, seed: int = 0):
    """``(q, k, v, dout, kw)`` of a case on ``dev``, from a seeded
    generator; ``kw`` holds the scale and the options."""
    b, s, t, h, kvh, dh, dv, dtype, kw = FLASH_BWD_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    return (rnd(b, s, h, dh), rnd(b, t, kvh, dh), rnd(b, t, kvh, dv), rnd(b, s, h, dv),
            dict(scale=dh ** -0.5, **kw))


def flash_bwd_vs_plain(q, k, v, dout, kw) -> float:
    """``flash_attention_bwd_cuda`` after the forward kernel against
    ``ref.flash_attention_bwd_ref`` on the same card tensors; returns the
    largest error over the three gradients relative to the largest
    magnitude of the three, and fails past ``FLASH_BWD_TOL``.  (Relative to
    the call's, not each gradient's own: a query that sees one key has p =
    1 and a dq of exactly 0 in the reference, but of rounding noise, the
    difference of two equal dot products, in the kernel.)"""
    from repro_torch.kernels import flash_attn

    out, lse = flash_attn.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    got = flash_attn.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    want = tref.flash_attention_bwd_ref(q, k, v, dout, **kw)
    scale = max(max(float(w.float().abs().max()) for w in want), 1e-30)
    err = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        e = float((g.float() - w.float()).abs().max()) / scale
        assert e <= FLASH_BWD_TOL[q.dtype], (name, e, tuple(q.shape), kw)
        err = max(err, e)
    return err


def flash_bwd_repeat_equal(q, k, v, dout, kw) -> None:
    """Two ``flash_attention_bwd_cuda`` calls on the same inputs give the
    same bits (no atomics)."""
    from repro_torch.kernels import flash_attn

    out, lse = flash_attn.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    first = flash_attn.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    second = flash_attn.flash_attention_bwd_cuda(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


# name -> (T, E, k, gate, inputs): DeepSeek-V2's prefill shape and V3's
# (sigmoid gates), a training microbatch of 16,384 tokens, one token, E not
# a multiple of 4 (67: 4-byte access), E < 4, k = E (more slots than a
# token's lanes; at E 256 past 48 KB of shared memory), and inputs "randn"
# (seeded logits, the forward kernel's route), "ties" (all-tied logits),
# "dup" (a route made by hand that names experts twice and three times) or
# "unaligned" (the logits 4 bytes past a 16-byte boundary: 4-byte access
# at E 160).
MOE_BWD_CASES = {
    "deepseek_v2": (2048, 160, 6, "softmax", "randn"),
    "deepseek_v3": (2048, 256, 8, "sigmoid", "randn"),
    "long": (16384, 160, 6, "softmax", "randn"),
    "t1": (1, 160, 6, "softmax", "randn"),
    "all_ties": (64, 160, 6, "softmax", "ties"),
    "all_ties_sigmoid": (64, 256, 8, "sigmoid", "ties"),
    "e_tail": (1000, 67, 5, "sigmoid", "randn"),
    "e_small": (37, 3, 3, "softmax", "randn"),
    "dup_slots": (1000, 160, 6, "softmax", "dup"),
    "dup_slots_sigmoid": (999, 256, 8, "sigmoid", "dup"),
    "unaligned": (500, 160, 6, "softmax", "unaligned"),
    "k_all": (64, 256, 256, "softmax", "randn"),
    "k_all_sigmoid": (50, 67, 67, "sigmoid", "randn"),
}


def moe_bwd_inputs(case: str, dev, seed: int = 0):
    """``(logits, idx, grad_w, gate)``: the forward kernel's route of the
    case's logits (bias 0), or the hand-made route of a ``"dup"`` case, and
    a seeded upstream gradient."""
    from repro_torch.kernels import moe_route

    t, e, k, gate, kind = MOE_BWD_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = (torch.zeros((t, e), device=dev) if kind == "ties"
              else torch.randn((t, e), generator=gen, device=dev))
    if kind == "dup":  # distinct experts, then repeats
        idx = torch.argsort(torch.rand((t, e), generator=gen, device=dev), dim=1)[:, :k]
        idx = idx.to(torch.int32)
        idx[::2, -1] = idx[::2, 0]
        idx[::3, 0] = idx[::3, 1]
        idx[::5, 1:4] = idx[::5, 2:3]
    else:
        idx = moe_route.moe_route_cuda(logits, torch.zeros((e,), device=dev), k,
                                       gate_fn=gate)[0]
    if kind == "unaligned":
        buf = torch.empty((t * e + 1,), device=dev)
        buf[1:] = logits.reshape(-1)
        logits = buf[1:].view(t, e)
        assert logits.data_ptr() % 16 == 4
    return logits, idx, torch.randn((t, k), generator=gen, device=dev), gate


def moe_bwd_vs_plain(logits, idx, grad_w, gate) -> float:
    """``moe_route_bwd_cuda`` against ``ref.moe_route_weights_vjp_ref``;
    returns the max abs error."""
    from repro_torch.kernels import moe_route

    got = moe_route.moe_route_bwd_cuda(logits, idx, grad_w, gate_fn=gate)
    want = tref.moe_route_weights_vjp_ref(logits, idx, grad_w, gate)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    if gate == "sigmoid":  # the experts not chosen take an exact 0
        chosen = torch.zeros_like(got, dtype=torch.bool).scatter_(1, idx.long(), True)
        assert not got[~chosen].any()
    return float((got - want).abs().max())


def moe_bwd_repeat_equal(logits, idx, grad_w, gate) -> None:
    """Two ``moe_route_bwd_cuda`` calls on the same inputs give the same
    bits (no atomics)."""
    from repro_torch.kernels import moe_route

    first = moe_route.moe_route_bwd_cuda(logits, idx, grad_w, gate_fn=gate)
    second = moe_route.moe_route_bwd_cuda(logits, idx, grad_w, gate_fn=gate)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# One train step on the card against the CPU: (arch, sync, microbatches).
TRAIN_STEP_CASES = [("smollm-135m", False, 1), ("smollm-135m", True, 2),
                    ("deepseek-v2-236b", False, 1), ("deepseek-v2-236b", True, 1),
                    ("deepseek-v2-236b", False, 2), ("deepseek-v2-236b", True, 2)]
# AdamW's eps is 1e-4 in these steps: at 1e-8 the first update g / (|g| +
# eps) is the sign of any gradient above ~1e-8, so float32 noise in a
# gradient of that size (cuBLAS and the kernels sum in other orders) would
# move its parameter by a tenth of lr.
TRAIN_STEP_OPT = dict(lr=1e-2, warmup_steps=1, total_steps=4, eps=1e-4)


def state_to(state, dev):
    """A copy of a ``TrainState`` on ``dev``, sharing no storage with it."""
    import copy

    from repro_torch.core import moe_balancer
    from repro_torch.optim import adamw
    from repro_torch.train import train_loop

    def move(t):
        return t.to(dev, copy=True)

    opt = adamw.OptState(m={n: move(t) for n, t in state.opt.m.items()},
                         v={n: move(t) for n, t in state.opt.v.items()},
                         step=move(state.opt.step))
    bal = state.balancer
    if bal is not None:
        bal = moe_balancer.BalancerState(**{
            f.name: move(getattr(bal, f.name)) for f in dataclasses.fields(bal)})
    return train_loop.TrainState(params=copy.deepcopy(state.params).to(dev), opt=opt,
                                 balancer=bal, step=move(state.step))


def train_step_card_vs_cpu(dev, arch: str, sync: bool, micro: int, steps: int = 2) -> dict:
    """``steps`` train steps of the reduced ``arch`` (float32; DeepSeek with
    the CARE balancer under ET-2) from one state on the card and on the CPU,
    on the data pipeline's batches.  Asserts the loss, ``grad_norm``,
    ``lr``, every parameter, ``m``, ``v`` and the balancer within 1e-4 of
    each leaf's largest magnitude, the trigger and the routed counts equal,
    and the card's backward launches (one ``flash_attention_bwd`` a GQA
    layer, one ``moe_route_bwd`` a MoE layer, per microbatch).  Returns the
    largest difference and the card's launch counts."""
    from repro_torch.configs.base import CareConfig
    from repro_torch.data import pipeline
    from repro_torch.optim import adamw
    from repro_torch.train import train_loop

    cfg = get_config(arch).reduced()
    if cfg.moe:
        cfg = dataclasses.replace(cfg, care=CareConfig(enabled=True, comm="et", x=2))
    cpu = train_loop.init_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = state_to(cpu, dev)
    opt = adamw.OptimConfig(**TRAIN_STEP_OPT)
    step = train_loop.make_train_step(cfg, opt, sync=sync, microbatches=micro)
    data = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    worst = 0.0

    def close(got, want, label):
        nonlocal worst
        got, want = got.detach().double().cpu(), want.detach().double()
        scale = max(float(want.abs().max()), 1e-30)
        err = float((got - want).abs().max()) / scale
        assert err <= 1e-4, (label, err)
        worst = max(worst, err)

    tops.reset_launch_counts()
    for i in range(steps):
        batch = pipeline.global_batch_at(i, data)
        card, cm = step(card, batch)
        cpu, pm = step(cpu, batch)
        for key in ("loss", "grad_norm", "lr"):
            close(cm[key], pm[key], f"step {i} {key}")
        assert bool(cm["sync_trigger"]) == bool(pm["sync_trigger"])
        cparams = dict(card.params.named_parameters())
        for name, p in cpu.params.named_parameters():
            close(cparams[name], p, f"step {i} {name}")
            close(card.opt.m[name], cpu.opt.m[name], f"step {i} m {name}")
            close(card.opt.v[name], cpu.opt.v[name], f"step {i} v {name}")
        if cfg.moe:
            _eq(card.balancer.true_counts.cpu().numpy(), cpu.balancer.true_counts.numpy())
            for f in ("load_approx", "true_load", "bias"):
                close(getattr(card.balancer, f), getattr(cpu.balancer, f), f"balancer {f}")
    torch.cuda.synchronize()
    launches = tops.launch_counts()
    n_gqa = 0 if cfg.use_mla else cfg.num_layers
    n_moe = tmodel.num_scanned_layers(cfg) if cfg.moe else 0
    assert launches["flash_attention_bwd"] == n_gqa * steps * micro, launches
    assert launches["flash_attention"] == n_gqa * steps * micro, launches
    assert launches["moe_route_bwd"] == n_moe * steps * micro, launches
    assert launches["moe_route"] == n_moe * steps * micro, launches
    return {"max_rel_err": worst, "launches": launches}


# The split arithmetic of the TP families at published width on one card:
# the ranks of a TP group simulated in one process through the functions
# they call, each on its blocks (partitioning.local_specs' layout, taken
# with parallel.take_block at the rank's coordinate), the collectives done
# by hand (a float32 sum of bf16 partials, a concatenation).
TP_BLOCKS_TOL = 1e-2  # of the largest magnitude: bf16 partial sums added in another order


def _rank_leaves(module, prefix: str, cfg, ctx, rank: int) -> dict:
    """``{leaf: tensor}`` of ``module`` (the layer at ``prefix`` of a
    one-layer model, e.g. ``layers.0.mamba``) as TP rank ``rank`` of
    ``ctx`` holds it: its block of each leaf ``local_specs`` splits, every
    other leaf whole."""
    from repro_torch.models import parallel, partitioning

    named = dict(module.named_parameters())
    specs = partitioning.port_specs([f"{prefix}.{n}" for n in named],
                                    partitioning.local_specs(cfg, ctx))
    return {n: parallel.take_block(t, specs[f"{prefix}.{n}"], ctx, {"model": rank})
            if f"{prefix}.{n}" in specs else t for n, t in named.items()}


def _tp_ctx(tp: int, rank: int | None = None):
    """A spec-only context on a ``(1, tp)`` mesh; with ``rank``, one that
    answers as that TP rank (its ``tp_index``), so that the port's own
    rules pick the rank's part of a whole leaf."""
    from repro_torch.models.parallel import MeshShape, ParallelContext

    class RankContext(ParallelContext):
        def index(self, axes) -> int:
            if axes != self.tp_axis:
                raise ValueError(f"a simulated TP rank has no index over {axes}")
            return rank

    kind = ParallelContext if rank is None else RankContext
    return kind(mesh=MeshShape((1, tp), ("data", "model")))


def scaled_err(got, want) -> float:
    """Largest ``|got - want|`` over the largest ``|want|``."""
    w = want.detach().float()
    return float((got.detach().float() - w).abs().max()) / max(float(w.abs().max()), 1e-30)


def _psum(parts, dtype):
    return sum(p.float() for p in parts).to(dtype)


def rwkv_rank_blocks(dev, b: int, s: int, tp: int, seed: int = 0) -> dict:
    """RWKV6-1.6B's time and channel mix (published width, bf16) on ``b x s``
    tokens, whole and as ``tp`` ranks: each rank's ``rwkv_time_mix`` on its
    WKV heads (its columns of ``wr``, ``wk``, ``wv``, ``wg``, its rows of
    ``u`` and ``wo``, and the columns of ``w0``, ``decay_w2`` and the group
    norm that ``ssm._shift_cols`` gives it as that rank) and ``channel_mix_parts`` on its hidden units and
    ``wr``'s columns; and ``_wkv6_chunked`` on each rank's heads of the
    same inputs.  Returns the errors over the largest magnitude (the WKV's
    and the time mix's state and output against the whole call's heads,
    the summed ``wo`` and ``wv`` products against the whole layer), whether
    the WKV heads are equal bit for bit, and ``whole`` / ``rank`` callables
    (rank 0's layer) for timing."""
    import types

    from repro_torch.models import ssm

    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), num_layers=1)
    ctx = _tp_ctx(tp)
    n = cfg.rwkv_head_dim
    h = cfg.d_model // n
    hl = h // tp
    g = torch.Generator(device=dev).manual_seed(seed)
    tm = ssm.RWKVTimeMix(cfg, device=dev, generator=g)
    cm = ssm.RWKVChannelMix(cfg, device=dev, generator=g)
    x = torch.randn((b, s, cfg.d_model), generator=g, device=dev).to(tm.wr.dtype)
    out = {}
    with torch.no_grad():
        # The chunked WKV on each rank's heads of the same inputs.
        r, k, v = (torch.randn((b, s, h, n), generator=g, device=dev) for _ in range(3))
        lw = -torch.exp(torch.randn((b, s, h, n), generator=g, device=dev))
        st0 = torch.zeros((b, h, n, n), device=dev)
        w_out, w_state = ssm._wkv6_chunked(r, k, v, lw, tm.u, st0)
        heads = [slice(i * hl, (i + 1) * hl) for i in range(tp)]
        parts = [ssm._wkv6_chunked(r[:, :, c], k[:, :, c], v[:, :, c], lw[:, :, c], tm.u[c],
                                   st0[:, c]) for c in heads]
        got_o, got_s = torch.cat([o for o, _ in parts], 2), torch.cat([st for _, st in parts], 1)
        out["wkv_equal"] = torch.equal(got_o, w_out) and torch.equal(got_s, w_state)
        out["wkv_err"] = max(scaled_err(got_o, w_out), scaled_err(got_s, w_state))
        # The layer.
        want, want_state, _ = ssm.rwkv_time_mix(tm, x, cfg)
        want_cm, _ = ssm.rwkv_channel_mix(cm, x, cfg)
        ranks = []
        for i in range(tp):
            cols = ssm._shift_cols(cfg, _tp_ctx(tp, i))
            t = _rank_leaves(tm, "layers.0.tm", cfg, ctx, i)
            t.update(w0=tm.w0[cols], decay_w2=tm.decay_w2[:, cols], gn_scale=tm.gn_scale[cols],
                     gn_bias=tm.gn_bias[cols])
            ranks.append((types.SimpleNamespace(**t),
                          types.SimpleNamespace(**_rank_leaves(cm, "layers.0.cm", cfg, ctx, i))))
        tms = [ssm.rwkv_time_mix(t, x, cfg) for t, _ in ranks]
        cms = [ssm.channel_mix_parts(c, x) for _, c in ranks]
        out["state_err"] = scaled_err(torch.cat([st for _, st, _ in tms], 1), want_state)
        out["tm_err"] = scaled_err(_psum([o for o, _, _ in tms], x.dtype), want)
        got_cm = torch.cat([gt for gt, _ in cms], -1) * _psum([kv for _, kv in cms], x.dtype)
        out["cm_err"] = scaled_err(got_cm, want_cm)
    tm0, cm0 = ranks[0]
    out["whole"] = lambda: (ssm.rwkv_time_mix(tm, x, cfg), ssm.rwkv_channel_mix(cm, x, cfg))
    out["rank"] = lambda: (ssm.rwkv_time_mix(tm0, x, cfg), ssm.channel_mix_parts(cm0, x))
    out.update(heads=hl, hidden=cfg.d_ff // tp, cfg=cfg)
    return out


def mamba_rank_blocks(dev, b: int, s: int, tp: int, seed: int = 0) -> dict:
    """Hymba-1.5B's Mamba layer (published width, bf16) on ``b x s``
    tokens, whole and as ``tp`` ranks of ``Di / tp`` inner channels (``w_in``
    the same block of its ``xi`` and ``z`` halves): each rank's
    ``mamba_in``, the partial ``xdbc`` summed, each rank's ``mamba_out``,
    the partial outputs summed.  Returns the errors over the largest
    magnitude (``xdbc``, the output, the ranks' states against the whole
    call's channels) and ``whole`` / ``rank`` callables (rank 0's
    call, its partial ``xdbc`` taken as the whole) for timing."""
    import types

    from repro_torch.models import ssm

    cfg = dataclasses.replace(get_config("hymba-1.5b"), num_layers=1)
    ctx = _tp_ctx(tp)
    g = torch.Generator(device=dev).manual_seed(seed)
    m = ssm.Mamba(cfg, device=dev, generator=g)
    x = torch.randn((b, s, cfg.d_model), generator=g, device=dev).to(m.w_in.dtype)
    out = {}
    with torch.no_grad():
        want, want_state, _ = ssm.mamba(m, x, cfg)
        want_xdbc = ssm.mamba_in(m, x)[3]
        ranks = [types.SimpleNamespace(**_rank_leaves(m, "layers.0.mamba", cfg, ctx, i))
                 for i in range(tp)]
        ins = [ssm.mamba_in(p, x) for p in ranks]
        xdbc = _psum([i[3] for i in ins], x.dtype)
        outs = [ssm.mamba_out(p, xi, z, xdbc, cfg) for p, (xi, z, _, _) in zip(ranks, ins)]
        out["xdbc_err"] = scaled_err(xdbc, want_xdbc)
        out["out_err"] = scaled_err(_psum([o for o, _ in outs], x.dtype), want)
        out["state_err"] = scaled_err(torch.cat([st for _, st in outs], 1), want_state)
    p0 = ranks[0]

    def rank():
        xi, z, _, part = ssm.mamba_in(p0, x)
        return ssm.mamba_out(p0, xi, z, part, cfg)

    out["whole"] = lambda: ssm.mamba(m, x, cfg)
    out["rank"] = rank
    out.update(channels=cfg.ssm_expand * cfg.d_model // tp, cfg=cfg)
    return out


def rank_heads(q, k, v, tp: int) -> list[tuple]:
    """Each TP rank's query heads and its KV heads (both counts dividing
    over ``tp``), as ``attention_full`` projects them under a context."""
    hl, kl = q.shape[2] // tp, k.shape[2] // tp
    return [tuple(t[:, :, i * n:(i + 1) * n].contiguous() for t, n in ((q, hl), (k, kl), (v, kl)))
            for i in range(tp)]


WHISPER_ATTN = {"encoder": (1500, 1500), "cross": (432, 1500)}  # S, T, non-causal


def whisper_attn_inputs(dev, which: str, b: int, seed: int = 0) -> tuple:
    """Whisper-small's encoder self-attention or cross-attention inputs
    (12 heads of 64, bf16): q ``(b, S, 12, 64)``, k and v ``(b, T, 12,
    64)``, and the kernel's keywords."""
    cfg = get_config("whisper-small")
    s, t = WHISPER_ATTN[which]
    dh = cfg.resolved_head_dim
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, s, cfg.num_heads, dh), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, t, cfg.num_kv_heads, dh), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    return q, k, v, dict(scale=dh ** -0.5, causal=False, window=None, softcap=0.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnCard:
    def test_jsaq_route_kernel(self, cuda_device):
        q = np.random.default_rng(0).integers(0, 50, (16, 300), dtype=np.int32)
        q[0] = 4  # an all-ties row
        qt = torch.from_numpy(q)
        ref = tref.jsaq_route_ref(qt, 64)
        got = tops.jsaq_route(qt.to(cuda_device), 64)
        for g, r in zip(got, ref):
            _eq(g.cpu().numpy(), r.numpy())

    @pytest.mark.parametrize("case", JSAQ_CASES + JSAQ_CARD)
    def test_jsaq_route_level_fill(self, cuda_device, case):
        q, n = jsaq_case(case)
        qt = torch.from_numpy(q).to(cuda_device)
        want = tref.jsaq_route_ref(qt, n)
        before = tops.launch_counts()["jsaq_route"]
        got = tops.jsaq_route(qt, n)
        again = tops.jsaq_route(qt, n)
        torch.cuda.synchronize()
        assert tops.launch_counts()["jsaq_route"] == before + 2
        for g, a, w in zip(got, again, want):
            _eq(g.cpu().numpy(), w.cpu().numpy())
            _eq(a.cpu().numpy(), w.cpu().numpy())

    @pytest.mark.parametrize(
        "policy,comm,rows",
        [(p, c, "mixed") for c in KINDS for p in POLICIES]
        + [(p, c, "wake") for c in ("rt", "et_rt") for p in POLICIES]
        + [(p, c, rows) for rows in ("edge", "drop") for c in KINDS for p in POLICIES],
    )
    def test_care_route_kernel(self, cuda_device, policy, comm, rows):
        # "mixed": mixed horizons at K = 300 (one tile).  "wake": K = 1e5
        # (391 tiles) under rt / et_rt, so tiles at rest wake on their rt
        # slot.  "edge": x <= 0 (every tile due every slot under dt, et and
        # et_rt), rt_period 1, msr 1, horizons 0 and 1, a run with an
        # arrival every slot and one with none, at cap 1.  "drop": cap 1 on
        # 6 servers with jobs of 8 slots or more, so jobs drop.
        rng = np.random.default_rng(1)
        if rows == "mixed":
            d, k, t, cap = 8, 300, 500, 16
            hz = np.array([500, 500, 400, 0, 1, 250, 500, 499], np.int32)
            params = np.stack(
                [rng.integers(2, 5, d), np.full(d, 7), np.full(d, 8), hz], 1
            ).astype(np.int32)
        elif rows == "wake":
            d, k, t, cap = 4, 100_000, 4000, 16
            params = np.array([[2, 100, 8, t], [3, 37, 8, t], [2, 100, 8, 3 * t // 4],
                               [1, 250, 3, t]], np.int32)
        elif rows == "edge":
            d, k, t, cap = 6, 1000, 600, 1
            params = np.array([[0, 100, 8, t], [-1, 3, 4, t], [2, 1, 1, t],
                               [3, 5, 1, 1], [1, 7, 8, 0], [2, 9, 8, t]], np.int32)
        else:
            d, k, t, cap = 4, 6, 600, 1
            params = np.array([[2, 5, 8, t], [0, 3, 8, t], [3, 1, 12, t],
                               [1, 7, 8, t // 2]], np.int32)
        hz = params[:, 3]
        arrive = ((rng.random((d, t)) < 0.95) & (np.arange(t) < hz[:, None])).astype(np.int32)
        if rows == "edge":
            arrive[2] = 1  # an arrival every slot
            arrive[5] = 0  # none
        kw = dict(servers=k, cap=cap, policy=policy, comm=comm)
        a, p = torch.from_numpy(arrive), torch.from_numpy(params)
        ref = tref.care_route_ref(a.to(cuda_device), p.to(cuda_device), **kw)
        before = tops.launch_counts()["care_route"]
        got = tops.care_route(a.to(cuda_device), p.to(cuda_device), **kw)
        torch.cuda.synchronize()
        assert tops.launch_counts()["care_route"] == before + 1
        for g, r in zip(got, ref):
            _eq(g.cpu().numpy(), r.cpu().numpy())
        if rows == "drop":
            assert int(got[3][:, 3].sum()) > 0

    def test_fused_grid_goes_through_the_kernel(self, cuda_device):
        static = slotted_sim.StaticConfig(
            servers=200, slots=300, policy="jsaq", comm="dt", approx="msr",
            buffer_cap=16, service="deterministic", deterministic_ties=True,
            route_backend="fused",
        )
        cells = [slotted_sim.Scenario.create(0.95, x=x, mean_service=8,
                                             service="deterministic", horizon=300)
                 for x in (2, 3)]
        tops.reset_launch_counts()
        fused = slotted_sim.simulate_grid([0, 1], static, cells, device=cuda_device)
        assert tops.launch_counts() == {"jsaq_route": 0, "care_route": 1, "serve_route": 0,
                                        "serve_slots": 0,
                                        "moe_route": 0, "flash_attention": 0,
                                        "moe_route_bwd": 0, "flash_attention_bwd": 0}
        dense = slotted_sim.simulate_grid(
            [0, 1], slotted_sim.StaticConfig(**{**static.__dict__, "route_backend": "dense"}),
            cells, device=cuda_device,
        )
        for row_f, row_d in zip(fused, dense):
            for f, d in zip(row_f, row_d):
                assert (f.messages, f.departures, f.max_aq) == (d.messages, d.departures, d.max_aq)
                _eq(f.per_server_arrivals, d.per_server_arrivals)
                _eq(f.final_q, d.final_q)

    @pytest.mark.parametrize("comm", ["et", "exact"])
    @pytest.mark.parametrize(
        "r,a_n",
        [(1024, 304), (200, 40), (8, 1), (1, 8), (31, 40), (33, 40), (1025, 64), (2048, 64)],
    )
    def test_serve_route_kernel(self, cuda_device, r, a_n, comm):
        rng = np.random.default_rng(r + a_n)
        d, cap = 6, 16
        q_len = rng.integers(0, cap + 1, (d, r)).astype(np.int32)
        busy = rng.integers(0, 5, (d, r)).astype(np.int32)
        approx = (rng.integers(0, 40, (d, r)) * 0.25).astype(np.float32)
        n_arr = rng.integers(0, a_n + 1, d).astype(np.int32)
        act = np.ones(d, bool)
        n_arr[0] = a_n
        q_len[1], busy[1], approx[1] = 2, 1, 3.0  # all ties
        q_len[2] = cap  # every ring full
        act[3] = False
        n_arr[4] = 0
        approx[5, ::3] = -0.0  # ties with +0.0, broken by index
        state = [
            torch.from_numpy(x) for x in (
                rng.random((d, a_n), dtype=np.float32), q_len,
                rng.integers(0, cap, (d, r)).astype(np.int32), busy, approx,
                n_arr, act,
            )
        ]
        ref = tref.serve_route_ref(*state, cap=cap, comm=comm)
        before = tops.launch_counts()["serve_route"]
        got = tops.serve_route(*(x.to(cuda_device) for x in state), cap=cap, comm=comm)
        torch.cuda.synchronize()
        assert tops.launch_counts()["serve_route"] == before + 1
        for g, want in zip(got, ref):
            _eq(g.cpu().numpy(), want.numpy())

    @pytest.mark.parametrize("case", list(SLOTS_CASES))
    def test_serve_slots_kernel(self, cuda_device, case):
        kw, horizons = SLOTS_CASES[case]
        cell = serve_engine.ServeConfig(**{**SLOTS_BASE, **kw})
        static = dataclasses.replace(cell.static_part(), trace_occupancy=True)
        fused, args, _ = slots_vs_dense(cuda_device, static, cell, horizons)
        _, rem_in_smem = tcuda.serve_slots_smem(
            cell.replicas, cell.decode_slots, args.work.shape[2], cell.comm,
            cell.decode_rates is not None,
        )
        assert rem_in_smem == (not case.endswith("device_memory"))
        if horizons is None or max(horizons) > 1:
            assert int(fused["total_comp"].sum()) > 0
        if "drops" in case:
            assert int(fused["dropped"].sum()) > 0

    @pytest.mark.parametrize("case", list(SLOTS_CASES))
    def test_serve_slots_stream_mode(self, cuda_device, case):
        kw, horizons = SLOTS_CASES[case]
        cell = serve_engine.ServeConfig(**{**SLOTS_BASE, **kw})
        carry, launches, _ = stream_vs_dense(cuda_device, cell, horizons)
        if horizons is None or max(horizons) > STREAM_WARMUP[0]:
            assert int(carry.comp_slot.count.sum()) > 0
        assert launches >= 1

    def test_serve_stream_one_launch_a_chunk(self, cuda_device):
        cell = serve_engine.ServeConfig(
            replicas=64, decode_slots=16, slots=1000, load=0.9, comm="et", x=4,
            mean_prefill=4, mean_decode=60, msr_drain=0.25, queue_cap=128,
            deterministic_ties=True, route_backend="fused")
        tops.reset_launch_counts()
        got = serve_engine.serve_stream(0, cell, chunk=256, warmup=100, device=cuda_device)
        counts = tops.launch_counts()
        assert counts["serve_slots"] == 4 and counts["serve_route"] == 0, counts
        want = serve_engine.serve_stream(0, cell, chunk=256, warmup=100, device="cpu")
        stream_carry_equal(got.state.carry, want.state.carry)
        for name in ("offered", "completed", "messages", "dropped", "count", "max_jct"):
            assert getattr(got, name) == getattr(want, name), name
        # Any chunking and a resume give the card's carry bit for bit.
        one = serve_engine.serve_stream(0, cell, chunk=1000, warmup=100, device=cuda_device)
        half = serve_engine.serve_stream(0, cell, chunk=256, warmup=100, slots=500,
                                         device=cuda_device)
        rest = serve_engine.serve_stream(0, cell, chunk=300, warmup=100, state=half.state,
                                         slots=500, device=cuda_device)
        for other in (one, rest):
            for a, b in zip(other.state.carry.comp_slot.__dict__.values(),
                            got.state.carry.comp_slot.__dict__.values()):
                assert torch.equal(a, b)
            stream_carry_equal(other.state.carry, got.state.carry)

    def test_degraded_stream_card_equals_cpu(self, cuda_device):
        cell = serve_engine.ServeConfig(**STREAM_DEGRADED)
        got = serve_engine.serve_stream(3, cell, chunk=64, device=cuda_device)
        want = serve_engine.serve_stream(3, cell, chunk=64, device="cpu")
        stream_carry_equal(got.state.carry, want.state.carry)
        assert got.completed == want.completed > 0

    def test_fused_serve_grid_goes_through_the_kernel(self, cuda_device):
        cells = [
            serve_engine.ServeConfig(
                replicas=64, decode_slots=16, slots=300, load=0.9, comm="et", x=x,
                mean_prefill=4, mean_decode=60, msr_drain=0.25, queue_cap=128,
                deterministic_ties=True, route_backend="fused",
            )
            for x in (2, 4)
        ]
        static = cells[0].static_part()
        tops.reset_launch_counts()
        fused = serve_engine.serve_grid([0, 1], static, cells, device=cuda_device)
        assert tops.launch_counts() == {"jsaq_route": 0, "care_route": 0, "serve_route": 0,
                                        "serve_slots": 1,
                                        "moe_route": 0, "flash_attention": 0,
                                        "moe_route_bwd": 0, "flash_attention_bwd": 0}
        dense_cells = [
            serve_engine.ServeConfig(**{**c.__dict__, "route_backend": "dense"}) for c in cells
        ]
        dense = serve_engine.serve_grid(
            [0, 1], dense_cells[0].static_part(), dense_cells, device=cuda_device
        )
        for row_f, row_d in zip(fused, dense):
            for f, d in zip(row_f, row_d):
                assert (f.messages, f.completed, f.dropped) == (d.messages, d.completed, d.dropped)
                _eq(f.jct_by_rid, d.jct_by_rid)
                _eq(f.final_occupancy, d.final_occupancy)

    @pytest.mark.parametrize("case", list(POLICY_CASES))
    def test_slotted_policies_card_equals_cpu(self, cuda_device, case):
        cfg = slotted_sim.SimConfig(**{**POLICY_BASE, **POLICY_CASES[case]})
        tops.reset_launch_counts()
        grid, _, _, _, _ = grid_vs_cpu(cuda_device, (0, 1), cfg.static_part(),
                                       [cfg.scenario()])
        assert sum(tops.launch_counts().values()) == 0
        for r in grid[0]:
            assert r.arrivals == r.departures + int(r.final_q.sum())
            assert r.departures > 0

    def test_fused_equals_dense_on_mmpp_diurnal_arrivals(self, cuda_device):
        static_kw, scn_kw = MMPP_FUSED
        fused_vs_dense(cuda_device, slotted_sim.StaticConfig(**static_kw),
                       slotted_sim.Scenario.create(**scn_kw))

    @pytest.mark.parametrize("case", list(DEGRADED_CASES))
    def test_degraded_card_equals_cpu(self, cuda_device, case):
        cfg = slotted_sim.SimConfig(**{**POLICY_BASE, **DEGRADED_CASES[case]})
        tops.reset_launch_counts()
        grid, _, _, _, raw = grid_vs_cpu(cuda_device, (0, 1), cfg.static_part(),
                                         [cfg.scenario()], raw_on_card=True)
        assert sum(tops.launch_counts().values()) == 0
        for r in grid[0]:
            assert r.arrivals == r.departures + int(r.final_q.sum())
            if cfg.net_drop:
                assert r.net_drops > 0
        if cfg.fault == "crash" and cfg.policy in ("jsq", "jsaq"):
            assert int(raw["suspect_routes"].sum()) == 0

    @pytest.mark.parametrize("case", list(SERVE_DEGRADED_CASES))
    def test_serving_degraded_card_equals_cpu(self, cuda_device, case):
        cell = serve_engine.ServeConfig(**{**SERVE_DEGRADED_BASE,
                                           **SERVE_DEGRADED_CASES[case]})
        tops.reset_launch_counts()
        card = serve_engine.serve_grid([0, 1], cell.static_part(), [cell],
                                       device=cuda_device)[0]
        assert sum(tops.launch_counts().values()) == 0
        cpu = serve_engine.serve_grid([0, 1], cell.static_part(), [cell], device="cpu")[0]
        for a, b in zip(card, cpu):
            for f in dataclasses.fields(serve_engine.ServeResult):
                _eq(getattr(a, f.name), getattr(b, f.name))
            assert a.completed > 0

    @pytest.mark.parametrize("case", ["et4", "ack"])
    def test_care_dispatcher_card_equals_cpu(self, cuda_device, case):
        cell = dispatch_cell(case, 300)
        tops.reset_launch_counts()
        got, _, _ = dispatcher_card_vs_cpu(cuda_device, cell)
        assert sum(tops.launch_counts().values()) == 0
        assert got["completed"] > 0 and got["messages"] > 0
        dispatcher_vs_serve_one(cuda_device, cell, got)

    def test_dispatch_batch_card_equals_cpu(self, cuda_device):
        cfg = dispatch_sim.DispatchSimConfig(**DISPATCH_SIM_SMALL)
        card, _, _ = dispatch_sim_card_vs_cpu(cuda_device, cfg, (0, 1))
        for seed, got in zip((0, 1), card):
            one = dispatch_sim.simulate(seed, cfg, device=cuda_device)
            np.testing.assert_array_equal(got.gap, one.gap)
            np.testing.assert_array_equal(got.backlog, one.backlog)
            assert (got.messages, got.max_err) == (one.messages, one.max_err)
        assert card[0].messages > 0

    @pytest.mark.parametrize(
        "t,e,k,gate_fn,dtype",
        [
            (2048, 160, 6, "softmax", torch.float32),  # DeepSeek-V2 prefill
            (4, 160, 6, "softmax", torch.float32),  # DeepSeek-V2 decode
            (2048, 256, 8, "sigmoid", torch.float32),  # DeepSeek-V3
            (1, 160, 6, "softmax", torch.float32),
            (300, 160, 6, "softmax", torch.bfloat16),
            (77, 33, 33, "sigmoid", torch.float32),
            (16384, 160, 6, "softmax", torch.float32),  # 4 x 4096 prefill: 4 tokens a warp
        ],
    )
    def test_moe_route_kernel(self, cuda_device, t, e, k, gate_fn, dtype):
        rng = np.random.default_rng(t + e + k)
        logits = torch.from_numpy(rng.standard_normal((t, e)).astype(np.float32)).to(dtype)
        bias = torch.from_numpy(rng.standard_normal(e).astype(np.float32))
        logits[0] = 0  # an all-ties row
        bias[e // 2] = 1e9  # an expert no token may choose
        logits, bias = logits.to(cuda_device), bias.to(cuda_device)
        before = tops.launch_counts()["moe_route"]
        got = tops.moe_route(logits, bias, k, gate_fn=gate_fn)
        torch.cuda.synchronize()
        assert tops.launch_counts()["moe_route"] == before + 1
        _moe_equal(got, logits, bias, k, gate_fn)
        assert int(got[2].sum()) == t * k and int(got[2][e // 2]) == (t if k == e else 0)

    @pytest.mark.parametrize("t,e,k", [(300, 8, 3), (2048, 160, 6)])
    def test_moe_route_repeats_an_expert_in_slot_order(self, cuda_device, t, e, k):
        # Every score but k - 1 lies below -1e30, so the last sweep takes a
        # masked expert again; its positions count the repeat in slot order.
        rng = np.random.default_rng(e)
        logits = torch.from_numpy(rng.standard_normal((t, e)).astype(np.float32))
        bias = torch.full((e,), 2e30)
        bias[rng.choice(e, k - 1, replace=False)] = 0.0
        logits, bias = logits.to(cuda_device), bias.to(cuda_device)
        got = tops.moe_route(logits, bias, k)
        _moe_equal(got, logits, bias, k, "softmax")
        idx = got[0].cpu()
        assert bool((idx[:, -1:] == idx[:, :-1]).any(1).all()), "every token repeats an expert"

    def test_moe_route_scratch_leaves_no_state(self, cuda_device):
        # The look-back words live across calls: two calls in a row, and
        # shapes interleaved, give the same outputs, with no fill.
        rng = np.random.default_rng(5)
        cases = []
        for t, e, k in ((2048, 160, 6), (5, 160, 6), (16384, 64, 4), (2048, 160, 6)):
            logits = torch.from_numpy(rng.standard_normal((t, e)).astype(np.float32))
            bias = torch.from_numpy(rng.standard_normal(e).astype(np.float32))
            cases.append((logits.to(cuda_device), bias.to(cuda_device), k))
        first = [tops.moe_route(lg, b, k) for lg, b, k in cases]
        again = [tops.moe_route(lg, b, k) for lg, b, k in reversed(cases)][::-1]
        for (lg, b, k), one, two in zip(cases, first, again):
            for x, y in zip(one, two):
                assert torch.equal(x, y)
            assert int(one[2].sum()) == lg.shape[0] * k
            _moe_equal(one, lg, b, k, "softmax")

    def test_reduced_moe_prefill_goes_through_the_kernel(self, cuda_device):
        cfg = get_config("deepseek-v2-236b").reduced()
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        params = tmodel.init_params(gen, cfg, device=cuda_device)
        tokens = torch.from_numpy(
            np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
        ).to(cuda_device)
        tops.reset_launch_counts()
        logits, cache = tmodel.prefill(params, {"tokens": tokens}, cfg, cache_len=20)
        logits2, _ = tmodel.decode_step(params, logits.argmax(-1), cache, 16, cfg)
        torch.cuda.synchronize()
        n_moe = tmodel.num_scanned_layers(cfg)
        assert tops.launch_counts() == {"jsaq_route": 0, "care_route": 0, "serve_route": 0,
                                        "serve_slots": 0,
                                        "moe_route": 2 * n_moe, "flash_attention": 0,
                                        "moe_route_bwd": 0, "flash_attention_bwd": 0}
        assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(logits2).all())
        # The same weights on the CPU take the plain router.  Both run in
        # float32 (no TF32); cuBLAS and the CPU sum in other orders.
        cpu = tmodel.Model(cfg, device="cpu")
        cpu.load_state_dict({n: p.cpu() for n, p in params.state_dict().items()})
        want, _ = tmodel.prefill(cpu, {"tokens": tokens.cpu()}, cfg, cache_len=20)
        np.testing.assert_allclose(logits.cpu().numpy(), want.numpy(), rtol=1e-3, atol=1e-4)

    @pytest.mark.parametrize("b,s,t,h,kvh,dh,dv,dtype,kw", FLASH_FWD_CASES)
    def test_flash_attention_kernel(self, cuda_device, b, s, t, h, kvh, dh, dv, dtype, kw):
        rng = np.random.default_rng(s + t + h + dh)
        q, k, v = (
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device, dtype)
            for shape in ((b, s, h, dh), (b, t, kvh, dh), (b, t, kvh, dv))
        )
        scale = 1.0 / dh**0.5
        want = tref.flash_attention_ref(q, k, v, scale=scale, **kw)
        before = tops.launch_counts()["flash_attention"]
        got = tops.flash_attention(q, k, v, scale=scale, **kw)
        torch.cuda.synchronize()
        assert tops.launch_counts()["flash_attention"] == before + 1
        assert got.shape == (b, s, h, dv) and got.dtype == dtype
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        _eq(tops.flash_attention(q, k, v, scale=scale, **kw).cpu().float().numpy(),
            got.cpu().float().numpy())  # a repeated call is identical

    @pytest.mark.parametrize("b,s,t,h,kvh,dh,dv,dtype,kw", FLASH_FWD_CASES)
    def test_flash_attention_lse(self, cuda_device, b, s, t, h, kvh, dh, dv, dtype, kw):
        # each forward kernel's log-sum-exp, written in the same launch as
        # the output, against the plain version within FLASH_LSE_TOL
        from repro_torch.kernels import flash_attn

        rng = np.random.default_rng(s + t + h + dh)
        q, k, v = (
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device, dtype)
            for shape in ((b, s, h, dh), (b, t, kvh, dh), (b, t, kvh, dv))
        )
        kw = dict(scale=1.0 / dh**0.5, **kw)
        before = tops.launch_counts()["flash_attention"]
        out, lse = flash_attn.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        assert tops.launch_counts()["flash_attention"] == before + 1
        want = tref.flash_attention_lse_ref(q, k, **kw)
        assert lse.shape == (b, h, s) and lse.dtype == torch.float32
        _eq(torch.isinf(lse).cpu().numpy(), torch.isinf(want).cpu().numpy())
        fin = torch.isfinite(want)
        np.testing.assert_allclose(lse[fin].cpu().numpy(), want[fin].cpu().numpy(), rtol=0,
                                   atol=FLASH_LSE_TOL)
        # writing the lse leaves the output as the launch without it gives it
        _eq(out.cpu().float().numpy(),
            flash_attn.flash_attention_cuda(q, k, v, **kw).cpu().float().numpy())

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_flash_attention_without_lse_writes_nothing(self, cuda_device, dtype):
        # a launch without lse passes a null pointer: a sentinel-filled
        # buffer allocated beside the call stays as it was, and nothing faults
        from repro_torch.kernels import flash_attn

        rng = np.random.default_rng(11)
        q, k, v = (
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device, dtype)
            for shape in ((1, 300, 4, 64), (1, 100, 2, 64), (1, 100, 2, 64))
        )
        kw = dict(scale=0.125, causal=True, window=50, softcap=30.0)  # rows 149.. have no key
        sentinel = torch.full((1, 4, 300), -7.0, device=cuda_device)
        before = tops.launch_counts()["flash_attention"]
        out = flash_attn.flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        assert tops.launch_counts()["flash_attention"] == before + 1
        assert bool((sentinel == -7.0).all())
        out2, lse = flash_attn.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        _eq(out.cpu().float().numpy(), out2.cpu().float().numpy())
        assert bool(torch.isinf(lse[..., 149:]).all())
        assert bool(torch.isfinite(lse[..., :149]).all())

    def test_flash_attention_f32_unaligned_pointers(self, cuda_device):
        # float32 views one float off a 16-byte boundary: the binding copies
        # them to aligned storage for the kernel's 16-byte copies
        b, s, t, h, kvh, dh, dv = 1, 130, 150, 4, 2, 64, 32
        rng = np.random.default_rng(5)

        def view(*shape):
            n = int(np.prod(shape))
            flat = torch.from_numpy(rng.standard_normal(n + 1).astype(np.float32)).to(cuda_device)
            x = flat[1:].view(*shape)
            assert x.data_ptr() % 16
            return x

        q, k, v = view(b, s, h, dh), view(b, t, kvh, dh), view(b, t, kvh, dv)
        kw = dict(scale=dh**-0.5, causal=True, window=50, softcap=30.0)
        before = tops.launch_counts()["flash_attention"]
        got = tops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert tops.launch_counts()["flash_attention"] == before + 1
        torch.testing.assert_close(got, tref.flash_attention_ref(q, k, v, **kw),
                                   rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("dh", [64, 128, 256])
    @pytest.mark.parametrize("dv", [64, 128, 256])
    def test_flash_attention_bf16_every_width(self, cuda_device, dh, dv):
        # every instance of the tensor-core kernel, GQA 3, ragged S = T = 333
        b, s, h, kvh = 1, 333, 6, 2
        rng = np.random.default_rng(dh + 7 * dv)
        q, k, v = (
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(cuda_device, torch.bfloat16)
            for shape in ((b, s, h, dh), (b, s, kvh, dh), (b, s, kvh, dv))
        )
        kw = dict(scale=dh**-0.5, causal=True, window=100, softcap=30.0)
        want = tref.flash_attention_ref(q, k, v, **kw)
        got = tops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)

    def test_flash_attention_refuses_what_it_cannot_fit(self, cuda_device):
        q = torch.zeros((1, 8, 2, 512), device=cuda_device)
        with pytest.raises(ValueError, match="dh"):
            tops.flash_attention(q, q, q, scale=1.0)
        q = torch.zeros((1, 8, 2, 64), dtype=torch.float16, device=cuda_device)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            tops.flash_attention(q, q, q, scale=1.0)
        # the tensor-core kernel takes bf16 widths 64, 128 and 256 only
        q = torch.zeros((1, 8, 2, 96), dtype=torch.bfloat16, device=cuda_device)
        with pytest.raises(ValueError, match="dh must be one of"):
            tops.flash_attention(q, q, q, scale=1.0)
        before = tops.launch_counts()["flash_attention"]
        flat = torch.zeros(8 * 2 * 64 + 8, dtype=torch.bfloat16, device=cuda_device)
        q = flat[8:].view(1, 8, 2, 64)  # 16-byte aligned: taken
        tops.flash_attention(q, q, q, scale=1.0)
        q = flat[1:8 * 2 * 64 + 1].view(1, 8, 2, 64)
        with pytest.raises(ValueError, match="16-byte boundary"):
            tops.flash_attention(q, q, q, scale=1.0)
        assert tops.launch_counts()["flash_attention"] == before + 1

    @pytest.mark.parametrize("arch,flash_per_layer",
                             [("hymba-1.5b", 1), ("rwkv6-1.6b", 0), ("whisper-small", 3)])
    def test_reduced_family_card_equals_cpu(self, cuda_device, arch, flash_per_layer):
        # Prefill and a decode step of the reduced model (float32) on the
        # card and, with the same weights, on the CPU: logits and every cache
        # leaf within 1e-4 (cuBLAS and the flash kernel sum in other orders
        # than the CPU); one flash_attention launch per full-sequence
        # attention (hymba's layers, whisper's encoder, decoder and cross
        # attention; none for RWKV), none in decode.
        cfg = get_config(arch).reduced()
        params = tmodel.init_params(torch.Generator(device=cuda_device).manual_seed(0), cfg,
                                    device=cuda_device)
        rng = np.random.default_rng(0)
        s = 64  # past hymba's reduced window of 16; RWKV's chunked form
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, s)))}
        if cfg.family == "audio":
            batch["frames"] = torch.from_numpy(
                rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        cpu = tmodel.Model(cfg, device="cpu")
        cpu.load_state_dict({n: p.cpu() for n, p in params.state_dict().items()})
        tops.reset_launch_counts()
        logits, cache = tmodel.prefill(params, {k: v.to(cuda_device) for k, v in batch.items()},
                                       cfg, cache_len=s + 4)
        nxt = logits.argmax(-1)
        logits2, _ = tmodel.decode_step(params, nxt, cache, s, cfg)
        torch.cuda.synchronize()
        n_flash = flash_per_layer * cfg.num_layers
        if cfg.family == "audio":
            n_flash = cfg.encoder_layers + 2 * cfg.num_layers
        assert tops.launch_counts() == {"jsaq_route": 0, "care_route": 0, "serve_route": 0,
                                        "serve_slots": 0, "moe_route": 0,
                                        "flash_attention": n_flash,
                                        "moe_route_bwd": 0, "flash_attention_bwd": 0}
        want, want_cache = tmodel.prefill(cpu, batch, cfg, cache_len=s + 4)
        np.testing.assert_allclose(logits.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
        want2, _ = tmodel.decode_step(cpu, nxt.cpu(), want_cache, s, cfg)
        np.testing.assert_allclose(logits2.cpu().numpy(), want2.numpy(), rtol=1e-4, atol=1e-4)
        assert cache["scan"].keys() == want_cache["scan"].keys()
        for name, t in cache["scan"].items():
            np.testing.assert_allclose(t.cpu().numpy(), want_cache["scan"][name].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=name)

    @pytest.mark.parametrize("arch", ["gemma2-9b", "qwen3-0.6b", "smollm-135m"])
    def test_reduced_dense_prefill_goes_through_the_kernel(self, cuda_device, arch):
        cfg = get_config(arch).reduced()
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        params = tmodel.init_params(gen, cfg, device=cuda_device)
        tokens = torch.from_numpy(
            np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
        ).to(cuda_device)
        tops.reset_launch_counts()
        logits, cache = tmodel.prefill(params, {"tokens": tokens}, cfg, cache_len=44)
        logits2, _ = tmodel.decode_step(params, logits.argmax(-1), cache, 40, cfg)
        torch.cuda.synchronize()
        assert tops.launch_counts() == {"jsaq_route": 0, "care_route": 0, "serve_route": 0,
                                        "serve_slots": 0,
                                        "moe_route": 0, "flash_attention": cfg.num_layers,
                                        "moe_route_bwd": 0, "flash_attention_bwd": 0}
        assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(logits2).all())
        cpu = tmodel.Model(cfg, device="cpu")
        cpu.load_state_dict({n: p.cpu() for n, p in params.state_dict().items()})
        want, _ = tmodel.prefill(cpu, {"tokens": tokens.cpu()}, cfg, cache_len=44)
        np.testing.assert_allclose(logits.cpu().numpy(), want.numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
class TestTrainingOnCard:
    @pytest.mark.parametrize("case", list(FLASH_BWD_CASES))
    def test_flash_attention_bwd_kernel(self, cuda_device, case):
        q, k, v, dout, kw = flash_bwd_inputs(case, cuda_device)
        before = tops.launch_counts()["flash_attention_bwd"]
        flash_bwd_vs_plain(q, k, v, dout, kw)
        torch.cuda.synchronize()
        assert tops.launch_counts()["flash_attention_bwd"] == before + 1

    @pytest.mark.parametrize("case", ["smollm_path", "gemma2_dh256"])
    def test_flash_attention_bwd_gives_the_same_bits_twice(self, cuda_device, case):
        flash_bwd_repeat_equal(*flash_bwd_inputs(case, cuda_device))

    @pytest.mark.parametrize("case", ["float32", "smollm_path"])
    def test_flash_attention_autograd_goes_through_both_kernels(self, cuda_device, case):
        q, k, v, dout, kw = flash_bwd_inputs(case, cuda_device)
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        tops.reset_launch_counts()
        out = tops.flash_attention(q, k, v, **kw)
        got = torch.autograd.grad(out, (q, k, v), dout)
        torch.cuda.synchronize()
        assert tops.launch_counts()["flash_attention"] == 1
        assert tops.launch_counts()["flash_attention_bwd"] == 1
        want = tref.flash_attention_bwd_ref(q, k, v, dout, **kw)
        if q.dtype == torch.float32:
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        else:  # within FLASH_BWD_TOL of the largest gradient, as flash_bwd_vs_plain
            big = max(float(w.float().abs().max()) for w in want)
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                assert g.dtype == w.dtype, name
                err = float((g.float() - w.float()).abs().max()) / big
                assert err <= FLASH_BWD_TOL[q.dtype], (name, err)

    @pytest.mark.parametrize("case", list(MOE_BWD_CASES))
    def test_moe_route_bwd_kernel(self, cuda_device, case):
        before = tops.launch_counts()["moe_route_bwd"]
        moe_bwd_vs_plain(*moe_bwd_inputs(case, cuda_device))
        torch.cuda.synchronize()
        assert tops.launch_counts()["moe_route_bwd"] == before + 1

    @pytest.mark.parametrize("case", list(MOE_BWD_CASES))
    def test_moe_route_bwd_kernel_repeats_bit_for_bit(self, cuda_device, case):
        moe_bwd_repeat_equal(*moe_bwd_inputs(case, cuda_device))

    def test_moe_route_autograd_goes_through_both_kernels(self, cuda_device):
        logits, _, gw, gate = moe_bwd_inputs("deepseek_v2", cuda_device)
        logits.requires_grad_(True)
        tops.reset_launch_counts()
        idx, w, counts, pos = tops.moe_route(logits, torch.zeros(160, device=cuda_device), 6)
        assert not (idx.requires_grad or counts.requires_grad or pos.requires_grad)
        (got,) = torch.autograd.grad(w, logits, gw)
        torch.cuda.synchronize()
        assert tops.launch_counts()["moe_route"] == tops.launch_counts()["moe_route_bwd"] == 1
        want = tref.moe_route_weights_vjp_ref(logits.detach(), idx, gw, gate)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("arch,sync,micro", TRAIN_STEP_CASES)
    def test_train_step_card_equals_cpu(self, cuda_device, arch, sync, micro):
        train_step_card_vs_cpu(cuda_device, arch, sync, micro)


# --------------------------------------------------------------------------
# the kernels as torch.library operators (FakeTensorMode, launch/dryrun.py)
# --------------------------------------------------------------------------


def fake_meta_mismatches(op, args, outs) -> list[str]:
    """Run ``op`` on fake copies of ``args`` (``FakeTensorMode``: no launch)
    and list every output whose shape, dtype or strides differ from
    ``outs``, the real launch's; empty when all agree."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fargs = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        fouts = op(*fargs)
    fouts = fouts if isinstance(fouts, (tuple, list)) else (fouts,)
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    bad = []
    for i, (f, r) in enumerate(zip(fouts, outs)):
        meta = lambda t: (tuple(t.shape), t.dtype, tuple(t.stride()), t.device.type)  # noqa: E731
        if meta(f) != meta(r):
            bad.append(f"output {i}: fake {meta(f)} real {meta(r)}")
    if len(fouts) != len(outs):
        bad.append(f"{len(fouts)} fake outputs, {len(outs)} real")
    return bad


def kernel_op_cases(dev):
    """``name -> (operator, arguments)``: each kernel's operator at a small
    shape of every dtype and option the model path uses."""
    from repro_torch.kernels import flash_attn, moe_route

    g = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dev, dtype)

    q, k, v = rand(2, 200, 6, 64, dtype=torch.bfloat16), rand(2, 200, 2, 64,
                                                              dtype=torch.bfloat16), None
    v = rand(2, 200, 2, 128, dtype=torch.bfloat16)
    q32, k32 = rand(1, 70, 4, 32), rand(1, 70, 4, 32)
    out, lse = flash_attn.flash_attention_op(q, k, v, 0.125, True, 64, 30.0, True)
    logits = rand(300, 160)
    idx = moe_route.moe_route_op(logits, rand(160), 6, "softmax")[0]
    cases = {
        "flash_attention_bf16_lse": (flash_attn.flash_attention_op,
                                     (q, k, v, 0.125, True, 64, 30.0, True)),
        "flash_attention_bf16": (flash_attn.flash_attention_op,
                                 (q, k, v, 0.125, True, None, 0.0, False)),
        "flash_attention_f32_lse": (flash_attn.flash_attention_op,
                                    (q32, k32, k32, 0.2, False, None, 0.0, True)),
        "flash_attention_bwd_bf16": (flash_attn.flash_attention_bwd_op,
                                     (q, k, v, out, torch.ones_like(out), lse, 0.125, True, 64,
                                      30.0)),
        "moe_route_f32": (moe_route.moe_route_op, (logits, rand(160), 6, "softmax")),
        "moe_route_bf16_sigmoid": (moe_route.moe_route_op,
                                   (rand(77, 256, dtype=torch.bfloat16), rand(256), 8,
                                    "sigmoid")),
        "moe_route_bwd": (moe_route.moe_route_bwd_op,
                          (logits, idx, rand(300, 6), "softmax")),
    }
    return cases


@pytest.mark.cuda
class TestKernelOperators:
    @pytest.mark.parametrize("case", [
        "flash_attention_bf16_lse", "flash_attention_bf16", "flash_attention_f32_lse",
        "flash_attention_bwd_bf16", "moe_route_f32", "moe_route_bf16_sigmoid", "moe_route_bwd",
    ])
    def test_fake_output_equals_the_real_launch(self, cuda_device, case):
        op, args = kernel_op_cases(cuda_device)[case]
        name = op._name.split("::")[-1]
        before = tops.launch_counts()[name]
        outs = op(*args)
        torch.cuda.synchronize()
        assert tops.launch_counts()[name] == before + 1  # a real tensor reaches the kernel
        assert fake_meta_mismatches(op, args, outs) == []
        assert tops.launch_counts()[name] == before + 1  # the fake one launched nothing

    def test_wrappers_launch_once_a_call(self, cuda_device):
        cases = kernel_op_cases(cuda_device)
        q, k, v = cases["flash_attention_bf16"][1][:3]
        logits, bias = cases["moe_route_f32"][1][:2]
        tops.reset_launch_counts()
        for n in range(1, 4):
            tops.flash_attention(q, k, v, scale=0.125)
            tops.moe_route(logits, bias, 6)
            counts = tops.launch_counts()
            assert counts["flash_attention"] == counts["moe_route"] == n
        qg = q.clone().requires_grad_(True)
        tops.flash_attention(qg, k, v, scale=0.125).float().sum().backward()
        lg = logits.clone().requires_grad_(True)
        tops.moe_route(lg, bias, 6)[1].sum().backward()
        torch.cuda.synchronize()
        counts = tops.launch_counts()
        assert counts["flash_attention"] == counts["moe_route"] == 4
        assert counts["flash_attention_bwd"] == counts["moe_route_bwd"] == 1

    def test_the_refusals_still_raise(self, cuda_device):
        from repro_torch.kernels import flash_attn, moe_route

        tops.reset_launch_counts()
        q = torch.zeros((1, 8, 2, 96), dtype=torch.bfloat16, device=cuda_device)
        with pytest.raises(ValueError, match="dh must be one of"):
            tops.flash_attention(q, q, q, scale=1.0)
        with pytest.raises(ValueError, match="dh must be one of"):
            flash_attn.flash_attention_bwd_op(q, q, q, q, q, torch.zeros(
                (1, 2, 8), device=cuda_device), 1.0, True, None, 0.0)
        with pytest.raises(ValueError, match="experts"):
            tops.moe_route(torch.zeros((4, 257), device=cuda_device),
                           torch.zeros(257, device=cuda_device), 2)
        logits = torch.zeros((4, 16), device=cuda_device)
        bias = torch.zeros(16, device=cuda_device)
        tops.moe_route(logits, bias, 2)  # builds the scratch before the capture
        graph = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="CUDA graph"):
            with torch.cuda.graph(graph):
                moe_route.moe_route_op(logits, bias, 2, "softmax")
        counts = tops.launch_counts()
        assert counts["flash_attention"] == counts["flash_attention_bwd"] == 0
        assert counts["moe_route"] == 1


@pytest.mark.cuda
class TestTPBlocksOnCard:
    """The TP families' split arithmetic at published width (chip_smoke.py
    phase 10 (f)-(h), at shorter sequences)."""

    def test_rwkv_rank_blocks(self, cuda_device):
        res = rwkv_rank_blocks(cuda_device, 1, 256, 16)  # 256 tokens: the chunked form
        assert res["heads"] == 2 and res["hidden"] == 448
        assert res["wkv_err"] <= TP_BLOCKS_TOL and res["state_err"] <= TP_BLOCKS_TOL, res
        assert res["tm_err"] <= TP_BLOCKS_TOL and res["cm_err"] <= TP_BLOCKS_TOL, res

    def test_mamba_rank_blocks(self, cuda_device):
        res = mamba_rank_blocks(cuda_device, 1, 128, 16)
        assert res["channels"] == 200
        for k in ("xdbc_err", "out_err", "state_err"):
            assert res[k] <= TP_BLOCKS_TOL, (k, res[k])

    @pytest.mark.parametrize("which", list(WHISPER_ATTN))
    @pytest.mark.parametrize("tp", [2, 4])
    def test_whisper_rank_heads_bit_for_bit(self, cuda_device, which, tp):
        q, k, v, kw = whisper_attn_inputs(cuda_device, which, 1)
        whole = tops.flash_attention(q, k, v, **kw)
        hl = q.shape[2] // tp
        for i, (qr, kr, vr) in enumerate(rank_heads(q, k, v, tp)):
            assert torch.equal(tops.flash_attention(qr, kr, vr, **kw),
                               whole[:, :, i * hl:(i + 1) * hl]), (which, tp, i)

