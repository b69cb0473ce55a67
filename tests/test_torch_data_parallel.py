"""The port's data parallelism: each rank of the dp group steps, prefills and
decodes on its block of the batch's rows, against the JAX package's own
step under a mesh and against the port's own one-device and whole-batch
runs.

Three gloo jobs (``tests/torch_ranks.py``, job ``"dp"``) run on meshes
(2, 2), (2, 1) and (4, 1) while one subprocess of the JAX package runs
over 4 forced host devices; all start together and the tests read their
results.

* *Against the JAX reference.* The reduced DeepSeek-V2 (4 experts, the
  CARE balancer under ET-2, capacity factor 1.0, which drops tokens) and
  the reduced SmolLM-135M, on each mesh, at 1 and 2 microbatches: two
  train steps (the second with ``sync=True``) on two global batches of 8
  x 16 whose labels are masked unevenly over the ranks.  The reference
  jits ``train_loop.make_train_step`` under an ``AxisType.Auto`` mesh of
  the same shape with the batch laid out ``P("data")``, so its MoE
  layers run their ``shard_map`` region on the same dispatcher blocks as
  the port's ranks.  Loss, ``grad_norm`` and ``lr`` of each step, every
  parameter and AdamW moment after the second, within 1e-4 of each
  leaf's largest magnitude; the sync trigger and the balancer's
  ``true_counts`` equal; every rank's parameters equal rank 0's.
* *Against the port's own runs,* where nothing drops (capacity factor
  4.0 with the balancer's bias off, so that the routes do not depend on
  its per-dispatcher rows; and SmolLM): the split step equals the one-device step on the
  whole batch and the whole-batch path under the same context (every rank
  holding every row, ``ParallelContext.with_whole_batch``) within 1e-5.
* *Serving* under (2, 2): each rank's prefill and two decode steps, and
  a decode from a zero cache, equal its rows of the ``ctx=None`` logits
  within 1e-5; the cache holds its rows only.  At a capacity factor that
  drops tokens a decode step keeps the whole batch's capacity and
  positions: its rows equal the one-device decode of the whole batch,
  where a one-device decode of the rank's rows alone differs.
* *Downgrade.* A batch of 3 rows over dp 2 stays whole on every rank
  (``ctx.for_batch``) and gives the one-device results.
* *Families.* Every family's reduced train step (dense Gemma2, MoE
  DeepSeek-V3 with its MTP head, hybrid Hymba, ssm RWKV6, audio Whisper,
  vlm Chameleon) under (2, 1) equals the one-device step within 1e-5.
* ``ParallelContext.take_rows`` gives each rank its block of each
  microbatch, refuses rows that do not divide under a split context and
  keeps them whole under ``for_batch``'s.
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import CareConfig as JCare
from repro.train import train_loop as jloop
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import CareConfig as TCare
from repro_torch.models import convert, ffn
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_ranks.py"
TIMEOUT_S = 300  # all jobs and the reference together
JAX_TOL, OWN_TOL = 1e-4, 1e-5
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=4, eps=1e-4)
CARE = dict(enabled=True, comm="et", x=2)
DROP = dict(n_routed_experts=4, moe_capacity_factor=1.0)
NO_DROP = dict(n_routed_experts=4, moe_capacity_factor=4.0)
NO_BIAS = dict(enabled=False)  # routes independent of the balancer's rows
B, S = 8, 16
MESHES = {"2x2": (2, 2), "2x1": (2, 1), "4x1": (4, 1)}

JAX_CASES = {  # name: arch, mesh, microbatches
    "v2-2x2-m1": ("deepseek-v2-236b", "2x2", 1),
    "v2-2x2-m2": ("deepseek-v2-236b", "2x2", 2),
    "v2-2x1-m1": ("deepseek-v2-236b", "2x1", 1),
    "v2-4x1-m2": ("deepseek-v2-236b", "4x1", 2),
    "smollm-2x1-m2": ("smollm-135m", "2x1", 2),
    "smollm-4x1-m1": ("smollm-135m", "4x1", 1),
}
OWN_CASES = {  # name: arch, mesh, microbatches (nothing drops)
    "v2-2x2-nodrop": ("deepseek-v2-236b", "2x2", 1),
    "smollm-4x1-m2": ("smollm-135m", "4x1", 2),
}
FAMILIES = ("gemma2-9b", "deepseek-v3-671b", "hymba-1.5b", "rwkv6-1.6b", "whisper-small",
            "chameleon-34b")

_REFERENCE = r'''
import dataclasses, math, pickle, sys
import numpy as np
import jax
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import CareConfig
from repro.launch.mesh import make_context
from repro.optim import adamw
from repro.train import train_loop

cases = pickle.loads(open(sys.argv[1], "rb").read())
out = {}
for name, c in cases.items():
    cfg = dataclasses.replace(get_config(c["arch"]).reduced(), **c["replace"])
    if cfg.moe:
        cfg = dataclasses.replace(cfg, care=CareConfig(**c["care"]))
    mesh = jax.make_mesh(c["mesh"], ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:math.prod(c["mesh"])])
    ctx = make_context(mesh, cfg.n_routed_experts if cfg.moe else 0)
    state = jax.device_put(train_loop.init_state(jax.random.key(0), cfg, ctx),
                           NamedSharding(mesh, P()))
    metrics = []
    for batch, sync in zip(c["batches"], c["syncs"]):
        step = jax.jit(train_loop.make_train_step(cfg, adamw.OptimConfig(**c["opt"]), ctx,
                                                  sync=sync, microbatches=c["micro"]))
        rows = {k: jax.device_put(v, NamedSharding(mesh, P("data"))) for k, v in batch.items()}
        state, m = step(state, rows)
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    out[name] = {"metrics": metrics, "state": jax.tree_util.tree_map(np.asarray, state)}
open(sys.argv[2], "wb").write(pickle.dumps(out))
'''


def _batches(vocab: int, rows: int = B, seed: int = 7) -> list[dict]:
    """Two global batches; the first rows lose more labels than the last."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        tok = rng.integers(0, vocab, (rows, S)).astype(np.int32)
        lab = np.roll(tok, -1, 1)
        lab[0, :9] = -1
        lab[1, ::3] = -1
        lab[rows - 1, 5:7] = -1
        out.append({"tokens": tok, "labels": lab})
    return out


def _configs(arch: str, replace: dict, care: dict = CARE):
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    if jcfg.moe:
        jcfg = dataclasses.replace(jcfg, care=JCare(**care), **replace)
        tcfg = dataclasses.replace(tcfg, care=TCare(**care), **replace)
    return jcfg, tcfg


def _torch_batches(batches: list[dict]) -> list[dict]:
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]


def _jobs() -> tuple[dict, dict]:
    """The reference's cases and each mesh's gloo job."""
    ref, jobs = {}, {m: {} for m in MESHES}
    common = dict(opt=adamw.OptimConfig(**OPT), syncs=(False, True))
    for name, (arch, mesh, micro) in JAX_CASES.items():
        jcfg, tcfg = _configs(arch, DROP)
        batches = _batches(tcfg.vocab_size)
        jstate = jloop.init_state(jax.random.key(0), jcfg)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg, "cpu")
        ref[name] = dict(arch=arch, replace=DROP if jcfg.moe else {}, care=CARE,
                         mesh=MESHES[mesh], micro=micro, opt=OPT, syncs=(False, True),
                         batches=batches)
        jobs[mesh][name] = dict(common, cfg=tcfg, params=params.state_dict(), micro=micro,
                                batches=_torch_batches(batches), runs=("split",), do=("train",))
    for name, (arch, mesh, micro) in OWN_CASES.items():
        _, tcfg = _configs(arch, NO_DROP, NO_BIAS)
        jobs[mesh][name] = dict(common, cfg=tcfg, micro=micro,
                                batches=_torch_batches(_batches(tcfg.vocab_size)),
                                runs=("split", "whole", "none"),
                                do=("train", "serve", "decode") if tcfg.moe else ("train",))
    _, tcfg = _configs("deepseek-v2-236b", DROP)
    jobs["2x2"]["v2-decode-drop"] = dict(
        cfg=tcfg, batches=_torch_batches(_batches(tcfg.vocab_size)), runs=("split", "none", "rows"),
        do=("decode",))
    _, tcfg = _configs("deepseek-v2-236b", NO_DROP)
    jobs["2x1"]["v2-3-rows"] = dict(common, cfg=tcfg,
                                    batches=_torch_batches(_batches(tcfg.vocab_size, rows=3)),
                                    runs=("split", "none"), do=("train", "serve", "decode"))
    for arch in FAMILIES:
        cfg = tget(arch).reduced()
        batches = _torch_batches(_batches(cfg.vocab_size, rows=4))
        if cfg.family == "audio":
            rng = np.random.default_rng(11)
            for b in batches:
                b["frames"] = torch.from_numpy(
                    rng.standard_normal((4, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        jobs["2x1"][arch] = dict(common, cfg=cfg, batches=batches[:1], syncs=(False,),
                                 runs=("split", "none"), do=("train",))
    return ref, jobs


def _env(**extra) -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1", **extra}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"jax": {case: ...}, mesh: [rank's results, ...]}``: every job and
    the reference started together, each rank a process."""
    work = tmp_path_factory.mktemp("dp")
    ref, jobs = _jobs()
    (work / "ref_in.pkl").write_bytes(pickle.dumps(ref))
    procs, logs = [], []

    def start(argv, log, env):
        logs.append(log)
        with open(log, "wb") as f:
            procs.append(subprocess.Popen(argv, env=env, cwd=ROOT, stdout=f,
                                          stderr=subprocess.STDOUT))

    start([sys.executable, "-c", _REFERENCE, str(work / "ref_in.pkl"), str(work / "ref.pkl")],
          work / "ref.log",
          _env(JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    for mesh, cases in jobs.items():
        d = work / mesh
        d.mkdir()
        world = math.prod(MESHES[mesh])
        torch.save(dict(kind="dp", mesh=MESHES[mesh], axes=("data", "model"), cases=cases,
                        rows=B), d / "job.pt")
        for r in range(world):
            start([sys.executable, str(WORKER), str(r), str(world), str(d)], d / f"rank{r}.log",
                  _env())
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"{log} exit {p.returncode}:\n{log.read_text()[-4000:]}"
    out = {"jax": pickle.loads((work / "ref.pkl").read_bytes())}
    for mesh in jobs:
        out[mesh] = [torch.load(work / mesh / f"out{r}.pt", weights_only=False)
                     for r in range(math.prod(MESHES[mesh]))]
    return out


def _close(got: torch.Tensor, want, tol: float, label: str) -> None:
    w = np.asarray(want, dtype=np.float64)
    scale = max(float(np.abs(w).max()), 1e-30)
    np.testing.assert_allclose(got.detach().double().numpy() / scale, w / scale, rtol=tol,
                               atol=tol, err_msg=label)


def _same_state(got: dict, want: dict, tol: float, label: str) -> None:
    for part in ("params", "m", "v"):
        assert got[part].keys() == want[part].keys()
        for n, t in want[part].items():
            _close(got[part][n], t.detach().numpy(), tol, f"{label} {part} {n}")


def _dp_rows(out: dict, mesh: str, rows: int = B) -> slice:
    dp = MESHES[mesh][0]
    i = out["ctx"]["dp"]
    return slice(i * rows // dp, (i + 1) * rows // dp)


@pytest.mark.parametrize("case", JAX_CASES)
def test_split_step_equals_the_jax_mesh_step(runs, case):
    arch, mesh, micro = JAX_CASES[case]
    _, tcfg = _configs(arch, DROP)
    ref = runs["jax"][case]
    want = convert.train_state_from_jax(ref["state"], tcfg, "cpu")
    want = {"params": dict(want.params.named_parameters()), "m": want.opt.m, "v": want.opt.v,
            "balancer": want.balancer}
    outs = [o["cases"][case]["split"] for o in runs[mesh]]
    dp = MESHES[mesh][0]
    for r, got in enumerate(outs):
        assert not got["whole"] and got["rows"] == B // dp
        for i, (gm, wm) in enumerate(zip(got["metrics"], ref["metrics"])):
            for k in ("loss", "grad_norm", "lr"):
                _close(gm[k], wm[k], JAX_TOL, f"rank {r} step {i} {k}")
            assert bool(gm["sync_trigger"]) == bool(wm["sync_trigger"])
        _same_state(got, want, JAX_TOL, f"rank {r}")
        for n, t in got["params"].items():
            assert torch.equal(t, outs[0]["params"][n]), (r, n)
        if tcfg.moe:
            np.testing.assert_array_equal(got["balancer"]["true_counts"].numpy(),
                                          want["balancer"].true_counts.numpy())
            for f in ("load_approx", "true_load", "bias"):
                _close(got["balancer"][f], getattr(want["balancer"], f).numpy(), JAX_TOL,
                       f"rank {r} balancer {f}")
    if tcfg.moe:
        # Tokens were dropped: in the first step some dispatcher routed more
        # (token, slot) pairs to an expert than its microbatches hold.
        tp = MESHES[mesh][1]
        tokens = B // micro // dp * S // tp
        cap = ffn._capacity(tokens, tcfg.moe_top_k, tcfg.n_routed_experts,
                            tcfg.moe_capacity_factor)
        assert float(outs[0]["metrics"][0]["true_counts"].max()) > micro * cap


@pytest.mark.parametrize("case", OWN_CASES)
def test_split_step_equals_one_device_and_whole_batch(runs, case):
    arch, mesh, micro = OWN_CASES[case]
    dp = MESHES[mesh][0]
    for r, o in enumerate(runs[mesh]):
        res = o["cases"][case]
        split = res["split"]
        assert not split["whole"] and split["rows"] == B // dp
        assert res["whole"]["whole"] and res["whole"]["rows"] == B
        for other in ("none", "whole"):
            for i, (gm, wm) in enumerate(zip(split["metrics"], res[other]["metrics"])):
                for k in ("loss", "grad_norm", "lr"):
                    _close(gm[k], wm[k].numpy(), OWN_TOL, f"rank {r} {other} step {i} {k}")
                assert bool(gm["sync_trigger"]) == bool(wm["sync_trigger"])
            _same_state(split, res[other], OWN_TOL, f"rank {r} {other}")
        if "balancer" in split:
            for other in ("none", "whole"):
                counts = res[other]["balancer"]["true_counts"]
                if counts.dim() == 4:
                    counts = counts.sum((1, 2))
                np.testing.assert_array_equal(split["balancer"]["true_counts"].sum((1, 2)),
                                              counts)


def test_serving_takes_each_rank_its_rows(runs):
    for r, o in enumerate(runs["2x2"]):
        res = o["cases"]["v2-2x2-nodrop"]
        rows = _dp_rows(o, "2x2")
        split, none = res["split"], res["none"]
        assert split["cache_rows"] == B // 2 and none["cache_rows"] == B
        assert split["serve"].shape[1] == B // 2
        _close(split["serve"], none["serve"][:, rows].numpy(), OWN_TOL, f"rank {r} serve")
        _close(split["decode"], none["decode"][rows].numpy(), OWN_TOL, f"rank {r} decode")


def test_decode_keeps_the_whole_batch_capacity(runs):
    differs = False
    for r, o in enumerate(runs["2x2"]):
        res = o["cases"]["v2-decode-drop"]
        rows = _dp_rows(o, "2x2")
        assert res["split"]["cache_rows"] == B // 2
        _close(res["split"]["decode"], res["none"]["decode"][rows].numpy(), OWN_TOL,
               f"rank {r} decode")
        differs |= not torch.allclose(res["rows"]["decode"], res["none"]["decode"][rows],
                                      rtol=1e-3, atol=1e-3)
    assert differs, "no token dropped: the rank's rows alone route as the whole batch"


def test_a_batch_that_does_not_divide_stays_whole(runs):
    for r, o in enumerate(runs["2x1"]):
        res = o["cases"]["v2-3-rows"]
        split, none = res["split"], res["none"]
        assert split["whole"] and split["rows"] == 3 and split["cache_rows"] == 3
        _close(split["serve"], none["serve"].numpy(), OWN_TOL, f"rank {r} serve")
        _close(split["decode"], none["decode"].numpy(), OWN_TOL, f"rank {r} decode")
        for i, (gm, wm) in enumerate(zip(split["metrics"], none["metrics"])):
            for k in ("loss", "grad_norm"):
                _close(gm[k], wm[k].numpy(), OWN_TOL, f"rank {r} step {i} {k}")
        _same_state(split, none, OWN_TOL, f"rank {r}")


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_splits_its_train_step(runs, arch):
    for r, o in enumerate(runs["2x1"]):
        res = o["cases"][arch]
        split, none = res["split"], res["none"]
        assert not split["whole"] and split["rows"] == 2
        for k in ("loss", "grad_norm"):
            _close(split["metrics"][0][k], none["metrics"][0][k].numpy(), OWN_TOL,
                   f"rank {r} {k}")
        _same_state(split, none, OWN_TOL, f"rank {r}")


@pytest.mark.parametrize("mesh", MESHES)
def test_take_rows_gives_each_rank_its_block_of_each_microbatch(runs, mesh):
    dp = MESHES[mesh][0]
    for o in runs[mesh]:
        i = o["ctx"]["dp"]
        for micro, got in o["take_rows"].items():
            want = np.arange(B).reshape(micro, dp, B // micro // dp)[:, i].reshape(-1)
            np.testing.assert_array_equal(got.numpy(), want)
        # Rows that do not divide are refused under the split context, and
        # kept whole under ctx.for_batch's.
        assert o["take_rows_refused"]
        np.testing.assert_array_equal(o["whole_rows"].numpy(), np.arange(B))
