"""The port's tensor parallelism over ``model`` for every family: each
rank of the TP group holds its blocks of the split leaves, computes its
heads, channels, hidden units and vocabulary columns, and sums the
row-parallel products over the group; a MoE model's rank also holds its
block of the routed experts (``partitioning.expert_specs``).

Three gloo jobs (``tests/torch_ranks.py``, job ``"tp"``) run on meshes
(1, 2), (2, 2) and (1, 4) while a subprocess of the JAX package for each
mesh runs its cases over 4 forced host devices; all start together and
the tests read their results.  The reference's compiles take most of the
time (~5 s a case), so XLA compiles them without its expensive backend
passes (``REF_XLA_FLAGS``: 0.6 of the CPU time; the arithmetic is the
same float32 program).  The cases are the reduced SmolLM-135M, Gemma2-9B (softcap,
local and global windows), Qwen1.5-4B (QKV bias) and Qwen3-0.6B (qk-norm):
4 query heads over 2 KV heads, so (1, 2) and (2, 2) split both head
counts and (1, 4) splits the query heads only (each rank reads the KV
head its query head uses) with the KV cache split by rows.  One more
case at (1, 4), SmolLM with 6 heads over 3 KV heads (SmolLM-135M's 9 over
3 on 16 ranks, cut to size), keeps its attention whole on every rank, and
a cache of 18 rows at (1, 4) keeps the cache whole (``cache_specs``
downgrades it).  The MoE cases are the reduced DeepSeek-V2 (MLA's 4 heads,
``w_dq`` and the shared expert split, ``embed`` by its ``D`` columns, the
compressed cache by rows) at (1, 2) and (1, 4) with its 8 experts over
the whole mesh, at (2, 2) with 6 experts (EP over ``model``, FSDP over
``data``), at (1, 4) with a cache of 18 rows (whole), and the reduced
DeepSeek-V3 (sigmoid gate, MTP head) at (2, 2).  The other families at
(1, 2), (2, 2) and (1, 4): the reduced RWKV6-1.6B (4 WKV heads of 32,
the channel mix's hidden units and ``D`` columns, the shift states by
columns; one more prefill of 64 tokens, which takes the chunked WKV
form), Hymba-1.5B (4 heads over 2, Mamba's 256 inner channels with
``w_in``'s block of both halves, the FFN; and with 5 heads over 1,
Hymba's 25 over 5 cut to size, at (1, 2): attention whole, the KV cache
by rows) and Whisper-small (encoder, decoder and cross-attention heads,
the FFN; and with 6 heads over 6 at (1, 4): attention whole, the self
and cross caches by rows).

* *Against the JAX reference.* Two train steps on two global batches of
  4 x 16 whose labels are masked unevenly, each rank on its dp block of
  the rows.  The reference jits ``train_loop.make_train_step`` under an
  ``AxisType.Auto`` mesh of the same shape, its parameters laid out by
  its ``param_specs`` and its moments by ``zero1_specs``, the batch
  ``P("data")``.  Loss, ``grad_norm`` and ``lr`` of each step, every
  parameter and AdamW moment gathered whole after the second, within
  1e-4 of each leaf's largest magnitude; every rank's whole state equal
  to rank 0's.
* *Against the port's own runs.* A prefill and two greedy decode steps,
  and a decode step from a zero cache, under the context equal the
  rank's rows of the ``ctx=None`` logits within 1e-5.
* *Layout.* Each rank holds ``1/tp`` of every leaf
  ``partitioning.local_specs`` splits and the whole of every other leaf;
  the KV cache from a prefill and from ``init_decode_cache`` is the
  rank's ``cache_specs`` block of the whole cache.
* *Checkpoints* under (2, 2), Qwen3's, DeepSeek-V2's (EP+FSDP) and
  Hymba's (``w_in``'s two-half block): the trained state saved whole from
  rank 0 and restored into a fresh state's blocks gives every block back
  bit for bit.
* *One TP rank* (a (1, 1) context in this process): the primitives
  return their input, and the prefill, decode and train step of a dense
  decoder, RWKV6, Hymba and Whisper issue no collective.
"""
import dataclasses
import functools
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
from repro.train import train_loop as jloop
from repro_torch.configs import get_config as tget
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import make_context, make_production_mesh
from repro_torch.models import convert, model, parallel, partitioning
from repro_torch.models.parallel import MeshShape, ParallelContext
from repro_torch.models.parallel import Spec as P
from repro_torch.optim import adamw
from repro_torch.train import train_loop
from torch_ranks import one_rank

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_ranks.py"
TIMEOUT_S = 240  # all jobs and the reference together
JAX_TOL, OWN_TOL = 1e-4, 1e-5
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=4, eps=1e-4)
B, S = 4, 16
CACHE = S + 4  # divides over TP 2 and 4
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
ARCHS = {"smollm": "smollm-135m", "gemma2": "gemma2-9b", "qwen15": "qwen1.5-4b",
         "qwen3": "qwen3-0.6b"}
CASES = {  # name: arch, mesh, config changes, cache rows
    **{f"{short}-{mesh}": (arch, mesh, {}, CACHE) for short, arch in ARCHS.items()
       for mesh in MESHES},
    "smollm-6h-1x4": ("smollm-135m", "1x4", dict(num_heads=6, num_kv_heads=3), CACHE),
    "gemma2-cache18-1x4": ("gemma2-9b", "1x4", {}, S + 2),
    "v2-1x2": ("deepseek-v2-236b", "1x2", {}, CACHE),
    "v2-1x4": ("deepseek-v2-236b", "1x4", {}, CACHE),
    "v2e6-2x2": ("deepseek-v2-236b", "2x2", dict(n_routed_experts=6), CACHE),
    "v3-2x2": ("deepseek-v3-671b", "2x2", {}, CACHE),
    "v2-cache18-1x4": ("deepseek-v2-236b", "1x4", {}, S + 2),
    **{f"{short}-{mesh}": (arch, mesh, {}, CACHE)
       for short, arch in (("rwkv", "rwkv6-1.6b"), ("hymba", "hymba-1.5b"),
                           ("whisper", "whisper-small")) for mesh in MESHES},
    "hymba-5h-1x2": ("hymba-1.5b", "1x2", dict(num_heads=5, num_kv_heads=1), CACHE),
    "whisper-6h-1x4": ("whisper-small", "1x4", dict(num_heads=6, num_kv_heads=6), CACHE),
}
CKPT_CASE = ("qwen3-2x2", "v2e6-2x2", "hymba-2x2")
LONG = 64  # an RWKV prefill of 64 tokens takes the chunked WKV form
# Cases whose MoE layers also take the one-device path on the rank's
# expert blocks (a sequence that does not divide over TP): EP+FSDP, and EP
# over both axes.
HELD_CASES = ("v2e6-2x2", "v3-2x2")
# The cache's rows do not enter a train step: that case's reference is
# gemma2-1x4's.
SAME_STEP = {"gemma2-cache18-1x4": "gemma2-1x4", "v2-cache18-1x4": "v2-1x4"}
REF_XLA_FLAGS = ("--xla_force_host_platform_device_count=4 --xla_backend_optimization_level=0 "
                 "--xla_llvm_disable_expensive_passes=true")

_REFERENCE = r'''
import dataclasses, math, pickle, sys
import numpy as np
import jax
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch.mesh import make_context
from repro.models import partitioning
from repro.optim import adamw
from repro.train import train_loop

cases = pickle.loads(open(sys.argv[1], "rb").read())
out = {}
for name, c in cases.items():
    cfg = dataclasses.replace(get_config(c["arch"]).reduced(), **c["replace"])
    mesh = jax.make_mesh(c["mesh"], ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:math.prod(c["mesh"])])
    ctx = make_context(mesh, cfg.n_routed_experts if cfg.moe else 0)
    state = train_loop.init_state(jax.random.key(0), cfg, ctx)
    pspecs = partitioning.param_specs(state.params, cfg, ctx)
    zspecs = partitioning.zero1_specs(pspecs, state.params, ctx)
    rep = NamedSharding(mesh, P())
    opt = adamw.OptState(m=jax.device_put(state.opt.m, partitioning.to_shardings(zspecs, mesh)),
                         v=jax.device_put(state.opt.v, partitioning.to_shardings(zspecs, mesh)),
                         step=jax.device_put(state.opt.step, rep))
    state = train_loop.TrainState(
        params=jax.device_put(state.params, partitioning.to_shardings(pspecs, mesh)), opt=opt,
        balancer=None, step=jax.device_put(state.step, rep))
    step = jax.jit(train_loop.make_train_step(cfg, adamw.OptimConfig(**c["opt"]), ctx))
    metrics = []
    for batch in c["batches"]:
        rows = {k: jax.device_put(v, NamedSharding(mesh, P("data"))) for k, v in batch.items()}
        state, m = step(state, rows)
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    out[name] = {"metrics": metrics, "state": jax.tree_util.tree_map(np.asarray, state)}
open(sys.argv[2], "wb").write(pickle.dumps(out))
'''


def _batches(cfg) -> list[dict]:
    """Two global batches; the first rows lose more labels than the last.
    Whisper's carry its encoder's frames."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        lab = np.roll(tok, -1, 1)
        lab[0, :9] = -1
        lab[1, ::3] = -1
        lab[B - 1, 5:7] = -1
        out.append({"tokens": tok, "labels": lab})
        if cfg.family == "audio":
            out[-1]["frames"] = rng.standard_normal(
                (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _configs(arch: str, replace: dict):
    return (dataclasses.replace(jget(arch).reduced(), **replace),
            dataclasses.replace(tget(arch).reduced(), **replace))


def _jobs() -> tuple[dict, dict]:
    """Each mesh's reference cases and gloo job."""
    ref, jobs = {m: {} for m in MESHES}, {m: {} for m in MESHES}
    opt = adamw.OptimConfig(**OPT)
    trees = {}
    for name, (arch, mesh, replace, cache_len) in CASES.items():
        jcfg, tcfg = _configs(arch, replace)
        batches = _batches(tcfg)
        key = (arch, tuple(replace.items()))
        if key not in trees:
            trees[key] = jax.tree.map(np.asarray, jloop.init_state(jax.random.key(0), jcfg).params)
        tree = trees[key]
        if name not in SAME_STEP:
            ref[mesh][name] = dict(arch=arch, replace=replace, mesh=MESHES[mesh], opt=OPT,
                                   batches=batches)
        long = None
        if tcfg.family == "ssm":
            long = torch.from_numpy(np.random.default_rng(3).integers(
                0, tcfg.vocab_size, (B, LONG)).astype(np.int32))
        jobs[mesh][name] = dict(cfg=tcfg, tree=tree, opt=opt, cache_len=cache_len,
                                ckpt=name in CKPT_CASE, held=name in HELD_CASES, long=long,
                                batches=[{k: torch.from_numpy(v) for k, v in b.items()}
                                         for b in batches])
    return ref, jobs


def _env(**extra) -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1", **extra}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"jax": {case: ...}, mesh: [rank's results, ...]}``: every job and
    the reference started together, each rank a process."""
    work = tmp_path_factory.mktemp("tp")
    ref, jobs = _jobs()
    procs, logs = [], []

    def start(argv, log, env):
        logs.append(log)
        with open(log, "wb") as f:
            procs.append(subprocess.Popen(argv, env=env, cwd=ROOT, stdout=f,
                                          stderr=subprocess.STDOUT))

    for mesh, cases in ref.items():
        (work / f"ref_in_{mesh}.pkl").write_bytes(pickle.dumps(cases))
        start([sys.executable, "-c", _REFERENCE, str(work / f"ref_in_{mesh}.pkl"),
               str(work / f"ref_{mesh}.pkl")], work / f"ref_{mesh}.log",
              _env(JAX_PLATFORMS="cpu", XLA_FLAGS=REF_XLA_FLAGS))
    for mesh, cases in jobs.items():
        d = work / mesh
        d.mkdir()
        world = math.prod(MESHES[mesh])
        torch.save(dict(kind="tp", mesh=MESHES[mesh], axes=("data", "model"), cases=cases),
                   d / "job.pt")
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
    out = {"jax": {}}
    for mesh in ref:
        out["jax"].update(pickle.loads((work / f"ref_{mesh}.pkl").read_bytes()))
    for mesh in jobs:
        out[mesh] = [torch.load(work / mesh / f"out{r}.pt", weights_only=False)
                     for r in range(math.prod(MESHES[mesh]))]
    return out


def _close(got: torch.Tensor, want, tol: float, label: str) -> None:
    w = np.asarray(want, dtype=np.float64)
    scale = max(float(np.abs(w).max()), 1e-30)
    np.testing.assert_allclose(got.detach().double().numpy() / scale, w / scale, rtol=tol,
                               atol=tol, err_msg=label)


def _rank_rows(mesh: str, rank: int) -> slice:
    dp, tp = MESHES[mesh]
    i = rank // tp
    return slice(i * B // dp, (i + 1) * B // dp)


def _ctx(mesh: str, cfg=None) -> ParallelContext:
    experts = cfg.n_routed_experts if cfg is not None and cfg.moe else 0
    return make_context(MeshShape(MESHES[mesh], ("data", "model")), experts)


@pytest.mark.parametrize("case", CASES)
def test_tp_step_equals_the_jax_mesh_step(runs, case):
    arch, mesh, replace, _ = CASES[case]
    _, tcfg = _configs(arch, replace)
    ref = runs["jax"][SAME_STEP.get(case, case)]
    want = convert.train_state_from_jax(ref["state"], tcfg, "cpu")
    want = {"params": dict(want.params.named_parameters()), "m": want.opt.m, "v": want.opt.v}
    outs = [o["cases"][case] for o in runs[mesh]]
    for r, got in enumerate(outs):
        for i, (gm, wm) in enumerate(zip(got["metrics"], ref["metrics"])):
            for k in ("loss", "grad_norm", "lr"):
                _close(gm[k], wm[k], JAX_TOL, f"rank {r} step {i} {k}")
        for part in ("params", "m", "v"):
            assert got[part].keys() == want[part].keys()
            for n, t in want[part].items():
                _close(got[part][n], t.detach().numpy(), JAX_TOL, f"rank {r} {part} {n}")
                assert torch.equal(got[part][n], outs[0][part][n]), (r, part, n)


@pytest.mark.parametrize("case", CASES)
def test_serving_equals_ctx_none(runs, case):
    _, mesh, _, _ = CASES[case]
    for r, o in enumerate(runs[mesh]):
        res = o["cases"][case]
        rows = _rank_rows(mesh, r)
        assert res["ctx_serve"].shape[1] == B // MESHES[mesh][0]
        _close(res["ctx_serve"], res["none_serve"][:, rows].numpy(), OWN_TOL, f"rank {r} serve")
        _close(res["ctx_zero"], res["none_zero"][rows].numpy(), OWN_TOL, f"rank {r} zero cache")
        if "none_long" in res:
            _close(res["ctx_long"], res["none_long"][rows].numpy(), OWN_TOL, f"rank {r} long")


def _meta_tree(shapes: dict) -> dict:
    """A cache of meta tensors from ``{path: shape}``."""
    tree: dict = {}
    for path, shape in shapes.items():
        *keys, leaf = path.split("/")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = torch.empty(shape, device="meta")
    return tree


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_its_blocks(runs, case):
    arch, mesh, replace, cache_len = CASES[case]
    _, tcfg = _configs(arch, replace)
    dp, tp = MESHES[mesh]
    ctx = _ctx(mesh, tcfg)
    specs = partitioning.local_specs(tcfg, ctx)
    lay = partitioning.tp_layout(tcfg, ctx)
    if tcfg.use_mla:
        # MLA's heads, w_dq and the shared expert split; embed by its D
        # columns; the latents, norms and the router whole; the experts
        # the EP blocks of the reference's layout.
        assert lay.heads and lay.q_lora and lay.shared and lay.embed == "cols"
        for prefix in ("layers", "head_layers/0") + (("mtp/block",) if tcfg.mtp else ()):
            lead = (None,) if prefix == "layers" else ()
            attn = {n: specs[f"{prefix}/attn/{n}"] for n in ("w_dq", "w_uq", "w_uk", "w_uv", "wo")}
            assert attn == {**{n: P(*lead, None, "model") for n in attn},
                            "wo": P(*lead, "model", None)}
        assert {"layers/moe/shared/w_in", "layers/moe/shared/w_out",
                "head_layers/0/ffn/w_in", "head_layers/0/ffn/w_out"} <= specs.keys()
        assert specs["embed"] == P(None, "model") and specs["lm_head"] == P(None, "model")
        assert not [k for k in specs if k.rsplit("/", 1)[-1] in (
            "w_dkv", "kv_norm", "q_norm", "gate")]
        want = partitioning.expert_specs(ctx)
        assert [specs[f"layers/moe/{n}"] for n in ("w_in", "w_gate_h", "w_out")] == [
            P(None, *w) for w in want]
        assert (ctx.fsdp_axis is not None) == (tcfg.n_routed_experts == 6)
    elif tcfg.family == "ssm":
        # The time mix by WKV heads, the channel mix by hidden units and
        # wr's D columns; the token-shift and decay LoRAs and the group
        # norm whole.
        assert lay.wkv and lay.ffn and lay.shift and lay.embed == "rows"
        col, row = P(None, None, "model"), P(None, "model", None)
        assert {k: v for k, v in specs.items() if k.startswith("layers/")} == {
            **{f"layers/tm/{n}": col for n in ("wr", "wk", "wv", "wg")},
            "layers/tm/u": row, "layers/tm/wo": row, "layers/cm/wk": col,
            "layers/cm/wv": row, "layers/cm/wr": col}
    else:
        heads = tcfg.num_heads % tp == 0
        attns = {"audio": ["layers/attn", "layers/cross", "enc_layers/attn"]}.get(
            tcfg.family, ["layers/attn"])
        for attn in attns:
            assert (f"{attn}/wq" in specs) == lay.heads == heads
            assert (f"{attn}/wo" in specs) == heads and (f"{attn}/wk" in specs) == lay.kv
        ffns = ["layers/ffn"] + (["enc_layers/ffn"] if tcfg.family == "audio" else [])
        assert {f"{f}/{n}" for f in ffns for n in ("w_in", "w_out")} | {"embed"} <= specs.keys()
        if tcfg.family == "hybrid":
            # Mamba by inner channels, w_in the same block of xi's and z's.
            assert lay.ssm
            mb = {k.split("/")[-1]: v for k, v in specs.items() if "/mamba/" in k}
            assert mb == {"w_in": P(None, None, "model", parts=2),
                          **{n: P(None, None, "model") for n in ("conv", "w_dt")},
                          **{n: P(None, "model", None) for n in ("w_x", "a_log", "w_out")},
                          **{n: P(None, "model") for n in ("conv_b", "dt_bias", "d_skip")}}
    split = partitioning.port_specs(list(runs[mesh][0]["cases"][case]["blocks"]), specs)
    for o in runs[mesh]:
        res = o["cases"][case]
        assert res["tp_specs"] == specs
        for n, (local, whole) in res["blocks"].items():
            parts = math.prod(ctx.size(e) for e in split.get(n, ()) if e is not None)
            assert math.prod(local) * parts == math.prod(whole), n
        # The cache: the dp rows and the cache_specs block of the whole one.
        _, shapes = res["none_cache"]
        cspecs = partitioning.cache_specs(_meta_tree(shapes), ctx)
        want = {}
        for path, shape in shapes.items():
            spec = cspecs
            for k in path.split("/"):
                spec = spec[k]
            want[path] = tuple(d if e is None else d // ctx.size(e) for d, e in zip(shape, spec))
        def kind(leaf):  # how cache_specs splits a KV cache leaf over TP
            spec = cspecs["scan"].get(leaf, (None,) * 4)
            return "seq" if spec[2] == "model" else "heads" if spec[3] == "model" else None

        kv = "ckv" if tcfg.use_mla else "k"
        marks = {m: kind(leaf) for m, leaf in (("kv_split", kv), ("cross_split", "cross_k"))}
        marks = {m: k for m, k in marks.items() if k is not None}
        if tcfg.use_mla:  # the compressed cache splits by rows only
            assert marks == ({"kv_split": "seq"} if cache_len % tp == 0 else {})
        for got in (res["ctx_cache"], res["ctx_zero_cache"]):
            assert got == (marks, want), case
        assert res["none_cache"] == ({}, shapes)
        lead = shapes["scan/wkv"] if tcfg.family == "ssm" else shapes[f"scan/{kv}"]
        assert lead[1] == B and (tcfg.family == "ssm" or lead[2] == cache_len)


@pytest.mark.parametrize("case", HELD_CASES)
def test_moe_one_device_path_on_expert_blocks(runs, case):
    """A sequence of S - 1 positions does not divide over TP, so every MoE
    layer takes the one-device path: each rank routes the whole batch and
    multiplies its expert blocks' buffers (FSDP-gathered at E = 6), ``y``
    summed over the EP group.  Nothing drops at the reduced capacity
    factor, so under the split context and under its whole-batch view the
    loss and every gradient (summed over dp as the step sums them) equal
    ``ctx=None``'s within 1e-5."""
    mesh = CASES[case][1]
    for r, o in enumerate(runs[mesh]):
        res = o["cases"][case]["held"]
        for view in ("split", "whole"):
            _close(res[view]["loss"], res["none"]["loss"].numpy(), OWN_TOL, f"rank {r} {view}")
            assert res[view]["grads"].keys() == res["none"]["grads"].keys()
            for n, g in res["none"]["grads"].items():
                _close(res[view]["grads"][n], g.numpy(), OWN_TOL, f"rank {r} {view} {n}")


def test_the_cases_cover_every_cache_and_head_layout():
    kinds = set()
    for arch, mesh, replace, cache_len in CASES.values():
        _, tcfg = _configs(arch, replace)
        lay = partitioning.tp_layout(tcfg, _ctx(mesh))
        kinds.add((lay.heads, lay.kv, partitioning.kv_cache_split(tcfg, _ctx(mesh), cache_len)))
    assert kinds == {(True, True, "heads"), (True, False, "seq"), (False, False, "seq"),
                     (True, False, None), (False, False, None)}


@pytest.mark.parametrize("case", CKPT_CASE)
def test_checkpoint_round_trip_restores_every_block(runs, case):
    mesh = CASES[case][1]
    assert all(o["cases"][case]["ckpt_written"] for o in runs[mesh])
    assert all(o["cases"][case]["ckpt_same"] for o in runs[mesh])


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma2-9b", "qwen1.5-4b", "qwen3-0.6b",
                                  "chameleon-34b", "deepseek-v2-236b", "deepseek-v3-671b",
                                  "hymba-1.5b", "rwkv6-1.6b", "whisper-small"])
def test_production_layout(arch):
    """On the 16-wide ``model`` axis: SmolLM's 9 heads and Qwen1.5's 20 stay
    whole, Gemma2's and Qwen3's 16 query heads split with their 8 KV heads
    whole and the cache split by rows, Chameleon's 64 over 8 the same; the
    FFN and the vocabulary split wherever they divide; DeepSeek-V2's and
    V3's 128 MLA heads, ``w_dq``, shared experts and ``embed``'s columns
    split, the compressed cache by rows, V2's 160 experts over ``model``
    with ``D`` over ``data`` and V3's 256 over both axes.  RWKV6's 32 WKV
    heads split 2 a rank, its 7168 hidden units 448 and its vocabulary;
    Hymba's 25 heads over 5 and Whisper's 12 stay whole, Hymba's KV cache
    of 32768 rows and Whisper's self cache of 448 split by rows and its
    cross cache of 1500 stays whole; Hymba's Mamba (3200 channels, 200 a
    rank) and FFN (5504, 344 a rank) and Whisper's FFN (3072, 192 a rank)
    split, neither vocabulary (32001, 51865) does."""
    cfg = tget(arch)
    ctx = make_context(make_production_mesh(), cfg.n_routed_experts if cfg.moe else 0)
    lay = partitioning.tp_layout(cfg, ctx)
    specs = partitioning.local_specs(cfg, ctx)
    split = functools.partial(partitioning.kv_cache_split, cfg, ctx)
    if cfg.family == "ssm":
        assert lay.wkv and lay.ffn and lay.shift and lay.vocab and not lay.heads
        assert (cfg.d_model // cfg.rwkv_head_dim // 16, cfg.d_ff // 16) == (2, 448)
        assert specs["layers/tm/u"] == P(None, "model", None)
        assert specs["embed"] == P("model", None) and specs["lm_head"] == P(None, "model")
        assert split(32768) is None
        return
    if cfg.family in ("hybrid", "audio"):
        assert not (lay.heads or lay.kv or lay.vocab) and lay.ffn
        assert not [k for k in specs if "/attn/" in k or "/cross/" in k]
        assert "embed" not in specs and "lm_head" not in specs
        if cfg.family == "hybrid":
            assert lay.ssm and specs["layers/mamba/w_in"] == P(None, None, "model", parts=2)
            assert (cfg.ssm_expand * cfg.d_model // 16, cfg.d_ff // 16) == (200, 344)
            assert split(32768) == "seq"
        else:
            assert cfg.d_ff // 16 == 192 and "enc_layers/ffn/w_in" in specs
            assert split(448) == "seq" and split(cfg.encoder_seq) is None
        return
    assert lay.heads == (cfg.num_heads % 16 == 0) and not lay.kv
    assert lay.ffn and lay.vocab
    assert partitioning.kv_cache_split(cfg, ctx, 32768) == "seq"
    if cfg.moe:
        specs = partitioning.local_specs(cfg, ctx)
        assert lay.q_lora and lay.shared and lay.embed == "cols"
        experts = {"deepseek-v2-236b": P(None, "model", "data", None),
                   "deepseek-v3-671b": P(None, ("data", "model"), None, None)}[arch]
        assert specs["layers/moe/w_in"] == specs["layers/moe/w_gate_h"] == experts
        assert specs["embed"] == P(None, "model") and "layers/moe/gate" not in specs


def test_one_tp_rank_issues_no_collective(tmp_path):
    with one_rank(tmp_path / "store") as ctx:
        x = torch.ones(2, 3, requires_grad=True)
        assert parallel.tp_copy(x, ctx) is x and parallel.tp_reduce(x, ctx) is x
        assert parallel.tp_gather(x, ctx, 1) is x and torch.equal(parallel.tp_max(x, ctx), x)
        for arch in ("gemma2-9b", "rwkv6-1.6b", "hymba-1.5b", "whisper-small"):
            cfg = tget(arch).reduced()
            batch = {k: torch.from_numpy(v) for k, v in _batches(cfg)[0].items()}
            assert partitioning.tp_layout(cfg, ctx) is None
            state = train_loop.init_state(torch.Generator().manual_seed(0), cfg, ctx,
                                          device="cpu")
            step = train_loop.make_train_step(cfg, adamw.OptimConfig(**OPT), ctx)
            with op_analysis.OpRecorder() as rec:
                with torch.no_grad():
                    logits, cache = model.prefill(state.params, batch, cfg, ctx, cache_len=CACHE)
                    model.decode_step(state.params, logits.argmax(-1), cache, S, cfg, ctx)
                step(state, batch)
            assert rec.n_coll == 0, arch
            assert not [k for k, v in cache.items() if isinstance(v, str)], arch
            assert state.params.tp_specs == {}, arch
