"""The port's sharding rules (``models/partitioning.py``, ``models/parallel.py``,
``launch/mesh.py``) against the JAX package's.

The reference runs in one subprocess over 8 forced host devices, its meshes
built with ``AxisType.Auto`` axes (``jax.make_mesh``'s ``Explicit`` default
is what makes ``tests/test_partitioning.py::TestHint`` fail under jax 0.9):
for every architecture, at its published size and reduced, on meshes
(1, 1), (2, 2), (2, 4), (3, 2) (E divides only the model axis there, so
experts take the FSDP layout) and a (2, 2, 2) pod mesh, it writes the
``PartitionSpec`` of every leaf that ``param_specs``, ``zero1_specs``,
``cache_specs``, ``batch_specs`` and ``balancer_specs`` give, and the
sharding that ``parallel.hint`` puts on arrays whose dimensions do and do
not divide.  The port computes the same on a ``Model`` built on the meta
device (no memory) under a context over a ``MeshShape`` of the same axes;
every leaf's spec must be the reference's, entry for entry.
``choose_ep_axes`` and ``make_context`` are held against the reference on
the production shapes through ``jax.sharding.AbstractMesh``.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from jax.sharding import AbstractMesh

from repro.launch import mesh as jmesh
from repro.models import parallel as jparallel
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.moe_balancer import BalancerState
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model, parallel, partitioning

ROOT = Path(__file__).resolve().parents[1]
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "3x2": ((3, 2), ("data", "model")),
    "pod2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}
SIZES = ("full", "reduced")
BATCH, CACHE_LEN = 8, 128
BATCHES = {"tokens": (8, 64), "labels": (8, 64), "odd": (3, 64), "frames": (8, 16, 32),
           "scalar": ()}
HINTS = [  # (shape, entries); "dp" stands for the context's dp axes
    ((4, 6, 8), ("dp", None, "model")),
    ((6, 6, 8), ("dp", None, "model")),
    ((4, 6, 6), ("dp", None, "model")),
    ((8, 3, 4), (("data", "model"), None)),
    ((4, 3, 4), (("data", "model"), None)),
    ((4, 8, 4, 2), ("dp", None, "model", None)),
    ((4, 8), ("dp", "model")),
    ((3, 8), ("dp", "model")),
    ((4, 2), (None, "model")),
]

_REFERENCE = r'''
import json, math, sys
import jax
from jax.sharding import AxisType, PartitionSpec as P
from repro.configs import ARCH_IDS, get_config
from repro.launch.mesh import make_context
from repro.models import model, parallel, partitioning
from repro.train import train_loop

MESHES, SIZES, BATCH, CACHE_LEN, BATCHES, HINTS = json.loads(sys.argv[1])

def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda s: isinstance(s, P))[0]
    return {"/".join(partitioning._path_keys(path)): enc(s) for path, s in leaves}

key = jax.random.key(0)
cfgs, params, caches = {}, {}, {}
for arch in ARCH_IDS:
    for size in SIZES:
        cfg = get_config(arch)
        cfg = cfg.reduced() if size == "reduced" else cfg
        cfgs[arch, size] = cfg
        params[arch, size] = jax.eval_shape(lambda k: model.init_params(k, cfg), key)
        caches[arch, size] = jax.eval_shape(
            lambda p: model.init_decode_cache(p, cfg, BATCH, CACHE_LEN), params[arch, size])

out = {}
for name, (shape, axes) in MESHES.items():
    mesh = jax.make_mesh(tuple(shape), tuple(axes), axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:math.prod(shape)])
    rec = {}
    for (arch, size), cfg in cfgs.items():
        ctx = make_context(mesh, cfg.n_routed_experts if cfg.moe else 0)
        p_specs = partitioning.param_specs(params[arch, size], cfg, ctx)
        r = {
            "ctx": [list(ctx.dp_axes), ctx.tp_axis, list(ctx.ep_axes), ctx.fsdp_axis],
            "params": flat(p_specs),
            "zero1": flat(partitioning.zero1_specs(p_specs, params[arch, size], ctx)),
            "cache": flat(partitioning.cache_specs(caches[arch, size], ctx)),
        }
        if cfg.moe:
            state = jax.eval_shape(lambda k: train_loop.init_state(k, cfg, ctx), key)
            r["balancer"] = flat(partitioning.balancer_specs(state.balancer, ctx))
        rec[f"{arch}/{size}"] = r
    ctx = make_context(mesh, 0)
    batch = {k: jax.ShapeDtypeStruct(tuple(s), jax.numpy.int32) for k, s in BATCHES.items()}
    rec["batch"] = flat(partitioning.batch_specs(batch, ctx))
    hints = []
    for shape_, entries in HINTS:
        entries = [ctx.dp_axes if e == "dp" else tuple(e) if isinstance(e, list) else e
                   for e in entries]
        y = parallel.hint(jax.numpy.ones(tuple(shape_)), ctx, *entries)
        hints.append(enc(y.sharding.spec))
    rec["hint"] = hints
    out[name] = rec
print(json.dumps(out))
'''


def _enc(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _strip(entries: list) -> list:
    while entries and entries[-1] is None:
        entries = entries[:-1]
    return entries


def _flat(tree, prefix=""):
    if isinstance(tree, parallel.Spec):
        return {prefix[:-1]: _enc(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


@pytest.fixture(scope="module")
def reference():
    args = json.dumps([MESHES, SIZES, BATCH, CACHE_LEN, BATCHES, HINTS])
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_models():
    """Each config's parameters and decode cache on the meta device."""
    out = {}
    for arch in ARCH_IDS:
        for size in SIZES:
            cfg = get_config(arch)
            cfg = cfg.reduced() if size == "reduced" else cfg
            params = model.Model(cfg, device="meta")
            out[arch, size] = (cfg, params, model.init_decode_cache(params, cfg, BATCH, CACHE_LEN))
    return out


def _ctx(mesh_name: str, cfg=None):
    shape, axes = MESHES[mesh_name]
    e = cfg.n_routed_experts if cfg is not None and cfg.moe else 0
    return tmesh.make_context(parallel.MeshShape(shape, axes), e)


CASES = [(a, s, m) for a in ARCH_IDS for s in SIZES for m in MESHES]


@pytest.mark.parametrize("arch,size,mesh", CASES)
def test_param_and_zero1_specs(reference, port_models, arch, size, mesh):
    cfg, params, _ = port_models[arch, size]
    ctx = _ctx(mesh, cfg)
    want = reference[mesh][f"{arch}/{size}"]
    assert [list(ctx.dp_axes), ctx.tp_axis, list(ctx.ep_axes), ctx.fsdp_axis] == want["ctx"]
    p_specs = partitioning.param_specs(params, cfg, ctx)
    got = {k: _enc(v) for k, v in p_specs.items()}
    assert got == want["params"]
    z = partitioning.zero1_specs(p_specs, params, ctx)
    assert {k: _enc(v) for k, v in z.items()} == want["zero1"]


@pytest.mark.parametrize("arch,size,mesh", CASES)
def test_cache_specs(reference, port_models, arch, size, mesh):
    cfg, _, cache = port_models[arch, size]
    got = _flat(partitioning.cache_specs(cache, _ctx(mesh, cfg)))
    assert got == reference[mesh][f"{arch}/{size}"]["cache"]


MOE_CASES = [(a, s, m) for a in ARCH_IDS if get_config(a).moe for s in SIZES for m in MESHES]


@pytest.mark.parametrize("arch,size,mesh", MOE_CASES)
def test_balancer_specs(reference, port_models, arch, size, mesh):
    cfg = port_models[arch, size][0]
    ctx = _ctx(mesh, cfg)
    state = BalancerState.init(model.num_scanned_layers(cfg), cfg.n_routed_experts, "meta",
                               dispatchers=(ctx.dp_size, ctx.tp_size))
    got = {k: _enc(v) for k, v in partitioning.balancer_specs(state, ctx).items()}
    assert got == reference[mesh][f"{arch}/{size}"]["balancer"]


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_specs(reference, mesh):
    batch = {k: torch.empty(s, device="meta") for k, s in BATCHES.items()}
    got = {k: _enc(v) for k, v in partitioning.batch_specs(batch, _ctx(mesh)).items()}
    assert got == reference[mesh]["batch"]


@pytest.mark.parametrize("mesh", MESHES)
def test_hint_downgrades_what_does_not_divide(reference, mesh):
    ctx = _ctx(mesh)
    for (shape, entries), want in zip(HINTS, reference[mesh]["hint"], strict=True):
        entries = [ctx.dp_axes if e == "dp" else e for e in entries]
        got = parallel.divisible(entries, shape, ctx.shape)
        assert _strip(_enc(got)) == _strip(want), (shape, entries)
        x = torch.empty(shape, device="meta")
        assert parallel.hint(x, ctx, *entries) is x
        assert parallel.hint(x, None, *entries) is x


PRODUCTION = {"prod": ((16, 16), ("data", "model")),
              "prod_pod": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("e", [160, 256, 8, 6, 7])
@pytest.mark.parametrize("mesh", [*MESHES, *PRODUCTION])
def test_choose_ep_axes(e, mesh):
    shape, axes = {**MESHES, **PRODUCTION}[mesh]
    if mesh in PRODUCTION:
        got = tmesh.make_production_mesh(multi_pod=mesh == "prod_pod")
        assert got == parallel.MeshShape(shape, axes)
    jm = AbstractMesh(shape, axes)
    dp = tuple(a for a in axes if a != "model")
    try:
        want = jparallel.choose_ep_axes(jm, e, dp, "model")
    except ValueError:
        with pytest.raises(ValueError, match="not divisible"):
            parallel.choose_ep_axes(parallel.MeshShape(shape, axes), e, dp, "model")
        return
    assert parallel.choose_ep_axes(parallel.MeshShape(shape, axes), e, dp, "model") == want
    got = tmesh.make_context(parallel.MeshShape(shape, axes), e)
    ref = jmesh.make_context(jm, e)
    assert (got.dp_axes, got.tp_axis, got.ep_axes, got.fsdp_axis) == (
        ref.dp_axes, ref.tp_axis, ref.ep_axes, ref.fsdp_axis)
    assert (got.ep_size, got.dp_size, got.tp_size) == (ref.ep_size, ref.dp_size, ref.tp_size)


def test_production_mesh_specs_shard_deepseek_experts():
    """On the 16 x 16 production shape DeepSeek-V2's 160 experts take the
    FSDP layout and V3's 256 spread over the whole mesh, as in the JAX
    package's dry run."""
    mesh = tmesh.make_production_mesh()
    for arch, want in (("deepseek-v2-236b", ("model", "data", None)),
                       ("deepseek-v3-671b", (("data", "model"), None, None))):
        cfg = get_config(arch)
        ctx = tmesh.make_context(mesh, cfg.n_routed_experts)
        specs = partitioning.param_specs(model.Model(cfg, device="meta"), cfg, ctx)
        assert specs["layers/moe/w_in"] == (None, *want)
        assert math.prod(ctx.shape.values()) == 256


def test_to_shardings_gives_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = parallel.MeshShape((2, 2, 2), ("pod", "data", "model"))
    tree = {"a": parallel.Spec(("pod", "data"), None, "model"),
            "b": {"c": parallel.Spec(None, "data")}, "d": parallel.Spec()}
    got = partitioning.to_shardings(tree, mesh)
    assert got == {"a": (Shard(0), Shard(0), Shard(2)),
                   "b": {"c": (Replicate(), Shard(1), Replicate())},
                   "d": (Replicate(),) * 3}


def test_a_mesh_shape_has_no_ranks():
    ctx = _ctx("2x2")
    with pytest.raises(ValueError, match="no ranks"):
        ctx.index("data")
    with pytest.raises(ValueError, match="no process groups"):
        ctx.group(("data", "model"))
    assert parallel.Spec(("model",), None) == ("model", None)
