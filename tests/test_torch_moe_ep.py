"""The port's expert-parallel MoE path over CPU ranks (gloo) against the JAX
package's one-device reference.

Each test starts 2 or 4 rank processes (``tests/torch_ranks.py``) that
join through a file store, build a DeviceMesh and the parallel context
``launch/mesh.make_context`` gives it, and run the job; every rank's
results come back to this process.

* ``moe_ffn`` at a narrow MoE config (the reduced DeepSeek-V2: d_model
  128, top-2, expert hidden 64, one shared expert) on meshes where E
  divides the whole mesh (pure EP: (1, 2), (2, 1), (2, 2), (1, 4) and a
  (2, 1, 2) pod mesh, whose pods replicate the experts) and where it
  divides only the model axis (EP+FSDP: E = 6 on (2, 2)), at capacity
  factors that drop tokens (1.0, 1.5) and that do not (4.0).  Each rank
  is one dispatcher: its block ``x[dp, tp]`` with its bias row, and its
  capacity is its own block's.  So the reference is the JAX package's
  ``moe_ffn`` without a context on each block with that block's bias row:
  every rank's ``(DP, TP, E)`` counts equal the blocks' counts bit for
  bit, its ``y`` (gathered whole) is within 1e-4, and the gradients of
  ``sum(y * cot)`` with respect to ``x`` and every weight (``jax.grad`` of
  the same sum over blocks) are within 1e-4 of each leaf's largest
  magnitude, the same on every rank.
* The reduced DeepSeek-V2 under a (2, 2) context (pure EP and, at E = 6,
  EP+FSDP) and a (1, 2) context, against the same model without one:
  prefill and two decode steps, then one train step (balancer sync on).
  At the reduced config's capacity factor (4.0) no token is dropped, so
  the whole-batch step and the per-dispatcher one route the same tokens:
  logits, loss, ``grad_norm``, parameters and the AdamW moments (ZeRO-1
  blocks gathered) within 1e-4, and the dispatchers' counts summed equal
  to the whole batch's counts bit for bit.
* Every architecture's entry points under a (1, 1) context in this
  process against no context, bit for bit.
* ``launch.train --mesh 1,2`` on two ranks (torchrun's environment),
  crashed at step 2 and resumed, against an uninterrupted run on the same
  mesh, and its first loss against one process without a mesh.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import ffn as jffn
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import CareConfig
from repro_torch.launch import train as tlaunch
from repro_torch.models import ffn as tffn
from repro_torch.models import model
from repro_torch.optim import adamw
from torch_ranks import one_rank

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_ranks.py"
TIMEOUT_S = 180  # per test, all ranks together
RTOL, ATOL = 1e-4, 1e-4

MOE_CASES = {  # world, mesh, axes, E, capacity factor
    "2r-1x2-ep": (2, (1, 2), ("data", "model"), 8, 1.0),
    "2r-2x1-ep": (2, (2, 1), ("data", "model"), 8, 4.0),
    "4r-2x2-ep": (4, (2, 2), ("data", "model"), 8, 1.0),
    "4r-1x4-ep": (4, (1, 4), ("data", "model"), 8, 1.5),
    "4r-2x2-fsdp": (4, (2, 2), ("data", "model"), 6, 1.0),
    "4r-2x2-fsdp-nodrop": (4, (2, 2), ("data", "model"), 6, 4.0),
    "4r-pod2x1x2-ep": (4, (2, 1, 2), ("pod", "data", "model"), 8, 1.5),
}
MODEL_CASES = {  # world, mesh, E
    "4r-2x2-ep": (4, (2, 2), 8),
    "4r-2x2-fsdp": (4, (2, 2), 6),
    "2r-1x2-ep": (2, (1, 2), 8),
}


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}


def _start(argv: list, log: Path, env: dict) -> subprocess.Popen:
    with open(log, "wb") as f:
        return subprocess.Popen(argv, env=env, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)


def _wait(procs, logs, label: str, codes=None) -> None:
    """Wait for every rank (all within ``TIMEOUT_S``; killed past it) and
    check their exit codes (0 unless ``codes`` says otherwise)."""
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log, code) in enumerate(zip(procs, logs, codes or [0] * len(procs))):
        assert p.returncode == code, (
            f"{label} rank {r} exit {p.returncode}:\n{log.read_text(errors='replace')[-4000:]}")


def _run_ranks(work: Path, world: int, job: dict) -> list[dict]:
    torch.save(job, work / "job.pt")
    logs = [work / f"rank{r}.log" for r in range(world)]
    procs = [_start([sys.executable, str(WORKER), str(r), str(world), str(work)], logs[r], _env())
             for r in range(world)]
    _wait(procs, logs, job["kind"])
    return [torch.load(work / f"out{r}.pt", weights_only=False) for r in range(world)]


def _close(got: torch.Tensor, want, label: str) -> None:
    w = np.asarray(want, dtype=np.float64)
    scale = max(float(np.abs(w).max()), 1e-30)
    np.testing.assert_allclose(got.detach().double().numpy() / scale, w / scale, rtol=RTOL,
                               atol=ATOL, err_msg=label)


def _jax_tree(p: tffn.MoEFFN) -> dict:
    tree = {}
    for name, t in p.state_dict().items():
        *head, leaf = name.split(".")
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = jnp.asarray(t.numpy())
    return tree


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_ffn_over_ranks_equals_one_device_blocks(tmp_path, case):
    world, mesh, axes, e, factor = MOE_CASES[case]
    tcfg = dataclasses.replace(tget("deepseek-v2-236b").reduced(), n_routed_experts=e,
                               moe_capacity_factor=factor)
    jcfg = dataclasses.replace(jget("deepseek-v2-236b").reduced(), n_routed_experts=e,
                               moe_capacity_factor=factor)
    p = tffn.MoEFFN(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    dp, tp = int(np.prod(mesh[:-1])), mesh[-1]
    b, s, d = 4, 8, tcfg.d_model
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    bias = rng.standard_normal((dp, tp, e)).astype(np.float32)
    cot = rng.standard_normal((b, s, d)).astype(np.float32)
    outs = _run_ranks(tmp_path, world, dict(
        kind="moe", cfg=tcfg, mesh=mesh, axes=axes, params=p.state_dict(),
        x=torch.from_numpy(x), bias=torch.from_numpy(bias), cot=torch.from_numpy(cot)))

    bl, sl = b // dp, s // tp
    blocks = [(i, j, np.s_[i * bl:(i + 1) * bl, j * sl:(j + 1) * sl])
              for i in range(dp) for j in range(tp)]

    def loss(jp, jx):
        total, ys, counts = 0.0, [], []
        for i, j, blk in blocks:
            y, c = jffn.moe_ffn(jp, jx[blk], jnp.asarray(bias[i, j]), jcfg)
            total = total + jnp.sum(y * cot[blk])
            ys.append(y)
            counts.append(c)
        return total, (ys, counts)

    (_, (ys, counts)), (g_p, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        _jax_tree(p), jnp.asarray(x))
    want_y = np.zeros_like(x)
    for (_, _, blk), y in zip(blocks, ys):
        want_y[blk] = np.asarray(y)
    want_counts = np.stack([np.asarray(c) for c in counts]).reshape(dp, tp, e)
    assert (want_counts.sum(-1) == bl * sl * tcfg.moe_top_k).all()

    fsdp = e % (dp * tp) != 0
    for r, out in enumerate(outs):
        assert out["ctx"]["fsdp_axis"] == ("data" if fsdp else None), out["ctx"]
        assert out["ctx"]["grid"] == r
        assert out["hint"] == (True, True)  # a DTensor laid out as hinted, and one not
        np.testing.assert_array_equal(out["counts"].numpy(), want_counts, err_msg=f"rank {r}")
        _close(out["y"], want_y, f"rank {r} y")
        _close(out["x_grad"], g_x, f"rank {r} dx")
        for name, g in out["grads"].items():
            want = g_p
            for k in name.split("."):
                want = want[k]
            _close(g, want, f"rank {r} d{name}")
        assert torch.equal(out["y"], outs[0]["y"])
        for name, g in out["grads"].items():
            assert torch.equal(g, outs[0]["grads"][name]), name


@pytest.mark.parametrize("case", MODEL_CASES)
def test_deepseek_under_a_context_equals_no_context(tmp_path, case):
    world, mesh, e = MODEL_CASES[case]
    cfg = dataclasses.replace(tget("deepseek-v2-236b").reduced(), n_routed_experts=e,
                              care=CareConfig(enabled=True, comm="et", x=2))
    b, s = 4, 16
    for t in (b * s // world, b * s):  # no token dropped, per dispatcher or whole
        assert tffn._capacity(t, cfg.moe_top_k, e, cfg.moe_capacity_factor) >= t
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int64))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    outs = _run_ranks(tmp_path, world, dict(
        kind="model", cfg=cfg, mesh=mesh, axes=("data", "model"), seed=0, batch=batch,
        sync=True, opt=adamw.OptimConfig(lr=1e-2, warmup_steps=1, total_steps=4, eps=1e-4)))
    dp, tp = mesh
    for r, o in enumerate(outs):
        _close(o["ctx_serve"], o["none_serve"].numpy(), f"rank {r} logits")
        for k in ("loss", "grad_norm", "lr"):
            _close(o["ctx_metrics"][k], o["none_metrics"][k].numpy(), f"rank {r} {k}")
        assert bool(o["ctx_metrics"]["sync_trigger"]) == bool(o["none_metrics"]["sync_trigger"])
        for part in ("params", "m", "v"):
            want = o[f"none_{part}"]
            assert o[f"ctx_{part}"].keys() == want.keys()
            for n, t in want.items():
                _close(o[f"ctx_{part}"][n], t.numpy(), f"rank {r} {part} {n}")
        bal, none = o["ctx_balancer"], o["none_balancer"]
        assert bal["true_counts"].shape == (1, dp, tp, e)
        np.testing.assert_array_equal(bal["true_counts"].sum((1, 2)).numpy(),
                                      none["true_counts"].numpy())
        # ZeRO-1: the embedding's moments (V, D), laid out (dp, tp) when both divide.
        v, d = cfg.vocab_size, cfg.d_model
        assert o["ctx_opt_blocks"]["embed"] == (v // dp, d // tp)
        for n, t in o["ctx_params"].items():
            assert torch.equal(t, outs[0]["ctx_params"][n]), (r, n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launch_train_on_a_mesh_resumes(tmp_path):
    """Crashed at step 2 and resumed, the two ranks' losses equal an
    uninterrupted mesh run's; its first loss (the balancer's bias still
    zero) equals one process's without a mesh.  Later losses differ from
    that run by design: each dispatcher's balancer emulates its own load."""
    args = ["--arch", "deepseek-v2-236b", "--steps", "4", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--log-every", "0", "--device", "cpu", "--lr", "1e-2"]
    one = tlaunch.main(args)
    code = ("import json, sys; from repro_torch.launch import train; "
            "out = train.main(sys.argv[1:]); print('LOSSES', json.dumps(out['losses']))")

    def launch(label, extra, codes=(0, 0)):
        port = _free_port()
        logs = [tmp_path / f"{label}{r}.log" for r in range(2)]
        procs = [_start([sys.executable, "-c", code, *args, "--mesh", "1,2", *extra], logs[r],
                        {**_env(), "RANK": str(r), "WORLD_SIZE": "2",
                         "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
                 for r in range(2)]
        _wait(procs, logs, f"launch.train {label}", list(codes))
        if codes[0]:
            return None
        return [np.array(json.loads([ln for ln in log.read_text().splitlines()
                                     if ln.startswith("LOSSES")][-1].split(" ", 1)[1]))
                for log in logs]

    whole = launch("whole", [])
    ckpt = ["--ckpt-dir", str(tmp_path / "ckpt")]
    launch("crash", ckpt + ["--crash-at", "2"], (42, 42))
    resumed = launch("resume", ckpt)
    for w, r in zip(whole, resumed):
        np.testing.assert_array_equal(w, whole[0])
        np.testing.assert_allclose(r, w[2:], rtol=1e-6, atol=0)
    np.testing.assert_allclose(whole[0][0], one["losses"][0], rtol=1e-5)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_family_takes_a_one_rank_context(tmp_path, arch):
    """Every entry point that takes a context (prefill, decode_step,
    init_decode_cache, train_loss) gives the ``ctx=None`` result on a
    (1, 1) mesh, bit for bit; a MoE model's counts come as one
    dispatcher's ``(L, 1, 1, E)`` rows."""
    cfg = tget(arch).reduced()
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(5)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int64))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))

    def run(ctx):
        with torch.no_grad():
            logits, cache = model.prefill(params, batch, cfg, ctx, cache_len=10)
            out = [logits]
            for pos in (8, 9):
                logits, cache = model.decode_step(params, torch.argmax(out[-1], -1), cache, pos,
                                                  cfg, ctx)
                out.append(logits)
            if cfg.family != "audio":
                empty = model.init_decode_cache(params, cfg, 2, 4, ctx)
                out.append(model.decode_step(params, tok[:, 0], empty, 0, cfg, ctx)[0])
        loss, aux = model.train_loss(params, batch, cfg, ctx)
        return torch.stack(out), loss, aux["counts"]

    want = run(None)
    with one_rank(tmp_path / "store", cfg.n_routed_experts if cfg.moe else 0) as ctx:
        got = run(ctx)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    if cfg.moe:
        assert torch.equal(got[2], want[2][:, None, None, :])
    else:
        assert got[2] is None and want[2] is None
