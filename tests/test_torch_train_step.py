"""The port's train step (``train/train_loop.py``) against the JAX package's
on the CPU, and its launcher and example.

Both packages start from one state: the JAX ``init_state`` carried across
by ``convert.train_state_from_jax``.  Two steps run on the same data
pipeline batches (the JAX step under ``jax.jit``), with the balancer-sync
program off and on and with 1 and 2 microbatches, at SmolLM-135M's and
DeepSeek-V2's reduced configs (float32; DeepSeek with the CARE balancer
under ET-2, so the trigger and the counts move).  After each step the
loss, ``grad_norm``, ``lr``, every parameter, ``m`` and ``v``, the balancer
and the sync trigger are compared: floats within 1e-4 (rtol and atol)
after scaling each leaf by its largest magnitude (the gradients' float32
sums run in another order), the trigger, the steps and the routed counts
(the balancer's ``true_counts``) equal.  AdamW's ``eps`` is 1e-4 here: at
the default 1e-8 the first step's update ``g / (|g| + eps)`` is the sign of
every gradient above ~1e-8, so the float32 noise of a reordered gradient
sum (~1e-9 on a gradient of 1e-8) moves such a parameter by a tenth of
``lr``; at 1e-4 the update is a smooth function of the gradient and the
comparison tests the arithmetic.  ``tests/test_torch_optim.py`` holds the
default ``eps`` on identical gradients.  ``launch.train`` crashes at step 4
and resumes as ``tests/test_substrate.py``'s driver test does, and its
resumed losses equal an uninterrupted run's; ``examples/train_moe_care``
runs on the CPU at ``tests/test_examples.py``'s sizes.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import CareConfig as JCare
from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro.train import train_loop as jloop
from repro_torch.ckpt import checkpoint
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import CareConfig as TCare
from repro_torch.examples import train_moe_care
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_loop
from torch_ranks import one_rank

RTOL, ATOL = 1e-4, 1e-4
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=4, eps=1e-4)
CARE = dict(enabled=True, comm="et", x=2)


def _close(got: torch.Tensor, want, label: str) -> None:
    w = np.asarray(want, dtype=np.float64)
    scale = max(float(np.abs(w).max()), 1e-30)
    np.testing.assert_allclose(got.detach().double().numpy() / scale, w / scale, rtol=RTOL,
                               atol=ATOL, err_msg=label)


def _configs(arch: str):
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    if jcfg.moe:
        jcfg = dataclasses.replace(jcfg, care=JCare(**CARE))
        tcfg = dataclasses.replace(tcfg, care=TCare(**CARE))
    return jcfg, tcfg


@pytest.mark.parametrize("arch,sync,micro", [
    ("smollm-135m", False, 1), ("smollm-135m", True, 2),
    ("deepseek-v2-236b", False, 1), ("deepseek-v2-236b", True, 1),
    ("deepseek-v2-236b", False, 2), ("deepseek-v2-236b", True, 2),
])
def test_train_step_matches_jax(arch, sync, micro):
    jcfg, tcfg = _configs(arch)
    jstate = jloop.init_state(jax.random.key(0), jcfg)
    tstate = convert.train_state_from_jax(jstate, tcfg, "cpu")
    jstep = jax.jit(jloop.make_train_step(jcfg, jadamw.OptimConfig(**OPT), None, sync=sync,
                                          microbatches=micro))
    tstep = train_loop.make_train_step(tcfg, tadamw.OptimConfig(**OPT), None, sync=sync,
                                       microbatches=micro)
    dcfg = jpipe.DataConfig(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=4)
    for i in range(2):
        batch = jpipe.global_batch_at(i, dcfg)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        for key in ("loss", "grad_norm", "lr"):
            _close(tm[key], jm[key], f"step {i} {key}")
        assert bool(tm["sync_trigger"]) == bool(jm["sync_trigger"])
        assert int(tstate.step) == int(jstate.step) == int(tstate.opt.step) == i + 1
        want = convert.train_state_from_jax(jstate, tcfg, "cpu")
        for name, p in tstate.params.named_parameters():
            _close(p, dict(want.params.named_parameters())[name].detach(), f"step {i} {name}")
            _close(tstate.opt.m[name], want.opt.m[name], f"step {i} m {name}")
            _close(tstate.opt.v[name], want.opt.v[name], f"step {i} v {name}")
        if tcfg.moe:
            tb, jb = tstate.balancer, jstate.balancer
            np.testing.assert_array_equal(tb.true_counts.numpy(), np.asarray(jb.true_counts))
            assert int(tb.steps_since_sync) == int(jb.steps_since_sync)
            for f in ("load_approx", "true_load", "bias"):
                _close(getattr(tb, f), getattr(jb, f), f"step {i} balancer {f}")


def test_init_state_turns_on_grads_and_zero_moments(tmp_path):
    cfg = tget("deepseek-v2-236b").reduced()
    state = train_loop.init_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert all(p.requires_grad for p in state.params.parameters())
    assert all(float(m.abs().sum()) == 0 for m in state.opt.m.values())
    assert state.balancer.true_counts.shape == (1, cfg.n_routed_experts)
    assert state.step.dtype == state.opt.step.dtype == torch.int32
    # Under a (1, 1) context: the same parameters, a (L, 1, 1, E) balancer,
    # whole moments keyed by the JAX leaves' paths (ZeRO-1 over one rank).
    with one_rank(tmp_path / "store", cfg.n_routed_experts) as ctx:
        got = train_loop.init_state(torch.Generator().manual_seed(0), cfg, ctx, device="cpu")
        whole = tadamw.gather_state(got.opt, got.params, ctx)
    assert got.balancer.true_counts.shape == (1, 1, 1, cfg.n_routed_experts)
    assert got.opt.m["layers/moe/w_in"].shape == (1, *state.params.layers[0].moe.w_in.shape)
    for name, p in state.params.named_parameters():
        assert torch.equal(dict(got.params.named_parameters())[name], p)
        assert torch.equal(whole.m[name], state.opt.m[name])


def test_launch_train_crash_restart_resumes_the_stream(tmp_path):
    args = ["--arch", "smollm-135m", "--steps", "8", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path / "a"), "--ckpt-every", "2", "--log-every", "0",
            "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        tlaunch.main(args + ["--crash-at", "4"])
    assert e.value.code == 42
    assert checkpoint.latest_step(tmp_path / "a") == 4
    out = tlaunch.main(args)
    assert out["start_step"] == 4 and len(out["losses"]) == 4
    assert np.isfinite(out["final_loss"])
    whole = tlaunch.main([a if a != str(tmp_path / "a") else str(tmp_path / "b") for a in args])
    assert whole["start_step"] == 0
    np.testing.assert_allclose(out["losses"], whole["losses"][4:], rtol=1e-6)


def test_launch_train_moe_picks_the_sync_program(capsys):
    out = tlaunch.main(["--arch", "deepseek-v2-236b", "--steps", "4", "--batch", "2",
                        "--seq", "16", "--log-every", "2", "--device", "cpu"])
    assert np.isfinite(out["final_loss"]) and 0 <= out["syncs"] <= 4
    assert "sync=" in capsys.readouterr().out


def test_train_moe_care_example_on_the_cpu(capsys):
    train_moe_care.main(["--steps", "6", "--batch", "2", "--seq", "32", "--ckpt-every", "2",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[done]" in out and "resumed from checkpoint at step 2" in out
