"""The port's checkpoints (``ckpt/checkpoint.py``) on the CPU: round trip,
rotation, the atomic replace, async save, the errors, and checkpoints
crossing between the two packages.

A checkpoint the JAX package writes (``repro.ckpt.checkpoint.save`` of its
``TrainState`` after two train steps: nonzero moments and balancer)
restores into the port bit for bit, float32 and bfloat16 alike (the
bfloat16 leaves as their raw patterns), and equals
``convert.train_state_from_jax`` of the same state; a float32 one the port
writes restores into the JAX package.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import get_config as jget
from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro.train import train_loop as jloop
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config as tget
from repro_torch.data import pipeline as tpipe
from repro_torch.models import convert
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_loop


def _state(arch: str, seed: int = 0, **over):
    cfg = dataclasses.replace(tget(arch).reduced(), **over)
    return cfg, train_loop.init_state(torch.Generator().manual_seed(seed), cfg, device="cpu")


def _tensors(state) -> dict:
    out = {f"p.{n}": p.detach() for n, p in state.params.named_parameters()}
    out.update({f"m.{n}": t for n, t in state.opt.m.items()})
    out.update({f"v.{n}": t for n, t in state.opt.v.items()})
    out["opt_step"], out["step"] = state.opt.step, state.step
    if state.balancer is not None:
        out.update({f"b.{f.name}": getattr(state.balancer, f.name)
                    for f in dataclasses.fields(state.balancer)})
    return out


def _equal(a, b) -> None:
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype, k
        assert torch.equal(ta[k], tb[k]), k


def _stepped(arch: str, steps: int = 1, **over):
    cfg, state = _state(arch, **over)
    step = train_loop.make_train_step(cfg, tadamw.OptimConfig(lr=1e-2))
    dcfg = tpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    for i in range(steps):
        batch = tpipe.global_batch_at(i, dcfg)
        if cfg.family == "audio":
            batch["frames"] = np.random.default_rng(i).standard_normal(
                (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        state, _ = step(state, batch)
    return cfg, state


@pytest.mark.parametrize("arch,over", [("deepseek-v2-236b", {}),
                                       ("smollm-135m", dict(param_dtype="bfloat16",
                                                            compute_dtype="bfloat16")),
                                       ("whisper-small", {})])
def test_round_trip(tmp_path, arch, over):
    cfg, state = _stepped(arch, **over)
    ckpt.save(state, tmp_path, 7, extra={"note": "x"})
    manifest = json.loads((tmp_path / "step-7" / "manifest.json").read_text())
    assert manifest["step"] == 7 and manifest["extra"] == {"note": "x"}
    _, fresh = _state(arch, seed=1, **over)
    restored, step = ckpt.restore(fresh, tmp_path)
    assert step == 7 and restored is fresh
    _equal(restored, state)


def test_rotation_and_atomic_replace(tmp_path):
    _, state = _state("smollm-135m")
    for s in (1, 2, 3, 4):
        ckpt.save(state, tmp_path, s, keep=2)
    assert ckpt.all_steps(tmp_path) == [3, 4] and ckpt.latest_step(tmp_path) == 4
    (tmp_path / "tmp-9").mkdir()  # a save that died before its replace
    (tmp_path / "tmp-9" / "arrays.npz").write_bytes(b"torn")
    assert ckpt.latest_step(tmp_path) == 4
    with torch.no_grad():
        state.params.embed.add_(1.0)
    ckpt.save(state, tmp_path, 4, keep=2)  # replaces step 4 whole
    assert ckpt.all_steps(tmp_path) == [3, 4]
    _, fresh = _state("smollm-135m", seed=3)
    ckpt.restore(fresh, tmp_path)
    assert torch.equal(fresh.params.embed, state.params.embed)
    ckpt.save(state, tmp_path, 9, keep=2)  # a leftover tmp-9 is cleared first
    assert ckpt.all_steps(tmp_path) == [4, 9] and not (tmp_path / "tmp-9").exists()


def test_async_save_snapshots_first(tmp_path):
    _, state = _state("deepseek-v2-236b")
    before = state.params.embed.detach().clone()
    t = ckpt.async_save(state, tmp_path, 5)
    with torch.no_grad():
        state.params.embed.add_(1.0)  # the caller moves on at once
    ckpt.wait_pending()
    assert not t.is_alive()
    _, fresh = _state("deepseek-v2-236b", seed=1)
    ckpt.restore(fresh, tmp_path, 5)
    assert torch.equal(fresh.params.embed, before)


def test_errors(tmp_path):
    _, state = _state("smollm-135m")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state, tmp_path)
    ckpt.save(state, tmp_path, 1)
    _, wider = _state("smollm-135m", d_ff=320)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(wider, tmp_path)
    _, moe = _state("deepseek-v2-236b")
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore(moe, tmp_path)


def _jax_state(arch: str, **over):
    cfg = dataclasses.replace(jget(arch).reduced(), **over)
    state = jloop.init_state(jax.random.key(0), cfg)
    step = jax.jit(jloop.make_train_step(cfg, jadamw.OptimConfig(lr=1e-2)))
    dcfg = jpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    for i in range(2):
        state, _ = step(state, jpipe.global_batch_at(i, dcfg))
    return state


@pytest.mark.parametrize("arch,over", [("deepseek-v2-236b", {}),
                                       ("smollm-135m", dict(param_dtype="bfloat16",
                                                            compute_dtype="bfloat16"))])
def test_jax_written_checkpoint_restores_in_the_port(tmp_path, arch, over):
    jstate = _jax_state(arch, **over)
    jckpt.save(jstate, tmp_path, 2)
    cfg, fresh = _state(arch, seed=5, **over)
    restored, step = ckpt.restore(fresh, tmp_path)
    assert step == 2
    _equal(restored, convert.train_state_from_jax(jstate, cfg, "cpu"))
    # and the port writes what the JAX package wrote
    ckpt.save(restored, tmp_path / "port", 2)
    a = np.load(tmp_path / "step-2" / "arrays.npz")
    b = np.load(tmp_path / "port" / "step-2" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype.str == b[k].dtype.str and a[k].tobytes() == b[k].tobytes(), k


def test_port_written_float32_checkpoint_restores_in_jax(tmp_path):
    jstate = _jax_state("deepseek-v2-236b")
    cfg = tget("deepseek-v2-236b").reduced()
    ckpt.save(convert.train_state_from_jax(jstate, cfg, "cpu"), tmp_path, 2)
    like = jloop.init_state(jax.random.key(9), jget("deepseek-v2-236b").reduced())
    restored, step = jckpt.restore(like, tmp_path)
    assert step == 2
    for x, y in zip(jax.tree.leaves(restored), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
