"""Checkpointing: atomic, rotating ``.npz`` trees of a training state.

Port of ``repro/ckpt/checkpoint.py``, with its on-disk format, so that a
checkpoint the JAX package writes restores into the port:

* the state is flattened to ``path -> array`` with the JAX package's
  '/'-joined key paths of the same ``TrainState`` (``params/...``,
  ``opt/m/...``, ``opt/v/...``, ``opt/step``, ``balancer/<field>``,
  ``step``), the scanned layers stacked on a leading axis as the JAX tree
  stacks them (``params/layers/attn/wq`` is ``(L, D, H dh)``; whisper's
  ``enc_layers`` too; ``head_layers/<i>`` and ``mtp`` are not stacked);
* ``step-<n>/arrays.npz`` plus ``manifest.json`` (step, each array's
  shape and dtype, ``extra``) are written under ``tmp-<n>`` and moved to
  ``step-<n>`` with ``os.replace`` (atomic on POSIX), so a crash mid-save
  never corrupts the latest checkpoint;
* ``keep`` rotates old checkpoints; ``async_save`` copies the state to
  host memory first, then writes on a background thread.

bfloat16 leaves: numpy has no bfloat16 without ``ml_dtypes``, which the
card's machine does not have.  The rule here: a bfloat16 array is written
as its raw 2-byte patterns, numpy dtype ``'<V2'`` (what ``np.savez`` writes
for the JAX package's ``ml_dtypes`` bfloat16), with dtype ``"bfloat16"`` in
the manifest; on restore an array the manifest calls bfloat16 is read back
bit for bit from those patterns.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.models.partitioning import STACKED, jax_param_paths

_BF16 = "bfloat16"


def _state_paths(state) -> dict[str, tuple[list, bool]]:
    """``{path: (tensors, stacked)}`` of a ``train_loop.TrainState``."""
    named = dict(state.params.named_parameters())
    paths: dict[str, tuple[list, bool]] = {}
    for prefix, tree in (("params", named), ("opt/m", state.opt.m), ("opt/v", state.opt.v)):
        for key, ts in jax_param_paths(tree).items():
            stacked = key.split("/", 1)[0] in STACKED
            paths[f"{prefix}/{key}"] = (ts, stacked)
    paths["opt/step"] = ([state.opt.step], False)
    if state.balancer is not None:
        for field in ("load_approx", "true_load", "true_counts", "bias", "steps_since_sync"):
            paths[f"balancer/{field}"] = ([getattr(state.balancer, field)], False)
    paths["step"] = ([state.step], False)
    return paths


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (a CPU tensor is cloned: its numpy view would share it)."""
    t = t.detach()
    t = t.clone() if t.device.type == "cpu" else t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view("V2")
    return t.numpy()


def flatten(state) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """The state as host arrays ``{path: array}`` and their dtype names."""
    arrays, dtypes = {}, {}
    for path, (ts, stacked) in _state_paths(state).items():
        t = torch.stack([x.detach() for x in ts]) if stacked else ts[0]
        arrays[path] = _to_numpy(t)
        dtypes[path] = _BF16 if t.dtype == torch.bfloat16 else str(arrays[path].dtype)
    return arrays, dtypes


def _write(flat, directory, step: int, keep: int, extra: dict | None) -> Path:
    arrays, dtypes = flat
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"tmp-{step}"
    final = directory / f"step-{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {
        "step": step,
        "arrays": {k: {"shape": list(v.shape), "dtype": dtypes[k]} for k, v in arrays.items()},
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    for s in sorted(all_steps(directory))[:-keep]:
        shutil.rmtree(directory / f"step-{s}", ignore_errors=True)
    return final


def save(state, directory: str | os.PathLike, step: int, *, keep: int = 3,
         extra: dict | None = None) -> Path:
    """Atomically write ``state`` under ``directory/step-<step>``."""
    return _write(flatten(state), directory, step, keep, extra)


_PENDING: list[threading.Thread] = []


def async_save(state, directory, step: int, *, keep: int = 3,
               extra: dict | None = None) -> threading.Thread:
    """Save on a background thread.  The state is copied to host memory
    before the thread starts, so the caller may update it at once."""
    flat = flatten(state)
    t = threading.Thread(target=_write, args=(flat, directory, step, keep, extra), daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending():
    for t in _PENDING:
        t.join()
    _PENDING.clear()


def all_steps(directory) -> list[int]:
    directory = Path(directory)
    if not directory.exists():
        return []
    return sorted(
        int(p.name.split("-", 1)[1])
        for p in directory.iterdir()
        if p.is_dir() and p.name.startswith("step-")
    )


def latest_step(directory) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


@torch.no_grad()
def restore(like, directory, step: int | None = None):
    """Restore into ``like`` (a ``TrainState`` of the right structure, on
    the device to fill), in place.  Returns ``(like, step)``.  Raises
    ``FileNotFoundError`` without a checkpoint, ``KeyError`` for a path
    the checkpoint lacks and ``ValueError`` for a shape that differs."""
    directory = Path(directory)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    src = directory / f"step-{step}"
    manifest = json.loads((src / "manifest.json").read_text())["arrays"]
    data = np.load(src / "arrays.npz")
    for path, (ts, stacked) in _state_paths(like).items():
        if path not in data.files:
            raise KeyError(f"checkpoint missing array {path!r}")
        arr = data[path]
        want = ((len(ts), *ts[0].shape) if stacked else tuple(ts[0].shape))
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"shape mismatch for {path}: ckpt {arr.shape} vs {want}")
        t = _from_numpy(arr, manifest[path]["dtype"])
        if path.startswith(("params/", "opt/m/", "opt/v/")):
            for i, dst in enumerate(ts):
                dst.copy_(t[i] if stacked else t)
        else:  # state leaves that may share storage (a fresh balancer's zeros)
            _set_leaf(like, path, t.to(device=ts[0].device, dtype=ts[0].dtype))
    return like, step


def _set_leaf(state, path: str, t: torch.Tensor) -> None:
    if path == "step":
        state.step = t
    elif path == "opt/step":
        state.opt.step = t
    else:
        setattr(state.balancer, path.split("/", 1)[1], t)
