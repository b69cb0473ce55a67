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

A checkpoint always holds whole leaves.  Under a parallel context every
rank calls :func:`save` and :func:`restore`: a rank's tensor-parallel
blocks and ZeRO-1 moment blocks are gathered onto rank 0 one leaf at a
time, and rank 0 writes each leaf before it gathers the next, so no rank
holds more than one whole leaf; on restore each rank reads one leaf at a
time and keeps its block of it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models import parallel
from repro_torch.models.partitioning import STACKED, jax_param_paths

_BF16 = "bfloat16"


def _state_paths(state) -> dict[str, tuple[list, bool, tuple | None]]:
    """``{path: (tensors, stacked, spec)}`` of a ``train_loop.TrainState``:
    ``spec`` lays out the rank's tensor (the stacked one where ``stacked``)
    within the whole leaf, None where the rank holds it whole."""
    named = dict(state.params.named_parameters())
    tp = getattr(state.params, "tp_specs", {})
    paths: dict[str, tuple[list, bool, tuple | None]] = {}
    for key, ts in jax_param_paths(named).items():
        paths[f"params/{key}"] = (ts, key.split("/", 1)[0] in STACKED, tp.get(key))
    for part in ("m", "v"):
        tree = getattr(state.opt, part)
        if state.opt.specs is None:  # one moment a parameter, shaped like it
            for key, ts in jax_param_paths(tree).items():
                paths[f"opt/{part}/{key}"] = (ts, key.split("/", 1)[0] in STACKED, tp.get(key))
        else:  # ZeRO-1: a block of each JAX leaf's moments, of the TP block
            for key, t in tree.items():
                paths[f"opt/{part}/{key}"] = ([t], False, _merge(tp.get(key), state.opt.specs[key]))
    paths["opt/step"] = ([state.opt.step], False, None)
    if state.balancer is not None:
        for field in ("load_approx", "true_load", "true_counts", "bias", "steps_since_sync"):
            paths[f"balancer/{field}"] = ([getattr(state.balancer, field)], False, None)
    paths["step"] = ([state.step], False, None)
    return paths


def _merge(tp, zero):
    """The layout of a ZeRO-1 block (``zero``, within the rank's TP block)
    of a TP block (``tp``) within the whole leaf; they split no dimension
    both."""
    if tp is None:
        return zero
    n = max(len(tp), len(zero))
    tpe, zero = (tuple(s) + (None,) * (n - len(s)) for s in (tp, zero))
    if any(a is not None and b is not None for a, b in zip(tpe, zero)):
        raise ValueError(f"TP layout {tp} and ZeRO-1 layout {zero} split one dimension")
    return parallel.Spec(*(a if a is not None else b for a, b in zip(tpe, zero)),
                         parts=parallel.spec_parts(tp, n))


def _local(ts, stacked) -> torch.Tensor:
    return torch.stack([x.detach() for x in ts]) if stacked else ts[0].detach()


def _split_axes(spec, ctx) -> tuple[str, ...]:
    """The mesh axes wider than one rank that ``spec`` splits, in mesh order."""
    if spec is None or ctx is None:
        return ()
    used = {a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))}
    return tuple(a for a in ctx.mesh.mesh_dim_names if a in used and ctx.size(a) > 1)


def _whole_shape(t: torch.Tensor, spec, ctx) -> tuple:
    entries = tuple(spec or ()) + (None,) * t.dim()
    return tuple(d * (ctx.size(e) if e is not None else 1) for d, e in zip(t.shape, entries))


def _gather_to_rank0(t: torch.Tensor, spec, ctx) -> torch.Tensor | None:
    """The whole leaf on the host of rank 0 (None on every other rank) from
    each rank's block ``t`` of it, laid out by ``spec``.  Only the ranks of
    rank 0's group over the split axes send; the others hold copies."""
    axes = _split_axes(spec, ctx)
    if not axes:
        return t if ctx is None or dist.get_rank() == 0 else None
    group = ctx.group(axes)
    if 0 not in dist.get_process_group_ranks(group):
        return None
    t = t.contiguous()
    lead = dist.get_rank() == 0
    got = [torch.empty_like(t) for _ in range(ctx.size(axes))] if lead else None
    dist.gather(t, got, dst=0, group=group)
    if not lead:
        return None
    shape = _whole_shape(t, spec, ctx)
    out = torch.empty(shape, dtype=t.dtype)
    for j, blk in enumerate(got):
        coord = dict(zip(axes, np.unravel_index(j, [ctx.size(a) for a in axes])))
        parallel.put_block(out, blk.cpu(), spec, ctx, coord)
    return out


def _check_ctx(state, ctx) -> None:
    if ctx is None and (state.opt.specs is not None or getattr(state.params, "tp_specs", {})):
        raise ValueError("a state of blocks needs the parallel context it was made for")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (a CPU tensor is cloned: its numpy view would share it)."""
    t = t.detach()
    t = t.clone() if t.device.type == "cpu" else t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view("V2")
    return t.numpy()


def _host_leaves(state, ctx=None):
    """``(path, host array or None, dtype name)`` for each leaf in turn,
    whole; under ``ctx`` gathered onto rank 0 (None on the others)."""
    _check_ctx(state, ctx)
    for path, (ts, stacked, spec) in _state_paths(state).items():
        local = _local(ts, stacked)
        t = _gather_to_rank0(local, spec, ctx)
        if t is None:
            yield path, None, None
        else:
            arr = _to_numpy(t)
            yield path, arr, _BF16 if t.dtype == torch.bfloat16 else str(arr.dtype)


def flatten(state) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """The state (whole leaves) as host arrays ``{path: array}`` and their
    dtype names."""
    arrays, dtypes = {}, {}
    for path, arr, dtype in _host_leaves(state):
        arrays[path], dtypes[path] = arr, dtype
    return arrays, dtypes


def _write(leaves, directory, step: int, keep: int, extra: dict | None) -> Path:
    """Write ``leaves`` (``(path, array, dtype name)`` in turn, each written
    before the next is drawn) as ``directory/step-<step>``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"tmp-{step}"
    final = directory / f"step-{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    arrays = {}
    # the layout np.savez writes: one uncompressed ``<path>.npy`` a leaf
    with zipfile.ZipFile(tmp / "arrays.npz", "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for path, arr, dtype in leaves:
            with zf.open(f"{path}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr), allow_pickle=False)
            arrays[path] = {"shape": list(arr.shape), "dtype": dtype}
    manifest = {"step": step, "arrays": arrays, "extra": extra or {}}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    for s in sorted(all_steps(directory))[:-keep]:
        shutil.rmtree(directory / f"step-{s}", ignore_errors=True)
    return final


def save(state, directory: str | os.PathLike, step: int, *, keep: int = 3,
         extra: dict | None = None, ctx=None) -> Path | None:
    """Atomically write ``state`` under ``directory/step-<step>``.  Under a
    parallel context every rank calls it and rank 0 writes: it returns the
    path there and None on the other ranks."""
    leaves = _host_leaves(state, ctx)
    if ctx is not None and dist.get_rank() != 0:
        for _ in leaves:  # take part in each leaf's gather
            pass
        return None
    return _write(leaves, directory, step, keep, extra)


_PENDING: list[threading.Thread] = []


def async_save(state, directory, step: int, *, keep: int = 3,
               extra: dict | None = None) -> threading.Thread:
    """Save on a background thread.  The state is copied to host memory
    before the thread starts, so the caller may update it at once."""
    flat = list(_host_leaves(state))
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
def restore(like, directory, step: int | None = None, ctx=None):
    """Restore into ``like`` (a ``TrainState`` of the right structure, on
    the device to fill), in place; under ``ctx`` each rank keeps its blocks
    of the whole leaves.  Returns ``(like, step)``.  Raises
    ``FileNotFoundError`` without a checkpoint, ``KeyError`` for a path
    the checkpoint lacks and ``ValueError`` for a shape that differs."""
    _check_ctx(like, ctx)
    directory = Path(directory)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    src = directory / f"step-{step}"
    manifest = json.loads((src / "manifest.json").read_text())["arrays"]
    data = np.load(src / "arrays.npz")
    for path, (ts, stacked, spec) in _state_paths(like).items():
        if path not in data.files:
            raise KeyError(f"checkpoint missing array {path!r}")
        arr = data[path]  # one whole leaf at a time
        local = torch.empty((len(ts), *ts[0].shape) if stacked else ts[0].shape, device="meta")
        want = _whole_shape(local, spec, ctx)
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"shape mismatch for {path}: ckpt {arr.shape} vs {want}")
        t = _from_numpy(arr, manifest[path]["dtype"])
        if spec is not None and ctx is not None:
            t = parallel.take_block(t, spec, ctx)
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
