"""Mesh construction.

Port of ``repro/launch/mesh.py``.  ``make_production_mesh`` gives the
production shape only (a :class:`parallel.MeshShape`: a 16 x 16 mesh has no
devices to stand on here); ``make_context`` builds the parallel context of
a mesh (``models/parallel.py``); ``make_debug_mesh`` builds a live
``DeviceMesh`` over the ranks of the default process group, which
``init_ranks`` starts: NCCL on the card, gloo for CPU ranks.
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from repro_torch.core.care.slotted_sim import _resolve_device
from repro_torch.models.parallel import MeshShape, ParallelContext, choose_ep_axes, mesh_shape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(shape, axes)


def make_context(mesh, num_experts: int = 0) -> ParallelContext:
    """ParallelContext for a mesh (handles the pod axis)."""
    axes = tuple(mesh_shape(mesh))
    dp_axes = tuple(a for a in axes if a in ("pod", "data"))
    tp_axis = "model"
    if num_experts:
        ep_axes, fsdp = choose_ep_axes(mesh, num_experts, dp_axes, tp_axis)
    else:
        ep_axes, fsdp = (tp_axis,), None
    return ParallelContext(
        mesh=mesh, dp_axes=dp_axes, tp_axis=tp_axis, ep_axes=ep_axes,
        fsdp_axis=fsdp,
    )


def init_ranks(device=None, *, rank: int | None = None, world_size: int | None = None,
               init_method: str | None = None) -> bool:
    """Start the default process group unless one is running: NCCL when
    ``device`` is the CUDA card (None means the card), gloo for the CPU.
    Rank and world size come from the arguments, else from ``RANK`` /
    ``WORLD_SIZE`` (``torchrun``), else one rank on a local store.  There
    is no fallback: a backend that fails to start raises.  Returns whether
    it started one (its caller then ends it with
    ``dist.destroy_process_group``)."""
    if dist.is_initialized():
        return False
    dev = _resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if rank is None and "RANK" in os.environ:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    rank, world_size = rank or 0, world_size or 1
    if init_method is None:
        if world_size != 1:
            raise ValueError("several ranks need an init_method (or torchrun's environment)")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            init_method = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else rank % torch.cuda.device_count()
        torch.cuda.set_device(index)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    return True


def make_debug_mesh(shape=(2, 4), device=None):
    """A ``("data", "model")`` DeviceMesh of ``shape`` over the ranks of the
    default process group (``init_ranks``), on the card unless ``device``
    is the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_resolve_device(device).type, tuple(shape),
                            mesh_dim_names=("data", "model"))
