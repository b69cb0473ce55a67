"""Per-rank roofline numerators of one step, read from the ops it runs.

Counterpart of ``repro/launch/hlo_analysis.py``.  The JAX package reads them
from the optimized per-device HLO; the port makes no HLO, so this module
records the ops of one eager step under a ``TorchDispatchMode`` (on fake
tensors in ``launch/dryrun.py``: no memory, no card) and returns the same
dict as ``hlo_analysis.analyze_module``:

* ``flops`` -- every matrix product (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``mv``, ``dot``; ``linear``, ``matmul`` and ``einsum`` reach
  the dispatcher as these) at ``2 * prod(result) * K``, plus each
  hand-written kernel by its registered formula (:data:`KERNEL_FLOPS`; the
  attention kernels count dense attention's ``2 B H S T (dh + dv)`` forward
  and twice that backward, as the JAX package's dense SDPA does).  The port
  runs eagerly, so a layer loop records its body once a layer: no trip
  multiplier is needed, and ``scan_trips`` is kept so callers read alike.
* bytes -- two flavours, as the reference's:
  - ``bytes`` (raw): every op that is not a view, charged its result and
    the whole buffer under each operand -- the conservative account;
  - ``bytes_hbm``: slicing-aware, each op charged what it touches.  A view
    (``view``, ``slice``, ``select``, ``expand``, ``detach``, ...) copies
    nothing and is charged 0, as a ``bitcast`` is; an allocation with no
    fill is charged 0; ``index``, ``index_select``, ``gather`` and
    ``embedding`` are charged twice their result (read the rows, write
    them); an in-place write into a slice (``copy_``, ``index_put_``,
    ``index_copy_``, ``index_add_`` on a view, e.g. a KV-cache update) is
    charged twice the update; a hand-written kernel, and any other op, is
    charged its operands and results.  An operand is charged the elements
    its strides reach once each, so a per-step slice of an ``(S, ...)``
    buffer costs the slice and a broadcast costs its source.
  - ``bytes_hbm_v2`` equals ``bytes_hbm``: the reference's second estimate
    undoes the CPU backend's float32 emulation of bfloat16 around an
    in-place update, which an eager op does not have.
* ``collectives`` -- the operand bytes of every c10d op, by kind
  (all-reduce, all-gather, reduce-scatter, all-to-all; send and recv as
  collective-permute), and ``total``; ``collectives_by_group`` the same
  for each process group the recorder is given by name (e.g. ``dp`` and
  ``tp``), the rest under ``other``.

The recorder also tracks the bytes alive: tensors made during the step,
by storage, from the op that makes them to the last reference's end
(autograd's saved tensors included), so ``peak_bytes`` is the step's peak
of temporaries over the arguments it was given.
"""
from __future__ import annotations

import math
import sys
import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels.flash_attn import flash_flops

_aten = torch.ops.aten

# c10d op -> (kind, index of the argument it sends, or None when the
# written buffer is the operand as well, e.g. all-reduce in place).
_C10D = {
    "allreduce_": ("all-reduce", None),
    "allreduce_coalesced_": ("all-reduce", None),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", None),
    "recv_": ("collective-permute", None),
    "broadcast_": ("all-gather", None),
}

# Ops that read only the rows they return.
_GATHER_OPS = {
    _aten.index.Tensor, _aten.index_select.default, _aten.gather.default,
    _aten.embedding.default,
}
# In-place writes of an update into part of a buffer: (argument of the update).
_UPDATE_OPS = {
    _aten.copy_.default: 1,
    _aten.index_put_.default: 2,
    _aten.index_copy_.default: 3,
    _aten.index_add_.default: 3,
}
# Allocations without a fill, and metadata: no bytes move.
_FREE_OPS = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten._unsafe_view.default,
    _aten.lift_fresh.default,
}


def _mm_flops(args, out) -> float:
    k = args[0].shape[-1] if len(args[0].shape) else 1
    return 2.0 * math.prod(out.shape) * k


def _addmm_flops(args, out) -> float:
    return 2.0 * math.prod(out.shape) * args[1].shape[-1]


# Matrix products: 2 * prod(result) * K, K the first operand's last dim.
_MATMUL_FLOPS = {
    _aten.mm.default: _mm_flops,
    _aten.bmm.default: _mm_flops,
    _aten.mv.default: _mm_flops,
    _aten.dot.default: _mm_flops,
    _aten.addmm.default: _addmm_flops,
    _aten.baddbmm.default: _addmm_flops,
    _aten.addmv.default: _addmm_flops,
}


def _flash_fwd(args, _out) -> float:
    q, k, v = args[:3]
    return float(flash_flops(q.shape, k.shape, v.shape))


def _flash_bwd(args, _out) -> float:
    return 2.0 * _flash_fwd(args, _out)


# The hand-written kernels' operators (``kernels/flash_attn.py``) and their
# FLOPs; the router's (``kernels/moe_route.py``) multiply no matrix.
KERNEL_FLOPS = {
    "repro_torch::flash_attention": _flash_fwd,
    "repro_torch::flash_attention_bwd": _flash_bwd,
}


def tensors_of(tree) -> list[torch.Tensor]:
    """The tensors among the leaves of nested lists, tuples and dicts."""
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def touched_bytes(t: torch.Tensor) -> int:
    """Bytes a strided tensor reaches, each element once (a broadcast
    dimension, stride 0, reads its source once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def buffer_bytes(t: torch.Tensor) -> int:
    """Bytes of the whole buffer under ``t`` (a view's base included)."""
    return t.untyped_storage().nbytes()


def storage_key(t: torch.Tensor) -> int:
    """The identity of the storage under ``t``, shared by its views."""
    return t.untyped_storage()._cdata


def _where() -> str:
    """The chain of the port's functions that called the current op, outer
    first, e.g. ``model.train_loss/transformer.lm_block_full/...``: the
    counterpart of an HLO computation (every layer's body under one name)."""
    names = []
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("repro_torch.") and not mod.startswith(("repro_torch.launch.",
                                                                    "repro_torch.kernels")):
            names.append(f"{mod.rsplit('.', 1)[-1]}.{f.f_code.co_name}")
        f = f.f_back
    return "/".join(reversed(names)) or "<step>"


class OpRecorder(TorchDispatchMode):
    """Records every op dispatched while it is active.

    ``arguments``: tensors the step is given (parameters, optimizer state,
    inputs); their buffers count as arguments, not temporaries.  With
    ``keep_ops`` each op's charge is also kept in :attr:`rows` as
    ``(bytes_hbm, flops, op name, where)``, for ``launch/op_breakdown.py``.
    ``groups`` (``{name: process group}``) labels each collective's bytes
    by the group it runs over (:meth:`result`'s ``collectives_by_group``).
    :attr:`kernel_calls` lists each call of a hand-written kernel's
    operator as ``(name, [(shape, dtype, strides) of each output])``, which
    a fake trace and a real run of the same step must give alike.
    """

    def __init__(self, arguments=(), *, keep_ops: bool = False, groups: dict | None = None):
        super().__init__()
        self._group_names = {g.group_name: name for name, g in (groups or {}).items()}
        self.colls_by: dict[str, dict[str, float]] = defaultdict(lambda: defaultdict(float))
        self.flops = 0.0
        self.bytes = 0.0
        self.bytes_hbm = 0.0
        self.colls: dict[str, float] = defaultdict(float)
        self.n_ops = 0
        self.n_coll = 0
        self.keep_ops = keep_ops
        self.rows: list[tuple[float, float, str, str]] = []
        self.kernel_calls: list[tuple[str, list]] = []
        self._args = {}
        for t in tensors_of(arguments):
            self._args[storage_key(t)] = buffer_bytes(t)
        self.argument_bytes = sum(self._args.values())
        self._live: dict[int, list[int]] = {}  # storage -> [references, bytes]
        self.live_bytes = 0
        self.peak_bytes = 0

    # -- memory --------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        key = storage_key(t)
        if key in self._args:
            return
        ent = self._live.get(key)
        if ent is None:
            ent = self._live[key] = [0, buffer_bytes(t)]
            self.live_bytes += ent[1]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        ent[0] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        ent = self._live.get(key)
        if ent is None:
            return
        ent[0] -= 1
        if ent[0] == 0:
            self.live_bytes -= ent[1]
            del self._live[key]

    # -- charges -------------------------------------------------------
    def _charge(self, func, args, kwargs, out) -> tuple[float, float]:
        """``(bytes_hbm, flops)`` of one op; adds raw bytes and collectives."""
        ins = tensors_of((args, kwargs))
        outs = tensors_of(out)
        name = func._schema.name
        if name.startswith("c10d::"):
            kind, src = _C10D.get(name.split("::", 1)[1], (name, None))
            sent = tensors_of(args[src]) if src is not None else ins
            op_bytes = float(sum(touched_bytes(t) for t in sent))
            self.colls[kind] += op_bytes
            self.colls_by[self._group_of(args)][kind] += op_bytes
            self.n_coll += 1
            self.bytes += op_bytes + sum(buffer_bytes(t) for t in outs)
            return op_bytes + sum(touched_bytes(t) for t in outs), 0.0
        if func.is_view or func in _FREE_OPS:
            return 0.0, 0.0
        self.bytes += sum(buffer_bytes(t) for t in ins) + sum(buffer_bytes(t) for t in outs)
        flops = 0.0
        if func in _MATMUL_FLOPS:
            flops = _MATMUL_FLOPS[func](args, out)
        elif name in KERNEL_FLOPS:
            flops = KERNEL_FLOPS[name](args, out)
        if func in _GATHER_OPS:
            return 2.0 * sum(touched_bytes(t) for t in outs), flops
        if func in _UPDATE_OPS:
            upd = args[_UPDATE_OPS[func]] if len(args) > _UPDATE_OPS[func] else None
            if isinstance(upd, torch.Tensor):
                return 2.0 * touched_bytes(upd), flops
        return float(sum(touched_bytes(t) for t in ins) + sum(touched_bytes(t) for t in outs)), flops

    def _group_of(self, args) -> str:
        """The name of the group a c10d op's arguments run over."""
        for a in args:
            if isinstance(a, torch.ScriptObject):
                try:
                    pg = dist.ProcessGroup.unbox(a)
                except RuntimeError:  # another script object (a reduce op)
                    continue
                return self._group_names.get(pg.group_name, "other")
        return "other"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":  # prim.device and the like
            return out
        hbm, flops = self._charge(func, args, kwargs, out)
        self.n_ops += 1
        self.bytes_hbm += hbm
        self.flops += flops
        if self.keep_ops:
            self.rows.append((hbm, flops, str(func), _where()))
        if func.namespace == "repro_torch":
            self.kernel_calls.append((func._schema.name, [
                (tuple(t.shape), t.dtype, tuple(t.stride())) for t in tensors_of(out)]))
        for t in tensors_of(out):
            self._track(t)
        return out

    def result(self, scan_trips: list[int] | None = None) -> dict:
        """The dict of ``hlo_analysis.analyze_module``; ``scan_trips`` is
        unused (an eager step records each trip)."""
        del scan_trips
        colls = dict(self.colls)
        colls["total"] = float(sum(self.colls.values()))
        by_group = {}
        for name, kinds in self.colls_by.items():
            by_group[name] = {**kinds, "total": float(sum(kinds.values()))}
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "bytes_hbm": self.bytes_hbm,
            "bytes_hbm_v2": self.bytes_hbm,
            "collectives": colls,
            "collectives_by_group": by_group,
            "n_collectives_static": self.n_coll,
            "n_ops": self.n_ops,
            "argument_bytes": self.argument_bytes,
            "peak_bytes": self.peak_bytes,
        }

