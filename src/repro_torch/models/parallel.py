"""Parallel context: the mesh's axes, its process groups and the batch's rows.

Port of ``repro/models/parallel.py``.  The JAX package is mostly GSPMD
(pjit plus sharding hints) with one manual region, the MoE layer
(``shard_map`` + ``all_to_all``).  The port keeps the reference's
data-parallel layout: under a context each rank of the dp group holds its
block of the batch's rows (``partitioning.batch_specs``; the whole batch
where its rows do not divide over dp, as GSPMD downgrades the spec), the
loss is the whole batch's token mean (``common.cross_entropy`` sums the
unmasked count over dp), and the train step sums each gradient over dp
once.

Tensor parallelism over ``model`` is eager and Megatron-style for every
family (``partitioning.tp_layout``): each rank of the TP group holds its
blocks of the leaves the layout splits (whole query and KV heads, MLA's
heads, RWKV's WKV heads, Mamba's inner channels, FFN and shared-expert
hidden units, vocabulary rows and columns, the MoE family's embedding
columns; ``partitioning.local_specs``), computes only those, and sums the
row-parallel products over the TP group where GSPMD inserts the same
all-reduce for the reference.  The autograd functions :func:`tp_copy`
(identity forward, all-reduce backward), :func:`tp_reduce` (all-reduce
forward, identity backward) and :func:`tp_gather` (all-gather forward,
this rank's block backward) carry it, and :func:`group_copy` /
:func:`group_reduce` do the same over any axes; none issues a collective
over a group of one rank.  The residual stream stays whole on every
rank, so the reference's sequence-parallel hints have no eager
counterpart yet and :func:`hint` only checks a DTensor's layout against
the hints' rule.  A layout may take a dimension as equal pieces, a block
of each (``Spec(..., parts=)``: Mamba's ``w_in``, whose ``xi`` and ``z``
halves each give a rank the same channels); :func:`take_block`,
:func:`put_block` and :func:`gather` read it.
Each rank holds its block of the routed experts wherever the EP group
has several ranks (``partitioning.expert_specs``).  The MoE layer is the
port's manual region too (``models/ffn.py``): each rank takes its
dispatcher's positions of its rows, and tokens cross ranks with
``all_to_all_single`` over the expert-parallel group; the autograd
functions below carry the gradients back across the same groups.

A context holds a ``torch.distributed.device_mesh.DeviceMesh`` with axes
named ``("data", "model")`` and optionally ``"pod"`` first, or a
:class:`MeshShape` (names and sizes, no devices) for the spec rules alone
(``models/partitioning.py``, ``launch/mesh.make_production_mesh``).
``None`` in place of a context means one device.
"""
from __future__ import annotations

import copy
import dataclasses
import math

import torch
import torch.distributed as dist


class Spec(tuple):
    """A layout, one entry per leading dimension, as ``PartitionSpec``: an
    axis name, a tuple of names (sharded over their product, row-major), or
    None (whole); trailing dimensions left out are whole.  A tuple of one
    name is that name, as ``PartitionSpec`` normalises it.

    ``parts`` (one count a dimension, or one count for every dimension an
    entry splits): a dimension of ``p`` parts is ``p`` equal consecutive
    pieces, and a block is its block of each piece, in order (the entry
    laid on the view that cuts the dimension ``d`` into ``(p, d / p)``);
    1 is the plain layout."""

    def __new__(cls, *entries, parts=1):
        self = super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))
        if isinstance(parts, int):
            parts = tuple(parts if e is not None else 1 for e in self)
        if len(parts) != len(self):
            raise ValueError(f"{len(parts)} part counts for {len(self)} entries")
        self.parts = tuple(parts)
        return self

    def __eq__(self, other) -> bool:
        return tuple.__eq__(self, other) and self.parts == getattr(other, "parts",
                                                                    (1,) * len(other))

    def __ne__(self, other) -> bool:
        return not self == other

    def __hash__(self) -> int:
        return hash((tuple(self), self.parts))

    def __repr__(self) -> str:
        if set(self.parts) <= {1}:
            return f"Spec{tuple.__repr__(self)}"
        return f"Spec{tuple.__repr__(self)[:-1].rstrip(',')}, parts={self.parts})"

    def __getnewargs_ex__(self):
        # Unpickled as Spec(*entries, parts=), not Spec(entries).
        return tuple(self), {"parts": self.parts}


def spec_parts(spec, n: int) -> tuple[int, ...]:
    """The part counts of ``spec``'s first ``n`` dimensions (1 past its
    entries, and for a plain tuple)."""
    parts = tuple(getattr(spec, "parts", ()))
    return (parts + (1,) * n)[:n]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis sizes and names with no devices behind it."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or :class:`MeshShape`."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    # DeviceMesh.shape reads the layout; .mesh would build a tensor, which
    # a trace under FakeTensorMode refuses.
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(entry) -> tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    mesh: object  # DeviceMesh, or MeshShape for the spec rules alone
    dp_axes: tuple[str, ...] = ("data",)  # batch / gradient axes
    tp_axis: str = "model"  # tensor-parallel axis
    ep_axes: tuple[str, ...] = ("data", "model")  # expert-parallel axes
    fsdp_axis: str | None = None  # shard expert D dim when E doesn't
    #                               divide the full EP product
    whole_batch: bool = False  # every rank holds the whole batch (:meth:`for_batch`)
    _groups: dict = dataclasses.field(default_factory=dict, init=False, compare=False, repr=False)

    def __post_init__(self):
        if isinstance(self.mesh, MeshShape):
            return
        # Groups are made collectively: every rank makes them here, in one order.
        sets = [self.ep_axes, self.dp_axes, self.grid_axes, (self.tp_axis,)]
        if self.fsdp_axis is not None:
            sets.append((self.fsdp_axis,))
        for axes in sets:
            self.group(axes)

    @property
    def shape(self) -> dict[str, int]:
        return mesh_shape(self.mesh)

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    @property
    def ep_size(self) -> int:
        return self.size(self.ep_axes)

    @property
    def dp_size(self) -> int:
        return self.size(self.dp_axes)

    @property
    def tp_size(self) -> int:
        return self.shape[self.tp_axis]

    @property
    def tp_split(self) -> bool:
        """Whether the TP group has more than one rank."""
        return self.tp_size > 1

    @property
    def tp_index(self) -> int:
        """This rank's position in the TP group."""
        return self.index(self.tp_axis)

    @property
    def grid_axes(self) -> tuple[str, ...]:
        """The dispatcher grid ``(dp..., tp)``: one MoE dispatcher a rank."""
        return (*self.dp_axes, self.tp_axis)

    @property
    def split(self) -> bool:
        """Whether each rank holds only its dp block of the batch's rows (and
        a sum over the dp group is needed to make a whole-batch value)."""
        return self.dp_size > 1 and not self.whole_batch

    def for_batch(self, rows: int, microbatches: int = 1) -> ParallelContext:
        """The context for a global batch of ``rows`` rows taken in
        ``microbatches`` microbatches: one whose ranks hold their block of
        each microbatch where its rows divide over dp, else one whose ranks
        all hold the whole batch (``batch_specs``' downgrade).  The copy
        shares this context's process groups."""
        whole = (rows // microbatches) % self.dp_size != 0
        return self if whole == self.whole_batch else self.with_whole_batch(whole)

    def with_whole_batch(self, whole: bool = True) -> ParallelContext:
        """This context saying every rank holds the whole batch (``whole``) or
        its block of the rows; the copy shares the process groups."""
        view = copy.copy(self)
        object.__setattr__(view, "whole_batch", whole)
        return view

    def local_rows(self, rows: int) -> int:
        """The rows of a ``rows``-row batch, cache or microbatch that this
        rank holds: its dp block where they divide (and the context does
        not say every rank holds the whole batch), else all of them."""
        return rows // self.dp_size if self.split and rows % self.dp_size == 0 else rows

    def take_rows(self, batch: dict, microbatches: int = 1) -> dict:
        """This rank's rows of each leaf of a global batch (dimension 0 the
        rows): its block, by ``partitioning.batch_specs``' spec of one
        microbatch, of each of ``microbatches`` equal microbatches, so that
        the step's microbatch ``i`` holds the reference's microbatch ``i``'s
        block.  Every leaf stays whole where the context says each rank
        holds the whole batch (:meth:`for_batch` of a batch whose rows do not
        divide over dp)."""
        from repro_torch.models.partitioning import batch_specs

        if not self.split:
            return dict(batch)
        out = {}
        for name, t in batch.items():
            mb = t.reshape(microbatches, t.shape[0] // microbatches, *t.shape[1:])
            spec = batch_specs({name: mb[0]}, self)[name]
            if spec[0] is None:
                raise ValueError(
                    f"{name}: {mb.shape[1]} rows a microbatch do not divide over dp "
                    f"{self.dp_size}; take them under ctx.for_batch({t.shape[0]}, {microbatches})")
            block = mb[(slice(None), *shard_index(spec, mb.shape[1:], self))]
            out[name] = block.reshape(-1, *t.shape[1:])
        return out

    def dp_sum(self, t: torch.Tensor, spec=None) -> torch.Tensor:
        """``t`` summed over the dp group, in place, where each rank holds
        its block of the rows (:attr:`split`); else ``t`` as it is, and no
        collective is issued.  With ``spec`` (the layout of a block ``t`` is
        the gradient of) only over the dp axes it does not split: a block
        over a dp axis gathers its gradient over that axis itself (the EP
        exchange, the FSDP gather's adjoint)."""
        if self.split:
            axes = tuple(a for a in self.dp_axes if a not in spec_axes(spec))
            if self.size(axes) > 1:
                dist.all_reduce(t, group=self.group(axes))
        return t

    def index(self, axes) -> int:
        """This rank's row-major position over ``axes``."""
        if isinstance(self.mesh, MeshShape):
            raise ValueError("a MeshShape has no ranks; build the context on a DeviceMesh")
        coord = dict(zip(self.mesh.mesh_dim_names, self.mesh.get_coordinate()))
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + coord[a]
        return i

    def group(self, axes):
        """The process group of ``axes`` that holds this rank; its ranks are
        in row-major order over ``axes``, so group rank == :meth:`index`."""
        axes = _axes(axes)
        if axes in self._groups:
            return self._groups[axes]
        if isinstance(self.mesh, MeshShape):
            raise ValueError("a MeshShape has no process groups")
        names = list(self.mesh.mesh_dim_names)
        if [a for a in names if a in axes] != list(axes):
            raise ValueError(f"axes {axes} are not in the mesh's order {tuple(names)}")
        if len(axes) == 1:
            group = self.mesh.get_group(axes[0])
        else:
            ranks = self.mesh.mesh
            rest = [i for i, a in enumerate(names) if a not in axes]
            dims = [names.index(a) for a in axes]
            rows = ranks.permute(*rest, *dims).reshape(-1, self.size(axes)).tolist()
            group, _ = dist.new_subgroups_by_enumeration(rows)
        if dist.get_rank(group) != self.index(axes):
            raise ValueError(f"group of {axes}: rank {dist.get_rank(group)} != "
                             f"row-major index {self.index(axes)}")
        self._groups[axes] = group
        return group


def spec_axes(spec) -> set[str]:
    """The mesh axes ``spec`` splits a dimension over (none for None)."""
    return {a for e in (spec or ()) if e is not None for a in _axes(e)}


def divisible(spec, shape, sizes: dict[str, int]) -> Spec:
    """``spec`` padded to ``len(shape)`` entries, any entry whose dimension
    does not divide over its axes downgraded to None."""
    fixed = []
    for dim, names in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if names is None:
            fixed.append(None)
            continue
        size = math.prod(sizes[a] for a in _axes(names))
        fixed.append(names if dim % size == 0 else None)
    return Spec(*fixed)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec``, one per mesh axis: ``Shard(i)``
    where the axis names entry ``i``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is not None:
            for a in _axes(entry):
                out[names.index(a)] = Shard(i)
    return tuple(out)


def hint(x, ctx: ParallelContext | None, *entries):
    """The JAX package's sharding hint; returns ``x`` itself.

    ``entries`` are leading spec entries (an axis name, a tuple of names,
    or None); trailing dims are whole.  An entry whose dimension is not
    divisible on the mesh is downgraded to None (:func:`divisible`), so the
    same hints fit any mesh.  A plain tensor is this rank's rows of the
    logical array (its dp block where the batch is split, the tensor
    parallel dimensions whole) and nothing moves; a DTensor must already be
    laid out so on every mesh axis wider than one.
    """
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        want = placements(divisible(entries, x.shape, ctx.shape), ctx.mesh)
        wide = [i for i, n in enumerate(ctx.shape.values()) if n > 1]
        if [x.placements[i] for i in wide] != [want[i] for i in wide]:
            raise ValueError(f"DTensor placed {x.placements}, the hint asks for {want}")
    return x


def choose_ep_axes(ctx_or_mesh, num_experts: int, dp_axes, tp_axis) -> tuple:
    """Pick EP axes: the widest mesh-axis product that divides E.

    Prefers (data..., model) for storage economy (deepseek-v3: 256 experts
    over 256 chips); falls back to (model,) + FSDP weight sharding over
    'data' when E only divides the TP axis (deepseek-v2: 160 = 10 x 16).
    """
    if isinstance(ctx_or_mesh, ParallelContext):
        shape = ctx_or_mesh.shape
    else:
        shape = mesh_shape(ctx_or_mesh)
    full = [a for a in (*dp_axes, tp_axis) if a != "pod"]
    full_size = math.prod(shape[a] for a in full)
    if num_experts % full_size == 0:
        return tuple(full), None
    tp_size = shape[tp_axis]
    if num_experts % tp_size == 0:
        fsdp = "data" if "data" in shape else None
        return (tp_axis,), fsdp
    raise ValueError(f"num_experts={num_experts} not divisible by mesh axes {shape}")


# --------------------------------------------------------------------------
# blocks of a tensor laid out by a spec
# --------------------------------------------------------------------------


def shard_index(spec, shape, ctx: ParallelContext, coord: dict | None = None) -> tuple:
    """This rank's block of a tensor of ``shape`` laid out by ``spec`` (a
    plain layout: :func:`take_block` reads one of pieces); with ``coord``
    (``{axis: index}``, 0 for an axis it omits) the block of the rank at
    those mesh coordinates."""
    if any(p != 1 for p in spec_parts(spec, len(shape))):
        raise ValueError(f"{spec} takes its block of each piece: use take_block / put_block")
    idx = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            idx.append(slice(None))
            continue
        step = dim // ctx.size(entry)
        if coord is None:
            i = ctx.index(entry)
        else:
            i = 0
            for a in _axes(entry):
                i = i * ctx.size(a) + coord.get(a, 0)
        idx.append(slice(i * step, (i + 1) * step))
    return tuple(idx)


def _view(spec, shape) -> tuple[tuple, tuple]:
    """``(view shape, plain entries)`` of ``spec`` on a tensor of
    ``shape``: each dimension of ``p > 1`` parts cut into ``(p, d / p)``,
    its entry on the second."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    vshape, ventries = [], []
    for d, e, p in zip(shape, entries, spec_parts(spec, len(shape))):
        if p == 1:
            vshape.append(d)
            ventries.append(e)
        else:
            vshape += [p, d // p]
            ventries += [None, e]
    return tuple(vshape), tuple(ventries)


def block_shape(spec, shape, ctx: ParallelContext) -> tuple:
    """The shape of a rank's block of a tensor of ``shape``."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d if e is None else d // ctx.size(e) for d, e in zip(shape, entries))


def take_block(t: torch.Tensor, spec, ctx: ParallelContext, coord: dict | None = None):
    """This rank's block of ``t`` (a view where ``spec`` is plain), or with
    ``coord`` the block of the rank at those mesh coordinates."""
    vshape, ventries = _view(spec, t.shape)
    blk = t.reshape(vshape)[shard_index(ventries, vshape, ctx, coord)]
    return blk.reshape(block_shape(spec, t.shape, ctx))


def put_block(out: torch.Tensor, blk: torch.Tensor, spec, ctx: ParallelContext,
              coord: dict | None = None) -> None:
    """Write ``blk`` as the block of the rank at ``coord`` (this rank's
    without it) into the contiguous whole tensor ``out``."""
    vshape, ventries = _view(spec, out.shape)
    out.view(vshape)[shard_index(ventries, vshape, ctx, coord)] = blk.reshape(
        block_shape(ventries, vshape, ctx))


def gather(local: torch.Tensor, spec, ctx: ParallelContext) -> torch.Tensor:
    """The whole tensor from every rank's block of it, laid out by ``spec``."""
    vshape, ventries = _view(spec, local.shape)
    out = local.reshape(vshape)
    for i, entry in enumerate(ventries):
        if entry is not None and ctx.size(entry) > 1:
            out = all_gather(out, ctx.group(entry), i)
    entries = tuple(spec) + (None,) * (local.dim() - len(spec))
    return out.reshape([d * (1 if e is None else ctx.size(e))
                        for d, e in zip(local.shape, entries)])


# --------------------------------------------------------------------------
# collectives under autograd (the manual MoE region, tensor parallelism)
# --------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    """Equal blocks of dim 0: block ``j`` goes to group rank ``j``, and
    block ``j`` of the result came from rank ``j``.  Its own adjoint."""

    @staticmethod
    def forward(fctx, x, group):
        fctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(fctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=fctx.group)
        return out, None


class _AllGather(torch.autograd.Function):
    """The group's blocks concatenated on ``dim``, in rank order.  Each rank
    uses the whole for its own work, so the adjoint sums the gradients
    over the group and takes this rank's block (a reduce-scatter)."""

    @staticmethod
    def forward(fctx, x, group, dim: int):
        fctx.group, fctx.dim = group, dim
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(fctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=fctx.group)
        n, me = dist.get_world_size(fctx.group), dist.get_rank(fctx.group)
        return g.chunk(n, dim=fctx.dim)[me].contiguous(), None, None


class _Scatter(torch.autograd.Function):
    """This rank's block ``index`` of a tensor every rank of ``group`` holds
    whole.  The blocks' gradients land in a zero tensor of the whole shape,
    summed over the group: each rank ends with the whole gradient."""

    @staticmethod
    def forward(fctx, full, index, group):
        fctx.index, fctx.group, fctx.shape = index, group, full.shape
        return full[index].contiguous()

    @staticmethod
    def backward(fctx, g):
        out = g.new_zeros(fctx.shape)
        out[fctx.index] = g
        dist.all_reduce(out, group=fctx.group)
        return out, None, None


class _Gather(torch.autograd.Function):
    """The whole tensor of ``shape`` from the group's blocks (``blocks[r]``
    the index of group rank ``r``'s).  Every rank then computes the same
    thing from it, so the adjoint is this rank's block of the gradient."""

    @staticmethod
    def forward(fctx, local, group, blocks, shape):
        me = dist.get_rank(group)
        fctx.block = blocks[me]
        parts = [torch.empty_like(local) for _ in blocks]
        dist.all_gather(parts, local.contiguous(), group=group)
        out = local.new_empty(shape)
        for idx, part in zip(blocks, parts):
            out[idx] = part
        return out

    @staticmethod
    def backward(fctx, g):
        return g[fctx.block].contiguous(), None, None, None


class _Copy(torch.autograd.Function):
    """Identity forward.  Every rank of the group feeds the same input to
    its own block of the work, so the adjoint sums the blocks' gradients
    over the group."""

    @staticmethod
    def forward(fctx, x, group):
        fctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=fctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    """The group's partial sums added (an all-reduce).  Every rank then
    computes the same thing from the sum, so the adjoint is the identity."""

    @staticmethod
    def forward(fctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(fctx, g):
        return g, None


class _GatherSame(torch.autograd.Function):
    """The group's blocks concatenated on ``dim``, in rank order.  Every
    rank then computes the same thing from the whole, so the adjoint is
    this rank's block of the gradient."""

    @staticmethod
    def forward(fctx, x, group, dim: int):
        fctx.dim = dim
        fctx.n, fctx.me = dist.get_world_size(group), dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(fctx.n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(fctx, g):
        return g.chunk(fctx.n, dim=fctx.dim)[fctx.me].contiguous(), None, None


def _tp_group(ctx: ParallelContext | None):
    """The TP group of a context whose TP group has several ranks, else None."""
    return ctx.group(ctx.tp_axis) if ctx is not None and ctx.tp_split else None


def group_copy(x: torch.Tensor, ctx: ParallelContext | None, axes) -> torch.Tensor:
    """``x`` as it is, its gradient summed over the group of ``axes``: an
    input every rank of the group feeds to its own share of the work."""
    if ctx is None or ctx.size(axes) == 1:
        return x
    return _Copy.apply(x, ctx.group(axes))


def group_reduce(x: torch.Tensor, ctx: ParallelContext | None, axes) -> torch.Tensor:
    """``x`` summed over the group of ``axes``, whose ranks then all hold
    the same gradient of the sum (the adjoint is the identity)."""
    if ctx is None or ctx.size(axes) == 1:
        return x
    return _Reduce.apply(x, ctx.group(axes))


def tp_copy(x: torch.Tensor, ctx: ParallelContext | None) -> torch.Tensor:
    """``x`` as it is, its gradient summed over the TP group: the input of a
    column-parallel product, or a whole parameter each rank uses part of."""
    return group_copy(x, ctx, ctx.tp_axis) if ctx is not None else x


def tp_reduce(x: torch.Tensor, ctx: ParallelContext | None) -> torch.Tensor:
    """``x`` summed over the TP group: the output of a row-parallel product."""
    return group_reduce(x, ctx, ctx.tp_axis) if ctx is not None else x


def tp_gather(x: torch.Tensor, ctx: ParallelContext | None, dim: int) -> torch.Tensor:
    """The TP group's blocks of ``x`` concatenated on ``dim`` in rank order."""
    group = _tp_group(ctx)
    return x if group is None else _GatherSame.apply(x, group, dim)


def tp_max(x: torch.Tensor, ctx: ParallelContext | None) -> torch.Tensor:
    """``x``'s elementwise maximum over the TP group, out of the graph (a
    softmax's shift)."""
    group = _tp_group(ctx)
    x = x.detach()
    if group is None:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    return _AllToAll.apply(x, group)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _AllGather.apply(x, group, dim)


def gather_same(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated on ``dim`` in rank order,
    for work every rank of the group does alike (the adjoint is this
    rank's block of the gradient); :func:`all_gather` sums it instead."""
    return _GatherSame.apply(x, group, dim)


def scatter(full: torch.Tensor, index: tuple, group) -> torch.Tensor:
    return _Scatter.apply(full, index, group)


def gather_blocks(local: torch.Tensor, group, blocks: list, shape) -> torch.Tensor:
    return _Gather.apply(local, group, blocks, tuple(shape))
