"""ctypes binding of the hand-written Hopper MoE router, and its schedule.

:func:`moe_route_cuda` launches ``csrc/moe_route.cu``, which replaces the
Pallas kernel ``moe_route_pallas`` (``repro/kernels/moe_route.py:89``) and
the capacity positions the reference computes around it
(``repro/models/ffn.py:110-114``): one launch returns the route, the
per-expert counts and each (token, slot)'s position in its expert's
buffer.  :func:`moe_route_bwd_cuda` launches ``csrc/moe_route_bwd.cu``,
the gradient of the combine weights with respect to the logits, and the
operators ``repro_torch::moe_route`` / ``repro_torch::moe_route_bwd``
(:data:`moe_route_op`, :data:`moe_route_bwd_op`) join the two for autograd
and give their outputs' shapes on fake tensors.  Like the routing bindings
in :mod:`repro_torch.kernels.jsaq_route`, each binding checks device,
dtype, shape and contiguity, allocates the outputs with ``torch.empty``,
launches on PyTorch's current stream, raises if the launch reports an
error, and adds one to its ``launches`` count.  The libraries are built at
first use.

:func:`moe_positions_tiled` replays the kernel's schedule for the
positions in plain torch (warp ranks, the scan over warps, the prefix
inside a cluster and the look-back across clusters), so the CPU tests can
hold it against ``ref.moe_positions_ref``; change it with the kernel.
:func:`moe_route_bwd_tiled` replays the backward kernel's (its tiling of
tokens and lanes, the k-term sums and the scatter of dg in slot order),
held against ``jax.vjp`` of the reference router and
``ref.moe_route_weights_vjp_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.jsaq_route import _I, _P, _check, _lib, _raise_on
from repro_torch.kernels.ref import GATE_FNS

# Largest expert count the kernel takes: a lane owns at most 8 experts
# (kMaxExperts in csrc/moe_route.cu).
MAX_EXPERTS = 256
# Warps a block: at most kMaxWarps in csrc/moe_route.cu, and at least
# MOE_MIN_WARPS where the tokens allow; blocks a cluster at most (kCluster);
# lanes a warp.
MOE_MAX_WARPS = 32
MOE_MIN_WARPS = 16
MOE_CLUSTER = 8
LANES = 32
# A flag word carries its call's generation in its high 32 bits; a scratch
# is zeroed anew before its counter would wrap.
_GEN_LIMIT = 2**32


def moe_tiling(t: int, max_clusters: int) -> tuple[int, int, int, int]:
    """``(per_warp, warps, blocks, cluster)`` for ``t`` tokens on a card that
    holds ``max_clusters`` clusters of ``MOE_CLUSTER`` blocks at once, one
    block an SM.  One token a warp while the blocks hold a warp a token,
    else the fewest tokens a warp that fit; ``warps`` a block, at least
    ``MOE_MIN_WARPS`` (fewer blocks) and as few as reach the tokens; the
    blocks rounded up to whole clusters of ``cluster`` blocks (a grid of
    fewer than ``MOE_CLUSTER`` blocks is one cluster).  A warp or a block
    past the last token routes nothing and counts zero."""
    max_blocks = MOE_CLUSTER * max_clusters
    per_warp = max(1, -(-t // (MOE_MAX_WARPS * max_blocks)))
    units = -(-t // per_warp)  # warps with tokens
    warps = min(MOE_MAX_WARPS, max(MOE_MIN_WARPS, -(-units // max_blocks)))
    needed = -(-units // warps)
    cluster = min(MOE_CLUSTER, needed)
    return per_warp, warps, -(-needed // cluster) * cluster, cluster


class _Scratch:
    """One stream's look-back words, ``(MAX_EXPERTS, max_clusters)`` zeroed
    once when allocated, and the generation of its last call.  A word of
    another generation is never read as this call's, so no call resets it."""

    def __init__(self, dev: torch.device, max_clusters: int):
        self.flags = torch.zeros((MAX_EXPERTS, max_clusters), dtype=torch.int64, device=dev)
        self.gen = 0

    def next_gen(self) -> int:
        self.gen += 1
        if self.gen >= _GEN_LIMIT:
            self.flags.zero_()
            self.gen = 1
        return self.gen


_SCRATCH: dict[tuple[int, int], _Scratch] = {}


def _scratch(dev: torch.device, stream: int) -> _Scratch:
    """The scratch of (device, stream): two streams never share one."""
    key = (dev.index, stream)
    if key not in _SCRATCH:
        clusters = ctypes.c_int(0)
        query = _lib("moe_route", "moe_route_max_clusters", (ctypes.POINTER(ctypes.c_int),))
        _raise_on(query(ctypes.byref(clusters)), "moe_route")
        if clusters.value < 1:
            raise RuntimeError("moe_route: no cluster of its blocks fits on this card")
        _SCRATCH[key] = _Scratch(dev, clusters.value)
    return _SCRATCH[key]


def moe_route_cuda(
    logits: torch.Tensor, bias: torch.Tensor, top_k: int, *, gate_fn: str = "softmax"
):
    """CARE-biased top-k routing and capacity positions on the card; see
    ``ref.moe_route_ref`` and ``ref.moe_positions_ref``.

    ``logits`` is ``(T, E)`` float32 or bfloat16 with ``T >= 1`` and ``E <=
    256``, ``bias`` ``(E,)`` float32, ``1 <= top_k <= E``.  Returns ``(idx,
    weights, counts, pos)``: ``(T, k)`` int32, ``(T, k)`` float32, ``(E,)``
    int32, ``(T k,)`` int32.  Not for CUDA graph capture: each call passes
    a new generation number to the kernel.
    """
    if logits.device.type != "cuda":
        raise ValueError(f"moe_route_cuda needs a CUDA tensor, got {logits.device}")
    t, e = check_route_shapes(logits, top_k, gate_fn)
    dev = logits.device
    _check(logits, "logits", (t, e), dev, logits.dtype)
    _check(bias, "bias", (e,), dev, torch.float32)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("moe_route_cuda cannot be captured in a CUDA graph")
    launch = _lib(
        "moe_route", "moe_route_launch",
        (_P, _I, _P, _P, _P, _P, _P, _P, _I, ctypes.c_uint, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    )
    idx = torch.empty((t, top_k), dtype=torch.int32, device=dev)
    weights = torch.empty((t, top_k), dtype=torch.float32, device=dev)
    counts = torch.empty((e,), dtype=torch.int32, device=dev)
    pos = torch.empty((t * top_k,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        scratch = _scratch(dev, stream)
        per_warp, warps, blocks, cluster = moe_tiling(t, scratch.flags.shape[1])
        err = launch(
            logits.data_ptr(), int(logits.dtype == torch.bfloat16), bias.data_ptr(),
            idx.data_ptr(), weights.data_ptr(), counts.data_ptr(), pos.data_ptr(),
            scratch.flags.data_ptr(), scratch.flags.shape[1], scratch.next_gen(), t, e,
            top_k, int(gate_fn == "softmax"), per_warp, warps, blocks, cluster, stream,
        )
    _raise_on(err, "moe_route")
    moe_route_cuda.launches += 1
    return idx, weights, counts, pos


moe_route_cuda.launches = 0



def moe_route_bwd_cuda(
    logits: torch.Tensor, idx: torch.Tensor, grad_w: torch.Tensor, *, gate_fn: str = "softmax"
) -> torch.Tensor:
    """The gradient of the router's combine weights with respect to the
    ``(T, E)`` float32 logits on the card; see
    ``ref.moe_route_weights_vjp_ref``.  ``idx`` is the forward's ``(T, k)``
    int32 route, ``grad_w`` the ``(T, k)`` float32 upstream gradient.
    Returns ``(T, E)`` float32."""
    if logits.device.type != "cuda":
        raise ValueError(f"moe_route_bwd_cuda needs a CUDA tensor, got {logits.device}")
    if gate_fn not in GATE_FNS:
        raise ValueError(f"unknown gate_fn {gate_fn!r}; expected one of {GATE_FNS}")
    if logits.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"logits and idx must be 2-D, got {tuple(logits.shape)}, "
                         f"{tuple(idx.shape)}")
    dev = logits.device
    t, e = logits.shape
    k = idx.shape[1]
    if t < 1 or not 1 <= e <= MAX_EXPERTS or not 1 <= k <= e:
        raise ValueError(f"moe_route_bwd_cuda: no route for T={t} E={e} k={k}")
    _check(logits, "logits", (t, e), dev, torch.float32)
    _check(idx, "idx", (t, k), dev, torch.int32)
    _check(grad_w, "grad_w", (t, k), dev, torch.float32)
    launch = _lib("moe_route_bwd", "moe_route_bwd_launch", (_P, _P, _P, _P, _I, _I, _I, _I, _P))
    dlogits = torch.empty((t, e), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = launch(logits.data_ptr(), idx.data_ptr(), grad_w.data_ptr(), dlogits.data_ptr(),
                     t, e, k, int(gate_fn == "softmax"),
                     torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "moe_route_bwd")
    moe_route_bwd_cuda.launches += 1
    return dlogits


moe_route_bwd_cuda.launches = 0


# --------------------------------------------------------------------------
# the kernels as PyTorch operators
# --------------------------------------------------------------------------
#
# ``repro_torch::moe_route`` and ``repro_torch::moe_route_bwd`` wrap the two
# bindings as ``torch.library`` operators: the CUDA implementation is the
# binding (it launches or raises), the fake implementation gives the
# outputs' shapes, dtypes and strides and builds nothing (``launch/
# dryrun.py`` traces the step under ``FakeTensorMode``), and the route's
# gradient is the backward kernel.  The router multiplies no matrix, so it
# has no FLOP formula (``FlopCounterMode`` counts matrix products).


def check_route_shapes(logits: torch.Tensor, top_k: int, gate_fn: str) -> tuple[int, int]:
    """The refusals of :func:`moe_route_cuda` that depend on shapes and
    dtypes alone; returns ``(T, E)``."""
    if gate_fn not in GATE_FNS:
        raise ValueError(f"unknown gate_fn {gate_fn!r}; expected one of {GATE_FNS}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"logits must be float32 or bfloat16, got {logits.dtype}")
    if logits.dim() != 2:
        raise ValueError(f"logits must be (T, E), got shape {tuple(logits.shape)}")
    t, e = logits.shape
    if t < 1:
        raise ValueError("moe_route_cuda needs at least one token")
    if not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"moe_route_cuda takes 1..{MAX_EXPERTS} experts, got {e}")
    if not 1 <= top_k <= e:
        raise ValueError(f"top_k must be in [1, {e}], got {top_k}")
    return t, e


def _route_op(logits, bias, top_k: int, gate_fn: str):
    return moe_route_cuda(logits, bias, top_k, gate_fn=gate_fn)


moe_route_op = torch.library.custom_op(
    "repro_torch::moe_route", _route_op, mutates_args=(), device_types="cuda",
    schema="(Tensor logits, Tensor bias, int top_k, str gate_fn) "
           "-> (Tensor, Tensor, Tensor, Tensor)",
)


@moe_route_op.register_fake
def _route_fake(logits, bias, top_k, gate_fn):
    t, e = check_route_shapes(logits, top_k, gate_fn)
    return (logits.new_empty((t, top_k), dtype=torch.int32),
            logits.new_empty((t, top_k), dtype=torch.float32),
            logits.new_empty((e,), dtype=torch.int32),
            logits.new_empty((t * top_k,), dtype=torch.int32))


def _route_bwd_op(logits, idx, grad_w, gate_fn: str):
    return moe_route_bwd_cuda(logits, idx, grad_w, gate_fn=gate_fn)


moe_route_bwd_op = torch.library.custom_op(
    "repro_torch::moe_route_bwd", _route_bwd_op, mutates_args=(), device_types="cuda",
    schema="(Tensor logits, Tensor idx, Tensor grad_w, str gate_fn) -> Tensor",
)


@moe_route_bwd_op.register_fake
def _route_bwd_fake(logits, idx, grad_w, gate_fn):
    return logits.new_empty(logits.shape, dtype=torch.float32)


def _route_setup(ctx, inputs, output):
    logits, _bias, _top_k, gate_fn = inputs
    idx, _weights, counts, pos = output
    # idx, counts and pos take no gradient; the bias reaches only the argmax.
    ctx.mark_non_differentiable(idx, counts, pos)
    ctx.save_for_backward(logits, idx)
    ctx.gate_fn = gate_fn


def _route_grad(ctx, _g_idx, g_weights, _g_counts, _g_pos):
    logits, idx = ctx.saved_tensors
    if g_weights is None:
        return None, None, None, None
    d = moe_route_bwd_op(logits.to(torch.float32), idx, g_weights.contiguous(), ctx.gate_fn)
    return d.to(logits.dtype), None, None, None


moe_route_op.register_autograd(_route_grad, setup_context=_route_setup)


def launch_floor_cuda() -> None:
    """Launch one empty block on the current stream: the floor any launch
    pays.  A timing aid; it counts in no kernel's ``launches``."""
    launch = _lib("moe_route", "moe_empty_launch", (_P,))
    _raise_on(launch(torch.cuda.current_stream().cuda_stream), "moe_empty")


def moe_positions_tiled(
    idx: torch.Tensor, e: int, *, tile: int, warp: int, cluster: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's schedule for the positions, in plain torch.

    ``idx`` is the ``(T, k)`` route; a block routes ``tile`` consecutive
    tokens, a warp ``warp`` of them (``tile`` a multiple of ``warp``), and
    ``cluster`` consecutive blocks form a cluster (the kernel: ``warps x
    per_warp`` tokens a block, tiled by ``moe_tiling``).  Blocks start on token
    boundaries, so no block splits a token's k slots.  Per warp, each chunk
    of <= 32 slots of a token is ranked by ``__match_any_sync`` groups on
    top of the warp's running histogram; a scan over the block's warps
    gives each warp's offset and the block's count; a block's prefix in
    its cluster sums the counts of the cluster's blocks before it, and a
    cluster's prefix sums the counts of every cluster before it, 32
    clusters (a warp's lanes) a step.

    Returns ``(pos (T k,) int32, counts (E,) int32)``: the positions, and
    the last cluster's prefix plus its count.
    """
    t, k = idx.shape
    if tile % warp:
        raise ValueError(f"tile {tile} must be a multiple of warp {warp}")
    warps = tile // warp
    flat = idx.reshape(-1).long()
    rank = torch.empty(t * k, dtype=torch.int64)
    blocks = -(-(-(-t // tile)) // cluster) * cluster  # whole clusters
    hist = torch.zeros((blocks, warps, e), dtype=torch.int64)
    for blk in range(blocks):
        for wi in range(warps):
            h = hist[blk, wi]
            for tok in range(blk * tile + wi * warp, min(blk * tile + (wi + 1) * warp, t)):
                for c0 in range(0, k, LANES):
                    chunk = flat[tok * k + c0: tok * k + min(k, c0 + LANES)]
                    # Lane l's rank: its group's lanes below l (popc of
                    # peers & lanemask_lt), on top of the running count.
                    same = chunk[:, None] == chunk[None, :]
                    below = torch.tril(same, diagonal=-1).sum(1)
                    rank[tok * k + c0: tok * k + c0 + len(chunk)] = h[chunk] + below
                    h.index_add_(0, chunk, torch.ones_like(chunk))
    # A thread an expert: each warp's offset, running over the warps.
    offset = torch.zeros_like(hist)
    for wi in range(1, warps):
        offset[:, wi] = offset[:, wi - 1] + hist[:, wi - 1]
    count = offset[:, -1] + hist[:, -1]  # (blocks, E)
    # Each block's prefix in its cluster, and each cluster's count.
    per_cluster = count.reshape(-1, cluster, e)
    cta_base = torch.zeros_like(per_cluster)
    for r in range(1, cluster):
        cta_base[:, r] = cta_base[:, r - 1] + per_cluster[:, r - 1]
    total = per_cluster.sum(1)  # (clusters, E)
    # Each cluster's prefix: every cluster before it, LANES a step.
    cluster_base = torch.zeros_like(total)
    for cl in range(total.shape[0]):
        for p0 in range(0, cl, LANES):
            cluster_base[cl] += total[p0:min(cl, p0 + LANES)].sum(0)
    base = (cluster_base[:, None, :] + cta_base).reshape(blocks, e)
    block_of = torch.arange(t * k) // (tile * k)
    warp_of = (torch.arange(t * k) // k - block_of * tile) // warp
    pos = base[block_of, flat] + offset[block_of, warp_of, flat] + rank
    return pos.to(torch.int32), (cluster_base[-1] + total[-1]).to(torch.int32)


# Threads a block of csrc/moe_route_bwd.cu (kThreads); a token takes
# moe_bwd_tiling(E)[0] of them.
MOE_BWD_THREADS = 128


def moe_bwd_tiling(e: int) -> tuple[int, int]:
    """``(lanes, per_lane)``: the lanes of ``csrc/moe_route_bwd.cu`` a token
    takes for ``e`` experts, and the float4 chunks each lane owns (lane
    ``l``'s chunk ``v`` holds experts ``4 (l + lanes v)`` to ``+ 3``).
    Eight lanes from 9 chunks (33 experts) up, else the fewest lanes, a
    power of two, that give each chunk its own lane; only a lane's last
    chunk can fall past the row."""
    chunks = -(-e // 4)
    if chunks <= 8:
        return 1 << (chunks - 1).bit_length(), 1
    return 8, -(-chunks // 8)


def _butterfly(parts: torch.Tensor, op) -> torch.Tensor:
    """The kernel's xor-shuffle reduction over a token's lanes (the last
    dimension), in its order: every lane ends with lane 0's value."""
    lane = torch.arange(parts.shape[-1])
    off = parts.shape[-1] // 2
    while off:
        parts = op(parts, parts[..., lane ^ off])
        off //= 2
    return parts[..., 0]


def moe_route_bwd_tiled(
    logits: torch.Tensor, idx: torch.Tensor, grad_w: torch.Tensor, *, gate_fn: str = "softmax"
) -> torch.Tensor:
    """The backward kernel's schedule in plain torch: what
    ``ref.moe_route_weights_vjp_ref`` computes, by ``csrc/moe_route_bwd.cu``'s
    formula and order.

    A block takes ``MOE_BWD_THREADS // lanes`` consecutive tokens
    (:func:`moe_bwd_tiling`); a token's lanes each sum their own experts
    (the row max, and the softmax sum as a partial sum per float4
    component, ``(s0 + s1) + (s2 + s3)``) and their own slots ``j = l +
    lanes m``, in order, then reduce by butterfly: ``S = sum_j r_j`` and
    ``A = sum_j gw_j r_j`` (for the softmax, sums of ``exp(x - max)`` times
    the inverse row sum); ``Z = S + 1e-20`` and ``c = sum_j r_j dr_j = (A -
    (A / Z) S) / Z`` follow from the two sums.  ``dg`` is the scatter of
    the slots' ``dr_j``: the first slot naming an expert writes the sum of
    that expert's ``dr_j`` in slot order (times ``g (1 - g)`` for the
    sigmoid), so a repeated expert sums its slots; the softmax writes ``g_e
    (dg_e - c)`` for every expert, the sigmoid ``dg_e`` and 0 elsewhere.
    Returns ``(T, E)`` float32.
    """
    if gate_fn not in GATE_FNS:
        raise ValueError(f"unknown gate_fn {gate_fn!r}; expected one of {GATE_FNS}")
    t, e = logits.shape
    k = idx.shape[1]
    lanes, per_lane = moe_bwd_tiling(e)
    tokens = MOE_BWD_THREADS // lanes
    softmax = gate_fn == "softmax"
    # (lanes, per_lane, 4): the expert of lane l's chunk v, component q.
    lane_e = (4 * (torch.arange(lanes)[:, None, None] + lanes * torch.arange(per_lane)[:, None])
              + torch.arange(4))
    valid = lane_e < e
    owned = lane_e.clamp(max=e - 1)
    slot_lane = torch.arange(k) % lanes
    later = torch.arange(k)[None, :] > torch.arange(k)[:, None]  # [i, j]: i < j
    out = torch.empty((t, e), dtype=torch.float32, device=logits.device)

    for t0 in range(0, t, tokens):  # a block
        x = logits[t0:t0 + tokens].to(torch.float32)
        ids = idx[t0:t0 + tokens].long()
        gw = grad_w[t0:t0 + tokens].to(torch.float32)
        n = x.shape[0]

        def slot_sum(vals):
            parts = torch.zeros((n, lanes), dtype=torch.float32, device=x.device)
            for j in range(k):  # each lane's slots in order
                parts[:, slot_lane[j]] += vals[:, j]
            return _butterfly(parts, torch.add)

        xe = torch.gather(x, 1, ids)
        if softmax:
            xl = x[:, owned]
            m = _butterfly(torch.where(valid, xl, -torch.inf).flatten(2).amax(2), torch.maximum)
            g = torch.where(valid, torch.exp(xl - m[:, None, None, None]), 0.0)
            sq = torch.zeros((n, lanes, 4), dtype=torch.float32, device=x.device)
            for v in range(per_lane):
                sq = sq + g[:, :, v]
            inv = 1.0 / _butterfly((sq[..., 0] + sq[..., 1]) + (sq[..., 2] + sq[..., 3]),
                                   torch.add)
            g = g * inv[:, None, None, None]
            p = torch.exp(xe - m[:, None])
            s_r, s_a = slot_sum(p) * inv, slot_sum(gw * p) * inv
        else:
            r = 1.0 / (1.0 + torch.exp(-xe))
            s_r, s_a = slot_sum(r), slot_sum(gw * r)
        inv_z = 1.0 / (s_r + 1e-20)
        gw_dot_w = s_a * inv_z
        c = (s_a - gw_dot_w * s_r) * inv_z
        dr = (gw - gw_dot_w[:, None]) * inv_z[:, None]

        s = torch.zeros((n, k), dtype=torch.float32, device=x.device)
        first = torch.ones((n, k), dtype=torch.bool, device=x.device)
        for i in range(k):
            same = ids[:, i:i + 1] == ids
            s = s + torch.where(same, dr[:, i:i + 1], 0.0)
            first &= ~(same & later[i])
        if not softmax:
            s = s * r * (1.0 - r)
        dg = torch.zeros((n, e), dtype=torch.float32, device=x.device)
        rows = torch.arange(n, device=x.device)[:, None].expand(n, k)
        dg[rows[first], ids[first]] = s[first]
        if softmax:
            res = g * (dg[:, owned] - c[:, None, None, None])
            dg[:, lane_e[valid]] = res[:, valid]
        out[t0:t0 + n] = dg
    return out
