"""ctypes bindings of the hand-written Hopper routing kernels.

* :func:`jsaq_route_cuda` -- ``csrc/jsaq_route.cu``, which replaces the
  Pallas kernel ``jsaq_route_pallas`` (``repro/kernels/jsaq_route.py:169``)
  with a level fill: a few rounds a row in place of N argmins.  Its schedule
  is mirrored on the CPU by :func:`jsaq_route_levels`, which nothing on the
  main path calls (``tests/test_torch_jsaq_schedule.py``).
* :func:`care_route_cuda` -- ``csrc/care_route.cu``, which replaces
  ``care_route_pallas`` (``repro/kernels/jsaq_route.py:355``).  Its tile
  schedule is mirrored on the CPU by :func:`care_route_tiled`, which
  nothing on the main path calls (``tests/test_torch_care_schedule.py``).
* :func:`serve_route_cuda` -- ``csrc/serve_route.cu``, which replaces
  ``serve_route_pallas`` (``repro/kernels/jsaq_route.py:496``).  Its lane
  chain runs on one warp (``csrc/serve_lanes.cuh``), mirrored on the CPU by
  :func:`serve_lanes_warp`.
* :func:`serve_slots_cuda` -- the serving engine's whole fused slot loop in
  one launch (``serve_slots_kernel`` in ``csrc/serve_route.cu``), the
  card's counterpart of the reference's ``lax.scan`` around
  ``serve_route_pallas``.  Its plain version is the engine's per-slot loop
  (``serve.engine._serve_loop``, on the CPU or with ``route_backend=
  "dense"``), whose stages it runs in the loop's order: that loop with its
  route step through :func:`serve_lanes_warp` mirrors its schedule.
  Nothing on the main path calls the mirror: the tests hold it against
  the plain versions and the JAX package
  (``tests/test_torch_serve_schedule.py``).

Each binding checks device, dtype, shape and contiguity, allocates the
outputs (and the kernel's scratch) with ``torch.empty``, launches on
PyTorch's current stream, raises if the launch reports an error, and adds
one to its ``launches`` count.  The libraries are built at first use
(:mod:`repro_torch.kernels._build`), never at import.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import CARE_COMMS

_P = ctypes.c_void_p
_I = ctypes.c_int

# jsaq_route: the bins a thread scans per pass (kItems in
# csrc/jsaq_route.cu), which with the row's servers sets the block size, and
# the most bytes of a row's work space (histogram, list, rounds) kept in
# shared memory, a larger one going to device scratch: None for the most a
# block may opt in to on the card (jsaq_route_smem_max in the source).
JSAQ_ITEMS = 4
JSAQ_SMEM_MAX: int | None = None
_I32_MAX = 2**31 - 1

# Largest replica count serve_route and serve_slots take: a run's (R,) state
# lives in one block's shared memory (kMaxReplicas in csrc/serve_route.cu).
SERVE_MAX_REPLICAS = 8192
# Dynamic shared memory a serve_slots block may take: Hopper's 232,448 bytes
# a block, less 1 KB for the kernel's static shared memory.
SERVE_SMEM_MAX = 232_448 - 1024

# care_route's tile table (csrc/care_route.cu): servers a tile at the least,
# the most tiles a block's shared memory holds (20 B a tile), and the most
# warps a block.
CARE_TILE = 256
CARE_MAX_TILES = 8192
CARE_WARPS = 16
_CARE_NEVER = 2**31 - 1  # INT_MAX: a tile no rt trigger wakes
_CARE_POISON = -(2**20)  # care_route_tiled's value of a field the kernel does not read


def _threads(k: int) -> int:
    """Threads per block: one per server up to 1024, a multiple of 32."""
    return min(1024, max(32, (k + 31) // 32 * 32))


def _check(
    t: torch.Tensor, name: str, shape: tuple, device: torch.device,
    dtype: torch.dtype = torch.int32,
) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")


@functools.cache
def _lib(name: str, fn: str, argtypes: tuple) -> ctypes._CFuncPtr:
    f = getattr(_build.load(name), fn)
    f.argtypes = list(argtypes)
    f.restype = _I
    return f


def jsaq_max_rounds(num_jobs: int) -> int:
    """The most rounds of ``jsaq_route``'s level fill for ``num_jobs`` jobs:
    the largest d with d (d - 1) / 2 <= N - 1, since the d-th distinct level
    takes a job only after d (d - 1) / 2 jobs below it (at most
    ``floor((1 + sqrt(1 + 8 N)) / 2)``; 23 at N = 256)."""
    return (1 + math.isqrt(8 * num_jobs - 7)) // 2 if num_jobs > 0 else 0


def _jsaq_threads(k: int, n: int) -> int:
    """Threads a row of ``jsaq_route``: about ``JSAQ_ITEMS`` servers or bins
    each, a multiple of 32 up to 1024."""
    return min(1024, max(32, -(-max(k, n) // (JSAQ_ITEMS * 32)) * 32))


@functools.cache
def _jsaq_smem_max(device: torch.device) -> int:
    with torch.cuda.device(device):
        limit = _lib("jsaq_route", "jsaq_route_smem_max", ())()
    if limit < 0:
        raise RuntimeError(f"cannot read the shared memory limit of {device}")
    return limit


def jsaq_route_cuda(q_app: torch.Tensor, num_jobs: int):
    """Sequential JSAQ on the card as a level fill: ``(D, K)`` int32 ->
    ``(idx, q')``, equal to ``ref.jsaq_route_ref``.  A row's work space
    (``3 N + 3 jsaq_max_rounds(N)`` ints) is shared memory up to the most a
    block may opt in to (or ``JSAQ_SMEM_MAX`` bytes, if set), else a device
    scratch."""
    if q_app.device.type != "cuda":
        raise ValueError(f"jsaq_route_cuda needs a CUDA tensor, got {q_app.device}")
    d, k = q_app.shape
    if num_jobs < 0 or (num_jobs > 0 and k == 0):
        raise ValueError(f"cannot route {num_jobs} jobs over {k} servers")
    _check(q_app, "q_app", (d, k), q_app.device)
    launch = _lib(
        "jsaq_route", "jsaq_route_launch", (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    )
    rounds = jsaq_max_rounds(num_jobs)
    work = 3 * num_jobs + 3 * rounds
    idx = torch.empty((d, num_jobs), dtype=torch.int32, device=q_app.device)
    q_out = torch.empty_like(q_app)
    scratch = None
    smem_max = _jsaq_smem_max(q_app.device) if JSAQ_SMEM_MAX is None else JSAQ_SMEM_MAX
    if 4 * work > smem_max:
        scratch = torch.empty((d, work), dtype=torch.int32, device=q_app.device)
    with torch.cuda.device(q_app.device):
        err = launch(
            q_app.data_ptr(), idx.data_ptr(), q_out.data_ptr(), d, k, num_jobs, rounds,
            _jsaq_threads(k, num_jobs), None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "jsaq_route")
    jsaq_route_cuda.launches += 1
    return idx, q_out


jsaq_route_cuda.launches = 0


def jsaq_route_levels(q_app: torch.Tensor, num_jobs: int):
    """The level fill of ``csrc/jsaq_route.cu``, in plain PyTorch on the CPU.

    Per row, the kernel's passes: the minimum ``m``, the histogram of ``a =
    q - m`` below N, the fill level L and ``rem`` from ``cnt`` and ``P``,
    the rounds (distinct values of ``a`` whose level takes a job), the
    jobs of level L and ``q'`` from one pass over the row, the list of
    servers with ``a < L``, then each full round's levels from its ranks in
    that list.  int32 wraps as the chain does (every server at INT32_MAX,
    then server 0 takes the rest).  Nothing on the main path calls it: the
    tests hold it against ``ref.jsaq_route_ref`` and the JAX kernel, so
    that the schedule the kernel runs is checked where there is no card.

    Returns ``(idx, q_out, rounds)``: the two outputs of
    ``ref.jsaq_route_ref`` and the ``(D,)`` rounds of each row.
    """
    q = q_app.to(torch.int64)
    d, k = q.shape
    n = num_jobs
    if n < 0 or (n > 0 and k == 0):
        raise ValueError(f"cannot route {n} jobs over {k} servers")
    idx = torch.full((d, n), -1, dtype=torch.int32)  # a job no round places shows
    q_out = q_app.to(torch.int32).clone()
    rounds = torch.zeros((d,), dtype=torch.int64)
    if n == 0:
        return idx, q_out, rounds
    for row in range(d):
        m = int(q[row].min())
        a = q[row] - m
        h = torch.bincount(a[a < n], minlength=n)
        cnt = h.cumsum(0)
        p = cnt.cumsum(0) - cnt  # jobs placed below each level
        hit = torch.nonzero((p <= n) & (n < p + cnt))
        fill, rem = (int(hit[0, 0]), n - int(p[hit[0, 0]])) if len(hit) else (n, 0)
        levels = torch.nonzero((h > 0) & (p < n))[:, 0]
        rounds[row] = len(levels)
        top = _I32_MAX - m  # INT32_MAX's level
        wrap = top < n and int(p[top]) < n
        if wrap:
            fill, rem = top, 0
        full = levels[levels < fill].tolist()
        listed = torch.nonzero(a < fill)[:, 0]
        for j in reversed(range(len(full))):  # the kernel's warps take rounds in no order
            v = full[j]
            span = (full[j + 1] if j + 1 < len(full) else fill) - v
            srv = listed[a[listed] <= v]
            pos = int(p[v]) + torch.arange(span)[:, None] * int(cnt[v]) + torch.arange(len(srv))
            idx[row, pos.reshape(-1)] = srv.repeat(span).to(torch.int32)
        le = a <= fill
        rank = le.cumsum(0) - le.long()
        extra = le & (rank < rem)
        idx[row, n - rem + rank[extra]] = torch.nonzero(extra)[:, 0].to(torch.int32)
        out = torch.where(le, m + fill + extra.long(), q[row])
        if wrap:
            out[0] += n - int(p[top])
            idx[row, int(p[top]):] = 0
        q_out[row] = ((out + 2**31) % 2**32 - 2**31).to(torch.int32)
    return idx, q_out, rounds


def care_tile(servers: int) -> int:
    """Servers a tile of ``care_route``'s tile table: ``CARE_TILE``, or the
    least multiple of 32 that keeps K within ``CARE_MAX_TILES`` tiles."""
    need = -(-servers // CARE_MAX_TILES)
    return max(CARE_TILE, -(-need // 32) * 32)


def _care_schedule(comm: str, x: int, rt_period: int) -> tuple[bool, bool]:
    """``(rt_kind, dense)`` of one run.  Under rt and et_rt a server at rest
    triggers when its slot counter reaches ``rt_period``; under dt, et and
    et_rt with ``x <= 0`` (and rt / et_rt with ``rt_period <= 1``) every
    server may trigger in every slot, so every tile is due every slot."""
    rt_kind = comm in ("rt", "et_rt")
    dense = (comm in ("dt", "et", "et_rt") and x <= 0) or (rt_kind and rt_period <= 1)
    return rt_kind, dense


def _check_care(policy: str, comm: str, servers: int) -> None:
    if policy not in ("jsq", "jsaq"):
        raise ValueError(f"care_route supports policies 'jsq'/'jsaq', got {policy!r}")
    if comm not in CARE_COMMS:
        raise ValueError(f"unknown communication kind: {comm}")
    if servers < 1:
        raise ValueError(f"servers must be >= 1, got {servers}")


def care_route_cuda(
    arrive: torch.Tensor,
    params: torch.Tensor,
    *,
    servers: int,
    cap: int,
    policy: str,
    comm: str,
):
    """The fused CARE slot loop on the card; see ``ref.care_route_ref``.
    A block of ``min(CARE_WARPS, tiles)`` warps a run."""
    if arrive.device.type != "cuda":
        raise ValueError(f"care_route_cuda needs a CUDA tensor, got {arrive.device}")
    _check_care(policy, comm, servers)
    dev = arrive.device
    d, t = arrive.shape
    _check(arrive, "arrive", (d, t), dev)
    _check(params, "params", (d, 4), dev)
    tile = care_tile(servers)
    n_tiles = -(-servers // tile)
    launch = _lib(
        "care_route", "care_route_launch",
        (_P, _P, _P, _P, _P, _P, _P) + (_I,) * 9 + (_P,),
    )
    routed = torch.empty((d, t), dtype=torch.int32, device=dev)
    q_true = torch.empty((d, servers), dtype=torch.int32, device=dev)
    per_srv = torch.empty((d, servers), dtype=torch.int32, device=dev)
    stats = torch.empty((d, 8), dtype=torch.int32, device=dev)
    # qa, hr, eh, ds, ss: the kernel reads a field only after it wrote it.
    scratch = torch.empty((d, 5, servers), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = launch(
            arrive.data_ptr(), params.data_ptr(), routed.data_ptr(),
            q_true.data_ptr(), per_srv.data_ptr(), stats.data_ptr(),
            scratch.data_ptr(), d, t, servers, cap, int(policy == "jsaq"),
            CARE_COMMS.index(comm), tile, n_tiles, 32 * min(CARE_WARPS, n_tiles),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "care_route")
    care_route_cuda.launches += 1
    return routed, q_true, per_srv, stats


care_route_cuda.launches = 0


def care_route_tiled(
    arrive: torch.Tensor,
    params: torch.Tensor,
    *,
    servers: int,
    cap: int,
    policy: str,
    comm: str,
    tile: int,
):
    """The schedule of ``csrc/care_route.cu``, in plain Python on the CPU.

    Same arithmetic as the kernel, tile by tile: a tile table (live flag,
    last slot visited, first slot an rt trigger wakes it), a tile visited
    only when due (live, or holding the slot's arrival, or rt-due, or every
    slot when ``_care_schedule`` says dense), the slot counter of a tile at
    rest advanced lazily at its next visit, only the fields the kernel
    loads read (the others poisoned, so that reading one would show), and
    the route of the next slot taken from the visited tiles' partial
    argmins and the first index of the lowest tile not visited.
    Nothing on the main path calls it: the tests hold it against
    ``ref.care_route_ref`` and the JAX kernel, so that the schedule the
    kernel runs is checked where there is no card.

    Returns ``(routed, q_true, per_srv, stats, visits)``: the four outputs
    of ``ref.care_route_ref`` and the ``(D,)`` tile visits of each run.
    """
    _check_care(policy, comm, servers)
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    d, t = arrive.shape
    routed = torch.full((d, t), -1, dtype=torch.int32)
    q_true = torch.zeros((d, servers), dtype=torch.int32)
    per_srv = torch.zeros((d, servers), dtype=torch.int32)
    stats = torch.zeros((d, 8), dtype=torch.int32)
    visits = torch.zeros((d,), dtype=torch.int64)
    arr_rows = (arrive.cpu() > 0).tolist()
    for run, (x, rt_period, msr, horizon) in enumerate(params.cpu().tolist()):
        counters, visits[run] = _care_run(
            arr_rows[run][: min(t, max(horizon, 0))], x, rt_period, msr, servers,
            cap, policy == "jsaq", comm, tile, routed[run], q_true[run], per_srv[run],
        )
        stats[run, :7] = torch.tensor(counters, dtype=torch.int32)
    return routed, q_true, per_srv, stats, visits


def _care_field(src, lo, hi, alive, start):
    """A tile's copy of one state field, as the kernel loads it: ``start``
    where the kernel sets it without a load, the stored values where it
    loads them, and poison where the field is dead (the kernel neither
    loads nor uses it), so that a read of a dead field shows in the outputs."""
    if not alive:
        return torch.full((hi - lo,), _CARE_POISON, dtype=torch.int32)
    if start is not None:
        return torch.full((hi - lo,), start, dtype=torch.int32)
    return src[lo:hi].clone()


def _care_run(arr, x, rt_period, msr, k, cap, jsaq, comm, tile, routed, q, ps):
    """One run of ``care_route_tiled``; fills ``routed``, ``q`` and ``ps``
    in place and returns the seven counters and the tile visits."""
    n_tiles = -(-k // tile)
    rt_kind, dense = _care_schedule(comm, x, rt_period)
    # Scratch state starts poisoned, as the kernel's starts unset.
    qa, hr, eh, ds, ss = (torch.full((k,), _CARE_POISON, dtype=torch.int32) for _ in range(5))
    due0 = -1 + max(1, rt_period) if rt_kind else _CARE_NEVER
    last, due, live = [-1] * n_tiles, [due0] * n_tiles, [False] * n_tiles
    live_list, next_rt, route = [], due0, 0
    msgs = deps = arrs = drops = max_aq = max_q = gap = visits = 0
    for s, a in enumerate(arr):
        j, tj = route, route // tile
        todo = list(range(n_tiles)) if dense else list(live_list)
        if not dense and a and not live[tj]:
            todo.append(tj)
        scan = rt_kind and not dense and s >= next_rt
        acc = _CARE_NEVER
        if scan:
            for i in range(n_tiles):
                if a and i == tj:
                    continue
                if due[i] <= s:
                    todo.append(i)
                else:
                    acc = min(acc, due[i])
        assert len(set(todo)) == len(todo), f"a tile visited twice in slot {s}"
        best, qmax_s, qmin_s, live_list = (_CARE_NEVER, _CARE_NEVER), 0, _CARE_NEVER, []
        for i in todo:
            lo, hi = i * tile, min(k, (i + 1) * tile)
            active = live[i] or (a and lo <= j < hi)
            fresh = last[i] < 0  # ds and ss start from 0
            # At rest q = qa = 0, and hr and eh are dead until an admit.
            qv = _care_field(q, lo, hi, True, None if live[i] else 0)
            qav = _care_field(qa, lo, hi, True, None if live[i] else 0)
            hrv = _care_field(hr, lo, hi, live[i], None)
            ehv = _care_field(eh, lo, hi, live[i], None)
            dsv = _care_field(ds, lo, hi, comm == "dt", 0 if fresh else None)
            ssv = _care_field(ss, lo, hi, rt_kind, 0 if fresh else None) + (s - 1 - last[i])
            if a and lo <= j < hi:
                o = j - lo
                if qv[o] < cap:
                    if qv[o] == 0:
                        hrv[o] = msr
                    qv[o] += 1
                    if qav[o] == 0:
                        ehv[o] = msr
                    qav[o] += 1
                    ps[j] += 1
                    arrs += 1
                    routed[s] = j
                else:
                    drops += 1
            busy = qv > 0
            hrv = torch.where(busy, hrv - 1, hrv)
            dep = busy & (hrv <= 0)
            qv = torch.where(dep, qv - 1, qv)
            hrv = torch.where(dep & (qv > 0), msr, hrv)
            ticking = qav > 0
            ehv = torch.where(ticking, ehv - 1, ehv)
            dep_e = ticking & (ehv <= 0)
            qav = torch.where(dep_e, qav - 1, qav)
            ehv = torch.where(dep_e, msr, ehv)
            err = (qv - qav).abs()
            dsa = dsv + dep.to(torch.int32)
            ssa = ssv + 1
            trig = {
                "rt": ssa >= rt_period,
                "dt": dsa >= x,
                "et": err >= x,
                "et_rt": (err >= x) | (ssa >= rt_period),
                "exact": dep,
                "none": torch.zeros_like(dep),
            }[comm]
            deps += int(dep.sum())
            msgs += int((dep if comm == "exact" else trig).sum())
            dsv = torch.where(trig, 0, dsa)
            ssv = torch.where(trig, 0, ssa)
            qav = torch.where(trig, qv, qav)
            ehv = torch.where(trig, msr, ehv)
            if active:
                q[lo:hi], qa[lo:hi], hr[lo:hi], eh[lo:hi] = qv, qav, hrv, ehv
            if comm == "dt":
                ds[lo:hi] = dsv
            if rt_kind:
                ss[lo:hi] = ssv
            # The tile's partials: argmin (lowest index), extrema, live flag
            # and, at rest, the first slot an rt trigger wakes it.
            score = qav if jsaq else qv
            best = min(best, (int(score.min()), lo + int(torch.argmin(score))))
            max_aq = max(max_aq, int((qv - qav).abs().max()))
            qmax_s, qmin_s = max(qmax_s, int(qv.max())), min(qmin_s, int(qv.min()))
            last[i] = s
            live[i] = bool(((qv > 0) | (qav > 0)).any())
            if live[i]:
                live_list.append(i)
                due[i] = _CARE_NEVER
            elif rt_kind:
                wake = int((rt_period - ssv.to(torch.int64)).clamp(min=1).min())
                due[i] = min(s + wake, _CARE_NEVER)
                acc = min(acc, due[i])
            else:
                due[i] = _CARE_NEVER
        visits += len(todo)
        if len(todo) < n_tiles:
            # The lowest tile not visited is at rest: all its scores are 0.
            u = next(i for i in range(n_tiles) if last[i] != s)
            best = min(best, (0, u * tile))
            qmin_s = 0
        route = best[1]
        max_q = max(max_q, qmax_s)
        gap = max(gap, qmax_s - qmin_s)
        if rt_kind:
            next_rt = acc if scan else min(next_rt, acc)
    return (msgs, deps, arrs, drops, max_aq, max_q, gap), visits


def _check_serve(comm: str, cap: int, r: int, kernel: str) -> None:
    if comm not in CARE_COMMS:
        raise ValueError(f"unknown communication kind: {comm}")
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    if not 1 <= r <= SERVE_MAX_REPLICAS:
        raise ValueError(f"{kernel} takes 1..{SERVE_MAX_REPLICAS} replicas, got {r}")


def serve_route_cuda(
    tie_u: torch.Tensor,
    q_len: torch.Tensor,
    q_head: torch.Tensor,
    busy_cnt: torch.Tensor,
    approx: torch.Tensor,
    n_arr: torch.Tensor,
    act: torch.Tensor,
    *,
    cap: int,
    comm: str,
):
    """One serving slot's arrival lanes for D runs on the card; see
    ``ref.serve_route_ref``.  Takes at most ``SERVE_MAX_REPLICAS`` replicas."""
    if tie_u.device.type != "cuda":
        raise ValueError(f"serve_route_cuda needs a CUDA tensor, got {tie_u.device}")
    dev = tie_u.device
    d, a_n = tie_u.shape
    r = q_len.shape[-1]
    _check_serve(comm, cap, r, "serve_route_cuda")
    smem = 4 * (4 * r + 2 * (-(-r // 32)) + 2 * a_n)
    if smem > SERVE_SMEM_MAX:
        raise ValueError(
            f"serve_route_cuda: {r} replicas with {a_n} lanes need {smem} B of shared "
            f"memory a block, more than {SERVE_SMEM_MAX}"
        )
    _check(tie_u, "tie_u", (d, a_n), dev, torch.float32)
    for name, t in (("q_len", q_len), ("q_head", q_head), ("busy_cnt", busy_cnt)):
        _check(t, name, (d, r), dev)
    _check(approx, "approx", (d, r), dev, torch.float32)
    _check(n_arr, "n_arr", (d,), dev)
    _check(act, "act", (d,), dev, torch.bool)
    launch = _lib(
        "serve_route", "serve_route_launch",
        (_P,) * 12 + (_I,) * 6 + (_P,),
    )
    jv = torch.empty((d, a_n), dtype=torch.int32, device=dev)
    tail = torch.empty((d, a_n), dtype=torch.int32, device=dev)
    admit = torch.empty((d, a_n), dtype=torch.bool, device=dev)
    q_len_out = torch.empty_like(q_len)
    approx_out = torch.empty_like(approx)
    drops = torch.empty((d,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = launch(
            q_len.data_ptr(), q_head.data_ptr(), busy_cnt.data_ptr(),
            approx.data_ptr(), n_arr.data_ptr(), act.data_ptr(), jv.data_ptr(),
            tail.data_ptr(), admit.data_ptr(), q_len_out.data_ptr(),
            approx_out.data_ptr(), drops.data_ptr(), d, a_n, r, cap,
            int(comm == "exact"), _threads(r),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "serve_route")
    serve_route_cuda.launches += 1
    return jv, tail, admit, q_len_out, approx_out, drops


serve_route_cuda.launches = 0


# ---------------------------------------------------------------------------
# serve_slots: the fused serving slot loop in one launch.
# ---------------------------------------------------------------------------


def serve_slots_smem(r: int, decode_slots: int, lanes: int, comm: str,
                     use_rates: bool, stream: bool = False) -> tuple[int, bool]:
    """Dynamic shared memory of a ``serve_slots`` block, and whether ``rem``
    and ``arid`` ((S, R) int32 each) are in it.

    A run keeps ``q_len``, ``q_head``, ``approx`` and the busy count, plus
    the deps counter under dt and the slot counter under rt and et_rt (both
    in ``stream`` mode, whose carry holds them), the rates under
    ``use_rates``, the minima of its 32-replica sub-blocks and
    one slot's ``work`` and ``rid`` lanes and the chain's replica and ring
    position of each lane, 4 bytes each; ``rem`` and
    ``arid`` join them when the block still fits in ``SERVE_SMEM_MAX``, else
    they stay in device scratch.  Raises ``ValueError`` when even the rest
    does not fit.
    """
    fields = (4 + (stream or comm == "dt") + (stream or comm in ("rt", "et_rt"))
              + bool(use_rates))
    base = 4 * (fields * r + 2 * (-(-r // 32)) + 4 * lanes)
    if base > SERVE_SMEM_MAX:
        raise ValueError(
            f"serve_slots: {r} replicas with {lanes} arrival lanes need {base} B "
            f"of shared memory a block, more than {SERVE_SMEM_MAX}"
        )
    rem = 8 * decode_slots * r
    if base + rem <= SERVE_SMEM_MAX:
        return base + rem, True
    return base, False


# The carry dict serve_slots resumes from in stream mode (the engine's
# _slots_view): name -> (dtype, shape from (D, R, S, cap)).
SLOTS_CARRY = {
    "q_len": (torch.int32, "DR"), "q_head": (torch.int32, "DR"),
    "approx": (torch.float32, "DR"), "q_work": (torch.int32, "DRC"),
    "q_rid": (torch.int32, "DRC"), "rem": (torch.int32, "DRS"),
    "arid": (torch.int32, "DRS"), "deps_since_msg": (torch.int32, "DR"),
    "slots_since_msg": (torch.int32, "DR"), "msgs": (torch.int32, "D"),
    "total_comp": (torch.int32, "D"), "dropped": (torch.int32, "D"),
    "count": (torch.int32, "D"), "mean": (torch.float32, "D"),
    "m2": (torch.float32, "D"), "max_jct": (torch.int32, "D"),
    "hist": (torch.int32, "DH"),
}
HIST_BUCKETS = 119  # kHistBuckets in csrc/serve_route.cu


def serve_slots_cuda(
    n_arr: torch.Tensor,
    work: torch.Tensor,
    rid: torch.Tensor | None,
    x: torch.Tensor,
    rt_period: torch.Tensor,
    msr_drain: torch.Tensor,
    rates: torch.Tensor,
    horizon: torch.Tensor,
    *,
    cap: int,
    comm: str,
    decode_slots: int,
    use_rates: bool,
    trace_occupancy: bool,
    n_cap: int,
    t_end: int,
    carry: dict | None = None,
    t0: int = 0,
    warmup: torch.Tensor | None = None,
) -> dict:
    """Slots ``[t0, t0 + t_end)`` of the serving engine's fused slot loop
    for D runs, in one launch.

    Args:
      n_arr: ``(T, D)`` int32 arrivals per slot and run.
      work / rid: ``(T, D, A)`` int32 arrival lanes (``rid`` unread, and
        may be None, in stream mode).
      x / msr_drain: ``(D,)`` float32; rt_period / horizon: ``(D,)`` int32,
        the horizon an absolute slot.
      rates: ``(D, R)`` float32 decode rates, read under ``use_rates``
        only (without it the engine's rates are ones, so the drain is
        ``msr_drain`` and every busy decode slot works one unit).
      n_cap: entries of the rid-indexed ``comp_slot`` (fixed mode).
      t_end: slots to run; run ``d`` stops at ``min(horizon[d] - t0,
        t_end)``.
      carry: stream mode.  The dict of :data:`SLOTS_CARRY` (the engine's
        ``_slots_view``): the loop resumes from it at absolute slot ``t0``,
        stores each lane's arrival slot in its ring entry, folds the JCTs
        of the completions at or past ``warmup`` ``(D,)`` int32 into
        ``count`` / ``mean`` / ``m2`` / ``max_jct`` / ``hist``, and writes
        the carry back in place.

    Fixed mode (no ``carry``) starts from an empty engine at slot 0 and
    returns ``comp_slot`` ``(D, n_cap)``, ``msgs``, ``total_comp``,
    ``dropped`` ``(D,)``, ``final_occ`` ``(D, R)``, ``occupancy`` ``(D, T,
    R)`` (None unless ``trace_occupancy``) and the end-of-run routing state
    ``q_len``, ``q_head``, ``approx`` and ``busy`` ``(D, R)``.  Stream mode
    returns ``carry``.
    """
    if work.device.type != "cuda":
        raise ValueError(f"serve_slots_cuda needs a CUDA tensor, got {work.device}")
    dev = work.device
    t_n, d, a_n = work.shape
    r = rates.shape[-1]
    stream = carry is not None
    _check_serve(comm, cap, r, "serve_slots_cuda")
    if decode_slots < 1:
        raise ValueError(f"decode_slots must be >= 1, got {decode_slots}")
    if not 0 <= t_end <= t_n:
        raise ValueError(f"t_end must be in [0, {t_n}], got {t_end}")
    if n_cap < 0:
        raise ValueError(f"n_cap must be >= 0, got {n_cap}")
    if t0 < 0 or t0 + t_end > _I32_MAX:
        raise ValueError(f"slots [{t0}, {t0 + t_end}) leave the int32 slot clock")
    _check(n_arr, "n_arr", (t_n, d), dev)
    _check(work, "work", (t_n, d, a_n), dev)
    if not stream:
        _check(rid, "rid", (t_n, d, a_n), dev)
    for name, t, dtype in (
        ("x", x, torch.float32), ("rt_period", rt_period, torch.int32),
        ("msr_drain", msr_drain, torch.float32), ("horizon", horizon, torch.int32),
    ):
        _check(t, name, (d,), dev, dtype)
    _check(rates, "rates", (d, r), dev, torch.float32)
    smem, rem_smem = serve_slots_smem(r, decode_slots, a_n, comm, use_rates, stream)
    launch = _lib("serve_route", "serve_slots_launch", (_P,) * 32 + (_I,) * 15 + (_P,))

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    if stream:
        if trace_occupancy:
            raise ValueError("serve_slots traces no occupancy in stream mode")
        _check(warmup, "warmup", (d,), dev)
        sizes = {"D": d, "R": r, "S": decode_slots, "C": cap, "H": HIST_BUCKETS}
        if set(carry) != set(SLOTS_CARRY):
            raise ValueError(f"carry must hold {sorted(SLOTS_CARRY)}, got {sorted(carry)}")
        for name, (dtype, dims) in SLOTS_CARRY.items():
            _check(carry[name], name, tuple(sizes[c] for c in dims), dev, dtype)
        state, out = carry, carry
        extra = dict(comp_slot=None, final_occ=None, occupancy=None, busy=None)
    else:
        if t0:
            raise ValueError("the fixed horizon starts at slot 0")
        state = dict(q_len=empty(d, r), q_head=empty(d, r),
                     approx=empty(d, r, dtype=torch.float32),
                     deps_since_msg=empty(d, r), slots_since_msg=empty(d, r),
                     msgs=empty(d), total_comp=empty(d), dropped=empty(d),
                     # The rings are read only where the chain wrote them.
                     q_work=empty(d, r, cap), q_rid=empty(d, r, cap))
        extra = dict(comp_slot=empty(d, n_cap), final_occ=empty(d, r),
                     occupancy=empty(d, t_n, r) if trace_occupancy else None,
                     busy=empty(d, r))
        out = {key: state[key] for key in ("msgs", "total_comp", "dropped", "q_len",
                                           "q_head", "approx")}
        out.update(extra)
    rem_g = arid_g = None
    if not rem_smem:  # set by the kernel before it reads them
        rem_g, arid_g = empty(d, decode_slots, r), empty(d, decode_slots, r)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def field(name):
        return ptr(state.get(name))

    with torch.cuda.device(dev):
        err = launch(
            n_arr.data_ptr(), work.data_ptr(), None if stream else rid.data_ptr(),
            x.data_ptr(), rt_period.data_ptr(), msr_drain.data_ptr(), rates.data_ptr(),
            horizon.data_ptr(), ptr(warmup) if stream else None,
            ptr(extra["comp_slot"]), ptr(extra["final_occ"]), ptr(extra["occupancy"]),
            ptr(extra["busy"]), field("q_len"), field("q_head"), field("approx"),
            field("q_work"), field("q_rid"), field("rem"), field("arid"),
            field("deps_since_msg"), field("slots_since_msg"), field("msgs"),
            field("total_comp"), field("dropped"), field("count"), field("mean"),
            field("m2"), field("max_jct"), field("hist"), ptr(rem_g), ptr(arid_g),
            d, t_n, t_end, t0, a_n, r, decode_slots, cap, n_cap, CARE_COMMS.index(comm),
            int(use_rates), int(rem_smem), int(stream), _threads(r), smem,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "serve_slots")
    serve_slots_cuda.launches += 1
    return out


serve_slots_cuda.launches = 0


# ---------------------------------------------------------------------------
# CPU mirror of csrc/serve_lanes.cuh (change both together).  Plain Python,
# step for step as the warp runs.
# ---------------------------------------------------------------------------

_NO_KEY = 0xFFFFFFFF
_NO_IDX = 2**31 - 1


def score_key(x) -> int:
    """``score_key`` of ``csrc/serve_lanes.cuh``: the order-preserving
    uint32 of a float32 score, ``-0.0`` folded into ``+0.0`` first."""
    v = np.float32(x)
    if v == 0:
        v = np.float32(0.0)
    b = int(v.view(np.uint32))
    return (~b & 0xFFFFFFFF) if b & 0x80000000 else b | 0x80000000


class _WarpRow:
    """One run's routing state as the kernel keeps it in shared memory:
    Python lists of ints and ``np.float32``, and the sub-block minima."""

    def __init__(self, q_len, q_head, approx, busy, cap: int, exact: bool):
        self.q_len, self.q_head, self.busy = list(q_len), list(q_head), list(busy)
        self.approx = [np.float32(v) for v in approx]
        self.r, self.cap, self.exact = len(self.q_len), cap, exact
        self.sub = [(_NO_KEY, _NO_IDX)] * (-(-self.r // 32))

    def key(self, e: int) -> int:
        if e >= self.r:
            return _NO_KEY
        if self.exact:
            return score_key(np.float32(self.q_len[e] + self.busy[e]))
        return score_key(self.approx[e])

    def sub_minima(self) -> None:
        """One warp's reduce and ballot over the 32 keys of each sub-block."""
        for sb in range(len(self.sub)):
            keys = [self.key(sb * 32 + lane) for lane in range(32)]
            m = min(keys)
            self.sub[sb] = (m, sb * 32 + keys.index(m))

    def chain(self, n_live: int):
        """``serve_chain``: returns ``(stop, j, tail, reads, admitted)``,
        ``reads`` the most entries one rescan read and ``admitted`` the
        ``(j, q_head[j] + len)`` of lanes ``[0, stop)``, whose ring tail
        (the remainder by cap) is taken after the chain."""
        n_sub = len(self.sub)
        spl = -(-n_sub // 32)
        lanes = []
        for lane in range(32):
            best = (_NO_KEY, _NO_IDX)
            for i in range(spl):
                sb = lane * spl + i
                if sb < n_sub and self.sub[sb][0] < best[0]:
                    best = self.sub[sb]
            lanes.append(best)
        a, reads, admitted = 0, 0, []
        while True:
            m = min(k for k, _ in lanes)
            owner = [k for k, _ in lanes].index(m)
            j = lanes[owner][1]
            length = self.q_len[j]
            if a >= n_live or length >= self.cap:
                break
            bumped = self.approx[j] + np.float32(1.0)
            new_key = score_key(
                np.float32(length + 1 + self.busy[j]) if self.exact else bumped
            )
            admitted.append((j, self.q_head[j] + length))
            self.q_len[j], self.approx[j] = length + 1, bumped
            sb = j // 32
            keys = [new_key if sb * 32 + lane == j else self.key(sb * 32 + lane)
                    for lane in range(32)]
            lk = min(keys)
            best = (lk, sb * 32 + keys.index(lk))
            n_read = 32
            if spl > 1:
                self.sub[sb] = best
                cand = [
                    self.sub[owner * spl + lane]
                    if lane < spl and owner * spl + lane < n_sub else (_NO_KEY, _NO_IDX)
                    for lane in range(32)
                ]
                k2 = [k for k, _ in cand]
                best = cand[k2.index(min(k2))]
                n_read += spl
            lanes[owner] = best
            reads = max(reads, n_read)
            a += 1
        return a, j, (self.q_head[j] + length) % self.cap, reads, admitted


def serve_lanes_warp(
    tie_u: torch.Tensor,
    q_len: torch.Tensor,
    q_head: torch.Tensor,
    busy_cnt: torch.Tensor,
    approx: torch.Tensor,
    n_arr: torch.Tensor,
    act: torch.Tensor,
    *,
    cap: int,
    comm: str,
):
    """The lane chain of ``serve_route_kernel`` in plain Python on the CPU.

    Same inputs and outputs as ``ref.serve_route_ref``, computed the way
    one warp computes them: owner ranges of 32-replica sub-blocks, keys with
    ``-0.0`` folded, a rescan of the bumped replica's sub-block (and of the
    owner's sub-block minima above R = 1024), and the chain stopped at the
    first drop, whose replica the rest of the lanes receive.  Returns the
    six outputs of ``ref.serve_route_ref`` and a ``(D,)`` int64 tensor: the
    most entries one rescan read in each run.
    """
    d, a_n = tie_u.shape
    _check_serve(comm, cap, q_len.shape[-1], "serve_lanes_warp")
    jv = torch.empty((d, a_n), dtype=torch.int32)
    tail = torch.empty((d, a_n), dtype=torch.int32)
    admit = torch.zeros((d, a_n), dtype=torch.bool)
    q_out = torch.empty_like(q_len)
    ap_out = torch.empty_like(approx)
    drops = torch.empty((d,), dtype=torch.int32)
    reads = torch.zeros((d,), dtype=torch.int64)
    for run in range(d):
        row = _WarpRow(q_len[run].tolist(), q_head[run].tolist(),
                       approx[run].numpy(), busy_cnt[run].tolist(), cap, comm == "exact")
        row.sub_minima()
        n_live = min(max(int(n_arr[run]), 0), a_n) if bool(act[run]) else 0
        stop, j, t, reads[run], admitted = row.chain(n_live)
        for a, (ja, raw) in enumerate(admitted):
            jv[run, a], tail[run, a], admit[run, a] = ja, raw % cap, True
        jv[run, stop:], tail[run, stop:] = j, t
        q_out[run] = torch.tensor(row.q_len, dtype=torch.int32)
        ap_out[run] = torch.from_numpy(np.array(row.approx, dtype=np.float32))
        drops[run] = n_live - stop
    return jv, tail, admit, q_out, ap_out, drops, reads
