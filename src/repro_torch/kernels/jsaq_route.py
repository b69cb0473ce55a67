"""ctypes bindings of the hand-written Hopper routing kernels.

* :func:`jsaq_route_cuda` -- ``csrc/jsaq_route.cu``, which replaces the
  Pallas kernel ``jsaq_route_pallas`` (``repro/kernels/jsaq_route.py:169``).
* :func:`care_route_cuda` -- ``csrc/care_route.cu``, which replaces
  ``care_route_pallas`` (``repro/kernels/jsaq_route.py:355``).
* :func:`serve_route_cuda` -- ``csrc/serve_route.cu``, which replaces
  ``serve_route_pallas`` (``repro/kernels/jsaq_route.py:496``).

Each binding checks device, dtype, shape and contiguity, allocates the
outputs (and the kernel's scratch) with ``torch.empty``, launches on
PyTorch's current stream, raises if the launch reports an error, and adds
one to its ``launches`` count.  The libraries are built at first use
(:mod:`repro_torch.kernels._build`), never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import CARE_COMMS

_P = ctypes.c_void_p
_I = ctypes.c_int

# Largest replica count serve_route takes: its four (R,) state arrays live in
# one block's shared memory (kMaxReplicas in csrc/serve_route.cu).
SERVE_MAX_REPLICAS = 8192


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


def jsaq_route_cuda(q_app: torch.Tensor, num_jobs: int):
    """Sequential JSAQ on the card: ``(D, K)`` int32 -> ``(idx, q')``."""
    if q_app.device.type != "cuda":
        raise ValueError(f"jsaq_route_cuda needs a CUDA tensor, got {q_app.device}")
    d, k = q_app.shape
    if num_jobs < 0 or (num_jobs > 0 and k == 0):
        raise ValueError(f"cannot route {num_jobs} jobs over {k} servers")
    _check(q_app, "q_app", (d, k), q_app.device)
    launch = _lib("jsaq_route", "jsaq_route_launch", (_P, _P, _P, _I, _I, _I, _I, _P))
    idx = torch.empty((d, num_jobs), dtype=torch.int32, device=q_app.device)
    q_out = torch.empty_like(q_app)
    with torch.cuda.device(q_app.device):
        err = launch(
            q_app.data_ptr(), idx.data_ptr(), q_out.data_ptr(), d, k, num_jobs,
            _threads(k), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "jsaq_route")
    jsaq_route_cuda.launches += 1
    return idx, q_out


jsaq_route_cuda.launches = 0


def care_route_cuda(
    arrive: torch.Tensor,
    params: torch.Tensor,
    *,
    servers: int,
    cap: int,
    policy: str,
    comm: str,
):
    """The fused CARE slot loop on the card; see ``ref.care_route_ref``."""
    if arrive.device.type != "cuda":
        raise ValueError(f"care_route_cuda needs a CUDA tensor, got {arrive.device}")
    if policy not in ("jsq", "jsaq"):
        raise ValueError(f"care_route supports policies 'jsq'/'jsaq', got {policy!r}")
    if comm not in CARE_COMMS:
        raise ValueError(f"unknown communication kind: {comm}")
    if servers < 1:
        raise ValueError(f"servers must be >= 1, got {servers}")
    dev = arrive.device
    d, t = arrive.shape
    _check(arrive, "arrive", (d, t), dev)
    _check(params, "params", (d, 4), dev)
    launch = _lib(
        "care_route", "care_route_launch",
        (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    )
    routed = torch.empty((d, t), dtype=torch.int32, device=dev)
    q_true = torch.empty((d, servers), dtype=torch.int32, device=dev)
    per_srv = torch.empty((d, servers), dtype=torch.int32, device=dev)
    stats = torch.empty((d, 8), dtype=torch.int32, device=dev)
    scratch = torch.empty((d, 5, servers), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = launch(
            arrive.data_ptr(), params.data_ptr(), routed.data_ptr(),
            q_true.data_ptr(), per_srv.data_ptr(), stats.data_ptr(),
            scratch.data_ptr(), d, t, servers, cap, int(policy == "jsaq"),
            CARE_COMMS.index(comm), _threads(servers),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "care_route")
    care_route_cuda.launches += 1
    return routed, q_true, per_srv, stats


care_route_cuda.launches = 0


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
    if comm not in CARE_COMMS:
        raise ValueError(f"unknown communication kind: {comm}")
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    dev = tie_u.device
    d, a_n = tie_u.shape
    r = q_len.shape[-1]
    if not 1 <= r <= SERVE_MAX_REPLICAS:
        raise ValueError(
            f"serve_route_cuda takes 1..{SERVE_MAX_REPLICAS} replicas, got {r}"
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
