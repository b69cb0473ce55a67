"""Public wrappers of the port's kernels.

A wrapper looks at where its input lies.  A CPU tensor goes to the plain
PyTorch version in :mod:`repro_torch.kernels.ref`; a CUDA tensor goes to the
hand-written kernel (bindings in :mod:`repro_torch.kernels.jsaq_route`,
:mod:`repro_torch.kernels.moe_route` and :mod:`repro_torch.kernels.flash_attn`),
which either launches or raises --
nothing on the CUDA path falls back to the plain version.  The kernels mask
by bound, so no lane, domain or token padding is needed.  Only a kernel
launch counts in :func:`launch_counts`.  :func:`moe_route` and
:func:`flash_attention` call their kernels as ``torch.library`` operators
(``repro_torch::moe_route``, ``repro_torch::flash_attention``; see
``kernels/moe_route.py`` and ``kernels/flash_attn.py``): on a CUDA tensor
the operator launches the kernel, and its gradient is a kernel too; on a
fake tensor (``FakeTensorMode``, whatever device it claims) it gives the
outputs' shapes and launches nothing, which is how ``launch/dryrun.py``
traces the card's path without a card; on a CPU tensor autograd
differentiates the plain version itself.  The plain version of
:func:`serve_slots`, the serving engine's fused slot loop, is the engine's
own per-slot loop, which the caller passes in.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import flash_attn as _flash
from repro_torch.kernels import jsaq_route as _cuda
from repro_torch.kernels import moe_route as _moe
from repro_torch.kernels import ref as _ref


def _route(t: torch.Tensor, name: str) -> bool:
    """True for the kernel, False for the plain version; raises otherwise."""
    if is_fake(t):
        raise ValueError(f"{name}: a fake tensor has no kernel here (no fake implementation)")
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device {t.device}")


def jsaq_route(q_app: torch.Tensor, num_jobs: int):
    """Batched sequential JSAQ: ``(D, K)`` int32 -> ``((D, N) idx, (D, K) q')``."""
    if _route(q_app, "jsaq_route"):
        return _cuda.jsaq_route_cuda(q_app, num_jobs)
    return _ref.jsaq_route_ref(q_app, num_jobs)


def care_route(
    arrive: torch.Tensor,
    params: torch.Tensor,
    *,
    servers: int,
    cap: int,
    policy: str,
    comm: str,
):
    """Fused CARE slot loop: ``(D, T)`` arrivals + ``(D, 4)`` params ->
    ``(routed, q_true, per_srv, stats)``; see ``ref.care_route_ref``."""
    kw = dict(servers=servers, cap=cap, policy=policy, comm=comm)
    if _route(arrive, "care_route"):
        return _cuda.care_route_cuda(arrive, params, **kw)
    return _ref.care_route_ref(arrive, params, **kw)


def serve_route(
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
    """One serving slot's arrival lanes for ``D`` runs:
    ``(jv, tail, admit, q_len', approx', drops)``; see ``ref.serve_route_ref``."""
    args = (tie_u, q_len, q_head, busy_cnt, approx, n_arr, act)
    if _route(tie_u, "serve_route"):
        return _cuda.serve_route_cuda(*args, cap=cap, comm=comm)
    return _ref.serve_route_ref(*args, cap=cap, comm=comm)


def serve_slots(
    n_arr: torch.Tensor,
    work: torch.Tensor,
    rid: torch.Tensor,
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
    plain: Callable[[], dict],
    carry: dict | None = None,
    t0: int = 0,
    warmup: torch.Tensor | None = None,
) -> dict:
    """Slots ``[t0, t0 + t_end)`` of the serving engine's fused slot loop
    for D runs; see ``jsaq_route.serve_slots_cuda``.  Without ``carry`` the
    fixed horizon from an empty engine: the dict of
    ``serve.engine._serve_core``.  With ``carry`` (stream mode; the engine's
    ``_slots_view``) the loop resumes from it and the carry dict comes
    back, on the card the same tensors updated in place.  ``plain``
    computes the same dict on the same inputs (the engine's per-slot loop);
    it runs on the CPU."""
    if _route(work, "serve_slots"):
        return _cuda.serve_slots_cuda(
            n_arr, work, rid, x, rt_period, msr_drain, rates, horizon, cap=cap,
            comm=comm, decode_slots=decode_slots, use_rates=use_rates,
            trace_occupancy=trace_occupancy, n_cap=n_cap, t_end=t_end,
            carry=carry, t0=t0, warmup=warmup,
        )
    return plain()


def moe_route(
    logits: torch.Tensor, bias: torch.Tensor, top_k: int, *, gate_fn: str = "softmax"
):
    """CARE-biased top-k MoE routing: ``(T, E)`` logits + ``(E,)`` bias ->
    ``((T, k) idx, (T, k) weights, (E,) counts, (T k,) pos)``; see
    ``ref.moe_route_ref``.  ``pos`` is each (token, slot)'s position in its
    expert's capacity buffer (``ref.moe_positions_ref``); the kernel
    computes all four in one launch.  Any ``T >= 1`` (no token padding);
    ``1 <= top_k <= E``."""
    if not 1 <= top_k <= logits.shape[-1]:
        raise ValueError(f"top_k must be in [1, {logits.shape[-1]}], got {top_k}")
    if is_fake(logits) or _route(logits, "moe_route"):
        return _moe.moe_route_op(logits, bias, top_k, gate_fn)
    out = _ref.moe_route_ref(logits, bias, top_k, gate_fn)
    return (*out, _ref.moe_positions_ref(out[0], logits.shape[-1]))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: int | None = None,
    softcap: float = 0.0,
):
    """Flash SDPA: ``q (B, S, H, dh)``, ``k, v (B, T, KVH, dh / dv)`` ->
    ``(B, S, H, dv)``; see ``ref.flash_attention_ref``.  Any ``S, T >= 1``
    (no padding); GQA reads KV head ``h // (H // KVH)`` in place.
    ``window``: None or an int >= 1, applied only with ``causal``."""
    _flash.check_window(window)
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    if is_fake(q) or _route(q, "flash_attention"):
        # The backward reads the forward's log-sum-exp: ask for it only then.
        lse = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
        return _flash.flash_attention_op(q, k, v, scale, causal, window, softcap, lse)[0]
    return _ref.flash_attention_ref(q, k, v, **kw)


_KERNELS = {
    "jsaq_route": _cuda.jsaq_route_cuda,
    "care_route": _cuda.care_route_cuda,
    "serve_route": _cuda.serve_route_cuda,
    "serve_slots": _cuda.serve_slots_cuda,
    "moe_route": _moe.moe_route_cuda,
    "flash_attention": _flash.flash_attention_cuda,
    "moe_route_bwd": _moe.moe_route_bwd_cuda,
    "flash_attention_bwd": _flash.flash_attention_bwd_cuda,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel."""
    return {name: fn.launches for name, fn in _KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0
