"""ctypes binding of the hand-written Hopper MoE router.

:func:`moe_route_cuda` launches ``csrc/moe_route.cu``, which replaces the
Pallas kernel ``moe_route_pallas`` (``repro/kernels/moe_route.py:89``).
Like the routing bindings in :mod:`repro_torch.kernels.jsaq_route`, it
checks device, dtype, shape and contiguity, allocates the outputs, launches
on PyTorch's current stream, raises if the launch reports an error, and
adds one to its ``launches`` count.  The library is built at first use.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.jsaq_route import _I, _P, _check, _lib, _raise_on
from repro_torch.kernels.ref import GATE_FNS

# Largest expert count the kernel takes: a warp holds one token's scores in
# registers, 8 a lane (kMaxExperts in csrc/moe_route.cu).
MAX_EXPERTS = 256


def moe_route_cuda(
    logits: torch.Tensor, bias: torch.Tensor, top_k: int, *, gate_fn: str = "softmax"
):
    """CARE-biased top-k routing on the card; see ``ref.moe_route_ref``.

    ``logits`` is ``(T, E)`` float32 or bfloat16 with ``E <= 256``,
    ``bias`` ``(E,)`` float32, ``1 <= top_k <= E``.  Returns ``(idx,
    weights, counts)``: ``(T, k)`` int32, ``(T, k)`` float32, ``(E,)``
    int32.
    """
    if logits.device.type != "cuda":
        raise ValueError(f"moe_route_cuda needs a CUDA tensor, got {logits.device}")
    if gate_fn not in GATE_FNS:
        raise ValueError(f"unknown gate_fn {gate_fn!r}; expected one of {GATE_FNS}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"logits must be float32 or bfloat16, got {logits.dtype}")
    if logits.dim() != 2:
        raise ValueError(f"logits must be (T, E), got shape {tuple(logits.shape)}")
    dev = logits.device
    t, e = logits.shape
    if not 1 <= e <= MAX_EXPERTS:
        raise ValueError(f"moe_route_cuda takes 1..{MAX_EXPERTS} experts, got {e}")
    if not 1 <= top_k <= e:
        raise ValueError(f"top_k must be in [1, {e}], got {top_k}")
    _check(logits, "logits", (t, e), dev, logits.dtype)
    _check(bias, "bias", (e,), dev, torch.float32)
    launch = _lib(
        "moe_route", "moe_route_launch",
        (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    )
    idx = torch.empty((t, top_k), dtype=torch.int32, device=dev)
    weights = torch.empty((t, top_k), dtype=torch.float32, device=dev)
    counts = torch.zeros((e,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = launch(
            logits.data_ptr(), int(logits.dtype == torch.bfloat16), bias.data_ptr(),
            idx.data_ptr(), weights.data_ptr(), counts.data_ptr(), t, e, top_k,
            int(gate_fn == "softmax"), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "moe_route")
    moe_route_cuda.launches += 1
    return idx, weights, counts


moe_route_cuda.launches = 0
