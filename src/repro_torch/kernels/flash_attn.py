"""ctypes binding of the hand-written Hopper flash-attention kernel.

:func:`flash_attention_cuda` launches ``csrc/flash_attn.cu``, which replaces
the Pallas kernel ``flash_attention_pallas`` (``repro/kernels/flash_attn.py:84``).
Like the other bindings it checks device, dtype, shape and contiguity,
allocates the output, launches on PyTorch's current stream, raises if the
launch reports an error, and adds one to its ``launches`` count.  The
library is built at first use.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.jsaq_route import _I, _P, _check, _lib, _raise_on

_F = ctypes.c_float

# Largest head width the kernel takes: a thread accumulates 4 rows x 16
# value columns in registers and the block stages (64 + 32) x (dh + 4) and
# 32 x (dv + 4) floats, 141 KB at 256 (kMaxDim in csrc/flash_attn.cu).
MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)


def check_window(window) -> None:
    """A window is None (global) or an int in ``[1, 2**31 - 1]``."""
    if window is not None and not (isinstance(window, int) and 1 <= window < 2**31):
        raise ValueError(f"window must be None or an int in [1, 2**31 - 1], got {window!r}")


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: int | None = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Flash attention on the card; see ``ref.flash_attention_ref``.

    ``q`` is ``(B, S, H, dh)``, ``k`` ``(B, T, KVH, dh)``, ``v`` ``(B, T,
    KVH, dv)``, all float32 or all bfloat16 and contiguous, ``H`` a
    multiple of ``KVH``, ``dh`` and ``dv`` multiples of 4 up to 256, any
    ``S, T >= 1``.  ``window`` applies only with ``causal``.  Returns
    ``(B, S, H, dv)`` in ``q``'s dtype.
    """
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs a CUDA tensor, got {q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"q, k, v must be 4-D, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    check_window(window)
    if softcap < 0:
        raise ValueError(f"softcap must be >= 0, got {softcap}")
    dev = q.device
    b, s, h, dh = q.shape
    t, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    if min(b, s, t, h, kvh) < 1 or h % kvh:
        raise ValueError(f"no attention for B={b} S={s} T={t} H={h} KVH={kvh}")
    for name, width in (("dh", dh), ("dv", dv)):
        if not (4 <= width <= MAX_HEAD_DIM and width % 4 == 0):
            raise ValueError(f"{name} must be a multiple of 4 in [4, {MAX_HEAD_DIM}], got {width}")
    _check(q, "q", (b, s, h, dh), dev, q.dtype)
    _check(k, "k", (b, t, kvh, dh), dev, q.dtype)
    _check(v, "v", (b, t, kvh, dv), dev, q.dtype)
    launch = _lib(
        "flash_attn", "flash_attn_launch",
        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P),
    )
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, s, t, h, kvh, dh, dv, float(scale),
            float(softcap), int(causal), window if causal and window is not None else 0,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
