"""ctypes binding of the hand-written Hopper flash-attention kernels.

:func:`flash_attention_cuda` launches ``csrc/flash_attn.cu``, which replaces
the Pallas kernel ``flash_attention_pallas`` (``repro/kernels/flash_attn.py:84``).
The source holds two kernels, chosen by the input type: bfloat16 runs on the
tensor cores (``wgmma``, tiles fed by TMA), float32 on the CUDA cores
(register tiles fed by a ``cp.async`` ring from a producer warpgroup), since the tensor cores' TF32
cannot meet float32's tolerance.  Both kernels' tile schedules are mirrored
by :func:`key_tiles`.  Either writes each row's log-sum-exp when asked
(``return_lse``), which :func:`flash_attention_bwd_cuda` (``csrc/
flash_attn_bwd.cu``) reads: in bfloat16 a D pass, a dq kernel and a dk/dv
kernel, all on ``wgmma`` fed by TMA, whose tile schedules
:func:`bwd_key_tiles` and :func:`bwd_query_tiles` mirror.  Like the other
bindings it checks device, dtype, shape and contiguity, allocates the output,
launches on PyTorch's current stream, raises if the launch reports an error,
and adds one to its ``launches`` count.  The library is built at first use.
The operators ``repro_torch::flash_attention`` and
``repro_torch::flash_attention_bwd`` (:data:`flash_attention_op`,
:data:`flash_attention_bwd_op`) wrap the two bindings for autograd and for
fake tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.jsaq_route import _I, _P, _check, _lib, _raise_on

_F = ctypes.c_float

# Largest head width of the float32 kernel: a consumer thread accumulates 8
# rows x 8 value columns in registers, and the block holds Q (64 x dh
# floats), two stages of 32-key K (rows padded to 16 mod 32 words) and V
# tiles, and two transposed p tiles a consumer group: 219,968 bytes at 256,
# of the 232,448 a block may take (kMaxDim in csrc/flash_attn.cu).
MAX_HEAD_DIM = 256
# Head widths of the bfloat16 kernel: TMA boxes of 64 columns, and at 256 its
# (64, dv) accumulator takes 128 registers a thread and Q plus two stages of
# K and V take 192 KB of shared memory.  Other widths are refused, not padded.
BF16_WIDTHS = (64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
# The bfloat16 kernel's tiles: a block of two consumer warpgroups owns 128
# query rows and walks 64-key tiles (kRows and kKeys in csrc/flash_attn.cu).
BLOCK_Q = 128
BLOCK_K = 64
# The float32 kernel's: 64 query rows a block, 32-key tiles (kBQ and kBK).
F32_BLOCK_Q = 64
F32_BLOCK_K = 32
_NO_WINDOW = 2**31 - 1  # INT_MAX, the kernel's "no window"


def check_window(window) -> None:
    """A window is None (global) or an int in ``[1, 2**31 - 1]``."""
    if window is not None and not (isinstance(window, int) and 1 <= window < 2**31):
        raise ValueError(f"window must be None or an int in [1, 2**31 - 1], got {window!r}")


def key_tiles(
    qb: int, s: int, t: int, causal: bool, window: int | None, *,
    block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
):
    """Key tiles that a flash kernel's query block ``qb`` visits: the
    bfloat16 kernel's by default, the float32 kernel's with ``block_q=
    F32_BLOCK_Q, block_k=F32_BLOCK_K``.

    Returns ``(first, end, masked)``: the block runs tiles ``first .. end -
    1`` (tile ``j`` holds keys ``block_k j .. block_k (j + 1) - 1``), and
    ``masked[j - first]`` says whether tile ``j`` holds a key that one of
    the block's rows ``block_q qb .. min(block_q (qb + 1), S) - 1`` must not
    attend, so that the kernel masks it.  A row with no key at all (causal
    and ``row >= T - 1 + window``) makes the block run every tile, masked,
    as the dense softmax then averages all ``T`` keys.  The same arithmetic
    as ``key_tiles`` and ``tile_masked`` in ``csrc/flash_attn.cu`` (``<kBK>``
    for the float32 kernel).
    """
    w = window if causal and window is not None else _NO_WINDOW
    row0 = qb * block_q
    row_last = min(row0 + block_q, s) - 1
    first, end, all_masked = 0, -(-t // block_k), False
    if causal:
        if row_last >= t - 1 + w:
            all_masked = True
        else:
            first = max(0, row0 - w + 1) // block_k
            end = -(-min(t, row_last + 1) // block_k)
    masked = [
        all_masked or k0 + block_k > t
        or (causal and (k0 + block_k - 1 > row0 or row_last - k0 >= w))
        for k0 in range(first * block_k, end * block_k, block_k)
    ]
    return first, end, masked


def bwd_blocks(dh: int, dv: int) -> tuple[int, int]:
    """``(block_q, block_k)`` of the bfloat16 backward at these widths: query
    rows a dq block owns (``DqCfg::kRows``: 64 at dh = dv = 256, where two
    warpgroups' Q, dO and K / V stages would not fit in shared memory) and
    keys a dk/dv block owns (``DkvCfg::kKeys``: 64 past dh + dv = 256, where
    dK and dV are split over the two warpgroups)."""
    return (64 if dh + dv > 384 else 128), (64 if dh + dv > 256 else 128)


def bwd_key_tiles(qb: int, s: int, t: int, causal: bool, window: int | None, *,
                  block_q: int = BLOCK_Q):
    """64-key tiles that the backward's dq block ``qb`` (``block_q`` rows)
    visits: every key one of its rows attends, none when no row has a key
    (their p is 0 through the forward's +inf lse).  Returns ``(first, end,
    masked)`` as :func:`key_tiles`; the arithmetic of ``bwd_key_tiles`` and
    ``key_tile_masked`` in ``csrc/flash_attn_bwd.cu``."""
    w = window if causal and window is not None else _NO_WINDOW
    row0 = qb * block_q
    row_last = min(row0 + block_q, s) - 1
    first, end = 0, -(-t // 64)
    if causal:
        lo, hi = max(0, row0 - w + 1), min(t, row_last + 1)
        first, end = (lo // 64, -(-hi // 64)) if lo < hi else (0, 0)
    masked = [k0 + 64 > t or (causal and (k0 + 63 > row0 or row_last - k0 >= w))
              for k0 in range(first * 64, end * 64, 64)]
    return first, end, masked


def bwd_query_tiles(kb: int, s: int, t: int, causal: bool, window: int | None, *,
                    block_k: int = BLOCK_Q):
    """64-row query tiles that the backward's dk/dv block ``kb`` (keys
    ``block_k kb ..``) walks for each query head of its group: ``(main,
    none)``, two ``range``s, ``main`` holding every row that attends one of
    its keys, ``none`` every row with no key at all (causal and ``row >= T -
    1 + window``), whose uniform softmax adds ``dout / T`` to every key's
    dv.  The arithmetic of ``bwd_query_tiles`` in ``csrc/flash_attn_bwd.cu``."""
    w = window if causal and window is not None else _NO_WINDOW
    n = -(-s // 64)
    if not causal:
        return range(0, n), range(0)
    k0 = kb * block_k
    lo, hi = k0, min(s, min(k0 + block_k, t) - 1 + w)
    main = range(lo // 64, -(-hi // 64) if lo < hi else lo // 64)
    none = t - 1 + w
    return main, (range(none // 64, n) if none < s else range(0))


def bwd_pair(kw0: int, q0: int, causal: bool, window: int | None) -> tuple[bool, bool]:
    """``(masked, skipped)`` of a dk/dv warpgroup's 64 keys ``kw0 ..``
    against query rows ``q0 .. q0 + 63``: whether some pair must not attend,
    and whether none may (the warpgroup then runs no product); the
    arithmetic of ``pair_masked`` and ``pair_skipped``."""
    w = window if causal and window is not None else _NO_WINDOW
    masked = causal and (q0 < kw0 + 63 or q0 + 63 - kw0 >= w)
    skipped = causal and (q0 + 63 < kw0 or q0 - kw0 - 63 >= w)
    return masked, skipped


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """Raise ``ValueError`` for what the kernels do not take; else return
    ``(B, S, T, H, KVH, dh, dv)``.  float32 takes ``dh`` and ``dv`` that are
    multiples of 4 up to 256; bfloat16 takes them in ``BF16_WIDTHS``, with
    16-byte aligned pointers (TMA's rule)."""
    b, s, t, h, kvh, dh, dv = check_shapes(q, k, v)
    dev = q.device
    _check(q, "q", (b, s, h, dh), dev, q.dtype)
    _check(k, "k", (b, t, kvh, dh), dev, q.dtype)
    _check(v, "v", (b, t, kvh, dv), dev, q.dtype)
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary in bfloat16")
    return b, s, t, h, kvh, dh, dv


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: int | None = None,
    softcap: float = 0.0,
    return_lse: bool = False,
):
    """Flash attention on the card; see ``ref.flash_attention_ref``.

    ``q`` is ``(B, S, H, dh)``, ``k`` ``(B, T, KVH, dh)``, ``v`` ``(B, T,
    KVH, dv)``, all float32 or all bfloat16 and contiguous, ``H`` a
    multiple of ``KVH``, any ``S, T >= 1``; widths and alignment as
    :func:`check_inputs` says (a float32 input off a 16-byte boundary is
    first copied to one).  ``window`` applies only with ``causal``.  Returns ``(B, S, H,
    dv)`` in ``q``'s dtype; with ``return_lse``, also the float32 ``(B, H,
    S)`` log-sum-exp of each row's scores (``ref.flash_attention_lse_ref``;
    +inf for a row with no key), which the kernel writes in the same launch.
    """
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs a CUDA tensor, got {q.device}")
    b, s, t, h, kvh, dh, dv = check_inputs(q, k, v)
    check_window(window)
    if softcap < 0:
        raise ValueError(f"softcap must be >= 0, got {softcap}")
    if q.dtype == torch.float32:  # the kernel copies 16 bytes at a time
        q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    launch = _lib(
        "flash_attn", "flash_attn_launch",
        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P),
    )
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None,
            int(q.dtype == torch.bfloat16), b, s, t, h, kvh, dh, dv, float(scale),
            float(softcap), int(causal), window if causal and window is not None else 0,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "flash_attention")
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0


def smem_bytes(dtype: torch.dtype, dh: int, dv: int) -> int:
    """Dynamic shared memory a block of the kernel for ``dtype`` takes at
    these widths (-1 for widths it refuses); builds the library if needed."""
    query = _lib("flash_attn", "flash_attn_smem_bytes", (_I, _I, _I))
    return query(int(dtype == torch.bfloat16), dh, dv)


def bwd_smem_bytes(kernel: str, dh: int, dv: int) -> int:
    """Dynamic shared memory a block of the bfloat16 backward's ``"dq"`` or
    ``"dkv"`` kernel takes at these widths (-1 for widths it refuses)."""
    query = _lib("flash_attn_bwd", "flash_attn_bwd_smem_bytes", (_I, _I, _I))
    return query(int(kernel == "dkv"), dh, dv)


def flash_attention_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: int | None = None,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`flash_attention_cuda` on the card; see
    ``ref.flash_attention_bwd_ref``.  ``out`` is the forward's output and
    ``dout`` its upstream gradient, both ``(B, S, H, dv)``; ``lse`` the
    float32 ``(B, H, S)`` log-sum-exp the forward returned with
    ``return_lse``; the inputs and options are the forward's, which refuses
    what this refuses.  Returns ``(dq, dk, dv)`` in the inputs' dtype,
    summed in float32; two calls on the same inputs give the same bits (no
    atomics).  An input off a 16-byte boundary is first copied to one."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_cuda needs a CUDA tensor, got {q.device}")
    b, s, t, h, kvh, dh, dv = check_inputs(q, k, v)
    check_window(window)
    if softcap < 0:
        raise ValueError(f"softcap must be >= 0, got {softcap}")
    _check(out, "out", (b, s, h, dv), q.device, q.dtype)
    _check(dout, "dout", (b, s, h, dv), q.device, q.dtype)
    _check(lse, "lse", (b, h, s), q.device, torch.float32)
    q, k, v, out, dout = (x if x.data_ptr() % 16 == 0 else x.clone()
                          for x in (q, k, v, out, dout))
    launch = _lib(
        "flash_attn_bwd", "flash_attn_bwd_launch",
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I,
         _I, _P),
    )
    dq, dk, dv_ = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    d_rows = torch.empty((b, h, s), dtype=torch.float32, device=q.device)  # D = dout . out
    with torch.cuda.device(q.device):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv_.data_ptr(), d_rows.data_ptr(),
            int(q.dtype == torch.bfloat16), b, s, t, h, kvh, dh, dv,
            float(scale), float(softcap), int(causal),
            window if causal and window is not None else 0,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "flash_attention_bwd")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv_


flash_attention_bwd_cuda.launches = 0


# --------------------------------------------------------------------------
# the kernels as PyTorch operators
# --------------------------------------------------------------------------
#
# ``repro_torch::flash_attention`` and ``repro_torch::flash_attention_bwd``
# wrap the two bindings as ``torch.library`` operators.  Their CUDA
# implementation is the binding itself (it launches or raises); their fake
# implementation gives the outputs' shapes, dtypes and strides and builds
# nothing, so the step traces under ``FakeTensorMode`` (``launch/dryrun.py``);
# the forward's gradient is the backward kernel, and each has the FLOP
# formula ``torch.utils.flop_counter.FlopCounterMode`` reads.


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """The refusals of :func:`check_inputs` that depend on shapes and
    dtypes alone (a fake tensor has no pointer); the same tuple."""
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"q, k, v must be 4-D, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, h, dh = q.shape
    t, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    if min(b, s, t, h, kvh) < 1 or h % kvh:
        raise ValueError(f"no attention for B={b} S={s} T={t} H={h} KVH={kvh}")
    for name, width in (("dh", dh), ("dv", dv)):
        if q.dtype == torch.bfloat16 and width not in BF16_WIDTHS:
            raise ValueError(f"{name} must be one of {BF16_WIDTHS} in bfloat16, got {width}")
        if not (4 <= width <= MAX_HEAD_DIM and width % 4 == 0):
            raise ValueError(f"{name} must be a multiple of 4 in [4, {MAX_HEAD_DIM}], got {width}")
    return b, s, t, h, kvh, dh, dv


def _flash_op(q, k, v, scale: float, causal: bool, window, softcap: float, return_lse: bool):
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    if return_lse:
        return flash_attention_cuda(q, k, v, return_lse=True, **kw)
    out = flash_attention_cuda(q, k, v, **kw)
    return out, out.new_empty((0,), dtype=torch.float32)


flash_attention_op = torch.library.custom_op(
    "repro_torch::flash_attention", _flash_op, mutates_args=(), device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, float scale, bool causal, SymInt? window, "
           "float softcap, bool return_lse) -> (Tensor, Tensor)",
)


@flash_attention_op.register_fake
def _flash_fake(q, k, v, scale, causal, window, softcap, return_lse):
    b, s, _t, h, _kvh, _dh, dv = check_shapes(q, k, v)
    check_window(window)
    if softcap < 0:
        raise ValueError(f"softcap must be >= 0, got {softcap}")
    lse = q.new_empty((b, h, s) if return_lse else (0,), dtype=torch.float32)
    return q.new_empty((b, s, h, dv)), lse


def _flash_bwd_op(q, k, v, out, dout, lse, scale: float, causal: bool, window, softcap: float):
    return flash_attention_bwd_cuda(q, k, v, out, dout, lse, scale=scale, causal=causal,
                                    window=window, softcap=softcap)


flash_attention_bwd_op = torch.library.custom_op(
    "repro_torch::flash_attention_bwd", _flash_bwd_op, mutates_args=(), device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, Tensor out, Tensor dout, Tensor lse, float scale, "
           "bool causal, SymInt? window, float softcap) -> (Tensor, Tensor, Tensor)",
)


@flash_attention_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, out, dout, lse, scale, causal, window, softcap):
    check_shapes(q, k, v)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_setup(ctx, inputs, output):
    q, k, v, scale, causal, window, softcap, _return_lse = inputs
    out, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.kw = (scale, causal, window, softcap)


def _flash_grad(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    if lse.numel() == 0:
        raise RuntimeError("flash_attention: a gradient needs the forward's lse (return_lse)")
    dq, dk, dv = flash_attention_bwd_op(q, k, v, out, dout.contiguous(), lse, *ctx.kw)
    return dq, dk, dv, None, None, None, None, None


flash_attention_op.register_autograd(_flash_grad, setup_context=_flash_setup)


def flash_flops(q, k, v) -> int:
    """Dense attention's forward work, ``2 B H S T (dh + dv)``: the score
    and value products over every (query, key) pair, masked or not, as the
    JAX package's dense SDPA counts them.  The backward is twice this."""
    b, s, h, dh = q
    t, dv = k[1], v[3]
    return 2 * b * h * s * t * (dh + dv)


def _register_flops():
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _fwd(q, k, v, *args, out_shape=None, **kwargs) -> int:
        return flash_flops(q, k, v)

    @register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
    def _bwd(q, k, v, *args, out_shape=None, **kwargs) -> int:
        return 2 * flash_flops(q, k, v)


_register_flops()
