"""Blocked (flash-style) attention in plain PyTorch: a loop over KV blocks
with an online softmax.

Port of ``repro/models/flash.py``, which is pure JAX (no Pallas kernel):
the same choice between the blocked and the dense path, the same block
size and the same order of sums and casts, so the two agree to float32
rounding.  Semantics: scale -> optional softcap -> causal/window mask ->
softmax in float32 -> weighted sum.  Score products run in float32 (the
JAX package's ``preferred_element_type=float32``): bfloat16 inputs are
widened first, which keeps every product exact.
"""
from __future__ import annotations

import torch

KV_BLOCK = 1024
_NEG = -1e30


def _scores(qg: torch.Tensor, k: torch.Tensor, scale: float, softcap: float):
    sc = torch.einsum("bskgd,btkd->bskgt", qg.float(), k.float()) * scale
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    return sc


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, window):
    if not causal:
        return None
    ok = kpos <= qpos
    if window is not None:
        ok = ok & (qpos - kpos < window)
    return ok


def flash_sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    q_positions: torch.Tensor | None = None,
    causal: bool = True,
    window=None,
    softcap: float = 0.0,
    kv_block: int | None = None,
):
    """Blocked attention.  q: ``(B,S,H,Dh)``; k, v: ``(B,T,KVH,Dh[v])``.

    ``window``: only keys with ``q_pos - k_pos < window`` attend (None for
    global).  ``kv_block=None`` picks ``min(max(T // 2, 1024), 4096)``;
    the dense path runs when ``T`` is not a multiple of the block or fits
    in one.  Returns ``(B, S, H*Dv)``.
    """
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    dv = v.shape[3]
    g = h // kvh
    if kv_block is None:
        kv_block = min(max(t // 2, KV_BLOCK), 4096)
    if t % kv_block or t <= kv_block:
        return _dense_sdpa(
            q, k, v, scale=scale, q_positions=q_positions, causal=causal,
            window=window, softcap=softcap,
        )
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    qpos = q_positions[:, :, None, None, None]  # (B,S,1,1,1)
    qg = q.reshape(b, s, kvh, g, dh)

    acc = torch.zeros((b, s, kvh, g, dv), dtype=torch.float32, device=dev)
    m = torch.full((b, s, kvh, g), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, s, kvh, g), dtype=torch.float32, device=dev)
    for off in range(0, t, kv_block):
        k_b, v_b = k[:, off : off + kv_block], v[:, off : off + kv_block]
        sc = _scores(qg, k_b, scale, softcap)
        kpos = torch.arange(off, off + kv_block, dtype=torch.int32, device=dev)
        ok = _mask(qpos, kpos[None, None, None, None, :], causal, window)
        if ok is not None:
            sc = torch.where(ok, sc, _NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bskgt,btkd->bskgd", p.to(v_b.dtype), v_b)
        acc = acc * alpha[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype).reshape(b, s, h * dv)


def _dense_sdpa(q, k, v, *, scale, q_positions, causal, window, softcap):
    """Unblocked path (short T); same semantics."""
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    dv = v.shape[3]
    g = h // kvh
    dev = q.device
    sc = _scores(q.reshape(b, s, kvh, g, dh), k, scale, softcap)
    if q_positions is None:
        q_positions = torch.arange(s, dtype=torch.int32, device=dev)[None, :]
    qpos = q_positions[:, :, None, None, None]
    kpos = torch.arange(t, dtype=torch.int32, device=dev)[None, None, None, None, :]
    ok = _mask(qpos, kpos, causal, window)
    if ok is not None:
        sc = torch.where(ok, sc, _NEG)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bskgt,btkd->bskgd", p.to(v.dtype), v)
    return out.to(q.dtype).reshape(b, s, h * dv)
