"""Recurrent sequence mixers: RWKV-6 ("Finch") and Mamba-1 (hymba's branch).

Port of ``repro/models/ssm.py``.  Both are linear-state models: the whole
context lives in a fixed-size state (RWKV: ``(B, H, n, n)`` a layer; Mamba:
``(B, Di, N)`` plus a ``(B, K-1, Di)`` conv tail), so a decode step costs
the same at any position.

RWKV-6 (arXiv:2404.05892): token-shift ddlerp (low-rank data-dependent
mixing), per-channel data-dependent decay ``w = exp(-exp(w0 + lora(x)))``,
and the WKV6 recurrence

    o_t = r_t @ (S_{t-1} + (u * k_t) v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T

with a per-head group norm (population variance, eps 64e-5) and an output
gate.  :func:`rwkv_time_mix` takes the chunked form when ``S % WKV_CHUNK ==
0 and S > WKV_CHUNK`` and the sequential scan otherwise, exactly as the
reference dispatches, so both take the same form on the same ``S``.

Mamba-1 (hymba's SSM heads): in-proj -> depthwise causal conv -> selective
SSM with ZOH discretisation -> gated out-proj, state size ``N =
cfg.ssm_state``.

None of these recurrences reached a Pallas kernel in the JAX package
(``lax.scan`` and ``jnp`` code), so they stay plain PyTorch here: loops
over tokens or chunks of small device operations, host-bound on the card.

Under a TP context (``partitioning.tp_layout``) each rank computes its
block: RWKV's time mix its WKV heads (its columns of ``wr``, ``wk``,
``wv``, ``wg``, its rows of ``u`` and ``wo``; the token-shift and decay
LoRAs whole on every rank, ``w0``, ``decay_w2`` and the group norm read
at its columns), the channel mix its hidden units (the receptance
gathered over TP, ``k @ wv`` summed), Mamba its inner channels (``xdbc``
and the output summed over TP).  The whole leaves a rank reads enter
through ``parallel.tp_copy``, so their gradients are summed over TP.  A
rank's token-shift states are its ``D`` columns, gathered where a step
reads them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, parallel, partitioning

RWKV_LORA = 32
RWKV_DECAY_LORA = 64
WKV_CHUNK = 32  # chunk length of the parallel form
GROUP_NORM_EPS = 64e-5
MAMBA_CHUNK = 256  # tokens a Mamba scan chunk holds states for


def _out_scale(cfg: ModelConfig) -> float:
    return 0.02 / max(cfg.num_layers, 1) ** 0.5


# ==========================================================================
# RWKV-6
# ==========================================================================


class RWKVTimeMix(nn.Module):
    """Time-mix parameters, named as the JAX leaves and drawn in
    ``init_rwkv_time_mix``'s order.  ``w0`` and ``u`` are float32 whatever
    ``param_dtype`` is, as in the reference."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        d = cfg.d_model
        pdt = common.dtype_of(cfg.param_dtype)
        h = d // cfg.rwkv_head_dim

        def init(shape, dtype=pdt, **kw):
            return common.dense_init(generator, shape, dtype, device, **kw)

        self.mu_x = init((d,), scale=0.5)
        self.mu = init((5, d), scale=0.5)
        self.maa_w1 = init((d, 5 * RWKV_LORA))
        self.maa_w2 = init((5, RWKV_LORA, d))
        self.w0 = init((d,), torch.float32, scale=1.0)
        self.decay_w1 = init((d, RWKV_DECAY_LORA))
        self.decay_w2 = init((RWKV_DECAY_LORA, d))
        self.u = init((h, cfg.rwkv_head_dim), torch.float32, scale=0.5)
        self.wr = init((d, d))
        self.wk = init((d, d))
        self.wv = init((d, d))
        self.wg = init((d, d))
        self.wo = init((d, d), scale=_out_scale(cfg))
        self.gn_scale = common.ones_init((d,), pdt, device)
        self.gn_bias = common.zeros_init((d,), pdt, device)


class RWKVChannelMix(nn.Module):
    """Channel-mix parameters (``init_rwkv_channel_mix``)."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        pdt = common.dtype_of(cfg.param_dtype)

        def init(shape, **kw):
            return common.dense_init(generator, shape, pdt, device, **kw)

        self.mu_k = init((d,), scale=0.5)
        self.mu_r = init((d,), scale=0.5)
        self.wk = init((d, f))
        self.wv = init((f, d), scale=_out_scale(cfg))
        self.wr = init((d, d))


def _shifted(x: torch.Tensor, shift_prev: torch.Tensor | None) -> torch.Tensor:
    """The token shift: ``x`` moved one step later, ``shift_prev`` (or
    zeros) in front."""
    if shift_prev is None:
        shift_prev = torch.zeros((x.shape[0], x.shape[2]), dtype=x.dtype, device=x.device)
    return torch.cat([shift_prev[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(p: RWKVTimeMix, x: torch.Tensor, x_prev: torch.Tensor, tctx=None) -> torch.Tensor:
    """Data-dependent token-shift mixing -> ``(5, B, S, D)``: the mixed
    streams w, k, v, r, g.  Each leaf enters through ``tp_copy`` over
    ``tctx``, so its gradient is summed over TP."""
    leaves = (p.mu_x, p.maa_w1, p.maa_w2, p.mu)
    mu_x, maa_w1, maa_w2, mu = (parallel.tp_copy(t, tctx) for t in leaves)
    dx = x_prev - x
    xxx = x + dx * mu_x
    lora = torch.tanh(xxx @ maa_w1)
    b, s, _ = lora.shape
    lora = lora.reshape(b, s, 5, RWKV_LORA)
    deltas = torch.einsum("bsir,ird->ibsd", lora, maa_w2)
    return x[None] + dx[None] * (mu[:, None, None, :] + deltas)


def _wkv6_scan(r, k, v, w, u, state):
    """WKV6 recurrence, one token a step.  r, k, v, w: ``(B, S, H, n)``;
    u: ``(H, n)``; state: ``(B, H, n, n)`` float32.  Returns ``(out (B, S,
    H, n) float32, final state)``."""
    r, k, v, w = (a.to(torch.float32) for a in (r, k, v, w))
    bonus = u[None, :, :, None]
    out = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, H, n, n)
        out.append(torch.einsum("bhn,bhnm->bhm", r[:, t], state + bonus * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(out, dim=1), state


def _wkv6_chunked(r, k, v, lw, u, state, chunk: int = WKV_CHUNK):
    """Chunked-parallel WKV6, the same math as :func:`_wkv6_scan`: an
    ``O(C^2 n)`` intra-chunk attention with relative decays plus one state
    contraction a chunk, one chunk a step.  Every relative decay is the
    exponential of a non-positive log-decay sum, so every ``exp`` is <= 1.

    Args:
      r, k, v: ``(B, S, H, n)``; lw: ``(B, S, H, n)`` log-decay (<= 0);
      u: ``(H, n)``; state: ``(B, H, n, n)`` float32.  ``S % chunk == 0``.
    Returns ``(out (B, S, H, n) float32, final state)``.
    """
    b, s, h, n = r.shape
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of the chunk {chunk}")
    nc = s // chunk
    r, k, v = (a.to(torch.float32) for a in (r, k, v))
    # The reference's clamp: w = exp(lw) <= 9e-14 is zero for every
    # practical purpose, and an unbounded |lw| makes the in-chunk cumsum
    # differences cancel catastrophically in float32.
    lw = torch.clamp(lw.to(torch.float32), min=-30.0)

    def to_chunks(a):  # (B, S, H, n) -> (NC, B, H, C, n)
        return a.reshape(b, nc, chunk, h, n).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = map(to_chunks, (r, k, v, lw))
    u_diag = u[None, :, None, :]  # (1, H, 1, n)
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    out = []
    for c in range(nc):
        rt, kt, vt, lwt = rc[c], kc[c], vc[c], lwc[c]  # (B, H, C, n)
        cum = torch.cumsum(lwt, dim=2)  # inclusive log-decay sums
        cum_ex = cum - lwt  # exclusive (sum over i < t)
        total = cum[:, :, -1:, :]  # (B, H, 1, n)
        # Inter-chunk: queries decayed from the chunk start hit the state.
        inter = torch.einsum("bhcn,bhnm->bhcm", rt * torch.exp(cum_ex), state)
        # Intra-chunk: scores with per-channel relative decay, strictly
        # causal (s < t); the t == s bonus uses u instead.
        dec = torch.exp(cum_ex[:, :, :, None, :] - cum[:, :, None, :, :])
        scores = (rt[:, :, :, None, :] * kt[:, :, None, :, :] * dec).sum(-1)
        scores = torch.where(strict, scores, 0.0)
        intra = torch.einsum("bhts,bhsm->bhtm", scores, vt)
        bonus = (rt * u_diag * kt).sum(-1)
        intra = intra + bonus[..., None] * vt
        # State update: the carried state decayed across the whole chunk,
        # plus each key decayed from its own position to the chunk end.
        k_dec = kt * torch.exp(total - cum)
        state = torch.exp(total)[:, :, 0, :, None] * state + torch.einsum(
            "bhcn,bhcm->bhnm", k_dec, vt)
        out.append(inter + intra)
    # (NC, B, H, C, n) -> (B, S, H, n)
    return torch.stack(out).permute(1, 0, 3, 2, 4).reshape(b, s, h, n), state


def _group_norm(out: torch.Tensor) -> torch.Tensor:
    """RWKV's per-head group norm over the last axis, without its affine
    part: population variance (``jnp.var``; ``torch.var`` would divide by
    ``n - 1``), eps ``GROUP_NORM_EPS``."""
    mu = out.mean(dim=-1, keepdim=True)
    var = out.var(dim=-1, keepdim=True, correction=0)
    return (out - mu) * torch.rsqrt(var + GROUP_NORM_EPS)


def _shift_cols(cfg: ModelConfig, ctx) -> slice:
    """The ``D`` columns of a rank's token-shift state (all without a
    split)."""
    lay = partitioning.tp_layout(cfg, ctx)
    if lay is None or not lay.shift:
        return slice(None)
    w = cfg.d_model // lay.size
    return slice(ctx.tp_index * w, (ctx.tp_index + 1) * w)


def _whole_shift(shift_prev, cfg: ModelConfig, ctx):
    """A rank's block of a token-shift state gathered whole over TP."""
    if shift_prev is None or _shift_cols(cfg, ctx) == slice(None):
        return shift_prev
    return parallel.tp_gather(shift_prev, ctx, dim=-1)


def rwkv_time_mix(p: RWKVTimeMix, x: torch.Tensor, cfg: ModelConfig, state=None,
                  shift_prev=None, ctx=None):
    """x: ``(B, S, D)``; state: ``(B, H, n, n)`` float32 or None (zeros);
    shift_prev: ``(B, D)`` or None.  Returns ``(out (B, S, D), state, x[:,
    -1])``.  Under a TP context that splits the WKV heads the state is the
    rank's heads ``(B, H/tp, n, n)``; the shift states are the rank's
    ``D`` columns wherever ``d_model`` divides over TP."""
    b, s, d = x.shape
    n = cfg.rwkv_head_dim
    lay = partitioning.tp_layout(cfg, ctx)
    tctx = ctx if lay is not None and lay.wkv else None
    x = parallel.tp_copy(x, tctx)

    def read(t):  # a whole leaf of which the rank uses a part
        return parallel.tp_copy(t, tctx)

    xw, xk, xv, xr, xg = _ddlerp(p, x, _shifted(x, _whole_shift(shift_prev, cfg, ctx)), tctx)
    cols = _shift_cols(cfg, tctx)  # the rank's heads' columns
    lora = torch.tanh(xw @ read(p.decay_w1)) @ read(p.decay_w2)[:, cols]
    decay = read(p.w0)[cols] + lora.to(torch.float32)
    h = p.u.shape[0]  # the heads this rank computes
    r = (xr @ p.wr).reshape(b, s, h, n)
    k = (xk @ p.wk).reshape(b, s, h, n)
    v = (xv @ p.wv).reshape(b, s, h, n)
    g = F.silu(xg @ p.wg)
    lw = -torch.exp(decay.to(torch.float32)).reshape(b, s, h, n)  # log w (<= 0)
    if state is None:
        state = torch.zeros((b, h, n, n), dtype=torch.float32, device=x.device)
    if s % WKV_CHUNK == 0 and s > WKV_CHUNK:
        out, state = _wkv6_chunked(r, k, v, lw, p.u, state)
    else:
        out, state = _wkv6_scan(r, k, v, torch.exp(lw), p.u, state)
    out = _group_norm(out).reshape(b, s, h * n)
    out = out * read(p.gn_scale)[cols] + read(p.gn_bias)[cols]
    out = parallel.tp_reduce((out.to(x.dtype) * g) @ p.wo, tctx)
    return out, state, x[:, -1, _shift_cols(cfg, ctx)]


def channel_mix_parts(p: RWKVChannelMix, x: torch.Tensor, shift_prev=None, tctx=None):
    """The channel mix on the columns and hidden units ``p`` holds:
    ``(sigmoid(xr @ wr), relu(xk @ wk)^2 @ wv)``, the receptance gate's
    columns and the (partial) product.  ``shift_prev`` is whole; ``mu_k``
    and ``mu_r`` enter through ``tp_copy`` over ``tctx``."""
    dx = _shifted(x, shift_prev) - x
    xk = x + dx * parallel.tp_copy(p.mu_k, tctx)
    xr = x + dx * parallel.tp_copy(p.mu_r, tctx)
    return torch.sigmoid(xr @ p.wr), torch.square(F.relu(xk @ p.wk)) @ p.wv


def rwkv_channel_mix(p: RWKVChannelMix, x: torch.Tensor, cfg: ModelConfig, shift_prev=None,
                     ctx=None):
    """The squared-ReLU FFN with token shift and a receptance gate.
    Returns ``(out (B, S, D), x[:, -1])``.  Under a TP context that splits
    it the rank computes its hidden units and its columns of the gate
    (:func:`channel_mix_parts`); the gate is gathered and ``k @ wv``
    summed over TP."""
    lay = partitioning.tp_layout(cfg, ctx)
    tctx = ctx if lay is not None and lay.ffn else None
    x = parallel.tp_copy(x, tctx)
    gate, kv = channel_mix_parts(p, x, _whole_shift(shift_prev, cfg, ctx), tctx)
    out = parallel.tp_gather(gate, tctx, dim=-1) * parallel.tp_reduce(kv, tctx)
    return out, x[:, -1, _shift_cols(cfg, ctx)]


# ==========================================================================
# Mamba-1 (hymba's SSM branch)
# ==========================================================================


class Mamba(nn.Module):
    """Mamba parameters, named as the JAX leaves (``init_mamba``).
    ``dt_bias`` (softplus^-1(0.01)), ``a_log`` and ``d_skip`` are float32
    whatever ``param_dtype`` is, as in the reference."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        d = cfg.d_model
        di = cfg.ssm_expand * d
        n = cfg.ssm_state
        dt_rank = max(d // 16, 1)
        pdt = common.dtype_of(cfg.param_dtype)

        def init(shape, **kw):
            return common.dense_init(generator, shape, pdt, device, **kw)

        self.w_in = init((d, 2 * di))
        self.conv = init((cfg.conv_kernel, di), scale=0.5)
        self.conv_b = common.zeros_init((di,), pdt, device)
        self.w_x = init((di, dt_rank + 2 * n))
        self.w_dt = init((dt_rank, di))
        self.dt_bias = common._param(torch.full((di,), -4.6, dtype=torch.float32, device=device))
        a = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
        self.a_log = common._param(a[None, :].repeat(di, 1))
        self.d_skip = common.ones_init((di,), torch.float32, device)
        self.w_out = init((di, d), scale=_out_scale(cfg))


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 conv_state: torch.Tensor | None = None):
    """Depthwise causal conv.  x: ``(B, S, Di)``; kernel: ``(K, Di)``;
    conv_state: ``(B, K-1, Di)``, the tail of the previous chunk (zeros if
    None).  The K terms are summed in order ``i = 0 .. K-1``, as the
    reference sums them.  Returns ``(y, new conv_state)``."""
    kk, s = kernel.shape[0], x.shape[1]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], kk - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xx = torch.cat([conv_state, x], dim=1)  # (B, S+K-1, Di)
    y = xx[:, 0:s, :] * kernel[0]
    for i in range(1, kk):
        y = y + xx[:, i : i + s, :] * kernel[i]
    return y + bias, xx[:, s:, :]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` with no threshold, as ``jax.nn.softplus``
    (``F.softplus`` returns ``x`` itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_in(p: Mamba, x: torch.Tensor, conv_state=None):
    """Mamba's input half on the inner channels ``p`` holds: ``(xi, z,
    conv_state, xi @ w_x)``, the last ``(B, S, dt_rank + 2N)`` and, on a
    block of the channels, that block's partial sum of ``xdbc``."""
    di = p.w_in.shape[-1] // 2
    xz = x @ p.w_in
    xi, z = xz[..., :di], xz[..., di:]
    xi, conv_state = _causal_conv(xi, p.conv, p.conv_b, conv_state)
    xi = F.silu(xi)
    return xi, z, conv_state, xi @ p.w_x


def mamba_out(p: Mamba, xi: torch.Tensor, z: torch.Tensor, xdbc: torch.Tensor,
              cfg: ModelConfig, state=None, chunk: int = MAMBA_CHUNK):
    """The selective scan and ``w_out``'s product on the inner channels
    ``p`` holds, from the whole ``xdbc``.  Returns ``(out (B, S, D), the
    channels' state)``: on a block of the channels, that block's partial
    sum of the output.

    The scan is a loop over tokens with float32 state, taken ``chunk``
    tokens at a time.  For each chunk the per-step factors ``exp(dt a)``
    and ``dt x b`` are computed first (the same elementwise operations as
    the reference's step, so the same values), which leaves two device
    operations a step; the chunk's states are kept and contracted with
    ``c`` once after its loop.  The chunk bounds the transient memory to
    a few ``(B, chunk, Di, N)`` float32 tensors whatever ``S`` is.  With
    grad enabled the chunk's states are a list that autograd can take
    (``out=`` and ``+=`` would refuse it), the same values.
    """
    b, s, di = xi.shape
    n = cfg.ssm_state
    dt_rank = p.w_dt.shape[0]
    dt = softplus((xdbc[..., :dt_rank] @ p.w_dt).to(torch.float32) + p.dt_bias)  # (B, S, Di)
    bmat = xdbc[..., dt_rank : dt_rank + n].to(torch.float32)  # (B, S, N)
    cmat = xdbc[..., dt_rank + n :].to(torch.float32)  # (B, S, N)
    a = -torch.exp(p.a_log)  # (Di, N)
    if state is None:
        state = torch.zeros((b, di, n), dtype=torch.float32, device=xi.device)
    xif = xi.to(torch.float32)
    ys = []
    for c0 in range(0, s, chunk):
        dt_c, x_c = dt[:, c0 : c0 + chunk], xif[:, c0 : c0 + chunk]
        da = torch.exp(dt_c[..., None] * a)  # (B, C, Di, N)
        dbx = (dt_c * x_c)[..., None] * bmat[:, c0 : c0 + chunk, None, :]  # (B, C, Di, N)
        if torch.is_grad_enabled():
            # Training: autograd keeps every state anyway; the same two
            # operations a step, without the writes into hs.
            steps = []
            for t in range(da.shape[1]):
                state = da[:, t] * state + dbx[:, t]
                steps.append(state)
            hs = torch.stack(steps, dim=1)
        else:
            hs = torch.empty_like(da)
            for t in range(da.shape[1]):
                state = torch.mul(da[:, t], state, out=hs[:, t])
                state += dbx[:, t]
        del da, dbx
        ys.append((hs * cmat[:, c0 : c0 + chunk, None, :]).sum(-1))
        state = state.clone()  # free the chunk's states
        del hs
    y = torch.cat(ys, dim=1) + xif * p.d_skip
    y = y.to(xi.dtype) * F.silu(z)
    return y @ p.w_out, state


def mamba(p: Mamba, x: torch.Tensor, cfg: ModelConfig, state=None, conv_state=None,
          chunk: int = MAMBA_CHUNK, ctx=None):
    """Selective SSM (:func:`mamba_in`, then :func:`mamba_out`).  x: ``(B,
    S, D)``; state: ``(B, Di, N)`` float32 or None (zeros); conv_state:
    ``(B, K-1, Di)`` or None.  Returns ``(out (B, S, D), state,
    conv_state)``.  Under a TP context that splits Mamba's inner channels
    ``p`` holds the rank's block of them, the states are its ``Di / tp``
    channels, and ``xdbc`` and the output are summed over TP."""
    lay = partitioning.tp_layout(cfg, ctx)
    tctx = ctx if lay is not None and lay.ssm else None
    xi, z, conv_state, xdbc = mamba_in(p, parallel.tp_copy(x, tctx), conv_state)
    # Every rank reads all of xdbc for its own channels: summed forward,
    # and the gradient of each rank's partial product summed too.
    xdbc = parallel.tp_copy(parallel.tp_reduce(xdbc, tctx), tctx)
    out, state = mamba_out(p, xi, z, xdbc, cfg, state, chunk)
    return parallel.tp_reduce(out, tctx), state, conv_state
