"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each ``*_ref`` computes what its CUDA kernel computes, tie-breaking
included (first index wins), with ordinary tensor operations.  The CPU
path of :mod:`repro_torch.kernels.ops` runs them, the tests hold them
against the JAX package, and ``chip_smoke.py`` holds the kernels against
them on the card.  Integer and bool outputs are compared for equality;
``moe_route``'s float32 combine weights within rtol 1e-5 / atol 1e-6 (the
JAX package's own tolerance for its router kernel); ``flash_attention``
within 2e-5 in float32 and 2e-2 in bfloat16 (``tests/test_flash_kernel.py``),
its log-sum-exp (:func:`flash_attention_lse_ref`) as
``tests/test_torch_cuda.py`` states.  The two backward versions, :func:`flash_attention_bwd_ref` and
:func:`moe_route_weights_vjp_ref`, are ``torch.autograd.grad`` of the forward
versions; their kernels' tolerances are stated in ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import torch

# Trigger kinds the fused kernel evaluates.
CARE_COMMS = ("rt", "dt", "et", "et_rt", "exact", "none")
# Gate activations of the MoE router.
GATE_FNS = ("softmax", "sigmoid")
# Score given to an expert already chosen for a token.
MOE_NEG = -1e30
# Score of a masked key in attention.
FLASH_NEG = -1e30


def jsaq_route_ref(q_app: torch.Tensor, num_jobs: int):
    """Sequential JSAQ: per row, ``num_jobs`` times take the argmin (lowest
    index on ties) and add one job to it.  ``(D, K)`` ->
    ``((D, num_jobs) idx, (D, K) q')``, mirroring ``repro/kernels/ref.py:13``.
    """
    q = q_app.to(torch.int32).clone()
    d = q.shape[0]
    rows = torch.arange(d, device=q.device)
    idx = torch.empty((d, num_jobs), dtype=torch.int32, device=q.device)
    for n in range(num_jobs):
        j = torch.argmin(q, dim=1)
        idx[:, n] = j.to(torch.int32)
        q[rows, j] += 1
    return idx, q


def care_route_ref(
    arrive: torch.Tensor,
    params: torch.Tensor,
    *,
    servers: int,
    cap: int,
    policy: str,
    comm: str,
    count_live: bool = False,
):
    """The fused CARE slot loop, one run per row, as a per-slot loop.

    Follows ``_care_kernel`` (``repro/kernels/jsaq_route.py:253-331``)
    operation for operation: route by lowest-index argmin of the true
    (``jsq``) or approximated (``jsaq``) queues, cap-checked admit,
    deterministic service of ``msr_slots`` per job, the MSR emulation
    drain, then the trigger and snap.  Slots at ``t >= horizon`` are
    frozen no-ops.

    Args:
      arrive: ``(D, T)`` int32 arrival indicators.
      params: ``(D, 4)`` int32 ``[x, rt_period, msr_slots, horizon]``.
      count_live: also return the work these inputs need (see below).

    Returns:
      ``(routed, q_true, per_srv, stats)``: ``(D, T)`` routed server per
      slot (-1 without an admitted arrival), final ``(D, K)`` queues,
      ``(D, K)`` admitted arrivals per server and ``(D, 8)`` int32 stats
      ``[msgs, deps, arrs, dropped, max_aq, max_q, gap_sup, 0]``.  With
      ``count_live``, a fifth ``(D,)`` int64 tensor: the active
      server-slots that are not at rest (``q > 0`` or ``qa > 0`` once the
      slot's arrival is admitted) or that trigger while at rest; a server
      at rest that does not trigger changes only its slot counter.
    """
    if policy not in ("jsq", "jsaq"):
        raise ValueError(f"care_route supports policies 'jsq'/'jsaq', got {policy!r}")
    if comm not in CARE_COMMS:
        raise ValueError(f"unknown communication kind: {comm}")
    dev = arrive.device
    d, t = arrive.shape
    k = servers
    params = params.to(torch.int32)
    x, rt_period, msr, horizon = (params[:, i : i + 1] for i in range(4))
    zeros = torch.zeros((d, k), dtype=torch.int32, device=dev)
    zeros1 = torch.zeros((d, 1), dtype=torch.int32, device=dev)
    q, qa, hr, ds, ss, ps = (zeros.clone() for _ in range(6))
    eh = zeros + msr
    msgs, deps, arrs, drops, max_aq, max_q, gap = (zeros1.clone() for _ in range(7))
    live = torch.zeros((d,), dtype=torch.int64, device=dev)
    routed = torch.full((d, t), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(k, device=dev)
    # Every run is frozen from its horizon on, so the loop may stop at the
    # largest one.
    t_end = min(t, max(int(horizon.max()) if d else 0, 0))
    for s in range(t_end):
        act = s < horizon
        arr = (arrive[:, s : s + 1] > 0) & act

        # 1. arrival and routing (lowest-index ties)
        score = qa if policy == "jsaq" else q
        j = torch.argmin(score, dim=1, keepdim=True)
        onehot = lane == j
        q_sel = torch.where(onehot, q, 0).sum(1, keepdim=True, dtype=torch.int32)
        admit = arr & (q_sel < cap)
        drops = drops + (arr & ~admit).to(torch.int32)
        sel = onehot & admit
        hr = torch.where(sel & (q == 0), msr, hr)
        q = q + sel.to(torch.int32)
        was_empty = qa == 0
        qa = qa + sel.to(torch.int32)
        eh = torch.where(sel & was_empty, msr, eh)
        arrs = arrs + admit.to(torch.int32)
        ps = ps + sel.to(torch.int32)
        routed[:, s] = torch.where(admit, j.to(torch.int32), -1)[:, 0]
        if count_live:
            moving = (q > 0) | (qa > 0)

        # 2. service (deterministic msr_slots-sized jobs)
        busy = (q > 0) & act
        hr = torch.where(busy, hr - 1, hr)
        dep = busy & (hr <= 0)
        q = torch.where(dep, q - 1, q)
        hr = torch.where(dep & (q > 0), msr, hr)
        dep_i = dep.to(torch.int32)
        deps = deps + dep_i.sum(1, keepdim=True, dtype=torch.int32)

        # 3. MSR emulation drain
        ticking = (qa > 0) & act
        eh = torch.where(ticking, eh - 1, eh)
        dep_e = ticking & (eh <= 0)
        qa = torch.where(dep_e, qa - 1, qa)
        eh = torch.where(dep_e, msr, eh)

        # 4/5. trigger and snap
        err = torch.abs(q - qa)
        dsa = ds + dep_i
        ssa = ss + 1
        if comm == "rt":
            trig = ssa >= rt_period
        elif comm == "dt":
            trig = dsa >= x
        elif comm == "et":
            trig = err >= x
        elif comm == "et_rt":
            trig = (err >= x) | (ssa >= rt_period)
        elif comm == "exact":
            trig = dep
        else:
            trig = torch.zeros_like(dep)
        trig = trig & act
        if count_live:
            live += ((moving | trig) & act).sum(1)
        sent = (dep_i if comm == "exact" else trig).sum(1, keepdim=True, dtype=torch.int32)
        msgs = msgs + torch.where(act, sent, 0)
        ds = torch.where(act, torch.where(trig, 0, dsa), ds)
        ss = torch.where(act, torch.where(trig, 0, ssa), ss)
        qa = torch.where(trig, q, qa)
        eh = torch.where(trig, msr, eh)

        # 6. metrics
        aq = torch.abs(q - qa).amax(1, keepdim=True)
        qmax = q.amax(1, keepdim=True)
        qmin = q.amin(1, keepdim=True)
        max_aq = torch.maximum(max_aq, aq)
        max_q = torch.maximum(max_q, qmax)
        gap = torch.maximum(gap, qmax - qmin)
    stats = torch.cat([msgs, deps, arrs, drops, max_aq, max_q, gap, zeros1], dim=1)
    if count_live:
        return routed, q, ps, stats, live
    return routed, q, ps, stats


def serve_route_ref(
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
    """One serving slot's arrival lanes, routed in order, one run per row.

    Follows ``_serve_kernel`` (``repro/kernels/jsaq_route.py:425-493``)
    lane for lane: lane ``a`` is live when ``act & (a < n_arr)``; it goes
    to the lowest-index argmin of ``approx`` (or of ``float(q_len +
    busy_cnt)`` under ``comm="exact"``), is admitted when that ring holds
    fewer than ``cap`` requests, takes ring slot ``(q_head[j] + q_len[j]) %
    cap``, and an admit adds one to ``q_len[j]`` and ``1.0`` to
    ``approx[j]``.  ``tie_u`` only pins the lane count.

    Args:
      tie_u: ``(D, A)`` float32.
      q_len / q_head / busy_cnt: ``(D, R)`` int32.
      approx: ``(D, R)`` float32.
      n_arr: ``(D,)`` int32 live lanes per run.
      act: ``(D,)`` bool horizon mask.

    Returns:
      ``(jv, tail, admit, q_len', approx', drops)``: ``(D, A)`` int32
      replica and ring tail of every lane (dead lanes included), ``(D, A)``
      bool admits, the ``(D, R)`` post-slot ``q_len`` and ``approx``, and
      the ``(D,)`` int32 count of live lanes refused on a full ring.
    """
    if comm not in CARE_COMMS:
        raise ValueError(f"unknown communication kind: {comm}")
    dev = tie_u.device
    d, a_n = tie_u.shape
    q = q_len.to(torch.int32).clone()
    ap = approx.to(torch.float32).clone()
    busy = busy_cnt.to(torch.int32)
    rows = torch.arange(d, device=dev)
    jv = torch.empty((d, a_n), dtype=torch.int32, device=dev)
    tail = torch.empty((d, a_n), dtype=torch.int32, device=dev)
    admit = torch.empty((d, a_n), dtype=torch.bool, device=dev)
    drops = torch.zeros((d,), dtype=torch.int32, device=dev)
    for a in range(a_n):
        live = act & (a < n_arr)
        score = (q + busy).to(torch.float32) if comm == "exact" else ap
        j = torch.argmin(score, dim=1)
        len_j = q[rows, j]
        ok = live & (len_j < cap)
        jv[:, a] = j.to(torch.int32)
        tail[:, a] = torch.remainder(q_head[rows, j] + len_j, cap)
        admit[:, a] = ok
        q[rows, j] = len_j + ok.to(torch.int32)
        ap[rows, j] = ap[rows, j] + ok.to(torch.float32)
        drops = drops + (live & ~ok).to(torch.int32)
    return jv, tail, admit, q, ap, drops


def _flash_scores(q, k, *, scale, causal, window, softcap):
    """The filled float32 scores ``(B, S, KVH, G, T)`` of
    :func:`flash_attention_ref` and the ``(1, S, 1, 1, T)`` mask of the pairs
    that attend (None without ``causal``)."""
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, dh)
    sc = torch.einsum("bskgd,btkd->bskgt", qg.float(), k.float()) * scale
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    ok = None
    if causal:
        qpos = torch.arange(s, dtype=torch.int32, device=q.device)[None, :, None, None, None]
        kpos = torch.arange(t, dtype=torch.int32, device=q.device)[None, None, None, None, :]
        ok = kpos <= qpos
        if window is not None:
            ok = ok & (qpos - kpos < window)
        sc = torch.where(ok, sc, FLASH_NEG)
    return sc, ok


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: int | None = None,
    softcap: float = 0.0,
):
    """Dense softmax attention with float32 scores, the flash kernel's contract.

    Mirrors ``repro/kernels/ref.py:25-56``: ``s = (q . k) * scale`` in
    float32 (bfloat16 inputs are widened first, which keeps every product
    exact), then ``softcap * tanh(s / softcap)`` if ``softcap``, then with
    ``causal`` the fill ``-1e30`` where ``kpos > qpos`` or ``qpos - kpos >=
    window``; the softmax in float32, the probabilities cast to ``v``'s
    dtype before the product with ``v``, and the output in ``q``'s dtype.
    Query head ``h`` attends KV head ``h // (H // KVH)``.

    Args:
      q: ``(B, S, H, dh)``.
      k: ``(B, T, KVH, dh)``; v: ``(B, T, KVH, dv)``.

    Returns:
      ``(B, S, H, dv)``.
    """
    b, s, h, _ = q.shape
    sc, _ = _flash_scores(q, k, scale=scale, causal=causal, window=window, softcap=softcap)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bskgt,btkd->bskgd", p.to(v.dtype), v)
    return out.to(q.dtype).reshape(b, s, h, v.shape[3])


def flash_attention_lse_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: int | None = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Each row's log-sum-exp of the scores :func:`flash_attention_ref`
    builds (filled, softcapped, scaled, float32), in natural-log units, as
    the forward kernels write it for the backward: ``(B, H, S)`` float32,
    ``+inf`` for a row with no key at all (causal and ``row >= T - 1 +
    window``), for which the backward reads p = 0.  Then ``exp(s - lse)``
    is the softmax of every row that has a key."""
    b, s, h, _ = q.shape
    sc, ok = _flash_scores(q, k, scale=scale, causal=causal, window=window, softcap=softcap)
    lse = torch.logsumexp(sc, dim=-1)
    if ok is not None:
        lse = torch.where(ok.any(dim=-1), lse, torch.inf)
    return lse.reshape(b, s, h).transpose(1, 2).contiguous()


def moe_route_ref(
    logits: torch.Tensor, bias: torch.Tensor, top_k: int, gate_fn: str = "softmax"
):
    """CARE-biased top-k routing: iterative masked argmax, unbiased weights.

    Mirrors ``repro/kernels/ref.py:60-86``: the gates are the softmax (or
    sigmoid) of the float32 logits; the selection score is ``logits -
    bias``; each of ``top_k`` sweeps takes the argmax of the score (the
    first index wins ties: ``torch.argmax`` returns the first maximum,
    where ``torch.topk`` gives no tie order) and sets it to ``-1e30``; the
    weights are the chosen experts' gates over ``(their sum + 1e-20)``.

    Args:
      logits: ``(T, E)`` float32 or bfloat16.
      bias: ``(E,)`` selection bias.

    Returns:
      ``(idx, weights, counts)``: ``(T, k)`` int32 experts in selection
      order, ``(T, k)`` float32 weights, ``(E,)`` int32 (token, slot)
      pairs per expert.
    """
    if gate_fn not in GATE_FNS:
        raise ValueError(f"unknown gate_fn {gate_fn!r}; expected one of {GATE_FNS}")
    logits = logits.to(torch.float32)
    e = logits.shape[1]
    if gate_fn == "softmax":
        gates = torch.softmax(logits, dim=1)
    else:
        gates = torch.sigmoid(logits)
    score = logits - bias[None, :].to(torch.float32)
    counts = torch.zeros((e,), dtype=torch.int32, device=logits.device)
    idx_list, w_list = [], []
    for _ in range(top_k):
        j = torch.argmax(score, dim=1, keepdim=True)
        idx_list.append(j)
        w_list.append(torch.gather(gates, 1, j))
        counts += torch.bincount(j[:, 0], minlength=e).to(torch.int32)
        score.scatter_(1, j, MOE_NEG)
    idx = torch.cat(idx_list, dim=1).to(torch.int32)
    weights = torch.cat(w_list, dim=1)
    weights = weights / (weights.sum(dim=1, keepdim=True) + 1e-20)
    return idx, weights, counts


def moe_positions_ref(idx: torch.Tensor, e: int) -> torch.Tensor:
    """Each (token, slot)'s position in its expert's capacity buffer.

    Mirrors ``repro/models/ffn.py:110-114``: for flat entry ``j = t k + i``
    of ``idx`` (``(T, k)``), the number of entries ``j' < j`` routed to the
    same expert, as the exclusive ``cumsum`` of the ``(T k, E)`` one-hot
    summed against it.  A token that names an expert twice counts its
    slots in order.  Returns ``(T k,)`` int32.
    """
    flat = idx.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat.long(), e).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    return torch.sum(pos * onehot, dim=1, dtype=torch.int32)


def flash_attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: int | None = None,
    softcap: float = 0.0,
):
    """The gradient of :func:`flash_attention_ref` with respect to ``q``,
    ``k`` and ``v`` for the upstream gradient ``dout`` ``(B, S, H, dv)``:
    ``torch.autograd.grad`` of the forward version, so the fill ``-1e30``
    blocks every masked score's gradient and a row with no key at all
    spreads its ``dout`` over every value row as its uniform softmax does.
    Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = flash_attention_ref(*leaves, scale=scale, causal=causal, window=window,
                                  softcap=softcap)
        return torch.autograd.grad(out, leaves, dout)


def moe_route_weights_vjp_ref(
    logits: torch.Tensor, idx: torch.Tensor, grad_w: torch.Tensor, gate_fn: str = "softmax"
) -> torch.Tensor:
    """The gradient of :func:`moe_route_ref`'s ``(T, k)`` combine weights
    with respect to the ``(T, E)`` float32 logits, for the upstream gradient
    ``grad_w`` and the route ``idx`` the forward chose: the weights are the
    chosen gates over ``(their sum + 1e-20)``, the gates the softmax (every
    expert takes a share) or the sigmoid (only the chosen ones) of the
    logits.  The selection bias reaches only the argmax and takes none.
    Returns ``(T, E)`` float32."""
    if gate_fn not in GATE_FNS:
        raise ValueError(f"unknown gate_fn {gate_fn!r}; expected one of {GATE_FNS}")
    with torch.enable_grad():
        x = logits.detach().to(torch.float32).requires_grad_(True)
        gates = torch.softmax(x, dim=1) if gate_fn == "softmax" else torch.sigmoid(x)
        w = torch.gather(gates, 1, idx.long())
        w = w / (w.sum(dim=1, keepdim=True) + 1e-20)
        return torch.autograd.grad(w, x, grad_w.to(torch.float32))[0]
