"""Resource-allocation component (paper Sections 2.1.4 and 9.1).

Port of ``repro/core/care/routing.py``: JSQ, JSAQ, SQ(d), round robin,
uniformly random routing and the pull policies (JIQ / hyper-scalable JSQ)
that spend a balancer-side token pool.  Policies are functions of tensors
with a trailing server axis and any leading batch axes.

The reference draws a policy's randomness from the slot's PRNG key; the
port takes each draw as a tensor for the slot instead:

* random tie-breaking of the shortest-queue family and the pull policies:
  a ``(..., K)`` float32 Gumbel tensor (the reference's
  ``gumbel(key, (K,))``); a caller that wants lowest-index ties passes
  ``deterministic=True`` and no Gumbels;
* SQ(d): the ``(..., d)`` int32 sample of distinct servers and its
  ``(..., d)`` Gumbels (the reference's ``permutation(key_perm, K)[:d]``
  and ``gumbel(key_tie, (d,))`` after ``split(key)``);
* random: an int32 draw in ``[0, n_eligible)`` (the reference's
  ``randint(key, (), 0, n_eligible)``) where the eligible set is known when
  the draws are made; under the control plane's suspect mask, which
  changes it every slot, the two 32-bit words that ``randint`` draws
  (:func:`randint_from_bits`).

``torch.argmin`` / ``torch.argmax`` return the first index on ties, as
``jnp.argmin`` / ``jnp.argmax`` do.
"""
from __future__ import annotations

from typing import Literal

import torch

PolicyKind = Literal["jsq", "jsaq", "sq2", "sqd", "rr", "random", "jiq", "hsq"]
POLICIES = ("jsq", "jsaq", "sq2", "sqd", "rr", "random", "jiq", "hsq")

# Pull (server-initiated) policies: route on the balancer-side token pool
# kept up by the comm kind of the same name.
PULL_POLICIES = ("jiq", "hsq")


def expected_drain_slots(mean_size, rates):
    """Expected per-job drain time ``E[S] / r_i`` in slots."""
    return mean_size / rates


def argmin_random_ties(q: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Index of the minimum of ``q``; ties broken by the largest Gumbel."""
    is_min = q == q.amin(-1, keepdim=True)
    score = torch.where(is_min, gumbel, -torch.inf)
    return torch.argmax(score, -1).to(torch.int32)


def mask_scores(score: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lift masked-out candidates to ``+inf``; an all-False mask means all."""
    mask = torch.where(mask.any(-1, keepdim=True), mask, True)
    return torch.where(mask, score.to(torch.float32), torch.inf)


def route_shortest(
    q: torch.Tensor,
    gumbel: torch.Tensor | None = None,
    deterministic: bool = False,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """JSQ / JSAQ: join the shortest (approximated) queue."""
    if mask is not None:
        q = mask_scores(q, mask)
    if deterministic:
        return torch.argmin(q, -1).to(torch.int32)
    if gumbel is None:
        raise ValueError("random ties need the slot's Gumbel tensor")
    return argmin_random_ties(q, gumbel)


def route_rr(
    rr_ptr: torch.Tensor, k: int, mask: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Round robin: returns ``(server, ptr')``; a mask skips to the
    cyclically next eligible server."""
    if mask is None:
        return rr_ptr % k, (rr_ptr + 1) % k
    mask = torch.where(mask.any(-1, keepdim=True), mask, True)
    lanes = torch.arange(k, dtype=torch.int32, device=rr_ptr.device)
    off = (lanes - rr_ptr[..., None]) % k
    off = torch.where(mask, off, k)
    server = torch.argmin(off, -1).to(torch.int32)
    return server, (server + 1) % k


def route_sqd(
    q_true: torch.Tensor,
    subset: torch.Tensor,
    gumbel: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """SQ(d): join the shortest of the ``(..., d)`` sampled servers.

    Ties within the subset go to the largest of its ``(..., d)`` Gumbels.
    ``mask`` excludes servers within the subset: a masked-out candidate
    loses every comparison unless the whole subset is masked out (the
    fallback of :func:`mask_scores`).
    """
    sub = q_true.gather(-1, subset.long())
    if mask is not None:
        sub = mask_scores(sub, mask.gather(-1, subset.long()))
    j = argmin_random_ties(sub, gumbel)
    return subset.gather(-1, j.long()[..., None])[..., 0].to(torch.int32)


_WORD = 0xFFFFFFFF


def randint_from_bits(bits: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``randint(key, (), 0, n)`` of the reference from the two 32-bit words
    its key draws.

    ``bits`` is ``(..., 2)`` int64 in ``[0, 2^32)``: the words ``hi``, ``lo``
    of ``bits(k1)``, ``bits(k2)`` for ``k1, k2 = split(key)``; ``n`` (>= 1,
    broadcastable) the range.  The reference's uint32 arithmetic, its wraps
    included: ``((hi % n) * m + lo % n) % n`` with ``m = (2^16 % n)^2 % n``.
    """
    n = n.to(torch.int64)
    hi, lo = bits[..., 0], bits[..., 1]
    m = (((65536 % n) ** 2) & _WORD) % n
    return (((((hi % n) * m) & _WORD) + lo % n) & _WORD) % n


def route_random(
    pick: torch.Tensor | None, mask: torch.Tensor | None = None,
    bits: torch.Tensor | None = None,
) -> torch.Tensor:
    """Uniformly random routing from an int32 draw ``pick``.

    Without a mask ``pick`` (in ``[0, K)``) is the server.  With one it is
    in ``[0, n_eligible)`` and picks the ``pick``-th eligible server (an
    all-False mask means all servers).  Given ``bits`` (the ``(..., 2)``
    words of :func:`randint_from_bits`) in place of ``pick``, the draw is
    made from this mask's eligible count.
    """
    if mask is None:
        if bits is not None:
            raise ValueError("random bits draw from the eligible count of a mask")
        return pick.to(torch.int32)
    mask = torch.where(mask.any(-1, keepdim=True), mask, True)
    if bits is not None:
        pick = randint_from_bits(bits, mask.sum(-1, dtype=torch.int64))
    cum = torch.cumsum(mask.to(torch.int32), -1, dtype=torch.int32)
    return torch.argmax((cum == pick[..., None] + 1).to(torch.int32), -1).to(
        torch.int32
    )


def route_tokens(
    tokens: torch.Tensor,
    gumbel: torch.Tensor | None = None,
    deterministic: bool = False,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pull policies (JIQ / hsq): join the server holding the most tokens.

    Scored as ``-tokens`` through :func:`route_shortest`, so ties (an empty
    pool included: the uniform fallback) resolve as JSAQ's do and masks
    compose through :func:`mask_scores`.
    """
    return route_shortest((0 - tokens).to(torch.float32), gumbel, deterministic, mask)


def route(
    policy: str,
    q_true: torch.Tensor,
    q_app: torch.Tensor,
    rr_ptr: torch.Tensor,
    gumbel: torch.Tensor | None = None,
    drain_slots: torch.Tensor | None = None,
    deterministic: bool = False,
    mask: torch.Tensor | None = None,
    *,
    subset: torch.Tensor | None = None,
    subset_gumbel: torch.Tensor | None = None,
    rand_pick: torch.Tensor | None = None,
    rand_bits: torch.Tensor | None = None,
    tokens: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch one job per batch row.  Returns ``(server, rr_ptr')``.

    ``jsq`` and ``sq2`` / ``sqd`` read the true queues, ``jsaq`` the
    approximated ones, ``rr`` and ``random`` neither, ``jiq`` / ``hsq`` the
    token pool ``tokens`` (the caller spends and refreshes it).
    ``drain_slots`` (optional, ``(..., K)``) makes the queue-reading
    policies minimise ``q_i * E[S] / r_i`` (SQ(d) within its subset).
    ``mask`` marks the eligible servers for every policy.  The slot's
    draws: ``gumbel`` for jsq / jsaq / jiq / hsq with random ties,
    ``subset`` and ``subset_gumbel`` for sq2 / sqd, ``rand_pick`` for random
    (or ``rand_bits``, see :func:`route_random`).
    """
    k = q_true.shape[-1]
    if drain_slots is None:
        scaled_true, scaled_app = q_true, q_app
    else:
        scaled_true = q_true.to(torch.float32) * drain_slots
        scaled_app = q_app.to(torch.float32) * drain_slots
    if policy == "jsq":
        return route_shortest(scaled_true, gumbel, deterministic, mask), rr_ptr
    if policy == "jsaq":
        return route_shortest(scaled_app, gumbel, deterministic, mask), rr_ptr
    if policy in ("sq2", "sqd"):
        return route_sqd(scaled_true, subset, subset_gumbel, mask), rr_ptr
    if policy == "rr":
        server, ptr = route_rr(rr_ptr, k, mask)
        return server.to(torch.int32), ptr
    if policy == "random":
        return route_random(rand_pick, mask, rand_bits), rr_ptr
    if policy in PULL_POLICIES:
        return route_tokens(tokens, gumbel, deterministic, mask), rr_ptr
    raise ValueError(f"unknown policy: {policy}")
