"""Resource-allocation component (paper Sections 2.1.4 and 9.1).

Port of the main-path part of ``repro/core/care/routing.py``: JSQ, JSAQ and
round robin.  Policies are functions of tensors with a trailing server
axis and any leading batch axes.  Random tie-breaking takes a ``(..., K)``
float32 Gumbel tensor for the slot instead of a PRNG key (the reference
draws ``jax.random.gumbel(key, (K,))`` from the slot's key); a caller that
wants lowest-index ties passes ``deterministic=True`` and no Gumbels.
``torch.argmin`` / ``torch.argmax`` return the first index on ties, as
``jnp.argmin`` / ``jnp.argmax`` do.
"""
from __future__ import annotations

from typing import Literal

import torch

PolicyKind = Literal["jsq", "jsaq", "rr"]

SLICE_2_POLICIES = "slice 2 of the port (ROADMAP 1, item 8)"
SLICE_2_PULL = "slice 2 of the port (ROADMAP 1, item 10)"


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


def route(
    policy: str,
    q_true: torch.Tensor,
    q_app: torch.Tensor,
    rr_ptr: torch.Tensor,
    gumbel: torch.Tensor | None = None,
    drain_slots: torch.Tensor | None = None,
    deterministic: bool = False,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch one job per batch row.  Returns ``(server, rr_ptr')``.

    ``jsq`` reads the true queues, ``jsaq`` the approximated ones, ``rr``
    neither.  ``drain_slots`` (optional, ``(..., K)``) makes the
    shortest-queue family minimise ``q_i * E[S] / r_i``.
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
    if policy == "rr":
        server, ptr = route_rr(rr_ptr, k, mask)
        return server.to(torch.int32), ptr
    if policy in ("sq2", "sqd", "random"):
        raise NotImplementedError(
            f"policy {policy!r} comes with {SLICE_2_POLICIES}"
        )
    if policy in ("jiq", "hsq"):
        raise NotImplementedError(f"policy {policy!r} comes with {SLICE_2_PULL}")
    raise ValueError(f"unknown policy: {policy}")
