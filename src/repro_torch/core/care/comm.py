"""Communication component of the CARE model: the push trigger core.

Port of ``repro/core/care/comm.py:87-265`` for the push kinds:

* ``rt``     -- a message every ``rt_period`` slots;
* ``dt``     -- a message after every ``x`` departures;
* ``et``     -- a message as soon as the approximation error reaches ``x``;
* ``et_rt``  -- ``et`` with an ``rt`` fallback after ``rt_period`` silent
  slots;
* ``exact``  -- one message per departure (Prop 6.1);
* ``none``   -- never.

Functions are vectorised over a trailing server axis and any leading batch
axes (the simulator's run axis).  ``x`` and ``rt_period`` may be numbers or
int32 tensors broadcastable against the counters (one per run).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Literal, Tuple

import torch

CommKind = Literal["none", "rt", "dt", "et", "et_rt", "exact"]

PUSH_KINDS = ("none", "rt", "dt", "et", "et_rt", "exact")
PULL_KINDS = ("jiq", "hsq")

SLICE_2_PULL = "slice 2 of the port (ROADMAP 1, item 10)"


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Trigger kind plus its numeric thresholds (numbers or tensors)."""

    kind: CommKind = "et"
    x: Any = 3
    rt_period: Any = 100

    @staticmethod
    def from_rate(kind: CommKind, x=3, rt_rate: float = 0.01) -> "CommConfig":
        """Build a config from a per-slot message *rate* (RT-r convention)."""
        period = max(int(round(1.0 / max(rt_rate, 1e-9))), 1)
        return CommConfig(kind=kind, x=x, rt_period=period)


@dataclasses.dataclass
class CommState:
    """Per-server trigger counters ``(..., K)`` and the message total ``(...)``."""

    deps_since_msg: torch.Tensor
    slots_since_msg: torch.Tensor
    msgs: torch.Tensor

    @staticmethod
    def init(k: int, batch: tuple = (), device=None) -> "CommState":
        zeros = torch.zeros((*batch, k), dtype=torch.int32, device=device)
        return CommState(
            deps_since_msg=zeros,
            slots_since_msg=zeros.clone(),
            msgs=torch.zeros(batch, dtype=torch.int32, device=device),
        )


def trigger(
    cfg: CommConfig, *, err=None, deps_since=None, slots_since=None, new_deps=None
) -> torch.Tensor:
    """Pure trigger predicate on already-advanced counters."""
    if cfg.kind == "rt":
        return slots_since >= cfg.rt_period
    if cfg.kind == "dt":
        return deps_since >= cfg.x
    if cfg.kind == "et":
        return err >= cfg.x
    if cfg.kind == "et_rt":
        return (err >= cfg.x) | (slots_since >= cfg.rt_period)
    if cfg.kind == "exact":
        return new_deps > 0
    if cfg.kind == "none":
        return torch.zeros_like(deps_since, dtype=torch.bool)
    if cfg.kind in PULL_KINDS:
        raise NotImplementedError(
            f"pull comm kind {cfg.kind!r} comes with {SLICE_2_PULL}"
        )
    raise ValueError(f"unknown communication kind: {cfg.kind}")


def evaluate(
    state: CommState,
    cfg: CommConfig,
    err: torch.Tensor,
    new_deps: torch.Tensor,
    *,
    can_send: torch.Tensor | None = None,
    force: torch.Tensor | None = None,
    count_msgs: bool = True,
) -> Tuple[torch.Tensor, CommState]:
    """Advance the pattern by one slot and evaluate the trigger.

    This slot's departures and the elapsed slot are counted *before* the
    comparison, so a message fires in the slot its condition is met
    (Theorem 2.3's ``AQ <= x-1``).  ``force`` (servers that must send) is
    applied before ``can_send`` (servers able to send).  With
    ``count_msgs=False`` the trigger intent is returned and ``msgs`` is
    left as it was.  ``exact`` bills one message per departure, even when
    several departures share a slot.

    Returns ``(triggered, state')``: the ``(..., K)`` bool mask of senders
    and the state with their counters reset and ``msgs`` accumulated.
    """
    deps_since = state.deps_since_msg + new_deps
    slots_since = state.slots_since_msg + 1
    triggered = trigger(
        cfg,
        err=err,
        deps_since=deps_since,
        slots_since=slots_since,
        new_deps=new_deps,
    )
    if force is not None:
        triggered = triggered | force
    if can_send is not None:
        triggered = triggered & can_send

    if not count_msgs:
        sent = torch.zeros_like(state.msgs)
    elif cfg.kind == "exact":
        sent = new_deps.sum(-1, dtype=torch.int32)
    else:
        sent = triggered.sum(-1, dtype=torch.int32)

    return triggered, CommState(
        deps_since_msg=torch.where(triggered, 0, deps_since),
        slots_since_msg=torch.where(triggered, 0, slots_since),
        msgs=state.msgs + sent,
    )
