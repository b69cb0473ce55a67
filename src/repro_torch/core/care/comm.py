"""Communication component of the CARE model: the trigger core.

Port of ``repro/core/care/comm.py:87-265`` for the push kinds:

* ``rt``     -- a message every ``rt_period`` slots;
* ``dt``     -- a message after every ``x`` departures;
* ``et``     -- a message as soon as the approximation error reaches ``x``;
* ``et_rt``  -- ``et`` with an ``rt`` fallback after ``rt_period`` silent
  slots;
* ``exact``  -- one message per departure (Prop 6.1);
* ``none``   -- never;

and the pull kinds, where a server pushes a token to the balancer:

* ``jiq``    -- when this slot's departures left its queue empty;
* ``hsq``    -- when its queue drops below ``x`` (a downward crossing), or
  after ``rt_period`` silent slots (the token refresh).

The network model of the degraded control plane comes with ROADMAP 1,
item 9; of the reference's ``validate_control_plane`` the port keeps the
pull pairing and the token-refresh check.

Functions are vectorised over a trailing server axis and any leading batch
axes (the simulator's run axis).  ``x`` and ``rt_period`` may be numbers or
int32 tensors broadcastable against the counters (one per run).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Literal, Tuple

import torch

CommKind = Literal["none", "rt", "dt", "et", "et_rt", "exact", "jiq", "hsq"]

PUSH_KINDS = ("none", "rt", "dt", "et", "et_rt", "exact")
# Server-initiated (pull) kinds; each pairs 1:1 with the routing policy of
# the same name.
PULL_KINDS = ("jiq", "hsq")


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
    cfg: CommConfig,
    *,
    err=None,
    deps_since=None,
    slots_since=None,
    new_deps=None,
    q=None,
) -> torch.Tensor:
    """Pure trigger predicate on already-advanced counters.

    ``q`` is the end-of-slot queue length the pull kinds key on.
    """
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
    if cfg.kind == "jiq":
        return (new_deps > 0) & (q == 0)
    if cfg.kind == "hsq":
        return ((q < cfg.x) & (q + new_deps >= cfg.x)) | (
            slots_since >= cfg.rt_period
        )
    if cfg.kind == "none":
        return torch.zeros_like(deps_since, dtype=torch.bool)
    raise ValueError(f"unknown communication kind: {cfg.kind}")


def evaluate(
    state: CommState,
    cfg: CommConfig,
    err: torch.Tensor,
    new_deps: torch.Tensor,
    *,
    can_send: torch.Tensor | None = None,
    force: torch.Tensor | None = None,
    q: torch.Tensor | None = None,
    count_msgs: bool = True,
) -> Tuple[torch.Tensor, CommState]:
    """Advance the pattern by one slot and evaluate the trigger.

    This slot's departures and the elapsed slot are counted *before* the
    comparison, so a message fires in the slot its condition is met
    (Theorem 2.3's ``AQ <= x-1``).  ``force`` (servers that must send) is
    applied before ``can_send`` (servers able to send).  ``q`` is the
    end-of-slot queue length, read by the pull kinds only.  With
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
        q=q,
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


def validate_control_plane(
    *, policy: str | None = None, comm: str | None = None,
    token_refresh: float | None = None,
) -> None:
    """The pull-family checks of the reference's ``validate_control_plane``.

    A pull policy (``jiq`` / ``hsq``) pairs 1:1 with the comm kind of its
    name, and the hsq token-refresh rate is >= 0; every error names the
    field and the fix.
    """
    if policy is not None and comm is not None:
        if policy in PULL_KINDS:
            if comm == "exact":
                raise ValueError(
                    f"policy={policy!r} cannot run under comm='exact' --"
                    " the exact full-state channel is push-per-departure"
                    " and would double-bill the token traffic; set"
                    f" comm={policy!r} (the matching pull token channel)"
                )
            if comm != policy:
                raise ValueError(
                    f"policy={policy!r} requires comm={policy!r} (its"
                    f" server-initiated token channel), got comm={comm!r}"
                )
        elif comm in PULL_KINDS:
            raise ValueError(
                f"comm={comm!r} is the token channel of policy={comm!r};"
                f" it cannot drive the push policy {policy!r}"
            )
    if token_refresh is not None and token_refresh < 0:
        raise ValueError(
            f"token_refresh must be >= 0 (the hsq token-refresh rate;"
            f" 0 disables the periodic refresh), got {token_refresh}"
        )
