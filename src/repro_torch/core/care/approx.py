"""Approximation component of the CARE model (paper Section 4).

Port of ``repro/core/care/approx.py``.  The balancer keeps an approximation
``q_app`` of every queue, driven by the arrivals it routed itself and by an
emulated departure process:

* ``basic``  -- never emulate departures (Definition 4.2);
* ``msr``    -- emulate a FIFO in which every job takes ``msr_slots`` slots
  (Definition 4.8);
* ``msr_x``  -- ``msr`` with emulated departures capped at ``x - 1`` since
  the last message (Definition 4.9).

Functions are vectorised over a trailing server axis and any leading batch
axes.  ``msr_slots`` and ``x`` may be numbers or int32 tensors that
broadcast against the state (one per run).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Literal

import torch

ApproxKind = Literal["basic", "msr", "msr_x"]


@dataclasses.dataclass(frozen=True)
class ApproxConfig:
    kind: ApproxKind = "msr"
    msr_slots: Any = 30
    x: Any = 3


@dataclasses.dataclass
class EmuState:
    """Balancer-side emulation state, ``(..., K)`` int32 each.

    ``q_app`` is the approximated queue length, ``head_rem`` the remaining
    emulated service of the emulated head job, ``emu_deps`` the emulated
    departures since the last message (what ``msr_x`` truncates).
    """

    q_app: torch.Tensor
    head_rem: torch.Tensor
    emu_deps: torch.Tensor

    @staticmethod
    def init(q0: torch.Tensor, cfg: ApproxConfig) -> "EmuState":
        zeros = torch.zeros_like(q0, dtype=torch.int32)
        return EmuState(
            q_app=q0.to(torch.int32),
            head_rem=zeros + cfg.msr_slots,
            emu_deps=zeros,
        )


def emu_arrival(state: EmuState, server: int, cfg: ApproxConfig) -> EmuState:
    """Register one arrival routed to ``server`` (unbatched state)."""
    sel = torch.zeros_like(state.q_app, dtype=torch.bool)
    sel[server] = True
    return emu_arrival_masked(state, sel, cfg)


def emu_arrival_masked(
    state: EmuState, sel: torch.Tensor, cfg: ApproxConfig
) -> EmuState:
    """Register arrivals on the servers in the bool mask ``sel``.

    An arrival at an empty emulated queue enters service at once with a
    fresh mean-service estimate.
    """
    was_empty = state.q_app == 0
    return EmuState(
        q_app=state.q_app + sel.to(torch.int32),
        head_rem=torch.where(sel & was_empty, cfg.msr_slots, state.head_rem),
        emu_deps=state.emu_deps,
    )


def emu_drain_slot(
    state: EmuState,
    cfg: ApproxConfig,
    units: torch.Tensor | None = None,
    active: torch.Tensor | None = None,
) -> EmuState:
    """Advance the emulated queues by one slot.

    ``units`` is the per-server work of this slot (``None``: one unit);
    ``active`` (bool, broadcastable) freezes the emulation where False.
    """
    if cfg.kind == "basic":
        return state
    busy = state.q_app > 0
    if cfg.kind == "msr_x":
        ticking = busy & (state.emu_deps < (cfg.x - 1))
    else:
        ticking = busy
    if active is not None:
        ticking = ticking & active
    dec = 1 if units is None else units
    head_rem = torch.where(ticking, state.head_rem - dec, state.head_rem)
    dep = ticking & (head_rem <= 0)
    return EmuState(
        q_app=torch.where(dep, state.q_app - 1, state.q_app),
        head_rem=torch.where(dep, cfg.msr_slots, head_rem),
        emu_deps=torch.where(dep, state.emu_deps + 1, state.emu_deps),
    )


def emu_message_reset(
    state: EmuState, q_true: torch.Tensor, triggered: torch.Tensor,
    cfg: ApproxConfig,
) -> EmuState:
    """Servers in ``triggered`` report their true length; the emulation of
    every job present restarts with a fresh mean estimate (Definition 4.4)."""
    return EmuState(
        q_app=torch.where(triggered, q_true, state.q_app),
        head_rem=torch.where(triggered, cfg.msr_slots, state.head_rem),
        emu_deps=torch.where(triggered, 0, state.emu_deps),
    )


def approximation_error(state: EmuState, q_true: torch.Tensor) -> torch.Tensor:
    """Per-server approximation error ``AE_i(t) = |Q_i - q_app_i|`` (Eq. 6)."""
    return torch.abs(q_true - state.q_app)
