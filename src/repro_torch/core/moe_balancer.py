"""CARE expert load balancer: the paper's technique inside MoE routing.

Port of ``repro/core/moe_balancer.py``.  Experts are the servers, tokens
the jobs, routers the dispatchers.  The balancer keeps an *approximated*
per-expert load and biases the gate's selection score by it (JSAQ on the
gate's candidates); exact counts are synchronised only sparsely:

* ``dt`` -- every ``x`` steps;
* ``et`` -- when the emulation error reaches ``x`` times the mean
  per-expert load.

Between syncs the approximation evolves by the paper's queue-length
emulation: the dispatcher's own routed counts minus an MSR drain.  The
selection bias is a PI controller on the approximated relative load:
``alpha * clip(load/mean - 1)`` plus an integral term that cancels a
persistent gate skew (DeepSeek-V3's aux-loss-free update, driven by the
CARE-approximated load).  State leaves are ``(L, E)`` float32, or
``(L, DP, TP, E)`` with one row per dispatcher.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import CareConfig
from repro_torch.core.care import comm as comm_lib
from repro_torch.core.care.slotted_sim import _resolve_device

_EPS = 1e-6


@dataclasses.dataclass
class BalancerState:
    """Per-MoE-layer balancer state; leaves shaped (L, E) or (L, DP, TP, E)."""

    load_approx: torch.Tensor  # dispatcher-side approximated load
    true_load: torch.Tensor  # expert-side exact load EMA (the message content)
    true_counts: torch.Tensor  # expert-side exact counts since last sync
    bias: torch.Tensor  # integral selection bias (same shape as load_approx)
    steps_since_sync: torch.Tensor  # () int32

    @staticmethod
    def init(num_layers: int, num_experts: int, device=None,
             dispatchers: tuple[int, int] = ()) -> "BalancerState":
        """Zero state on ``device`` (None means the CUDA card); with
        ``dispatchers=(DP, TP)`` one row per dispatcher."""
        dev = _resolve_device(device)
        z = torch.zeros((num_layers, *dispatchers, num_experts), dtype=torch.float32,
                        device=dev)
        return BalancerState(
            load_approx=z,
            true_load=z,
            true_counts=z,
            bias=z,
            steps_since_sync=torch.zeros((), dtype=torch.int32, device=dev),
        )


def _relative_overload(load: torch.Tensor) -> torch.Tensor:
    """(load / mean - 1) per layer; 0 everywhere when balanced."""
    mean = torch.mean(load, dim=-1, keepdim=True)
    return load / (mean + _EPS) - 1.0


def selection_bias(state: BalancerState, cfg: CareConfig) -> torch.Tensor:
    """JSAQ selection bias (L, E): positive for over-loaded experts.

    ``integral + alpha * clip(rel, +-clip)`` on the relative overload of
    the approximated load.  It shifts only the selection score; the
    combine weights stay unbiased.
    """
    if not cfg.enabled:
        return torch.zeros_like(state.load_approx)
    rel = _relative_overload(state.load_approx)
    prop = cfg.bias_alpha * torch.clamp(rel, -cfg.bias_clip, cfg.bias_clip)
    return state.bias + prop


def post_step_update(
    state: BalancerState, step_counts: torch.Tensor, cfg: CareConfig
) -> BalancerState:
    """Advance the emulation by one step (no communication).

    ``step_counts`` (L, E) are the dispatcher's own routed counts; the MSR
    drain emulates expert service; the integral bias accumulates the
    approximated relative overload and is kept zero-mean.
    """
    load = (state.load_approx + step_counts) * cfg.drain
    rel = _relative_overload(load)
    bias = state.bias + cfg.gamma * torch.clamp(rel, -1.0, 1.0)
    bias = bias - torch.mean(bias, dim=-1, keepdim=True)
    return BalancerState(
        load_approx=load,
        true_load=(state.true_load + step_counts) * cfg.drain,
        true_counts=state.true_counts + step_counts,
        bias=bias,
        steps_since_sync=state.steps_since_sync + 1,
    )


def sync(state: BalancerState, cfg: CareConfig) -> BalancerState:
    """Exact synchronisation: snap the approximation to the true load.

    With per-dispatcher state (L, DP, TP, E) the message is the mean over
    dispatchers of the expert-side loads, which every dispatcher takes; with
    one dispatcher the emulation already is the exact state and the snap
    changes nothing.
    """
    tl = state.true_load
    if tl.dim() == 4:
        snapped = torch.mean(tl, dim=(1, 2), keepdim=True).expand(tl.shape).contiguous()
    else:
        snapped = tl
    return BalancerState(
        load_approx=snapped,
        true_load=tl,
        true_counts=torch.zeros_like(state.true_counts),
        bias=state.bias,
        steps_since_sync=torch.zeros_like(state.steps_since_sync),
    )


def needs_sync(state: BalancerState, cfg: CareConfig) -> torch.Tensor:
    """ET/DT trigger predicate (0-d bool tensor) for host-level scheduling.

    DT-x: every x steps (RT with period x in the comm core's terms).  ET-x:
    the expert-side error, |true - approx| over the mean per-expert load,
    reaches x.
    """
    if cfg.comm == "dt":
        return comm_lib.trigger(
            comm_lib.CommConfig(kind="rt", rt_period=cfg.x),
            slots_since=state.steps_since_sync,
        )
    mean_load = torch.mean(state.true_load, dim=-1, keepdim=True) + _EPS
    err = torch.abs(state.true_load - state.load_approx) / mean_load
    return comm_lib.trigger(comm_lib.CommConfig(kind="et", x=cfg.x), err=torch.max(err))


def balance_metrics(counts: torch.Tensor) -> dict:
    """Load-balance quality of one step's dispatch counts (E,)."""
    c = counts.to(torch.float32)
    mean = torch.mean(c) + 1e-9
    return {
        "max_over_mean": torch.max(c) / mean,
        "min_over_mean": torch.min(c) / mean,
        "cv": torch.std(c, correction=0) / mean,
    }
