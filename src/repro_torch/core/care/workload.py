"""Workload layer: arrival processes and job sizes, as functions of uniforms.

Port of ``repro/core/care/workload.py``:

* arrivals -- Bernoulli (the paper's default) or a two-state
  Markov-modulated Bernoulli process (``mmpp``), either one optionally
  modulated by a diurnal curve ``1 + amp * sin(2 pi t / period)``;
* sizes -- a :class:`ServiceProcess` of kind ``geometric``,
  ``deterministic``, ``pareto`` or ``weibull``;
* arrival classes drawn by inverse CDF on a class mix;
* the per-server credit schedule of heterogeneous service rates
  (:func:`service_units`);
* the server fault process: the crash <-> healthy chain
  (:func:`fault_transitions`) and the work a faulted server does
  (:func:`faulted_service_units`).

Every sampler is split in two:

* a deterministic function of given uniforms (:func:`bernoulli_arrivals`,
  :func:`mmpp_arrivals_from_rates`, :func:`service_sizes`,
  :func:`arrival_classes`, :func:`gumbel`), which the tests feed with the
  reference's own uniforms and hold bit for bit;
* a draw of those uniforms from a ``torch.Generator``
  (:func:`uniforms`), which the simulator uses.  Torch cannot replay JAX's
  threefry stream, so the port's own draws match the reference only in
  distribution.

Derived constants are computed host-side in float64 and cast once, as the
reference does, so the same operands give the same float32 arithmetic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np
import torch

ServiceKind = Literal["geometric", "deterministic", "pareto", "weibull"]
SERVICE_KINDS = ("geometric", "deterministic", "pareto", "weibull")

# Bounds of the size sampler's and the Gumbel transform's uniforms, as the
# reference draws them.
SIZE_U_MIN = 1e-7
SIZE_U_MAX = 1.0 - 1e-7
GUMBEL_U_MIN = float(np.finfo(np.float32).tiny)
# 2 pi as the reference's float32 product sees it (a weakly typed Python
# float meeting a float32 operand).
TWO_PI_F32 = np.float32(2.0 * np.pi)


@dataclasses.dataclass(frozen=True)
class ServiceProcess:
    """Job-size distribution: a kind plus its float32/int32 operands.

    Attributes:
      kind: ``"geometric"`` (Geometric(1/mean), support {1, 2, ...}, the
        paper's default), ``"deterministic"`` (every job takes
        ``round(mean)`` slots), ``"pareto"`` (Pareto with tail index
        ``tail > 1`` and the scale that gives the continuous mean
        ``mean``) or ``"weibull"`` (shape ``tail``, the scale for mean
        ``mean``); the last two are discretised by ``ceil``.
      mean: f32 mean job size in slots.
      tail: f32 Pareto alpha or Weibull shape (reporting; the samplers use
        ``scale`` and ``inv_tail``).
      geo_log1p: f32 ``log1p(-1/mean)``, computed in float64, cast once.
      msr_slots: i32 ``max(round(mean), 1)``, the MSR emulation's per-job
        slot count (Definition 4.8).
      scale: f32 Pareto ``x_m`` or Weibull ``lambda`` (0 for the others).
      inv_tail: f32 ``1/tail`` (0 for the others).
    """

    kind: str
    mean: np.float32
    geo_log1p: np.float32
    msr_slots: np.int32
    tail: np.float32 = np.float32(2.0)
    scale: np.float32 = np.float32(0.0)
    inv_tail: np.float32 = np.float32(0.0)

    @staticmethod
    def create(
        kind: str = "geometric", mean: float = 30.0, tail: float = 2.0
    ) -> "ServiceProcess":
        mean = float(mean)
        tail = float(tail)
        if mean < 1.0:
            raise ValueError(f"mean service must be >= 1 slot, got {mean}")
        scale = 0.0
        inv_tail = 0.0
        if kind == "pareto":
            if tail <= 1.0:
                raise ValueError(
                    f"pareto tail index must be > 1 for a finite mean, got {tail}"
                )
            scale = mean * (tail - 1.0) / tail
            inv_tail = 1.0 / tail
        elif kind == "weibull":
            if tail <= 0.0:
                raise ValueError(f"weibull shape must be > 0, got {tail}")
            scale = mean / math.gamma(1.0 + 1.0 / tail)
            inv_tail = 1.0 / tail
        elif kind not in ("geometric", "deterministic"):
            raise ValueError(f"unknown service kind: {kind}")
        return ServiceProcess(
            kind=kind,
            mean=np.float32(mean),
            geo_log1p=np.float32(np.log1p(-1.0 / np.float64(mean))),
            msr_slots=np.int32(max(int(round(mean)), 1)),
            tail=np.float32(tail),
            scale=np.float32(scale),
            inv_tail=np.float32(inv_tail),
        )


def service_sizes(
    u: torch.Tensor, kind: str, mean, geo_log1p, scale=None, inv_tail=None
) -> torch.Tensor:
    """Job sizes in whole slots from float32 uniforms in ``(0, 1)``.

    The operands are float32, broadcastable against ``u`` (one per run in
    the batched simulator); ``scale`` / ``inv_tail`` are read by the
    heavy-tailed kinds only.  Each kind is the reference's float32
    formula: ``floor(log1p(-u) / log1p(-1/mean)) + 1`` (geometric),
    ``round(mean)`` (deterministic), ``ceil`` of :func:`pareto_raw` or
    :func:`weibull_raw`, all clamped below at 1.
    """
    if kind == "geometric":
        sizes = torch.floor(torch.log1p(-u) / geo_log1p) + 1.0
    elif kind == "deterministic":
        sizes = torch.round(torch.as_tensor(mean, device=u.device)).expand_as(u)
    elif kind == "pareto":
        sizes = torch.ceil(pareto_raw(u, scale, inv_tail))
    elif kind == "weibull":
        sizes = torch.ceil(weibull_raw(u, scale, inv_tail))
    else:
        raise ValueError(f"unknown service kind: {kind}")
    return torch.clamp_min(sizes, 1.0).to(torch.int32)


def pareto_raw(u: torch.Tensor, scale, inv_tail) -> torch.Tensor:
    """Continuous Pareto(scale, 1/inv_tail) samples by inverse CDF."""
    return scale * torch.pow(u, -torch.as_tensor(inv_tail, device=u.device))


def weibull_raw(u: torch.Tensor, scale, inv_tail) -> torch.Tensor:
    """Continuous Weibull(shape 1/inv_tail, scale) samples by inverse CDF."""
    return scale * torch.pow(-torch.log(u), torch.as_tensor(inv_tail, device=u.device))


def diurnal_modulation(t_idx: torch.Tensor, amp, period) -> torch.Tensor:
    """Per-slot rate multiplier ``1 + amp * sin(2 pi t / period)``, float32.

    ``amp`` / ``period`` are float32 operands broadcastable against
    ``t_idx`` (one per run).  ``amp = 0`` gives exactly 1.0 everywhere, so
    an unmodulated cell keeps the flat rate bit for bit.
    """
    two_pi = torch.as_tensor(TWO_PI_F32, device=t_idx.device)
    phase = two_pi * t_idx.to(torch.float32) / period
    return 1.0 + amp * torch.sin(phase)


def bernoulli_arrivals(u: torch.Tensor, load, mod=None) -> torch.Tensor:
    """One potential arrival per slot: ``u < load`` on float32 uniforms.

    ``mod`` (optional, float32, broadcastable) multiplies the rate: the
    diurnal curve of :func:`diurnal_modulation`.
    """
    return u < (load if mod is None else load * mod)


def mmpp_arrivals_from_rates(
    u_switch: torch.Tensor,
    u_arr: torch.Tensor,
    lam_hi,
    lam_lo,
    burst_stay,
    mod=None,
) -> torch.Tensor:
    """Two-state Markov-modulated Bernoulli arrivals on given uniforms.

    The chain starts in state 0 (the lull) and switches state in every slot
    whose ``u_switch >= burst_stay``; a slot's state is the parity of the
    switches up to and including it (the reference's ``lax.scan`` over the
    chain, as one cumulative sum along the last axis).  The slot's rate is
    ``lam_hi`` in state 1 and ``lam_lo`` in state 0, times ``mod``, and an
    arrival is ``u_arr < rate``: the same compares and selects on the same
    float32 values as the scan, so the arrivals are equal bit for bit.
    """
    switch = (u_switch >= burst_stay).to(torch.int32)
    burst = (torch.cumsum(switch, -1, dtype=torch.int32) & 1) == 1
    lam = torch.where(burst, lam_hi, lam_lo)
    if mod is not None:
        lam = lam * mod
    return u_arr < lam


def arrival_classes(u: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """Per-slot arrival class ids by inverse CDF on the class mix.

    ``mix`` is ``(..., C)`` float32 class weights (normalised here), ``u``
    ``(..., T)`` float32 uniforms with the same leading axes.  A slot's
    class is the number of cumulative weights ``<= u``, clipped to
    ``C - 1``; int32.
    """
    cum = torch.cumsum(mix, -1) / mix.sum(-1, keepdim=True)
    cls = torch.searchsorted(cum.contiguous(), u.contiguous(), right=True,
                             out_int32=True)
    return torch.clamp(cls, 0, mix.shape[-1] - 1)


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel samples ``-log(-log(u))`` from uniforms in ``(0, 1)``."""
    return -torch.log(-torch.log(u))


def service_units(slot_idx: torch.Tensor, rates: torch.Tensor) -> torch.Tensor:
    """Work units each server completes in slot ``slot_idx`` (credit schedule).

    ``floor((t+1) r) - floor(t r)`` in float32, as the reference computes it:
    the long-run average is exactly ``r`` units per slot.  ``slot_idx`` is a
    float32 tensor (a 0-d view of a slot-index vector, so that the slot loop
    makes no host-to-device copy); ``rates`` is float32.
    """
    t = slot_idx.to(torch.float32)
    return (torch.floor((t + 1.0) * rates) - torch.floor(t * rates)).to(torch.int32)


def fault_transitions(faulted: torch.Tensor, fault_u: torch.Tensor,
                      crash_rate, recover_rate):
    """One slot of the two-state fault chain: ``(faulted', recovered)``.

    A healthy server crashes when ``fault_u < crash_rate``, a faulted one
    recovers when ``fault_u < recover_rate``: one float32 uniform a
    (slot, server) serves both, since a server is in one state.
    ``recovered`` marks this slot's recoveries (the resync trigger).
    """
    crash = ~faulted & (fault_u < crash_rate)
    recover = faulted & (fault_u < recover_rate)
    return (faulted | crash) & ~recover, recover


def faulted_service_units(slot_idx: torch.Tensor, faulted: torch.Tensor,
                          nominal_units, fault_kind: str, slow_factor,
                          rates: torch.Tensor | None = None) -> torch.Tensor:
    """Work units each server completes this slot under the fault process.

    A crashed server (``"crash"``) does no work, its jobs wait; a slowed
    one (``"slow"``) works by the credit schedule of ``rates *
    slow_factor`` (unit rates when ``rates`` is None).  Healthy servers
    keep ``nominal_units``.  ``slot_idx`` is a float32 tensor as in
    :func:`service_units`.
    """
    nominal = nominal_units
    if not torch.is_tensor(nominal):
        nominal = torch.full(faulted.shape, nominal, dtype=torch.int32, device=faulted.device)
    if fault_kind == "crash":
        slowed = torch.zeros_like(nominal)
    elif fault_kind == "slow":
        base = torch.ones(faulted.shape, dtype=torch.float32, device=faulted.device)
        if rates is not None:
            base = rates.to(torch.float32)
        slowed = service_units(slot_idx, base * slow_factor)
    else:
        raise ValueError(f"unknown fault kind: {fault_kind}")
    return torch.where(faulted, slowed, nominal)


def distinct_subsets(
    gen: torch.Generator, t: int, k: int, d: int, *, device=None
) -> torch.Tensor:
    """``(t, d)`` int32 samples of ``d`` distinct servers of ``k``, one a slot.

    Floyd's algorithm, vectorised over the slots: for ``j`` from ``k - d``
    to ``k - 1`` draw ``r`` uniform in ``[0, j]`` and take ``j`` if ``r``
    is already taken, else ``r``.  Every ``d``-subset is equally likely,
    and the draw is O(d) a slot (never a ``(t, k)`` permutation).
    """
    cols: list[torch.Tensor] = []
    for j in range(k - d, k):
        r = torch.randint(0, j + 1, (t,), generator=gen, device=device,
                          dtype=torch.int32)
        if cols:
            taken = (torch.stack(cols, -1) == r[:, None]).any(-1)
            r = torch.where(taken, j, r)
        cols.append(r)
    return torch.stack(cols, -1)


def uniforms(
    gen: torch.Generator,
    shape,
    *,
    minval: float = 0.0,
    maxval: float = 1.0,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """float32 uniforms in ``[minval, maxval)`` drawn from ``gen``."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    if minval == 0.0 and maxval == 1.0:
        return u
    return torch.clamp_min(u * (maxval - minval) + minval, minval)

