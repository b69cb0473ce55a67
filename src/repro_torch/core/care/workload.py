"""Workload layer: Bernoulli arrivals and job sizes, as functions of uniforms.

Port of ``repro/core/care/workload.py`` for the kinds of slice 1: Bernoulli
arrivals and the ``geometric`` / ``deterministic`` size distributions, plus
the serving tier's decode credit schedule (:func:`service_units`).
Every sampler is split in two:

* a deterministic function of given float32 uniforms
  (:func:`bernoulli_arrivals`, :func:`service_sizes`, :func:`gumbel`), which
  the tests feed with the reference's own uniforms and hold bit for bit;
* a draw of those uniforms from a ``torch.Generator``
  (:func:`uniforms`), which the simulator uses.  Torch cannot replay JAX's
  threefry stream, so the port's own draws match the reference only in
  distribution.

Derived constants are computed host-side in float64 and cast once, as the
reference does, so the same operands give the same float32 arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

ServiceKind = Literal["geometric", "deterministic"]

SLICE_2_WORKLOADS = "slice 2 of the port (ROADMAP 1, item 8)"

# Bounds of the size sampler's and the Gumbel transform's uniforms, as the
# reference draws them.
SIZE_U_MIN = 1e-7
SIZE_U_MAX = 1.0 - 1e-7
GUMBEL_U_MIN = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class ServiceProcess:
    """Job-size distribution: a kind plus its float32/int32 operands.

    Attributes:
      kind: ``"geometric"`` (Geometric(1/mean), support {1, 2, ...}, the
        paper's default) or ``"deterministic"`` (every job takes
        ``round(mean)`` slots).
      mean: f32 mean job size in slots.
      geo_log1p: f32 ``log1p(-1/mean)``, computed in float64, cast once.
      msr_slots: i32 ``max(round(mean), 1)``, the MSR emulation's per-job
        slot count (Definition 4.8).
    """

    kind: str
    mean: np.float32
    geo_log1p: np.float32
    msr_slots: np.int32

    @staticmethod
    def create(
        kind: str = "geometric", mean: float = 30.0
    ) -> "ServiceProcess":
        mean = float(mean)
        if mean < 1.0:
            raise ValueError(f"mean service must be >= 1 slot, got {mean}")
        if kind in ("pareto", "weibull"):
            raise NotImplementedError(
                f"service kind {kind!r} comes with {SLICE_2_WORKLOADS}"
            )
        if kind not in ("geometric", "deterministic"):
            raise ValueError(f"unknown service kind: {kind}")
        return ServiceProcess(
            kind=kind,
            mean=np.float32(mean),
            geo_log1p=np.float32(np.log1p(-1.0 / np.float64(mean))),
            msr_slots=np.int32(max(int(round(mean)), 1)),
        )


def service_sizes(u: torch.Tensor, kind: str, mean, geo_log1p) -> torch.Tensor:
    """Job sizes in whole slots from float32 uniforms in ``(0, 1)``.

    ``mean`` / ``geo_log1p`` are float32 operands broadcastable against
    ``u`` (one per run in the batched simulator).  The geometric kind is
    ``floor(log1p(-u) / log1p(-1/mean)) + 1`` in float32, as the reference
    computes it.
    """
    if kind == "geometric":
        sizes = torch.floor(torch.log1p(-u) / geo_log1p) + 1.0
    elif kind == "deterministic":
        sizes = torch.round(torch.as_tensor(mean, device=u.device)).expand_as(u)
    else:
        raise ValueError(f"unknown service kind: {kind}")
    return torch.clamp_min(sizes, 1.0).to(torch.int32)


def bernoulli_arrivals(u: torch.Tensor, load) -> torch.Tensor:
    """One potential arrival per slot: ``u < load`` on float32 uniforms."""
    return u < load


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

