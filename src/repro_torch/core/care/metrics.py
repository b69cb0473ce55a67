"""Metrics for communication and performance (Section 2.1.5).

The host-side (numpy) part of ``repro/core/care/metrics.py`` that the
slotted tier uses, kept in the port so that it needs nothing of the JAX
package: JCT statistics and CCDFs, relative communication and the pull
policies' token counters.  The streaming histogram helpers come with the
serving tier.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.care import slotted_sim


def ccdf(samples: np.ndarray, grid: np.ndarray | None = None):
    """Complement CDF of ``samples`` on ``grid`` (paper Figures 3, 8-12)."""
    samples = np.asarray(samples)
    if grid is None:
        hi = max(int(samples.max()) if samples.size else 1, 1)
        grid = np.unique(np.round(np.geomspace(1, hi, 128)).astype(np.int64))
    frac = np.array([(samples > g).mean() if samples.size else 0.0 for g in grid])
    return grid, frac


def jct_summary(jct: np.ndarray) -> dict:
    """Mean / tail percentiles of job completion times.

    An empty sample yields all-zero statistics with ``count`` 0, never NaN.
    """
    jct = np.asarray(jct)
    if jct.size == 0:
        return {"count": 0, "mean": 0.0, "p50": 0.0, "p90": 0.0,
                "p99": 0.0, "p999": 0.0}
    return {
        "count": int(jct.size),
        "mean": float(jct.mean()),
        "p50": float(np.percentile(jct, 50)),
        "p90": float(np.percentile(jct, 90)),
        "p99": float(np.percentile(jct, 99)),
        "p999": float(np.percentile(jct, 99.9)),
    }


def mean_jct(jct: np.ndarray) -> float:
    """Mean JCT of a sample array; 0.0 (never NaN) when nothing completed."""
    jct = np.asarray(jct)
    return float(jct.mean()) if jct.size else 0.0


def token_summary(token_sum: int, token_misses: int, slots: int,
                  routed: int) -> dict:
    """Summary of the pull-policy token counters (JIQ / hsq runs).

    ``token_sum`` integrates the end-of-slot token pool over ``slots``
    slots; ``token_misses`` counts the routed jobs, of ``routed``, that
    found an empty pool.  An empty window (``slots == 0`` and
    ``routed == 0``) yields finite all-zero statistics with ``count`` 0,
    never NaN.
    """
    slots = int(slots)
    routed = int(routed)
    token_sum = int(token_sum)
    token_misses = int(token_misses)
    if routed == 0 and slots == 0:
        return {"count": 0, "mean_tokens": 0.0, "miss_rate": 0.0,
                "hit_rate": 0.0}
    miss_rate = token_misses / routed if routed else 0.0
    return {
        "count": routed,
        "mean_tokens": token_sum / slots if slots else 0.0,
        "miss_rate": miss_rate,
        "hit_rate": (1.0 - miss_rate) if routed else 0.0,
    }


def ccdf_dominates(a: np.ndarray, b: np.ndarray, tol: float = 0.02) -> bool:
    """True if the JCT distribution ``a`` stochastically dominates ``b``
    (``a`` is better: its CCDF is pointwise <= ``b``'s, up to ``tol``)."""
    hi = int(max(a.max() if a.size else 1, b.max() if b.size else 1))
    grid = np.unique(np.round(np.geomspace(1, hi, 64)).astype(np.int64))
    _, ca = ccdf(a, grid)
    _, cb = ccdf(b, grid)
    return bool(np.all(ca <= cb + tol))


def relative_communication(
    result: "slotted_sim.SimResult", policy: str, sqd: int = 2
) -> float:
    """Messages relative to the exact-state baseline (1 per departure)."""
    msgs = slotted_sim.exact_state_messages(result, policy, sqd)
    return msgs / max(result.departures, 1)
