"""Metrics for communication and performance (Section 2.1.5).

The host-side (numpy) part of ``repro/core/care/metrics.py`` that the
slotted tier uses, kept in the port so that it needs nothing of the JAX
package.  The streaming histogram helpers come with the serving tier.
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


def relative_communication(
    result: "slotted_sim.SimResult", policy: str, sqd: int = 2
) -> float:
    """Messages relative to the exact-state baseline (1 per departure)."""
    msgs = slotted_sim.exact_state_messages(result, policy, sqd)
    return msgs / max(result.departures, 1)
