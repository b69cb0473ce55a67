"""Metrics for communication and performance (Section 2.1.5).

The host-side (numpy) part of ``repro/core/care/metrics.py``, kept in the
port so that it needs nothing of the JAX package: JCT statistics and CCDFs,
relative communication, the pull policies' token counters, and the
streaming serving engine's log-bucket JCT histogram (:func:`jct_bucket`
on numpy arrays and on int32 tensors, its edges, quantiles and summary).
"""
from __future__ import annotations

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# Fixed-bucket log-spaced JCT histogram: the streaming serving engine's
# tail-quantile accumulator.  Bucketing is exact integer arithmetic after an
# exact floor(log2): float64 frexp on the host and on tensors (float64
# carries every int32 exactly), __clz in the serving kernel.
# ---------------------------------------------------------------------------

# JCTs 1..3 get exact buckets; from 4 up, every octave [2^e, 2^(e+1)) is
# split into 4 linear sub-octaves (<= 25% relative width) through the full
# int32 range: 3 + 4 * 29 = 119 buckets.
HIST_BUCKETS = 119
_I32_MAX = np.iinfo(np.int32).max


def jct_bucket(j):
    """Histogram bucket of JCT ``j``, clipped into [1, 2^31-1]: int32, as a
    numpy array for a number or an array, as a tensor for an int tensor."""
    if torch.is_tensor(j):
        j = torch.clamp(j.to(torch.int32), 1, _I32_MAX)
        e = (torch.frexp(j.to(torch.float64))[1] - 1).to(torch.int32)
        sub = (j >> torch.clamp_min(e - 2, 0)) & 3
        return torch.where(e < 2, j - 1, 4 * e + sub - 5).to(torch.int32)
    j = np.clip(np.asarray(j, np.int32), 1, _I32_MAX)
    e = (np.frexp(j.astype(np.float64))[1] - 1).astype(np.int32)
    sub = (j >> np.maximum(e - 2, 0)) & 3
    return np.where(e < 2, j - 1, 4 * e + sub - 5).astype(np.int32)


def jct_bucket_edges() -> np.ndarray:
    """Lower edges of every bucket plus the exclusive top, int64:
    ``edges[b] <= j < edges[b + 1]`` iff ``jct_bucket(j) == b``; shape
    ``(HIST_BUCKETS + 1,)`` with ``edges[-1] == 2^31``."""
    edges = np.empty(HIST_BUCKETS + 1, np.int64)
    edges[:3] = [1, 2, 3]
    b = np.arange(3, HIST_BUCKETS, dtype=np.int64)
    e, sub = (b + 5) // 4, (b + 5) % 4
    edges[3:HIST_BUCKETS] = (4 + sub) << (e - 2)
    edges[HIST_BUCKETS] = np.int64(2) ** 31
    return edges


def log_hist_quantiles(hist: np.ndarray, qs) -> np.ndarray:
    """Quantiles of a :func:`jct_bucket` histogram, one per ``q`` in ``qs``,
    interpolated linearly inside the containing bucket (exact for the
    buckets 1, 2, 3; within one sub-octave above).  An empty histogram
    gives zeros."""
    hist = np.asarray(hist, np.int64)
    qs = np.atleast_1d(np.asarray(qs, np.float64))
    total = int(hist.sum())
    if total == 0:
        return np.zeros(qs.shape)
    edges = jct_bucket_edges()
    cum = np.cumsum(hist)
    ranks = qs * (total - 1)
    out = np.empty(qs.shape)
    for i, rank in enumerate(ranks):
        b = int(np.searchsorted(cum, rank, side="right"))
        prev = cum[b - 1] if b > 0 else 0
        frac = (rank - prev + 0.5) / hist[b]
        out[i] = edges[b] + min(max(frac, 0.0), 1.0) * (edges[b + 1] - edges[b] - 1)
    return out


def stream_summary(count: int, mean: float, m2: float, max_jct: int,
                   hist: np.ndarray) -> dict:
    """Summary of the streaming engine's JCT accumulators: ``count`` /
    ``mean`` / ``m2`` (Welford), the exact ``max_jct`` and the log-bucket
    ``hist``, whose quantiles are clamped to the maximum.  With no count
    or an empty histogram every statistic is 0 (``max`` is kept)."""
    count = int(count)
    hist = np.asarray(hist, np.int64)
    if count == 0 or int(hist.sum()) == 0:
        return {"count": 0, "mean": 0.0, "std": 0.0, "p50": 0.0,
                "p90": 0.0, "p99": 0.0, "p999": 0.0, "max": int(max_jct)}
    qs = log_hist_quantiles(hist, (0.5, 0.9, 0.99, 0.999))
    p50, p90, p99, p999 = np.minimum(qs, float(max_jct))
    return {
        "count": count,
        "mean": float(mean),
        "std": float(np.sqrt(max(float(m2), 0.0) / count)),
        "p50": float(p50),
        "p90": float(p90),
        "p99": float(p99),
        "p999": float(p999),
        "max": int(max_jct),
    }
