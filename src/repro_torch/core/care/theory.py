"""Closed-form communication/approximation bounds from the paper.

A copy of ``repro/core/care/theory.py``, kept in the port so that it needs
nothing of the JAX package.

* Theorem 2.3: DT-x / ET-x with basic or MSR-x give ``AQ <= x-1`` using at
  most ``1/x`` messages per departure.
* Theorem 2.4: ET-x + MSR, exponential service: expected inter-message time
  ``E[tau] >= (x/2 - 1)^2 / mu``  (x >= 3).
* Theorem 2.5: same, with infinite backlog: ``E[tau] >= x(x-1)/mu``; the
  implied relative communication is ``1/(x^2 - x)`` of the exact-state rate.
* Abstract's headline form, in terms of max error ``y = x - 1``:
  relative communication ``1/(y^2 + y)``.
"""
from __future__ import annotations

import numpy as np


def dt_relative_comm(x: np.ndarray | int) -> np.ndarray:
    """Thm 2.3 bound: messages per departure of DT-x / ET-x (basic, MSR-x)."""
    x = np.asarray(x, dtype=np.float64)
    return 1.0 / x


def et_msr_relative_comm_backlogged(x: np.ndarray | int) -> np.ndarray:
    """Thm 2.5 bound: relative communication of ET-x + MSR under heavy load."""
    x = np.asarray(x, dtype=np.float64)
    return 1.0 / (x * x - x)


def et_msr_relative_comm_general(x: np.ndarray | int) -> np.ndarray:
    """Thm 2.4 bound: relative communication of ET-x + MSR, general (x>=3)."""
    x = np.asarray(x, dtype=np.float64)
    return 1.0 / np.square(x / 2.0 - 1.0)


def headline_relative_comm(y: np.ndarray | int) -> np.ndarray:
    """Abstract form: error budget y ==> communication factor 1/(y^2 + y)."""
    y = np.asarray(y, dtype=np.float64)
    return 1.0 / (y * y + y)


def max_error_bound(x: int, comm: str, approx: str) -> float | None:
    """Deterministic AQ bound for a (pattern, algorithm) combination.

    Returns None when no deterministic bound exists (e.g. DT-x with
    unbounded MSR, Example 6.6; any RT-r combination, Section 6.2).
    """
    if comm == "et":
        return float(x - 1)  # Prop 6.8: holds for ANY emulation algorithm.
    if comm == "dt" and approx in ("basic", "msr_x"):
        return float(x - 1)  # Eq. (18) and Prop 6.7.
    return None


def messages_per_departure_bound(comm: str, approx: str, x: int) -> float | None:
    """Deterministic M(t) <= D(t)/x -type bound, when one exists."""
    if comm == "dt":
        return 1.0 / x  # Prop 6.4 (any approximation algorithm).
    if comm == "et" and approx in ("basic", "msr_x"):
        return 1.0 / x  # Prop 6.8.
    return None  # ET + MSR: only the stochastic bound of Prop 6.9.
