"""The one percentile / latency-summary convention for the whole stack.

Before this module, :class:`~repro.runtime.engine.EngineReport`,
:class:`~repro.runtime.fleet.FleetReport`, the Monte-Carlo simulator and
several benchmarks each carried their own copy of the same three lines of
percentile / throughput-window arithmetic — with subtly different
empty-series behavior. Every report now routes through these helpers, so
the convention is stated once:

- **Percentiles are linear-interpolation** (numpy's default
  ``np.percentile``), NOT nearest-rank. A single sample is every
  percentile of itself; an empty series has percentile ``inf`` (a latency
  that never completed) — the sentinel every report already used.
- **Throughput windows** span ``[first arrival, last completion]`` of the
  completed set, guarded against zero-width windows.

The P² sketch in :mod:`repro.obs.metrics` estimates the same
linear-interpolation quantile (its small-n exact path calls
:func:`percentile` directly), so report rows and streaming metrics agree
within the sketch's documented error.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile of ``xs`` (numpy convention).

    Empty series return ``inf`` (the "never completed" latency sentinel);
    a single sample is every percentile of itself.
    """
    xs = np.asarray(xs, np.float64)
    if xs.size == 0:
        return float("inf")
    return float(np.percentile(xs, q))


def throughput(n: int, t0: float, t1: float) -> float:
    """Completions per second over the window ``[t0, t1]``, zero-width
    guarded. Zero completions are zero throughput regardless of window."""
    if n <= 0:
        return 0.0
    return n / max(t1 - t0, 1e-12)


def latency_summary(lats: Sequence[float],
                    slo: Optional[float] = None) -> Dict[str, float]:
    """The standard latency row: mean / p50 / p99 (+ SLO attainment).

    Empty series follow the report convention: percentiles and mean are
    ``inf``, attainment is 0. ``slo=None`` omits the attainment key.
    """
    lats = np.asarray(lats, np.float64)
    out = {
        "mean": float(lats.mean()) if lats.size else float("inf"),
        "p50": percentile(lats, 50),
        "p99": percentile(lats, 99),
    }
    if slo is not None:
        out["slo_attainment"] = (float(np.mean(lats <= slo))
                                 if lats.size else 0.0)
    return out
