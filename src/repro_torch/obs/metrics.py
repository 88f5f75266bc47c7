"""Streaming metrics: counters / gauges / histograms with P² quantiles.

The serving stack's distributional claims (p50/p95/p99 latency,
share-recovery tails) must be observable on long runs without storing
every sample. :class:`Histogram` therefore carries one :class:`P2Quantile`
sketch per tracked quantile — the Jain & Chlamtac (1985) *piecewise-
parabolic* estimator: five markers, O(1) memory and O(1) update,
independent of stream length.

**Accuracy contract** (pinned by ``tests/test_obs.py``): for n ≤ 5
observations the sketch is EXACT (it holds the raw samples and evaluates
the same linear-interpolation percentile as
:func:`repro.obs.stats.percentile`, the convention every report row
uses). Beyond that it is an estimate: for smooth unimodal distributions
(uniform, exponential, lognormal service/latency shapes) expect ≲5%
relative error on p50 and ≲15% on p99 at a few thousand samples. Reports
that hold all samples anyway (``EngineReport``) keep computing exact
percentiles via :mod:`repro.obs.stats`; the sketch is for streaming
scopes where retention is the cost.

Scoping: a :class:`MetricsRegistry` keys every instrument by
``(name, labels)`` — by convention ``tenant=`` and ``slo_class=`` labels
— so fleet lanes record into disjoint series with zero coordination.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.stats import percentile


class P2Quantile:
    """Jain & Chlamtac P² streaming estimator of one quantile ``q``.

    Five markers track (min, q/2, q, (1+q)/2, max) height estimates;
    each :meth:`observe` adjusts the middle markers toward their desired
    positions with a piecewise-parabolic height update. Fixed memory,
    no sample retention.
    """

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = float(q)
        self.count = 0
        self._heights: Optional[np.ndarray] = None    # marker heights
        self._pos: Optional[np.ndarray] = None        # marker positions
        self._want: Optional[np.ndarray] = None       # desired positions
        self._dwant = np.array([0.0, q / 2, q, (1 + q) / 2, 1.0])
        self._boot: List[float] = []                  # first 5 samples

    def observe(self, x: float) -> None:
        """Fold one observation into the sketch."""
        x = float(x)
        self.count += 1
        if self._heights is None:
            self._boot.append(x)
            if len(self._boot) == 5:
                self._heights = np.sort(np.asarray(self._boot))
                self._pos = np.arange(1.0, 6.0)
                q = self.q
                self._want = np.array([1.0, 1 + 2 * q, 1 + 4 * q,
                                       3 + 2 * q, 5.0])
            return
        h, n, want = self._heights, self._pos, self._want
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = int(np.searchsorted(h, x, side="right")) - 1
            k = min(max(k, 0), 3)
        n[k + 1:] += 1.0
        want += self._dwant
        for i in (1, 2, 3):
            d = want[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) or \
                    (d <= -1.0 and n[i - 1] - n[i] < -1.0):
                d = 1.0 if d > 0 else -1.0
                # piecewise-parabolic height prediction; fall back to
                # linear when it would leave the neighbor bracket
                hp = h[i] + d / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + d) * (h[i + 1] - h[i])
                    / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1])
                    / (n[i] - n[i - 1]))
                if not h[i - 1] < hp < h[i + 1]:
                    j = i + int(d)
                    hp = h[i] + d * (h[j] - h[i]) / (n[j] - n[i])
                h[i] = hp
                n[i] += d

    def value(self) -> float:
        """Current quantile estimate (exact for n ≤ 5; NaN when empty)."""
        if self.count == 0:
            return float("nan")
        if self._heights is None:
            return percentile(self._boot, 100.0 * self.q)
        return float(self._heights[2])


class Counter:
    """Monotonic event count."""

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (default 1)."""
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self):
        self.value = float("nan")

    def set(self, v: float) -> None:
        """Record the current level."""
        self.value = float(v)


#: default quantiles a histogram sketches
DEFAULT_QUANTILES = (0.5, 0.9, 0.95, 0.99)


class Histogram:
    """Streaming distribution summary: count/sum/min/max + P² quantiles."""

    def __init__(self, quantiles: Tuple[float, ...] = DEFAULT_QUANTILES):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.sketches = {q: P2Quantile(q) for q in quantiles}

    def observe(self, x: float) -> None:
        """Fold one sample into every sketch and the moment fields."""
        x = float(x)
        self.count += 1
        self.total += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        for sk in self.sketches.values():
            sk.observe(x)

    def quantile(self, q: float) -> float:
        """The sketched estimate for tracked quantile ``q``."""
        return self.sketches[q].value()

    def summary(self) -> Dict[str, float]:
        """count / mean / min / max plus one ``pXX`` key per quantile."""
        out = {
            "count": self.count,
            "mean": self.total / self.count if self.count else float("nan"),
            "min": self.min, "max": self.max,
        }
        for q, sk in self.sketches.items():
            out[f"p{round(q * 100):02d}"] = sk.value()
        return out


class MetricsRegistry:
    """Label-scoped instrument store shared by every runtime layer.

    Instruments are created on first touch and keyed by
    ``(name, sorted(labels))`` — lanes ask for
    ``histogram("request_latency_s", tenant="t03", slo_class="gold")``
    and get their own series. Re-requesting a name under a different
    instrument type raises.
    """

    def __init__(self):
        self._store: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}

    def _get(self, cls, name: str, labels: Dict[str, Any], **kw):
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        inst = self._store.get(key)
        if inst is None:
            inst = self._store[key] = cls(**kw)
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, requested {cls.__name__}")
        return inst

    def counter(self, name: str, **labels: Any) -> Counter:
        """The counter for ``(name, labels)`` (created on first touch)."""
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        """The gauge for ``(name, labels)`` (created on first touch)."""
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  quantiles: Tuple[float, ...] = DEFAULT_QUANTILES,
                  **labels: Any) -> Histogram:
        """The histogram for ``(name, labels)`` (created on first touch)."""
        return self._get(Histogram, name, labels, quantiles=quantiles)

    def collect(self) -> List[Dict[str, Any]]:
        """Every series as a flat row: name, labels, type, fields."""
        rows = []
        for (name, labels), inst in sorted(self._store.items()):
            row: Dict[str, Any] = {"name": name, "labels": dict(labels),
                                   "type": type(inst).__name__.lower()}
            if isinstance(inst, Histogram):
                row.update(inst.summary())
            else:
                row["value"] = inst.value
            rows.append(row)
        return rows
