"""Deterministic observability plane for the quorum-serving stack.

Three small, dependency-free layers that every runtime level shares:

- :mod:`repro.obs.trace` — per-request / controller / fleet spans on the
  engines' virtual clock, exportable to Chrome trace-format JSON
  (perfetto-loadable) and JSONL.
- :mod:`repro.obs.metrics` — counters / gauges / histograms with a P²
  streaming quantile sketch (fixed memory), scoped per tenant and SLO
  class.
- :mod:`repro.obs.stats` — the ONE percentile / latency-summary
  convention (`numpy` linear interpolation) the engine, fleet, simulator
  and benchmarks all share.
- :mod:`repro.obs.report` — offline trace analysis: per-request critical
  paths and the failure/repair timeline (CLI: ``scripts/trace_report.py``).

Instrumentation is nullable end to end: with no :class:`Tracer` attached
the runtime is bit-identical to an uninstrumented build (pinned by
``tests/test_obs.py``). See ``docs/observability.md``.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               P2Quantile)
from repro_torch.obs.stats import latency_summary, percentile, throughput
from repro_torch.obs.trace import (TraceEvent, Tracer, load_chrome, load_jsonl)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "P2Quantile",
    "latency_summary", "percentile", "throughput",
    "TraceEvent", "Tracer", "load_chrome", "load_jsonl",
]
