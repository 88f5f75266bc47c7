"""Offline trace analysis: per-request critical paths, repair timelines.

Consumes the :class:`~repro.obs.trace.TraceEvent` stream an instrumented
run recorded (or a trace file re-loaded via :func:`load_trace`) and
answers the question the raw report rows cannot: *why* did the p99
request take that long? Each completed request is decomposed into named,
non-overlapping segments that **sum exactly to its measured latency**:

- ``batch_wait`` — arrival → micro-batch dispatch (queueing + the SLO
  batch-close window),
- ``share_wait`` — dispatch → the last coded group's k-th share arrival
  (clipped to the service window; only for coded plans),
- ``service`` / ``merge_tail`` — the remainder to completion.

The failure/repair timeline interleaves chaos ticks, controller
observations, repair/re-encode/replan spans (with their plan-epoch
bumps), spare-pool claims and autoscale actions in virtual-time order.

``scripts/trace_report.py`` is the CLI wrapper; ``examples/
traced_serving.py`` prints the same analysis inline.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.stats import percentile
from repro_torch.obs.trace import TraceEvent, load_chrome, load_jsonl

#: controller span names that change the live plan (repair timeline rows)
REPAIR_KINDS = ("repair", "full_replan", "reencode", "noop",
                "scale_up", "scale_down", "scale")


def load_trace(path: str) -> List[TraceEvent]:
    """Load a trace file, sniffing the format from the first line: a
    Chrome dump is one JSON object carrying ``traceEvents``; a JSONL dump's
    first line is a complete per-event object."""
    import json
    with open(path) as f:
        head = f.readline()
    try:
        obj = json.loads(head)
        if isinstance(obj, dict) and "traceEvents" not in obj:
            return load_jsonl(path)
    except json.JSONDecodeError:
        pass                       # multi-line Chrome JSON
    return load_chrome(path)


@dataclasses.dataclass
class RequestPath:
    """One completed request's reconstructed critical path."""

    rid: int
    track: str                       # e.g. "t03/req/17"
    t_arrival: float
    t_done: float
    outcome: str                     # quorum_complete | degraded | shed
    segments: List[Tuple[str, float]]   # ordered; sums to latency

    @property
    def latency(self) -> float:
        """End-to-end virtual latency."""
        return self.t_done - self.t_arrival

    @property
    def tenant(self) -> str:
        """Tenant prefix of the track ('' for single-tenant runs)."""
        head, _, _ = self.track.partition("req/")
        return head.rstrip("/")


def request_paths(events: Sequence[TraceEvent],
                  include_shed: bool = False) -> List[RequestPath]:
    """Reconstruct every request's segment decomposition from its spans.

    Shed requests (zero-duration terminal ``shed`` span, no service) are
    excluded unless ``include_shed``.
    """
    by_track: Dict[str, List[TraceEvent]] = {}
    coded_end: Dict[str, float] = {}          # req track -> last k-th arrival
    for ev in events:
        if ev.phase != "X":
            continue
        if ev.name == "share_wait":
            head, _, _ = ev.track.partition("/coded")
            coded_end[head] = max(coded_end.get(head, -np.inf), ev.t_end)
        elif "req/" in ev.track:
            by_track.setdefault(ev.track, []).append(ev)
    out: List[RequestPath] = []
    for track, spans in by_track.items():
        root = next((s for s in spans if s.name == "request"), None)
        if root is None:
            continue
        outcome = str(root.attrs.get("outcome", "?"))
        if outcome == "shed" and not include_shed:
            continue
        segments: List[Tuple[str, float]] = []
        children = sorted((s for s in spans if s is not root
                           and s.name != "shed"), key=lambda s: (s.t, s.seq))
        for sp in children:
            if sp.name == "service" and track in coded_end:
                # split service at the last coded group's completion,
                # clipped to the service window so the pieces still sum
                t_k = min(max(coded_end[track], sp.t), sp.t_end)
                segments.append(("share_wait", t_k - sp.t))
                segments.append(("merge_tail", sp.t_end - t_k))
            else:
                segments.append((sp.name, sp.dur))
        out.append(RequestPath(
            rid=int(root.attrs.get("rid", -1)), track=track,
            t_arrival=root.t, t_done=root.t_end, outcome=outcome,
            segments=segments))
    out.sort(key=lambda p: (p.t_arrival, p.track))
    return out


@dataclasses.dataclass
class CriticalPath:
    """The request at (or nearest) a latency percentile, decomposed."""

    q: float
    target_latency: float            # the exact percentile of the run
    path: RequestPath                # the nearest real request
    n: int                           # completed requests considered

    def fractions(self) -> List[Tuple[str, float, float]]:
        """``(segment, seconds, share-of-latency)`` rows, largest first."""
        lat = max(self.path.latency, 1e-300)
        rows = [(name, dur, dur / lat) for name, dur in self.path.segments]
        rows.sort(key=lambda r: -r[1])
        return rows


def critical_path(events: Sequence[TraceEvent],
                  q: float = 99.0) -> Optional[CriticalPath]:
    """Decompose the request nearest the q-th latency percentile.

    The percentile itself is the run's exact linear-interpolation value
    (:func:`repro.obs.stats.percentile`); the decomposition belongs to
    the real request whose latency is closest to it, so the segments sum
    to a latency that was actually measured.
    """
    paths = request_paths(events)
    if not paths:
        return None
    lats = np.asarray([p.latency for p in paths])
    target = percentile(lats, q)
    pick = paths[int(np.argmin(np.abs(lats - target)))]
    return CriticalPath(q=q, target_latency=target, path=pick, n=len(paths))


def failure_timeline(events: Sequence[TraceEvent]
                     ) -> List[Tuple[float, str, str, str]]:
    """``(t, track, what, detail)`` rows for every chaos / repair /
    spare-pool / autoscale event, in virtual-time order."""
    rows: List[Tuple[int, float, str, str, str]] = []
    for ev in events:
        on_ctl = ev.track.endswith("controller")
        if ev.name == "chaos_tick":
            rows.append((ev.seq, ev.t, ev.track, "chaos_tick",
                         f"down={ev.attrs.get('down', [])}"))
        elif ev.name == "failure_observed":
            rows.append((ev.seq, ev.t, ev.track, "failure_observed",
                         f"down={ev.attrs.get('down', [])}"))
        elif on_ctl and ev.name in REPAIR_KINDS and ev.phase == "X":
            rows.append((ev.seq, ev.t, ev.track, ev.name,
                         f"moved={ev.attrs.get('moved', [])} "
                         f"feasible={ev.attrs.get('feasible')} "
                         f"epoch={ev.attrs.get('epoch', '?')}"))
        elif ev.name in ("spare_claim", "spare_free"):
            rows.append((ev.seq, ev.t, ev.track, ev.name,
                         f"device={ev.attrs.get('device')} "
                         f"tenant={ev.attrs.get('tenant')}"))
        elif ev.name in ("scale_up", "scale_down") and not on_ctl:
            rows.append((ev.seq, ev.t, ev.track, ev.name,
                         f"tenant={ev.attrs.get('tenant')} "
                         f"device={ev.attrs.get('device')}"))
    rows.sort(key=lambda r: (r[1], r[0]))
    return [(t, track, what, detail) for _, t, track, what, detail in rows]


# -- text rendering ----------------------------------------------------------

def format_critical_path(cp: CriticalPath) -> str:
    """Human-readable critical-path block for one percentile."""
    p = cp.path
    lines = [
        f"p{cp.q:g} critical path — request {p.rid}"
        + (f" (tenant {p.tenant})" if p.tenant else "")
        + f": latency {p.latency * 1e3:.3f} ms"
        f" (run p{cp.q:g} = {cp.target_latency * 1e3:.3f} ms, "
        f"n = {cp.n}, outcome = {p.outcome})"]
    for name, dur, frac in cp.fractions():
        lines.append(f"  {frac * 100:5.1f}%  {dur * 1e3:9.3f} ms  {name}")
    return "\n".join(lines)


def format_timeline(rows: Sequence[Tuple[float, str, str, str]],
                    limit: Optional[int] = None) -> str:
    """Human-readable failure/repair timeline table."""
    if not rows:
        return "failure/repair timeline: (no events)"
    shown = rows if limit is None else rows[:limit]
    lines = ["failure/repair timeline:"]
    for t, track, what, detail in shown:
        lines.append(f"  t={t * 1e3:9.3f} ms  {track:<24s} "
                     f"{what:<16s} {detail}")
    if limit is not None and len(rows) > limit:
        lines.append(f"  … {len(rows) - limit} more rows")
    return "\n".join(lines)


def render_report(events: Sequence[TraceEvent], q: float = 99.0,
                  timeline_limit: Optional[int] = 30) -> str:
    """The full offline report: critical path + failure/repair timeline."""
    parts = []
    cp = critical_path(events, q)
    parts.append(format_critical_path(cp) if cp is not None
                 else "no completed requests in trace")
    parts.append(format_timeline(failure_timeline(events), timeline_limit))
    return "\n\n".join(parts)
