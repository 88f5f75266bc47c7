"""Deterministic span tracing on the serving stack's virtual clock.

A :class:`Tracer` records structured :class:`TraceEvent`\\ s — closed
spans and instants — stamped in *virtual seconds* (the same clock the
engines schedule on), so traces are bit-reproducible at fixed seeds and
tracing itself can never perturb a run: recording touches no RNG and
schedules nothing.

Tracks ("lanes") are hierarchical string names: ``req/17`` (one request's
life), ``t03/req/17`` (the same inside tenant ``t03``), ``controller``,
``batches``, ``server``, ``chaos``, ``fleet/router``, ``fleet/spares``,
``fleet/autoscale``. Span begin/end pairs are stack-disciplined *per
track* — ending a span that is not the top of its track's stack raises —
so spans on one track provably nest and never overlap. Spans carry two
global sequence numbers (``seq`` at begin, ``end_seq`` at end): an
instant with ``span.seq < instant.seq < span.end_seq`` was recorded
*inside* that span, which is how tests pin "repair spans bracket the
plan-epoch bump" without wall clocks.

Exports:

- :meth:`Tracer.dump_chrome` — Chrome trace-format JSON (the
  ``traceEvents`` array form). Load it in Perfetto (https://ui.perfetto.dev)
  or ``chrome://tracing``; virtual seconds are mapped to microseconds.
- :meth:`Tracer.dump_jsonl` — one JSON object per event, full fidelity.

Both round-trip through :func:`load_chrome` / :func:`load_jsonl`
(timestamps survive the µs conversion to ≤1e-9 s).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

#: Chrome trace-format phase codes used by this tracer.
SPAN, INSTANT = "X", "i"


def _jsonable(v: Any) -> Any:
    """Coerce attribute values to strict-JSON types (numpy scalars →
    python, sets/tuples → sorted/ordered lists, non-finite floats →
    strings — strict JSON has no Infinity/NaN literals)."""
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (set, frozenset)):
        return sorted(_jsonable(x) for x in v)
    if hasattr(v, "item"):                     # numpy scalar
        v = v.item()
    if isinstance(v, float) and not (v == v and abs(v) != float("inf")):
        return repr(v)                         # 'inf' / '-inf' / 'nan'
    return v


@dataclasses.dataclass
class TraceEvent:
    """One recorded event: a closed span (``phase == "X"``) or an instant.

    ``t``/``dur`` are virtual seconds; ``seq``/``end_seq`` are the global
    recording-order sequence numbers of the begin and end edges (equal
    for instants and for spans emitted via :meth:`Tracer.complete`).
    """

    phase: str
    name: str
    track: str
    t: float
    dur: float = 0.0
    seq: int = 0
    end_seq: int = 0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def t_end(self) -> float:
        """Span end time (``t`` for instants)."""
        return self.t + self.dur

    def contains(self, other: "TraceEvent") -> bool:
        """True when ``other`` was recorded inside this span's begin/end
        sequence window (the nesting certificate, time-tie safe)."""
        return self.seq < other.seq and other.end_seq < self.end_seq


class Tracer:
    """Append-only event recorder shared by every runtime layer.

    The engines refresh :attr:`now` (virtual seconds) at every event-loop
    pop, so clock-less components (``ClusterController``,
    ``QuorumServer``, ``SparePoolBroker``) can stamp events without
    holding a clock themselves. All recording APIs accept an explicit
    ``t`` override — spans whose end is already known (a batch's
    completion time) are closed in the future without bookkeeping.
    """

    def __init__(self):
        self.events: List[TraceEvent] = []
        #: virtual now — refreshed by the owning event loop at every pop
        self.now: float = 0.0
        self._open: Dict[str, List[TraceEvent]] = {}
        self._seq = 0

    # -- recording -----------------------------------------------------------

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def begin(self, name: str, track: str, t: Optional[float] = None,
              **attrs: Any) -> TraceEvent:
        """Open a span on ``track`` at ``t`` (default :attr:`now`); close
        it with :meth:`end`. Opens nest per track (stack discipline)."""
        ev = TraceEvent(SPAN, name, track, self.now if t is None else float(t),
                        float("nan"), self._next_seq(), 0, dict(attrs))
        self.events.append(ev)
        self._open.setdefault(track, []).append(ev)
        return ev

    def end(self, span: TraceEvent, t: Optional[float] = None,
            **attrs: Any) -> TraceEvent:
        """Close ``span`` at ``t`` (default :attr:`now`), merging
        ``attrs``. Raises if ``span`` is not the innermost open span of
        its track — the per-track nesting invariant is enforced at record
        time, not just checked after the fact."""
        stack = self._open.get(span.track)
        if not stack or stack[-1] is not span:
            raise RuntimeError(
                f"span {span.name!r} is not the innermost open span of "
                f"track {span.track!r} — spans on one track must nest")
        stack.pop()
        span.dur = (self.now if t is None else float(t)) - span.t
        span.end_seq = self._next_seq()
        span.attrs.update(attrs)
        return span

    def complete(self, name: str, track: str, t0: float, t1: float,
                 **attrs: Any) -> TraceEvent:
        """Record an already-closed span ``[t0, t1]`` in one call (no
        stack participation — both edges share one sequence number)."""
        s = self._next_seq()
        ev = TraceEvent(SPAN, name, track, float(t0), float(t1) - float(t0),
                        s, s, dict(attrs))
        self.events.append(ev)
        return ev

    def instant(self, name: str, track: str, t: Optional[float] = None,
                **attrs: Any) -> TraceEvent:
        """Record a zero-duration point event."""
        s = self._next_seq()
        ev = TraceEvent(INSTANT, name, track,
                        self.now if t is None else float(t), 0.0, s, s,
                        dict(attrs))
        self.events.append(ev)
        return ev

    # -- queries -------------------------------------------------------------

    def spans(self, name: Optional[str] = None,
              track: Optional[str] = None) -> List[TraceEvent]:
        """Closed spans, optionally filtered by name and/or track."""
        return [e for e in self.events if e.phase == SPAN
                and (name is None or e.name == name)
                and (track is None or e.track == track)]

    def instants(self, name: Optional[str] = None,
                 track: Optional[str] = None) -> List[TraceEvent]:
        """Instant events, optionally filtered by name and/or track."""
        return [e for e in self.events if e.phase == INSTANT
                and (name is None or e.name == name)
                and (track is None or e.track == track)]

    def open_spans(self) -> List[TraceEvent]:
        """Spans begun but never ended (should be empty after a clean
        run — every admitted request closes its root span)."""
        return [e for stack in self._open.values() for e in stack]

    # -- export --------------------------------------------------------------

    def to_chrome(self) -> Dict[str, Any]:
        """The trace as a Chrome trace-format ``traceEvents`` dict.

        Each track becomes one ``tid`` (named via ``thread_name``
        metadata) under a single ``pid``; virtual seconds map to the
        format's microseconds. Span sequence numbers ride along in
        ``args`` so :func:`load_chrome` round-trips them.
        """
        order: Dict[str, int] = {}
        for ev in self.events:
            order.setdefault(ev.track, len(order))
        out: List[Dict[str, Any]] = [
            {"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
             "args": {"name": track}} for track, tid in order.items()]
        for ev in self.events:
            rec: Dict[str, Any] = {
                "name": ev.name, "cat": "obs", "ph": ev.phase,
                "ts": ev.t * 1e6, "pid": 0, "tid": order[ev.track],
                "args": {**_jsonable(ev.attrs),
                         "seq": ev.seq, "end_seq": ev.end_seq}}
            if ev.phase == SPAN:
                dur = ev.dur * 1e6
                if dur != dur:                 # still-open span: NaN dur
                    dur, rec["args"]["open"] = 0.0, True
                rec["dur"] = dur
            else:
                rec["s"] = "t"
            out.append(rec)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def dump_chrome(self, path: str) -> None:
        """Write Chrome trace-format JSON (open with Perfetto)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, allow_nan=False)

    def dump_jsonl(self, path: str) -> None:
        """Write one full-fidelity JSON object per event."""
        with open(path, "w") as f:
            for ev in self.events:
                rec = dataclasses.asdict(ev)
                rec["attrs"] = _jsonable(rec["attrs"])
                if rec["dur"] != rec["dur"]:   # still-open span: NaN dur
                    rec["dur"], rec["attrs"]["open"] = 0.0, True
                f.write(json.dumps(rec, allow_nan=False) + "\n")


def load_chrome(path: str) -> List[TraceEvent]:
    """Load a Chrome trace-format file back into :class:`TraceEvent`\\ s
    (recording order; timestamps within 1e-9 s of the originals)."""
    with open(path) as f:
        data = json.load(f)
    names: Dict[int, str] = {}
    for rec in data["traceEvents"]:
        if rec.get("ph") == "M" and rec.get("name") == "thread_name":
            names[int(rec["tid"])] = rec["args"]["name"]
    events = []
    for rec in data["traceEvents"]:
        if rec.get("ph") not in (SPAN, INSTANT):
            continue
        args = dict(rec.get("args", {}))
        seq = int(args.pop("seq", 0))
        end_seq = int(args.pop("end_seq", seq))
        events.append(TraceEvent(
            rec["ph"], rec["name"], names.get(int(rec["tid"]), "?"),
            float(rec["ts"]) / 1e6, float(rec.get("dur", 0.0)) / 1e6,
            seq, end_seq, args))
    events.sort(key=lambda e: e.seq)
    return events


def load_jsonl(path: str) -> List[TraceEvent]:
    """Load a JSONL trace dump back into :class:`TraceEvent`\\ s."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(TraceEvent(**json.loads(line)))
    return events
