"""Failure injection + elastic re-planning helpers.

`FailureInjector` drives chaos-testing of the serving loop (crash devices on
a schedule, flap links). `replan` rebuilds the RoCoIn plan on the surviving
fleet and remaps existing distilled students to partitions — placement-only
recovery, no re-training (weights are content-addressed by partition)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import planner as PL
from repro_torch.core.assignment import StudentArch
from repro_torch.core.grouping import Device


@dataclasses.dataclass
class FailureEvent:
    """One scheduled chaos action: crash or recover ``device`` at a request."""

    at_request: int
    device: str
    kind: str = "crash"           # crash | recover


@dataclasses.dataclass
class FailureInjector:
    """Replays a ``FailureEvent`` schedule, tracking the down-device set."""

    events: List[FailureEvent]
    _down: set = dataclasses.field(default_factory=set)
    _count: int = 0

    def tick(self) -> set:
        """Advance one request; returns the set of currently-down devices."""
        for e in self.events:
            if e.at_request == self._count:
                if e.kind == "crash":
                    self._down.add(e.device)
                else:
                    self._down.discard(e.device)
        self._count += 1
        return set(self._down)

    def alive_matrix(self, names: Sequence[str], ticks: int,
                     start: int = 0) -> np.ndarray:
        """Replay the schedule for ticks [start, start+ticks) at once:
        (ticks, len(names)) bool, True while the device is up. O(#events)
        fills instead of O(ticks·devices) scanning — the vectorized
        simulator's view of a chaos script. Devices already down at the
        window start (an event at_request ≤ start) start down."""
        col = {n: i for i, n in enumerate(names)}
        # only the requested window is allocated: events at or before `start`
        # collapse into the initial per-device state instead of materializing
        # the O(start) prefix that used to be filled and thrown away
        init = np.ones(len(names), bool)
        window: List[Tuple[int, int, bool]] = []
        for e in sorted(self.events, key=lambda e: e.at_request):
            if e.device not in col:
                continue
            up = e.kind != "crash"
            if e.at_request <= start:
                init[col[e.device]] = up       # latest pre-window event wins
            elif e.at_request < start + ticks:
                window.append((e.at_request - start, col[e.device], up))
        alive = np.broadcast_to(init, (ticks, len(names))).copy()
        for first, j, up in window:
            alive[first:, j] = up
        return alive

    def advance(self, n: int) -> None:
        """Consume `n` ticks without querying them (applies any events in the
        window so a later tick() continues from consistent state)."""
        for e in self.events:
            if self._count <= e.at_request < self._count + n:
                if e.kind == "crash":
                    self._down.add(e.device)
                else:
                    self._down.discard(e.device)
        self._count += n


def markov_flap_schedule(names: Sequence[str], p_fail: float,
                         p_recover: float, ticks: int,
                         rng: np.random.Generator) -> List[FailureEvent]:
    """Sample a Gilbert two-state link chain per device (up → down w.p.
    `p_fail`, down → up w.p. `p_recover`, all links start up) and emit the
    transitions as a FailureEvent schedule. The loop is over ticks only —
    every device's transition draw at a tick is one vectorized RNG call."""
    n = len(names)
    up = np.ones(n, bool)
    events: List[FailureEvent] = []
    u = rng.random((ticks, n))
    for t in range(ticks):
        go_down = up & (u[t] < p_fail)
        go_up = ~up & (u[t] < p_recover)
        for i in np.flatnonzero(go_down):
            events.append(FailureEvent(t, names[i], "crash"))
        for i in np.flatnonzero(go_up):
            events.append(FailureEvent(t, names[i], "recover"))
        up = (up & ~go_down) | go_up
    return events


def replan(devices: Sequence[Device], A: np.ndarray,
           students: Sequence[StudentArch], *, d_th: Optional[float],
           p_th: float, seed: int = 0) -> PL.Plan:
    """Elastic re-plan on the surviving fleet (same Algorithm 1)."""
    if d_th is None:
        return PL.tune_d_th(devices, A, students, p_th=p_th, seed=seed)
    return PL.make_plan(devices, A, students, d_th=d_th, p_th=p_th, seed=seed)


def _filter_sets(plan) -> List[set]:
    """Per-slot filter index sets for a legacy Plan or a canonical PlanIR."""
    from repro_torch.core.plan_ir import PlanIR
    if isinstance(plan, PlanIR):
        return [set(np.flatnonzero(row).tolist()) for row in plan.partition]
    return [set(np.asarray(g.filters).tolist()) for g in plan.groups]


def remap_students(old_plan, new_plan) -> Dict[int, int]:
    """Map new partition slots → old partition slots by maximum filter-set
    overlap, so already-distilled students redeploy without retraining.

    The matching is ONE-TO-ONE via the Hungarian algorithm on the overlap
    matrix — the previous greedy argmax could deploy the same old student to
    several new slots, silently dropping distilled knowledge. Accepts legacy
    ``Plan`` or ``PlanIR`` on either side. When there are more new slots
    than old students a perfect matching is impossible; the surplus slots
    fall back to their best-overlap old student (documented duplication)."""
    from repro_torch.core.assignment import hungarian
    new_sets = _filter_sets(new_plan)
    old_sets = _filter_sets(old_plan)
    Kn, Ko = len(new_sets), len(old_sets)
    if Kn == 0:
        return {}
    if Ko == 0:
        return {ni: 0 for ni in range(Kn)}
    O = np.zeros((Kn, Ko))
    for ni, ns in enumerate(new_sets):
        for oi, os_ in enumerate(old_sets):
            O[ni, oi] = len(ns & os_)
    n = max(Kn, Ko)
    W = np.zeros((n, n))
    W[:Kn, :Ko] = O
    cols = hungarian(W)
    mapping = {}
    for ni in range(Kn):
        oi = int(cols[ni])
        mapping[ni] = oi if oi < Ko else int(np.argmax(O[ni]))
    return mapping
