"""Virtual-clock scheduler primitives shared by the serving stack.

The continuous-batching :class:`~repro.runtime.engine.ServingEngine` (PR 3)
grew a deterministic event loop — a heap of ``(time, sequence, kind,
payload)`` entries plus an arm-once batch-window close timer — and the
multi-tenant :mod:`repro.runtime.fleet` router needs the identical
machinery. This module is that machinery, extracted so router and engine
share ONE scheduler implementation instead of a copy:

- :class:`EventQueue` — the deterministic event heap. Entries pop in
  ``(time, push order)`` order; the monotone push sequence breaks time
  ties, so a replay that performs the same pushes performs the same pops,
  bit for bit. Event *kinds* are plain caller-owned ints — the queue
  imposes no vocabulary.
- :class:`CloseTimer` — the batch-window close timer with the engine's
  arm-once semantics: re-arm only for a strictly earlier deadline (or
  after the armed one fired), so a waiting queue head never floods the
  heap with redundant close events.
- :func:`periodic_ticks` — chaos/autoscale tick times computed by index
  (``i · every``), not by accumulation: summing float steps can overshoot
  the horizon by an ulp and drop the final tick.

Everything here is pure bookkeeping on virtual seconds — no wall clock, no
RNG — which is what makes engine runs replayable and the fixed-seed
bit-identity tests (``tests/test_clock.py``) meaningful.
"""
from __future__ import annotations

import heapq
from typing import Any, List, Tuple

import numpy as np

# the scheduler's time-comparison slack: timers and due-checks treat two
# virtual instants closer than this as simultaneous (one ulp of drift from
# float arrival arithmetic must not reorder events)
EPS = 1e-12


class EventQueue:
    """Deterministic virtual-clock event heap.

    Entries are ``(t, seq, kind, payload)`` with ``seq`` a monotone push
    counter, so ties in ``t`` resolve in push order — the property every
    fixed-seed replay in the serving stack relies on. ``kind`` is an int
    owned by the caller (the engine and the fleet router each define their
    own vocabularies); ``payload`` is opaque.
    """

    def __init__(self) -> None:
        self._heap: List[Tuple[float, int, int, Any]] = []
        self._seq = 0

    def push(self, t: float, kind: int, payload: Any = -1) -> None:
        """Schedule ``(kind, payload)`` at virtual time ``t``."""
        heapq.heappush(self._heap, (t, self._seq, kind, payload))
        self._seq += 1

    def pop(self) -> Tuple[float, int, Any]:
        """Remove and return the earliest ``(t, kind, payload)`` entry."""
        t, _, kind, payload = heapq.heappop(self._heap)
        return t, kind, payload

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class CloseTimer:
    """Arm-once batch-window close timer on an :class:`EventQueue`.

    The scheduling loop arms a close event while the queue head still needs
    to wait out its ``max_wait`` window. Re-arming every loop iteration
    would flood the heap, so the timer remembers the soonest armed deadline
    and pushes a new event only when asked for a strictly earlier one — or
    when the armed one already fired (``at <= now``) and a fresh window
    needs covering. :meth:`fired` is called when the timer's event pops:
    it clears the armed deadline only if that pop IS the live timer
    (earlier superseded events are ignored stale pops).
    """

    def __init__(self, queue: EventQueue, kind: int, payload: Any = -1):
        self._queue = queue
        self._kind = kind
        self._payload = payload
        self._at = float("inf")

    @property
    def armed_at(self) -> float:
        """The live armed deadline (``inf`` when unarmed)."""
        return self._at

    def arm(self, close_at: float, now: float) -> None:
        """Arm a close event at ``close_at``, unless one at least as early
        is already pending."""
        if close_at < self._at - EPS or self._at <= now:
            self._at = close_at
            self._queue.push(close_at, self._kind, self._payload)

    def fired(self, now: float) -> None:
        """Consume a popped close event at virtual time ``now``."""
        if self._at <= now + EPS:
            self._at = float("inf")


def periodic_ticks(every: float, t_end: float) -> np.ndarray:
    """Tick times ``every, 2·every, … ≤ t_end`` computed by index, not by
    accumulation — summing float steps can overshoot ``t_end`` by an ulp
    and drop the final tick. Empty for a non-positive cadence/horizon."""
    if every <= 0 or t_end <= 0:
        return np.zeros(0, np.float64)
    n_ticks = int(np.floor(t_end / every + 1e-9))
    return np.arange(1, n_ticks + 1, dtype=np.float64) * every
