"""Asynchronous continuous-batching serving engine (RoCoIn Fig. 1, §V).

The :class:`QuorumServer` serves whoever calls it, one batch at a time; this
module wraps it in the always-on engine the runtime phase needs under real
traffic. An open-loop request queue (Poisson or MMPP-bursty arrivals from
:mod:`repro.core.scenarios`, heterogeneous request sizes) feeds a scheduler
that forms micro-batches under a latency-SLO budget — a batch closes when it
reaches ``max_batch`` requests or when its oldest request has waited
``max_wait`` seconds, whichever comes first — and dispatches each batch
through the existing one-forward-per-partition
:meth:`QuorumServer.serve_batch` path.

Chaos stays live while traffic flows: injector ticks are delivered to the
:class:`~repro.runtime.controller.ClusterController` through its
non-blocking ``observe_deferred`` hook, and repairs are applied via
``poll()`` between dispatches. The migration handoff is re-entrant — an
in-flight batch finishes on the portions it was dispatched with,
queued requests pick up the migrated plan (each request records the
``plan_epoch`` it was served under).

Time is a virtual clock driven by an event heap (the shared scheduler
primitives in :mod:`repro.runtime.clock` — the multi-tenant fleet router
runs on the same ones), so runs are deterministic and arrival processes
can be replayed exactly. The service time of a batch
is either the *measured wall-clock* of its ``serve_batch`` call (the real
systems number — host work, kernel launches and device time
included) or a deterministic ``service_model`` ``(alpha, beta)`` →
``alpha + beta · rows`` for reproducible tests. Every micro-batch draws its
failures from its own spawned RNG stream keyed by batch id, so outcomes are
independent of how chaos ticks interleave with dispatches.

Batches are padded to power-of-two row counts (one throwaway filler
request), so the portion forwards see O(log max_rows) distinct shapes.

This module is the JAX package's engine, unchanged but for its imports and
the torch twin of :func:`build_demo_server`: it drives the port's
:class:`~repro_torch.runtime.serving.QuorumServer`, so the same arrival
trace, seed and failure model give the same records in both packages.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.simulator import FailureModel
from repro_torch.obs.stats import percentile, throughput
from repro_torch.runtime.clock import EPS, CloseTimer, EventQueue, periodic_ticks
from repro_torch.runtime.serving import QuorumServer

# event-kind vocabulary of the engine's virtual-clock loop (heap entries
# are managed by repro.runtime.clock.EventQueue; ties resolve in push
# order, so replays are exact)
ARRIVE, CLOSE, DONE, CHAOS, SHARE = 0, 1, 2, 3, 4


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RequestRecord:
    """One request's life through the engine (virtual seconds)."""
    rid: int
    t_arrival: float
    size: int                       # rows
    t_dispatch: float = float("inf")
    t_done: float = float("inf")
    batch_id: int = -1
    plan_epoch: int = 0             # migrations applied before its dispatch
    quorum_ok: bool = False         # every partition arrived
    degraded: bool = False
    served_latency: float = float("nan")   # Eq. 1a quorum latency
    rejected: bool = False          # shed by SLO admission control

    @property
    def latency(self) -> float:
        """End-to-end: queue wait + batching wait + service."""
        return self.t_done - self.t_arrival


@dataclasses.dataclass
class BatchRecord:
    """One dispatched micro-batch (virtual seconds)."""

    bid: int
    t_dispatch: float
    t_done: float
    n_requests: int
    rows: int
    plan_epoch: int
    service_s: float


@dataclasses.dataclass
class ShareFuture:
    """One coded group's partial-result future for one request.

    A coded dispatch (output- or compute-coded) fans a group out as ``n``
    share computations; the answer completes on the k-th share ARRIVAL and
    the remaining in-flight shares are cancelled. The engine materializes
    that as per-share events on the virtual clock: the future completes at
    the k-th pop (``t_complete``), later pops count as ``cancelled``.
    Shares that never arrive (dead devices / past deadline) are neither —
    they were lost, not cancelled.
    """

    rid: int                        # owning request
    group: int                      # ShareLayout group index
    k: int                          # shares needed
    n: int                          # shares dispatched
    t_issue: float                  # dispatch time of the owning batch
    t_complete: float = float("inf")   # k-th share arrival (virtual s)
    arrived: int = 0                # share arrivals consumed (≤ k)
    cancelled: int = 0              # in-flight shares cancelled after k-th

    @property
    def recovery_latency(self) -> float:
        """Virtual seconds from dispatch to the k-th share arrival."""
        return self.t_complete - self.t_issue


@dataclasses.dataclass
class EngineReport:
    """Everything a finished :meth:`ServingEngine.run` measured."""

    records: List[RequestRecord]
    batches: List[BatchRecord]
    migrations: List[Tuple[float, Any]]    # (virtual t, RepairOutcome)
    slo: float
    futures: List[ShareFuture] = dataclasses.field(default_factory=list)

    def latencies(self) -> np.ndarray:
        """End-to-end latencies of every completed request."""
        return np.asarray([r.latency for r in self.records
                           if np.isfinite(r.t_done)])

    def summary(self) -> Dict[str, float]:
        """Aggregate run metrics (throughput, tail latency, quorum rates)."""
        lats = self.latencies()
        done = [r for r in self.records if np.isfinite(r.t_done)]
        cancelled = int(sum(f.cancelled for f in self.futures))
        rejected = int(sum(r.rejected for r in self.records))
        if not done:
            return {"n": 0, "throughput": 0.0, "p50": float("inf"),
                    "p99": float("inf"), "slo_attainment": 0.0,
                    "quorum_rate": 0.0, "degraded_rate": 0.0,
                    "mean_batch": 0.0,
                    "migrations": len(self.migrations),
                    "share_futures": len(self.futures),
                    "cancelled_shares": cancelled,
                    "admitted": 0, "rejected": rejected}
        t0 = min(r.t_arrival for r in done)
        t1 = max(r.t_done for r in done)
        return {
            "n": len(done),
            "throughput": throughput(len(done), t0, t1),
            "p50": percentile(lats, 50),
            "p99": percentile(lats, 99),
            "slo_attainment": float(np.mean(lats <= self.slo)),
            "quorum_rate": float(np.mean([r.quorum_ok for r in done])),
            # fraction of answers served with any zeroed portion (missed
            # quorum or a migration knowledge gap) — the accuracy-risk dial
            # ServeResult.coverage quantifies per request
            "degraded_rate": float(np.mean([r.degraded for r in done])),
            "mean_batch": float(np.mean([b.n_requests for b in self.batches]))
            if self.batches else 0.0,
            "migrations": len(self.migrations),
            # coded dispatch accounting: fan-out futures issued and the
            # in-flight shares the first-k completions cancelled
            "share_futures": len(self.futures),
            "cancelled_shares": cancelled,
            # SLO admission control accounting (rejected requests never
            # dispatch, so they are disjoint from ``done``)
            "admitted": len(done),
            "rejected": rejected,
        }


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EngineConfig:
    """Continuous-batching engine knobs (batch window, SLO, service model)."""

    max_batch: int = 16             # batch closes when this many requests …
    max_wait: float = 0.02          # … or when the oldest waited this long
    slo: float = 0.5                # end-to-end latency SLO (virtual s)
    # concurrent in-flight micro-batches. With measured-wall service times
    # (service_model=None) the serve_batch calls still execute serially in
    # real time, so depth > 1 models idealized zero-contention parallel
    # hardware — use a deterministic service_model for honest overlap.
    pipeline_depth: int = 1
    chaos_every: Optional[float] = None   # injector tick cadence (virtual s)
    # (alpha, beta): service = alpha + beta · rows. None → measured wall time
    service_model: Optional[Tuple[float, float]] = None
    input_dim: int = 32             # request feature width
    # pad batches to power-of-two row counts: bounds the distinct shapes
    # the forwards see to O(log max_rows). With bucket_rows=False warmup
    # covers only the individual request sizes, so unseen row TOTALS pay
    # their first-call costs inside timed dispatches — disable bucketing
    # only with a deterministic service_model.
    bucket_rows: bool = True
    warmup: bool = True             # first calls before timing (wall mode)
    # SLO admission control: at batch formation, shed any queued request
    # whose wait so far plus the plan's predicted quorum latency
    # (``server.ir.objective()`` — the measured model when the plan carries
    # fitted DeviceSpecs) already exceeds the SLO, instead of serving a
    # guaranteed miss
    admission: bool = False
    seed: int = 0


def _serial_config(cfg: EngineConfig) -> EngineConfig:
    """The per-request ``serve()`` baseline: batch of one, no batching wait."""
    return dataclasses.replace(cfg, max_batch=1, max_wait=0.0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class ServingEngine:
    """Continuous-batching front end for a :class:`QuorumServer`.

    Parameters
    ----------
    server:     the live quorum server (its plan may migrate mid-run).
    config:     :class:`EngineConfig`.
    controller: optional ``ClusterController`` — chaos ticks flow through
                its non-blocking ``observe_deferred`` hook and repairs are
                applied via ``poll()`` between dispatches.
    injector:   optional ``FailureInjector`` driving chaos ticks; defaults
                to ``controller.injector``.
    failure_for: maps the current down-set to the failure model requests are
                sampled under at dispatch (default: forced failures, no
                stochastic outages).
    make_input: ``(rng, rows) -> array`` request payload factory (numpy
                or a tensor)
                (default: cached standard-normal ``(rows, input_dim)``).
    tracer:     optional :class:`repro.obs.trace.Tracer`. When attached
                (here or any time before :meth:`run`), the engine records
                per-request spans (arrival → batch_wait → dispatch →
                service → quorum_complete/degraded, terminal ``shed`` on
                admission rejection), batch spans, chaos instants and —
                through the wired controller/server — repair and migrate
                events, all on the virtual clock. ``None`` (default) is
                the zero-overhead path: runs are bit-identical to an
                uninstrumented build.
    metrics:    optional :class:`repro.obs.metrics.MetricsRegistry`;
                latency/share histograms and admission counters land
                under :attr:`metric_labels` (fleet lanes set tenant +
                SLO-class labels).
    """

    def __init__(self, server: QuorumServer,
                 config: Optional[EngineConfig] = None, *,
                 controller=None, injector=None,
                 failure_for: Optional[Callable[[Set[str]], Any]] = None,
                 make_input: Optional[Callable[[np.random.Generator, int],
                                               Any]] = None,
                 tracer=None, metrics=None):
        self.server = server
        self.cfg = config or EngineConfig()
        self.controller = controller
        self.injector = injector if injector is not None else (
            getattr(controller, "injector", None))
        self._custom_failure = failure_for is not None
        self._failure_for = failure_for or (lambda down: FailureModel(
            forced_failures=sorted(down), outages=False))
        self._make_input = make_input
        self._down: Set[str] = set()
        self._xcache: Dict[int, Any] = {}
        self._input_rng = np.random.default_rng(self.cfg.seed + 1)
        self.plan_epoch = 0
        self.migrations: List[Tuple[float, Any]] = []
        self.futures: List[ShareFuture] = []
        self.tracer = tracer
        self.metrics = metrics
        self.trace_name = ""            # track prefix, e.g. "t03/" in fleets
        self.metric_labels: Dict[str, str] = {}
        self._req_spans: Dict[int, Tuple[Any, Any]] = {}

    # -- observability -------------------------------------------------------

    def _wire_tracer(self) -> None:
        """Propagate the obs plane to the controller and server so repair
        and migrate events land on the same trace under this engine's
        track prefix. Idempotent; a ``None`` tracer un-wires."""
        if self.controller is not None:
            self.controller.tracer = self.tracer
            self.controller.trace_name = self.trace_name
        self.server.tracer = self.tracer
        self.server.trace_name = self.trace_name

    def _trace_arrival(self, r: RequestRecord, now: float) -> None:
        """Open the request's root span and its batch-wait child."""
        track = f"{self.trace_name}req/{r.rid}"
        root = self.tracer.begin("request", track, t=now, rid=r.rid,
                                 size=r.size)
        wait = self.tracer.begin("batch_wait", track, t=now)
        self._req_spans[r.rid] = (root, wait)

    def _shed(self, r: RequestRecord, now: float) -> None:
        """SLO admission rejection: mark the record and close the
        request's spans with a terminal zero-duration ``shed`` span.
        Shared by the engine's admission closure and the fleet lanes."""
        r.rejected = True
        tr = self.tracer
        if tr is not None:
            spans = self._req_spans.pop(r.rid, None)
            if spans is not None:
                root, wait = spans
                tr.end(wait, t=now, outcome="shed")
                tr.complete("shed", root.track, now, now, rid=r.rid)
                tr.end(root, t=now, outcome="shed")
        if self.metrics is not None:
            self.metrics.counter("requests_shed", **self.metric_labels).inc()

    def _trace_dispatch(self, now: float, reqs: List[RequestRecord],
                        bid: int, done_t: float, rows: int,
                        service: float) -> None:
        """Close every dispatched request's batch-wait, record its service
        span and terminal outcome, and record the batch span itself."""
        tr = self.tracer
        tr.complete("batch", f"{self.trace_name}batches", now, done_t,
                    bid=bid, n_requests=len(reqs), rows=rows,
                    plan_epoch=self.plan_epoch, service_s=service)
        for r in reqs:
            spans = self._req_spans.pop(r.rid, None)
            if spans is None:
                continue
            root, wait = spans
            outcome = "quorum_complete" if r.quorum_ok else "degraded"
            tr.end(wait, t=now, batch=bid)
            tr.complete("service", root.track, now, done_t, batch=bid,
                        plan_epoch=r.plan_epoch)
            tr.instant(outcome, root.track, t=done_t)
            tr.end(root, t=done_t, outcome=outcome,
                   quorum_ok=r.quorum_ok, degraded=r.degraded,
                   batch=bid, plan_epoch=r.plan_epoch)

    def _record_metrics(self, reqs: List[RequestRecord]) -> None:
        """Fold one dispatched batch into the latency/quorum metrics."""
        m = self.metrics
        lab = self.metric_labels
        h = m.histogram("request_latency_s", **lab)
        for r in reqs:
            h.observe(r.latency)
        m.counter("requests_served", **lab).inc(len(reqs))
        m.counter("requests_degraded", **lab).inc(
            sum(1 for r in reqs if r.degraded))

    # -- request payloads ----------------------------------------------------

    def _input(self, rows: int):
        if rows not in self._xcache:
            if self._make_input is not None:
                self._xcache[rows] = self._make_input(self._input_rng, rows)
            else:
                # cached as numpy: serve_batch moves the stacked rows to
                # the server's device
                self._xcache[rows] = self._input_rng.standard_normal(
                    (rows, self.cfg.input_dim)).astype(np.float32)
        return self._xcache[rows]

    def _batch_rng(self, bid: int) -> np.random.Generator:
        """Per-batch spawned stream, keyed by batch id (not spawn order), so
        failure draws are reproducible under any event interleaving."""
        return np.random.default_rng(
            np.random.SeedSequence(entropy=self.cfg.seed, spawn_key=(bid,)))

    # -- dispatch ------------------------------------------------------------

    def _apply_control(self, now: float) -> None:
        """Between-dispatch control point: apply pending repairs (the
        non-blocking half of the chaos loop) and refresh the failure model
        to the current down-set. Without a chaos source (controller or
        injector) or an explicit ``failure_for``, the server's own failure
        model is left untouched."""
        if self.controller is not None:
            out = self.controller.poll()
            if out is not None:
                self.migrations.append((now, out))
                self.plan_epoch += 1
            down = set(self.controller.down)
        else:
            down = set(self._down)
        if (self.controller is not None or self.injector is not None
                or self._custom_failure):
            self.server.failure = self._failure_for(down)

    def _dispatch(self, now: float, reqs: List[RequestRecord], bid: int
                  ) -> Tuple[float, BatchRecord, List[Tuple[float, int]]]:
        """Serve one micro-batch at virtual time ``now``.

        Returns the batch completion time, its record, and — for coded
        plans — the ``(arrival_time, future_index)`` share events to put on
        the virtual clock (one per in-flight share of every fan-out future
        issued for this batch's requests)."""
        self._apply_control(now)
        xs = [self._input(r.size) for r in reqs]
        rows = sum(r.size for r in reqs)
        pad_rows = 0
        if self.cfg.bucket_rows and rows:
            bucket = 1 << (rows - 1).bit_length()
            pad_rows = bucket - rows
            if pad_rows:
                xs = xs + [self._input(pad_rows)]   # filler request, dropped
        t0 = time.perf_counter()
        results = self.server.serve_batch(xs, rng=self._batch_rng(bid))
        if self.cfg.service_model is None and results:
            # serve_batch returns without waiting for the device (the
            # logits sync is deferred to ServeResult access). In
            # measured-wall mode the device time IS the service time, so
            # block inside the timed region; in modelled mode skip the
            # sync — the next micro-batch overlaps the in-flight one
            results[0].block_until_ready()
        wall = time.perf_counter() - t0
        if self.cfg.service_model is not None:
            alpha, beta = self.cfg.service_model
            service = alpha + beta * rows
        else:
            service = wall
        done_t = now + service
        share_events: List[Tuple[float, int]] = []
        layout = None
        for r, res in zip(reqs, results):        # filler result falls off
            r.t_dispatch = now
            r.t_done = done_t
            r.batch_id = bid
            r.plan_epoch = self.plan_epoch
            # a complete answer needs every portion to arrive AND carry real
            # weights — a migration-zeroed slot arriving with a zero FC
            # slice is a degraded answer, not a quorum-complete one
            r.quorum_ok = bool(res.arrived.all()) and not res.degraded
            r.degraded = bool(res.degraded)
            r.served_latency = float(res.latency)
            st = getattr(res, "share_times", None)
            if st is None:
                continue                      # replicate-only: no fan-out
            if layout is None:
                layout = self.server.arrays.layout
            # one partial-result future per coded group: the request's
            # answer for that group completes at the k-th share ARRIVAL.
            # Groups that cannot complete (fewer than k shares in flight)
            # issue no future — the simulator already scored them failed
            for c in range(len(layout.group_shares)):
                t_sh = st[layout.group_shares[c]]
                finite = np.isfinite(t_sh)
                k = int(layout.group_k[c])
                if int(finite.sum()) < k:
                    continue
                idx = len(self.futures)
                self.futures.append(ShareFuture(
                    rid=r.rid, group=c, k=k, n=int(t_sh.shape[0]),
                    t_issue=now))
                share_events.extend(
                    (now + float(t), idx) for t in t_sh[finite])
        batch = BatchRecord(bid, now, done_t, len(reqs), rows,
                            self.plan_epoch, service)
        if self.tracer is not None:
            self._trace_dispatch(now, reqs, bid, done_t, rows, service)
        if self.metrics is not None:
            self._record_metrics(reqs)
        return done_t, batch, share_events

    def _share_event(self, fut_idx: int, now: float) -> None:
        """One coded share's arrival on the virtual clock — the
        cancel-on-first-k bookkeeping shared verbatim by the engine loop
        and the fleet loop: the k-th pop completes the future (and closes
        its ``share_wait`` span), later pops count as cancelled."""
        fut = self.futures[fut_idx]
        if fut.arrived < fut.k:
            fut.arrived += 1
            if fut.arrived == fut.k:
                fut.t_complete = now
                if self.tracer is not None:
                    self.tracer.complete(
                        "share_wait",
                        f"{self.trace_name}req/{fut.rid}/coded/g{fut.group}",
                        fut.t_issue, now, rid=fut.rid, group=fut.group,
                        k=fut.k, n=fut.n)
                if self.metrics is not None:
                    self.metrics.histogram(
                        "share_recovery_s", **self.metric_labels).observe(
                        fut.recovery_latency)
        else:
            fut.cancelled += 1

    # -- event loop ----------------------------------------------------------

    def run(self, times: Sequence[float],
            sizes: Optional[Sequence[int]] = None) -> EngineReport:
        """Serve an open-loop arrival trace to completion (drains the queue
        after the last arrival) and return the full report. Per-run metrics
        (plan epochs, applied migrations) reset at entry, and the server's
        own failure model is restored on exit — the chaos-driven forced
        -failure models the engine installs are borrowed state."""
        self.plan_epoch = 0
        self.migrations = []
        self.futures = []
        self._down = set()          # each run re-derives its own chaos state
        self._req_spans = {}
        self._wire_tracer()
        saved_failure = self.server.failure
        try:
            return self._run(times, sizes)
        finally:
            self.server.failure = saved_failure

    def _run(self, times, sizes) -> EngineReport:
        times = np.asarray(times, np.float64)
        if sizes is None:
            sizes = np.ones(len(times), np.int64)
        sizes = np.asarray(sizes, np.int64)
        records = [RequestRecord(i, float(times[i]), int(sizes[i]))
                   for i in range(len(times))]
        if self.cfg.warmup and self.cfg.service_model is None and records:
            self._warmup(sizes)

        events = EventQueue()
        for r in records:
            events.push(r.t_arrival, ARRIVE, r.rid)
        if self.injector is not None and self.cfg.chaos_every:
            t_end = float(times.max()) if len(times) else 0.0
            for t in periodic_ticks(self.cfg.chaos_every, t_end):
                events.push(float(t), CHAOS, -1)

        queue: deque = deque()
        in_flight = 0
        bid = 0
        timer = CloseTimer(events, CLOSE)
        batches: List[BatchRecord] = []

        def due(now: float) -> bool:
            return bool(queue) and (
                len(queue) >= self.cfg.max_batch
                or now >= records[queue[0]].t_arrival
                + self.cfg.max_wait - EPS)

        def admit(now: float):
            """Admission control: drop queued requests that can no longer
            meet the SLO given the plan's predicted quorum latency. The
            prediction is ``ir.objective()`` — Eq. 1a on whatever latency
            model the plan carries, so a measured-mode plan sheds load on
            microbenched numbers."""
            if not self.cfg.admission or not queue:
                return
            pred = self.server.ir.objective()
            survivors = [rid for rid in queue
                         if now - records[rid].t_arrival + pred
                         <= self.cfg.slo + EPS]
            if len(survivors) != len(queue):
                for rid in queue:
                    if now - records[rid].t_arrival + pred \
                            > self.cfg.slo + EPS:
                        self._shed(records[rid], now)
                queue.clear()
                queue.extend(survivors)

        def try_dispatch(now: float):
            nonlocal in_flight, bid
            admit(now)
            while queue and in_flight < self.cfg.pipeline_depth and due(now):
                take = [records[queue.popleft()]
                        for _ in range(min(len(queue), self.cfg.max_batch))]
                done_t, batch, share_events = self._dispatch(now, take, bid)
                batches.append(batch)
                events.push(done_t, DONE, bid)
                for t_sh, fut_idx in share_events:
                    events.push(t_sh, SHARE, fut_idx)
                bid += 1
                in_flight += 1
            # arm a close timer only while the head still needs to wait; a
            # head that is due but blocked on pipeline_depth is re-tried by
            # the DONE event (an overdue timer would spin the event loop)
            if queue and not due(now):
                timer.arm(records[queue[0]].t_arrival + self.cfg.max_wait,
                          now)

        tr = self.tracer
        while events:
            now, kind, payload = events.pop()
            if tr is not None:
                tr.now = now       # clock-less components stamp off this
            if kind == ARRIVE:
                queue.append(payload)
                if tr is not None:
                    self._trace_arrival(records[payload], now)
                try_dispatch(now)
            elif kind == CLOSE:
                timer.fired(now)
                try_dispatch(now)
            elif kind == DONE:
                in_flight -= 1
                try_dispatch(now)
            elif kind == SHARE:
                # cancel-on-first-k: the k-th arrival completes the future;
                # a share popping after that was in flight when the answer
                # completed — it is the cancelled speculative work
                self._share_event(payload, now)
            else:                                    # CHAOS
                down = set(self.injector.tick())
                if tr is not None:
                    tr.instant("chaos_tick", f"{self.trace_name}chaos",
                               t=now, down=sorted(down))
                if self.controller is not None:
                    self.controller.observe_deferred(down)
                else:
                    self._down = down
        return EngineReport(records, batches, self.migrations,
                            self.cfg.slo, self.futures)

    def _warmup(self, sizes: np.ndarray) -> None:
        """Serve every row bucket the run can hit once, so measured service
        times exclude first-call costs (the kernel build, cuDNN's algorithm
        search, allocator growth). The
        server's failure model is parked during warmup so stateful scenarios
        (e.g. a chaos script) consume no ticks."""
        if self.cfg.bucket_rows:
            max_rows = int(sizes.max()) * self.cfg.max_batch
            buckets = []
            b = 1
            while True:
                buckets.append(b)
                if b >= max_rows:
                    break
                b <<= 1
        else:
            buckets = sorted({int(s) for s in np.unique(sizes)})
        saved = self.server.failure
        try:
            # clean pass warms the full-quorum path; a second pass with
            # one device forced down warms the degraded branches (dead
            # -slot zeros, per-row masking) so the first real failure does
            # not absorb a first-call spike into its measured service time
            arrays = self.server.arrays
            models = [FailureModel(outages=False)]
            dead_slot = [arrays.names[j] for j in
                         (arrays.slot_cols[0] if arrays.n_slots else [])]
            if dead_slot:
                models.append(FailureModel(forced_failures=dead_slot,
                                           outages=False))
            for model in models:
                self.server.failure = model
                for b in buckets:
                    self.server.serve_batch([self._input(b)],
                                            rng=np.random.default_rng(0))
        finally:
            self.server.failure = saved


# ---------------------------------------------------------------------------
# demo fleet — the torch twin of the JAX package's build_demo_server
# ---------------------------------------------------------------------------

def build_demo_server(ir, *, feat: int = 32, hidden: int = 64,
                      n_classes: int = 10, seed: int = 0,
                      deadline: float = float("inf"),
                      failure=None, fastpath: Optional[bool] = None,
                      quantize: str = "none",
                      device=None) -> QuorumServer:
    """A content-addressed toy server for a :class:`PlanIR`: a shared trunk
    (``tanh(x @ W)``), per-partition head columns, and master FC rows indexed
    by filter id. It draws the SAME numpy weights from the same ``seed`` as
    the JAX package's ``build_demo_server``, so the two servers compute the
    same function. Because every weight is addressed by the partition's
    filter set, ANY partition layout has true weights — the reference
    implementation of the :attr:`QuorumServer.redeploy_fn` contract — and
    full-quorum logits are partition-independent (the merge telescopes to
    ``tanh(x @ trunk) @ head @ wfc + bias``).

    The students share one head matmul over the shared trunk, so the server
    always carries the stacked fused export; ``fastpath=False`` pins the
    legacy per-slot loop and ``quantize="int8"`` deploys the stacked heads
    and FC slices weight-only int8. Runs on the card unless
    ``device="cpu"``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.device import resolve_device
    from repro_torch.runtime.serving import FusedStudents
    dev = resolve_device(device)

    def on_dev(a: np.ndarray) -> "torch.Tensor":
        return torch.as_tensor(a, dtype=torch.float32).to(dev)

    rng = np.random.default_rng(seed)
    trunk = on_dev(rng.standard_normal((feat, hidden)).astype(np.float32)
                   / np.sqrt(feat))
    head = on_dev(rng.standard_normal((hidden, ir.M)).astype(np.float32)
                  / np.sqrt(hidden))
    wfc = rng.standard_normal((ir.M, n_classes)).astype(np.float32)
    bias = on_dev(rng.standard_normal(n_classes).astype(np.float32))

    def params_for(mask: np.ndarray) -> "torch.Tensor":
        # the slot's weight tree for the stacked export: its head columns
        return head[:, torch.as_tensor(np.flatnonzero(mask), device=dev)]

    def fn_for(mask: np.ndarray) -> Callable:
        cols = params_for(mask)

        def fn(x):
            return torch.tanh(x @ trunk) @ cols
        return fn

    def slice_for(mask: np.ndarray) -> "torch.Tensor":
        return on_dev(wfc[np.flatnonzero(mask)])

    def redeploy(new_ir, slot: int):
        mask = np.asarray(new_ir.partition[slot])
        return fn_for(mask), slice_for(mask), params_for(mask)

    fused = FusedStudents(
        apply=lambda p, h: h @ p,
        params=[params_for(row) for row in ir.partition],
        pad=lambda p, width: F.pad(p, (0, width - p.shape[-1])),
        pre=lambda x: torch.tanh(x @ trunk))

    dims = [max(int(row.sum()), 1) for row in ir.partition]
    Dk = max(dims, default=1)
    fcw = np.zeros((ir.K, Dk, n_classes), np.float32)
    for k, row in enumerate(ir.partition):
        idx = np.flatnonzero(row)
        fcw[k, :len(idx)] = wfc[idx]
    return QuorumServer(
        plan=ir,
        portion_fns=[fn_for(row) for row in ir.partition],
        fc_weights=on_dev(fcw),
        fc_bias=bias,
        deadline=deadline,
        failure=failure or FailureModel(outages=False),
        rng=np.random.default_rng(seed),
        part_dims=tuple(dims),
        redeploy_fn=redeploy,
        fused=fused,
        fastpath=fastpath,
        quantize=quantize,
        device=dev,
    )
