"""Hierarchical fleet control plane: multi-tenant routing over many quorum
servers.

Everything below :mod:`repro.runtime.engine` serves ONE model on ONE plan;
this module is the level above it — the three-level hierarchy the ROADMAP's
"heavy traffic from millions of users" north star needs:

  1. :class:`FleetRouter` — load-aware dispatch across per-tenant serving
     lanes. Every tenant keeps its own queue (requests are tenant-bound:
     tenants run DISTINCT models), so routing is the *scheduling* decision:
     when several lanes have a closable micro-batch and the fleet's shared
     serving capacity is limited, the router picks who dispatches next —
     ``"jsq"`` (serve the longest queue first, the join-shortest-queue dual)
     or ``"predicted"`` (highest SLO urgency, using each plan's Eq. 1a
     predicted quorum latency — the measured ``device_specs`` model when
     the plan carries one).
  2. :class:`FleetController` — owns the global spare pool through a
     :class:`SparePoolBroker` and arbitrates it across per-tenant
     :class:`~repro.runtime.controller.ClusterController` shards. Chaos
     repairs now COMPETE: a spare claimed by one tenant's repair is out of
     every other tenant's candidate set until freed (the broker enforces
     exclusivity; double-claims raise).
  3. :class:`Autoscaler` — spins tenant plans up/down from the spare pool
     as MMPP traffic shifts: a backlogged tenant adopts the best free spare
     into its slowest slot (placement-only — partitions untouched, nothing
     re-jits), an idle tenant releases adopted spares back to the pool.

:class:`FleetEngine` runs all of it on ONE virtual clock built from the
same :mod:`repro.runtime.clock` primitives as the single-tenant engine —
same event-kind vocabulary, same arm-once close timers, one per lane. Each
lane wraps a hidden :class:`~repro.runtime.engine.ServingEngine` whose
``_dispatch`` path (batch RNG keyed by batch id, input cache, power-of-two
row bucketing, coded share futures, controller poll points) is reused
verbatim, so a single-tenant fleet is BIT-identical to the bare engine at
fixed seeds (``tests/test_fleet.py`` pins this). Repairs apply at dispatch
boundaries exactly as in the engine; the fleet controller's weight-ordered
``poll_round`` runs at autoscale ticks, giving high-SLO-class tenants first
claim on contested spares.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.obs.stats import throughput
from repro_torch.runtime.clock import EPS, CloseTimer, EventQueue, periodic_ticks
from repro_torch.runtime.controller import ClusterController
from repro_torch.runtime.engine import (ARRIVE, CHAOS, CLOSE, DONE, SHARE,
                                  EngineConfig, EngineReport, RequestRecord,
                                  ServingEngine)

# fleet-only event kind: autoscaler / fleet-controller control ticks
SCALE = 5


# ---------------------------------------------------------------------------
# tenancy model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A tenant's service class: latency target plus arbitration weight.

    ``weight`` orders spare-pool arbitration (fleet-controller poll rounds
    and autoscaler passes run highest weight first) and scales the
    ``"predicted"`` router's urgency, so a gold tenant wins contested
    resources over a best-effort one."""

    name: str
    slo: float                       # end-to-end latency target (virtual s)
    weight: float = 1.0              # arbitration priority (higher wins)


#: default service class for tenants that do not declare one
BEST_EFFORT = SLOClass("best-effort", slo=0.5, weight=1.0)


@dataclasses.dataclass
class TenantSpec:
    """One tenant of the fleet: a model behind its own plan and controller.

    ``service_coeffs`` — optional ``(c0, c1, c2)`` tying the lane's
    deterministic service model to the LIVE plan: a dispatched batch takes
    ``c0 + obj·c1 + obj·c2·rows`` virtual seconds with ``obj`` the plan's
    Eq. 1a objective, so adopting a fast spare into the slowest slot
    genuinely raises the tenant's capacity (the fleet benchmark's arms are
    comparable only because of this coupling). None keeps the tenant
    config's static ``service_model``."""

    name: str
    server: Any                      # QuorumServer
    controller: Optional[ClusterController] = None
    slo: SLOClass = BEST_EFFORT
    config: Optional[EngineConfig] = None
    service_coeffs: Optional[Tuple[float, float, float]] = None


# ---------------------------------------------------------------------------
# spare-pool broker + fleet controller
# ---------------------------------------------------------------------------

class SparePoolBroker:
    """Free-set arbiter for the fleet's shared spare devices.

    The broker owns a fixed pool *universe* (the spare device names every
    tenant plan carries as unassigned columns via
    :meth:`~repro.core.plan_ir.PlanIR.add_devices`). Tenant controllers ask
    :meth:`candidates` before planning and settle claims through
    :meth:`notify`; names outside the universe (tenant-owned devices
    churning through repairs) are ignored. Claiming a spare another shard
    holds raises — the invariant the single-tenant controller silently
    violated when two shards repaired concurrently."""

    def __init__(self, pool_names: Sequence[str]):
        self.pool: Set[str] = set(pool_names)
        self.free: Set[str] = set(pool_names)
        self.owner: Dict[str, Any] = {}
        self.log: List[Tuple[str, str, Any]] = []   # (op, name, shard)
        # optional obs plane (wired by FleetEngine.run): claim/free
        # instants land on the fleet/spares track, stamped off tracer.now
        self.tracer = None

    def candidates(self, shard) -> Set[str]:
        """Spare names ``shard`` may claim right now (the free set)."""
        return set(self.free)

    def notify(self, shard, claimed: Set[str], freed: Set[str]) -> None:
        """Settle an applied plan change: move ``claimed`` out of the free
        set under ``shard``'s ownership and return ``freed`` to it."""
        claimed, freed = claimed & self.pool, freed & self.pool
        stolen = {n for n in claimed if self.owner.get(n, shard) is not shard}
        if stolen:
            raise RuntimeError(
                f"spare(s) {sorted(stolen)} double-claimed: already owned")
        tenant = getattr(shard, "trace_name", "").rstrip("/")
        for n in sorted(claimed):
            self.free.discard(n)
            self.owner[n] = shard
            self.log.append(("claim", n, shard))
            if self.tracer is not None:
                self.tracer.instant("spare_claim", "fleet/spares",
                                    device=n, tenant=tenant)
        for n in sorted(freed):
            if self.owner.get(n, shard) is shard:
                self.owner.pop(n, None)
                self.free.add(n)
                self.log.append(("free", n, shard))
                if self.tracer is not None:
                    self.tracer.instant("spare_free", "fleet/spares",
                                        device=n, tenant=tenant)

    def held_by(self, shard) -> Set[str]:
        """Spare names currently owned by ``shard``."""
        return {n for n, s in self.owner.items() if s is shard}


class FleetController:
    """The hierarchy's middle level: global spare pool + shard arbitration.

    Wires every tenant :class:`ClusterController` to one shared
    :class:`SparePoolBroker` and fixes the arbitration order — descending
    SLO-class weight (ties by tenant name). :meth:`poll_round` drains
    deferred chaos observations shard by shard in that order, so when two
    tenants' repairs want the same spare at the same control tick, the
    higher class plans first and wins it."""

    def __init__(self, tenants: Sequence[TenantSpec],
                 spare_names: Sequence[str]):
        self.broker = SparePoolBroker(spare_names)
        self.tenants = {t.name: t for t in tenants}
        for t in tenants:
            if t.controller is not None:
                t.controller.spare_broker = self.broker
        self._order = tuple(sorted(
            (t.name for t in tenants if t.controller is not None),
            key=lambda n: (-self.tenants[n].slo.weight, n)))

    def order(self) -> Tuple[str, ...]:
        """Tenant names in arbitration order (highest weight first)."""
        return self._order

    def poll_round(self) -> Dict[str, Any]:
        """Apply every shard's pending deferred down-set in arbitration
        order; returns ``{tenant: RepairOutcome}`` for shards that acted."""
        outcomes: Dict[str, Any] = {}
        for name in self._order:
            out = self.tenants[name].controller.poll()
            if out is not None:
                outcomes[name] = out
        return outcomes


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetRouter:
    """Dispatch-order policy over ready lanes.

    ``"jsq"`` serves the longest queue first — the dispatch-side dual of
    join-shortest-queue, load-aware but SLO-blind. ``"predicted"`` serves
    the lane whose head request is closest to breaching its SLO under the
    plan's CURRENT Eq. 1a predicted quorum latency (measured model when the
    plan carries fitted device specs), scaled by the tenant's class weight.
    Ties resolve by lane index, so runs are deterministic."""

    policy: str = "predicted"

    def pick(self, ready: List["_Lane"], now: float) -> "_Lane":
        """Choose which of the ``ready`` lanes dispatches next."""
        if self.policy == "jsq":
            return max(ready, key=lambda ln: (len(ln.queue), -ln.index))
        if self.policy != "predicted":
            raise ValueError(f"unknown router policy: {self.policy!r}")
        return max(ready, key=lambda ln: (ln.urgency(now), -ln.index))


# ---------------------------------------------------------------------------
# per-tenant serving lane
# ---------------------------------------------------------------------------

class _LaneEngine(ServingEngine):
    """Per-tenant :class:`ServingEngine` whose deterministic service model
    can track the live plan (``TenantSpec.service_coeffs``). With no
    coefficients it IS the stock engine — the single-tenant bit-identity
    guarantee rests on that."""

    service_coeffs: Optional[Tuple[float, float, float]] = None

    def _apply_control(self, now: float) -> None:
        """Engine control point, then re-anchor the service model to the
        (possibly just-migrated) plan objective."""
        super()._apply_control(now)
        if self.service_coeffs is not None:
            c0, c1, c2 = self.service_coeffs
            obj = float(self.server.ir.objective())
            if not np.isfinite(obj):
                # a plan mid-outage with an empty slot predicts ∞; serve at
                # a heavily degraded but finite rate so the run terminates
                obj = 10.0 * self.cfg.slo
            self.cfg = dataclasses.replace(
                self.cfg, service_model=(c0 + obj * c1, obj * c2))


class _Lane:
    """One tenant's scheduling state on the fleet's shared virtual clock:
    queue, in-flight count, close timer, and the wrapped engine that owns
    dispatch (batch RNG, input cache, bucketing, controller poll)."""

    def __init__(self, index: int, tenant: TenantSpec, events: EventQueue,
                 seed: int):
        self.index = index
        self.tenant = tenant
        cfg = tenant.config or EngineConfig()
        cfg = dataclasses.replace(cfg, slo=tenant.slo.slo,
                                  seed=cfg.seed + seed)
        self.engine = _LaneEngine(tenant.server, cfg,
                                  controller=tenant.controller)
        self.engine.service_coeffs = tenant.service_coeffs
        self.records: List[RequestRecord] = []
        self.queue: deque = deque()
        self.batches: List = []
        self.in_flight = 0
        self.bid = 0
        self.timer = CloseTimer(events, CLOSE, payload=index)
        self.last_busy = 0.0

    @property
    def cfg(self) -> EngineConfig:
        """The lane's live engine config (service model may track the plan)."""
        return self.engine.cfg

    def due(self, now: float) -> bool:
        """Engine batch-window rule: full batch, or the head waited out
        ``max_wait``."""
        return bool(self.queue) and (
            len(self.queue) >= self.cfg.max_batch
            or now >= self.records[self.queue[0]].t_arrival
            + self.cfg.max_wait - EPS)

    def ready(self, now: float) -> bool:
        """Dispatchable right now, ignoring the fleet capacity gate."""
        return (bool(self.queue)
                and self.in_flight < self.cfg.pipeline_depth
                and self.due(now))

    def urgency(self, now: float) -> float:
        """SLO pressure of the head request: (wait so far + predicted
        quorum latency) normalized by the tenant's SLO, scaled by its class
        weight. ≥ weight means the head is predicted to breach."""
        if not self.queue:
            return -np.inf
        pred = float(self.engine.server.ir.objective())
        if not np.isfinite(pred):
            return np.inf
        wait = now - self.records[self.queue[0]].t_arrival
        return (wait + pred) / max(self.tenant.slo.slo, EPS) \
            * self.tenant.slo.weight

    def admit(self, now: float) -> None:
        """Engine SLO admission control on this lane's queue (sheds queued
        requests that can no longer meet the tenant SLO)."""
        if not self.cfg.admission or not self.queue:
            return
        pred = self.engine.server.ir.objective()
        records, queue = self.records, self.queue
        survivors = [rid for rid in queue
                     if now - records[rid].t_arrival + pred
                     <= self.cfg.slo + EPS]
        if len(survivors) != len(queue):
            for rid in queue:
                if now - records[rid].t_arrival + pred > self.cfg.slo + EPS:
                    self.engine._shed(records[rid], now)
            queue.clear()
            queue.extend(survivors)

    def dispatch_one(self, now: float, events: EventQueue) -> None:
        """Close and dispatch one micro-batch through the wrapped engine;
        completion and coded-share events land on the fleet clock."""
        take = [self.records[self.queue.popleft()]
                for _ in range(min(len(self.queue), self.cfg.max_batch))]
        done_t, batch, share_events = self.engine._dispatch(now, take,
                                                            self.bid)
        self.batches.append(batch)
        events.push(done_t, DONE, self.index)
        for t_sh, fut_idx in share_events:
            events.push(t_sh, SHARE, (self.index, fut_idx))
        self.bid += 1
        self.in_flight += 1
        self.last_busy = now

    def report(self) -> EngineReport:
        """The lane's finished run as a standard :class:`EngineReport`."""
        return EngineReport(self.records, self.batches,
                            self.engine.migrations, self.cfg.slo,
                            self.engine.futures)


# ---------------------------------------------------------------------------
# autoscaler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AutoscalerConfig:
    """Backlog-driven spare adoption knobs (virtual seconds / requests)."""

    every: float = 0.05              # control tick cadence
    grow_backlog: int = 12           # queue length that triggers adoption
    shrink_idle: float = 0.25        # idle seconds before releasing a spare
    cooldown: float = 0.1            # per-tenant gap between scale actions
    max_per_tenant: int = 4          # adopted-spare cap per tenant


class Autoscaler:
    """Moves spares between the pool and tenant plans as traffic shifts.

    Grow: a tenant whose queue exceeds ``grow_backlog`` adopts the free
    spare with the lowest Eq. 1a latency for its SLOWEST slot's student —
    membership-only, so nothing re-jits and the plan objective (hence the
    lane's plan-tied service model) drops immediately. Shrink: a tenant
    idle longer than ``shrink_idle`` releases its most recently adopted
    spare back to the pool, provided quorum survives without it. Both
    respect a per-tenant cooldown; passes run in fleet arbitration order so
    gold tenants adopt first when the pool runs dry."""

    def __init__(self, config: Optional[AutoscalerConfig] = None):
        self.cfg = config or AutoscalerConfig()
        self.adopted: Dict[str, List[str]] = {}
        self._last_action: Dict[str, float] = {}
        self.actions: List[Tuple[float, str, str, str]] = []

    def step(self, now: float, lanes: Sequence[_Lane],
             fleet: FleetController) -> None:
        """One control tick over every lane, in arbitration order."""
        by_name = {ln.tenant.name: ln for ln in lanes}
        for name in fleet.order():
            lane = by_name.get(name)
            if lane is None or lane.tenant.controller is None:
                continue
            if now - self._last_action.get(name, -np.inf) < self.cfg.cooldown:
                continue
            if (len(lane.queue) >= self.cfg.grow_backlog
                    and len(self.adopted.get(name, []))
                    < self.cfg.max_per_tenant):
                if self._grow(now, lane, fleet.broker):
                    self._last_action[name] = now
            elif (not lane.queue and not lane.in_flight
                    and self.adopted.get(name)
                    and now - lane.last_busy >= self.cfg.shrink_idle):
                if self._shrink(now, lane):
                    self._last_action[name] = now

    def _grow(self, now: float, lane: _Lane, broker: SparePoolBroker) -> bool:
        ctl = lane.tenant.controller
        ir = ctl.ir
        glat = ir.group_latency()
        finite = np.isfinite(glat)
        if not finite.any():
            return False
        k_star = int(np.argmax(np.where(finite, glat, -np.inf)))
        stu = int(ir.student_of[k_star])
        if stu < 0:
            return False
        name_to_col = {n: i for i, n in enumerate(ir.device_names)}
        assigned = ClusterController._assigned_names(ir)
        cols = [(n, name_to_col[n]) for n in sorted(broker.candidates(ctl))
                if n in name_to_col and n not in assigned
                and n not in ctl.down
                and ir.student_caps[stu, 1] <= ir.device_caps[
                    name_to_col[n], 1]]
        if not cols:
            return False
        pick, col = min(cols, key=lambda nc: float(ir.latency_nd[stu,
                                                                 nc[1]]))
        member = np.array(ir.member)
        member[k_star, col] = True
        out = ctl.apply_plan(ir.with_(member=member), kind="scale_up",
                             moved=(pick,))
        lane.engine.migrations.append((now, out))
        lane.engine.plan_epoch += 1
        self.adopted.setdefault(lane.tenant.name, []).append(pick)
        self.actions.append((now, lane.tenant.name, "scale_up", pick))
        if lane.engine.tracer is not None:
            lane.engine.tracer.instant("scale_up", "fleet/autoscale", t=now,
                                       tenant=lane.tenant.name, device=pick)
        return True

    def _shrink(self, now: float, lane: _Lane) -> bool:
        ctl = lane.tenant.controller
        ir = ctl.ir
        name = self.adopted[lane.tenant.name][-1]
        if name not in ir.device_names:
            self.adopted[lane.tenant.name].pop()
            return False
        col = list(ir.device_names).index(name)
        member = np.array(ir.member)
        member[:, col] = False
        new_ir = ir.with_(member=member)
        alive = new_ir.alive_mask(ctl.down)
        if not new_ir.quorum(alive).all():
            return False                     # the spare became load-bearing
        out = ctl.apply_plan(new_ir, kind="scale_down", moved=(name,))
        lane.engine.migrations.append((now, out))
        lane.engine.plan_epoch += 1
        self.adopted[lane.tenant.name].pop()
        self.actions.append((now, lane.tenant.name, "scale_down", name))
        if lane.engine.tracer is not None:
            lane.engine.tracer.instant("scale_down", "fleet/autoscale",
                                       t=now, tenant=lane.tenant.name,
                                       device=name)
        return True


# ---------------------------------------------------------------------------
# the fleet engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetReport:
    """Per-tenant :class:`EngineReport`\\ s plus fleet-level aggregates."""

    tenants: Tuple[str, ...]
    reports: Tuple[EngineReport, ...]

    def tenant(self, name: str) -> EngineReport:
        """The named tenant's report."""
        return self.reports[self.tenants.index(name)]

    def summary(self) -> Dict[str, Any]:
        """Fleet aggregates: completed request throughput across tenants
        (plus the quorum-complete GOODPUT — degraded answers don't count),
        the per-tenant p99 vector, and its worst case."""
        per = [r.summary() for r in self.reports]
        done = [r for rep in self.reports for r in rep.records
                if np.isfinite(r.t_done)]
        good = [r for r in done if r.quorum_ok]
        if done:
            t0 = min(r.t_arrival for r in done)
            t1 = max(r.t_done for r in done)
            rps = throughput(len(done), t0, t1)
            good_rps = throughput(len(good), t0, t1)
        else:
            rps = good_rps = 0.0
        p99s = [s["p99"] for s in per]
        return {
            "tenants": len(self.tenants),
            "aggregate_rps": rps,
            "goodput_rps": good_rps,
            "quorum_rate": len(good) / len(done) if done else 0.0,
            "completed": len(done),
            "rejected": int(sum(s["rejected"] for s in per)),
            "p99_per_tenant": p99s,
            "worst_p99": max(p99s) if p99s else float("inf"),
            "migrations": int(sum(s["migrations"] for s in per)),
        }


class FleetEngine:
    """N serving lanes, one virtual clock, one router, one spare pool.

    Parameters
    ----------
    tenants:    the fleet's :class:`TenantSpec` list (lane order = list
                order; determinism ties resolve toward earlier lanes).
    router:     dispatch-order policy (default ``"predicted"``).
    fleet_controller: optional :class:`FleetController`; required for
                autoscaling and weight-ordered repair arbitration.
    injector:   optional fleet-wide ``FailureInjector``; each chaos tick's
                down-set is delivered raw to EVERY tenant shard (a shard's
                ``alive_mask`` ignores foreign names), preserving
                single-tenant bit-identity.
    capacity:   max concurrently in-flight micro-batches across ALL lanes
                (the shared serving hardware); None = unlimited.
    autoscaler: optional :class:`Autoscaler`; its config's ``every`` sets
                the SCALE tick cadence.
    chaos_every: injector tick cadence on the fleet clock (virtual s).
    tracer:     optional :class:`repro.obs.trace.Tracer` — threaded into
                every lane engine (per-request spans under a
                ``<tenant>/`` track prefix), the tenant controllers and
                servers, the spare broker (claim/free instants on
                ``fleet/spares``), plus router decisions
                (``fleet/router``) and autoscale actions
                (``fleet/autoscale``). May also be attached after
                construction, any time before :meth:`run`. ``None`` keeps
                runs bit-identical to an uninstrumented build.
    metrics:    optional :class:`repro.obs.metrics.MetricsRegistry` —
                lane histograms/counters are scoped by ``tenant=`` and
                ``slo_class=`` labels.
    """

    def __init__(self, tenants: Sequence[TenantSpec], *,
                 router: Optional[FleetRouter] = None,
                 fleet_controller: Optional[FleetController] = None,
                 injector=None, capacity: Optional[int] = None,
                 autoscaler: Optional[Autoscaler] = None,
                 chaos_every: Optional[float] = None, seed: int = 0,
                 tracer=None, metrics=None):
        self.tenants = list(tenants)
        self.router = router or FleetRouter()
        self.fleet_controller = fleet_controller
        self.injector = injector
        self.capacity = capacity
        self.autoscaler = autoscaler
        self.chaos_every = chaos_every
        self.seed = seed
        self.tracer = tracer
        self.metrics = metrics
        if autoscaler is not None and fleet_controller is None:
            raise ValueError("autoscaling needs a FleetController "
                             "(it owns the spare pool)")

    def run(self, traces: Sequence[Tuple[Sequence[float], Sequence[int]]]
            ) -> FleetReport:
        """Serve one arrival trace per tenant to completion on the shared
        virtual clock and return per-tenant reports plus aggregates. Event
        scheduling for a lone tenant reproduces
        :meth:`ServingEngine.run` push-for-push — the refactor's
        bit-identity contract."""
        if len(traces) != len(self.tenants):
            raise ValueError(f"{len(traces)} traces for "
                             f"{len(self.tenants)} tenants")
        events = EventQueue()
        lanes = [_Lane(i, t, events, self.seed)
                 for i, t in enumerate(self.tenants)]
        if self.tracer is not None or self.metrics is not None:
            for lane in lanes:
                eng = lane.engine
                eng.tracer = self.tracer
                eng.metrics = self.metrics
                eng.trace_name = lane.tenant.name + "/"
                eng.metric_labels = {"tenant": lane.tenant.name,
                                     "slo_class": lane.tenant.slo.name}
                eng._wire_tracer()
            if self.fleet_controller is not None and self.tracer is not None:
                self.fleet_controller.broker.tracer = self.tracer
        t_end = 0.0
        for lane, (times, sizes) in zip(lanes, traces):
            times = np.asarray(times, np.float64)
            if sizes is None:
                sizes = np.ones(len(times), np.int64)
            sizes = np.asarray(sizes, np.int64)
            lane.records = [RequestRecord(i, float(times[i]), int(sizes[i]))
                            for i in range(len(times))]
            if (lane.cfg.warmup and lane.cfg.service_model is None
                    and lane.tenant.service_coeffs is None and len(times)):
                lane.engine._warmup(sizes)
            for r in lane.records:
                events.push(r.t_arrival, ARRIVE, (lane.index, r.rid))
            if len(times):
                t_end = max(t_end, float(times.max()))
        if self.injector is not None and self.chaos_every:
            for t in periodic_ticks(self.chaos_every, t_end):
                events.push(float(t), CHAOS, -1)
        if self.autoscaler is not None:
            for t in periodic_ticks(self.autoscaler.cfg.every, t_end):
                events.push(float(t), SCALE, -1)

        saved_failures = [ln.engine.server.failure for ln in lanes]
        try:
            self._loop(events, lanes)
        finally:
            for lane, failure in zip(lanes, saved_failures):
                lane.engine.server.failure = failure
        return FleetReport(tuple(t.name for t in self.tenants),
                           tuple(ln.report() for ln in lanes))

    # -- internals -----------------------------------------------------------

    def _loop(self, events: EventQueue, lanes: List[_Lane]) -> None:
        tr = self.tracer
        while events:
            now, kind, payload = events.pop()
            if tr is not None:
                tr.now = now
            if kind == ARRIVE:
                ti, rid = payload
                lanes[ti].queue.append(rid)
                lanes[ti].last_busy = now
                if tr is not None:
                    lanes[ti].engine._trace_arrival(lanes[ti].records[rid],
                                                    now)
                self._dispatch_phase(now, events, lanes)
            elif kind == CLOSE:
                lanes[payload].timer.fired(now)
                self._dispatch_phase(now, events, lanes)
            elif kind == DONE:
                lanes[payload].in_flight -= 1
                self._dispatch_phase(now, events, lanes)
            elif kind == SHARE:
                ti, fut_idx = payload
                lanes[ti].engine._share_event(fut_idx, now)
            elif kind == CHAOS:
                down = set(self.injector.tick())
                if tr is not None:
                    tr.instant("chaos_tick", "fleet/chaos", t=now,
                               down=sorted(down))
                for lane in lanes:
                    if lane.tenant.controller is not None:
                        lane.tenant.controller.observe_deferred(down)
                    else:
                        lane.engine._down = down
            else:                                    # SCALE
                self._control_tick(now, lanes)

    def _dispatch_phase(self, now: float, events: EventQueue,
                        lanes: List[_Lane]) -> None:
        """The engine's ``try_dispatch`` generalized across lanes: admit,
        then let the router drain ready lanes under the capacity gate, then
        re-arm close timers for lanes still waiting out their window."""
        for lane in lanes:
            lane.admit(now)
        while self.capacity is None \
                or sum(ln.in_flight for ln in lanes) < self.capacity:
            ready = [ln for ln in lanes if ln.ready(now)]
            if not ready:
                break
            pick = self.router.pick(ready, now)
            if self.tracer is not None:
                self.tracer.instant(
                    "route", "fleet/router", t=now,
                    policy=self.router.policy, picked=pick.tenant.name,
                    ready=[ln.tenant.name for ln in ready])
            pick.dispatch_one(now, events)
        for lane in lanes:
            if lane.queue and not lane.due(now):
                lane.timer.arm(
                    lane.records[lane.queue[0]].t_arrival
                    + lane.cfg.max_wait, now)

    def _control_tick(self, now: float, lanes: List[_Lane]) -> None:
        """SCALE tick: settle pending repairs in arbitration order (gold
        tenants claim contested spares first), then autoscale."""
        by_name = {ln.tenant.name: ln for ln in lanes}
        if self.fleet_controller is not None:
            for name in self.fleet_controller.order():
                lane = by_name.get(name)
                if lane is not None:
                    lane.engine._apply_control(now)
        if self.autoscaler is not None:
            self.autoscaler.step(now, lanes, self.fleet_controller)
