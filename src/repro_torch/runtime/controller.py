"""Online cluster controller: failure events → incremental repair replanning.

RoCoIn's headline claim is resilience, but the original pipeline treated
failure handling as an offline recompute: ``failures.replan()`` rebuilt the
whole Algorithm-1 plan from scratch and ``QuorumServer.remove_device``
silently left emptied groups missing quorum forever. ``ClusterController``
makes failure handling a first-class runtime loop over the canonical
:class:`~repro.core.plan_ir.PlanIR`:

  1. consume :class:`~repro.runtime.failures.FailureInjector` events (or any
     down-device set) via :meth:`step` / :meth:`observe` — or, from a
     latency-critical serving loop, the non-blocking
     :meth:`observe_deferred` / :meth:`poll` pair,
  2. when a group loses quorum (no live replica), perform *incremental local
     repair*: spare devices — unassigned ones, or live members of groups that
     keep a live replica after donating — are matched to the broken slots by
     a residual Hungarian assignment on the precomputed Eq. 1a latency
     matrix, warm-started with each slot's current student; only touched
     groups re-pick students,
  3. fall back to a full Algorithm-1 replan (:func:`planner.tune_d_th_ir` on
     the live fleet) when repair is infeasible, remapping distilled students
     one-to-one via :func:`failures.remap_students`,
  3b. erasure-coded groups (a PlanIR carrying a coding spec) repair even
     cheaper: a share whose every placement died is rebuilt by
     *re-encoding* onto a live spare — one placement, no re-jit, no
     re-distillation, because the share payload is a deterministic linear
     combination of the group's portions (``reencoded_shares`` in the
     outcome counts them),
  4. migrate an attached live :class:`~repro.runtime.serving.QuorumServer`
     in place — slots whose knowledge partition is untouched keep their
     jit-compiled portion forwards.

Incremental repair never changes partitions, so it re-jits nothing and
redeploys only the moved donor replicas; a full replan generally reshapes
every partition and redeploys most of the fleet. ``benchmarks/plan_scale.py``
and ``tests/test_controller.py`` quantify the gap.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core import assignment as ASG
from repro_torch.core import planner as PL
from repro_torch.core.plan_ir import PlanIR
from repro_torch.runtime.failures import remap_students


@dataclasses.dataclass(frozen=True)
class RepairOutcome:
    """One repair action taken (or proposed) by the controller."""
    kind: str                  # "repair" | "full_replan" | "reencode" | "noop"
    ir: PlanIR                        # the plan after the action
    mapping: Dict[int, int]           # new slot -> old slot (student reuse)
    touched_slots: Tuple[int, ...]    # slots whose membership/student changed
    rejitted_slots: Tuple[int, ...]   # slots whose partition mask changed
    redeployed: int                   # (device, slot) placements that changed
    moved_devices: Tuple[str, ...]
    feasible: bool
    objective: float                  # live Eq. 1a objective after the action
    wall_s: float
    # coded shares rebuilt by re-encoding (global share ids: slot id for
    # systematic shares, K + p for parity share p) — a re-encoded share
    # costs one donor placement and NO re-distillation: its payload is a
    # deterministic linear combination of the group's portions
    reencoded_shares: Tuple[int, ...] = ()


class ClusterController:
    """Event loop turning failure signals into plan repairs.

    Parameters
    ----------
    ir:        the canonical plan to govern (device/student catalogues,
               membership, partitions, Eq. 1a matrix — everything repair
               needs travels inside the IR).
    server:    optional live ``QuorumServer``; every applied outcome migrates
               it in place (untouched portion forwards keep their jit).
    injector:  optional ``FailureInjector`` driving :meth:`step`/:meth:`run`.
    force_full: disable incremental repair (full replan on every event) —
               the comparison baseline used by benchmarks and tests.
    spare_broker: optional spare-pool arbiter (duck-typed; see
               :class:`repro.runtime.fleet.SparePoolBroker`). When set, the
               controller no longer assumes it owns every unassigned device:
               before planning it asks ``broker.candidates(self)`` for the
               spare names it may claim, and after applying an outcome it
               reports ``broker.notify(self, claimed, freed)`` so concurrent
               repairs on OTHER tenant shards cannot grab the same spare.
               Without a broker, behavior is bit-identical to the
               single-tenant controller of PRs 4-7.
    """

    def __init__(self, ir: PlanIR, *, server=None, injector=None,
                 seed: int = 0, force_full: bool = False,
                 require_feasible: bool = True, spare_broker=None):
        self.ir = ir.validate()
        self.server = server
        self.injector = injector
        self.seed = seed
        self.force_full = force_full
        self.require_feasible = require_feasible
        self.spare_broker = spare_broker
        self.down: Set[str] = set()
        self.history: List[RepairOutcome] = []
        self._pending: Optional[Set[str]] = None
        # optional obs plane, wired by the owning engine (repair spans
        # stamp off tracer.now — the controller holds no clock)
        self.tracer = None
        self.trace_name = ""
        # assignment snapshot last reported to the broker — notify() sends
        # set diffs, so this must track exactly what the broker believes
        self._broker_view: Set[str] = self._assigned_names(self.ir)

    # -- event intake --------------------------------------------------------

    def step(self) -> Optional[RepairOutcome]:
        """Advance the injector one tick and react to the new down-set."""
        return self.observe(self.injector.tick())

    def run(self, ticks: int) -> List[RepairOutcome]:
        """Drive `ticks` injector ticks; returns the non-noop outcomes."""
        out = []
        for _ in range(ticks):
            o = self.step()
            if o is not None:
                out.append(o)
        return out

    def observe_deferred(self, down_names: Sequence[str]) -> bool:
        """Non-blocking intake for the serving hot path: record the newest
        down-set WITHOUT planning (an O(1) set copy — safe to call from a
        latency-critical loop). Repeated calls coalesce; only the newest set
        survives until the next :meth:`poll`. Returns True when the recorded
        set differs from the last applied one (a later poll may repair)."""
        down = set(down_names)
        self._pending = down
        changed = down != self.down
        if self.tracer is not None and changed:
            self.tracer.instant("failure_observed",
                                f"{self.trace_name}controller",
                                down=sorted(down))
        return changed

    def poll(self) -> Optional[RepairOutcome]:
        """Apply the newest deferred down-set, if any. The continuous
        -batching engine calls this between micro-batch dispatches, so repair
        planning never blocks an in-flight batch."""
        if self._pending is None:
            return None
        down, self._pending = self._pending, None
        return self.observe(down)

    def observe(self, down_names: Sequence[str]) -> Optional[RepairOutcome]:
        """React to a new set of transiently-down devices. Returns the
        applied outcome, or None when every slot still holds quorum (for a
        coded slot: its own share is live OR its group can still decode)."""
        down = set(down_names)
        if down == self.down:
            return None
        self.down = down
        alive = self.ir.alive_mask(down)
        if self.ir.quorum(alive).all():
            return None
        return self._rebuild(alive)

    def permanent_loss(self, name: str) -> Optional[RepairOutcome]:
        """Remove a device from the fleet outright, then restore quorum.
        Coded shares the loss emptied are rebuilt FIRST by re-encoding onto
        spare devices (placement-only — the share payload is a deterministic
        linear combination, no re-distillation); replicate groups that lost
        quorum then repair as before. Returns the applied outcome (a noop
        outcome when the loss broke no group — the attached server still
        adopts the shrunken plan)."""
        self.ir = self.ir.drop_device(name)
        self.down.discard(name)
        alive = self.ir.alive_mask(self.down)
        cand = self._spare_candidates()
        self.ir, reenc, moved = self._reencode_shares(
            alive, spare_candidates=cand)
        if self.ir.quorum(alive).all():
            # quorum intact, but the loss may still have pushed a surviving
            # group past the Eq. 1f outage target — report that honestly
            feasible = bool(
                (self.ir.group_outage(alive) <= self.ir.p_th).all())
            out = RepairOutcome(
                kind="reencode" if reenc else "noop", ir=self.ir,
                mapping={k: k for k in range(self.ir.K)},
                touched_slots=tuple(s for s in reenc if s < self.ir.K),
                rejitted_slots=(), redeployed=len(reenc),
                moved_devices=moved, feasible=feasible,
                objective=self.ir.objective(alive), wall_s=0.0,
                reencoded_shares=reenc)
            self._apply(out)
            return out
        return self._rebuild(alive, reencoded=reenc, moved=moved)

    # -- repair planning -----------------------------------------------------

    def _rebuild(self, alive: np.ndarray, reencoded: Tuple[int, ...] = (),
                 moved: Tuple[str, ...] = ()) -> RepairOutcome:
        cand = self._spare_candidates()
        if not reencoded and (self.ir.coding is not None
                              or self.ir.compute_coding is not None):
            self.ir, reencoded, moved = self._reencode_shares(
                alive, spare_candidates=cand)
            if reencoded and self.ir.quorum(alive).all():
                out = RepairOutcome(
                    kind="reencode", ir=self.ir,
                    mapping={k: k for k in range(self.ir.K)},
                    touched_slots=tuple(s for s in reencoded
                                        if s < self.ir.K),
                    rejitted_slots=(), redeployed=len(reencoded),
                    moved_devices=moved,
                    feasible=bool((self.ir.group_outage(alive)
                                   <= self.ir.p_th).all()),
                    objective=self.ir.objective(alive), wall_s=0.0,
                    reencoded_shares=reencoded)
                self._apply(out)
                return out
        out = None if self.force_full else self.plan_repair(
            alive, spare_candidates=cand)
        if out is None:
            out = self.plan_full(alive, spare_candidates=cand)
        # a full replan discards the coding layout (and with it any share
        # placement the re-encode pass made), so its outcome must not
        # report that re-encode work as applied
        if reencoded and out.kind != "full_replan":
            out = dataclasses.replace(
                out,
                reencoded_shares=tuple(reencoded) + out.reencoded_shares,
                moved_devices=tuple(moved) + tuple(out.moved_devices),
                redeployed=out.redeployed + len(reencoded))
        self._apply(out)
        return out

    def _reencode_shares(self, alive: np.ndarray, *,
                         spare_candidates: Optional[Set[str]] = None
                         ) -> Tuple[PlanIR, Tuple[int, ...],
                                    Tuple[str, ...]]:
        """Rebuild coded shares with no live placement by re-encoding onto
        live spare devices (unassigned, Eq. 1g memory respected, picked by
        Eq. 1a latency of the share's student). ``spare_candidates``, when
        given, is the explicit set of device names eligible as re-encode
        targets (a fleet broker's free pool); None keeps the legacy "every
        alive unassigned column is mine" behavior. Returns the (possibly
        unchanged) IR plus the rebuilt global share ids and donor names —
        no portion forward is re-jitted and no student re-distilled: the
        new device serves the same deterministic linear combination.

        Re-encoding is a real data operation, not bookkeeping: a share can
        only be recomputed from ≥ k live shares of its group, so a group
        that has already lost decode (fewer than k shares live) is NOT
        eligible — its slots fall through to student redeploys via
        ``plan_repair`` / ``plan_full``.

        Compute-coded slots re-encode the same way, one tier down: a lost
        WEIGHT shard (``1/k`` of the slot's linear layer, pre-encoded) is
        rebuilt onto the lowest-latency live spare whose memory fits the
        shard (Eq. 1g at ``params / k``), provided ≥ k shards of the slot
        are still live to source the re-encode. The old placement is
        dropped — shards are one-per-device by construction."""
        ir = self.ir
        cs = ir.coding
        cc = ir.compute_coding
        has_out = cs is not None and cs.n_groups
        has_cc = cc is not None and cc.Q
        if (not has_out and not has_cc) or not ir.N:
            return ir, (), ()
        member = np.array(ir.member)
        pmember = (np.array(cs.parity_member) if has_out and cs.P
                   else np.zeros((0, ir.N), bool))
        used = member.any(axis=0)
        if pmember.size:
            used = used | pmember.any(axis=0)
        spares = [int(n) for n in np.flatnonzero(alive & ~used)
                  if spare_candidates is None
                  or ir.device_names[n] in spare_candidates]
        params = ir.student_caps[:, 1]
        c_mem = ir.device_caps[:, 1]
        reencoded: List[int] = []
        moved: List[str] = []
        if has_out:
            share_live = np.concatenate([
                (member & alive[None, :]).any(axis=1),
                (pmember & alive[None, :]).any(axis=1) if cs.P
                else np.zeros(0, bool)])
            lost: List[Tuple[int, int, np.ndarray, int]] = []
            for c in range(cs.n_groups):
                shares = cs.group_shares(c)
                _, k = cs.code_nk(c)
                if int(share_live[shares].sum()) < k:
                    continue        # undecodable: re-encoding has no source
                for s in cs.group_slots(c):
                    if not share_live[s]:
                        lost.append((int(s), int(ir.student_of[s]), member,
                                     int(s)))
                for p in cs.group_parities(c):
                    if not share_live[ir.K + int(p)]:
                        lost.append((ir.K + int(p),
                                     int(cs.parity_student[p]),
                                     pmember, int(p)))
            for share_id, stu, mat, row in lost:
                if stu < 0 or not spares:
                    continue
                fits = [n for n in spares if params[stu] <= c_mem[n]]
                if not fits:
                    continue
                best = min(fits, key=lambda n: float(ir.latency_nd[stu, n]))
                mat[row, best] = True
                spares.remove(best)
                reencoded.append(share_id)
                moved.append(ir.device_names[best])
        new_shard_member = None
        if has_cc:
            base = ir.K + (cs.P if cs is not None else 0)
            new_shard_member = [np.array(m) for m in cc.shard_member]
            off = 0
            for q in range(cc.Q):
                n_q, k_q = cc.code_nk(q)
                slot = int(cc.slots[q])
                stu = int(ir.student_of[slot])
                mem = new_shard_member[q]
                live_sh = (mem >= 0) & alive[np.maximum(mem, 0)]
                if int(live_sh.sum()) < k_q or stu < 0:
                    off += n_q
                    continue        # undecodable: no re-encode source
                for j in np.flatnonzero(~live_sh):
                    fits = [d for d in spares
                            if params[stu] / k_q <= c_mem[d]]
                    if not fits:
                        break
                    best = min(fits,
                               key=lambda d: float(ir.latency_nd[stu, d]))
                    old = int(mem[j])
                    if old >= 0:
                        member[slot, old] = False
                    mem[j] = best
                    member[slot, best] = True
                    spares.remove(best)
                    reencoded.append(int(base + off + j))
                    moved.append(ir.device_names[best])
                off += n_q
        if not reencoded:
            return ir, (), ()
        kw: Dict = {"member": member}
        if has_out:
            kw["coding"] = cs.with_(parity_member=pmember)
        if new_shard_member is not None:
            kw["compute_coding"] = cc.with_(
                shard_member=tuple(new_shard_member))
        new_ir = ir.with_(**kw)
        return new_ir, tuple(reencoded), tuple(moved)

    @staticmethod
    def _assigned_names(ir: PlanIR) -> Set[str]:
        """Device names holding any placement (replica, parity share, or
        compute shard) in ``ir`` — the set a spare broker must treat as
        claimed by this tenant."""
        if not ir.N:
            return set()
        used = ir.member.any(axis=0)
        if ir.coding is not None and ir.coding.P:
            used = used | ir.coding.parity_member.any(axis=0)
        return {ir.device_names[n] for n in np.flatnonzero(used)}

    def _spare_candidates(self) -> Optional[Set[str]]:
        """The spare names this shard may claim right now: None (= all
        unassigned) without a broker; otherwise the broker's free set plus
        this plan's own unassigned devices OUTSIDE the broker's pool
        universe — the broker arbitrates only the shared pool, private
        spares stay the tenant's business."""
        if self.spare_broker is None:
            return None
        cand = set(self.spare_broker.candidates(self))
        pool = set(getattr(self.spare_broker, "pool", ()))
        return cand | (set(self.ir.device_names)
                       - self._assigned_names(self.ir) - pool)

    def apply_plan(self, new_ir: PlanIR, *, kind: str = "scale",
                   mapping: Optional[Dict[int, int]] = None,
                   moved: Sequence[str] = ()) -> RepairOutcome:
        """Adopt an externally planned IR — the hook a fleet autoscaler uses
        to grow or shrink this tenant's membership from the shared spare
        pool. Migrates the attached server and settles the spare broker
        exactly as an internally planned repair would (membership-only
        changes keep every jitted portion forward)."""
        new_ir = new_ir.validate()
        if mapping is None:
            mapping = {k: k for k in range(new_ir.K)}
        alive = new_ir.alive_mask(self.down)
        out = RepairOutcome(
            kind=kind, ir=new_ir, mapping=mapping, touched_slots=(),
            rejitted_slots=(), redeployed=len(tuple(moved)),
            moved_devices=tuple(moved),
            feasible=bool(new_ir.quorum(alive).all()),
            objective=new_ir.objective(alive), wall_s=0.0)
        self._apply(out)
        return out

    def _apply(self, out: RepairOutcome) -> None:
        tr, span = self.tracer, None
        if tr is not None:
            # the repair span brackets the whole adoption — server
            # migration, the plan-epoch bump (history append), and the
            # broker settlement — so its seq window certifies ordering
            span = tr.begin(
                out.kind, f"{self.trace_name}controller",
                feasible=bool(out.feasible),
                moved=list(out.moved_devices),
                redeployed=int(out.redeployed),
                reencoded=list(getattr(out, "reencoded_shares", ()) or ()))
        self.ir = out.ir
        if self.server is not None:
            self.server.migrate(out.ir, out.mapping)
        self.history.append(out)
        if tr is not None:
            tr.instant("plan_epoch", span.track, epoch=len(self.history))
        if self.spare_broker is not None:
            now_assigned = self._assigned_names(out.ir)
            claimed = now_assigned - self._broker_view
            # a name that vanished from the IR entirely (permanent loss)
            # is dead, not freed — only still-present columns return to
            # the pool
            freed = ((self._broker_view - now_assigned)
                     & set(out.ir.device_names))
            if claimed or freed:
                self.spare_broker.notify(self, claimed, freed)
            self._broker_view = now_assigned
        if tr is not None:
            tr.end(span, epoch=len(self.history),
                   objective=float(out.objective),
                   wall_s=float(out.wall_s),
                   rejitted=len(out.rejitted_slots))

    def plan_repair(self, alive: np.ndarray, *,
                    spare_candidates: Optional[Set[str]] = None
                    ) -> Optional[RepairOutcome]:
        """Incremental local repair: fill quorum-less slots with spare donor
        devices via a residual Hungarian on the Eq. 1a matrix, warm-started
        from the current plan. Partitions (and therefore portion forwards)
        are untouched; only donor sources and repaired slots re-pick
        students. ``spare_candidates``, when given, is the explicit set of
        unassigned device names this repair may claim (the legacy behavior
        — None — recomputes "alive & unused" internally and assumes it owns
        all of it, which is wrong the moment two shards repair
        concurrently). Returns None when repair is infeasible."""
        t0 = time.perf_counter()
        ir = self.ir
        N = ir.N
        live = ir.member & alive[None, :]
        # quorum-aware: a coded slot whose group can still decode is NOT
        # broken even with its own share down (identical to live.any(1)
        # for replicate slots)
        broken = np.flatnonzero(~ir.quorum(alive))
        if not len(broken) or not N:
            return None
        # a broken compute-coded slot cannot be repaired by donating whole
        # replicas — its members hold 1/k weight shards, and fewer than k
        # live means the re-encode pass above had no source either. Only a
        # full replan (which drops the coding layout) can restore it
        if (ir.compute_coding is not None
                and np.isin(broken, ir.compute_coding.slots).any()):
            return None
        # parity-share devices are busy too: they must not be treated as
        # free donors (stealing one would silently kill the coded share it
        # computes while quorum()/outage still scored it alive)
        assigned = ir.member.any(axis=0)
        if ir.coding is not None and ir.coding.P:
            assigned = assigned | ir.coding.parity_member.any(axis=0)
        slot_of = np.where(ir.member.any(axis=0),
                           ir.member.argmax(axis=0), -1)
        live_counts = live.sum(axis=1)
        dev_idx = np.arange(N)
        in_slot_live = (slot_of >= 0) & live[np.maximum(slot_of, 0), dev_idx]

        # residual cost: latency of each broken slot's warm-start student on
        # each device; ∞ when the student does not fit the device's memory
        stu = ir.student_of[broken]
        params = ir.student_caps[:, 1]
        c_mem = ir.device_caps[:, 1]
        warm_lat = np.where(stu[:, None] >= 0,
                            ir.latency_nd[np.maximum(stu, 0)],
                            ir.latency_nd.min(axis=0)[None, :])   # (B, N)
        warm_par = np.where(stu >= 0, params[np.maximum(stu, 0)],
                            params.min())                          # (B,)
        cost = np.where(warm_par[:, None] <= c_mem[None, :], warm_lat, np.inf)

        # donor pool: unassigned live devices freely; members of a slot only
        # while the source keeps a live replica AND its live Eq. 1f outage
        # stays within p_th after the donation (removing a replica can only
        # raise the outage product, so any subset of this prefix is safe too)
        donors: List[int] = [int(n) for n in dev_idx
                             if alive[n] and not assigned[n]
                             and (spare_candidates is None
                                  or ir.device_names[n] in spare_candidates)]
        p_out_all = ir.device_caps[:, 3]
        min_cost = cost.min(axis=0)
        cc = ir.compute_coding
        for k in range(ir.K):
            if k in broken:
                continue
            # compute-coded slots never donate: every member carries one
            # weight shard, and pulling it would break the 1:1 placement
            if cc is not None and cc.entry_of(k) >= 0:
                continue
            members = [int(n) for n in dev_idx if in_slot_live[n]
                       and slot_of[n] == k]
            members.sort(key=lambda n: min_cost[n])
            remaining = float(np.prod([p_out_all[n] for n in members]))
            for n in members[:-1]:           # always keep one live replica
                without = remaining / max(p_out_all[n], 1e-12)
                if without > ir.p_th:
                    break
                donors.append(n)
                remaining = without
        B = len(broken)
        if len(donors) < B:
            return None
        # prune to the most promising donors to keep the matching tiny
        donors.sort(key=lambda n: min_cost[n])
        donors = donors[:max(4 * B + 8, B)]
        D = len(donors)

        # residual Hungarian: donors × broken slots, maximizing 1/(1+latency)
        n_sq = max(D, B)
        W = np.zeros((n_sq, n_sq))
        Cd = cost[:, donors]                                       # (B, D)
        W[:D, :B] = np.where(np.isfinite(Cd.T), 1.0 / (1.0 + Cd.T), 0.0)
        cols = ASG.hungarian(W)
        picks: Dict[int, int] = {}
        for r in range(D):
            b = int(cols[r])
            if b < B and np.isfinite(Cd[b, r]):
                picks[b] = donors[r]
        if len(picks) < B:
            return None                      # some slot found no viable donor

        used = set(picks.values())
        new_member = np.array(ir.member)
        moved: List[str] = []
        for b, d in picks.items():
            src = int(slot_of[d])
            if src >= 0:
                new_member[src, d] = False
            new_member[int(broken[b]), d] = True
            moved.append(ir.device_names[d])
        # reliability top-up (Eq. 1f on live members) with leftover donors
        p_out = ir.device_caps[:, 3]
        leftovers = [d for d in donors if d not in used]
        for bi, b in enumerate(broken):
            def live_outage() -> float:
                m = new_member[b] & alive
                return float(np.where(m, p_out, 1.0).prod())
            while live_outage() > ir.p_th and leftovers:
                best = min((d for d in leftovers if np.isfinite(cost[bi, d])),
                           key=lambda d: cost[bi, d], default=None)
                if best is None:
                    break
                src = int(slot_of[best])
                if src >= 0:
                    new_member[src, best] = False
                new_member[b, best] = True
                moved.append(ir.device_names[best])
                used.add(best)
                leftovers.remove(best)

        # repair is placement-only: every touched slot keeps its deployed
        # student (the donor cost matrix already enforced the warm-start
        # student fits the matched donors, and a donor source only shrinks,
        # so its student still fits). Re-plan metrics therefore describe
        # exactly what the live server serves. Only student-LESS slots pick
        # a student — they had nothing deployed to keep.
        touched = sorted({int(b) for b in broken}
                         | {int(slot_of[d]) for d in used if slot_of[d] >= 0})
        new_student_of = np.array(ir.student_of)
        empty = [k for k in touched if new_student_of[k] < 0]
        if empty:
            sizes = ir.partition_sizes()
            e_idx = np.asarray(empty, np.int64)
            best_s, _ = ASG.select_students(new_member[e_idx], ir.device_caps,
                                            ir.student_caps, sizes[e_idx],
                                            ir.latency_nd)
            diag = best_s[np.arange(len(empty)), np.arange(len(empty))]
            if (diag < 0).any():
                return None
            new_student_of[e_idx] = diag

        new_ir = ir.with_(member=new_member, student_of=new_student_of)
        live_out = new_ir.group_outage(alive)
        # Eq. 1f must hold for EVERY touched slot — repaired groups and the
        # donor sources alike (a donation may not degrade its source)
        feasible = bool(new_ir.quorum(alive).all()
                        and (live_out[np.asarray(touched, np.int64)]
                             <= ir.p_th).all())
        if not new_ir.quorum(alive).all():
            return None
        if self.require_feasible and not feasible:
            return None                      # let the full replan restore 1f
        return RepairOutcome(
            kind="repair", ir=new_ir,
            mapping={k: k for k in range(new_ir.K)},
            touched_slots=tuple(touched), rejitted_slots=(),
            redeployed=len(used), moved_devices=tuple(moved),
            feasible=feasible, objective=new_ir.objective(alive),
            wall_s=time.perf_counter() - t0)

    def plan_full(self, alive: np.ndarray, *,
                  spare_candidates: Optional[Set[str]] = None
                  ) -> RepairOutcome:
        """Fallback: full Algorithm-1 replan (tune_d_th sweep) on the live
        fleet, embedded back onto the full device axis; distilled students
        redeploy via one-to-one remap_students. With ``spare_candidates``
        set, unassigned devices outside the candidate set are excluded from
        the replan fleet — a shard must not re-partition itself onto spares
        another tenant holds."""
        t0 = time.perf_counter()
        ir = self.ir
        assigned = ir.member.any(axis=0) if ir.N else np.zeros(0, bool)
        if ir.coding is not None and ir.coding.P:
            assigned = assigned | ir.coding.parity_member.any(axis=0)
        devs = [d for i, d in enumerate(ir.devices())
                if alive[i] and (spare_candidates is None or assigned[i]
                                 or d.name in spare_candidates)]
        small = PL.tune_d_th_ir(devs, ir.A, ir.students(), p_th=ir.p_th,
                                seed=self.seed) if devs else None
        if small is None or small.K == 0:
            return RepairOutcome(
                kind="full_replan", ir=ir,
                mapping={k: k for k in range(ir.K)}, touched_slots=(),
                rejitted_slots=(), redeployed=0, moved_devices=(),
                feasible=False, objective=float("inf"),
                wall_s=time.perf_counter() - t0)
        col = {n: i for i, n in enumerate(ir.device_names)}
        member_full = np.zeros((small.K, ir.N), bool)
        for k in range(small.K):
            for j in np.flatnonzero(small.member[k]):
                member_full[k, col[small.device_names[j]]] = True
        # a full replan reshapes groups and partitions wholesale, so any
        # coded layout of the OLD plan is meaningless against the new slot
        # axis — drop it (re-run select_redundancy on the result to re-code)
        new_ir = ir.with_(member=member_full, partition=small.partition,
                          student_of=small.student_of,
                          group_idx=small.group_idx, d_th=small.d_th,
                          coding=None, compute_coding=None)
        mapping = remap_students(ir, new_ir)
        rejit = tuple(
            k for k in range(new_ir.K)
            if mapping.get(k, k) >= ir.K
            or not (new_ir.partition[k] == ir.partition[mapping.get(k, k)]).all())
        # redeployments: devices newly placed, or whose knowledge partition
        # changed (their replica must receive different student weights)
        old_assigned = ir.member.any(axis=0)
        old_slot = np.where(old_assigned, ir.member.argmax(axis=0), -1)
        new_assigned = member_full.any(axis=0)
        new_slot = np.where(new_assigned, member_full.argmax(axis=0), -1)
        redeployed = 0
        for n in range(ir.N):
            if not new_assigned[n]:
                continue
            if not old_assigned[n]:
                redeployed += 1
            elif not (new_ir.partition[new_slot[n]]
                      == ir.partition[old_slot[n]]).all():
                redeployed += 1
        moved = tuple(ir.device_names[n] for n in range(ir.N)
                      if new_assigned[n] and new_slot[n] != old_slot[n])
        return RepairOutcome(
            kind="full_replan", ir=new_ir, mapping=mapping,
            touched_slots=tuple(range(new_ir.K)), rejitted_slots=rejit,
            redeployed=redeployed, moved_devices=moved,
            feasible=small.feasible, objective=new_ir.objective(alive),
            wall_s=time.perf_counter() - t0)
