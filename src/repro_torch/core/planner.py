"""RoCoIn knowledge-assignment planner — Algorithm 1 end-to-end.

Joint decision: device grouping G, filter partition P, student assignment α,
minimizing the Eq. (1a) objective

    max_k  min_{n ∈ G_k}  ( C_j^flops / c_n^core + Q_j / r_n^tran )

subject to coverage (1b–1e), group reliability (1f), memory (1g).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import assignment as ASG
from repro_torch.core import grouping as GRP
from repro_torch.core import ncut as NC
from repro_torch.core.assignment import StudentArch
from repro_torch.core.grouping import Device
from repro_torch.core.hwspec import DeviceSpec
from repro_torch.core.plan_ir import PlanIR, device_matrix, eq1a_latency, student_matrix


@dataclasses.dataclass
class GroupPlan:
    group_idx: int
    devices: List[Device]
    partition_idx: int
    filters: np.ndarray          # filter indices of the knowledge partition
    student: Optional[StudentArch]

    @property
    def latency(self) -> float:
        """min over the group's devices (fastest replica wins), Eq. 1a inner."""
        if self.student is None:
            return float("inf")
        return min(self.student.flops / d.c_core +
                   8.0 * self.student.out_bytes / d.r_tran
                   for d in self.devices)

    @property
    def outage(self) -> float:
        return GRP.group_outage(self.devices)


@dataclasses.dataclass
class Plan:
    groups: List[GroupPlan]
    A: np.ndarray                # the activation graph used
    d_th: float
    p_th: float

    @property
    def K(self) -> int:
        return len(self.groups)

    @property
    def latency(self) -> float:
        """Eq. 1a objective: blocked by the slowest group."""
        if not self.groups:
            return float("inf")
        return max(g.latency for g in self.groups)

    @property
    def feasible(self) -> bool:
        return (all(g.student is not None for g in self.groups)
                and all(g.outage <= self.p_th for g in self.groups))

    def total_params(self) -> float:
        """S-Total: all student replicas, Fig. 4."""
        return sum(g.student.params * len(g.devices)
                   for g in self.groups if g.student)

    def valid_params(self) -> float:
        """S-Valid: one replica per partition, Fig. 4."""
        return sum(g.student.params for g in self.groups if g.student)

    def summary(self) -> Dict:
        return {
            "K": self.K,
            "latency": self.latency,
            "feasible": self.feasible,
            "s_total": self.total_params(),
            "s_valid": self.valid_params(),
            "group_sizes": [len(g.devices) for g in self.groups],
            "students": [g.student.name if g.student else None
                         for g in self.groups],
        }


def partition_sizes(A: np.ndarray, parts: Sequence[np.ndarray]) -> List[float]:
    """C^para(P_k) proxy: knowledge volume of the partition (degree mass),
    normalized so Σ = 1."""
    vols = np.array([NC.volume(A, p) for p in parts], np.float64)
    tot = max(vols.sum(), 1e-12)
    return list(vols / tot)


class _Precomputed:
    """Per-sweep constants of the vectorized planner: device/student capacity
    matrices, the Eq. 1a latency matrix, and the Ncut partition cache keyed
    by K (the candidate × repair sweep of :func:`tune_d_th` previously
    recomputed identical spectral partitions for every d_th)."""

    def __init__(self, devices: Sequence[Device], A: np.ndarray,
                 students: Sequence[StudentArch], seed: int,
                 device_specs: Optional[Sequence[DeviceSpec]] = None):
        self.devices = list(devices)
        self.A = np.asarray(A, np.float64)
        self.students = list(students)
        self.seed = seed
        self.dnames, self.dcaps = device_matrix(self.devices)
        self.snames, self.scaps = student_matrix(self.students)
        self.device_specs = (tuple(device_specs)
                             if device_specs is not None else None)
        self.latency_nd = eq1a_latency(self.scaps, self.dcaps,
                                       self.device_specs)
        self.caps2 = self.dcaps[:, [1, 0]]          # capacity_vec order
        self._parts: Dict[int, List[np.ndarray]] = {}

    def partitions(self, K: int) -> List[np.ndarray]:
        if K not in self._parts:
            self._parts[K] = NC.ncut_partition(self.A, K, seed=self.seed)
        return self._parts[K]


def _plan_from_groups(pre: _Precomputed, groups: List[List[int]],
                      d_th: float, p_th: float) -> PlanIR:
    """Ncut partition (K = #groups) → vectorized Eq. 5 weights → KM matching,
    assembled into the canonical PlanIR (slot k serves partition k)."""
    K = len(groups)
    N, M = len(pre.dnames), pre.A.shape[0]
    parts = pre.partitions(K) if K else []
    Kp = len(parts)
    if Kp == 0:
        return PlanIR(pre.dnames, pre.dcaps, pre.snames, pre.scaps,
                      np.zeros((0, N), bool), np.zeros((0, M), bool),
                      np.zeros(0, np.int64), np.zeros(0, np.int64),
                      pre.latency_nd, pre.A, d_th, p_th,
                      device_specs=pre.device_specs)
    sizes = np.asarray(partition_sizes(pre.A, parts), np.float64)
    member_g = np.zeros((Kp, N), bool)          # groups truncated to Kp, as
    for g, idxs in enumerate(groups[:Kp]):      # in the original Algorithm 1
        member_g[g, idxs] = True
    best, W = ASG.select_students(member_g, pre.dcaps, pre.scaps, sizes,
                                  pre.latency_nd)
    member = np.zeros((Kp, N), bool)
    partition = np.zeros((Kp, M), bool)
    student_of = np.full(Kp, -1, np.int64)
    group_idx = np.zeros(Kp, np.int64)
    for g, p in ASG.match_arrays(W):
        member[p] = member_g[g]
        partition[p, parts[p]] = True
        student_of[p] = best[g, p]
        group_idx[p] = g
    return PlanIR(pre.dnames, pre.dcaps, pre.snames, pre.scaps, member,
                  partition, student_of, group_idx, pre.latency_nd, pre.A,
                  d_th, p_th, device_specs=pre.device_specs)


def make_plan_ir(devices: Sequence[Device], A: np.ndarray,
                 students: Sequence[StudentArch], *, d_th: float,
                 p_th: float, seed: int = 0, repair: bool = False,
                 device_specs: Optional[Sequence[DeviceSpec]] = None,
                 _pre: Optional[_Precomputed] = None) -> PlanIR:
    """Algorithm 1 on the array path: vectorized follow-the-leader grouping →
    Ncut partition (K = #groups) → vectorized Eq. 5 → KM assignment.

    ``device_specs`` (one fitted :class:`DeviceSpec` per device, e.g. from
    :func:`repro.launch.microbench.fleet_specs_from_microbench`) switches
    every Eq. 1a evaluation — student selection, KM weights, the returned
    plan's objective — to the measured latency model."""
    pre = _pre if _pre is not None else _Precomputed(devices, A, students,
                                                     seed, device_specs)
    groups = GRP.follow_the_leader_arrays(pre.caps2, pre.dcaps[:, 3],
                                          d_th, p_th, repair=repair)
    return _plan_from_groups(pre, groups, d_th, p_th)


def make_plan(devices: Sequence[Device], A: np.ndarray,
              students: Sequence[StudentArch], *, d_th: float, p_th: float,
              seed: int = 0, repair: bool = False) -> Plan:
    """Algorithm 1: grouping → Ncut partition (K = #groups) → KM assignment.
    Legacy object-graph view of :func:`make_plan_ir`."""
    ir = make_plan_ir(devices, A, students, d_th=d_th, p_th=p_th, seed=seed,
                      repair=repair)
    return ir.to_plan(devices=devices, students=students)


def tune_d_th_ir(devices: Sequence[Device], A: np.ndarray,
                 students: Sequence[StudentArch], *, p_th: float,
                 candidates: Optional[Sequence[float]] = None,
                 seed: int = 0,
                 device_specs: Optional[Sequence[DeviceSpec]] = None
                 ) -> Optional[PlanIR]:
    """The paper picks d_th 'through trial and error' — sweep candidates and
    keep the feasible plan with the lowest Eq. 1a latency.

    The sweep is batched: capacity/latency matrices are computed once,
    spectral partitions are cached per K, and candidates that reproduce an
    already-evaluated grouping reuse its plan instead of re-running
    assignment (with 12 log-spaced d_th values most candidates collapse to a
    handful of distinct groupings)."""
    if candidates is None:
        candidates = np.geomspace(0.05, 4.0, 12)
    pre = _Precomputed(devices, A, students, seed, device_specs)
    memo: Dict[Tuple[Tuple[int, ...], ...], PlanIR] = {}
    best: Optional[PlanIR] = None
    for repair in (False, True):   # prefer the paper's pure Alg. 1; repair
        for d_th in candidates:    # pass only when nothing feasible (§V)
            groups = GRP.follow_the_leader_arrays(
                pre.caps2, pre.dcaps[:, 3], float(d_th), p_th, repair=repair)
            gkey = tuple(tuple(g) for g in groups)
            ir = memo.get(gkey)
            if ir is None:
                ir = _plan_from_groups(pre, groups, float(d_th), p_th)
                memo[gkey] = ir
            if ir.K == 0:
                continue
            if best is None:
                best = ir
                continue
            key = (not ir.feasible, ir.latency)
            bkey = (not best.feasible, best.latency)
            if key < bkey:
                best = ir
        if best is not None and best.feasible:
            break
    return best


def tune_d_th(devices: Sequence[Device], A: np.ndarray,
              students: Sequence[StudentArch], *, p_th: float,
              candidates: Optional[Sequence[float]] = None,
              seed: int = 0) -> Plan:
    """Legacy object-graph view of :func:`tune_d_th_ir`."""
    ir = tune_d_th_ir(devices, A, students, p_th=p_th,
                      candidates=candidates, seed=seed)
    if ir is None:
        return None
    return ir.to_plan(devices=devices, students=students)


# ---------------------------------------------------------------------------
# robustness-curve-aware replica thinning (failout → placement trade)
# ---------------------------------------------------------------------------

def plan_loss_tail(ir: PlanIR, tolerated: int) -> float:
    """P(more than ``tolerated`` slots miss simultaneously) — the
    survivability measure replica thinning is held to. Exact
    Poisson-binomial over the per-slot Eq. 1f outage probabilities:
    P(fewer than K − tolerated slots arrive)."""
    from repro_torch.coding.codes import arrival_shortfall_prob
    K = ir.K
    if K == 0:
        return 1.0
    arrive = 1.0 - ir.group_outage()
    return arrival_shortfall_prob(arrive, K - min(tolerated, K))


def thin_replicas(ir: PlanIR, curve, *, max_acc_drop: float = 0.01,
                  p_th: Optional[float] = None) -> PlanIR:
    """Trade replicas against trained-in robustness: a failout-trained
    ensemble whose measured :class:`~repro.core.failout.RobustnessCurve`
    shows ≤ ``max_acc_drop`` worst-case accuracy drop at up to ℓ slot
    losses can ship with fewer replicas — losing a slot is no longer a
    failed answer, it is a trained, near-baseline-accuracy answer.

    The per-slot Eq. 1f constraint (every group's outage ≤ p_th) therefore
    relaxes to the PLAN-level survivability target
    :func:`plan_loss_tail` ``(ir, ℓ) ≤ p_th``: the probability that MORE
    slots miss than training hardened against stays within the target the
    replicated plan was built for. Replicas are removed greedily — always
    a group's SLOWEST member, so the all-alive Eq. 1a objective is
    untouched — from the largest groups first, stopping before the tail
    constraint would break; every group keeps ≥ 1 member. Freed devices
    become unassigned spare columns (the controller's repair pool, or
    parity budget for :func:`repro.coding.planner.select_redundancy`).

    Coded plans are returned unchanged — their redundancy is already
    budgeted share-wise; thinning applies to the replicate mode the
    distillation pipeline produces."""
    if ir.coding is not None or ir.compute_coding is not None:
        return ir
    if ir.K == 0 or (ir.student_of < 0).any():
        return ir
    tolerated = int(curve.tolerated(max_acc_drop))
    if tolerated < 1:
        return ir
    target = ir.p_th if p_th is None else float(p_th)
    member = np.array(ir.member)
    lat = ir.latency_nd[ir.student_of]              # (K, N)

    def tail(m: np.ndarray) -> float:
        arrive = 1.0 - np.where(m, ir.device_caps[None, :, 3],
                                1.0).prod(axis=1)
        from repro_torch.coding.codes import arrival_shortfall_prob
        return arrival_shortfall_prob(arrive, ir.K - min(tolerated, ir.K))

    while True:
        sizes = member.sum(axis=1)
        dropped = False
        # largest groups first: they paid the most replication for the
        # failure mode training now covers
        for s in np.argsort(-sizes, kind="stable"):
            if sizes[s] < 2:
                continue
            cols = np.flatnonzero(member[s])
            slowest = int(cols[np.argmax(lat[s, cols])])
            cand = np.array(member)
            cand[s, slowest] = False
            if tail(cand) <= target + 1e-12:
                member = cand
                dropped = True
                break
        if not dropped:
            break
    if member.sum() == ir.member.sum():
        return ir
    return ir.with_(member=member).validate()


# ---------------------------------------------------------------------------
# baselines (§V-A)
# ---------------------------------------------------------------------------

def plan_nonn(devices: Sequence[Device], A: np.ndarray,
              students: Sequence[StudentArch], *, p_th: float = 1.0) -> Plan:
    """NoNN baseline: one device per partition (K = N, no replication),
    uniform partition, every device gets the SAME student — the largest one
    that fits the most constrained device (the straggler bottleneck)."""
    devices = list(devices)
    K = len(devices)
    parts = NC.ncut_partition(np.asarray(A), K)
    mem = min(d.c_mem for d in devices)
    fits = [s for s in students if s.params <= mem]
    student = max(fits, key=lambda s: s.capacity) if fits else None
    plans = [GroupPlan(i, [d], i, parts[i] if i < len(parts) else np.array([], np.int64),
                       student)
             for i, d in enumerate(devices)]
    return Plan(plans, np.asarray(A), 0.0, p_th)


def plan_hetnonn(devices: Sequence[Device], A: np.ndarray,
                 students: Sequence[StudentArch], *, p_th: float = 1.0) -> Plan:
    """HetNoNN baseline: heterogeneity-aware student per device (best student
    fitting EACH device) but no grouping/replication."""
    devices = list(devices)
    K = len(devices)
    parts = NC.ncut_partition(np.asarray(A), K)
    sizes = partition_sizes(A, parts)
    matches = ASG.match_groups_to_partitions([(d,) for d in devices], sizes,
                                             students)
    plans = []
    for g_idx, p_idx, student in matches:
        plans.append(GroupPlan(g_idx, [devices[g_idx]], p_idx, parts[p_idx],
                               student))
    return Plan(plans, np.asarray(A), 0.0, p_th)


def plan_rocoin_g(devices: Sequence[Device], A: np.ndarray,
                  students: Sequence[StudentArch], *, d_th: float,
                  p_th: float, seed: int = 0) -> Plan:
    """RoCoIn-G baseline: same workflow, greedy heuristic assignment instead
    of KM — groups sorted by capacity take partitions sorted by size."""
    grouping = GRP.follow_the_leader(devices, d_th, p_th, seed=seed)
    K = grouping.K
    parts = NC.ncut_partition(np.asarray(A), K, seed=seed)
    K = len(parts)
    sizes = partition_sizes(A, parts)
    cap_order = np.argsort([-min(d.c_core for d in g)
                            for g in grouping.groups[:K]])
    size_order = np.argsort([-s for s in sizes])
    plans = []
    for g_idx, p_idx in zip(cap_order, size_order):
        g = grouping.groups[g_idx]
        student, _ = ASG.best_student_for(tuple(g), sizes[p_idx], students)
        plans.append(GroupPlan(int(g_idx), list(g), int(p_idx), parts[p_idx],
                               student))
    return Plan(plans, np.asarray(A), d_th, p_th)
