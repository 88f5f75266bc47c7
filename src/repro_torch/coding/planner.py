"""Redundancy mode selection: replication vs erasure coding per group.

Algorithm 1 replicates every group (PAPER.md §IV): a group of ``g`` members
pays ``g×`` portion FLOPs to survive ``g - 1`` losses. ``select_redundancy``
is the post-pass that re-spends that budget: it pools slots into coded
groups of up to ``code_k`` partitions, keeps each slot's *fastest* member
as the systematic share (the all-alive Eq. 1a objective is therefore never
worse — decode waits for the k-th fastest share, so parity can even mask
a slow slot and LOWER the objective), frees the remaining replicas, and
re-deploys ``r`` of them as parity shares. A coded-(k + r, k) group
survives any ``r`` share losses at ``(k + r) / k ×`` compute instead of
replication's ``(1 + r)×``.

Mode choice is per candidate group, by minimizing deployed compute over
the Eq. 1a latency matrix under a target survivability: the parity budget
``r`` grows until the group's Poisson-binomial decode-shortfall
probability is no worse than the replicated groups it absorbs (or an
explicit ``parity`` count is given — an opt-in override of that sizing
target), parity devices are drawn from the freed pool by Eq. 1a latency
subject to Eq. 1g memory, and a group stays replicated when its coded
deployment would not be cheaper (adaptive mode), cannot meet the target,
or would break the plan's own Eq. 1f constraint — every coded slot's
shortfall probability (own share misses AND fewer than k other shares
arrive) must stay within ``p_th`` in BOTH modes. Freed devices that fund
no parity share are left unassigned: they become the spare pool the
:class:`~repro.runtime.controller.ClusterController` repairs and
re-encodes from.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.coding.codes import arrival_shortfall_prob
from repro_torch.coding.compute import ComputeCodingSpec
from repro_torch.coding.spec import CodingSpec
from repro_torch.core.plan_ir import PlanIR


def deployed_compute(ir: PlanIR) -> float:
    """Convenience re-export of :meth:`PlanIR.deployed_compute`."""
    return ir.deployed_compute()


def _share_outage(ir: PlanIR, member_row: np.ndarray) -> float:
    """P(a share placed on ``member_row`` misses): Π p_out of its devices."""
    return float(np.where(member_row, ir.device_caps[:, 3], 1.0).prod())


def select_redundancy(ir: PlanIR, *, code_k: int = 4,
                      parity: Optional[int] = None,
                      max_parity: int = 3,
                      min_group: int = 2,
                      construction: str = "vandermonde",
                      mode: str = "output",
                      robustness=None,
                      max_acc_drop: float = 0.01) -> PlanIR:
    """Mode-selection pass: convert replicated groups to coded-(n, k) where
    coding meets the replicated survivability target at lower deployed
    compute. Returns a new :class:`PlanIR` (possibly the input unchanged
    when nothing qualifies); the input must not already carry a coding
    spec.

    Parameters
    ----------
    code_k:    max partitions per coded group (k), or — in ``"compute"``
               mode — the number of data shards each slot's matmul splits
               into.
    parity:    fixed parity-share count per group; ``None`` sizes ``r``
               adaptively (1..max_parity) until the group's decode
               shortfall is ≤ the probability that any of the absorbed
               replicated groups fails.
    min_group: smallest slot pool worth coding (k = 1 degenerates to
               replication).
    mode:      ``"output"`` (default) pools slots into output-coded groups
               with parity devices running whole extra portions
               (:class:`CodingSpec`); ``"compute"`` codes each slot's OWN
               computation — its matmul splits into ``code_k`` shards plus
               ``r`` pre-encoded parity shards, one per member device, and
               the slot completes on the first ``code_k`` shard arrivals
               (:class:`~repro.coding.compute.ComputeCodingSpec`).
    robustness: a measured :class:`~repro.core.failout.RobustnessCurve`
               (accuracy vs #slot losses, exported per trained ensemble).
               When given, replicas the trained-in robustness makes
               redundant are thinned FIRST
               (:func:`repro.core.planner.thin_replicas`, tolerance
               ``max_acc_drop``): a failout-trained ensemble tolerating ℓ
               losses at ≤ ``max_acc_drop`` accuracy drop drops up to one
               replica per group while the plan-level loss tail
               P(> ℓ slot misses) stays within ``p_th`` — and the freed
               devices enlarge the spare pool the parity placement below
               draws from. ``mode="replicate"`` stops after thinning
               (no coding pass).
    """
    if ir.coding is not None or ir.compute_coding is not None:
        raise ValueError("plan already carries a coding spec")
    if robustness is not None:
        from repro_torch.core.planner import thin_replicas
        ir = thin_replicas(ir, robustness, max_acc_drop=max_acc_drop)
    if mode == "replicate":
        return ir
    if mode == "compute":
        return _select_compute(ir, code_k=code_k, parity=parity,
                               max_parity=max_parity,
                               construction=construction)
    if mode != "output":
        raise ValueError(f"unknown redundancy mode {mode!r}")
    K, N = ir.K, ir.N
    if K == 0 or N == 0:
        return ir
    stu = ir.student_of
    if (stu < 0).any():
        return ir                               # student-less slots: bail out
    lat = ir.latency_nd[stu]                    # (K, N) slot-student latency
    member = np.array(ir.member)
    p_out = ir.device_caps[:, 3]
    c_mem = ir.device_caps[:, 1]
    params = ir.student_caps[:, 1]
    flops = ir.student_caps[:, 0]

    # order slots by their (all-alive) Eq. 1a latency so coded groups pool
    # similar-speed partitions — the k-th order statistic under failures
    # then stays close to the group's own replicate degraded latency
    slot_lat = ir.group_latency()
    order = np.argsort(slot_lat, kind="stable")

    group_of = np.full(K, -1, np.int64)
    parity_rows: List[np.ndarray] = []
    parity_group: List[int] = []
    parity_student: List[int] = []
    next_group = 0
    used = member.any(axis=0)
    pool: List[int] = [int(n) for n in range(N) if not used[n]]

    for lo in range(0, K, code_k):
        slots = [int(s) for s in order[lo:lo + code_k]]
        k = len(slots)
        if k < min_group:
            continue
        # keep each slot's fastest member as its systematic share
        kept, freed = [], []
        for s in slots:
            cols = np.flatnonzero(member[s])
            best = int(cols[np.argmin(lat[s, cols])])
            kept.append(best)
            freed.extend(int(c) for c in cols if c != best)
        sys_out = np.array([float(p_out[c]) for c in kept])

        # replicate baseline for this pool: deployed compute and the
        # probability that any absorbed group fails outright (Eq. 1f)
        rep_compute = float(sum(flops[stu[s]] * member[s].sum()
                                for s in slots))
        rep_fail = 1.0 - float(np.prod(
            [1.0 - _share_outage(ir, member[s]) for s in slots]))

        # parity student: the group's most demanding portion (a coded share
        # is a linear combination of the group's portions, so its network is
        # sized like the largest of them — Hadidi-style coded network)
        pstu = int(stu[slots[int(np.argmax(flops[stu[slots]]))]])

        def slot_shortfalls(chosen_cols: List[int]) -> np.ndarray:
            """Per-slot Eq. 1f analogue for the candidate group: P(own
            share misses AND fewer than k of the other shares arrive)."""
            arrive = 1.0 - np.concatenate(
                [sys_out, p_out[np.asarray(chosen_cols, np.int64)]]) \
                if chosen_cols else 1.0 - sys_out
            return np.array([
                sys_out[i] * arrival_shortfall_prob(np.delete(arrive, i), k)
                for i in range(k)])

        # both modes respect the plan's own Eq. 1f constraint: a coded
        # group whose slot shortfall would exceed p_th stays replicated —
        # converting a feasible plan into an infeasible one is never a
        # valid trade for compute. (If the replicate baseline already
        # violates p_th, coding is only held to that existing level.)
        baseline = max(ir.p_th,
                       max(_share_outage(ir, member[s]) for s in slots))
        cand_pool = sorted(set(pool) | set(freed),
                           key=lambda c: float(ir.latency_nd[pstu, c]))
        r_target = parity if parity is not None else max_parity
        chosen: List[int] = []
        ok = False
        for cand in cand_pool:
            if len(chosen) >= r_target:
                break
            if params[pstu] > c_mem[cand]:
                continue                        # Eq. 1g: share must fit
            chosen.append(cand)
            if parity is None and len(chosen) >= 1:
                arrive = 1.0 - np.concatenate(
                    [sys_out, p_out[np.asarray(chosen, np.int64)]])
                if (arrival_shortfall_prob(arrive, k) <= rep_fail
                        and (slot_shortfalls(chosen)
                             <= baseline + 1e-12).all()):
                    ok = True
                    break
        if parity is not None:
            ok = (len(chosen) == parity
                  and (slot_shortfalls(chosen) <= baseline + 1e-12).all())
        if not ok or not chosen:
            continue                            # stays replicated
        coded_compute = float(flops[stu[slots]].sum()
                              + len(chosen) * flops[pstu])
        if parity is None and coded_compute >= rep_compute:
            continue        # adaptive mode: coding must be cheaper; an
            #                 explicit parity count is an opt-in to spend
            #                 compute on survivability replication lacks

        # commit: thin membership to the kept systematic devices, place the
        # parity shares, return unused freed replicas to the spare pool
        for s, keep_col in zip(slots, kept):
            member[s] = False
            member[s, keep_col] = True
            group_of[s] = next_group
        for cand in chosen:
            row = np.zeros(N, bool)
            row[cand] = True
            parity_rows.append(row)
            parity_group.append(next_group)
            parity_student.append(pstu)
        pool = sorted((set(pool) | set(freed)) - set(chosen))
        next_group += 1

    if next_group == 0:
        return ir
    P = len(parity_rows)
    spec = CodingSpec(
        group_of=group_of,
        parity_group=np.asarray(parity_group, np.int64),
        parity_member=(np.stack(parity_rows) if P
                       else np.zeros((0, N), bool)),
        parity_student=np.asarray(parity_student, np.int64),
        construction=construction,
    )
    return ir.with_(member=member, coding=spec).validate()


def _select_compute(ir: PlanIR, *, code_k: int,
                    parity: Optional[int],
                    max_parity: int,
                    construction: str) -> PlanIR:
    """``mode="compute"`` body: per-slot intermediate-computation coding.

    Each slot is treated independently on the Eq. 1a matrix: its candidate
    devices (current replicas plus the unassigned spare pool) are ranked by
    SHARD latency ``latency_nd[stu, c] / k`` (both Eq. 1a terms scale by
    the 1/k output split), the ``k`` fastest fitting devices take the
    systematic shards — so the all-alive first-k arrival set is exactly
    the systematic set and serving passes portions through undecoded —
    and ``r`` more take pre-encoded parity shards. Eq. 1g admits a device
    when ``params[stu] / k`` fits its memory (a shard holds 1/k of the
    weights). Adaptive sizing (``parity=None``) grows ``r`` until the
    coded Eq. 1f shortfall P(< k shards arrive) is within the slot's own
    replicated outage (never past ``p_th`` when the baseline met it) and
    additionally requires the coded deployment to be cheaper (``n/k <``
    replica count) and no slower all-alive than replication. Slots are
    visited slowest-first so stragglers get first pick of the spares;
    replicas a coded slot frees rejoin the pool for later slots.
    """
    K, N = ir.K, ir.N
    if K == 0 or N == 0:
        return ir
    stu = ir.student_of
    if (stu < 0).any():
        return ir                               # student-less slots: bail out
    k = int(code_k)
    if k < 2:
        return ir                               # k = 1 degenerates to replication
    lat = ir.latency_nd[stu]                    # (K, N) slot-student latency
    member = np.array(ir.member)
    p_out = ir.device_caps[:, 3]
    c_mem = ir.device_caps[:, 1]
    params = ir.student_caps[:, 1]
    used = member.any(axis=0)
    pool = set(int(n) for n in range(N) if not used[n])
    order = np.argsort(-ir.group_latency(), kind="stable")

    chosen_slots: List[int] = []
    chosen_mems: List[np.ndarray] = []
    for s in (int(x) for x in order):
        own = [int(c) for c in np.flatnonzero(member[s])]
        if not own:
            continue
        cands = sorted(set(own) | pool, key=lambda c: (float(lat[s, c]), c))
        fits = [c for c in cands if params[stu[s]] / k <= c_mem[c]]
        if len(fits) <= k:
            continue                            # no room for any parity shard
        rep_out = float(np.prod(p_out[np.asarray(own, np.int64)]))
        baseline = max(ir.p_th, rep_out)
        chosen: List[int] = []
        ok = False
        if parity is not None:
            if len(fits) >= k + parity:
                chosen = fits[:k + parity]
                sf = arrival_shortfall_prob(
                    1.0 - p_out[np.asarray(chosen, np.int64)], k)
                ok = sf <= baseline + 1e-12
        else:
            for r in range(1, max_parity + 1):
                if len(fits) < k + r:
                    break
                cand = fits[:k + r]
                sf = arrival_shortfall_prob(
                    1.0 - p_out[np.asarray(cand, np.int64)], k)
                if sf <= baseline + 1e-12:
                    chosen, ok = cand, True
                    break
            if ok:
                n = len(chosen)
                rep_lat = min(float(lat[s, c]) for c in own)
                if n / k >= len(own):           # must be cheaper than replication
                    ok = False
                elif float(lat[s, chosen[k - 1]]) / k > rep_lat + 1e-12:
                    ok = False                  # and no slower all-alive
        if not ok or not chosen:
            continue
        freed = set(own) - set(chosen)
        pool = (pool - set(chosen)) | freed
        member[s] = False
        member[s, np.asarray(chosen, np.int64)] = True
        chosen_slots.append(s)
        chosen_mems.append(np.asarray(chosen, np.int64))

    if not chosen_slots:
        return ir
    order2 = np.argsort(chosen_slots)
    spec = ComputeCodingSpec(
        slots=np.asarray([chosen_slots[i] for i in order2], np.int64),
        k=np.full(len(chosen_slots), k, np.int64),
        shard_member=tuple(chosen_mems[i] for i in order2),
        construction=construction,
    )
    return ir.with_(member=member, compute_coding=spec).validate()
