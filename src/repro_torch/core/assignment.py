"""Student assignment: Kuhn–Munkres optimal matching (RoCoIn §IV-B3).

The 3-D matching (device group × knowledge partition × student arch) is
reduced to bipartite matching: for a fixed (group, partition) pair the best
student is chosen analytically under the group's memory constraint, giving
the edge weight of Eq. 5:

    w(G_k, P_k') = max_{s_j ∈ S_k}  R_j / ( C_para(P_k') · (R_j/c_core + Q_j/r) )

The Hungarian algorithm (O(K³)) then finds the max-weight perfect matching.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.grouping import Device


@dataclasses.dataclass(frozen=True)
class StudentArch:
    """A candidate student model architecture."""
    name: str
    flops: float        # R_j — computation load per inference (FLOPs)
    params: float       # C_j^para — parameter memory (bytes)
    out_bytes: float    # Q_j — output size to transmit (bytes)
    capacity: float     # representational capacity score (≈ params)


def hungarian(weights: np.ndarray) -> np.ndarray:
    """Max-weight square assignment. Returns col index for each row.

    Jonker-Volgenant style O(n³) shortest augmenting path with the inner
    column scans vectorized in numpy (cost = -weights for maximization).
    Tie-breaking matches the scalar reference: the first column achieving
    the minimum reduced cost is expanded.
    """
    w = np.asarray(weights, np.float64)
    n, m = w.shape
    assert n == m, "assignment matrix must be square (pad first)"
    cost = -w
    INF = 1e18
    u = np.zeros(n + 1)
    v = np.zeros(n + 1)
    p = np.zeros(n + 1, np.int64)      # p[j] = row matched to column j
    way = np.zeros(n + 1, np.int64)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n + 1, INF)
        used = np.zeros(n + 1, bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            # relax every free column against the newly-used one at once
            free = ~used
            free[0] = False
            cur = cost[i0 - 1, :] - u[i0] - v[1:]
            better = free[1:] & (cur < minv[1:])
            minv[1:][better] = cur[better]
            way[1:][better] = j0
            # delta = first free column achieving the minimum reduced cost
            masked = np.where(free, minv, INF)
            j1 = int(np.argmin(masked[1:])) + 1
            delta = masked[j1]
            np.add.at(u, p[used], delta)
            v[used] -= delta
            minv[~used] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    ans = np.zeros(n, np.int64)
    for j in range(1, n + 1):
        ans[p[j] - 1] = j - 1
    return ans


def feasible_students(group: Sequence[Device],
                      students: Sequence[StudentArch]) -> List[StudentArch]:
    """S_k ⊂ S: students whose memory fits EVERY device of the group
    (Eq. 1g uses min over the group)."""
    mem = min(d.c_mem for d in group)
    return [s for s in students if s.params <= mem]


def best_student_for(group: Sequence[Device], part_size: float,
                     students: Sequence[StudentArch],
                     cap_scale: Optional[float] = None
                     ) -> Tuple[Optional[StudentArch], float]:
    """Eq. 5 inner max for one (group, partition) pair, with constraint (1h)
    operationalized: a student is *capable* of a partition when its capacity
    covers the partition's knowledge fraction (ε_th threshold). Among capable
    students we minimize latency (Eq. 1a is the outer objective); Eq. 5's
    capacity-to-delay ratio breaks ties / ranks incapable fallbacks. The
    group latency is its *fastest* member (min over devices, Eq. 1a inner).
    """
    S_k = feasible_students(group, students)
    if not S_k:
        return None, 0.0
    cap_scale = cap_scale if cap_scale is not None else max(
        s.capacity for s in students)

    def latency(s: StudentArch) -> float:
        return min(s.flops / d.c_core + 8.0 * s.out_bytes / d.r_tran
                   for d in group)

    def weight(s: StudentArch) -> float:
        return s.capacity / (max(part_size, 1e-9) * max(latency(s), 1e-12))

    req = part_size * cap_scale
    capable = [s for s in S_k if s.capacity >= req]
    if capable:
        best = min(capable, key=latency)       # fastest sufficient student
    else:
        best = max(S_k, key=lambda s: s.capacity)  # closest to capable (1h)
    return best, weight(best)


def assignment_weights(groups: Sequence[Sequence[Device]],
                       part_sizes: Sequence[float],
                       students: Sequence[StudentArch]) -> np.ndarray:
    """w(G_k, P_k') matrix (K×K), Eq. 5."""
    K = len(groups)
    Kp = len(part_sizes)
    W = np.zeros((K, Kp))
    for a, g in enumerate(groups):
        for b, size in enumerate(part_sizes):
            _, W[a, b] = best_student_for(g, size, students)
    return W


def select_students(member: np.ndarray, device_caps: np.ndarray,
                    student_caps: np.ndarray, part_sizes: np.ndarray,
                    latency_nd: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized Eq. 5 over ALL (group, partition) pairs at once.

    member:       (K, N) bool group membership
    device_caps:  (N, 4) ``plan_ir.DEVICE_COLS`` matrix
    student_caps: (S, 4) ``plan_ir.STUDENT_COLS`` matrix
    part_sizes:   (P,) normalized partition knowledge volumes
    latency_nd:   (S, N) precomputed Eq. 1a latency matrix

    Returns ``(best (K, P) int student index, −1 = none feasible;
    W (K, P) Eq. 5 weights)``. Selection reproduces
    :func:`best_student_for` exactly, including catalogue-order
    tie-breaking: among capable students the fastest wins; with no capable
    student the highest-capacity feasible one is the (1h) fallback.
    """
    member = np.asarray(member, bool)
    sizes = np.asarray(part_sizes, np.float64).reshape(-1)
    K, N = member.shape
    S = student_caps.shape[0]
    P = sizes.shape[0]
    if K == 0 or P == 0 or S == 0:
        return np.full((K, P), -1, np.int64), np.zeros((K, P))
    params = student_caps[:, 1]
    capacity = student_caps[:, 3]
    # group aggregates (∞/-∞ for empty groups → nothing feasible)
    min_mem = np.where(member, device_caps[None, :, 1], np.inf).min(axis=1)
    glat = np.where(member[None], latency_nd[:, None, :], np.inf).min(axis=2)
    feasible = (params[:, None] <= min_mem[None, :]) & member.any(1)[None, :]
    cap_scale = capacity.max()
    capable = capacity[:, None] >= sizes[None, :] * cap_scale       # (S, P)
    mask = feasible[:, :, None] & capable[:, None, :]               # (S, K, P)
    lat_cand = np.where(mask, glat[:, :, None], np.inf)
    idx_capable = lat_cand.argmin(axis=0)                           # (K, P)
    any_capable = mask.any(axis=0)
    cap_fb = np.where(feasible, capacity[:, None], -np.inf)
    idx_fb = cap_fb.argmax(axis=0)                                  # (K,)
    has_feasible = feasible.any(axis=0)                             # (K,)
    best = np.where(any_capable, idx_capable, idx_fb[:, None])
    best = np.where(has_feasible[:, None], best, -1)
    safe = np.maximum(best, 0)
    blat = glat[safe, np.arange(K)[:, None]]
    W = np.where(best >= 0,
                 capacity[safe] / (np.maximum(sizes, 1e-9)[None, :]
                                   * np.maximum(blat, 1e-12)),
                 0.0)
    return best.astype(np.int64), W


def match_arrays(W: np.ndarray) -> List[Tuple[int, int]]:
    """KM matching of a (K, P) weight matrix (padded square internally).
    Returns in-range (group, partition) pairs."""
    K, P = W.shape
    n = max(K, P)
    Wp = np.zeros((n, n))
    Wp[:K, :P] = W
    cols = hungarian(Wp)
    return [(g, int(p)) for g, p in enumerate(cols) if g < K and p < P]


def match_groups_to_partitions(groups: Sequence[Sequence[Device]],
                               part_sizes: Sequence[float],
                               students: Sequence[StudentArch]
                               ) -> List[Tuple[int, int, Optional[StudentArch]]]:
    """KM matching → list of (group_idx, partition_idx, chosen_student)."""
    K = max(len(groups), len(part_sizes))
    W = np.zeros((K, K))
    Wreal = assignment_weights(groups, part_sizes, students)
    W[:Wreal.shape[0], :Wreal.shape[1]] = Wreal
    cols = hungarian(W)
    out = []
    for g_idx, p_idx in enumerate(cols):
        if g_idx >= len(groups) or p_idx >= len(part_sizes):
            continue
        student, _ = best_student_for(groups[g_idx], part_sizes[p_idx], students)
        out.append((g_idx, int(p_idx), student))
    return out
