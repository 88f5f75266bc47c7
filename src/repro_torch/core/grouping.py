"""Device grouping: modified follow-the-leader clustering (RoCoIn §IV-B1).

Devices with similar capacity (Euclid distance over (c_mem, c_core), Eq. 2)
and satisfactory *cumulative* transmission reliability are grouped to act as
replicas of each other. Group reliability constraint (Eq. 1f):

    Π_{n ∈ G_k} p_n^out ≤ p^th

i.e. the probability that EVERY member of the group fails its transmission
must not exceed p^th.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Device:
    """Edge-device resource profile (paper Table I tuple)."""
    name: str
    c_core: float      # FLOP/s budget
    c_mem: float       # memory budget, bytes
    r_tran: float      # transmission rate to the source, bit/s
    p_out: float       # transmission outage probability ∈ (0,1)

    def capacity_vec(self) -> np.ndarray:
        return np.array([self.c_mem, self.c_core], np.float64)


def similarity(a: Device, b: Device, scale: Optional[np.ndarray] = None) -> float:
    """Eq. 2 — Euclid distance of capacity vectors (optionally normalized)."""
    va, vb = a.capacity_vec(), b.capacity_vec()
    if scale is not None:
        va, vb = va / scale, vb / scale
    return float(np.sqrt(((va - vb) ** 2).sum()))


def group_outage(devices: Sequence[Device]) -> float:
    """Π p_n^out — probability that the whole group fails."""
    p = 1.0
    for d in devices:
        p *= d.p_out
    return p


@dataclasses.dataclass
class Grouping:
    groups: List[List[Device]]

    @property
    def K(self) -> int:
        return len(self.groups)

    def centroids(self) -> np.ndarray:
        return np.stack([np.mean([d.capacity_vec() for d in g], axis=0)
                         for g in self.groups])


def follow_the_leader_arrays(caps: np.ndarray, p_out: np.ndarray,
                             d_th: float, p_th: float, *,
                             normalize: bool = True,
                             repair: bool = False) -> List[List[int]]:
    """Array-backed follow-the-leader (Alg. 1 lines 1–11) over a ``(N, 2)``
    capacity matrix (``capacity_vec`` order: ``c_mem, c_core``) and an
    ``(N,)`` outage vector. Returns groups as device-index lists.

    The greedy scan is inherently sequential, but each step is vectorized:
    one fused distance computation against ALL group centroids and an O(1)
    running-product outage update per placement — O(N·K) numpy work instead
    of the legacy O(N·K·|G|) Python loops. Semantics (first matching group,
    centroid = mean of members, outage product in insertion order) are
    identical to the object path, which now delegates here.
    """
    caps = np.asarray(caps, np.float64).reshape(-1, 2)
    p_out = np.asarray(p_out, np.float64).reshape(-1)
    N = caps.shape[0]
    if N == 0:
        return []
    scale = (np.maximum(caps.std(axis=0), 1e-9) if normalize
             else np.ones(2, np.float64))

    members: List[List[int]] = [[0]]
    cents = np.empty((N, 2), np.float64)    # centroid buffer, first K rows live
    cents[0] = caps[0]
    outage = np.empty(N, np.float64)        # running Π p_out per group
    outage[0] = p_out[0]
    K = 1

    for i in range(1, N):
        v = caps[i]
        dist = np.sqrt((((cents[:K] - v) / scale) ** 2).sum(axis=1))
        ok = (dist <= d_th) & (outage[:K] > p_th)
        if ok.any():
            gi = int(np.argmax(ok))         # first matching group, as legacy
            members[gi].append(i)
            cents[gi] = caps[members[gi]].mean(axis=0)
            outage[gi] *= p_out[i]
        else:
            members.append([i])
            cents[K] = v
            outage[K] = p_out[i]
            K += 1

    if repair:
        # Beyond-paper repair pass: Alg. 1 can strand a high-outage device as
        # a singleton once every other group already satisfies (1f) — the
        # paper acknowledges the resulting infeasibility (§V). Merge each
        # violating group into its nearest neighbour until (1f) holds
        # everywhere or one group remains.
        while len(members) > 1:
            bad = np.flatnonzero(outage[:len(members)] > p_th)
            if not len(bad):
                break
            gi = int(bad[0])
            cent = np.stack([caps[g].mean(axis=0) for g in members])
            dist = np.sqrt((((cent - cent[gi]) / scale) ** 2).sum(axis=1))
            dist[gi] = np.inf
            tgt = int(np.argmin(dist))
            members[tgt].extend(members[gi])
            out = 1.0
            for idx in members[tgt]:        # insertion-order product, as legacy
                out *= p_out[idx]
            outage[tgt] = out
            del members[gi]
            outage[gi:len(members)] = outage[gi + 1:len(members) + 1].copy()
    return members


def follow_the_leader(devices: Sequence[Device], d_th: float, p_th: float,
                      *, normalize: bool = True, seed: int = 0,
                      repair: bool = False) -> Grouping:
    """Alg. 1 lines 1–11. Iteratively add each device to the first group whose
    centroid is within d_th — but only while the group's cumulative outage is
    still ABOVE p_th (a group that already satisfies its reliability target
    stops absorbing replicas, freeing devices to form new groups). Devices
    matching no group start a new one. Thin object wrapper around
    :func:`follow_the_leader_arrays` (the hot path).
    """
    devices = list(devices)
    if not devices:
        return Grouping([])
    caps = np.stack([d.capacity_vec() for d in devices])
    p_out = np.array([d.p_out for d in devices], np.float64)
    idx_groups = follow_the_leader_arrays(caps, p_out, d_th, p_th,
                                          normalize=normalize, repair=repair)
    return Grouping([[devices[i] for i in g] for g in idx_groups])


def grouping_feasible(grouping: Grouping, p_th: float) -> bool:
    """Eq. 1f for every group."""
    return all(group_outage(g) <= p_th for g in grouping.groups)
