"""Normalized-cut spectral partitioning (RoCoIn Eq. 3–4, Alg. 1 lines 12–18).

Relaxed Ncut: columns of H = the K eigenvectors of L_sym = Z^{-1/2} L Z^{-1/2}
with smallest eigenvalues; rows of H clustered with K-means (row-normalized,
as in Ng-Jordan-Weiss) → filter partitions P_1..P_K.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def normalized_laplacian(A: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    A = np.asarray(A, np.float64)
    z = A.sum(axis=1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(z, eps))
    L = np.diag(z) - A
    return d_inv_sqrt[:, None] * L * d_inv_sqrt[None, :]


def _kmeans(X: np.ndarray, k: int, seed: int = 0, iters: int = 100,
            balanced: bool = True) -> np.ndarray:
    """Plain K-means with k-means++ init; optionally capacity-balanced
    assignment (each cluster ≤ ceil(M/k) — keeps partitions non-empty and
    near-equal, matching the paper's balance goal)."""
    rng = np.random.default_rng(seed)
    M = X.shape[0]
    # k-means++ init
    centers = [X[rng.integers(M)]]
    for _ in range(1, k):
        d2 = np.min([((X - c) ** 2).sum(1) for c in centers], axis=0)
        p = d2 / max(d2.sum(), 1e-12)
        centers.append(X[rng.choice(M, p=p)])
    C = np.stack(centers)
    cap = int(np.ceil(M / k))
    labels = np.zeros(M, np.int64)
    for _ in range(iters):
        d2 = ((X[:, None, :] - C[None]) ** 2).sum(-1)  # (M,k)
        if balanced:
            new = np.full(M, -1, np.int64)
            counts = np.zeros(k, np.int64)
            order = np.argsort(d2.min(axis=1))  # most-confident first
            for i in order:
                for c in np.argsort(d2[i]):
                    if counts[c] < cap:
                        new[i] = c
                        counts[c] += 1
                        break
            labels_new = new
        else:
            labels_new = d2.argmin(1)
        if np.array_equal(labels_new, labels):
            break
        labels = labels_new
        for c in range(k):
            pts = X[labels == c]
            if len(pts):
                C[c] = pts.mean(0)
    return labels


def ncut_partition(A: np.ndarray, K: int, seed: int = 0,
                   balanced: bool = True) -> List[np.ndarray]:
    """Partition the M filters of graph A into K groups. Returns a list of K
    index arrays (some may be empty only if K > M)."""
    A = np.asarray(A, np.float64)
    M = A.shape[0]
    K = min(K, M)
    if K <= 1:
        return [np.arange(M)]
    Lsym = normalized_laplacian(A)
    w, v = np.linalg.eigh(Lsym)           # ascending eigenvalues
    H = v[:, :K]                          # M×K indicator relaxation
    norms = np.linalg.norm(H, axis=1, keepdims=True)
    H = H / np.maximum(norms, 1e-12)
    labels = _kmeans(H, K, seed=seed, balanced=balanced)
    return [np.where(labels == c)[0] for c in range(K)]


def cut_weight(A: np.ndarray, part_a: np.ndarray, part_b: np.ndarray) -> float:
    """W(P_a, P_b) = Σ_{m∈a, m'∈b} A_{mm'}."""
    return float(A[np.ix_(part_a, part_b)].sum())


def volume(A: np.ndarray, part: np.ndarray) -> float:
    """vol(P) = Σ_{m∈P} z_m."""
    return float(A[part].sum())


def ncut_value(A: np.ndarray, parts: List[np.ndarray]) -> float:
    """Ncut(P_1..P_K) = ½ Σ_k W(P_k, ~P_k)/vol(P_k)  (Eq. 3)."""
    M = A.shape[0]
    total = 0.0
    allidx = np.arange(M)
    for p in parts:
        if len(p) == 0:
            continue
        comp = np.setdiff1d(allidx, p, assume_unique=False)
        vol = volume(A, p)
        if vol <= 0:
            continue
        total += cut_weight(A, p, comp) / vol
    return 0.5 * total
