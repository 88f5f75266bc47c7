"""Systematic MDS linear codes over the reals (the coding subsystem's core).

RoCoIn tolerates failures by replicating the same student across a group —
K-fold compute for each nine of resilience. CoCoI (arXiv:2501.06856) and
Hadidi et al.'s coded distributed computing for DNNs (arXiv:2104.04447)
recover from ``r`` losses with only ``r`` extra *coded* shares: a coded
group serving ``k`` knowledge partitions deploys ``n = k + r`` shares, the
first ``k`` *systematic* (the plain portion outputs, directly usable on
arrival) and the last ``r`` *parity* (fixed linear combinations of the
systematic portions). Any ``k`` arrived shares reconstruct every portion.

Constructions
-------------
Both generators are (n, k) with an identity top block (systematic):

  - ``vandermonde``: ``G = V · V_k^{-1}`` for a Vandermonde matrix ``V`` on
    distinct Chebyshev nodes — any k rows of ``V`` are invertible, and
    right-multiplying by ``V_k^{-1}`` preserves that, so the quotient is MDS
    with the numerically best-behaved nodes for small ``k``;
  - ``cauchy``: ``G = [I_k; C]`` with a Cauchy parity block
    ``C_ij = 1 / (x_i + y_j)`` — every square submatrix of a Cauchy matrix
    is nonsingular, the textbook sufficient condition for ``[I; P]`` MDS.

Decoding is a least-squares solve over the arrived generator rows; shares
for arrived systematic symbols pass through EXACTLY (identity rows), so the
pseudo-inverse touches only the erased portions and the failure-free path
is bit-identical to uncoded serving.

All functions here are the pure-numpy reference (``kernels/ref.py`` style);
the fused serving path runs the same math through the Pallas
``coded_decode`` kernel (:mod:`repro.kernels.coded_decode`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np

CONSTRUCTIONS = ("vandermonde", "cauchy")


def _spc_parity(k: int) -> np.ndarray:
    """The single-parity-check row ``1/√k``: for r = 1 it is the
    best-conditioned real MDS parity possible (every decode coefficient has
    unit magnitude), so both constructions use it — int8-quantized share
    transport then decodes within ~1% instead of paying the Vandermonde/
    Cauchy amplification."""
    return np.full((1, k), 1.0 / np.sqrt(k))


def vandermonde_generator(n: int, k: int) -> np.ndarray:
    """(n, k) systematic MDS generator ``V · V_k^{-1}``. The k systematic
    nodes are spread across the whole Chebyshev range and the parity nodes
    interleave them, so parity rows are Lagrange *interpolations* (bounded
    entries) rather than extrapolations — the decode pseudo-inverse stays
    fp32-exact for the r ≤ 3 codes the planner emits."""
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got (n={n}, k={k})")
    if n - k == 1:
        G = np.zeros((n, k))
        G[:k] = np.eye(k)
        G[k:] = _spc_parity(k)
        return G
    pts = np.cos((2 * np.arange(n) + 1) * np.pi / (2 * n))
    sys_idx = np.round(np.linspace(0, n - 1, k)).astype(int)
    par_idx = np.array([i for i in range(n)
                        if i not in set(sys_idx.tolist())], int)
    V = np.vander(pts[np.concatenate([sys_idx, par_idx])], k,
                  increasing=True)                  # (n, k)
    G = V @ np.linalg.inv(V[:k])
    G[:k] = np.eye(k)                               # exact identity top block
    return G


def cauchy_generator(n: int, k: int) -> np.ndarray:
    """(n, k) systematic MDS generator ``[I_k; C]`` with a Cauchy parity
    block (every square submatrix of a Cauchy matrix is nonsingular)."""
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got (n={n}, k={k})")
    r = n - k
    G = np.zeros((n, k))
    G[:k] = np.eye(k)
    if r == 1:
        G[k:] = _spc_parity(k)
    elif r:
        x = np.arange(r, dtype=np.float64)          # parity points
        y = r + np.arange(k, dtype=np.float64) + 0.5  # data points, disjoint
        G[k:] = 1.0 / (x[:, None] + y[None, :])
    return G


@functools.lru_cache(maxsize=256)
def make_generator(n: int, k: int,
                   construction: str = "vandermonde") -> np.ndarray:
    """Cached (n, k) systematic generator; the same (n, k, construction)
    always yields the identical matrix, so encoders and re-encoders built
    at different times agree bit-for-bit."""
    if construction == "vandermonde":
        G = vandermonde_generator(n, k)
    elif construction == "cauchy":
        G = cauchy_generator(n, k)
    else:
        raise ValueError(f"unknown construction {construction!r} "
                         f"(one of {CONSTRUCTIONS})")
    G.setflags(write=False)
    return G


@dataclasses.dataclass(frozen=True)
class MDSCode:
    """One (n, k) systematic MDS code: ``k`` data shares + ``n - k`` parity."""
    n: int
    k: int
    construction: str = "vandermonde"

    @property
    def G(self) -> np.ndarray:
        """The (n, k) systematic generator matrix (identity prefix)."""
        return make_generator(self.n, self.k, self.construction)

    @property
    def r(self) -> int:
        """Number of parity shares, ``n - k``."""
        return self.n - self.k

    def encode(self, data: np.ndarray) -> np.ndarray:
        """Encode stacked data (k, B, F) into shares (n, B, F)."""
        return encode_outputs(self.G, data)

    def decode(self, shares: np.ndarray, arrived: np.ndarray) -> np.ndarray:
        """Recover the data (k, B, F) from any k arrived shares."""
        return decode_outputs(self.G, shares, arrived)


# ---------------------------------------------------------------------------
# encode / decode over stacked portion outputs (numpy reference)
# ---------------------------------------------------------------------------

def encode_outputs(G: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Shares (n, B, F) = G (n, k) applied over stacked portion logits
    (k, B, F). The systematic prefix equals ``data`` exactly."""
    G = np.asarray(G, np.float64)
    n, k = G.shape
    data = np.asarray(data)
    if data.shape[0] != k:
        raise ValueError(f"data has {data.shape[0]} stacked portions, "
                         f"generator expects k={k}")
    out = np.tensordot(G, data.astype(np.float64), axes=(1, 0))
    out[:k] = data                       # identity rows: bit-exact
    return out.astype(data.dtype)


def decode_matrix(G: np.ndarray, arrived: np.ndarray) -> np.ndarray:
    """(k, n) decode operator ``D`` with ``D @ (mask · shares) == data`` for
    any arrival pattern with ≥ k shares. Arrived systematic symbols decode
    through exact identity rows; only erased portions touch the
    pseudo-inverse of the arrived generator rows. Columns of dead shares
    are zero, so ``D`` can be applied to the raw masked share tensor."""
    G = np.asarray(G, np.float64)
    n, k = G.shape
    arrived = np.asarray(arrived, bool).reshape(n)
    if int(arrived.sum()) < k:
        raise ValueError(f"need >= k={k} arrived shares, got "
                         f"{int(arrived.sum())}")
    D = np.zeros((k, n))
    have = arrived[:k]
    D[np.flatnonzero(have), np.flatnonzero(have)] = 1.0
    missing = np.flatnonzero(~have)
    if len(missing):
        rows = np.flatnonzero(arrived)
        X = np.linalg.pinv(G[rows])      # (k, a): X @ G[rows] == I_k
        D[missing[:, None], rows[None, :]] = X[missing]
    return D


def decode_outputs(G: np.ndarray, shares: np.ndarray,
                   arrived: np.ndarray) -> np.ndarray:
    """Recover the k stacked portions (k, B, F) from the (n, B, F) share
    tensor given ≥ k arrivals (non-arrived share rows are ignored)."""
    D = decode_matrix(G, arrived)
    masked = np.where(np.asarray(arrived, bool)[:, None, None], shares, 0.0)
    return np.tensordot(D, masked.astype(np.float64),
                        axes=(1, 0)).astype(shares.dtype)


def arrival_shortfall_prob(p_arrive: np.ndarray, k: int) -> float:
    """P(#arrivals < k) for independent Bernoulli shares — the
    Poisson-binomial tail the planner and Eq. 1f analogue use to size the
    parity budget. O(n·k) dynamic program, exact."""
    p = np.asarray(p_arrive, np.float64).reshape(-1)
    if k <= 0:
        return 0.0
    # dp[j] = P(count == j) for j < k; dp[k] absorbs P(count >= k)
    dp = np.zeros(k + 1)
    dp[0] = 1.0
    for pi in p:
        carry = dp[k] + dp[k - 1] * pi         # saturating top bucket
        dp[1:k] = dp[1:k] * (1.0 - pi) + dp[0:k - 1] * pi
        dp[0] *= (1.0 - pi)
        dp[k] = carry
    return float(dp[:k].sum())
