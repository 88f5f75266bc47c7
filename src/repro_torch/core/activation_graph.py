"""Filter-activation graph construction (RoCoIn §IV-B2, following NoNN).

For every validation example, the *average activity* ``a_m`` of filter ``m``
is the mean of the corresponding output channel of the teacher's final
convolution layer. The graph weight between filters m, m' is

    A_{mm'} = Σ_val  a_m · a_m' · |a_m − a_m'|

which encourages edges between very-important and less-important filters, so
normalized cut distributes important filters *across* partitions (importance
balancing). The torch twin of the JAX package's module: the same formulas on
tensors, on whatever device the activities lie.
"""
from __future__ import annotations

import numpy as np
import torch


def average_activity(feature_maps: torch.Tensor) -> torch.Tensor:
    """Per-example average activity of each channel.

    feature_maps: (N, H, W, C) conv outputs or (N, S, C) sequence hiddens or
    (N, C) already-pooled. Returns (N, C) nonnegative fp32 activities.
    """
    x = torch.as_tensor(feature_maps)
    if x.ndim == 4:
        act = torch.relu(x).mean(dim=(1, 2))
    elif x.ndim == 3:
        act = x.abs().mean(dim=1)
    elif x.ndim == 2:
        act = x.abs()
    else:
        raise ValueError(f"unsupported feature rank {x.ndim}")
    return act.float()


def activation_graph(activities: torch.Tensor) -> torch.Tensor:
    """Build the weighted adjacency A (M×M) from per-example activities (N,M).

    A_{mm'} = Σ_n a_nm · a_nm' · |a_nm − a_nm'|, zero diagonal, symmetric.
    The (N, M, M) product is formed whole, as in the JAX package.
    """
    a = torch.as_tensor(activities).float()               # (N, M)
    prod = a[:, :, None] * a[:, None, :]                 # a_m · a_m'
    diff = (a[:, :, None] - a[:, None, :]).abs()         # |a_m − a_m'|
    A = (prod * diff).sum(dim=0)
    A = 0.5 * (A + A.T)
    M = A.shape[0]
    return A * (1.0 - torch.eye(M, dtype=A.dtype, device=A.device))


def degree(A: torch.Tensor) -> torch.Tensor:
    """Node degrees z_m = Σ_m' A_{mm'}."""
    return A.sum(dim=1)


def filter_importance(activities: torch.Tensor) -> np.ndarray:
    """Mean activity per filter — used as the knowledge-size weight."""
    return torch.as_tensor(activities).mean(dim=0).cpu().numpy()
