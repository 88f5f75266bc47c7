"""Eval-mode layers of the CNN zoo: dense, 2-D convolution, batch norm.

Activations are NHWC at every public function, as in the JAX package, so
the two compare like with like. Convolution kernels are stored OIHW, the
layout ``F.conv2d`` takes (``convert.params_from_jax`` permutes the JAX
package's HWIO kernels). Inside :func:`conv2d_apply` the NHWC tensor is
handed to ``F.conv2d`` as a channels-last NCHW view, so no activation is
copied to change layout. Initialisers draw from an explicit
``torch.Generator`` on the CPU; the caller moves the tree to its device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def _trunc_normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    """``std`` times a standard normal truncated to [-2, 2]."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * std


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               use_bias: bool = False, std: Optional[float] = None) -> Params:
    """A dense layer: (in, out) kernel, std 1/sqrt(in) unless given."""
    std = std if std is not None else 1.0 / math.sqrt(in_dim)
    p = {"kernel": _trunc_normal(gen, (in_dim, out_dim), std)}
    if use_bias:
        p["bias"] = torch.zeros(out_dim)
    return p


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x (..., in) @ kernel (in, out) + bias``."""
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


# ---------------------------------------------------------------------------
# conv
# ---------------------------------------------------------------------------

def conv2d_init(gen: torch.Generator, in_ch: int, out_ch: int, ksize: int, *,
                groups: int = 1) -> Params:
    """A conv kernel (out, in/groups, k, k), He-scaled."""
    fan_in = in_ch // groups * ksize * ksize
    std = math.sqrt(2.0 / fan_in)
    return {"kernel": _trunc_normal(gen, (out_ch, in_ch // groups, ksize,
                                          ksize), std)}


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: the extra pixel (odd total)
    goes after, not before."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_apply(p: Params, x: torch.Tensor, *, stride: int = 1,
                 groups: int = 1) -> torch.Tensor:
    """x: (B, H, W, Cin) → (B, H', W', Cout), "SAME" padding."""
    w = p["kernel"]                               # (Cout, Cin/groups, kh, kw)
    h = x.permute(0, 3, 1, 2)                     # NCHW view, channels last
    (t, b), (l, r) = (_same_pad(x.shape[1], w.shape[2], stride),
                      _same_pad(x.shape[2], w.shape[3], stride))
    if t == b and l == r:
        y = F.conv2d(h, w, stride=stride, padding=(t, l), groups=groups)
    else:
        y = F.conv2d(F.pad(h, (l, r, t, b)), w, stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# batch norm (eval: running statistics)
# ---------------------------------------------------------------------------

def batchnorm_init(ch: int) -> Params:
    """Identity batch norm: unit scale and variance, zero bias and mean."""
    return {"scale": torch.ones(ch), "bias": torch.zeros(ch),
            "mean": torch.zeros(ch), "var": torch.ones(ch)}


def batchnorm_apply(p: Params, x: torch.Tensor, *, eps: float = 1e-5
                    ) -> torch.Tensor:
    """Normalise the last axis with the running statistics."""
    y = (x - p["mean"]) * torch.rsqrt(p["var"] + eps)
    return y * p["scale"] + p["bias"]
