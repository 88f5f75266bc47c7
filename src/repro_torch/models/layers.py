"""Layers of the CNN zoo (dense, 2-D convolution, batch norm in eval and
train mode) and of the LM stack (embedding, RMSNorm, LayerNorm, RoPE and
Qwen2-VL's M-RoPE, SwiGLU, GELU).

Activations are NHWC at every public function, as in the JAX package, so
the two compare like with like. Convolution kernels are stored OIHW, the
layout ``F.conv2d`` takes (``convert.params_from_jax`` permutes the JAX
package's HWIO kernels). Inside :func:`conv2d_apply` the NHWC tensor is
handed to ``F.conv2d`` as a channels-last NCHW view, so no activation is
copied to change layout. Initialisers draw from an explicit
``torch.Generator``: on the CPU unless given a ``device`` (the generator
must live there too), so full-width LM weights are drawn on the card.
RMSNorm goes through the hand-written kernel (:func:`ops.rmsnorm`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = Dict[str, Any]


def _trunc_normal(gen: torch.Generator, shape, std: float, *,
                  device=None, dtype=torch.float32) -> torch.Tensor:
    """``std`` times a standard normal truncated to [-2, 2], drawn in fp32
    on ``device`` (the CPU by default) and cast to ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype)


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               use_bias: bool = False, std: Optional[float] = None,
               device=None, dtype=torch.float32) -> Params:
    """A dense layer: (in, out) kernel, std 1/sqrt(in) unless given."""
    std = std if std is not None else 1.0 / math.sqrt(in_dim)
    p = {"kernel": _trunc_normal(gen, (in_dim, out_dim), std, device=device,
                                 dtype=dtype)}
    if use_bias:
        p["bias"] = torch.zeros(out_dim, device=device, dtype=dtype)
    return p


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x (..., in) @ kernel (in, out) + bias``."""
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def embed_init(gen: torch.Generator, vocab: int, dim: int, *, device=None,
               dtype=torch.float32) -> Params:
    """A (vocab, dim) embedding table, std 0.02."""
    return {"embedding": _trunc_normal(gen, (vocab, dim), 0.02, device=device,
                                       dtype=dtype)}


def embed_apply(p: Params, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the table for integer ``ids`` (any shape), through
    ``F.embedding``: the same rows as indexing, and a backward that sums
    each row's gradients in a fixed order (indexing's backward accumulates
    with atomics on the CPU, so two training runs would differ)."""
    return F.embedding(ids, p["embedding"])


def embed_attend(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied-weight logits: (..., d) @ (vocab, d)^T."""
    return x @ p["embedding"].t()


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(dim: int, *, device=None, dtype=torch.float32) -> Params:
    """Unit RMSNorm scale."""
    return {"scale": torch.ones(dim, device=device, dtype=dtype)}


def rmsnorm_apply(p: Params, x: torch.Tensor, *, eps: float = 1e-6
                  ) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · scale`` over the last axis, fp32
    inside, in ``x``'s dtype: the hand-written kernel on the card."""
    return ops.rmsnorm(x, p["scale"], eps=eps)


def layernorm_init(dim: int, *, device=None, dtype=torch.float32) -> Params:
    """Unit scale, zero bias."""
    return {"scale": torch.ones(dim, device=device, dtype=dtype),
            "bias": torch.zeros(dim, device=device, dtype=dtype)}


def layernorm_apply(p: Params, x: torch.Tensor, *, eps: float = 1e-5
                    ) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 inside (plain: no kernel)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings (RoPE / M-RoPE)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, *, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """(head_dim//2,) fp32 inverse frequencies."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def rope_table(positions: torch.Tensor, head_dim: int, *,
               theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (..., seq, 1, head_dim//2) fp32, for ``positions``
    (..., seq). A forward computes it once and every layer reuses it; the
    values are those :func:`apply_rope` computes."""
    freqs = rope_frequencies(head_dim, theta=theta, device=positions.device)
    angles = positions[..., :, None].float() * freqs
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def rotate(x: torch.Tensor, table: Tuple[torch.Tensor, torch.Tensor]
           ) -> torch.Tensor:
    """Rotate the halves of ``x`` (..., seq, heads, head_dim) by a
    :func:`rope_table`, in fp32, back to ``x``'s dtype."""
    cos, sin = table
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    return rotate(x, rope_table(positions, x.shape[-1], theta=theta))


def mrope_table(positions: torch.Tensor, head_dim: int, *,
                sections=(16, 24, 24), theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL's M-RoPE as a (cos, sin) table for :func:`rotate`, each
    (..., seq, 1, head_dim//2) fp32: three position streams (temporal,
    height, width) in ``positions`` (3, ..., seq) rotate disjoint runs of
    frequencies, ``sections`` pairs each (summing to head_dim//2), in
    order. The values are those :func:`apply_mrope` computes."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim // 2 = {half}")
    freqs = rope_frequencies(head_dim, theta=theta, device=positions.device)
    stream = torch.repeat_interleave(
        torch.arange(len(sections), device=positions.device),
        torch.tensor(sections, device=positions.device),
        output_size=half)                                      # (half,)
    angles = positions.float()[stream].movedim(0, -1) * freqs  # (.., seq, half)
    return (torch.cos(angles)[..., :, None, :],
            torch.sin(angles)[..., :, None, :])


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, *,
                sections=(16, 24, 24), theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions_3d: (3, ..., seq)."""
    return rotate(x, mrope_table(positions_3d, x.shape[-1],
                                 sections=sections, theta=theta))


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
# batch norm (eval: running statistics; train: batch statistics)
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


def batchnorm_train(p: Params, x: torch.Tensor, *, momentum: float = 0.9,
                    eps: float = 1e-5) -> Tuple[torch.Tensor, Params]:
    """Normalise the last axis with the batch's mean and biased variance;
    return ``(y, new_stats)``, the running statistics moved to
    ``momentum · old + (1 − momentum) · batch`` (the JAX package's
    ``batchnorm_apply(train=True)``). ``y`` is one ``F.batch_norm`` over
    the channels-last view, with no running buffers: its own update would
    keep the unbiased variance and weigh the batch by ``momentum``. The new
    statistics carry no gradient."""
    dims = tuple(range(x.ndim - 1))
    y = F.batch_norm(x.movedim(-1, 1), None, None, p["scale"], p["bias"],
                     training=True, eps=eps).movedim(1, -1)
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        new = {**p, "mean": momentum * p["mean"] + (1 - momentum) * mean,
               "var": momentum * p["var"] + (1 - momentum) * var}
    return y, new


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) · up``."""
    return F.silu(gate) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")
