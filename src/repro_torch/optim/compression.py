"""Gradient compression for the data-parallel all-reduce, and weight-only
int8 deployment (RoCoIn quantized portion forwards).

The torch twin of the JAX package's ``optim/compression.py``. Gradient
compression has two schemes, both with error feedback (the residual
re-enters the next step so compression bias does not accumulate):

  - top-k sparsification: keep the k largest-magnitude entries per tensor,
  - int8 stochastic quantization: per-tensor scale, round-to-nearest with
    dithering. The dither is uniform in [-0.5, 0.5) from a
    ``torch.Generator`` seeded by ``(cfg.seed, step)`` (the reference
    folds the step into a ``jax.random`` key), so its bits differ from the
    reference's; the invariants (``c + r' = g + r``, values on the scale's
    grid, ``|c / scale| <= 127``) are the same.

For deployment, ``Int8Weights``/``quantize_weight``/``dequantize_weight``
/``quantize_tree``/``dequantize_tree``: rounding is half to even on both
sides (``jnp.round``, ``torch.round``) and fp32 division is IEEE on both,
so ``q`` and ``scale`` equal the JAX arrays exactly.
Parameter trees are those of :mod:`repro_torch.tree`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "none"          # none | topk | int8
    topk_ratio: float = 0.01      # keep 1% of entries
    seed: int = 0


class CompressionState(NamedTuple):
    residual: Any                 # error-feedback memory (grad-shaped tree)
    step: torch.Tensor


def init_state(cfg: CompressionConfig, grads_like: Any) -> CompressionState:
    return CompressionState(tree_map(torch.zeros_like, grads_like),
                            torch.zeros((), dtype=torch.int32))


def _topk_compress(g: torch.Tensor, ratio: float) -> torch.Tensor:
    """Zero all but the top-k |entries| (dense masked representation; the
    wire format would be (values, indices)); ties at the threshold are all
    kept, as in the reference."""
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * ratio))
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = flat.abs() >= thresh
    return (flat * mask).reshape(g.shape)


class Int8Weights(NamedTuple):
    """A weight tensor stored as int8 values + fp32 scale(s).

    ``scale`` is a scalar for a per-tensor quantized weight, or a (K,)
    vector when ``q`` carries a leading stacked-student axis (one scale per
    slot — the layout :func:`repro_torch.kernels.ops.quorum_aggregate` and
    the fused serving step consume)."""
    q: torch.Tensor        # int8, same shape as the source weight
    scale: torch.Tensor    # f32, () or (q.shape[0],)


def _int8_scale(w: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
    """Symmetric per-tensor scale (``axis=None``) or one scale per slice
    along ``axis``."""
    a = w.to(torch.float32).abs()
    if axis is None:
        amax = a.max()
    else:
        amax = a.movedim(axis, 0).reshape(w.shape[axis], -1).amax(dim=1)
    return torch.clamp(amax, min=1e-12) / 127.0


def _int8_compress(g: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    scale = _int8_scale(g)
    noise = torch.rand(g.shape, generator=gen, dtype=torch.float32,
                       device=g.device) - 0.5
    q = torch.clamp(torch.round(g / scale + noise), -127, 127
                    ).to(torch.int8)
    return q.to(torch.float32) * scale


def _expand(scale: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = scale.shape[0]
    return scale.reshape(shape)


def quantize_weight(w: torch.Tensor, axis: Optional[int] = None
                    ) -> Int8Weights:
    """Deterministic round-to-nearest weight quantization."""
    scale = _int8_scale(w, axis)
    s = scale if axis is None else _expand(scale, w.dim(), axis)
    q = torch.clamp(torch.round(w.to(torch.float32) / s), -127, 127
                    ).to(torch.int8)
    return Int8Weights(q, scale)


def dequantize_weight(wq: Int8Weights, axis: Optional[int] = None
                      ) -> torch.Tensor:
    """Inverse of :func:`quantize_weight`. ``axis`` must match the axis the
    weight was quantized along; a scale whose length does not match that
    axis raises instead of broadcasting along the wrong one."""
    s = wq.scale
    if s.dim():
        ax = 0 if axis is None else axis
        if s.shape[0] != wq.q.shape[ax]:
            raise ValueError(
                f"scale of length {s.shape[0]} does not match axis {ax} of "
                f"the int8 weight {tuple(wq.q.shape)} — pass the axis it "
                f"was quantized along")
        s = _expand(s, wq.q.dim(), ax)
    return wq.q.to(torch.float32) * s


def quantize_tree(params: Any, axis: Optional[int] = None) -> Any:
    """Quantize every floating-point tensor of a tree to
    :class:`Int8Weights` (other leaves pass through untouched)."""
    def one(w):
        if isinstance(w, torch.Tensor) and w.is_floating_point():
            return quantize_weight(w, axis)
        return w
    return tree_map(one, params)


def dequantize_tree(params: Any) -> Any:
    """Inverse of :func:`quantize_tree`: expand Int8Weights leaves back to
    fp32 (the serving step runs this on the card, so device memory holds
    int8 between batches)."""
    return tree_map(
        lambda w: dequantize_weight(w) if isinstance(w, Int8Weights) else w,
        params)


def dither_generator(cfg: CompressionConfig, step: int,
                     device: torch.device) -> torch.Generator:
    """The int8 dither's generator for ``step``: seeded by
    ``(cfg.seed, step)`` through numpy's ``SeedSequence``."""
    seed = int(np.random.SeedSequence((cfg.seed, step)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def compress_grads(cfg: CompressionConfig, grads: Any,
                   state: CompressionState) -> Tuple[Any, CompressionState]:
    """Apply error-feedback compression. Returns (compressed_grads, state');
    the residual tree is a new one, the input trees are left as they are."""
    if cfg.scheme == "none":
        return grads, state
    step = state.step + 1
    gen = None
    if cfg.scheme == "int8":
        gen = dither_generator(cfg, int(step), tree_leaves(grads)[0].device)
    resid = []

    def one(g, r):
        gf = g.to(torch.float32) + r.to(torch.float32)
        if cfg.scheme == "topk":
            c = _topk_compress(gf, cfg.topk_ratio)
        elif cfg.scheme == "int8":
            c = _int8_compress(gf, gen)
        else:
            raise KeyError(cfg.scheme)
        resid.append((gf - c).to(r.dtype))
        return c.to(g.dtype)

    comp = tree_map(one, grads, state.residual)
    rest = iter(resid)                 # tree_map visits in the same order
    return comp, CompressionState(tree_map(lambda _: next(rest), grads),
                                  step)


def compression_ratio(cfg: CompressionConfig) -> float:
    """Wire-bytes multiplier vs dense fp32 all-reduce (for the roofline's
    collective term)."""
    if cfg.scheme == "topk":
        return cfg.topk_ratio * 2.0   # values + indices
    if cfg.scheme == "int8":
        return 0.25
    return 1.0
