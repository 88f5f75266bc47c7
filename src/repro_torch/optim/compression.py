"""Weight-only int8 deployment (RoCoIn quantized portion forwards).

The torch twin of ``Int8Weights``/``quantize_weight``/``dequantize_weight``
/``quantize_tree``/``dequantize_tree`` in the JAX package's
``optim/compression.py``. Rounding is half to even on both sides
(``jnp.round``, ``torch.round``) and fp32 division is IEEE on both, so ``q``
and ``scale`` equal the JAX arrays exactly.
Parameter trees are those of :mod:`repro_torch.tree`.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.tree import tree_map


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
