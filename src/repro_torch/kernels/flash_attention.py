"""Causal (or full) GQA prefill attention, flash style.

    q (B, KV, G, Sq, D), k/v (B, KV, Skv, D) → o (B, KV, G, Sq, D)

``o[b, h, g, i] = softmax_j(q·k_j / sqrt(D)) · v`` over the keys ``j <= i``
(causal) or all of them, fp32 inside, in q's dtype. Query head ``h·G + g``
of the model reads kv head ``h``.

:func:`flash_attention` launches the hand-written CUDA kernel
``csrc/flash_attention.cu`` on CUDA tensors and takes the plain version
:func:`flash_attention_ref` only for tensors that lie on the CPU. A failed
build or launch raises; nothing falls back. ``flash_attention.launches``
counts kernel launches (plain-version calls do not count).

On the card the kernel is chosen by dtype and head dim: bf16 at D = 64
and 128 runs both products on the tensor cores (``wgmma``, K/V tiles
staged by TMA; P is rounded to bf16 before P·V, which the plain version
does not do, within the bf16 bound), fp32 and bf16 at D = 32 and 96 the
CUDA-core kernel. q, k and v may be strided views (unit stride on the
last axis only), so the model passes views of its projections without a
copy; the tensor-core kernel reads k and v through TMA, which needs their
base and strides 16-byte aligned (and q's 4-byte aligned), and takes a
contiguous copy of an operand that is not (the model's never needs one).
The output is laid out (B, Sq, KV, G, D) in memory and returned as the
(B, KV, G, Sq, D) view, so the model's ``(B, Sq, H·D)`` reshape is free.
Any Sq and Skv work (the TPU kernel needs multiples of its blocks).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels._layout import (aligned, on_device, stream_handle,
                                         strides)

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 96, 128)        # the kernel's instantiated D
WGMMA_HEAD_DIMS = (64, 128)          # bf16 on the tensor cores
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """Plain version: q (B, KV, G, Sq, D); k, v (B, KV, Skv, D)."""
    Sq, D = q.shape[-2:]
    Skv = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhgqd,bhsd->bhgqs", q.float(), k.float()) * scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None]
        ki = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqs,bhsd->bhgqd", p, v.float()).to(q.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q (B, KV, G, Sq, D) and k, v (B, KV, Skv, D) "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    B, KV, _, _, D = q.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[1] != KV
            or k.shape[3] != D):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one dtype, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, KV, G, Sq, D); k, v: (B, KV, Skv, D), one dtype (f32/bf16).
    Returns (B, KV, G, Sq, D) in q's dtype."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not "
                         f"{q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("all operands must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a unit stride on the last "
                         "axis of q, k and v")
    B, KV, G, Sq, D = q.shape
    Skv = k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    out = torch.empty((B, Sq, KV, G, D), dtype=q.dtype, device=q.device)
    o = out.permute(0, 2, 3, 1, 4)                  # (B, KV, G, Sq, D) view
    if q.numel() == 0:
        return o                                    # no query rows
    if Skv == 0:
        return o.zero_()                            # nothing to attend to
    if q.dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS:
        q = aligned(q, 4)
        k, v = aligned(k, 16), aligned(v, 16)
    lib = _library()
    with on_device(q.device):
        rc = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            *strides(q)[:4], *strides(k)[:3], *strides(v)[:3],
            *o.stride()[:4], B, KV, G, Sq, Skv, D,
            int(causal), 1.0 / math.sqrt(D), int(q.dtype == torch.bfloat16),
            stream_handle(q.device))
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({rc})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("flash_attention")
    lib.flash_attention.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 14 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib
