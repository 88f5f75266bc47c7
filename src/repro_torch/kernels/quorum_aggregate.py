"""RoCoIn quorum aggregation: fused mask → concat → FC merge, on the card.

The source device merges the K student portions (some missing after
failures) with the FC head (paper Fig. 1, runtime phase):

    out (B, C) = Σ_k  mask_k · portion_k (B, Dk) @ (W_k (Dk, C) · s_k)  + bias

:func:`quorum_aggregate` launches the hand-written CUDA kernel
``csrc/quorum_aggregate.cu`` on a CUDA tensor and takes the plain version
:func:`quorum_aggregate_ref` only for tensors that lie on the CPU. A failed
build or launch raises; nothing falls back. ``quorum_aggregate.launches``
counts kernel launches (plain-version calls do not count).

int8 deployment: ``weights`` int8 with per-slot fp32 ``scales`` (K,); the
kernel expands ``q · s_k`` on the way into shared memory.

``block_batch`` (output rows per block) is resolved through the tuning
table (:mod:`repro_torch.kernels.autotune`) unless the caller pins it;
:func:`rows_per_block` clamps it to a legal launch. Every value gives the
same bits.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import autotune, build

MAX_THREADS = 1024      # bm * bn threads, one per output of the tile


def quorum_aggregate_ref(portions: torch.Tensor, weights: torch.Tensor,
                         bias: torch.Tensor, mask: torch.Tensor,
                         scales: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version. portions: (K, B, Dk); weights: (K, Dk, C) fp32 or
    int8; bias: (C,); mask: (K,); scales: optional (K,) dequant scales."""
    m = mask.to(torch.float32)[:, None, None]
    w = weights.to(torch.float32)
    if scales is not None:
        w = w * scales.to(torch.float32)[:, None, None]
    out = torch.einsum("kbd,kdc->bc", portions.to(torch.float32) * m, w)
    return out + bias.to(torch.float32)


def _check(portions, weights, bias, mask, scales) -> None:
    if portions.dim() != 3 or weights.dim() != 3:
        raise ValueError(f"portions (K, B, Dk) and weights (K, Dk, C) "
                         f"expected, got {tuple(portions.shape)} and "
                         f"{tuple(weights.shape)}")
    K, _, Dk = portions.shape
    C = weights.shape[2]
    if tuple(weights.shape[:2]) != (K, Dk):
        raise ValueError(f"weights {tuple(weights.shape)} do not match "
                         f"portions {tuple(portions.shape)}")
    if tuple(bias.shape) != (C,) or tuple(mask.shape) != (K,):
        raise ValueError(f"bias ({C},) and mask ({K},) expected, got "
                         f"{tuple(bias.shape)} and {tuple(mask.shape)}")
    if portions.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("portions and bias must be float32")
    if weights.dtype == torch.int8:
        if scales is None:
            raise ValueError("int8 weights need per-slot fp32 scales")
    elif weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32 or int8, got "
                        f"{weights.dtype}")
    if scales is not None and (scales.dtype != torch.float32
                               or tuple(scales.shape) != (K,)):
        raise ValueError(f"scales must be float32 of shape ({K},)")


def rows_per_block(C: int, block_batch: int) -> int:
    """The kernel's rows per block for ``C`` classes: ``block_batch``
    clamped into [1, 1024 / bn], bn = 16 classes per tile for C <= 16, else
    32 (a stale table entry is a legal launch)."""
    bn = 16 if C <= 16 else 32
    return max(1, min(int(block_batch), MAX_THREADS // bn))


def quorum_aggregate(portions: torch.Tensor, weights: torch.Tensor,
                     bias: torch.Tensor, mask: torch.Tensor,
                     scales: Optional[torch.Tensor] = None, *,
                     block_batch: Optional[int] = None) -> torch.Tensor:
    """portions: (K, B, Dk) f32; weights: (K, Dk, C) f32 or int8; bias:
    (C,) f32; mask: (K,) int32 (1 = portion arrived); scales: (K,) f32,
    required for int8 weights. Returns logits (B, C) f32.
    ``block_batch=None`` consults the tuning table for this shape."""
    _check(portions, weights, bias, mask, scales)
    shape, dtype = autotune.key_quorum_aggregate(portions, weights)
    bm = autotune.resolve("quorum_aggregate", shape, dtype,
                          {"block_batch": block_batch})["block_batch"]
    if portions.device.type == "cpu":
        return quorum_aggregate_ref(portions, weights, bias, mask, scales)
    if portions.device.type != "cuda":
        raise ValueError(f"quorum_aggregate runs on cuda or cpu tensors, "
                         f"not {portions.device}")
    tensors = [weights, bias, mask] + ([scales] if scales is not None else [])
    if any(t.device != portions.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if mask.dtype != torch.int32:
        raise TypeError("mask must be int32 on the card")
    if not all(t.is_contiguous() for t in [portions] + tensors):
        raise ValueError("quorum_aggregate needs contiguous operands")
    K, B, Dk = portions.shape
    C = weights.shape[2]
    out = torch.empty((B, C), dtype=torch.float32, device=portions.device)
    if B == 0:
        return out                     # the merge of nothing: (0, C)
    lib = _library()
    fn = (lib.quorum_aggregate_i8 if weights.dtype == torch.int8
          else lib.quorum_aggregate_f32)
    with torch.cuda.device(portions.device):
        rc = fn(portions.data_ptr(), weights.data_ptr(),
                scales.data_ptr() if scales is not None else None,
                bias.data_ptr(), mask.data_ptr(), out.data_ptr(),
                K, B, Dk, C, rows_per_block(C, bm),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.quorum_aggregate_error_string(rc).decode()
        raise RuntimeError(f"quorum_aggregate launch failed: {msg} ({rc})")
    quorum_aggregate.launches += 1
    return out


quorum_aggregate.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("quorum_aggregate")
    args = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    for fn in (lib.quorum_aggregate_f32, lib.quorum_aggregate_i8):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.quorum_aggregate_error_string.argtypes = [ctypes.c_int]
    lib.quorum_aggregate_error_string.restype = ctypes.c_char_p
    return lib
