"""Fused weight-dequant matmul ``y = x @ (q · scale)`` with int8 ``q``.

Weight-only int8 quantization (a per-tensor or per-output-channel fp32
scale) cuts the weight stream of a portion forward 4x; fusing the dequant
into the matmul means only the int8 bytes cross device memory and the fp32
expansion lives in shared memory.

:func:`dequant_matmul` launches the hand-written CUDA kernel
``csrc/dequant_matmul.cu`` on a CUDA tensor and takes the plain version
:func:`dequant_matmul_ref` only for tensors that lie on the CPU. A failed
build or launch raises; nothing falls back. ``dequant_matmul.launches``
counts kernel launches (plain-version calls do not count).

The output tile ``(block_batch, block_n)`` is resolved through the tuning
table (:mod:`repro_torch.kernels.autotune`) unless the caller pins it, and
:func:`tiles` clamps it to a legal launch: a tile changes which block owns
an output, never the order of its sum, so every tile gives the same bits.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import autotune, build
from repro_torch.kernels._layout import on_device, stream_handle

MAX_TILE = 128          # the kernel's largest block_batch and block_n


def dequant_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """Plain version. x: (B, D); q: (D, N) int8; scale: () or (N,) fp32."""
    w = q.to(torch.float32) * torch.as_tensor(scale, dtype=torch.float32,
                                              device=q.device)
    return x.to(torch.float32) @ w


def tiles(B: int, N: int, block_batch: int, block_n: int) -> Tuple[int, int]:
    """The (rows, columns) of one block's output tile: each clamped into
    [1, min(dim, MAX_TILE)], so a zero, negative or oversized request (a
    stale table entry for a shape that shrank) is a legal launch."""
    return (max(1, min(int(block_batch), B, MAX_TILE)),
            max(1, min(int(block_n), N, MAX_TILE)))


def _check(x, q, scale) -> None:
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"x (B, D) and q (D, N) expected, got "
                         f"{tuple(x.shape)} and {tuple(q.shape)}")
    if x.dtype != torch.float32 or q.dtype != torch.int8:
        raise TypeError(f"x must be float32 and q int8, got {x.dtype} and "
                        f"{q.dtype}")
    if scale.dtype != torch.float32 or tuple(scale.shape) not in (
            (), (q.shape[1],)):
        raise ValueError(f"scale must be float32 of shape () or "
                         f"({q.shape[1]},), got {scale.dtype} "
                         f"{tuple(scale.shape)}")


def dequant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                   block_batch: Optional[int] = None,
                   block_n: Optional[int] = None) -> torch.Tensor:
    """x: (B, D) f32; q: (D, N) int8; scale: () per-tensor or (N,)
    per-output-channel f32. Returns (B, N) f32. ``None`` blocks consult the
    tuning table for this shape."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    _check(x, q, scale)
    shape, dtype = autotune.key_dequant_matmul(x, q)
    blocks = autotune.resolve("dequant_matmul", shape, dtype,
                              {"block_batch": block_batch,
                               "block_n": block_n})
    if x.device.type == "cpu":
        return dequant_matmul_ref(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"dequant_matmul runs on cuda or cpu tensors, not "
                         f"{x.device}")
    if q.device != x.device or scale.device != x.device:
        raise ValueError("all operands must be on one device")
    if not (x.is_contiguous() and q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("dequant_matmul needs contiguous operands")
    B, D = x.shape
    N = q.shape[1]
    out = torch.empty((B, N), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out                     # B == 0: (0, N)
    bb, bn = tiles(B, N, blocks["block_batch"], blocks["block_n"])
    lib = _library()
    with on_device(x.device):
        rc = lib.dequant_matmul_f32(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            B, D, N, bb, bn, int(scale.dim() == 1),
            stream_handle(x.device))
    if rc != 0:
        msg = lib.dequant_matmul_error_string(rc).decode()
        raise RuntimeError(f"dequant_matmul launch failed at (B, D, N) = "
                           f"({B}, {D}, {N}), tile {bb} x {bn}: {msg} "
                           f"({rc})")
    dequant_matmul.launches += 1
    return out


dequant_matmul.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared."""
    lib = build.load("dequant_matmul")
    lib.dequant_matmul_f32.argtypes = ([ctypes.c_void_p] * 4
                                       + [ctypes.c_int] * 6
                                       + [ctypes.c_void_p])
    lib.dequant_matmul_f32.restype = ctypes.c_int
    lib.dequant_matmul_error_string.argtypes = [ctypes.c_int]
    lib.dequant_matmul_error_string.restype = ctypes.c_char_p
    return lib
