"""Fused RMSNorm: ``x · rsqrt(mean(x²) + eps) · scale`` over the last axis.

:func:`rmsnorm` launches the hand-written CUDA kernel ``csrc/rmsnorm.cu``
on a CUDA tensor (one block per row, one read and one write of every
element, fp32 inside) and takes the plain version :func:`rmsnorm_ref` only
for tensors that lie on the CPU. A failed build or launch raises; nothing
falls back. ``rmsnorm.launches`` counts kernel launches (plain-version
calls do not count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-6) -> torch.Tensor:
    """Plain version: fp32 inside, the result in ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dim() < 1 or scale.dim() != 1 or scale.shape[0] != x.shape[-1]:
        raise ValueError(f"x (..., D) and scale (D,) expected, got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"x and scale must be float32 or bfloat16, got "
                        f"{x.dtype} and {scale.dtype}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D) f32/bf16; scale: (D,) f32/bf16. Returns x's shape and
    dtype."""
    _check(x, scale)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cuda or cpu tensors, not "
                         f"{x.device}")
    if scale.device != x.device:
        raise ValueError("all operands must be on one device")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm needs contiguous operands")
    out = torch.empty_like(x)
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out                     # nothing to normalise
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.rmsnorm(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                         rows, D, eps, int(x.dtype == torch.bfloat16),
                         int(scale.dtype == torch.bfloat16),
                         torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.rmsnorm_error_string(rc).decode()
        raise RuntimeError(f"rmsnorm launch failed: {msg} ({rc})")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("rmsnorm")
    lib.rmsnorm.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                            + [ctypes.c_float] + [ctypes.c_int] * 2
                            + [ctypes.c_void_p])
    lib.rmsnorm.restype = ctypes.c_int
    lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib
