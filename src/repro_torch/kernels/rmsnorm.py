"""Fused RMSNorm: ``x · rsqrt(mean(x²) + eps) · scale`` over the last axis.

:func:`rmsnorm` launches the hand-written CUDA kernel ``csrc/rmsnorm.cu``
on a CUDA tensor and takes the plain version :func:`rmsnorm_ref` only for
tensors that lie on the CPU. A failed build or launch raises; nothing
falls back. ``rmsnorm.launches`` counts kernel launches (plain-version
calls do not count).

The kernel reads and writes 16 bytes at a time and keeps each row in
registers between the sum of squares and the product: one read and one
write of every element, fp32 inside. :func:`plan` chooses its launch from
the shape: the vector width (the scalar route where D is ragged or a base
is not 16-byte aligned), the accesses per thread, the warps per row and
the rows per block.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels._layout import num_sms, on_device, stream_handle

_DTYPES = (torch.float32, torch.bfloat16)
MAX_THREADS = 512                      # the kernel's launch bound
ROWS_THREADS = 256                     # threads a block of several rows takes
VECTOR_NV = (1, 2, 4, 8)               # 16-byte accesses a thread holds
SCALAR_NV = (1, 2, 4, 8, 16, 32)       # elements a thread holds (scalar route)
FEW_ROWS_ELEMS = 16                    # elements a thread holds at few rows


class NormPlan(NamedTuple):
    """One launch of the kernel."""
    vec: int             # elements per access: 16 bytes of x, or 1
    nv: int              # accesses per thread per row (compile-time)
    warps: int           # warps per row
    rows_per_block: int  # rows a block normalises at a time
    blocks: int          # the grid; blocks walk the row groups by its stride


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


@functools.lru_cache(maxsize=256)
def plan(rows: int, D: int, x_bytes: int, aligned: bool,
         sms: int) -> NormPlan:
    """The launch for ``rows`` rows of D elements of ``x_bytes`` bytes.
    16-byte accesses where x and the scale are ``aligned`` to 16 bytes and
    the access width divides D, else the scalar route. Warps per row: as
    few as keep a thread at 8 accesses or fewer (32 elements on the scalar
    route), so one warp up to D 2048 in bf16; where there are no more rows
    than SMs (a decode step), as many as keep it at 16 elements, since a
    thread's elements are a serial chain there and nothing else hides it.
    A block holds as many rows as fill ``ROWS_THREADS`` threads, fewer
    where that leaves SMs idle, and the grid stops at what the ``sms`` SMs
    hold at once."""
    vec = 16 // x_bytes
    if not aligned or D % vec:
        vec = 1
    nvs = VECTOR_NV if vec > 1 else SCALAR_NV
    nvec = D // vec
    cap = max(1, FEW_ROWS_ELEMS // vec) if rows <= sms else nvs[-1]
    warps = min(max(1, -(-nvec // (32 * cap))), MAX_THREADS // 32)
    need = -(-nvec // (32 * warps))
    if need > nvs[-1]:
        raise ValueError(f"rmsnorm takes D up to "
                         f"{MAX_THREADS * nvs[-1] * vec} on this route "
                         f"(16-byte aligned: {vec > 1}), got D={D}")
    nv = next(n for n in nvs if n >= need)
    rpb = max(1, min(ROWS_THREADS // (32 * warps), -(-rows // sms)))
    resident = sms * max(1, 2048 // (32 * warps * rpb))
    return NormPlan(vec, nv, warps, rpb,
                    max(1, min(-(-rows // rpb), resident)))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D) f32/bf16; scale: (D,) f32/bf16. Returns x's shape and
    dtype."""
    _check(x, scale)
    dev = x.device
    if dev.type == "cpu":
        return rmsnorm_ref(x, scale, eps=eps)
    if dev.type != "cuda":
        raise ValueError(f"rmsnorm runs on cuda or cpu tensors, not {dev}")
    if scale.device != dev:
        raise ValueError("all operands must be on one device")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm needs contiguous operands")
    out = torch.empty_like(x)
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out                     # nothing to normalise
    p = plan(rows, D, x.element_size(),
             (x.data_ptr() | scale.data_ptr()) % 16 == 0, num_sms(dev.index))
    lib = _library()
    with on_device(dev):
        rc = lib.rmsnorm(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                         rows, D, eps, x.dtype == torch.bfloat16,
                         scale.dtype == torch.bfloat16, p.vec, p.nv, p.warps,
                         p.rows_per_block, p.blocks, stream_handle(dev))
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
    lib.rmsnorm.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                     ctypes.c_int,
                                                     ctypes.c_float]
                            + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.rmsnorm.restype = ctypes.c_int
    lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib
