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
from repro_torch.kernels._layout import (num_sms, on_device, plain,
                                         plain_route, stream_handle)

_DTYPES = (torch.float32, torch.bfloat16)
MAX_THREADS = 512                      # the kernel's launch bound
ROWS_THREADS = 256                     # threads a block of several rows takes
VECTOR_NV = (1, 2, 4, 8)               # 16-byte accesses a thread holds
SCALAR_NV = (1, 2, 4, 8, 16, 32)       # elements a thread holds (scalar route)
FEW_ROWS_ELEMS = 16                    # elements a thread holds at few rows
BWD_ACCESSES = 2                       # the backward's accesses a thread a row
BWD_BLOCKS_PER_SM = 1                  # the backward's grid: one wave
BWD_REDUCE_RANGES = 32                 # scratch-row ranges its column sum takes


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
    dtype, differentiable in ``x`` and ``scale``."""
    _check(x, scale)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return _forward(x, scale, eps)


class _RMSNorm(torch.autograd.Function):
    """The forward launch, and :func:`rmsnorm_bwd` as its backward."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, g, eps=ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                dscale if ctx.needs_input_grad[1] else None, None)


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """The kernel on the card, the plain version on the CPU."""
    dev = x.device
    if plain_route(dev):
        return plain("rmsnorm", rmsnorm_ref, x, scale, eps=eps)
    if dev.type != "cuda":
        raise ValueError(f"rmsnorm runs on cuda, cpu or meta "
                         f"tensors, not {dev}")
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


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                    eps: float = 1e-6):
    """Plain backward, as the formula: with r = rsqrt(mean(x²) + eps),
    x̂ = x·r and gs = g·scale, dx = r·(gs − x̂·mean(gs·x̂)) and dscale =
    Σ_rows g·x̂; fp32 inside (fp64 for fp64 operands, which the card's
    checks use for dscale's long sums), dx in x's dtype and dscale in
    scale's."""
    D = x.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    xf, gf = x.to(acc), g.to(acc)
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    xh = xf * r
    gs = gf * scale.to(acc)
    dx = r * (gs - xh * (gs * xh).mean(-1, keepdim=True))
    dscale = (gf * xh).reshape(-1, D).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


@functools.lru_cache(maxsize=256)
def bwd_plan(rows: int, D: int, x_bytes: int, aligned: bool,
             sms: int) -> NormPlan:
    """The backward's launch: a row spread over as few warps (up to 16)
    as keep a thread at ``BWD_ACCESSES`` accesses where they can (fewer
    warps a row exchange their sums faster); the vector route where
    x, g, dx and the scale are ``aligned`` to 16 bytes and the access
    width divides D, else the scalar one. A block holds as many such row
    groups (``rows_per_block``) as fit ``MAX_THREADS``, each walking rows
    with a grid-wide stride; the grid is one wave, ``BWD_BLOCKS_PER_SM``
    block an SM, at most one per row group. Each block adds one row of D
    fp32 to the scale gradient's scratch, which a second launch sums down
    in ``BWD_REDUCE_RANGES`` ranges, each in order, then the ranges in
    order."""
    vec = 16 // x_bytes
    if not aligned or D % vec:
        vec = 1
    nvs = VECTOR_NV if vec > 1 else SCALAR_NV
    nvec = D // vec
    warps = min(max(1, -(-nvec // (32 * BWD_ACCESSES))), MAX_THREADS // 32)
    need = -(-nvec // (32 * warps))
    if need > nvs[-1]:
        raise ValueError(f"rmsnorm_bwd takes D up to "
                         f"{MAX_THREADS * nvs[-1] * vec} on this route "
                         f"(16-byte aligned: {vec > 1}), got D={D}")
    nv = next(n for n in nvs if n >= need)
    groups = max(1, (MAX_THREADS // 32) // warps)
    return NormPlan(vec, nv, warps, groups,
                    max(1, min(-(-rows // groups), sms * BWD_BLOCKS_PER_SM)))


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, *,
                eps: float = 1e-6):
    """Gradients of :func:`rmsnorm` for the upstream gradient ``g`` (x's
    shape): (dx in x's dtype, dscale in scale's). The hand-written kernel
    on the card, :func:`rmsnorm_bwd_ref` on the CPU."""
    _check(x, scale)
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} must have x's shape "
                         f"{tuple(x.shape)}")
    dev = x.device
    if plain_route(dev):
        return plain("rmsnorm_bwd", rmsnorm_bwd_ref, x, scale, g, eps)
    if dev.type != "cuda":
        raise ValueError(f"rmsnorm_bwd runs on cuda, cpu or meta "
                         f"tensors, not {dev}")
    if scale.device != dev or g.device != dev:
        raise ValueError("all operands must be on one device")
    x, scale = x.contiguous(), scale.contiguous()
    g = g.to(x.dtype).contiguous()
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(scale)
    p = bwd_plan(rows, D, x.element_size(),
                 (x.data_ptr() | g.data_ptr() | dx.data_ptr()
                  | scale.data_ptr()) % 16 == 0, num_sms(dev.index))
    dscale = torch.empty_like(scale)
    partial = torch.empty((p.blocks, D), dtype=torch.float32, device=dev)
    lib = _bwd_library()
    with on_device(dev):
        rc = lib.rmsnorm_bwd(x.data_ptr(), scale.data_ptr(), g.data_ptr(),
                             dx.data_ptr(), dscale.data_ptr(),
                             partial.data_ptr(), rows, D, eps,
                             x.dtype == torch.bfloat16,
                             scale.dtype == torch.bfloat16, p.vec, p.nv,
                             p.warps, p.rows_per_block, p.blocks,
                             BWD_REDUCE_RANGES, stream_handle(dev))
    if rc != 0:
        msg = lib.rmsnorm_bwd_error_string(rc).decode()
        raise RuntimeError(f"rmsnorm_bwd launch failed: {msg} ({rc})")
    rmsnorm_bwd.launches += 1
    return dx, dscale


rmsnorm_bwd.launches = 0


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


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    """The built backward library with its C signature declared."""
    lib = build.load("rmsnorm_bwd")
    lib.rmsnorm_bwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong,
                                                         ctypes.c_int,
                                                         ctypes.c_float]
                                + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.rmsnorm_bwd.restype = ctypes.c_int
    lib.rmsnorm_bwd_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_bwd_error_string.restype = ctypes.c_char_p
    return lib
