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

The kernel has two routes, picked by :func:`route` from (B, D, N) alone.
The tensor route (D past one 64-deep k-tile, N a multiple of 16, D of 4)
runs bf16 ``wgmma`` products with the int8 weight exact in bf16 and x split
into three bf16 terms (:func:`split_terms`), each k-tile summed on the
tensor cores and added into an fp32 sum, the scale applied to the finished
sum. Every other shape takes the CUDA-core route: fp32 FMAs with the weight
expanded first, as the plain version does (16-byte loads where the rows
start on 16 bytes). At D <= 64 that keeps the kernel within 1e-5 of the
plain version, which the tensor cores' own rounding of a sum does not at
every output near zero.

The output tile ``(block_batch, block_n)`` is resolved through the tuning
table (:mod:`repro_torch.kernels.autotune`) unless the caller pins it; on a
table miss :func:`default_tile` picks the route's largest tile that still
fills the card's SMs. :func:`plan` turns a tile into a legal launch of the
shape's route: a tile changes which block owns an output, never the order
of its sum, so every tile of a route gives the same bits.
:func:`candidates` gives the tuner one tile for each distinct launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import autotune, build
from repro_torch.kernels._layout import (no_backward, num_sms, on_device,
                                         plain, stream_handle)

MAX_TILE = 128          # the CUDA-core route's largest block_batch, block_n
TENSOR_COLS = 128       # the tensor route's columns a block
K_TILE = 64             # the tensor route's k-tile: its sum is promoted


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


def vector_rows(D: int, N: int) -> bool:
    """Every row of x and q starts on 16 bytes (N a multiple of 16, D of 4;
    the wrapper copies an operand whose base does not)."""
    return N % 16 == 0 and D % 4 == 0


def route(B: int, D: int, N: int) -> str:
    """``"tensor"`` for rows on 16 bytes and D past one k-tile, else
    ``"cuda_cores"``. The shape alone decides, never the tile."""
    return "tensor" if D > K_TILE and vector_rows(D, N) else "cuda_cores"


def plan(B: int, D: int, N: int, block_batch: int, block_n: int
         ) -> Tuple[str, int, int]:
    """(route, rows, columns) of one block. The CUDA-core route takes the
    clamped :func:`tiles`, its columns rounded down to a multiple of 16
    (at least 16) where it stages 16-byte rows; the tensor route one or two
    warpgroups of 64 rows (two where the clamped ``block_batch`` exceeds
    64) by ``TENSOR_COLS`` columns, whatever ``block_n`` asks."""
    bb, bn = tiles(max(B, 1), max(N, 1), block_batch, block_n)
    r = route(B, D, N)
    if r == "tensor":
        return r, (128 if bb > 64 else 64), TENSOR_COLS
    if vector_rows(D, N):
        bn = max(16, bn - bn % 16)
    return r, bb, bn


def default_tile(B: int, D: int, N: int, sms: int) -> Dict[str, int]:
    """The tile a call takes where neither the caller nor the table sets
    one: the route's largest that still gives each of ``sms`` SMs a block
    (on the tensor route 128 rows, else 64; on the CUDA-core route a square
    of 128, 64 or 32, else 16)."""
    if route(B, D, N) == "tensor":
        rows = 128 if -(-B // 128) * -(-N // TENSOR_COLS) >= sms else 64
        return {"block_batch": rows, "block_n": TENSOR_COLS}
    t = next((t for t in (128, 64, 32) if -(-B // t) * -(-N // t) >= sms),
             16)
    return {"block_batch": t, "block_n": t}


def candidates(B: int, D: int, N: int, sms: int
               ) -> Tuple[Dict[str, int], ...]:
    """The tuner's grid at this shape, :func:`default_tile` first, with one
    tile for each distinct launch :func:`plan` makes of it (on the tensor
    route at most two)."""
    seen, out = set(), []
    for c in autotune._configs("dequant_matmul",
                               default_tile(B, D, N, sms)):
        p = plan(B, D, N, c["block_batch"], c["block_n"])
        if p not in seen:
            seen.add(p)
            out.append(c)
    return tuple(out)


def split_terms(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensor route's three bf16 terms of fp32 ``x``: t0 = bf16(x), t1 =
    bf16(x - t0), t2 = bf16(x - t0 - t1), each difference exact in fp32;
    where t0 is not finite, t1 = t2 = 0. A model of the kernel's split for
    the tests: they sum back to x exactly for 2^-110 <= |x| <= 3.38e38."""
    x = x.to(torch.float32)
    t0 = x.to(torch.bfloat16)
    finite = torch.isfinite(t0)
    zero = torch.zeros_like(x)
    r = torch.where(finite, x - t0.float(), zero)
    t1 = r.to(torch.bfloat16)
    t2 = torch.where(finite, r - t1.float(), zero).to(torch.bfloat16)
    return t0, t1, t2


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
    blocks = autotune.resolve(
        "dequant_matmul", shape, dtype,
        {"block_batch": block_batch, "block_n": block_n},
        default_tile(*shape, num_sms(x.device.index))
        if x.device.type == "cuda" else None)
    if x.device.type == "cpu":
        return plain("dequant_matmul", dequant_matmul_ref, x, q, scale)
    no_backward("dequant_matmul", x, scale)
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
    r, bb, bn = plan(B, D, N, blocks["block_batch"], blocks["block_n"])
    vec = vector_rows(D, N)
    if vec:                            # 16-byte cp.async from every base
        x, q, scale = (t if t.data_ptr() % 16 == 0 else t.clone()
                       for t in (x, q, scale))
    lib = _library()
    with on_device(x.device):
        rc = lib.dequant_matmul_f32(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            B, D, N, 1 if r == "tensor" else 2 if vec else 0, bb, bn,
            int(scale.dim() == 1),
            stream_handle(x.device))
    if rc != 0:
        msg = lib.dequant_matmul_error_string(rc).decode()
        raise RuntimeError(f"dequant_matmul launch failed at (B, D, N) = "
                           f"({B}, {D}, {N}), {r} route, tile {bb} x {bn}: "
                           f"{msg} ({rc})")
    dequant_matmul.launches += 1
    return out


dequant_matmul.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared."""
    lib = build.load("dequant_matmul")
    lib.dequant_matmul_f32.argtypes = ([ctypes.c_void_p] * 4
                                       + [ctypes.c_int] * 7
                                       + [ctypes.c_void_p])
    lib.dequant_matmul_f32.restype = ctypes.c_int
    lib.dequant_matmul_error_string.argtypes = [ctypes.c_int]
    lib.dequant_matmul_error_string.restype = ctypes.c_char_p
    return lib
