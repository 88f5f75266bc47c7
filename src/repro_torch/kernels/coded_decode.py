"""Coded-share decode: masked, decode-weighted gather over the share axis.

After an erasure-coded dispatch the source holds the share tensor
(B, R, F) — R = K systematic + P parity shares, rows of dead shares
garbage — and a per-request decode operator ``dec`` (B, K, R) built on the
host from the arrival pattern (identity rows for arrived systematic shares,
pseudo-inverse rows for erased ones, zeros for unrecoverable slots):

    out (B, K, F)[b, k] = Σ_r  mask[b, r] · dec[b, k, r] · share[b, r] · s_r

:func:`coded_decode` launches the hand-written CUDA kernel
``csrc/coded_decode.cu`` on a CUDA tensor and takes the plain version
:func:`coded_decode_ref` only for tensors that lie on the CPU. A failed
build or launch raises; nothing falls back. ``coded_decode.launches``
counts kernel launches (plain-version calls do not count).

int8 share transport: ``shares`` int8 with per-share fp32 ``scales`` (R,);
the kernel scales each share on the way in.

``block_batch`` (batch rows per block) is resolved through the tuning table
(:mod:`repro_torch.kernels.autotune`) unless the caller pins it;
:func:`decode_plan` turns it into a launch: the vector width (4 columns of
shares per access, 16 bytes of fp32 or 4 of int8, or the scalar route
where a view's base or strides are not aligned to 4 elements or F is
ragged), the compile-time bound on R (a pass of up to 16 shares; more take
several passes) and the block and grid shapes (:func:`block_rows`). Every
plan gives the same bits.

On the card ``shares`` may be a view with unit stride along F (the
recovery path passes its (R, B, F) share stack transposed, without a copy).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import autotune, build
from repro_torch.kernels._layout import (no_backward, on_device, plain,
                                         stream_handle,
                                         strides)

MAX_THREADS = 256                      # the kernel's launch bound
VEC = 4                                # feature columns per access
MAX_COLS = 128                         # threads along F in one block
R_BOUNDS = (4, 8, 16)                  # the kernel's compile-time R bounds


class DecodePlan(NamedTuple):
    """One launch of the kernel."""
    vec: int                 # feature columns per thread and access
    r_max: int               # shares per pass, all loaded before use:
                             # one pass up to R = 16, passes of 16 beyond
    rows: int                # batch rows per block
    lanes: int               # rows a block decodes at once
    cols: int                # threads along F per block
    grid: Tuple[int, int]    # (row blocks, column blocks)


def coded_decode_ref(shares: torch.Tensor, dec: torch.Tensor,
                     mask: torch.Tensor,
                     scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version. shares: (B, R, F) fp32 or int8; dec: (B, K, R);
    mask: (B, R); scales: optional (R,) dequant scales. Returns (B, K, F)
    fp32."""
    w = dec.to(torch.float32) * mask.to(torch.float32)[:, None, :]
    if scales is not None:
        w = w * scales.to(torch.float32)[None, None, :]
    return torch.einsum("bkr,brf->bkf", w, shares.to(torch.float32))


def _check(shares, dec, mask, scales) -> None:
    if shares.dim() != 3 or dec.dim() != 3 or mask.dim() != 2:
        raise ValueError(f"shares (B, R, F), dec (B, K, R) and mask (B, R) "
                         f"expected, got {tuple(shares.shape)}, "
                         f"{tuple(dec.shape)} and {tuple(mask.shape)}")
    B, R, _ = shares.shape
    if dec.shape[0] != B or dec.shape[2] != R or tuple(mask.shape) != (B, R):
        raise ValueError(f"dec {tuple(dec.shape)} and mask "
                         f"{tuple(mask.shape)} do not match shares "
                         f"{tuple(shares.shape)}")
    if dec.dtype != torch.float32:
        raise TypeError("dec must be float32")
    if shares.dtype == torch.int8:
        if scales is None:
            raise ValueError("int8 shares need per-share fp32 scales")
    elif shares.dtype != torch.float32:
        raise TypeError(f"shares must be float32 or int8, got "
                        f"{shares.dtype}")
    if scales is not None and (scales.dtype != torch.float32
                               or tuple(scales.shape) != (R,)):
        raise ValueError(f"scales must be float32 of shape ({R},)")


def block_rows(B: int, F: int, block_batch: int,
               vec: int) -> Tuple[int, int]:
    """(rows, lanes) of one block: ``block_batch`` clamped into [1, B]
    rows, decoded ``lanes`` at a time, as many as ``MAX_THREADS`` threads
    hold beside the row's ``min(ceil(F / vec), MAX_COLS)`` threads."""
    cols = min(-(-F // vec), MAX_COLS)
    rows = max(1, min(int(block_batch), B))
    return rows, max(1, min(rows, MAX_THREADS // cols))


@functools.lru_cache(maxsize=256)
def decode_plan(B: int, R: int, F: int, elem_bytes: int, stride_b: int,
                stride_r: int, base_offset: int,
                block_batch: int) -> DecodePlan:
    """The launch for B rows of R shares of F elements of ``elem_bytes``
    bytes at element strides ``stride_b``, ``stride_r`` (0 on an axis of
    size 1), the base ``base_offset`` bytes past a 16-byte boundary.
    Accesses of ``VEC`` columns where that width divides F and both
    strides and the base is aligned to it, else the scalar route."""
    vec = VEC
    if (F | stride_b | stride_r) % vec or base_offset % (vec * elem_bytes):
        vec = 1
    r_max = next((m for m in R_BOUNDS if R <= m), R_BOUNDS[-1])
    rows, lanes = block_rows(B, F, block_batch, vec)
    cpr = -(-F // vec)
    cols = min(cpr, MAX_COLS)
    return DecodePlan(vec, r_max, rows, lanes, cols,
                      (-(-B // rows), -(-cpr // cols)))


def coded_decode(shares: torch.Tensor, dec: torch.Tensor, mask: torch.Tensor,
                 scales: Optional[torch.Tensor] = None, *,
                 block_batch: Optional[int] = None) -> torch.Tensor:
    """shares: (B, R, F) f32 or int8; dec: (B, K, R) f32; mask: (B, R)
    int32 (1 = share arrived; any integer or bool type on the CPU); scales:
    (R,) f32, required for int8 shares. Returns the recovered portions
    (B, K, F) f32. ``block_batch=None`` consults the tuning table for this
    shape."""
    _check(shares, dec, mask, scales)
    shape, dtype = autotune.key_coded_decode(shares, dec)
    bb = autotune.resolve("coded_decode", shape, dtype,
                          {"block_batch": block_batch})["block_batch"]
    if shares.device.type == "cpu":
        return plain("coded_decode", coded_decode_ref, shares, dec, mask,
                     scales)
    no_backward("coded_decode", shares, dec, scales)
    if shares.device.type != "cuda":
        raise ValueError(f"coded_decode runs on cuda or cpu tensors, not "
                         f"{shares.device}")
    dev = shares.device
    if dec.device != dev or mask.device != dev or (
            scales is not None and scales.device != dev):
        raise ValueError("all operands must be on one device")
    if mask.dtype != torch.int32:
        raise TypeError("mask must be int32 on the card")
    B, R, F = shares.shape
    K = dec.shape[1]
    out = torch.empty((B, K, F), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out                     # nothing to decode: (0, K, F)
    if shares.stride(2) != 1 and F > 1:
        raise ValueError("coded_decode needs shares with unit stride along F")
    if not (dec.is_contiguous() and mask.is_contiguous()
            and (scales is None or scales.is_contiguous())):
        raise ValueError("coded_decode needs contiguous dec, mask and scales")
    sb, sr, _ = strides(shares)
    p = decode_plan(B, R, F, shares.element_size(), sb, sr,
                    shares.data_ptr() % 16, bb)
    lib = _library()
    fn = (lib.coded_decode_i8 if shares.dtype == torch.int8
          else lib.coded_decode_f32)
    with on_device(dev):
        rc = fn(shares.data_ptr(), sb, sr, dec.data_ptr(), mask.data_ptr(),
                scales.data_ptr() if scales is not None else None,
                out.data_ptr(), B, R, K, F, p.vec, p.r_max, p.rows, p.lanes,
                p.cols, *p.grid, stream_handle(dev))
    if rc != 0:
        msg = lib.coded_decode_error_string(rc).decode()
        raise RuntimeError(f"coded_decode launch failed: {msg} ({rc})")
    coded_decode.launches += 1
    return out


coded_decode.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("coded_decode")
    args = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2
            + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    for fn in (lib.coded_decode_f32, lib.coded_decode_i8):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.coded_decode_error_string.argtypes = [ctypes.c_int]
    lib.coded_decode_error_string.restype = ctypes.c_char_p
    return lib
