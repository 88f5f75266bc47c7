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
:func:`block_rows` clamps it to a legal launch. Every value gives the same
bits.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import autotune, build

# the kernel's (K, R) weight tile and mask row live in shared memory, one
# per row the block decodes at a time
_MAX_SMEM_BYTES = 48 * 1024
_MAX_THREADS = 512


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


def block_rows(B: int, R: int, K: int, F: int,
               block_batch: int) -> Tuple[int, int]:
    """(rows, lanes) of one block: ``block_batch`` clamped into [1, B]
    rows, decoded ``lanes`` at a time, as many as 512 threads (128 feature
    columns per lane at most) and 48 KB of weight tiles allow."""
    threads = 128 if F >= 128 else -(-F // 32) * 32
    rows = max(1, min(int(block_batch), B))
    lanes = min(rows, _MAX_THREADS // max(threads, 1),
                _MAX_SMEM_BYTES // ((K * R + R) * 4))
    return rows, max(1, lanes)


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
        return coded_decode_ref(shares, dec, mask, scales)
    if shares.device.type != "cuda":
        raise ValueError(f"coded_decode runs on cuda or cpu tensors, not "
                         f"{shares.device}")
    tensors = [dec, mask] + ([scales] if scales is not None else [])
    if any(t.device != shares.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if mask.dtype != torch.int32:
        raise TypeError("mask must be int32 on the card")
    if not all(t.is_contiguous() for t in [shares] + tensors):
        raise ValueError("coded_decode needs contiguous operands")
    B, R, F = shares.shape
    K = dec.shape[1]
    if (K * R + R) * 4 > _MAX_SMEM_BYTES:
        raise ValueError(f"K={K}, R={R}: the (K, R) weight tile does not "
                         f"fit the kernel's shared memory")
    out = torch.empty((B, K, F), dtype=torch.float32, device=shares.device)
    if out.numel() == 0:
        return out                     # nothing to decode: (0, K, F)
    lib = _library()
    fn = (lib.coded_decode_i8 if shares.dtype == torch.int8
          else lib.coded_decode_f32)
    with torch.cuda.device(shares.device):
        rc = fn(shares.data_ptr(), dec.data_ptr(), mask.data_ptr(),
                scales.data_ptr() if scales is not None else None,
                out.data_ptr(), B, R, K, F, *block_rows(B, R, K, F, bb),
                torch.cuda.current_stream().cuda_stream)
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
    args = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    for fn in (lib.coded_decode_f32, lib.coded_decode_i8):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.coded_decode_error_string.argtypes = [ctypes.c_int]
    lib.coded_decode_error_string.restype = ctypes.c_char_p
    return lib
