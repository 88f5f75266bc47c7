"""Coded shard matmul: every compute shard's partial product in one launch.

Intermediate-computation coding (:mod:`repro_torch.coding.compute`) splits a
linear layer ``y = x @ W`` into ``k`` output-column blocks and adds
``n - k`` pre-encoded parity blocks, so each of ``n`` devices runs the same
small matmul against its own ``(D, w)`` shard and any ``k`` arrivals
rebuild ``y``. This is the device-side primitive:

    out (n, B, w)[i] = x (B, D) @ shards (n, D, w)[i]

:func:`coded_matmul` launches the hand-written CUDA kernel
``csrc/coded_matmul.cu`` on a CUDA tensor and takes the plain version
:func:`coded_matmul_ref` only for tensors that lie on the CPU. A failed
build or launch raises; nothing falls back. ``coded_matmul.launches``
counts kernel launches (plain-version calls do not count). It takes no
tuning, like the JAX package's public wrapper: :func:`plan` picks the
outputs a thread holds from the shape, so that the grid fills the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels._layout import (no_backward, num_sms, on_device,
                                         plain, stream_handle)

# the kernel's plans, (rows, columns) of outputs a thread holds; a block is
# 8 x 8 threads, so its tile is (8 * rows) x 32 of one shard's output
PLANS = ((8, 4), (4, 4), (2, 4))


def blocks(plan_index: int, n: int, B: int, w: int) -> int:
    """The grid of ``PLANS[plan_index]``: (row tiles, column tiles, n)."""
    tm, tn = PLANS[plan_index]
    return -(-B // (8 * tm)) * -(-w // (8 * tn)) * n


def plan(n: int, B: int, w: int, sms: int) -> int:
    """The first plan (most outputs a thread) whose grid gives each of the
    ``sms`` SMs two blocks, so that each of an SM's four schedulers has a
    warp, else the last: (8, 5) over B 256 and w 200 takes 4 x 4 (448
    blocks), (5, 3) over w 43 takes 2 x 4 (160). Every output's sum runs
    over D in one thread whatever the plan."""
    for i in range(len(PLANS)):
        if blocks(i, n, B, w) >= 2 * sms:
            return i
    return len(PLANS) - 1


def coded_matmul_ref(x: torch.Tensor, shards: torch.Tensor) -> torch.Tensor:
    """Plain version. x: (B, D); shards: (n, D, w). Returns (n, B, w)."""
    return torch.einsum("bd,ndw->nbw", x.to(torch.float32),
                        shards.to(torch.float32))


def coded_matmul(x: torch.Tensor, shards: torch.Tensor) -> torch.Tensor:
    """x: (B, D) f32 activations; shards: (n, D, w) f32 stacked shard
    weights from :func:`repro_torch.coding.compute.shard_linear_weights`
    (systematic first). Returns the (n, B, w) f32 partial products."""
    if x.dim() != 2 or shards.dim() != 3 or shards.shape[1] != x.shape[1]:
        raise ValueError(f"x (B, D) and shards (n, D, w) expected, got "
                         f"{tuple(x.shape)} and {tuple(shards.shape)}")
    if x.dtype != torch.float32 or shards.dtype != torch.float32:
        raise TypeError(f"x and shards must be float32, got {x.dtype} and "
                        f"{shards.dtype}")
    if x.device.type == "cpu":
        return plain("coded_matmul", coded_matmul_ref, x, shards)
    no_backward("coded_matmul", x, shards)
    if x.device.type != "cuda":
        raise ValueError(f"coded_matmul runs on cuda or cpu tensors, not "
                         f"{x.device}")
    if shards.device != x.device:
        raise ValueError("all operands must be on one device")
    if not (x.is_contiguous() and shards.is_contiguous()):
        raise ValueError("coded_matmul needs contiguous operands")
    B, D = x.shape
    n, _, w = shards.shape
    out = torch.empty((n, B, w), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out                     # B == 0: (n, 0, w)
    x, shards = (t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (x, shards))           # cp.async from the bases
    lib = _library()
    with on_device(x.device):
        rc = lib.coded_matmul_f32(x.data_ptr(), shards.data_ptr(),
                                  out.data_ptr(), n, B, D, w,
                                  plan(n, B, w, num_sms(x.device.index)),
                                  stream_handle(x.device))
    if rc != 0:
        msg = lib.coded_matmul_error_string(rc).decode()
        raise RuntimeError(f"coded_matmul launch failed: {msg} ({rc})")
    coded_matmul.launches += 1
    return out


coded_matmul.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared."""
    lib = build.load("coded_matmul")
    lib.coded_matmul_f32.argtypes = ([ctypes.c_void_p] * 3
                                     + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.coded_matmul_f32.restype = ctypes.c_int
    lib.coded_matmul_error_string.argtypes = [ctypes.c_int]
    lib.coded_matmul_error_string.restype = ctypes.c_char_p
    return lib
