"""MoE router gating: softmax over E experts, k rounds of argmax-and-mask,
renormalisation.

    logits (N, E) fp32 → weights (N, k) fp32 summing to 1, indices (N, k) int32

Ties go to the lowest expert index, as ``argmax`` and ``lax.top_k`` break
them. :func:`topk_gating` launches the hand-written CUDA kernel
``csrc/topk_gating.cu`` on a CUDA tensor (one warp per row, the row in
registers, shuffle reductions) and takes the plain version
:func:`topk_gating_ref` only for tensors that lie on the CPU. A failed
build or launch raises; nothing falls back. ``topk_gating.launches`` counts
kernel launches (plain-version calls do not count). Any N works, N = 0
included; E up to 256 on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
MAX_EXPERTS = 256                      # 32 lanes x 8 values in registers


def topk_gating_ref(logits: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the TPU kernel's k unrolled argmax-and-mask rounds."""
    cur = torch.softmax(logits.float(), dim=-1)
    ws, idxs = [], []
    for _ in range(k):
        idx = cur.argmax(-1)                       # first maximum on ties
        ws.append(cur.gather(-1, idx[:, None])[:, 0])
        idxs.append(idx)
        cur = cur.scatter(-1, idx[:, None], NEG_INF)
    w = torch.stack(ws, -1)
    return (w / w.sum(-1, keepdim=True).clamp_min(1e-9),
            torch.stack(idxs, -1).to(torch.int32))


def _check(logits: torch.Tensor, k: int) -> None:
    if logits.dim() != 2:
        raise ValueError(f"logits (N, E) expected, got {tuple(logits.shape)}")
    if not 0 < k <= logits.shape[1]:
        raise ValueError(f"need 0 < k <= E, got k={k}, E={logits.shape[1]}")
    if logits.dtype != torch.float32:
        raise TypeError(f"logits must be float32, got {logits.dtype}")


def topk_gating(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits: (N, E) fp32. Returns (weights (N, k) fp32, indices (N, k)
    int32)."""
    _check(logits, k)
    if logits.device.type == "cpu":
        return topk_gating_ref(logits, k)
    if logits.device.type != "cuda":
        raise ValueError(f"topk_gating runs on cuda or cpu tensors, not "
                         f"{logits.device}")
    N, E = logits.shape
    if E > MAX_EXPERTS:
        raise ValueError(f"the kernel takes E <= {MAX_EXPERTS}, got {E}")
    if not logits.is_contiguous():
        raise ValueError("topk_gating needs contiguous logits")
    w = torch.empty((N, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((N, k), dtype=torch.int32, device=logits.device)
    if N == 0:
        return w, idx                  # nothing to route
    lib = _library()
    with torch.cuda.device(logits.device):
        rc = lib.topk_gating(logits.data_ptr(), w.data_ptr(), idx.data_ptr(),
                             N, E, k, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.topk_gating_error_string(rc).decode()
        raise RuntimeError(f"topk_gating launch failed: {msg} ({rc})")
    topk_gating.launches += 1
    return w, idx


topk_gating.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("topk_gating")
    lib.topk_gating.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                + [ctypes.c_void_p])
    lib.topk_gating.restype = ctypes.c_int
    lib.topk_gating_error_string.argtypes = [ctypes.c_int]
    lib.topk_gating_error_string.restype = ctypes.c_char_p
    return lib
