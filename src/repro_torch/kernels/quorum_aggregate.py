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
:func:`merge_plan` turns it into a launch. The serving shapes take the rows
route (a warp an output row, a slot's reduction spread over lanes in
chunks of 4 along Dk, read 16 bytes at a time, the weights staged once per
block), wider ones the tiles route (Dk in slices of 32, a thread an
output). The route follows (K, Dk, C) alone, and each sums in an order
fixed by them, so every ``block_batch``, every view and either vector
width gives the same bits.

On the card ``portions`` may be a view with unit stride along Dk (the
output-coded path passes its decoded (B, K, Dk) stack transposed, without
a copy); a view whose base or strides are not aligned to 4 elements reads
one element at a time, in the same order.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import autotune, build
from repro_torch.kernels._layout import (no_backward, on_device, plain,
                                         stream_handle, strides)

ROW_WARPS = 8           # warps of a rows-route block: all stage, each a row
ROW_NCH = (1, 2, 4, 8)  # chunks of 4 a lane loads per row (compile-time)
ROW_CMAX = (4, 10, 16, 32)  # classes a lane sums (compile-time; 10: CIFAR)
ROW_SMEM = 48 * 1024    # the rows route's staged weights, at most
MAX_ROWS = 32           # rows a rows-route block serves, at most
TILE_THREADS = 1024     # rows * bn threads of a tiles-route block
TILE_DEPTH = 32         # the tiles route's Dk slice


class MergePlan(NamedTuple):
    """One launch of the kernel."""
    route: str               # "rows" or "tiles"
    vec: int                 # portion elements per access: 4 or 1 (rows)
    nch: int                 # chunks of 4 a lane loads per row (rows)
    cmax: int                # compile-time bound on C (rows)
    lanes: int               # lanes per slot (rows); classes a tile (tiles)
    rows: int                # output rows per block: block_batch, clamped
    threads: int             # threads per block
    grid: Tuple[int, int]    # (row blocks, class blocks)
    smem: int                # bytes of dynamic shared memory


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


def row_smem(K: int, Dk: int, C: int) -> int:
    """Bytes of the rows route's shared memory: the staged weights (K,
    CMAX, 4·G·J) and each warp's slot dots (K, CMAX); C <= 32."""
    G, _, J, _ = row_layout(K, Dk)
    return 4 * K * row_cmax(C) * (4 * G * J + ROW_WARPS)


def row_cmax(C: int) -> int:
    """The rows route's compile-time bound on C <= 32 classes."""
    return next(c for c in ROW_CMAX if c >= C)


def row_layout(K: int, Dk: int) -> Tuple[int, int, int, int]:
    """(G, S, J, P) of the rows route: G lanes share a slot, one per chunk
    of 4 along Dk up to 32 (a power of two), S = 32 / G slots side by side,
    J chunks a lane reads per slot, P passes over the K slots."""
    Q = -(-Dk // 4)
    G = min(32, 1 << (Q - 1).bit_length())
    S = 32 // G
    return G, S, -(-Q // G), -(-K // S)


@functools.lru_cache(maxsize=256)
def route(K: int, Dk: int, C: int) -> str:
    """"rows" where a warp can hold an output row (at most 32 slots and 32
    classes, at most 8 chunks a lane, the weights within ``ROW_SMEM``),
    else "tiles"."""
    if not (0 < Dk and K <= 32 and C <= ROW_CMAX[-1]):
        return "tiles"
    G, S, J, P = row_layout(K, Dk)
    return ("rows" if P * J <= ROW_NCH[-1] and row_smem(K, Dk, C) <= ROW_SMEM
            else "tiles")


@functools.lru_cache(maxsize=256)
def merge_plan(K: int, B: int, Dk: int, C: int, block_batch: int,
               stride_k: int = 0, stride_b: int = 0,
               base_offset: int = 0) -> MergePlan:
    """The launch for K slots of B rows of Dk portion elements merged into
    C classes, ``block_batch`` output rows per block (clamped to a legal
    launch: a stale table entry still launches). Portions at element
    strides ``stride_k``, ``stride_b`` (0 on an axis of size 1), the base
    ``base_offset`` bytes past a 16-byte boundary: 16-byte accesses on the
    rows route where 4 divides Dk and both strides and the base is aligned
    to them, else one element an access."""
    bm = max(1, int(block_batch))
    if route(K, Dk, C) == "tiles":
        bn = 16 if C <= 16 else 32
        bm = min(bm, TILE_THREADS // bn)
        return MergePlan("tiles", 1, 0, 0, bn, bm, bm * bn,
                         (max(1, -(-B // bm)), -(-C // bn)),
                         bm * (TILE_DEPTH + 1) * 4)
    vec = 4
    if (Dk | stride_k | stride_b) % 4 or base_offset % 16:
        vec = 1
    G, S, J, P = row_layout(K, Dk)
    nch = next(n for n in ROW_NCH if n >= P * J)
    bm = min(bm, MAX_ROWS, max(B, 1))
    return MergePlan("rows", vec, nch, row_cmax(C), G, bm, 32 * ROW_WARPS,
                     (max(1, -(-B // bm)), 1), row_smem(K, Dk, C))


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
        return plain("quorum_aggregate", quorum_aggregate_ref, portions,
                     weights, bias, mask, scales)
    no_backward("quorum_aggregate", portions, weights, bias, scales)
    if portions.device.type != "cuda":
        raise ValueError(f"quorum_aggregate runs on cuda or cpu tensors, "
                         f"not {portions.device}")
    tensors = [weights, bias, mask] + ([scales] if scales is not None else [])
    if any(t.device != portions.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if mask.dtype != torch.int32:
        raise TypeError("mask must be int32 on the card")
    K, B, Dk = portions.shape
    C = weights.shape[2]
    dev = portions.device
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    if B == 0:
        return out                     # the merge of nothing: (0, C)
    if (portions.stride(2) != 1 and Dk > 1) or not all(
            t.is_contiguous() for t in tensors):
        raise ValueError("quorum_aggregate needs portions with unit stride "
                         "along Dk and contiguous weights, bias, mask and "
                         "scales")
    sk, sb, _ = strides(portions)
    p = merge_plan(K, B, Dk, C, bm, sk, sb, portions.data_ptr() % 16)
    lib = _library()
    fn = (lib.quorum_aggregate_i8 if weights.dtype == torch.int8
          else lib.quorum_aggregate_f32)
    with on_device(dev):
        rc = fn(portions.data_ptr(), sk, sb, weights.data_ptr(),
                scales.data_ptr() if scales is not None else None,
                bias.data_ptr(), mask.data_ptr(), out.data_ptr(),
                K, B, Dk, C, int(p.route == "tiles"), p.vec, p.nch, p.cmax,
                p.lanes, p.rows, p.threads, *p.grid, p.smem,
                stream_handle(dev))
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
    args = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2
            + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 + [ctypes.c_void_p])
    for fn in (lib.quorum_aggregate_f32, lib.quorum_aggregate_i8):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.quorum_aggregate_error_string.argtypes = [ctypes.c_int]
    lib.quorum_aggregate_error_string.restype = ctypes.c_char_p
    return lib
