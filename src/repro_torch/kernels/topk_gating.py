"""MoE router gating: softmax over E experts, k rounds of argmax-and-mask,
renormalisation.

    logits (N, E) fp32 → weights (N, k) fp32 summing to 1, indices (N, k) int32

Ties go to the lowest expert index, as ``argmax`` and ``lax.top_k`` break
them. :func:`topk_gating` launches the hand-written CUDA kernel
``csrc/topk_gating.cu`` on a CUDA tensor and takes the plain version
:func:`topk_gating_ref` only for tensors that lie on the CPU. A failed
build or launch raises; nothing falls back. ``topk_gating.launches`` counts
kernel launches (plain-version calls do not count). Any N works, N = 0
included; E up to 256 on the card.

The kernel gives each row a group of lanes, reads the row 16 bytes at a
time and keeps it, and every round's result, in registers. :func:`plan`
chooses its launch from the shape: lanes per row from E, the vector width
(the scalar route where E is not a multiple of 4 or the base is not
16-byte aligned), the accesses per lane and the rows per block.

Where grad mode is on and the logits need a gradient, :func:`topk_gating`
is a ``torch.autograd.Function`` (the moe and hybrid families' routers
train through it) whose backward :func:`topk_gating_bwd` launches the
hand-written ``csrc/topk_gating_bwd.cu`` on the card (the forward's row
layout, :func:`bwd_plan`) and takes :func:`topk_gating_bwd_ref` on the
CPU; the indices carry no gradient. ``topk_gating_bwd.launches`` counts
its launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels._layout import (num_sms, on_device, plain,
                                         plain_route, stream_handle)

NEG_INF = -1e30
MAX_EXPERTS = 256                      # 32 lanes x 8 values in registers
MAX_THREADS = 256                      # the kernel's launch bound
VECTOR_NV = (1, 2)                     # 16-byte accesses a lane holds
SCALAR_NV = (1, 2, 4, 8)               # elements a lane holds (scalar route)


class GatingPlan(NamedTuple):
    """One launch of the kernel."""
    vec: int             # elements per access: 4 (16 bytes) or 1
    nv: int              # accesses per lane (compile-time)
    lanes: int           # lanes per row: a power of two from 2 to 32
    rows_per_block: int  # rows a block routes: a whole number of warps
    blocks: int          # the grid: one row group per block


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


@functools.lru_cache(maxsize=256)
def plan(N: int, E: int, k: int, aligned: bool, sms: int) -> GatingPlan:
    """The launch for N rows of E logits routed to k experts. Lanes per
    row: one per 16 bytes of the row (E / 4), rounded up to a power of two
    within [2, 32], so E 64 takes 16 lanes, E 16 four and E 8 two; past 128
    experts each of the 32 lanes reads two accesses. 16-byte accesses where
    E is a multiple of 4 and the logits are ``aligned``, else the scalar
    route (one element an access, up to 8 a lane). A block holds as many
    warps as spread the rows over the ``sms`` SMs in one wave, up to
    ``MAX_THREADS`` threads."""
    if not 0 < k <= E <= MAX_EXPERTS:
        raise ValueError(f"the kernel takes 0 < k <= E <= {MAX_EXPERTS}, "
                         f"got k={k}, E={E}")
    vec = 4 if aligned and E % 4 == 0 else 1
    lanes = min(32, max(2, 1 << (-(-E // 4) - 1).bit_length()))
    need = -(-E // (lanes * vec))
    nv = next(n for n in (VECTOR_NV if vec > 1 else SCALAR_NV) if n >= need)
    per_warp = 32 // lanes
    warps = -(-N // per_warp)
    wpb = max(1, min(MAX_THREADS // 32, -(-warps // sms)))
    rpb = wpb * per_warp
    return GatingPlan(vec, nv, lanes, rpb, max(1, -(-N // rpb)))


def topk_gating(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits: (N, E) fp32. Returns (weights (N, k) fp32, indices (N, k)
    int32); the weights differentiable in the logits."""
    _check(logits, k)
    if torch.is_grad_enabled() and logits.requires_grad:
        return _TopkGating.apply(logits, k)
    return _forward(logits, k)


class _TopkGating(torch.autograd.Function):
    """The forward launch, and :func:`topk_gating_bwd` as its backward;
    the indices carry no gradient."""

    @staticmethod
    def forward(ctx, logits, k):
        w, idx = _forward(logits, k)
        ctx.save_for_backward(logits, idx, w)
        ctx.mark_non_differentiable(idx)
        ctx.set_materialize_grads(False)
        return w, idx

    @staticmethod
    def backward(ctx, dw, didx=None):
        if dw is None:
            return None, None
        logits, idx, w = ctx.saved_tensors
        return topk_gating_bwd(logits, idx, w, dw), None


def _forward(logits: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on the card, the plain version on the CPU."""
    dev = logits.device
    if plain_route(dev):
        return plain("topk_gating", topk_gating_ref, logits, k)
    if dev.type != "cuda":
        raise ValueError(f"topk_gating runs on cuda, cpu or meta "
                         f"tensors, not {dev}")
    N, E = logits.shape
    if E > MAX_EXPERTS:
        raise ValueError(f"the kernel takes E <= {MAX_EXPERTS}, got {E}")
    if not logits.is_contiguous():
        raise ValueError("topk_gating needs contiguous logits")
    w = torch.empty((N, k), dtype=torch.float32, device=dev)
    idx = torch.empty((N, k), dtype=torch.int32, device=dev)
    if N == 0:
        return w, idx                  # nothing to route
    p = plan(N, E, k, logits.data_ptr() % 16 == 0, num_sms(dev.index))
    lib = _library()
    with on_device(dev):
        rc = lib.topk_gating(logits.data_ptr(), w.data_ptr(), idx.data_ptr(),
                             N, E, k, p.vec, p.nv, p.lanes, p.rows_per_block,
                             p.blocks, stream_handle(dev))
    if rc != 0:
        msg = lib.topk_gating_error_string(rc).decode()
        raise RuntimeError(f"topk_gating launch failed: {msg} ({rc})")
    topk_gating.launches += 1
    return w, idx


topk_gating.launches = 0


def topk_gating_bwd_ref(logits: torch.Tensor, idx: torch.Tensor,
                        w: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """Plain backward: dlogits (N, E) fp32 for the gradient ``dw`` of the
    weights ``w`` routed to ``idx``. With p = softmax(logits), t_j =
    p[idx_j] and s = Σ_j t_j: dt_j = (dw_j − Σ_i dw_i·w_i)/s where s >
    1e-9, else dw_j/1e-9 (the clamp's branch); dlogits = p ⊙ scatter(dt)
    − p·Σ_j dt_j·t_j. fp32 inside (fp64 for fp64 operands)."""
    acc = torch.promote_types(logits.dtype, torch.float32)
    p = torch.softmax(logits.to(acc), dim=-1)
    ix = idx.long()
    t = p.gather(-1, ix)
    s = t.sum(-1, keepdim=True)
    wf, dwf = w.to(acc), dw.to(acc)
    dt = torch.where(s > 1e-9, (dwf - (dwf * wf).sum(-1, keepdim=True)) / s,
                     dwf / 1e-9)
    dp = torch.zeros_like(p).scatter_(-1, ix, dt)     # indices are distinct
    return p * dp - p * (dt * t).sum(-1, keepdim=True)


def bwd_plan(N: int, E: int, k: int, aligned: bool, sms: int) -> GatingPlan:
    """The backward's launch: the forward's row layout (:func:`plan`), with
    ``aligned`` true where both the logits and dlogits start on 16 bytes."""
    return plan(N, E, k, aligned, sms)


def topk_gating_bwd(logits: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                    dw: torch.Tensor) -> torch.Tensor:
    """Gradient of :func:`topk_gating`'s weights in the logits, (N, E)
    fp32: the hand-written kernel ``csrc/topk_gating_bwd.cu`` on the card
    (each row's softmax recomputed in registers, dlogits written once),
    :func:`topk_gating_bwd_ref` on the CPU."""
    if logits.dim() != 2 or idx.shape != w.shape or dw.shape != w.shape \
            or idx.dim() != 2 or idx.shape[0] != logits.shape[0]:
        raise ValueError(f"logits (N, E) and idx, w, dw (N, k) expected, got "
                         f"{tuple(logits.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(w.shape)}, {tuple(dw.shape)}")
    _check(logits, idx.shape[1])
    dev = logits.device
    if plain_route(dev):
        return plain("topk_gating_bwd", topk_gating_bwd_ref, logits, idx,
                     w, dw)
    if dev.type != "cuda":
        raise ValueError(f"topk_gating_bwd runs on cuda, cpu or meta "
                         f"tensors, not {dev}")
    if any(t.device != dev for t in (idx, w, dw)):
        raise ValueError("all operands must be on one device")
    N, E = logits.shape
    k = idx.shape[1]
    if E > MAX_EXPERTS:
        raise ValueError(f"the kernel takes E <= {MAX_EXPERTS}, got {E}")
    logits = logits.contiguous()
    idx = idx.to(torch.int32).contiguous()
    w, dw = w.float().contiguous(), dw.float().contiguous()
    dl = torch.empty((N, E), dtype=torch.float32, device=dev)
    if N == 0:
        return dl                      # nothing to route
    p = bwd_plan(N, E, k, (logits.data_ptr() | dl.data_ptr()) % 16 == 0,
                 num_sms(dev.index))
    lib = _bwd_library()
    with on_device(dev):
        rc = lib.topk_gating_bwd(logits.data_ptr(), idx.data_ptr(),
                                 w.data_ptr(), dw.data_ptr(), dl.data_ptr(),
                                 N, E, k, p.vec, p.nv, p.lanes,
                                 p.rows_per_block, p.blocks,
                                 stream_handle(dev))
    if rc != 0:
        msg = lib.topk_gating_bwd_error_string(rc).decode()
        raise RuntimeError(f"topk_gating_bwd launch failed: {msg} ({rc})")
    topk_gating_bwd.launches += 1
    return dl


topk_gating_bwd.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("topk_gating")
    lib.topk_gating.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                                + [ctypes.c_void_p])
    lib.topk_gating.restype = ctypes.c_int
    lib.topk_gating_error_string.argtypes = [ctypes.c_int]
    lib.topk_gating_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    """The built backward library with its C signature declared."""
    lib = build.load("topk_gating_bwd")
    lib.topk_gating_bwd.argtypes = ([ctypes.c_void_p] * 5
                                    + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.topk_gating_bwd.restype = ctypes.c_int
    lib.topk_gating_bwd_error_string.argtypes = [ctypes.c_int]
    lib.topk_gating_bwd_error_string.restype = ctypes.c_char_p
    return lib
