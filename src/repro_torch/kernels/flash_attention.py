"""Causal (or full) GQA prefill attention, flash style.

    q (B, KV, G, Sq, D), k/v (B, KV, Skv, D) → o (B, KV, G, Sq, D)

``o[b, h, g, i] = softmax_j(q·k_j / sqrt(D)) · v`` over the keys ``j <= i``
(causal) or all of them, fp32 inside, in q's dtype. Query head ``h·G + g``
of the model reads kv head ``h``.

:func:`flash_attention` launches the hand-written CUDA kernel
``csrc/flash_attention.cu`` on CUDA tensors and takes the plain version
:func:`flash_attention_ref` only for tensors that lie on the CPU. A failed
build or launch raises; nothing falls back. ``flash_attention.launches``
counts kernel launches (plain-version calls do not count).

On the card the kernel is chosen by dtype and head dim: bf16 at D = 64
and 128 runs both products on the tensor cores (``wgmma``, K/V tiles
staged by TMA; P is rounded to bf16 before P·V, which the plain version
does not do, within the bf16 bound), fp32 and bf16 at D = 32 and 96 the
CUDA-core kernel. q, k and v may be strided views (unit stride on the
last axis only), so the model passes views of its projections without a
copy; the tensor-core kernel reads k and v through TMA, which needs their
base and strides 16-byte aligned (and q's 4-byte aligned), and takes a
contiguous copy of an operand that is not (the model's never needs one).
The output is laid out (B, Sq, KV, G, D) in memory and returned as the
(B, KV, G, Sq, D) view, so the model's ``(B, Sq, H·D)`` reshape is free.
Any Sq and Skv work (the TPU kernel needs multiples of its blocks).

Where autograd needs it (grad mode on and q, k or v requiring a
gradient), :func:`flash_attention` goes through a
``torch.autograd.Function`` whose forward is the same launch and whose
backward is :func:`flash_attention_bwd`: the hand-written
``csrc/flash_attention_bwd.cu`` on the card (counted once a call in
``flash_attention_bwd.launches``), the plain formula
:func:`flash_attention_bwd_ref` on the CPU. Its route follows the
forward's, by dtype and head dim (:func:`bwd_plan`): bf16 at D = 64 and
128 runs every product on the tensor cores (``wgmma``) in two launches, a
warpgroup per 64-row query tile (lse, Δ and dQ) and two per 64-key tile
(dK and dV), P and dS rounded to bf16 before their products (within the
bf16 bound); fp32, and bf16 at D = 32 and 96, the CUDA-core kernels in
three launches. No atomics on either route: reruns give the same bits.
dq, dk and dv come back laid out as the model's projections are,
(B, Sq, KV, G, D) and (B, Skv, KV, D) in memory, so the views' backward
copies nothing; ``flash_attention_bwd.copies`` counts operands it had to
copy (an upstream gradient with a stride on its last axis, or, on the
tensor route, an operand whose base or strides are off 16 bytes).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels._layout import (aligned, on_device, plain,
                                         plain_route, stream_handle, strides)

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 96, 128)        # the kernel's instantiated D
WGMMA_HEAD_DIMS = (64, 128)          # bf16 on the tensor cores
_DTYPES = (torch.float32, torch.bfloat16)
BWD_TILE = 64                        # tensor-route backward: rows, keys a tile


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """Plain version: q (B, KV, G, Sq, D); k, v (B, KV, Skv, D)."""
    Sq, D = q.shape[-2:]
    Skv = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhgqd,bhsd->bhgqs", q.float(), k.float()) * scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None]
        ki = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqs,bhsd->bhgqd", p, v.float()).to(q.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q (B, KV, G, Sq, D) and k, v (B, KV, Skv, D) "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    B, KV, _, _, D = q.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[1] != KV
            or k.shape[3] != D):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one dtype, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, KV, G, Sq, D); k, v: (B, KV, Skv, D), one dtype (f32/bf16).
    Returns (B, KV, G, Sq, D) in q's dtype, differentiable in q, k, v."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal)


class _FlashAttention(torch.autograd.Function):
    """The forward launch, and :func:`flash_attention_bwd` as its
    backward (q, k, v and the output saved, the output as its view)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o = _forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, causal=ctx.causal)
        need = ctx.needs_input_grad
        return (dq if need[0] else None, dk if need[1] else None,
                dv if need[2] else None, None)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool) -> torch.Tensor:
    """The kernel on the card, the plain version on the CPU."""
    if plain_route(q.device):
        return plain("flash_attention", flash_attention_ref, q, k, v,
                     causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda, cpu or meta "
                         f"tensors, not {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("all operands must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs a unit stride on the last "
                         "axis of q, k and v")
    B, KV, G, Sq, D = q.shape
    Skv = k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    out = torch.empty((B, Sq, KV, G, D), dtype=q.dtype, device=q.device)
    o = out.permute(0, 2, 3, 1, 4)                  # (B, KV, G, Sq, D) view
    if q.numel() == 0:
        return o                                    # no query rows
    if Skv == 0:
        return o.zero_()                            # nothing to attend to
    if q.dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS:
        q = aligned(q, 4)
        k, v = aligned(k, 16), aligned(v, 16)
    lib = _library()
    with on_device(q.device):
        rc = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            *strides(q)[:4], *strides(k)[:3], *strides(v)[:3],
            *o.stride()[:4], B, KV, G, Sq, Skv, D,
            int(causal), 1.0 / math.sqrt(D), int(q.dtype == torch.bfloat16),
            stream_handle(q.device))
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({rc})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, causal: bool = True):
    """Plain backward, as the formula: P from q and k, Δ = rowsum(dO∘O),
    dS = P∘(dO·vᵀ − Δ), dq = scale·dS·k, dk = scale·Σ_g dSᵀ·q, dv =
    Σ_g Pᵀ·dO; fp32 inside, each gradient in q's dtype."""
    Sq, D = q.shape[-2:]
    Skv = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhgqd,bhsd->bhgqs", qf, kf) * scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None]
        ki = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(ki <= qi, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    dp = torch.einsum("bhgqd,bhsd->bhgqs", dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqs,bhsd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqs,bhgqd->bhsd", ds, qf) * scale
    dv = torch.einsum("bhgqs,bhgqd->bhsd", p, dof)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


class BwdPlan(NamedTuple):
    """The backward's launches at one shape (:func:`bwd_plan`). On the
    tensor route each launch runs a block per (slot, b·KV + h), block
    ``n`` taking slot ``n // heads`` and pair ``n % heads``: every (b, kv
    head) of a tile side by side, the slots in the order given. The kernels
    read the slots as they are here; the CUDA-core route plans none."""
    route: str          # "wgmma" (bf16 at D 64/128) or "cuda_cores"
    launches: int       # kernels a call runs in stream order (2 or 3)
    heads: int          # B * KV: the (b, kv head) pairs
    dq: Tuple[Tuple[int, int, int], ...]
    # the dq launch, a slot a 64-row query tile (rows r = i*G + g):
    # (query tile, key tiles 0.. it walks, the first of them that needs an
    # element mask; the unmasked ones are a prefix)
    dkdv: Tuple[Tuple[int, int, int, int, int], ...]
    # the dkdv launch, a slot a 64-key tile: (key tile, first row tile it
    # walks, row tiles walked, and [lo, hi) the row tiles needing no mask)


def bwd_route(dtype: torch.dtype, D: int) -> str:
    """The backward's route, from dtype and head dim alone, as the
    forward's: the tensor cores for bf16 at D 64 and 128."""
    if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "cuda_cores"


@functools.lru_cache(maxsize=256)
def bwd_plan(dtype: torch.dtype, B: int, KV: int, G: int, Sq: int, Skv: int,
             D: int, causal: bool) -> BwdPlan:
    """The route of :func:`flash_attention_bwd` at a shape and, on the
    tensor route, its launches' slots: the last query tiles (the causal
    triangle's heaviest) first in the dq launch and the first key tiles
    (seen by the most rows) first in the dkdv launch; each walks only the
    tiles holding a pair it can see (top-left causal: key j <= position
    i), and masks element by element only those holding a pair it must
    not count (above the diagonal, past Sq·G or Skv). Key tiles past Sq
    walk no rows: their block writes zero gradients."""
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    route = bwd_route(dtype, D)
    if route != "wgmma":
        return BwdPlan(route, 3, B * KV, (), ())
    T, R = BWD_TILE, Sq * G
    dq = []
    for qt in reversed(range(-(-R // T))):
        i_lo, i_hi = qt * T // G, (min(qt * T + T, R) - 1) // G
        n = -(-(min(Skv, i_hi + 1) if causal else Skv) // T)
        full = [t for t in range(n) if t * T + T <= Skv
                and not (causal and t * T + T - 1 > i_lo)]
        assert full == list(range(len(full)))
        dq.append((qt, n, len(full)))
    dkdv = []
    for kt in range(-(-Skv // T)):
        j0 = kt * T
        start = min(R, j0 * G) if causal else 0     # a multiple of T below R
        walk = range(start // T, start // T + -(-(R - start) // T))
        full = [t for t in walk if j0 + T <= Skv and t * T + T <= R
                and not (causal and j0 + T - 1 > t * T // G)]
        lo, hi = (full[0], full[-1] + 1) if full else (0, 0)
        assert full == list(range(lo, hi))
        dkdv.append((kt, walk.start, len(walk), lo, hi))
    return BwdPlan(route, 2, B * KV, tuple(dq), tuple(dkdv))


@functools.lru_cache(maxsize=64)
def _slots(plan: BwdPlan, device: torch.device) -> torch.Tensor:
    """The plan's slots as the kernels read them: int32 on ``device``, the
    dq launch's then the dkdv launch's."""
    flat = [n for slot in plan.dq + plan.dkdv for n in slot]
    return torch.tensor(flat, dtype=torch.int32, device=device)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True):
    """Gradients of :func:`flash_attention` for the upstream gradient
    ``do`` (o's shape): (dq, dk, dv) in q's dtype, dq as a (B, KV, G, Sq,
    D) view of (B, Sq, KV, G, D) memory and dk, dv as (B, KV, Skv, D)
    views of (B, Skv, KV, D). The hand-written kernels on the card, on the
    route and slots of :func:`bwd_plan`; :func:`flash_attention_bwd_ref`
    on the CPU."""
    return _bwd(q, k, v, o, do, causal, cuda_cores=False)


def _bwd(q, k, v, o, do, causal: bool, cuda_cores: bool):
    """:func:`flash_attention_bwd`; ``cuda_cores`` runs the CUDA-core
    kernels whatever the plan's route (``chip_smoke.py`` times them at the
    tensor route's shapes as its yardstick)."""
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if plain_route(q.device):
        return plain("flash_attention_bwd", flash_attention_bwd_ref, q, k,
                     v, o, do, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, "
                         f"not {q.device}")
    if any(t.device != q.device for t in (k, v, o, do)):
        raise ValueError("all operands must be on one device")
    B, KV, G, Sq, D = q.shape
    Skv = k.shape[2]
    plan = bwd_plan(q.dtype, B, KV, G, Sq, Skv, D, bool(causal))
    tensor_route = plan.route == "wgmma" and not cuda_cores
    ops_in = []
    for t in (q, k, v, o, do.to(q.dtype)):
        if t.stride(-1) != 1:
            t = t.contiguous()
            flash_attention_bwd.copies += 1
        elif tensor_route:
            a = aligned(t, 16)          # cp.async reads rows 16 bytes at a time
            flash_attention_bwd.copies += a is not t
            t = a
        ops_in.append(t)
    q, k, v, o, do = ops_in
    dq = torch.empty((B, Sq, KV, G, D), dtype=q.dtype,
                     device=q.device).permute(0, 2, 3, 1, 4)
    dk = torch.empty((B, Skv, KV, D), dtype=q.dtype,
                     device=q.device).permute(0, 2, 1, 3)
    dv = torch.empty((B, Skv, KV, D), dtype=q.dtype,
                     device=q.device).permute(0, 2, 1, 3)
    if q.numel() == 0 or Skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    stats = torch.empty((2, B * KV * G * Sq), dtype=torch.float32,
                        device=q.device)
    st = (ctypes.c_longlong * 28)(
        *strides(q)[:4], *strides(k)[:3], *strides(v)[:3], *strides(o)[:4],
        *strides(do)[:4], *dq.stride()[:4], *dk.stride()[:3],
        *dv.stride()[:3])
    slots = _slots(plan, q.device).data_ptr() if tensor_route else None
    lib = _bwd_library()
    with on_device(q.device):
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(), st, slots,
            len(plan.dq), len(plan.dkdv), B, KV, G, Sq, Skv, D, int(causal),
            1.0 / math.sqrt(D), int(q.dtype == torch.bfloat16),
            stream_handle(q.device))
    if rc != 0:
        msg = lib.flash_attention_bwd_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_bwd launch failed: {msg} ({rc})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.copies = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("flash_attention")
    lib.flash_attention.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 14 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    """The built backward library with its C signature declared."""
    lib = build.load("flash_attention_bwd")
    lib.flash_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_longlong),
                                  ctypes.c_void_p]
        + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p])
    lib.flash_attention_bwd.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib
