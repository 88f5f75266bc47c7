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
``csrc/flash_attention_bwd.cu`` on the card (three CUDA launches a call,
counted once in ``flash_attention_bwd.launches``), the plain formula
:func:`flash_attention_bwd_ref` on the CPU. dq, dk and dv come back laid
out as the model's projections are, (B, Sq, KV, G, D) and (B, Skv, KV, D)
in memory, so the views' backward copies nothing;
``flash_attention_bwd.copies`` counts operands it had to make contiguous
(an upstream gradient with a stride on its last axis).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels._layout import (aligned, on_device, stream_handle,
                                         strides)

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 96, 128)        # the kernel's instantiated D
WGMMA_HEAD_DIMS = (64, 128)          # bf16 on the tensor cores
_DTYPES = (torch.float32, torch.bfloat16)


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
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not "
                         f"{q.device}")
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


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True):
    """Gradients of :func:`flash_attention` for the upstream gradient
    ``do`` (o's shape): (dq, dk, dv) in q's dtype, dq as a (B, KV, G, Sq,
    D) view of (B, Sq, KV, G, D) memory and dk, dv as (B, KV, Skv, D)
    views of (B, Skv, KV, D). The hand-written kernel on the card,
    :func:`flash_attention_bwd_ref` on the CPU."""
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, "
                         f"not {q.device}")
    if any(t.device != q.device for t in (k, v, o, do)):
        raise ValueError("all operands must be on one device")
    B, KV, G, Sq, D = q.shape
    Skv = k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    ops_in = []
    for t in (q, k, v, o, do.to(q.dtype)):
        if t.stride(-1) != 1:
            t = t.contiguous()
            flash_attention_bwd.copies += 1
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
    lib = _bwd_library()
    with on_device(q.device):
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats[0].data_ptr(), stats[1].data_ptr(), st, B, KV, G, Sq, Skv,
            D, int(causal), 1.0 / math.sqrt(D),
            int(q.dtype == torch.bfloat16), stream_handle(q.device))
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
        [ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p])
    lib.flash_attention_bwd.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib
