"""One-token GQA decode attention against a KV cache.

    q (B, KV, G, D), k/v caches (B, KV, S, D), length → o (B, KV, G, D)

``o = softmax_j(q·k_j / sqrt(D)) · v`` over the first ``length`` cache
positions, fp32 inside, in q's dtype. With ``return_lse=True`` also the
(B, KV, G) fp32 log-sum-exp of each row's scaled scores,
``lse = log Σ_j exp(q·k_j / sqrt(D))``: a tensor-parallel decode step that
holds the cache in sequence blocks on several ranks merges the blocks'
outputs by their weights ``exp(lse_r − logsumexp_r lse_r)``. A row over no
position (``length`` 0) gets o = 0 and lse = −inf on both routes, so that
such a block weighs nothing in the merge.

:func:`decode_attention` launches the hand-written CUDA kernel
``csrc/decode_attention.cu`` on CUDA tensors and takes the plain version
:func:`decode_attention_ref` only for tensors that lie on the CPU. A failed
build or launch raises; nothing falls back. ``decode_attention.launches``
counts kernel launches (plain-version calls do not count).

``length`` is a Python int or a one-element int32 tensor on q's device,
which the kernel reads on the card (no host sync). q and the caches may be
strided views with a unit stride on the last axis, so the model passes
views of its (B, S, KV, D) cache; the kernel reads the caches 16 bytes at
a time and takes a contiguous copy of a cache whose base or strides are
not 16-byte aligned (the model's are). Positions at or past ``length`` are
never read.

On the card :func:`split_plan` spreads each (b, kv head, chunk of query
heads) over several blocks, fixed at launch from the shapes and the SM
count; the kernel divides ``[0, length)`` among them after it reads
``length`` and merges their partial softmax states in the same launch,
the last block of each group through a ticket counter. The counters
(int32, zeroed once and left zeroed by every call) and the scratch of
partial states are kept per device and shape, so calls on one device must
not overlap on two streams.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import build
from repro_torch.kernels._layout import (aligned, no_backward, num_sms,
                                         on_device, plain, plain_route,
                                         stream_handle)

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 96, 128)        # the kernel's instantiated D
_DTYPES = (torch.float32, torch.bfloat16)
BLOCKS_PER_SM = 2                    # the split plan's target occupancy
MIN_SPLIT_ROWS = 16                  # cache capacity per split, at least
MAX_SPLITS = 64                      # the kernel's merge takes at most 64

Length = Union[int, torch.Tensor]


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, length: Length, *,
                         return_lse: bool = False):
    """Plain version: q (B, KV, G, D); caches (B, KV, S, D); length an int
    or a one-element tensor. Returns o, or (o, lse) with ``return_lse``.
    Past a length of 0 the masked softmax is the kernel's; at 0 (every
    position masked by the finite ``NEG_INF``, whose softmax would be the
    mean of v) o is 0 and lse −inf, as the kernel gives them."""
    S, D = k_cache.shape[2], q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhgd,bhsd->bhgs", q.float(), k_cache.float()) * scale
    if isinstance(length, torch.Tensor):
        length = length.reshape(())
    mask = torch.arange(S, device=q.device) < length
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float()).to(q.dtype)
    empty = torch.as_tensor(length, device=q.device) <= 0
    o = torch.where(empty, 0, o)
    if not return_lse:
        return o
    lse = torch.where(empty, -math.inf, torch.logsumexp(s, dim=-1))
    return o, lse


def head_chunk(G: int) -> int:
    """Query heads a block takes: G itself when it is 1 or 2, 4 for G 3
    and 4, else 8 (the kernel's template argument)."""
    return G if G <= 2 else 4 if G <= 4 else 8


def split_plan(B: int, KV: int, G: int, S: int, sms: int) -> int:
    """Blocks that share one (b, kv head, chunk of query heads): enough
    for about ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs, at most
    one per ``MIN_SPLIT_ROWS`` rows of the cache's capacity S and at most
    ``MAX_SPLITS``, at least one. A function of the shapes alone, never of
    ``length``."""
    groups = B * KV * -(-G // head_chunk(G))
    want = -(-BLOCKS_PER_SM * sms // max(groups, 1))
    return max(1, min(want, S // MIN_SPLIT_ROWS, MAX_SPLITS))


def _check(q, k_cache, v_cache, length) -> None:
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError(f"q (B, KV, G, D) and caches (B, KV, S, D) "
                         f"expected, got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    B, KV, _, D = q.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[1] != KV or k_cache.shape[3] != D):
        raise ValueError(f"caches {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if (q.dtype not in _DTYPES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise TypeError(f"q and the caches must share one dtype, float32 or "
                        f"bfloat16; got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if isinstance(length, torch.Tensor) and length.numel() != 1:
        raise ValueError(f"length must be an int or a one-element tensor, "
                         f"got shape {tuple(length.shape)}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: Length, *,
                     return_lse: bool = False):
    """q: (B, KV, G, D); caches: (B, KV, S, D), one dtype (f32/bf16);
    length: the number of valid cache positions. Returns o (B, KV, G, D)
    in q's dtype, or (o, lse (B, KV, G) fp32) with ``return_lse``."""
    _check(q, k_cache, v_cache, length)
    if plain_route(q.device):
        return plain("decode_attention", decode_attention_ref, q, k_cache,
                     v_cache, length, return_lse=return_lse)
    no_backward("decode_attention", q, k_cache, v_cache)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda, cpu or meta "
                         f"tensors, not {q.device}")
    if k_cache.device != q.device or v_cache.device != q.device:
        raise ValueError("all operands must be on one device")
    if isinstance(length, torch.Tensor):
        if length.device != q.device or length.dtype != torch.int32:
            raise TypeError("a tensor length must be int32 on q's device")
        length_ptr, length_val = length.data_ptr(), 0
    else:
        length_ptr, length_val = None, int(length)
    if any(t.stride(-1) != 1 for t in (q, k_cache, v_cache)):
        raise ValueError("decode_attention needs a unit stride on the last "
                         "axis of q and the caches")
    B, KV, G, D = q.shape
    S = k_cache.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    out = torch.empty((B, KV, G, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, KV, G), dtype=torch.float32,
                      device=q.device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out    # no query rows
    ks, vs = k_cache.stride(), v_cache.stride()
    if (k_cache.data_ptr() | v_cache.data_ptr() | (
            ks[0] | ks[1] | ks[2] | vs[0] | vs[1] | vs[2]) * q.element_size()
            ) % 16:                 # one test for the usual, aligned caches
        k_cache, v_cache = aligned(k_cache, 16), aligned(v_cache, 16)
        ks, vs = k_cache.stride(), v_cache.stride()
    nsplit, ws, counters, _ = _launch_plan(q.device.index, B, KV, G, S, D)
    lib = _library()
    with on_device(q.device):
        rc = lib.decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            *q.stride()[:3], *ks[:3], *vs[:3], B, KV, G, S,
            D, length_ptr, length_val, 1.0 / math.sqrt(D),
            int(q.dtype == torch.bfloat16), nsplit, ws, counters,
            stream_handle(q.device))
    if rc != 0:
        msg = lib.decode_attention_error_string(rc).decode()
        raise RuntimeError(f"decode_attention launch failed: {msg} ({rc})")
    decode_attention.launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0


@functools.lru_cache(maxsize=256)
def _launch_plan(index: int, B: int, KV: int, G: int, S: int, D: int
                 ) -> Tuple[int, Optional[int], Optional[int],
                            Tuple[torch.Tensor, ...]]:
    """``(splits, scratch, counters, buffers)`` of one shape on one
    device: :func:`split_plan`, then, when it splits, the addresses of an
    fp32 scratch for the splits' partial states and of the int32 ticket
    counters (zeroed here, left zeroed by every call), and the two tensors
    that own them. Kept across calls (calls on one stream run in order),
    so a call does no planning or allocation of its own."""
    nsplit = split_plan(B, KV, G, S, num_sms(index))
    if nsplit == 1:
        return 1, None, None, ()
    dev = torch.device("cuda", index)
    counters = torch.zeros(B * KV * -(-G // head_chunk(G)), dtype=torch.int32,
                           device=dev)
    ws = torch.empty(B * KV * G * nsplit * (D + 2), dtype=torch.float32,
                     device=dev)
    return nsplit, ws.data_ptr(), counters.data_ptr(), (ws, counters)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("decode_attention")
    lib.decode_attention.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    lib.decode_attention.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib
