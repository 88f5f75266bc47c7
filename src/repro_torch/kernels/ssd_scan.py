"""Mamba2 SSD chunked scan (state-space duality, arXiv:2405.21060).

    x (..., L, P), dt (..., L), A (...), Bm/Cm (..., L, N) → y (..., L, P)

where ``...`` is (BH,) or (B, H). With Q = min(chunk, L), la = dt·A and
cum its cumulative sum inside each chunk of Q steps:

    y[t] = Σ_{s≤t in the chunk} C_t·B_s · exp(cum_t − cum_s) · x_s·dt_s
           + C_t·(h · exp(cum_t))
    h'   = h · exp(cum_Q) + Σ_s exp(cum_Q − cum_s) · (x_s·dt_s) ⊗ B_s

the recurrence of the JAX package's ``kernels/ssd_scan.py`` and
``models/ssm.py:ssd_chunked``, fp32 inside. ``L % Q`` must be 0. Beside y
(in x's dtype, or ``out_dtype``) the scan can return the final fp32 state
h (..., P, N), which the TPU kernel keeps in scratch and a prefill caches.

On CUDA tensors :func:`ssd_scan` launches the hand-written kernels of
``csrc/ssd_scan.cu`` and takes the plain version :func:`ssd_scan_ref`
only for tensors that lie on the CPU. A failed build or launch raises;
nothing falls back. Two kernels, chosen by dtype and shape:

- bf16 x, B and C with P and N multiples of 16 (P <= 128, P·N <= 8192),
  serving's path: the tensor-core kernel (``mma.sync``, fp32 factors as
  TERMS bf16 terms each), two CUDA launches per call in stream order
  (:func:`mma_plan`): (a) each chunk's own state, and in the last block of
  each (batch row, head) the states passed between chunks; (b) the outputs
  per (batch row, chunk, 64-row t-tile, group of heads), C·Bᵀ computed
  once for the group when the heads share B and C (stride 0 over heads);
- fp32 operands, and bf16 shapes outside that range: the CUDA-core
  kernel, one launch per call.

``ssd_scan.launches`` counts wrapper calls that launched a kernel
(plain-version calls do not count). The tensor-core path's ticket counters
(int32, zeroed once and left zeroed by every call) are kept per device and
number of rows, so calls on one device must not overlap on two streams.

On the card the operands may be strided views with unit stride on their
last axis (dt and A any strides, stride 0 included), so the model passes
its (B, L, H, P) projection permuted to (B, H, L, P) and its head-shared
B/C expanded over H without a copy; the tensor-core kernel reads x, B and
C 16 bytes at a time and takes a contiguous copy of one whose base or
strides are not 16-byte aligned (the model's are). For (B, H) leading
axes, y is laid out (B, L, H, P) in memory and returned as the (B, H, L,
P) view, so the model's reshape back is free.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels._layout import (aligned, no_backward, num_sms,
                                         on_device, stream_handle)

_DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232448                    # bytes a block may use on Hopper
TILE = 64                              # t and s rows of the tensor-core tiles
PAD = 8                                # bf16 padding of a shared-memory row
HEAD_GROUPS = (4, 1)                   # the tensor-core kernel's head groups
BLOCKS_PER_SM = 4                      # launch (b)'s blocks per SM, at least
TERMS = 3                              # bf16 terms an fp32 factor enters as


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
                 return_state: bool = False,
                 out_dtype: Optional[torch.dtype] = None):
    """Plain version: the chunked form, all chunks' quadratic parts at once
    and the state carried over the chunks in a loop."""
    lead, (L, P), N = x.shape[:-2], x.shape[-2:], Bm.shape[-1]
    Q = _chunk(L, chunk)
    BH, nc = math.prod(lead), L // Q
    f32 = torch.float32
    xf = x.to(f32).reshape(BH, nc, Q, P)
    dtf = dt.to(f32).reshape(BH, nc, Q)
    Bf = Bm.to(f32).reshape(BH, nc, Q, N)
    Cf = Cm.to(f32).reshape(BH, nc, Q, N)
    cum = torch.cumsum(dtf * A.to(f32).reshape(BH, 1, 1), dim=-1)
    xb = xf * dtf[..., None]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(~causal,
                                                              float("-inf"))
    scores = (Cf @ Bf.transpose(-1, -2)) * torch.exp(seg)   # (BH,nc,Q,Q)
    y_intra = scores @ xb
    h = xf.new_zeros((BH, P, N))
    ys = []
    for c in range(nc):
        y_inter = (Cf[:, c] @ h.transpose(-1, -2)) * torch.exp(
            cum[:, c])[..., None]
        ys.append(y_intra[:, c] + y_inter)
        last = cum[:, c, -1:]
        xs = xb[:, c] * torch.exp(last - cum[:, c])[..., None]
        h = h * torch.exp(last)[..., None] + xs.transpose(-1, -2) @ Bf[:, c]
    y = torch.stack(ys, 1).reshape(*lead, L, P).to(out_dtype or x.dtype)
    if return_state:
        return y, h.reshape(*lead, P, N)
    return y


def _chunk(L: int, chunk: int) -> int:
    """Q = min(chunk, L); the reference requires L % Q == 0."""
    Q = min(chunk, L)
    if Q < 1 or L % Q:
        raise ValueError(f"sequence length {L} is not a positive multiple of "
                         f"the chunk {Q}")
    return Q


def _check(x, dt, A, Bm, Cm) -> None:
    if x.dim() not in (3, 4):
        raise ValueError(f"x (BH, L, P) or (B, H, L, P) expected, got "
                         f"{tuple(x.shape)}")
    lead, L = x.shape[:-2], x.shape[-2]
    want = {"dt": (*lead, L), "A": tuple(lead),
            "Bm": (*lead, L, Bm.shape[-1]), "Cm": (*lead, L, Bm.shape[-1])}
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} {tuple(t.shape)} does not match x "
                             f"{tuple(x.shape)}: expected {want[name]}")


class MmaPlan(NamedTuple):
    """The tensor-core kernel's launch plan for one call: the head group,
    the blocks of launches (a) and (b) and their shared-memory bytes."""

    head_group: int
    blocks_a: int
    blocks_b: int
    smem_a: int
    smem_b: int


def mma_takes(P: int, N: int) -> bool:
    """P and N that the tensor-core kernel's tiles take."""
    return (P % 16 == 0 and 16 <= P <= 128 and N % 16 == 0 and N >= 16
            and P * N <= 8192)


def mma_smem_bytes(P: int, N: int, Q: int, head_group: int
                   ) -> Tuple[int, int]:
    """Shared-memory bytes of launches (a) and (b), as the kernel lays it
    out: (a) the chunk's x and B rows, its cumsum (fp64) and weights;
    (b) the C tile, a ring of two stages of a B tile and the group's x
    tiles (which holds h_c as TERMS bf16 terms after the last s-tile), for
    a group of more than one head the shared fp32 C·Bᵀ tile (rows of TILE
    + 8), each head's cumsum, dt and row factors. Rows of bf16 carry PAD
    more elements. The kernel takes these sizes from here."""
    Qp = -(-Q // TILE) * TILE
    a = Qp * ((P + PAD) * 2 + (N + PAD) * 2 + 12)
    stage = TILE * (N + PAD) * 2 + head_group * TILE * (P + PAD) * 2
    b = (TILE * (N + PAD) * 2 + max(2 * stage, TERMS * P * (N + PAD) * 2)
         + (TILE * (TILE + 8) * 4 if head_group > 1 else 0)
         + head_group * (Qp * 12 + TILE * 4))
    return a, b


@functools.lru_cache(maxsize=256)
def mma_plan(Bsz: int, H: int, L: int, P: int, N: int, Q: int,
             shared_bc: bool, sms: int) -> MmaPlan:
    """Launch (a): a block per (b, h, chunk). Launch (b): a block per (b,
    chunk, 64-row t-tile, group of heads), four warps per head of the
    group, which share one C·Bᵀ per tile pair. The group is 4 where 4
    divides H, 4·P is within 256 and launch (b) still has ``BLOCKS_PER_SM``
    blocks on each of ``sms`` SMs, else 1; 1 when the heads do not share B
    and C. A function of the shapes alone."""
    nc, tiles = L // Q, -(-Q // TILE)
    hg = next((g for g in HEAD_GROUPS if H % g == 0 and g * P <= 256
               and (g == 1 or shared_bc)
               and Bsz * nc * tiles * (H // g) >= BLOCKS_PER_SM * sms), 1)
    smem_a, smem_b = mma_smem_bytes(P, N, Q, hg)
    return MmaPlan(hg, Bsz * H * nc, Bsz * nc * tiles * (H // hg), smem_a,
                   smem_b)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             return_state: bool = False,
             out_dtype: Optional[torch.dtype] = None):
    """x: (..., L, P); dt: (..., L); A: (...) negative; Bm/Cm: (..., L, N),
    ``...`` = (BH,) or (B, H). Returns y (..., L, P) in ``out_dtype``
    (default x's), and with ``return_state`` also the final state
    (..., P, N) fp32."""
    _check(x, dt, A, Bm, Cm)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                            return_state=return_state, out_dtype=out_dtype)
    no_backward("ssd_scan", x, dt, A, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu tensors, not "
                         f"{x.device}")
    if any(t.device != x.device for t in (dt, A, Bm, Cm)):
        raise ValueError("all operands must be on one device")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm and Cm must share one dtype, float32 or "
                        f"bfloat16; got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype} and "
                        f"{A.dtype}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm) if t.numel()):
        raise ValueError("x, Bm and Cm need unit stride on their last axis")
    four = x.dim() == 4
    Bsz, H = (x.shape[0], x.shape[1]) if four else (1, x.shape[0])
    L, P = x.shape[-2:]
    N = Bm.shape[-1]
    Q = _chunk(L, chunk)
    lib = _library()
    mma = x.dtype == torch.bfloat16 and mma_takes(P, N)
    if mma:
        x, Bm, Cm = (aligned(t, 16) for t in (x, Bm, Cm))
        plan = mma_plan(Bsz, H, L, P, N, Q, H == 1 or (
            Bm.stride(-3) == 0 and Cm.stride(-3) == 0),
            num_sms(x.device.index))
        mma = max(plan.smem_a, plan.smem_b) <= SMEM_LIMIT
    if not mma:
        if not (4 <= P <= 128 and P & (P - 1) == 0 and N % 4 == 0
                and 0 < N * P <= 8192 and N * P % 256 == 0):
            raise ValueError(f"the kernel takes P a power of two in [4, 128] "
                             f"and N a multiple of 4 with N*P a multiple of "
                             f"256 up to 8192 (or, for bfloat16, P and N "
                             f"multiples of 16 with P <= 128 and N*P <= "
                             f"8192); got P={P}, N={N}")
        smem = lib.ssd_scan_smem_bytes(P, N, Q)
        if smem > SMEM_LIMIT:
            raise ValueError(f"(P, N, Q) = ({P}, {N}, {Q}) needs {smem} bytes "
                             f"of shared memory, more than {SMEM_LIMIT}")
    if four:
        y = torch.empty((Bsz, L, H, P), dtype=out_dtype,
                        device=x.device).permute(0, 2, 1, 3)
    else:
        y = torch.empty((H, L, P), dtype=out_dtype, device=x.device)
    state = torch.empty((*x.shape[:-2], P, N), dtype=torch.float32,
                        device=x.device) if return_state else None
    if Bsz * H == 0:
        return (y, state) if return_state else y
    if not four:                       # one (b) of H rows: b strides unused
        x, dt, A, Bm, Cm, yv = (t.unsqueeze(0) for t in (x, dt, A, Bm, Cm, y))
    else:
        yv = y
    strides = [*x.stride()[:3], *dt.stride(), *A.stride(), *Bm.stride()[:3],
               *Cm.stride()[:3], *yv.stride()[:3]]
    arr = (ctypes.c_longlong * 17)(*strides)
    stream = stream_handle(x.device)
    st = state.data_ptr() if state is not None else None
    with on_device(x.device):
        if mma:
            BH, nc = Bsz * H, L // Q
            ws = _workspace(x.device, BH, L, P, N, Q).data_ptr()
            rc = lib.ssd_scan_mma(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), st, ws, ws + 4 * BH * nc * P * N,
                ws + 4 * BH * nc * P * N + 8 * BH * L,
                _counters(x.device.index, BH).data_ptr(), Bsz, H, L, P, N, Q,
                plan.head_group, arr, int(out_dtype == torch.bfloat16),
                plan.smem_a, plan.smem_b, stream)
        else:
            rc = lib.ssd_scan(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), st, Bsz, H, L, P, N, Q, arr,
                int(x.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16), stream)
    if rc != 0:
        msg = lib.ssd_scan_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan launch failed: {msg} ({rc})")
    ssd_scan.launches += 1
    return (y, state) if return_state else y


ssd_scan.launches = 0


def _workspace(dev: torch.device, BH: int, L: int, P: int, N: int, Q: int
               ) -> torch.Tensor:
    """The tensor-core path's scratch for one call, one allocation, written
    by launch (a) and read by launch (b): the chunks' own states, which
    (a)'s fold turns into the states entering each chunk (fp32 (BH, nc,
    P, N)), cumsums (fp64 (BH, L)) and decays (fp32 (BH, nc))."""
    nc = L // Q
    return torch.empty(4 * BH * nc * P * N + 8 * BH * L + 4 * BH * nc,
                       dtype=torch.uint8, device=dev)


@functools.lru_cache(maxsize=64)
def _counters(index: int, BH: int) -> torch.Tensor:
    """Launch (a)'s ticket counters, one per (batch row, head), zeroed here
    and left zeroed by every call."""
    return torch.zeros(BH, dtype=torch.int32,
                       device=torch.device("cuda", index))


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("ssd_scan")
    lib.ssd_scan.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                             + [ctypes.POINTER(ctypes.c_longlong)]
                             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.ssd_scan.restype = ctypes.c_int
    lib.ssd_scan_mma.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                                 + [ctypes.POINTER(ctypes.c_longlong)]
                                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.ssd_scan_mma.restype = ctypes.c_int
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib
