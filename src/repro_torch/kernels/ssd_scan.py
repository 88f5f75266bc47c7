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

:func:`ssd_scan` launches the hand-written CUDA kernel ``csrc/ssd_scan.cu``
on CUDA tensors and takes the plain version :func:`ssd_scan_ref` only for
tensors that lie on the CPU. A failed build or launch raises; nothing
falls back. ``ssd_scan.launches`` counts kernel launches (plain-version
calls do not count).

On the card the operands may be strided views with unit stride on their
last axis (dt and A any strides, stride 0 included), so the model passes
its (B, L, H, P) projection permuted to (B, H, L, P) and its head-shared
B/C expanded over H without a copy. For (B, H) leading axes, y is laid out
(B, L, H, P) in memory and returned as the (B, H, L, P) view, so the
model's reshape back is free.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232448                    # bytes a block may use on Hopper


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
    if not (4 <= P <= 128 and P & (P - 1) == 0 and N % 4 == 0
            and 0 < N * P <= 8192 and N * P % 256 == 0):
        raise ValueError(f"the kernel takes P a power of two in [4, 128] and "
                         f"N a multiple of 4 with N*P a multiple of 256 up "
                         f"to 8192; got P={P}, N={N}")
    lib = _library()
    smem = lib.ssd_scan_smem_bytes(P, N, Q)
    if smem > SMEM_LIMIT:
        raise ValueError(f"(P, N, Q) = ({P}, {N}, {Q}) needs {smem} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    if four:
        y = torch.empty((Bsz, L, H, P), dtype=out_dtype,
                        device=x.device).permute(0, 2, 1, 3)
    else:
        y = torch.empty((H, L, P), dtype=out_dtype, device=x.device)
    state = torch.empty((*x.shape[:-2], P, N), dtype=torch.float32,
                        device=x.device) if return_state else None
    if Bsz * H:
        if not four:                   # one (b) of H rows: b strides unused
            x, dt, A, Bm, Cm, yv = (t.unsqueeze(0)
                                    for t in (x, dt, A, Bm, Cm, y))
        else:
            yv = y
        strides = [*x.stride()[:3], *dt.stride(), *A.stride(),
                   *Bm.stride()[:3], *Cm.stride()[:3], *yv.stride()[:3]]
        arr = (ctypes.c_longlong * 17)(*strides)
        with torch.cuda.device(x.device):
            rc = lib.ssd_scan(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(),
                state.data_ptr() if state is not None else None,
                Bsz, H, L, P, N, Q, arr, int(x.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            msg = lib.ssd_scan_error_string(rc).decode()
            raise RuntimeError(f"ssd_scan launch failed: {msg} ({rc})")
        ssd_scan.launches += 1
    return (y, state) if return_state else y


ssd_scan.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("ssd_scan")
    lib.ssd_scan.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                             + [ctypes.POINTER(ctypes.c_longlong)]
                             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.ssd_scan.restype = ctypes.c_int
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib
