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

Where grad mode is on and an operand needs a gradient, :func:`ssd_scan` is
a ``torch.autograd.Function`` (the ssm and hybrid families train through
it) whose backward :func:`ssd_scan_bwd` launches the hand-written
``csrc/ssd_scan_bwd.cu`` on the card and takes the plain chunk-by-chunk
backward :func:`ssd_scan_bwd_ref` on the CPU. Two routes, no atomics
(:func:`bwd_plan`): bf16 x, B and C at the models' (P, N)
(``BWD_MMA_SHAPES``) take the tensor route, five launches whose products
are ``mma.sync`` with fp32 factors as ``BWD_TERMS`` bf16 terms, the chunk's
(t, s) tiles split into row-tile and column-tile blocks of one grid; fp32
operands and other shapes the CUDA-core route, four launches of fp32
FMAs;
``ssd_scan_bwd.launches`` counts its calls. B and C may be given once as
(B, L, N) for the heads of x (B, H, L, P), as the model does: the scan
repeats them over H with stride 0, and the backward returns their
gradients summed over the heads in that shape.

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
from repro_torch.kernels._layout import (aligned, num_sms, on_device,
                                         plain, plain_route, stream_handle)

_DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232448                    # bytes a block may use on Hopper
TILE = 64                              # t and s rows of the tensor-core tiles
PAD = 8                                # bf16 padding of a shared-memory row
HEAD_GROUPS = (4, 1)                   # the tensor-core kernel's head groups
BLOCKS_PER_SM = 4                      # launch (b)'s blocks per SM, at least
TERMS = 3                              # bf16 terms an fp32 factor enters as
BWD_THREADS = 256                      # the backward's launches (1), (2), (4)
BWD_CHUNK_THREADS = 512                # the backward's chunk launch (3)
BWD_TILE = 64                          # t and s rows of the backward's tiles
BWD_TERMS = 2                          # the backward's bf16 terms of a factor
BWD_MMA_THREADS = 128                  # the tensor route's tile launch (3')
BWD_MMA_SHAPES = ((64, 128), (64, 16), (32, 16))   # its (P, N): the models'


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
                 return_state: bool = False,
                 out_dtype: Optional[torch.dtype] = None):
    """Plain version: the chunked form, all chunks' quadratic parts at once
    and the state carried over the chunks in a loop; fp32 inside (fp64
    for fp64 operands, which the backward's checks use)."""
    Bm, Cm = _heads(x, Bm), _heads(x, Cm)
    lead, (L, P), N = x.shape[:-2], x.shape[-2:], Bm.shape[-1]
    Q = _chunk(L, chunk)
    BH, nc = math.prod(lead), L // Q
    f32 = torch.promote_types(x.dtype, torch.float32)   # fp64 stays fp64
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


def shared_bc(x: torch.Tensor, Bm: torch.Tensor) -> bool:
    """B and C given once for all heads: x (B, H, L, P) with Bm (B, L, N)."""
    return x.dim() == 4 and Bm.dim() == 3


def _heads(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A head-shared (B, L, N) operand as the (B, H, L, N) view that
    repeats it over x's heads with stride 0 (no copy); else ``t``."""
    if not shared_bc(x, t):
        return t
    return t[:, None].expand(x.shape[0], x.shape[1], *t.shape[1:])


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
    bc = (x.shape[0], L) if shared_bc(x, Bm) else (*lead, L)
    want = {"dt": (*lead, L), "A": tuple(lead),
            "Bm": (*bc, Bm.shape[-1]), "Cm": (*bc, Bm.shape[-1])}
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} {tuple(t.shape)} does not match x "
                             f"{tuple(x.shape)}: expected {want[name]}")


def _check_card(name: str, x, dt, A, Bm, Cm, *grads) -> None:
    """What the card's kernels take of the operands (and of the
    gradients ``grads`` beside them): one CUDA device, x, B and C of one
    dtype (fp32 or bf16), dt and A fp32, unit stride on x's, B's and C's
    last axes."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda, cpu or meta "
                         f"tensors, not {x.device}")
    if any(t.device != x.device for t in (dt, A, Bm, Cm, *grads)):
        raise ValueError("all operands must be on one device")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm and Cm must share one dtype, float32 or "
                        f"bfloat16; got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype} and "
                        f"{A.dtype}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm) if t.numel()):
        raise ValueError("x, Bm and Cm need unit stride on their last axis")


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
    ``...`` = (BH,) or (B, H), or (B, L, N) shared by the H heads of x (B,
    H, L, P). Returns y (..., L, P) in ``out_dtype`` (default x's), and
    with ``return_state`` also the final state (..., P, N) fp32;
    differentiable in x, dt, A, Bm and Cm."""
    _check(x, dt, A, Bm, Cm)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm)):
        return _SSDScan.apply(x, dt, A, Bm, Cm, chunk, return_state,
                              out_dtype)
    return _forward(x, dt, A, Bm, Cm, chunk, return_state, out_dtype)


class _SSDScan(torch.autograd.Function):
    """The forward launch, and :func:`ssd_scan_bwd` as its backward. The
    final state's gradient is ``None`` where the caller drops the state
    (training through ``mamba_apply``): the backward then takes it as
    zero without a zero tensor."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk, return_state, out_dtype):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _forward(x, dt, A, Bm, Cm, chunk, return_state, out_dtype)

    @staticmethod
    def backward(ctx, dy, dh=None):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        if dy is None and dh is None:
            return (None,) * 8
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        grads = ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dh, chunk=ctx.chunk)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad[:5])) + (None,) * 3


def _forward(x, dt, A, Bm, Cm, chunk: int, return_state: bool,
             out_dtype: Optional[torch.dtype]):
    """The kernels on the card, the plain version on the CPU."""
    if plain_route(x.device):
        return plain("ssd_scan", ssd_scan_ref, x, dt, A, Bm, Cm, chunk=chunk,
                     return_state=return_state, out_dtype=out_dtype)
    Bm, Cm = _heads(x, Bm), _heads(x, Cm)
    _check_card("ssd_scan", x, dt, A, Bm, Cm)
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
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


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                     dh: Optional[torch.Tensor] = None, *, chunk: int):
    """Plain backward of :func:`ssd_scan` for the gradients ``dy`` of y
    and ``dh`` of the final state (``None``: zero). Returns (dx, ddt, dA,
    dB, dC) in the operands' shapes and dtypes (dB and dC (B, L, N),
    summed over the heads, where B and C are head-shared), computed in
    fp32 (fp64 for fp64 operands) chunk by chunk, as the kernel does:

    - the states entering each chunk, h_0 = 0, h_{c+1} = exp(cum_Q) h_c
      + Σ_s exp(cum_Q − cum_s) xb_s ⊗ B_s;
    - the state's gradient backward over the chunks: with Hn_c that of the
      state leaving chunk c (Hn_last = dh), Hn_{c−1} = exp(cum_Q) Hn_c +
      Σ_t exp(cum_t) dy_t ⊗ C_t;
    - per chunk, with L_ts = exp(cum_t − cum_s) for s ≤ t (masked before
      the exp: no exponent is positive), S = C·Bᵀ, D_ts = dy_t·xb_s,
      W = L·D and M = S·W: dxb_s = Σ_t S_ts L_ts dy_t + exp(cum_Q −
      cum_s) Hn B_s, dC_t = Σ_s W_ts B_s + exp(cum_t) dy_t h_c, dB_s =
      Σ_t W_ts C_t + exp(cum_Q − cum_s) xb_s Hn;
    - dcum_t = Σ_s M_ts − Σ_t' M_t't + exp(cum_t) dy_t·(h_c C_t) − U_t,
      U_s = xb_s·exp(cum_Q − cum_s) Hn B_s, and at the chunk's last step
      also exp(cum_Q)⟨Hn, h_c⟩ + Σ_s U_s; dla its reverse cumsum;
    - ddt = dla·A + dxb·x, dA = Σ dla·dt, dx = dxb·dt."""
    shared = shared_bc(x, Bm)
    Bh, Ch = _heads(x, Bm), _heads(x, Cm)
    lead, (L, P), N = x.shape[:-2], x.shape[-2:], Bm.shape[-1]
    Q = _chunk(L, chunk)
    BH, nc = math.prod(lead), L // Q
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc).reshape(BH, nc, Q, P)
    dtf = dt.to(acc).reshape(BH, nc, Q)
    Af = A.to(acc).reshape(BH, 1, 1)
    Bf = Bh.to(acc).reshape(BH, nc, Q, N)
    Cf = Ch.to(acc).reshape(BH, nc, Q, N)
    dyf = dy.to(acc).reshape(BH, nc, Q, P)
    cum = torch.cumsum(dtf * Af, dim=-1)                   # (BH, nc, Q)
    last = cum[..., -1:]
    decay = torch.exp(last)[..., 0]                        # (BH, nc)
    e = torch.exp(cum)                                     # exp(cum_t)
    w = torch.exp(last - cum)                              # exp(cum_Q − cum_s)
    xb = xf * dtf[..., None]
    own = (xb * w[..., None]).transpose(-1, -2) @ Bf       # (BH, nc, P, N)
    down = (dyf * e[..., None]).transpose(-1, -2) @ Cf
    h = torch.zeros((BH, P, N), dtype=acc, device=x.device)
    hs = []
    for c in range(nc):
        hs.append(h)
        h = h * decay[:, c, None, None] + own[:, c]
    g = (dh.to(acc).reshape(BH, P, N) if dh is not None
         else torch.zeros((BH, P, N), dtype=acc, device=x.device))
    hn = [None] * nc
    for c in reversed(range(nc)):
        hn[c] = g
        g = g * decay[:, c, None, None] + down[:, c]
    hc, Hn = torch.stack(hs, 1), torch.stack(hn, 1)        # (BH, nc, P, N)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    Lm = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~causal, float("-inf")))                           # (t, s)
    S = Cf @ Bf.transpose(-1, -2)
    D = dyf @ xb.transpose(-1, -2)
    G, W = S * Lm, Lm * D
    M = S * W
    hnb = w[..., None] * (Bf @ Hn.transpose(-1, -2))       # (BH, nc, Q, P)
    dxb = G.transpose(-1, -2) @ dyf + hnb
    dC_state = e[..., None] * (dyf @ hc)
    dC = W @ Bf + dC_state
    dB = W.transpose(-1, -2) @ Cf + w[..., None] * (xb @ Hn)
    U = (xb * hnb).sum(-1)
    dcum = M.sum(-1) - M.sum(-2) + (dC_state * Cf).sum(-1) - U
    dcum[..., -1] += decay * (Hn * hc).sum((-1, -2)) + U.sum(-1)
    dla = dcum.flip(-1).cumsum(-1).flip(-1)
    ddt = dla * Af + (dxb * xf).sum(-1)
    dA = (dla * dtf).sum((-1, -2))
    dx = dxb * dtf[..., None]
    bc = (x.shape[0], x.shape[1], L, N) if shared else (*lead, L, N)
    dB, dC = dB.reshape(bc), dC.reshape(bc)
    if shared:
        dB, dC = dB.sum(1), dC.sum(1)
    return (dx.reshape(x.shape).to(x.dtype), ddt.reshape(dt.shape).to(
        dt.dtype), dA.reshape(A.shape).to(A.dtype), dB.to(Bm.dtype),
        dC.to(Cm.dtype))


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                 dh: Optional[torch.Tensor] = None, *, chunk: int):
    """Gradients of :func:`ssd_scan` (see :func:`ssd_scan_bwd_ref`)."""
    _check(x, dt, A, Bm, Cm)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must have x's shape "
                         f"{tuple(x.shape)}")
    if plain_route(x.device):
        return plain("ssd_scan_bwd", ssd_scan_bwd_ref, x, dt, A, Bm, Cm, dy,
                     dh, chunk=chunk)
    _check_card("ssd_scan_bwd", x, dt, A, Bm, Cm, dy,
                *(() if dh is None else (dh,)))
    L, P = x.shape[-2:]
    N = Bm.shape[-1]
    Q = _chunk(L, chunk)
    shared = shared_bc(x, Bm)
    four = x.dim() == 4
    Bsz, H = (x.shape[0], x.shape[1]) if four else (1, x.shape[0])
    plan = bwd_plan(x.dtype, Bsz, H, L, P, N, Q, shared,
                    num_sms(x.device.index))
    dy = dy.float()
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    mma = plan.route == "mma"
    if mma:                            # 16-byte rows for cp.async
        x, Bm, Cm, dy = (aligned(t, 16) for t in (x, Bm, Cm, dy))
    if dh is not None:
        dh = dh.float().contiguous()
    if four:                           # dx laid out as the model's x
        dx = torch.empty((Bsz, L, H, P), dtype=x.dtype,
                         device=x.device).permute(0, 2, 1, 3)
    else:
        dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    ddt = torch.empty_like(dt)
    dA = torch.empty(A.shape, dtype=torch.float32, device=x.device)
    dB = torch.empty(Bm.shape, dtype=x.dtype, device=x.device)
    dC = torch.empty(Cm.shape, dtype=x.dtype, device=x.device)
    if Bsz * H == 0:
        return dx, ddt, dA.zero_(), dB.zero_(), dC.zero_()
    ops4 = [x, dt, A, _heads(x, Bm), _heads(x, Cm), dy, dx, ddt]
    if not four:                       # one (b) of H rows: b strides unused
        ops4 = [t.unsqueeze(0) for t in ops4]
    xv, dtv, Av, Bv, Cv, dyv, dxv, ddtv = ops4
    strides = [*xv.stride()[:3], *dtv.stride(), *Av.stride(),
               *Bv.stride()[:3], *Cv.stride()[:3], *dyv.stride()[:3],
               *dxv.stride()[:3], *ddtv.stride()]
    arr = (ctypes.c_longlong * 23)(*strides)
    ws = torch.empty(plan.workspace, dtype=torch.uint8, device=x.device)
    lib = _bwd_library()
    with on_device(x.device):
        rc = lib.ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), dy.data_ptr(),
            dh.data_ptr() if dh is not None else None, dx.data_ptr(),
            ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            ws.data_ptr(), plan.workspace, Bsz, H, L, P, N, Q, int(shared),
            arr, int(x.dtype == torch.bfloat16), int(mma), plan.smem_state,
            plan.smem_tiles, plan.reduce_blocks, stream_handle(x.device))
    if rc != 0:
        msg = lib.ssd_scan_bwd_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan_bwd launch failed: {msg} ({rc})")
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC


ssd_scan_bwd.launches = 0


class BwdPlan(NamedTuple):
    """The backward's launches for one call. ``route`` "mma" (the tensor
    route: (1') the chunk states, own and gradient, (2) their fold, (3')
    the (3s) and (3t) tile blocks, (4') the scan, (5) the head sum) or
    "cuda_cores" ((1) the chunk states, (2) the fold, (3) the chunks, (4)
    the head sum); the blocks of each launch (the fold a (rows, entry
    groups) grid; ``scan_blocks`` 0 on the CUDA-core route, whose chunk
    launch scans), the shared-memory bytes of the states and tile (or
    chunk) launches, and the workspace's bytes."""

    route: str
    state_blocks: int
    fold_grid: Tuple[int, int]
    tile_blocks: int
    scan_blocks: int
    reduce_blocks: int
    smem_state: int
    smem_tiles: int
    workspace: int


def bwd_route(dtype: torch.dtype, P: int, N: int) -> str:
    """"mma" for bf16 x, B and C at a (P, N) the tensor route is built for
    (``BWD_MMA_SHAPES``), else "cuda_cores"."""
    return ("mma" if dtype == torch.bfloat16 and (P, N) in BWD_MMA_SHAPES
            else "cuda_cores")


def bwd_smem_bytes(P: int, N: int, Q: int, route: str = "cuda_cores"
                   ) -> Tuple[int, int]:
    """Shared-memory bytes of the route's states launch and its tile (or
    chunk) launch, as the kernel lays them out. CUDA-core (1): the chunk's
    cumsum (fp64), dt and two row factors, a 64-row tile each of x, B, dy
    and C. (3): the cumsum, six per-step arrays, a block's partial sums
    and an s-tile's U, the entering state and its gradient (rows of N +
    1), 64-row tiles of B and C (N + 1) and of x·dt and dy (P + 1), and
    the (t, s) tiles G, W and M (rows of 65). Tensor (1'): two stages of
    the larger of 64 rows of x and B (bf16, rows padded by 8) and of dy
    (fp32, rows of P + 4) and C, then the cumsum (fp64), dt and a factor
    per step of the 64-row-rounded chunk. (3'): the larger of a (3s)
    block's x and B rows and two stages of C rows and dy's terms, and a
    (3t) block's C rows and dy's terms and two stages of B and x rows
    (bf16, padded by 8); the cumsum, dt and a factor per step, and a
    block's partial sums."""
    T = BWD_TILE
    if route == "mma":
        Qp = -(-Q // T) * T
        row_p, row_n = 2 * T * (P + PAD), 2 * T * (N + PAD)
        state = 2 * max(row_p + row_n, 4 * T * (P + 4) + row_n) + 16 * Qp
        s_side = row_p + row_n + 2 * (row_n + BWD_TERMS * row_p)
        t_side = row_n + BWD_TERMS * row_p + 2 * (row_n + row_p)
        return state, max(s_side, t_side) + 16 * Qp + 4 * BWD_MMA_THREADS
    state = 8 * Q + 12 * Q + 4 * T * (2 * P + 2 * N)
    chunk = (8 * Q + 4 * (6 * Q + BWD_CHUNK_THREADS + T + 2)
             + 4 * 2 * P * (N + 1) + 4 * 2 * T * (N + 1)
             + 4 * 2 * T * (P + 1) + 4 * 3 * T * (T + 1))
    return state, chunk


def bwd_workspace_bytes(Bsz: int, H: int, L: int, P: int, N: int, Q: int,
                        route: str) -> int:
    """The backward's workspace, regions of 16-byte multiples in the
    kernel's order: the chunks' own states and state gradients (fp32 (BH,
    nc, P, N) each, the fold's entering states and Hn in their place),
    decays and dA shares ((BH, nc) each), per-head dB and dC ((BH, L, N)
    each); on the tensor route also the cumsums (fp64 (BH, L)), dy's
    ``BWD_TERMS`` bf16 terms ((BH, L, terms, P)), four per-step sums
    ((BH, L) each) and ⟨Hn_c, h_c⟩ ((BH, nc))."""
    BH, nc = Bsz * H, L // Q
    sizes = [4 * BH * nc * P * N] * 2 + [4 * BH * nc] * 2 \
        + [4 * BH * L * N] * 2
    if route == "mma":
        sizes += [8 * BH * L, 2 * BWD_TERMS * BH * L * P, 16 * BH * L,
                  4 * BH * nc]
    return sum(-(-n // 16) * 16 for n in sizes)


@functools.lru_cache(maxsize=256)
def bwd_plan(dtype: torch.dtype, Bsz: int, H: int, L: int, P: int, N: int,
             Q: int, shared: bool, sms: int) -> BwdPlan:
    """The backward's launches (:class:`BwdPlan`): on both routes a thread
    per state entry of each (batch row, head) in the fold and, in the head
    sum, a grid-stride loop over the dB and dC outputs ((B, L, N) where the
    heads share B and C, else (B, H, L, N)) of at most 8 blocks an SM. The
    tensor route (:func:`bwd_route`): two blocks per (batch row, head,
    chunk) in (1'), own state and gradient; two per (batch row, head,
    chunk, 64-row tile) in (3'), its (3s) and (3t) blocks, heaviest tiles
    first (the kernel's order); a warp per (batch row, head, chunk) in
    (4'), 8 a block. The CUDA-core route: a block per (batch row, head,
    chunk) in (1) and (3); it takes P and N powers of two in [4, 128] with
    P·N <= 8192. Raises for shapes neither route takes or shared memory
    past ``SMEM_LIMIT``."""
    route = bwd_route(dtype, P, N)
    if route == "cuda_cores" and (
            not all(4 <= v <= 128 and v & (v - 1) == 0 for v in (P, N))
            or P * N > 8192):
        raise ValueError(f"ssd_scan_bwd takes P and N powers of two in [4, "
                         f"128] with P*N <= 8192, or for bfloat16 (P, N) in "
                         f"{BWD_MMA_SHAPES}; got P={P}, N={N}")
    smem_state, smem_tiles = bwd_smem_bytes(P, N, Q, route)
    if max(smem_state, smem_tiles) > SMEM_LIMIT:
        raise ValueError(f"(P, N, Q) = ({P}, {N}, {Q}) needs "
                         f"{max(smem_state, smem_tiles)} bytes of shared "
                         f"memory in the backward, more than {SMEM_LIMIT}")
    BH, nc = Bsz * H, L // Q
    outs = Bsz * (1 if shared else H) * L * N
    mma = route == "mma"
    tiles = -(-Q // BWD_TILE)
    warps = BWD_THREADS // 32
    return BwdPlan(route, (2 if mma else 1) * BH * nc,
                   (BH, -(-P * N // BWD_THREADS)),
                   2 * tiles * BH * nc if mma else BH * nc,
                   -(-BH * nc // warps) if mma else 0,
                   max(1, min(-(-outs // BWD_THREADS), 8 * sms)),
                   smem_state, smem_tiles,
                   bwd_workspace_bytes(Bsz, H, L, P, N, Q, route))


def bwd_mma_flops(Bsz: int, H: int, L: int, P: int, N: int, Q: int) -> int:
    """The tensor route's bf16 operations, 2·16·8·16 a ``mma.sync`` as its
    warps issue them: (1') per chunk and head the own state and its
    gradient, ``BWD_TERMS`` products each over the 64-row-rounded chunk;
    (3') per 64-column block of a tile pair S and D (D once a term), the
    cross terms of Gᵀ·dy (terms·(terms+1)/2) and Wᵀ·C, W·B (once a term),
    a diagonal tile's blocks above (3s) or below (3t) a warp's rows
    skipped; then the state products, B·Hnᵀ and x·Hn once a term, dy·h_c
    the cross terms. The route's bound is these at the bf16 rate."""
    T, R = BWD_TERMS, BWD_TILE
    cross = T * (T + 1) // 2
    nt, P16, N16 = -(-Q // R), P // 16, N // 16
    Qp = nt * R
    per_chunk = 2 * (P // 16) * (Qp // 16) * T * (N // 8)      # (1')
    for i in range(nt):
        for j in range(i, nt):
            for w in range(4):
                s_cols = 4 - (w if j == i else 0)         # (3s) s-tile i
                t_cols = w + 1 if j == i else 4           # (3t) t-tile j
                per_chunk += 2 * s_cols * (N16 + P16 * T + P16 * cross
                                           + N16 * T)
                per_chunk += 2 * t_cols * (N16 + P16 * T + N16 * T)
    per_chunk += nt * 4 * 2 * (N16 * T * P16 + N16 * P16 * T)   # (3s) state
    per_chunk += nt * 4 * 2 * N16 * P16 * cross                  # (3t) state
    return per_chunk * 4096 * Bsz * H * (L // Q)


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


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    """The built backward library with its C signatures declared."""
    lib = build.load("ssd_scan_bwd")
    lib.ssd_scan_bwd.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong]
                                 + [ctypes.c_int] * 7
                                 + [ctypes.POINTER(ctypes.c_longlong)]
                                 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.ssd_scan_bwd.restype = ctypes.c_int
    lib.ssd_scan_bwd_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.ssd_scan_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_bwd_ws_bytes.argtypes = [ctypes.c_int] * 7
    lib.ssd_scan_bwd_ws_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib
