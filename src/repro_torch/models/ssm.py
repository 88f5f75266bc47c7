"""Mamba2 (SSD — state-space duality, arXiv:2405.21060): the ``ssm`` family.

The JAX package's ``models/ssm.py`` with the same parameter tree (layer
params stacked on axis 0) and cache layout ({"conv" (L, B, k−1, CH) in
``param_dtype``, "state" (L, B, H, P, N) fp32}). Prefill runs the chunked
dual form through the hand-written ``ssd_scan`` kernel, which also returns
the final state the cache keeps; decode carries the constant-size
recurrent state in plain PyTorch (its einsums carry no kernel in the
reference either). Every RMSNorm, the gated one included, goes through
``rmsnorm``, except a gated norm whose row a tensor-parallel rank holds
only part of (below).

Differences from the reference:

- ``mamba_apply`` takes no initial state or conv tail (no caller of the
  reference passes them);
- ``ssd_chunked`` runs the plain version of the scan on any device (the
  reference function, used by the tests and as the model's yardstick);
  ``mamba_apply`` runs ``ops.ssd_scan``, the kernel on the card, which
  training differentiates through its backward kernel ``ssd_scan_bwd``
  (the reference leaves the backward to jax's autodiff of
  ``ssd_chunked``, whose dt and A gradients are NaN at chunk 256 near
  dt = softplus(0); the port's are finite);
- a decode step writes the new conv window and state into the cache in
  place and returns the same dict (the reference donates it);
- no ``train`` flag and no sharding constraints, as in ``transformer.py``;
- under a tensor-parallel layout whose :class:`repro_torch.parallel.tensor.SSM`
  splits the mixer (a mesh step with ``model`` > 1,
  ``launch.steps.mesh_step``), a rank runs its SSM heads, or every head's
  block of channels, on its blocks of the params (``in_proj``'s columns
  [z_r | x_r | B | C | dt_r], or the whole product where ``in_proj`` is
  whole; the conv over [x_r | B | C]): the scan on (B, H_r, L, P_r), the
  decode recurrence on its state block, the gated norm's sums of squares
  summed over ``model`` (one all-reduce of (B, L, 1) in fp32, then the
  reference's formula in plain ops: a row split over the ranks needs the
  collective between the reduction and the scale, which one launch of
  the ``rmsnorm`` kernel cannot hold) and ``out_proj``'s partial products
  summed after it. GSPMD makes the same split of the reference's forward
  from ``xh``'s ``ssm_inner`` constraint and the params' shardings.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel import tensor as TP
from repro_torch.tree import stack_init

Params = Dict[str, Any]

_G = 1  # n_groups for B/C projections


def _dims(cfg: ModelConfig):
    """(d_inner, heads H, head dim P, state N, conv channels)."""
    d_in = cfg.d_inner
    N = cfg.ssm_state
    return d_in, cfg.n_ssm_heads, cfg.ssm_head_dim, N, d_in + 2 * _G * N


def mamba_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """One mixer: in_proj to [z | x | B | C | dt], the depthwise conv, the
    fp32 ``A_log``/``D``/``dt_bias``, the gated norm and out_proj."""
    d_in, H, P, N, conv_ch = _dims(cfg)
    dev = gen.device
    kw = dict(device=dev, dtype=cfg.param_dtype)
    d_proj = 2 * d_in + 2 * _G * N + H
    f32 = dict(device=dev, dtype=torch.float32)
    return {"in_proj": L.dense_init(gen, cfg.d_model, d_proj, **kw),
            "conv_w": L._trunc_normal(gen, (cfg.ssm_conv, conv_ch), 0.5, **kw),
            "conv_b": torch.zeros(conv_ch, **kw),
            "A_log": torch.zeros(H, **f32),              # A = -exp(A_log) = -1
            "D": torch.ones(H, **f32),
            "dt_bias": torch.zeros(H, **f32),
            "out_norm": L.rmsnorm_init(d_in, **kw),
            "out_proj": L.dense_init(gen, d_in, cfg.d_model, **kw)}


def _split_ssm():
    """The current tensor-parallel layout's :class:`TP.SSM` where it splits
    the mixer over the ``model`` ranks, else None (the mixer runs whole)."""
    tp = TP.current()
    ssm = tp.ssm if tp is not None else None
    return ssm if ssm is not None and ssm.split else None


def _rank_dims(cfg: ModelConfig):
    """(:func:`_dims` of what this rank computes: its channels, heads,
    head channels, N and conv channels; the splitting :class:`TP.SSM` or
    None)."""
    ssm = _split_ssm()
    if ssm is None:
        return _dims(cfg), None
    H, P = ssm.heads[1] - ssm.heads[0], ssm.head_dim[1] - ssm.head_dim[0]
    return (H * P, H, P, ssm.N, H * P + 2 * _G * ssm.N), ssm


def _split_proj(cfg: ModelConfig, proj: torch.Tensor, ssm=None):
    """(..., d_proj) → z (..., d_in), xbc (..., conv_ch), dt (..., H). On a
    rank that splits the mixer (``ssm``), its z_r, [x_r | B | C] and dt_r:
    the columns of its ``in_proj`` block, or taken from the whole product
    where ``in_proj`` is whole (x_r and B | C then joined: a copy)."""
    d_in, H, P, N, conv_ch = _dims(cfg)
    if ssm is None:
        return proj.split([d_in, conv_ch, H], dim=-1)
    (h0, h1), (p0, p1) = ssm.heads, ssm.head_dim
    if proj.shape[-1] != 2 * d_in + 2 * _G * N + H:
        c = (h1 - h0) * (p1 - p0)
        return proj.split([c, c + 2 * _G * N, h1 - h0], dim=-1)
    z, x, bc, dt = proj.split([d_in, d_in, 2 * _G * N, H], dim=-1)

    def mine(t):
        return t.unflatten(-1, (H, P))[..., h0:h1, p0:p1].flatten(-2)
    return mine(z), torch.cat([mine(x), bc], -1), dt[..., h0:h1]


def _causal_conv(p: Params, xbc: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, Len, CH), then SiLU; the result is
    laid out (B, Len, CH), so its channel slices have unit stride as the
    scan kernel needs."""
    k, ch = p["conv_w"].shape
    y = F.conv1d(xbc.transpose(1, 2), p["conv_w"].t()[:, None, :],
                 padding=k - 1, groups=ch)[..., :xbc.shape[1]]
    return F.silu(y.transpose(1, 2).contiguous() + p["conv_b"])


def _gated_norm(p: Params, y: torch.Tensor, z: torch.Tensor, d_in: int,
                ssm=None) -> torch.Tensor:
    """RMSNorm of ``y · silu(z)`` over all ``d_in`` channels, through the
    ``rmsnorm`` kernel; on a rank that splits the mixer (``ssm``), of its
    channels: their fp32 sums of squares summed over ``model``, then the
    reference's ``x · rsqrt(sum / d_in + eps) · scale_r`` in plain ops."""
    g = y * F.silu(z)
    if ssm is None:
        return L.rmsnorm_apply(p["out_norm"], g)
    gf = g.float()
    tp = TP.current()
    ss = TP.all_reduce(gf.square().sum(-1, keepdim=True), tp.group)
    return (gf * torch.rsqrt(ss / d_in + 1e-6)          # rmsnorm_apply's eps
            * p["out_norm"]["scale"].float()).to(g.dtype)


def _out_proj(p: Params, g: torch.Tensor, ssm=None) -> torch.Tensor:
    """``out_proj`` (no bias) of the normed ``g``; on a rank that splits
    the mixer, of its channels' rows, summed over ``model`` in fp32."""
    if ssm is None:
        return L.dense_apply(p["out_proj"], g)
    return TP.sum_partials(g.float() @ p["out_proj"]["kernel"].float(),
                           TP.current().group, g.dtype)


def _scan_operands(xh, dt, A, Bm, Cm):
    """Model layout (B, Len, H, P), (B, Len, H), (H,), (B, Len, N) → the
    (B, H, Len, ·) views the scan takes, with B/C passed once as (B, Len,
    N) for every head (the scan repeats them over H with stride 0, and its
    backward sums their gradients over the heads): no copies."""
    Bsz, _, H, _ = xh.shape
    return xh.permute(0, 2, 1, 3), dt.permute(0, 2, 1), A.expand(Bsz, H), \
        Bm, Cm


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, plain version. xh (B, Len, H, P); dt (B, Len, H);
    A (H,) negative; Bm, Cm (B, Len, N). Returns (y (B, Len, H, P) fp32,
    final state (B, H, P, N) fp32)."""
    y, h = ops.ssd_scan_ref(*_scan_operands(xh, dt, A, Bm, Cm), chunk=chunk,
                            return_state=True, out_dtype=torch.float32)
    return y.permute(0, 2, 1, 3), h


def mamba_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                return_state: bool = False):
    """Full-sequence mamba2 mixer through ``ssd_scan``. x: (B, Len, d).
    With ``return_state`` also returns (final SSM state, conv tail) for
    decode continuation: on a rank that splits the mixer, its block of
    each, (B, H_r, P_r, N) and (B, k−1, [x_r | B | C])."""
    (d_in, H, P, N, conv_ch), ssm = _rank_dims(cfg)
    proj = L.dense_apply(p["in_proj"], x)
    z, xbc, dt = _split_proj(cfg, proj, ssm)
    conv_tail = xbc[:, -(cfg.ssm_conv - 1):] if return_state else None
    xbc = _causal_conv(p, xbc)
    xs, Bm, Cm = xbc.split([d_in, _G * N, _G * N], dim=-1)
    xh = xs.unflatten(-1, (H, P))
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h_fin = ops.ssd_scan(*_scan_operands(xh, dt, A, Bm, Cm),
                            chunk=cfg.ssm_chunk, return_state=True,
                            out_dtype=torch.float32)
    y = y.permute(0, 2, 1, 3) + xh.float() * p["D"][:, None]
    y = y.reshape(*x.shape[:-1], d_in).to(cfg.compute_dtype)
    out = _out_proj(p, _gated_norm(p, y, z, cfg.d_inner, ssm), ssm)
    if return_state:
        return out, h_fin, conv_tail
    return out


def mamba_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 conv_state: torch.Tensor, ssm_state: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x (B, 1, d); conv_state (B, k−1, CH); ssm_state
    (B, H, P, N); on a rank that splits the mixer, its blocks of the two
    (CH = [x_r | B | C], H_r, P_r). Returns (out, new conv window, new
    state)."""
    (d_in, H, P, N, conv_ch), ssm = _rank_dims(cfg)
    proj = L.dense_apply(p["in_proj"], x)
    z, xbc, dt = _split_proj(cfg, proj, ssm)               # (B, 1, ·)
    window = torch.cat([conv_state, xbc], dim=1)          # (B, k, CH)
    conv_out = torch.einsum("bkc,kc->bc", window.float(),
                            p["conv_w"].float())
    conv_out = F.silu(conv_out + p["conv_b"].float())
    xs, Bm, Cm = conv_out.split([d_in, _G * N, _G * N], dim=-1)
    xh = xs.reshape(-1, H, P)                               # (B, H, P)
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])       # (B, H)
    a = torch.exp(dtv * -torch.exp(p["A_log"]))
    xb = xh * dtv[..., None]
    h_new = ssm_state * a[..., None, None] + torch.einsum(
        "bn,bhp->bhpn", Bm, xb)
    y = torch.einsum("bn,bhpn->bhp", Cm, h_new)
    y = y + xh * p["D"][:, None]
    y = y.reshape(-1, 1, d_in).to(cfg.compute_dtype)
    out = _out_proj(p, _gated_norm(p, y, z, cfg.d_inner, ssm), ssm)
    return out, window[:, 1:], h_new


# ---------------------------------------------------------------------------
# full SSM LM
# ---------------------------------------------------------------------------

def ssm_block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """A pre-norm mamba2 block."""
    return {"norm": T.norm_init(cfg, cfg.d_model, device=gen.device),
            "mixer": mamba_init(gen, cfg)}


def ssm_lm_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """All params, drawn from ``gen`` on its device, the layers one at a
    time into their stack."""
    dev = gen.device
    embed = L.embed_init(gen, cfg.vocab, cfg.d_model, device=dev,
                         dtype=cfg.param_dtype)
    return {"embed": embed,
            "layers": stack_init(cfg.n_layers,
                                 lambda: ssm_block_init(gen, cfg)),
            "out_norm": T.norm_init(cfg, cfg.d_model, device=dev),
            "lm_head": L.dense_init(gen, cfg.d_model, cfg.vocab, device=dev,
                                    dtype=cfg.param_dtype)}


def ssm_lm_forward(params: Params, cfg: ModelConfig, tokens, *, embeds=None,
                   positions=None) -> torch.Tensor:
    """Full-sequence logits (B, S, V)."""
    x = T._embed(params, cfg, tokens, embeds)
    for i in range(cfg.n_layers):
        lp = T._layer(params, i)
        x = x + mamba_apply(lp["mixer"], cfg,
                            T.norm_apply(cfg, lp["norm"], x))
    x = T.norm_apply(cfg, params["out_norm"], x)
    return L.dense_apply(params["lm_head"], x)


def ssm_prefill(params: Params, cfg: ModelConfig, tokens, *, embeds=None,
                positions=None) -> Tuple[torch.Tensor, Params]:
    """Prefill → (last-position logits (B, 1, V), {conv, state} cache)."""
    x = T._embed(params, cfg, tokens, embeds)
    convs, states = [], []
    for i in range(cfg.n_layers):
        lp = T._layer(params, i)
        y, h_fin, conv_tail = mamba_apply(
            lp["mixer"], cfg, T.norm_apply(cfg, lp["norm"], x),
            return_state=True)
        x = x + y
        convs.append(conv_tail.to(cfg.param_dtype))
        states.append(h_fin)
    x = T.norm_apply(cfg, params["out_norm"], x[:, -1:].contiguous())
    return (L.dense_apply(params["lm_head"], x),
            {"conv": torch.stack(convs), "state": torch.stack(states)})


def ssm_init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                   device=None) -> Params:
    """Zero conv windows (``param_dtype``) and fp32 states; ``max_len``
    does not size them (the state is constant-size)."""
    d_in, H, P, N, conv_ch = _dims(cfg)
    L_ = cfg.n_layers
    return {"conv": torch.zeros((L_, batch, cfg.ssm_conv - 1, conv_ch),
                                dtype=cfg.param_dtype, device=device),
            "state": torch.zeros((L_, batch, H, P, N), dtype=torch.float32,
                                 device=device)}


def ssm_decode_step(params: Params, cfg: ModelConfig, tokens, cache, index,
                    *, embeds=None) -> Tuple[torch.Tensor, Params]:
    """One decode step; the cache is updated in place. ``index`` is not
    read (the recurrent state carries the position)."""
    x = T._embed(params, cfg, tokens, embeds)
    for i in range(cfg.n_layers):
        lp = T._layer(params, i)
        y, conv, state = mamba_decode(lp["mixer"], cfg,
                                      T.norm_apply(cfg, lp["norm"], x),
                                      cache["conv"][i], cache["state"][i])
        cache["conv"][i] = conv
        cache["state"][i] = state
        x = x + y
    x = T.norm_apply(cfg, params["out_norm"], x)
    return L.dense_apply(params["lm_head"], x), cache
