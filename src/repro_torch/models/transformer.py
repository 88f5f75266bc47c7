"""Decoder-only LM, dense, MoE and VLM families: GQA attention with RoPE,
M-RoPE (or no positions), SwiGLU (or GELU) FFN or a token-dropping MoE
FFN, RMSNorm (or LayerNorm), layers stacked on a leading axis.

The JAX package's ``models/transformer.py`` for ``family="dense"``,
``"moe"`` and ``"vlm"``, with the same parameter tree (layer params stacked on axis 0),
the same cache layout ``(L, B, Smax, KV, hd)`` and the same head order:
query head ``h = kv·G + g`` reads kv head ``kv``. Prefill attention goes
through the hand-written ``flash_attention`` kernel (the reference's
``full`` and ``blocked`` paths are both exact causal attention, so one
kernel serves both), decode attention through ``decode_attention``, every
RMSNorm through ``rmsnorm`` and the MoE router's softmax and top-k through
``topk_gating``. The VLM (Qwen2-VL's backbone) takes precomputed patch
embeddings (B, S, d) in place of token ids (``embeds``, the stub
frontend) and rotates q and k by M-RoPE over three position streams
(3, B, S); its heads are padded up to ``pad_heads_to`` with zeroed ``wo``
slices, which nothing masks in training (their gradients are those of the
reference). The hybrid family (``models/hybrid.py``) and the enc-dec
(``models/encdec.py``) reuse the attention, FFN and MoE pieces. Training differentiates the same forward:
the kernels' autograd Functions carry the gradient (the router's weights
through ``topk_gating_bwd``), the MoE's gather dispatch and weighted
combine are differentiable indexing, and the routes and capacity positions
carry none, as ``lax.top_k``'s indices carry none in the reference.

Differences from the reference:

- a forward builds the RoPE or M-RoPE (cos, sin) table once from its
  positions and every layer reuses it (the values are those of
  ``apply_rope`` and ``apply_mrope``), so the attention functions take
  ``rope`` where the reference takes positions;
- a decode step writes the new K/V row into the cache in place and returns
  the same cache dict — the reference's ``generate`` donates the cache to
  its decode step, so its counterpart here is an in-place update;
- one card needs no sharding constraints, so ``constrain`` is dropped, and
  there is no ``train`` flag (it only selects a remat policy there);
- ``moe_apply`` is the reference's single-device path
  (``_moe_apply_dense``) unless a tensor-parallel layout with an MoE
  (:class:`repro_torch.parallel.tensor.Experts`) is current: then the
  paths of the reference's ``_moe_apply_shard_map``, each rank routing all
  of its data shard's rows and summing its partial output over ``model``
  (:func:`_moe_sharded`);
- the dense, MoE and VLM families' prefill and decode (and the hybrid's
  and the enc-dec's attention and FFN, which reuse these pieces) run
  tensor-parallel where a :class:`repro_torch.parallel.tensor.Layout` is
  current (a mesh step with ``model`` > 1, ``launch.steps.mesh_step``),
  on this rank's blocks of the params: its query heads (a VLM's padded
  ones in the same grouped-major order), with a sum over the ranks after
  the output projection; its kv heads where they divide the axis, else k
  and v summed over the input-dim blocks of ``wk``/``wv`` (prefill) or
  projected whole (decode); a sequence-sharded decode cache's blocks
  merged by their log-sum-exp (:func:`attend_blocks`); its FFN columns
  with a sum after ``wo``; its vocabulary rows of the embedding
  (:func:`repro_torch.parallel.tensor.embed_lookup`) and columns of the
  logits. GSPMD makes the same split of the reference's forward from its
  ``constrain`` calls and the params' shardings. A dense or MoE train
  step differentiates the same split (an MoE's input and router kernel
  enter the rank's share through ``copy_to_model``, its experts' weights
  gathered over ``data`` through the autograd ``all_gather``): a tensor every rank holds whole enters a
  rank's share of the work through
  :func:`repro_torch.parallel.tensor.copy_to_model` (the normed input of
  a split attention or FFN, the final norm's output before a
  vocabulary-split ``lm_head``, a whole k/v before the rank reads its kv
  heads), whose gradient is summed over the ranks; a sum of shares
  passes its gradient through (``reduce_from_model``); the loss over
  logits split on the vocabulary is :func:`softmax_xent`'s
  vocabulary-parallel form.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.parallel import tensor as TP
from repro_torch.tree import stack_init, tree_map

Params = Dict[str, Any]
Index = Union[int, torch.Tensor]
Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]


# ---------------------------------------------------------------------------
# norms (family-selected)
# ---------------------------------------------------------------------------

def norm_init(cfg: ModelConfig, dim: int, *, device=None) -> Params:
    """RMSNorm or LayerNorm params, as ``cfg.norm`` says."""
    if cfg.norm == "layernorm":
        return L.layernorm_init(dim, device=device, dtype=cfg.param_dtype)
    return L.rmsnorm_init(dim, device=device, dtype=cfg.param_dtype)


def norm_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The family's norm over the last axis."""
    if cfg.norm == "layernorm":
        return L.layernorm_apply(p, x)
    return L.rmsnorm_apply(p, x)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Head-structured params: wq (d,Hp,hd), wk/wv (d,KV,hd), wo (Hp,hd,d).
    Hp = heads padded up; padded wo slices are zeroed (inert)."""
    hd, Hp, KV = cfg.head_dim, cfg.heads_padded, cfg.n_kv_heads
    d = cfg.d_model
    kw = dict(device=gen.device, dtype=cfg.param_dtype)
    std = 1.0 / (d ** 0.5)
    wo = L._trunc_normal(gen, (Hp, hd, d), 1.0 / ((cfg.n_heads * hd) ** 0.5),
                         **kw)
    wo[cfg.n_heads:] = 0
    return {"wq": L._trunc_normal(gen, (d, Hp, hd), std, **kw),
            "wk": L._trunc_normal(gen, (d, KV, hd), std, **kw),
            "wv": L._trunc_normal(gen, (d, KV, hd), std, **kw),
            "wo": wo}


def _proj(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., d) @ w (d, heads, hd) → (..., heads, hd)."""
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def project_kv(p: Params, x: torch.Tensor, xs: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., d) → k and v (..., KV, hd). Tensor-parallel: k and v of the
    rank's kv heads, or, where ``wk``/``wv`` are cut on their input
    dimension, ``x[..., d_r] @ w[d_r]`` summed over the ranks (whole).
    ``xs`` is ``x`` as it enters the rank's share of the work
    (:func:`TP.copy_to_model`; ``x`` itself by default): a split
    projection reads it, a whole one (``wk``/``wv`` replicated) ``x``."""
    tp = TP.current()
    if tp is None or tp.kv == "whole":
        return _proj(p["wk"], x), _proj(p["wv"], x)
    xs = x if xs is None else xs
    if tp.kv == "heads":
        return _proj(p["wk"], xs), _proj(p["wv"], xs)
    xs = xs[..., tp.embed[0]:tp.embed[1]].float()
    kv = TP.sum_partials(torch.cat([_proj(p["wk"].float(), xs),
                                    _proj(p["wv"].float(), xs)], -2),
                         tp.group, x.dtype)
    return kv.chunk(2, dim=-2)


def _project_qkv(p: Params, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., d) → q (..., Hp, hd) (tensor-parallel: of the rank's heads),
    k and v (..., KV, hd) (:func:`project_kv`)."""
    tp = TP.current()
    if tp is None:
        return (_proj(p["wq"], x), *project_kv(p, x))
    xs = TP.copy_to_model(x, tp.group)
    return (_proj(p["wq"], xs if tp.split_heads else x),
            *project_kv(p, x, xs))


def _out_proj(p: Params, out: torch.Tensor) -> torch.Tensor:
    """(..., Hp, hd) → (..., d); tensor-parallel, the rank's heads' share,
    summed over the ranks in fp32 (:func:`TP.sum_partials`)."""
    tp = TP.current()
    if tp is None or not tp.split_heads:
        return out.flatten(-2) @ p["wo"].flatten(0, 1)
    return TP.sum_partials(out.flatten(-2).float()
                           @ p["wo"].flatten(0, 1).float(), tp.group,
                           out.dtype)


def _kv_read(t: torch.Tensor) -> torch.Tensor:
    """The kv heads of ``t`` (..., KV, hd) that the rank's query heads read
    (``t`` itself off a tensor-parallel layout and where the rank holds
    its own kv heads); a whole ``t`` enters the rank's share here."""
    tp = TP.current()
    if tp is None or tp.kv == "heads":
        return t
    t = TP.copy_to_model(t, tp.group)
    return t[..., tp.kv_read[0]:tp.kv_read[1], :]


def rope_table(cfg: ModelConfig, positions) -> Rope:
    """The (cos, sin) table of ``positions``: (B, S) for ``pos="rope"``,
    (3, B, S) for ``pos="mrope"``; None where the config rotates nothing
    (``"none"``, and ``"sincos"``, which adds its positions to the
    input)."""
    if cfg.pos == "rope":
        return L.rope_table(positions, cfg.head_dim, theta=cfg.rope_theta)
    if cfg.pos == "mrope":
        return L.mrope_table(positions, cfg.head_dim,
                             sections=cfg.mrope_sections,
                             theta=cfg.rope_theta)
    return None


def _apply_positions(q, k, rope: Rope):
    """Rotate q and k by the forward's RoPE table (no-op without one)."""
    if rope is not None:
        q, k = L.rotate(q, rope), L.rotate(k, rope)
    return q, k


def _grouped(q: torch.Tensor, KV: int) -> torch.Tensor:
    """(B, S, H, hd) → the (B, KV, G, S, hd) view the kernels take."""
    B, S, H, hd = q.shape
    return q.view(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4)


def attend(p: Params, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool) -> torch.Tensor:
    """q (B, Sq, Hp, hd) over k, v (B, Skv, KV, hd) through
    ``flash_attention``, then the output projection → (B, Sq, d)."""
    B, Sq, H, hd = q.shape
    o = ops.flash_attention(_grouped(q, k.shape[2]), k.permute(0, 2, 1, 3),
                            v.permute(0, 2, 1, 3), causal=causal)
    return _out_proj(p, o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd))


def attention_apply(p: Params, x: torch.Tensor, rope: Rope, *,
                    causal: bool = True, return_kv: bool = False):
    """Full-sequence (prefill) self-attention through ``flash_attention``,
    causal unless told otherwise. x: (B, S, d). With ``return_kv`` also
    returns k, v (B, S, KV, hd)."""
    q, k, v = _project_qkv(p, x)
    q, k = _apply_positions(q, k, rope)
    out = attend(p, q, _kv_read(k), _kv_read(v), causal=causal)
    if return_kv:
        return out, (k, v)
    return out


def _write_row(cache: torch.Tensor, row: torch.Tensor, index: Index) -> None:
    """cache (B, Smax, KV, hd)[:, index] = row (B, 1, KV, hd), in place."""
    row = row.to(cache.dtype)
    if isinstance(index, torch.Tensor):
        cache.index_copy_(1, index.reshape(1).long(), row)
    else:
        cache[:, index] = row[:, 0]


def attention_decode(p: Params, x: torch.Tensor, rope: Rope,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     index: Index
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, 1, d); caches (B, Smax, KV, hd); index: the
    new token's position (an int, or an int32 tensor on the card). The new
    K/V row is written into the caches in place (the reference donates
    them); attention runs over positions ``<= index`` through
    ``decode_attention``. Returns (out, k_cache, v_cache). Over a
    sequence-sharded cache (tensor-parallel) the rank holds a block of the
    positions: :func:`_attend_block`."""
    q, k, v = _project_qkv(p, x)
    q, k = _apply_positions(q, k, rope)
    tp = TP.current()
    if tp is not None and tp.seq is not None:
        out = _attend_block(p, q, k, v, k_cache, v_cache, index, tp)
        return out, k_cache, v_cache
    _write_row(k_cache, k, index)
    _write_row(v_cache, v, index)
    length = index + 1
    if isinstance(length, torch.Tensor):
        length = length.reshape(1).to(torch.int32)
    return (attend_cache(p, q, _kv_read(k_cache), _kv_read(v_cache), length),
            k_cache, v_cache)


def _write_block_row(cache: torch.Tensor, row: torch.Tensor, index: Index,
                     s0: int) -> None:
    """Write ``row`` at position ``index`` of a cache block (B, n, KV, hd)
    that holds positions [s0, s0 + n), in place, where the block holds
    it. A tensor ``index`` stays on the device: the block's row at the
    clamped position is rewritten with itself where it is not owned."""
    n = cache.shape[1]
    if not isinstance(index, torch.Tensor):
        if s0 <= index < s0 + n:
            _write_row(cache, row, index - s0)
        return
    local = index.reshape(1).long() - s0
    pos = local.clamp(0, n - 1)
    owned = ((local >= 0) & (local < n)).view(1, 1, 1, 1)
    cache.index_copy_(1, pos, torch.where(owned, row.to(cache.dtype),
                                          cache.index_select(1, pos)))


def _attend_block(p: Params, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, index: Index, tp) -> torch.Tensor:
    """The reference's "flash-decoding style context parallelism" for a
    cache whose sequence is sharded on ``model`` (kv heads that do not
    divide the axis, the MQA decode): this rank holds positions
    ``tp.seq`` = [s0, s1) of the caches (B, s1 - s0, KV, hd) and the whole
    k, v of the new token (``wk``/``wv`` replicated). It writes the row
    where it holds ``index``, then attends over its valid positions,
    ``clamp(index + 1 - s0, 0, s1 - s0)`` of them
    (:func:`attend_blocks`). → (B, 1, d)."""
    s0, s1 = tp.seq
    _write_block_row(k_cache, k, index, s0)
    _write_block_row(v_cache, v, index, s0)
    if isinstance(index, torch.Tensor):
        length = (index.reshape(1) + 1 - s0).clamp(0, s1 - s0).to(
            torch.int32)
    else:
        length = max(0, min(index + 1 - s0, s1 - s0))
    return attend_blocks(p, q, k_cache, v_cache, length, tp)


def attend_blocks(p: Params, q: torch.Tensor, k_block: torch.Tensor,
                  v_block: torch.Tensor, length, tp) -> torch.Tensor:
    """One query row q (B, 1, H_r, hd) of the rank's heads over its block
    of a cache whose positions are sharded on ``model`` (B, n, KV, hd,
    every kv head), the first ``length`` of them valid: it gathers q to
    every head, attends for (o_r, lse_r), merges the ranks' by their
    softmax weights (:func:`repro_torch.parallel.tensor.merge_blocks`),
    then takes its heads' rows into ``wo`` (summed over the ranks). The
    self cache's decode (:func:`_attend_block`, after its row write) and
    the enc-dec's cross cache (every row of the block) both come here.
    → (B, 1, d)."""
    if tp.split_heads:                              # (m, B, 1, H/m, hd)
        q = TP.all_gather(q, tp.group, tp.size).permute(1, 2, 0, 3, 4)
        q = q.flatten(2, 3)
    B, _, H, hd = q.shape
    KV = k_block.shape[2]
    o, lse = ops.decode_attention(q.reshape(B, KV, H // KV, hd),
                                  k_block.permute(0, 2, 1, 3),
                                  v_block.permute(0, 2, 1, 3), length,
                                  return_lse=True)
    o = TP.merge_blocks(o, lse, tp).reshape(B, 1, H, hd)
    h0, h1 = tp.heads
    return _out_proj(p, o[:, :, h0:h1])


def attend_cache(p: Params, q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, length) -> torch.Tensor:
    """One query row q (B, 1, Hp, hd) over the first ``length`` rows of
    caches (B, Smax, KV, hd) through ``decode_attention``, then the output
    projection → (B, 1, d)."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    o = ops.decode_attention(q.view(B, KV, H // KV, hd),
                             k_cache.permute(0, 2, 1, 3),
                             v_cache.permute(0, 2, 1, 3), length)
    return _out_proj(p, o.reshape(B, 1, H, hd))


# ---------------------------------------------------------------------------
# FFN: dense SwiGLU / GELU
# ---------------------------------------------------------------------------

def ffn_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """SwiGLU: wi (d, 2·d_ff) = [gate | up], wo (d_ff, d); GELU: with
    biases, wi (d, d_ff)."""
    d_ff = cfg.d_ff
    kw = dict(device=gen.device, dtype=cfg.param_dtype)
    if cfg.act == "swiglu":
        return {"wi": L.dense_init(gen, cfg.d_model, 2 * d_ff, **kw),
                "wo": L.dense_init(gen, d_ff, cfg.d_model, **kw)}
    return {"wi": L.dense_init(gen, cfg.d_model, d_ff, use_bias=True, **kw),
            "wo": L.dense_init(gen, d_ff, cfg.d_model, use_bias=True, **kw)}


def ffn_apply(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The dense FFN. Tensor-parallel: the rank's columns of ``wi`` (a
    SwiGLU's as gate_r ‖ up_r) and rows of ``wo``, summed over the ranks
    before ``wo``'s bias."""
    tp = TP.current()
    split = tp is not None and tp.split_ffn
    h = L.dense_apply(p["wi"], TP.copy_to_model(x, tp.group) if split else x)
    if cfg.act == "swiglu":
        gate, up = h.chunk(2, dim=-1)
        h = L.swiglu(gate, up)
    else:
        h = L.gelu(h)
    if not split:
        return L.dense_apply(p["wo"], h)
    y = TP.sum_partials(h.float() @ p["wo"]["kernel"].float(), tp.group,
                        h.dtype)
    return y + p["wo"]["bias"] if "bias" in p["wo"] else y


# ---------------------------------------------------------------------------
# MoE FFN — sort-free scatter dispatch (token-dropping, GShard-style capacity)
# ---------------------------------------------------------------------------

def moe_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """fp32 router (d, E); experts wi (E, 2, d, d_ff) with wi[e, 0] the
    gate and wi[e, 1] the up projection, wo (E, d_ff, d)."""
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    kw = dict(device=gen.device, dtype=cfg.param_dtype)
    std = 1.0 / (d ** 0.5)
    return {"router": L.dense_init(gen, d, E, device=gen.device),
            "wi": L._trunc_normal(gen, (E, 2, d, ff), std, **kw),
            "wo": L._trunc_normal(gen, (E, ff, d), std, **kw)}


def moe_capacity(cfg: ModelConfig, tokens_per_row: int) -> int:
    """Slots per expert and batch row: cf·k·S/E + 1 rounded up to 8."""
    cap = int(cfg.capacity_factor * cfg.top_k * tokens_per_row
              / cfg.n_experts) + 1
    return max(cfg.top_k, -(-cap // 8) * 8)


def _moe_route(router_kernel: torch.Tensor, cfg: ModelConfig,
               x: torch.Tensor):
    """fp32 router logits → ``topk_gating`` → each of the S·K slots' expert
    and its position among that expert's slots in (token, k) order; a slot
    past the capacity C is dropped. Returns (top_w (B, S, K) fp32, flat_e
    (B, S·K), pos (B, S·K), keep (B, S·K), C)."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, S)
    gates = x.float() @ router_kernel                          # (B, S, E)
    top_w, top_e = ops.topk_gating(gates.reshape(B * S, E), K)
    flat_e = top_e.reshape(B, S * K).long()
    pos_in_e = F.one_hot(flat_e, E).cumsum(1) - 1              # (B, SK, E)
    pos = pos_in_e.gather(2, flat_e[..., None])[..., 0]
    return top_w.reshape(B, S, K), flat_e, pos, pos < C, C


def _gather_dispatch(x: torch.Tensor, dest: torch.Tensor, n_slots: int,
                     K: int) -> torch.Tensor:
    """x (B, S, d); dest (B, S·K) flat slot ids (``n_slots`` = the
    dustbin). Scatters only the slot → token indices, then gathers token
    rows; an unrouted slot reads a zero row. Returns (B, n_slots, d)."""
    B, S, d = x.shape
    src = torch.full((B, n_slots + 1), S, dtype=torch.long, device=x.device)
    tok = torch.arange(S * K, device=x.device) // K
    src.scatter_(1, dest, tok.expand(B, -1))
    x_pad = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)
    return x_pad[torch.arange(B, device=x.device)[:, None], src[:, :n_slots]]


def _expert_compute(buf: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                    partial: bool = False) -> torch.Tensor:
    """buf (B, E, C, d) × wi (E, 2, d, ff) × wo (E, ff, d) → (B, E, C, d):
    batched products, as the reference leaves them to XLA. ``partial``
    (``wi``/``wo`` a rank's block of ff, its products a share of the
    whole): ``wo``'s product in fp32, for :func:`TP.sum_partials`."""
    gate = torch.einsum("becd,edf->becf", buf, wi[:, 0])
    up = torch.einsum("becd,edf->becf", buf, wi[:, 1])
    h = L.swiglu(gate, up)
    if partial:
        h, wo = h.float(), wo.float()
    return torch.einsum("becf,efd->becd", h, wo)


def _combine(out: torch.Tensor, dest: torch.Tensor, top_w: torch.Tensor,
             dtype) -> torch.Tensor:
    """The experts' outputs ``out`` (B, n_slots, d') back at their slots:
    each token's K slot outputs weighted by ``top_w`` (B, S, K) and
    summed; a slot at the dustbin ``n_slots`` adds zeros. → (B, S, d')."""
    B, _, d = out.shape
    S, K = top_w.shape[1:]
    out = torch.cat([out, out.new_zeros((B, 1, d))], dim=1)
    slot_out = out[torch.arange(B, device=out.device)[:, None], dest]
    return torch.einsum("bskd,bsk->bsd", slot_out.reshape(B, S, K, d),
                        top_w.to(dtype))


def moe_apply(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The MoE FFN — the reference's single-device path
    (``_moe_apply_dense``): dispatch per batch row with capacity C; a
    dropped slot adds nothing (its token keeps only the residual of that
    slot). Under a tensor-parallel layout with an MoE, the reference's
    sharded paths (:func:`_moe_sharded`)."""
    tp = TP.current()
    if tp is not None and tp.moe is not None:
        return _moe_sharded(p, cfg, x, tp)
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    top_w, flat_e, pos, keep, C = _moe_route(p["router"]["kernel"], cfg, x)
    dest = torch.where(keep, flat_e * C + pos, E * C)          # dustbin E·C
    buf = _gather_dispatch(x, dest, E * C, K).reshape(B, E, C, d)
    out = _expert_compute(buf, p["wi"], p["wo"])
    return _combine(out.reshape(B, E * C, d), dest, top_w, x.dtype)


def _gather_d(w: torch.Tensor, ex: TP.Experts) -> torch.Tensor:
    """An expert matrix cut on d (its dim 2) over ``data``, whole again:
    the reference's FSDP re-gather."""
    return TP.all_gather(w, ex.data_group, ex.data_size).movedim(
        0, 2).flatten(2, 3)


def _moe_sharded(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 tp: TP.Layout) -> torch.Tensor:
    """The reference's ``_moe_apply_shard_map`` on this rank, whose rows
    ``x`` (B, S, d) every ``model`` rank of its data shard holds:

    - expert-parallel (the rank holds experts [e0, e1)): it routes every
      row, dispatches only the slots routed to its experts (the others to
      the dustbin), runs them and combines its partial output;
    - ff-sharded (every expert at the rank's ff block): it dispatches
      every slot; where the expert matrices are also cut on d over
      ``data``, a prefill first gathers them over ``data`` and a
      one-token step takes :func:`_moe_decode_2d`.

    The partial outputs are summed over the ``model`` ranks in fp32
    (:func:`TP.sum_partials`). Under grad (a train step) each rank's work
    is a share of the whole: ``x`` and the router's kernel, which every
    ``model`` rank holds whole, enter it through
    :func:`TP.copy_to_model`, so that the input's and the router's
    gradients are summed over the ranks (the router's then the same bits
    on every rank); an expert matrix gathered over ``data`` takes its
    gradient back by reduce-scatter (:func:`TP.all_gather`)."""
    ex = tp.moe
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    (e0, e1), (f0, f1), (d0, d1) = ex.experts, ex.ff, ex.embed
    wi, wo = p["wi"], p["wo"]
    if (tuple(wi.shape) != (e1 - e0, 2, d1 - d0, f1 - f0)
            or tuple(wo.shape) != (e1 - e0, f1 - f0, d1 - d0)):
        raise ValueError(
            f"expert weights wi {tuple(wi.shape)}, wo {tuple(wo.shape)} on "
            f"a rank that holds experts [{e0}, {e1}), ff [{f0}, {f1}) and "
            f"d [{d0}, {d1}): expected its blocks, cut by "
            f"parallel.tensor.shard_params")
    fsdp = (d0, d1) != (0, d)
    if fsdp and S == 1:
        return _moe_decode_2d(p, cfg, x, tp)
    router = TP.copy_to_model(p["router"]["kernel"], tp.group)
    x = TP.copy_to_model(x, tp.group)
    top_w, flat_e, pos, keep, C = _moe_route(router, cfg, x)
    if ex.split_experts:
        mine = (flat_e >= e0) & (flat_e < e1) & keep
        dest = torch.where(mine, (flat_e - e0) * C + pos, (e1 - e0) * C)
    else:
        dest = torch.where(keep, flat_e * C + pos, E * C)
        if fsdp:
            wi, wo = _gather_d(wi, ex), _gather_d(wo, ex)
    n = (e1 - e0) * C
    buf = _gather_dispatch(x, dest, n, K).reshape(B, e1 - e0, C, d)
    out = _expert_compute(buf, wi, wo, partial=not ex.split_experts)
    y = _combine(out.reshape(B, n, d).float(), dest, top_w.to(x.dtype),
                 torch.float32)
    return TP.sum_partials(y, tp.group, x.dtype)


def _moe_decode_2d(p: Params, cfg: ModelConfig, x: torch.Tensor,
                   tp: TP.Layout) -> torch.Tensor:
    """The reference's 2-D-sharded decode (one token a row, every expert
    at the rank's ff block and d block [d0, d1) over ``data``): gather the
    rows over ``data``, route them all, take the dispatched rows' d block,
    sum the gate and up products over ``data``, apply ``wo`` (the rank's
    ff rows and d columns), sum over ``model``, combine, gather the
    output's d columns over ``data`` and keep this rank's rows. The
    weights stay where they are: a few small collectives a layer."""
    ex = tp.moe
    B, _, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    d0, d1 = ex.embed
    xg = TP.all_gather(x, ex.data_group, ex.data_size).flatten(0, 1)
    Bf = xg.shape[0]
    top_w, flat_e, pos, keep, C = _moe_route(p["router"]["kernel"], cfg,
                                             xg)
    dest = torch.where(keep, flat_e * C + pos, E * C)
    buf = _gather_dispatch(xg, dest, E * C, K).reshape(Bf, E, C, d)
    buf = buf[..., d0:d1]
    buf, wi = buf.float(), p["wi"].float()
    gu = TP.sum_partials(torch.stack([
        torch.einsum("becd,edf->becf", buf, wi[:, 0]),
        torch.einsum("becd,edf->becf", buf, wi[:, 1])]), ex.data_group,
        x.dtype)
    out = TP.sum_partials(torch.einsum(
        "becf,efd->becd", L.swiglu(gu[0], gu[1]).float(), p["wo"].float()),
        tp.group, x.dtype)
    y = _combine(out.reshape(Bf, E * C, d1 - d0), dest, top_w, x.dtype)
    y = TP.all_gather(y.contiguous(), ex.data_group, ex.data_size)
    y = y.permute(1, 2, 0, 3).reshape(Bf, 1, d)
    return y[ex.data_index * B:(ex.data_index + 1) * B]


def moe_aux_loss(p: Params, cfg: ModelConfig, x: torch.Tensor
                 ) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): E · Σ_e f_e · p_e,
    with f_e the share of tokens whose top expert is e and p_e the mean
    router probability of e; plain torch, the reference's formula."""
    gates = L.dense_apply(p["router"], x.float())
    probs = torch.softmax(gates, dim=-1)                       # (B,S,E)
    top_e = probs.argmax(-1)
    f = F.one_hot(top_e, cfg.n_experts).float().mean((0, 1))
    pbar = probs.mean((0, 1))
    return cfg.n_experts * (f * pbar).sum()


def _ffn(p: Params, cfg: ModelConfig, x: torch.Tensor, moe: bool
         ) -> torch.Tensor:
    return moe_apply(p, cfg, x) if moe else ffn_apply(p, cfg, x)


# ---------------------------------------------------------------------------
# transformer block
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """One layer: attention and the FFN (MoE for ``family="moe"``), each
    behind its norm."""
    return {"attn_norm": norm_init(cfg, cfg.d_model, device=gen.device),
            "attn": attn_init(gen, cfg),
            "ffn_norm": norm_init(cfg, cfg.d_model, device=gen.device),
            "ffn": (moe_init(gen, cfg) if cfg.family == "moe"
                    else ffn_init(gen, cfg))}


def block_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, rope: Rope
                ) -> torch.Tensor:
    """Pre-norm causal residual block over a full sequence."""
    h = norm_apply(cfg, p["attn_norm"], x)
    x = x + attention_apply(p["attn"], h, rope)
    h = norm_apply(cfg, p["ffn_norm"], x)
    return x + _ffn(p["ffn"], cfg, h, cfg.family == "moe")


def block_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, rope: Rope,
                 kc: torch.Tensor, vc: torch.Tensor, index: Index
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pre-norm residual block for one token against the layer's cache."""
    h = norm_apply(cfg, p["attn_norm"], x)
    a, kc, vc = attention_decode(p["attn"], h, rope, kc, vc, index)
    x = x + a
    h = norm_apply(cfg, p["ffn_norm"], x)
    return x + _ffn(p["ffn"], cfg, h, cfg.family == "moe"), kc, vc


# ---------------------------------------------------------------------------
# LM: init / forward / cache / decode
# ---------------------------------------------------------------------------

def lm_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """All params, drawn from ``gen`` on its device: layers stacked on
    axis 0 (drawn one at a time into the stack), the output norm, the
    embedding and (untied) the LM head."""
    layers = stack_init(cfg.n_layers, lambda: block_init(gen, cfg))
    dev = gen.device
    p = {"layers": layers, "out_norm": norm_init(cfg, cfg.d_model, device=dev)}
    p["embed"] = L.embed_init(gen, cfg.vocab, cfg.d_model, device=dev,
                              dtype=cfg.param_dtype)
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab, device=dev,
                                    dtype=cfg.param_dtype)
    return p


def default_positions(cfg: ModelConfig, batch: int, seq: int,
                      offset: Index = 0, *, device=None) -> torch.Tensor:
    """(B, S) positions ``offset + arange(S)``; for M-RoPE (3, B, S), the
    three streams equal (text only), as the reference's stub positions.
    ``offset`` is an int or a one-element tensor on ``device``."""
    pos = (torch.arange(seq, device=device)[None, :] + offset).expand(
        batch, seq)
    if cfg.pos == "mrope":
        return pos.expand(3, batch, seq)
    return pos


def _layer(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked layer params (views)."""
    return tree_map(lambda t: t[i], params["layers"])


def _embed(params: Params, cfg: ModelConfig, tokens, embeds) -> torch.Tensor:
    """The input rows in ``compute_dtype``: ``embeds`` (B, S, d) where
    given (a stub frontend's patch or frame embeddings), else the token
    ids' embedding rows (a decode step's new token)."""
    if embeds is not None:
        return embeds.to(cfg.compute_dtype)
    tp = TP.current()
    if tp is not None and tp.split_vocab:
        return TP.embed_lookup(params["embed"]["embedding"], tokens,
                               tp).to(cfg.compute_dtype)
    return L.embed_apply(params["embed"], tokens).to(cfg.compute_dtype)


def lm_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
               embeds: Optional[torch.Tensor] = None,
               positions=None) -> torch.Tensor:
    """Full-sequence forward → logits (B, S, V)."""
    x = _embed(params, cfg, tokens, embeds)
    B, S = x.shape[:2]
    if positions is None:
        positions = default_positions(cfg, B, S, device=x.device)
    rope = rope_table(cfg, positions)
    for i in range(cfg.n_layers):
        x = block_apply(_layer(params, i), cfg, x, rope)
    x = norm_apply(cfg, params["out_norm"], x)
    return _lm_head(params, cfg, x)


def _lm_head(params: Params, cfg: ModelConfig, x: torch.Tensor
             ) -> torch.Tensor:
    """Logits of ``x``; tensor-parallel, the rank's vocabulary columns
    (its rows of a tied embedding), left sharded."""
    tp = TP.current()
    if tp is not None and tp.split_vocab:
        x = TP.copy_to_model(x, tp.group)
    if cfg.tie_embeddings or "lm_head" not in params:
        return L.embed_attend(params["embed"], x)
    return L.dense_apply(params["lm_head"], x)


def lm_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
               embeds: Optional[torch.Tensor] = None, positions=None
               ) -> Tuple[torch.Tensor, Params]:
    """Full-sequence prefill → (last-position logits (B, 1, V), KV cache
    {"k", "v"} of shape (L, B, S, KV, hd) covering the prompt)."""
    x = _embed(params, cfg, tokens, embeds)
    B, S = x.shape[:2]
    if positions is None:
        positions = default_positions(cfg, B, S, device=x.device)
    rope = rope_table(cfg, positions)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = norm_apply(cfg, lp["attn_norm"], x)
        a, (k, v) = attention_apply(lp["attn"], h, rope, return_kv=True)
        x = x + a
        h = norm_apply(cfg, lp["ffn_norm"], x)
        x = x + _ffn(lp["ffn"], cfg, h, cfg.family == "moe")
        ks.append(k.to(cfg.param_dtype))
        vs.append(v.to(cfg.param_dtype))
    x = norm_apply(cfg, params["out_norm"], x)
    logits = _lm_head(params, cfg, x[:, -1:])
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  device=None) -> Params:
    """Zero K/V caches (L, B, max_len, KV, hd) in ``param_dtype``."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.param_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.param_dtype, device=device)}


def lm_decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   cache: Params, index: Index, *,
                   embeds: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Params]:
    """One decode step. tokens: (B, 1); cache from :func:`lm_init_cache`,
    updated in place at ``index``. Returns (logits (B, 1, V), cache)."""
    x = _embed(params, cfg, tokens, embeds)
    pos = default_positions(cfg, x.shape[0], 1, offset=index,
                            device=x.device)
    rope = rope_table(cfg, pos)
    for i in range(cfg.n_layers):
        x, _, _ = block_decode(_layer(params, i), cfg, x, rope,
                               cache["k"][i], cache["v"][i], index)
    x = norm_apply(cfg, params["out_norm"], x)
    return _lm_head(params, cfg, x), cache


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy; logits (B,S,V) fp32-softmaxed, labels (B,S).
    Under a tensor-parallel layout whose logits are split on the
    vocabulary, :func:`_vocab_parallel_xent`."""
    tp = TP.current()
    if tp is not None and tp.split_vocab:
        return _vocab_parallel_xent(logits, labels, tp)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def _vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor,
                         tp: TP.Layout) -> torch.Tensor:
    """The mean cross-entropy of logits (B, S, V_r) holding the rank's
    vocabulary columns ``tp.vocab`` = [v0, v1): the row max over the
    ranks (no gradient: it cancels), the sum of exponentials and the gold
    logit (a masked gather in [v0, v1), 0 elsewhere) each summed over them
    (:func:`TP.reduce_from_model`). The loss is the whole vocabulary's on
    every rank, and the gradient of each rank's block of the logits is its
    block of softmax − one-hot."""
    logits = logits.float()
    v0, v1 = tp.vocab
    with torch.no_grad():
        m = TP.all_reduce(logits.amax(-1), tp.group, "max")
    sumexp = TP.reduce_from_model(torch.exp(logits - m[..., None]).sum(-1),
                                  tp.group, torch.float32)
    local = labels.long() - v0
    inside = (local >= 0) & (local < v1 - v0)
    gold = logits.gather(-1, local.clamp(0, v1 - v0 - 1)[..., None])[..., 0]
    gold = TP.reduce_from_model(torch.where(inside, gold, 0.0), tp.group,
                                torch.float32)
    return (m + torch.log(sumexp) - gold).mean()
