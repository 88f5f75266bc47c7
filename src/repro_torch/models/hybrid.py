"""Jamba-style hybrid (arXiv:2403.19887): the ``hybrid`` family.

attn:mamba 1:7 interleave, MoE every ``moe_period`` layers. The repeating
period (``attn_period`` layers) is the unit stacked on axis 0 ("periods");
the sub-layers inside a period differ (``sub0`` … ``sub{n-1}``). The JAX
package's ``models/hybrid.py`` with the same parameter tree and cache
layout: {"k", "v"} (NP, B, S, KV, hd) and {"conv", "state"}
(NP, n_mamba, B, …). Attention, MoE and FFN come from ``transformer.py``,
the mamba mixer from ``ssm.py``, so a period runs ``rmsnorm``,
``ssd_scan`` (prefill), ``flash_attention`` (prefill),
``decode_attention`` (decode) and ``topk_gating``; training
differentiates a period through the backward kernels of the four it runs
forward (``rmsnorm_bwd``, ``ssd_scan_bwd``, ``flash_attention_bwd``,
``topk_gating_bwd``). Jamba has ``pos="none"``: attention is unrotated. A decode step updates the cache
in place, and there is no ``train`` flag, as in ``transformer.py``.

Under a tensor-parallel layout (a mesh step with ``model`` > 1) each
sub-layer runs its own split, as the layout reads each kind from the
sub-layer that holds it (``parallel.tensor.layout``): the attention's
heads (and the MQA fallbacks) and the dense FFN's columns as in
``transformer.py``, the MoE's experts as the reference's
``_moe_apply_shard_map``, the mamba mixers' SSM heads or head channels
as in ``ssm.py``; the cache is each rank's block of {k, v, conv,
state}.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.tree import stack_init, tree_map

Params = Dict[str, Any]


def _layer_kinds(cfg: ModelConfig) -> List[Tuple[bool, bool]]:
    """(is_attn, is_moe) for each sub-layer of one period: attention in the
    middle of the period, MoE at odd sub-layers."""
    kinds = []
    for i in range(cfg.attn_period):
        is_attn = i % cfg.attn_period == cfg.attn_period // 2
        is_moe = (cfg.n_experts > 0 and cfg.moe_period > 0
                  and i % cfg.moe_period == 1)
        kinds.append((is_attn, is_moe))
    return kinds


def n_periods(cfg: ModelConfig) -> int:
    """Periods in the model; ``n_layers`` must be a whole number of them."""
    if cfg.n_layers % cfg.attn_period:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"attn_period {cfg.attn_period}")
    return cfg.n_layers // cfg.attn_period


def _sub_init(gen: torch.Generator, cfg: ModelConfig, is_attn: bool,
              is_moe: bool) -> Params:
    dev = gen.device
    return {"mixer_norm": T.norm_init(cfg, cfg.d_model, device=dev),
            "ffn_norm": T.norm_init(cfg, cfg.d_model, device=dev),
            "mixer": T.attn_init(gen, cfg) if is_attn else S.mamba_init(gen, cfg),
            "ffn": T.moe_init(gen, cfg) if is_moe else T.ffn_init(gen, cfg)}


def period_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """One period's sub-layers ``sub0`` … ``sub{attn_period-1}``."""
    return {f"sub{i}": _sub_init(gen, cfg, a, m)
            for i, (a, m) in enumerate(_layer_kinds(cfg))}


def hybrid_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """All params, drawn from ``gen`` on its device, the periods one at a
    time into their stack."""
    dev = gen.device
    embed = L.embed_init(gen, cfg.vocab, cfg.d_model, device=dev,
                         dtype=cfg.param_dtype)
    return {"embed": embed,
            "periods": stack_init(n_periods(cfg),
                                  lambda: period_init(gen, cfg)),
            "out_norm": T.norm_init(cfg, cfg.d_model, device=dev),
            "lm_head": L.dense_init(gen, cfg.d_model, cfg.vocab, device=dev,
                                    dtype=cfg.param_dtype)}


def _period(params: Params, i: int) -> Params:
    """Period ``i``'s slice of the stacked period params (views)."""
    return tree_map(lambda t: t[i], params["periods"])


def _rope(cfg: ModelConfig, B: int, Sq: int, offset, device) -> T.Rope:
    return T.rope_table(cfg, T.default_positions(cfg, B, Sq, offset,
                                                  device=device))


def _ffn(sp: Params, cfg: ModelConfig, x: torch.Tensor, is_moe: bool
         ) -> torch.Tensor:
    h = T.norm_apply(cfg, sp["ffn_norm"], x)
    return x + T._ffn(sp["ffn"], cfg, h, is_moe)


def _period_apply(pp: Params, cfg: ModelConfig, x: torch.Tensor,
                  rope: T.Rope) -> torch.Tensor:
    for i, (is_attn, is_moe) in enumerate(_layer_kinds(cfg)):
        sp = pp[f"sub{i}"]
        h = T.norm_apply(cfg, sp["mixer_norm"], x)
        if is_attn:
            x = x + T.attention_apply(sp["mixer"], h, rope)
        else:
            x = x + S.mamba_apply(sp["mixer"], cfg, h)
        x = _ffn(sp, cfg, x, is_moe)
    return x


def hybrid_forward(params: Params, cfg: ModelConfig, tokens, *, embeds=None,
                   positions=None) -> torch.Tensor:
    """Full-sequence logits (B, S, V)."""
    x = T._embed(params, cfg, tokens, embeds)
    B, Sq = x.shape[:2]
    rope = (_rope(cfg, B, Sq, 0, x.device) if positions is None
            else T.rope_table(cfg, positions))
    for i in range(n_periods(cfg)):
        x = _period_apply(_period(params, i), cfg, x, rope)
    x = T.norm_apply(cfg, params["out_norm"], x)
    return L.dense_apply(params["lm_head"], x)


def hybrid_prefill(params: Params, cfg: ModelConfig, tokens, *, embeds=None,
                   positions=None) -> Tuple[torch.Tensor, Params]:
    """Prefill → (last-position logits (B, 1, V), {k, v, conv, state})."""
    x = T._embed(params, cfg, tokens, embeds)
    B, Sq = x.shape[:2]
    rope = (_rope(cfg, B, Sq, 0, x.device) if positions is None
            else T.rope_table(cfg, positions))
    ks, vs, convs, states = [], [], [], []
    for pi in range(n_periods(cfg)):
        pp = _period(params, pi)
        conv, state = [], []
        for i, (is_attn, is_moe) in enumerate(_layer_kinds(cfg)):
            sp = pp[f"sub{i}"]
            h = T.norm_apply(cfg, sp["mixer_norm"], x)
            if is_attn:
                a, (k, v) = T.attention_apply(sp["mixer"], h, rope,
                                              return_kv=True)
                x = x + a
            else:
                y, h_fin, conv_tail = S.mamba_apply(sp["mixer"], cfg, h,
                                                    return_state=True)
                conv.append(conv_tail.to(cfg.param_dtype))
                state.append(h_fin)
                x = x + y
            x = _ffn(sp, cfg, x, is_moe)
        ks.append(k.to(cfg.param_dtype))
        vs.append(v.to(cfg.param_dtype))
        convs.append(torch.stack(conv))
        states.append(torch.stack(state))
    x = T.norm_apply(cfg, params["out_norm"], x[:, -1:].contiguous())
    return (L.dense_apply(params["lm_head"], x),
            {"k": torch.stack(ks), "v": torch.stack(vs),
             "conv": torch.stack(convs), "state": torch.stack(states)})


def hybrid_init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                      device=None) -> Params:
    """Zero K/V caches (NP, B, max_len, KV, hd) and conv windows (NP,
    n_mamba, B, k−1, CH) in ``param_dtype``; fp32 states (NP, n_mamba, B,
    H, P, N)."""
    NP = n_periods(cfg)
    d_in, H, P, N, conv_ch = S._dims(cfg)
    n_mamba = sum(1 for a, _ in _layer_kinds(cfg) if not a)
    kv = (NP, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    pd = dict(dtype=cfg.param_dtype, device=device)
    return {"k": torch.zeros(kv, **pd), "v": torch.zeros(kv, **pd),
            "conv": torch.zeros((NP, n_mamba, batch, cfg.ssm_conv - 1,
                                 conv_ch), **pd),
            "state": torch.zeros((NP, n_mamba, batch, H, P, N),
                                 dtype=torch.float32, device=device)}


def hybrid_decode_step(params: Params, cfg: ModelConfig, tokens, cache,
                       index, *, embeds=None) -> Tuple[torch.Tensor, Params]:
    """One decode step at position ``index``; the cache is updated in
    place."""
    x = T._embed(params, cfg, tokens, embeds)
    rope = _rope(cfg, x.shape[0], 1, index, x.device)
    for pi in range(n_periods(cfg)):
        pp = _period(params, pi)
        mi = 0
        for i, (is_attn, is_moe) in enumerate(_layer_kinds(cfg)):
            sp = pp[f"sub{i}"]
            h = T.norm_apply(cfg, sp["mixer_norm"], x)
            if is_attn:
                a, _, _ = T.attention_decode(sp["mixer"], h, rope,
                                             cache["k"][pi], cache["v"][pi],
                                             index)
                x = x + a
            else:
                y, conv, state = S.mamba_decode(sp["mixer"], cfg, h,
                                                cache["conv"][pi, mi],
                                                cache["state"][pi, mi])
                cache["conv"][pi, mi] = conv
                cache["state"][pi, mi] = state
                mi += 1
                x = x + y
            x = _ffn(sp, cfg, x, is_moe)
    x = T.norm_apply(cfg, params["out_norm"], x)
    return L.dense_apply(params["lm_head"], x), cache
