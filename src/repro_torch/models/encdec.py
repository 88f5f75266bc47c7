"""Whisper-style encoder-decoder backbone (arXiv:2212.04356): the ``encdec``
family.

The JAX package's ``models/encdec.py`` with the same parameter tree
(``embed``, ``enc_layers``, ``enc_norm``, ``dec_layers``, ``dec_norm``,
``lm_head``; layers stacked on axis 0) and the same cache layout
{"k", "v", "ck", "cv"} (L_dec, B, S, KV, hd). The conv audio frontend is a
stub: the encoder takes precomputed frame embeddings (B, S_enc, d_model)
as ``embeds``. LayerNorm, GELU and multi-head attention, sinusoidal
positions added to the input, cross-attention from the decoder to the
encoder's states. The encoder's self-attention runs through
``flash_attention(causal=False)``, the decoder's through
``flash_attention(causal=True)``, and cross-attention, the decoder's
S_dec rows over the encoder's S_enc, through ``flash_attention(
causal=False)``; a decode step attends to its self cache and to the cross
cache through ``decode_attention``. Each decoder layer's cross K/V are
computed once a forward. LayerNorm and GELU are plain (no kernel).
Training differentiates the same forward through ``flash_attention_bwd``.

Under a tensor-parallel layout (``parallel.tensor.Layout``: a mesh step
with ``model`` > 1) the encoder's self-attention, the decoder's self-
and cross-attention and both FFNs run the rank's blocks as
``models/transformer.py`` does; the cross K/V go through the same
projection as self-attention's (``T.project_kv``), and a decode step
attends to the rank's kv heads of the cross cache, or to its block of
the encoder's rows, merged over the ranks by log-sum-exp
(``T.attend_blocks``).

Differences from the reference:

- the cross cache holds exactly the encoder's rows. A decode step attends
  to all of ``ck``/``cv``, whatever their length. The reference's
  ``generate`` splices the prefill's cross K/V into a cache of the decode
  length (``init_cache(cfg, batch, max_len)``), zero-padding them, and
  its ``_cross_attend`` has no mask, so every decode step there also
  attends to zero keys and values past the encoder's rows.
  :func:`encdec_init_cache` takes ``enc_len`` for the cross cache's rows
  (``max_len``, the reference's layout, when not given), and the port's
  ``greedy_decode`` passes the encoder's length, so nothing is padded;
- a decode step writes its K/V row into the self cache in place, and
  there is no ``train`` flag, as in ``transformer.py``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel import tensor as TP
from repro_torch.tree import stack_init, tree_map

Params = Dict[str, Any]


def sincos_positions(seq: int, dim: int, offset: T.Index = 0, *,
                     device=None) -> torch.Tensor:
    """(seq, dim) fp32 sinusoids of positions ``offset + arange(seq)``:
    sines in the first half, cosines in the second. ``offset`` is an int
    or a one-element tensor on ``device``."""
    pos = torch.arange(seq, dtype=torch.float32, device=device) + offset
    inv = torch.exp(-torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=device) / dim * math.log(10000.0))
    ang = pos.reshape(seq, 1) * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _add_positions(cfg: ModelConfig, x: torch.Tensor, offset: T.Index = 0
                   ) -> torch.Tensor:
    S = x.shape[1]
    return x + sincos_positions(S, cfg.d_model, offset, device=x.device
                                ).to(cfg.compute_dtype)[None]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def enc_block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """One encoder layer: self-attention and the FFN, each behind its norm."""
    dev = gen.device
    return {"attn_norm": T.norm_init(cfg, cfg.d_model, device=dev),
            "attn": T.attn_init(gen, cfg),
            "ffn_norm": T.norm_init(cfg, cfg.d_model, device=dev),
            "ffn": T.ffn_init(gen, cfg)}


def dec_block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """One decoder layer: causal self-attention, cross-attention and the
    FFN, each behind its norm."""
    dev = gen.device
    return {"self_norm": T.norm_init(cfg, cfg.d_model, device=dev),
            "self_attn": T.attn_init(gen, cfg),
            "cross_norm": T.norm_init(cfg, cfg.d_model, device=dev),
            "cross_attn": T.attn_init(gen, cfg),
            "ffn_norm": T.norm_init(cfg, cfg.d_model, device=dev),
            "ffn": T.ffn_init(gen, cfg)}


def _cross_kv(p: Params, enc: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder's states (B, S_enc, d) → cross k, v (B, S_enc, KV, hd)
    (tensor-parallel: the rank's kv heads, or whole, summed over the
    input-dim blocks of ``wk``/``wv``: ``T.project_kv``)."""
    return T.project_kv(p, enc)


def _cross_attend(p: Params, x: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """x (B, S_dec, d) over the encoder's k, v (B, S_enc, KV, hd), no mask,
    through ``flash_attention(causal=False)`` (tensor-parallel: the rank's
    heads over the kv heads they read)."""
    return T.attend(p, T._proj(p["wq"], x), T._kv_read(k), T._kv_read(v),
                    causal=False)


def _cross_decode(p: Params, x: torch.Tensor, ck: torch.Tensor,
                  cv: torch.Tensor) -> torch.Tensor:
    """One decoder row x (B, 1, d) over every row of the cross cache
    (B, S_enc, KV, hd) through ``decode_attention``. Tensor-parallel over
    a cross cache whose rows are sharded on ``model`` (``Layout.cross_seq``:
    kv heads that do not divide the axis), the rank's block of the rows,
    each of them valid, merged over the ranks by log-sum-exp
    (``T.attend_blocks``); else its kv heads, or the kv heads its query
    heads read."""
    q = T._proj(p["wq"], x)
    tp = TP.current()
    if tp is not None and tp.cross_seq is not None:
        return T.attend_blocks(p, q, ck, cv, ck.shape[1], tp)
    return T.attend_cache(p, q, T._kv_read(ck), T._kv_read(cv), ck.shape[1])


def _layer(stack: Params, i: int) -> Params:
    return tree_map(lambda t: t[i], stack)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def encdec_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """All params, drawn from ``gen`` on its device."""
    dev, dt = gen.device, cfg.param_dtype
    return {
        "embed": L.embed_init(gen, cfg.vocab, cfg.d_model, device=dev,
                              dtype=dt),
        "enc_layers": stack_init(cfg.n_enc_layers,
                                 lambda: enc_block_init(gen, cfg)),
        "enc_norm": T.norm_init(cfg, cfg.d_model, device=dev),
        "dec_layers": stack_init(cfg.n_dec_layers,
                                 lambda: dec_block_init(gen, cfg)),
        "dec_norm": T.norm_init(cfg, cfg.d_model, device=dev),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.vocab, device=dev,
                                dtype=dt),
    }


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames: precomputed frame embeddings (B, S_enc, d_model) → the
    encoder's normalised states (B, S_enc, d_model)."""
    x = _add_positions(cfg, frames.to(cfg.compute_dtype))
    for i in range(cfg.n_enc_layers):
        lp = _layer(params["enc_layers"], i)
        h = T.norm_apply(cfg, lp["attn_norm"], x)
        x = x + T.attention_apply(lp["attn"], h, None, causal=False)
        h = T.norm_apply(cfg, lp["ffn_norm"], x)
        x = x + T.ffn_apply(lp["ffn"], cfg, h)
    return T.norm_apply(cfg, params["enc_norm"], x)


def _decoder(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
             enc: torch.Tensor, keep_cache: bool):
    """The teacher-forced decoder over all of ``tokens`` (B, S_dec): the
    final states (B, S_dec, d) and, with ``keep_cache``, each layer's self
    k, v and cross ck, cv in ``param_dtype``."""
    x = _add_positions(cfg, T._embed(params, cfg, tokens, None))
    cache = {"k": [], "v": [], "ck": [], "cv": []}
    for i in range(cfg.n_dec_layers):
        lp = _layer(params["dec_layers"], i)
        h = T.norm_apply(cfg, lp["self_norm"], x)
        a, (k, v) = T.attention_apply(lp["self_attn"], h, None, causal=True,
                                      return_kv=True)
        x = x + a
        h = T.norm_apply(cfg, lp["cross_norm"], x)
        ck, cv = _cross_kv(lp["cross_attn"], enc)
        x = x + _cross_attend(lp["cross_attn"], h, ck, cv)
        h = T.norm_apply(cfg, lp["ffn_norm"], x)
        x = x + T.ffn_apply(lp["ffn"], cfg, h)
        if keep_cache:
            for name, t in (("k", k), ("v", v), ("ck", ck), ("cv", cv)):
                cache[name].append(t.to(cfg.param_dtype))
    return x, cache


def decode_train(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 enc: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder logits (B, S_dec, V) over the encoder's
    states ``enc`` (B, S_enc, d)."""
    x, _ = _decoder(params, cfg, tokens, enc, False)
    x = T.norm_apply(cfg, params["dec_norm"], x)
    return L.dense_apply(params["lm_head"], x)


def encdec_forward(params: Params, cfg: ModelConfig, tokens, *, embeds=None,
                   positions=None) -> torch.Tensor:
    """Unified API: ``embeds`` are the encoder's frames (the stub
    frontend), ``tokens`` the decoder's; ``positions`` is unused (the
    positions are sinusoids added to the inputs)."""
    return decode_train(params, cfg, tokens, encode(params, cfg, embeds))


def encdec_prefill(params: Params, cfg: ModelConfig, tokens, *, embeds=None,
                   positions=None) -> Tuple[torch.Tensor, Params]:
    """The encoder over ``embeds`` (B, S_enc, d), then the teacher-forced
    decoder over ``tokens`` (B, S_dec) → (last-position logits (B, 1, V),
    cache {"k", "v"} (L_dec, B, S_dec, KV, hd) and {"ck", "cv"}
    (L_dec, B, S_enc, KV, hd))."""
    enc = encode(params, cfg, embeds)
    x, cache = _decoder(params, cfg, tokens, enc, True)
    x = T.norm_apply(cfg, params["dec_norm"], x[:, -1:])
    logits = L.dense_apply(params["lm_head"], x)
    return logits, {k: torch.stack(v) for k, v in cache.items()}


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                      enc_len: Optional[int] = None, device=None) -> Params:
    """Zero caches in ``param_dtype``: self K/V (L_dec, B, max_len, KV, hd)
    and cross K/V (L_dec, B, enc_len, KV, hd), ``enc_len`` the encoder's
    length (``max_len`` when not given, as the reference lays it out)."""
    enc_len = max_len if enc_len is None else enc_len
    shape = (cfg.n_dec_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cross = shape[:2] + (enc_len,) + shape[3:]
    kw = dict(dtype=cfg.param_dtype, device=device)
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw),
            "ck": torch.zeros(cross, **kw), "cv": torch.zeros(cross, **kw)}


def encdec_prefill_cross(params: Params, cfg: ModelConfig, enc: torch.Tensor,
                         cache: Params) -> Params:
    """The cache with each decoder layer's cross K/V computed from the
    encoder's states ``enc`` (B, S_enc, d) (new ``ck``/``cv`` leaves of
    S_enc rows; the self K/V as they were)."""
    ck, cv = zip(*(_cross_kv(_layer(params["dec_layers"], i)["cross_attn"],
                             enc) for i in range(cfg.n_dec_layers)))
    return {**cache, "ck": torch.stack(ck).to(cfg.param_dtype),
            "cv": torch.stack(cv).to(cfg.param_dtype)}


def encdec_decode_step(params: Params, cfg: ModelConfig, tokens, cache,
                       index: T.Index, *, embeds=None
                       ) -> Tuple[torch.Tensor, Params]:
    """One decoder token (B, 1) at position ``index``: its self K/V row is
    written into the self cache in place and attended up to ``index``;
    cross-attention reads every row of the cross cache (the encoder's
    length). ``embeds`` is unused, as in the reference. Returns (logits
    (B, 1, V), cache)."""
    x = _add_positions(cfg, T._embed(params, cfg, tokens, None), index)
    for i in range(cfg.n_dec_layers):
        lp = _layer(params["dec_layers"], i)
        h = T.norm_apply(cfg, lp["self_norm"], x)
        a, _, _ = T.attention_decode(lp["self_attn"], h, None, cache["k"][i],
                                     cache["v"][i], index)
        x = x + a
        h = T.norm_apply(cfg, lp["cross_norm"], x)
        x = x + _cross_decode(lp["cross_attn"], h, cache["ck"][i],
                              cache["cv"][i])
        h = T.norm_apply(cfg, lp["ffn_norm"], x)
        x = x + T.ffn_apply(lp["ffn"], cfg, h)
    x = T.norm_apply(cfg, params["dec_norm"], x)
    return L.dense_apply(params["lm_head"], x), cache
