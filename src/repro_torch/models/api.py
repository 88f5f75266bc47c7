"""Unified model API over every family: dense, moe, vlm, ssm, hybrid and
encdec.

    init(gen, cfg)                          -> params (on gen's device)
    init_meta(cfg)                          -> params as meta tensors
    forward(params, cfg, batch)             -> logits
    loss(params, cfg, batch)                -> scalar
    prefill(params, cfg, batch)             -> (logits, cache)
    init_cache(cfg, batch, max_len)         -> cache dict
    decode_step(params, cfg, batch, cache, index) -> (logits, cache)

``batch`` keys: tokens (B,S) int | embeds (B,S,d) | positions (B,S), or
(3,B,S) for M-RoPE | labels (B,S). ``embeds`` replace the token embedding
of the VLM (patch embeddings) and are the enc-dec's encoder frames, beside
its decoder ``tokens``. The JAX package's ``models/api.py`` dispatches the
same way.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import ssm as SS
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

Params = Dict[str, Any]


def init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Params drawn from ``gen``, on the generator's device."""
    fn = {"ssm": SS.ssm_lm_init, "hybrid": HY.hybrid_init,
          "encdec": ED.encdec_init}.get(cfg.family, T.lm_init)
    return fn(gen, cfg)                 # T.lm_init: dense | moe | vlm


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on ``meta``: shapes and dtypes, no
    storage (the inits place every leaf on ``gen.device``)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def init_meta(cfg: ModelConfig) -> Params:
    """The params of :func:`init` as ``meta`` tensors, instantly at any
    width: what the spec functions and the roofline count take, where
    the JAX package takes ``jax.eval_shape`` of its init."""
    return init(_MetaGenerator(), cfg)


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, Any]
            ) -> torch.Tensor:
    """Full-sequence logits (B, S, V)."""
    fn = {"ssm": SS.ssm_lm_forward, "hybrid": HY.hybrid_forward,
          "encdec": ED.encdec_forward}.get(cfg.family, T.lm_forward)
    return fn(params, cfg, batch.get("tokens"), embeds=batch.get("embeds"),
              positions=batch.get("positions"))


def loss(params: Params, cfg: ModelConfig, batch: Dict[str, Any]
         ) -> torch.Tensor:
    """Mean token cross-entropy of ``forward`` against ``batch["labels"]``."""
    return T.softmax_xent(forward(params, cfg, batch), batch["labels"])


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Params]:
    """Last-position logits (B, 1, V) and the prompt's cache."""
    fn = {"ssm": SS.ssm_prefill, "hybrid": HY.hybrid_prefill,
          "encdec": ED.encdec_prefill}.get(cfg.family, T.lm_prefill)
    return fn(params, cfg, batch.get("tokens"), embeds=batch.get("embeds"),
              positions=batch.get("positions"))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               enc_len: Optional[int] = None,
               device: DeviceLike = None) -> Params:
    """A zero cache on ``device`` (the card unless told otherwise).
    ``enc_len`` sizes the enc-dec's cross cache (``max_len`` when not
    given, the reference's layout); other families take none."""
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return ED.encdec_init_cache(cfg, batch, max_len, enc_len=enc_len,
                                    device=dev)
    if enc_len is not None:
        raise ValueError(f"enc_len sizes an enc-dec's cross cache; the "
                         f"{cfg.family!r} family has none")
    fn = {"ssm": SS.ssm_init_cache, "hybrid": HY.hybrid_init_cache}.get(
        cfg.family, T.lm_init_cache)
    return fn(cfg, batch, max_len, device=dev)


def decode_step(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
                cache: Params, index) -> Tuple[torch.Tensor, Params]:
    """One token at position ``index``; the cache is updated in place."""
    fn = {"ssm": SS.ssm_decode_step, "hybrid": HY.hybrid_decode_step,
          "encdec": ED.encdec_decode_step}.get(cfg.family, T.lm_decode_step)
    return fn(params, cfg, batch["tokens"], cache, index,
              embeds=batch.get("embeds"))


def param_count(params: Params) -> int:
    """Number of parameters in the tree."""
    return sum(int(t.numel()) for t in tree_leaves(params))
