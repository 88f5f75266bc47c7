"""Unified model API over the dense, moe, ssm and hybrid families.

    init(gen, cfg)                          -> params (on gen's device)
    forward(params, cfg, batch)             -> logits
    loss(params, cfg, batch)                -> scalar
    prefill(params, cfg, batch)             -> (logits, cache)
    init_cache(cfg, batch, max_len)         -> cache dict
    decode_step(params, cfg, batch, cache, index) -> (logits, cache)

``batch`` keys: tokens (B,S) int | positions (B,S) | labels (B,S). The
JAX package's ``models/api.py`` dispatches the same way; its vlm and
encdec families raise ``NotImplementedError`` here, naming ROADMAP Queue 1
item 2, with no fallback.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import hybrid as HY
from repro_torch.models import ssm as SS
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

Params = Dict[str, Any]


def _ported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) {T.NOT_PORTED}; the "
            f"port serves the dense, moe, ssm and hybrid families")


def init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Params drawn from ``gen``, on the generator's device."""
    _ported(cfg)
    if cfg.family == "ssm":
        return SS.ssm_lm_init(gen, cfg)
    if cfg.family == "hybrid":
        return HY.hybrid_init(gen, cfg)
    return T.lm_init(gen, cfg)


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, Any]
            ) -> torch.Tensor:
    """Full-sequence logits (B, S, V)."""
    _ported(cfg)
    fn = {"ssm": SS.ssm_lm_forward, "hybrid": HY.hybrid_forward}.get(
        cfg.family, T.lm_forward)
    return fn(params, cfg, batch.get("tokens"), embeds=batch.get("embeds"),
              positions=batch.get("positions"))


def loss(params: Params, cfg: ModelConfig, batch: Dict[str, Any]
         ) -> torch.Tensor:
    """Mean token cross-entropy of ``forward`` against ``batch["labels"]``."""
    return T.softmax_xent(forward(params, cfg, batch), batch["labels"])


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Params]:
    """Last-position logits (B, 1, V) and the prompt's cache."""
    _ported(cfg)
    fn = {"ssm": SS.ssm_prefill, "hybrid": HY.hybrid_prefill}.get(
        cfg.family, T.lm_prefill)
    return fn(params, cfg, batch.get("tokens"), embeds=batch.get("embeds"),
              positions=batch.get("positions"))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: DeviceLike = None) -> Params:
    """A zero cache on ``device`` (the card unless told otherwise)."""
    _ported(cfg)
    fn = {"ssm": SS.ssm_init_cache, "hybrid": HY.hybrid_init_cache}.get(
        cfg.family, T.lm_init_cache)
    return fn(cfg, batch, max_len, device=resolve_device(device))


def decode_step(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
                cache: Params, index) -> Tuple[torch.Tensor, Params]:
    """One token at position ``index``; the cache is updated in place."""
    _ported(cfg)
    fn = {"ssm": SS.ssm_decode_step, "hybrid": HY.hybrid_decode_step}.get(
        cfg.family, T.lm_decode_step)
    return fn(params, cfg, batch["tokens"], cache, index,
              embeds=batch.get("embeds"))


def param_count(params: Params) -> int:
    """Number of parameters in the tree."""
    return sum(int(t.numel()) for t in tree_leaves(params))
