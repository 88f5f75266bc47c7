"""Step functions (train / prefill / serve) that the trainer and the
server share.

The torch twin of the JAX package's ``launch/steps.py`` on one card. The
train step differentiates ``api.loss`` with ``loss.backward()`` for every
family (on the card through the hand-written ``rmsnorm``,
``flash_attention``, ``ssd_scan`` and ``topk_gating`` kernels, as the
family has the layers, and their backward kernels), then hands the
gradients to :func:`repro_torch.optim.adamw.apply_updates`, which updates
the state in place. A leaf the loss does not reach gets a zero gradient,
as ``jax.grad`` gives it: the VLM's ``embed`` table when ``embeds``
replace the tokens (AdamW still decays it). The params a caller holds
never need a gradient: each step differentiates detached leaves that
share their storage.

The mesh and ``ShapeDtypeStruct`` functions of the reference
(``make_rules``, ``batch_specs``, ``cache_specs``, ``param_specs``,
``state_specs``, ``input_specs``, ``jit_step``) belong to the multi-device
tooling (ROADMAP Queue 1 item 3) and are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.tree import trainable, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState


def loss_and_grads(params: Any, cfg: ModelConfig, batch: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Any]:
    """``api.loss`` and its gradient tree (a leaf that the loss does not
    reach gets zeros, as ``jax.grad`` gives). ``params`` is left as it
    is: the graph is built over detached leaves sharing its storage."""
    leaves = trainable(params)
    loss = api.loss(leaves, cfg, batch)
    loss.backward()
    grads = tree_map(lambda t: t.grad if t.grad is not None
                     else torch.zeros_like(t), leaves)
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[adamw.AdamWConfig] = None):
    """``train_step(state, batch) -> (state, metrics)``: the state is
    updated in place and returned; metrics ``loss``, ``grad_norm``,
    ``lr`` are 0-d tensors on the device."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(state: TrainState, batch: Dict[str, Any]):
        loss, grads = loss_and_grads(state.params, cfg, batch)
        new_params, new_opt, metrics = adamw.apply_updates(
            opt_cfg, state.params, grads, state.opt)
        metrics["loss"] = loss
        return TrainState(new_params, new_opt), metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params, batch):
        return api.prefill(params, cfg, batch)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    @torch.no_grad()
    def serve_step(params, cache, batch, index):
        logits, new_cache = api.decode_step(params, cfg, batch, cache, index)
        return logits, new_cache
    return serve_step


def step_fn_for(cfg: ModelConfig, shape: ShapeConfig,
                opt_cfg: Optional[adamw.AdamWConfig] = None):
    if shape.kind == "train":
        return make_train_step(cfg, opt_cfg)
    if shape.kind == "prefill":
        return make_prefill_step(cfg)
    return make_serve_step(cfg)
