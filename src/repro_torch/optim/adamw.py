"""AdamW with mixed precision (bf16 params / fp32 master+moments) and
global-norm clipping.

The torch twin of the JAX package's ``optim/adamw.py``, with the same
fields, defaults and arithmetic: the schedule and the bias corrections in
float32 (``b1 ** step`` of a float32 step, as the reference computes it),
the moments and the master copy in fp32, each param the master cast to
its dtype. Parameter trees are those of :mod:`repro_torch.tree`.

:func:`apply_updates` works in place, under ``torch.no_grad()``: the
master copy, the moments and the params are updated in their own
storage, and the returned ``OptState`` holds the same trees (only
``step`` is a new tensor). The reference is functional; at 1.5 B
parameters a second copy of the state (24 GB) is what the in-place update
saves. Whoever needs the old state keeps a copy of it first
(``CheckpointManager.save`` does, before it returns).

ZeRO-1 (``apply_updates(..., zero1=Zero1(...))``): each rank of a data
group holds one block of the master copy and of the moments for every
leaf whose ``zero1_specs`` entry shards it on the data axis (the block
along that dimension), and the gradient of that block (reduce-scattered
by the caller); it updates its block in place, and the bf16 params are
gathered from every rank's block. The norm for the clip sums each
sharded leaf's squares over the group before the leaves are summed, so
the clip is the unsharded one; the arithmetic of each element, and the
order of the leaves' sum, are the reference's, so a group of one rank is
bit-equal to the step without ZeRO-1.

Tensor parallelism (``apply_updates(..., model=ModelSplit(...))``): each
rank of the ``model`` group holds its block of the leaves split on that
axis (params, gradients, master copy and moments alike; a ZeRO-1 block is
cut from it on ``data``, unless the leaf's own spec already cuts it on
``data``: then that block is the ZeRO-1 block, cut once). The clip's norm
sums such a leaf's squares over the ``model`` group too (and over
``data`` for a leaf its spec cuts there); a leaf replicated on ``model``
has the same gradient on every rank and counts once. The clip is then
the unsharded one, and the update of each element is the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.compat import all_gather_single
from repro_torch.tree import tree_leaves, tree_map

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    master_dtype: torch.dtype = torch.float32
    moment_dtype: torch.dtype = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor   # int32 scalar, on the params' device
    master: Params       # fp32 master copy of params
    m: Params
    v: Params


def init(cfg: AdamWConfig, params: Params) -> OptState:
    """A fresh state: the master a copy of ``params`` (never an alias, even
    in fp32), zero moments, step 0."""
    master = tree_map(lambda p: p.detach().to(cfg.master_dtype, copy=True),
                      params)
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,  # noqa: E731
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev), master,
                    tree_map(zeros, params), tree_map(zeros, params))


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(
        1.0, cfg.total_steps - cfg.warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


class Zero1(NamedTuple):
    """Where a rank's ZeRO-1 blocks lie: ``dims`` (the params' tree) holds
    each leaf's sharded dimension, or None for a leaf that ZeRO-1 does not
    cut (every rank holds it whole, or its params already are the rank's
    block on the data axis: :class:`ModelSplit`'s ``data``); this rank is
    ``rank`` of the ``size`` ranks of ``group``."""
    dims: Any
    rank: int
    size: int
    group: Any = None


def block(t: torch.Tensor, dim: Optional[int], zero1: Zero1
          ) -> torch.Tensor:
    """This rank's block of a whole leaf ``t`` (``t`` itself where the
    leaf is not sharded), a view."""
    if dim is None:
        return t
    n = t.shape[dim] // zero1.size
    return t.narrow(dim, zero1.rank * n, n)


def shard_state(state: OptState, zero1: Zero1) -> OptState:
    """A whole state's master copy and moments cut to this rank's blocks
    (copies, so that the whole leaves can be freed; a block that is the
    whole leaf is the leaf itself)."""
    def cut(t, d):
        b = block(t, d, zero1)
        return t if b.shape == t.shape else b.clone()
    return OptState(state.step, tree_map(cut, state.master, zero1.dims),
                    tree_map(cut, state.m, zero1.dims),
                    tree_map(cut, state.v, zero1.dims))


class ModelSplit(NamedTuple):
    """The leaves a rank holds a block of on the ``model`` axis: ``split``
    (the params' tree) is True for each, False for a leaf every rank of
    ``group`` (``size`` ranks) holds whole. ``data`` (None: no leaf) is
    True for a leaf whose params, gradients, master copy and moments are
    also the rank's block on the data axis (``data_group``, ``data_size``
    ranks), as the leaf's own spec places them (an MoE's expert matrix
    cut on d over ``data``): its ZeRO-1 block is that block."""
    split: Any
    group: Any
    size: int
    data: Any = None
    data_group: Any = None
    data_size: int = 1


def _sum_over(leaves: list, picked, size: int, group) -> None:
    """The sums ``leaves[i]`` for each leaf whose ``picked`` entry holds,
    summed over the group (in place in the list)."""
    idx = [i for i, p in enumerate(tree_leaves(picked)) if p]
    if idx and size > 1:
        part = torch.stack([leaves[i] for i in idx])
        dist.all_reduce(part, group=group)
        for j, i in enumerate(idx):
            leaves[i] = part[j]


def global_norm(tree: Params, zero1: Optional[Zero1] = None,
                model: Optional[ModelSplit] = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares; with ``zero1``
    a sharded leaf's sum is first summed over the group (``tree`` holds
    its blocks), with ``model`` a leaf split on that axis over its group
    (and one split on the data axis by its spec over that axis's)."""
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    if zero1 is not None:
        _sum_over(leaves, tree_map(lambda d: d is not None, zero1.dims),
                  zero1.size, zero1.group)
    if model is not None:
        if model.data is not None:
            _sum_over(leaves, model.data, model.data_size, model.data_group)
        _sum_over(leaves, model.split, model.size, model.group)
    return torch.sqrt(torch.stack(leaves).sum())


def clip_by_global_norm(tree: Params, max_norm: float,
                        zero1: Optional[Zero1] = None,
                        model: Optional[ModelSplit] = None
                        ) -> Tuple[Params, torch.Tensor]:
    """Scale every leaf by min(1, max_norm / norm), each in its dtype."""
    norm = global_norm(tree, zero1, model)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def _gather(p: torch.Tensor, piece: torch.Tensor, dim: int,
            zero1: Zero1) -> None:
    """Write every rank's block ``piece`` into the leaf ``p`` (whole on
    the data axis: this rank's ``model`` block of the leaf where it is
    split on ``model``, of which ``piece`` is a ZeRO-1 block)."""
    if zero1.size == 1:
        p.copy_(piece)
        return
    moved = piece.movedim(dim, 0).contiguous()
    out = torch.empty((zero1.size * moved.shape[0], *moved.shape[1:]),
                      dtype=piece.dtype, device=piece.device)
    all_gather_single(out, moved, group=zero1.group)
    p.copy_(out.movedim(0, dim))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Params, grads: Params,
                  state: OptState, *, zero1: Optional[Zero1] = None,
                  model: Optional[ModelSplit] = None
                  ) -> Tuple[Params, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step from ``grads`` (clipped first), in place: returns
    (params, state, {"grad_norm", "lr"}) with the same trees as given.
    With ``zero1`` the state, and the gradients, of a sharded leaf are
    this rank's blocks; ``params`` are whole, gathered after the update.
    With ``model`` every tree holds this rank's ``model`` blocks of the
    leaves split on that axis (:class:`ModelSplit`)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, zero1, model)
    step = state.step + 1
    lr = schedule(cfg, step)
    sf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** sf
    b2c = 1 - cfg.b2 ** sf

    def upd(p, master, g, m, v, dim):
        # the reference's operations in its order, each rounded once as
        # there; in place where a state array takes the result
        g = g.float()
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square().mul_(1 - cfg.b2))
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        delta.add_(master * cfg.weight_decay)
        master.sub_(delta.mul_(lr))
        if dim is None:
            p.copy_(master)
        else:
            _gather(p, master.to(p.dtype), dim, zero1)

    dims = zero1.dims if zero1 is not None else tree_map(lambda _: None,
                                                         params)
    tree_map(upd, params, state.master, grads, state.m, state.v, dims)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step, state.master, state.m, state.v), metrics
