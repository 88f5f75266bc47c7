"""End-to-end training driver: --arch <id> (reduced or full config), data
pipeline → train step → checkpoint/restart → optional grad compression.

The torch twin of the JAX package's ``launch/train.py`` on one card (the
CUDA device unless ``device="cpu"``). Weights are drawn from ``seed`` on
the device, batches come from the copied ``SyntheticTokens``, and each
step is ``loss.backward()`` (on the card through the hand-written forward
and backward kernels of the family's layers: ``flash_attention`` in every
family with attention, ``rmsnorm`` in every family but the enc-dec, which
normalises with plain LayerNorm, ``ssd_scan`` in the ssm and hybrid
families, ``topk_gating`` in the moe and hybrid families' routers), then
:func:`repro_torch.optim.compression.compress_grads`, then
:func:`repro_torch.optim.adamw.apply_updates` (in place).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --full --steps 20 --batch 4 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
      --full --steps 20 --batch 4 --seq 512

Where the last step is a multiple of ``ckpt_every``, its save in the loop
is the final checkpoint (the reference writes that step a second time,
the same state; at 1.5 B parameters that is 21 GB more of disk writes).
As in the reference, the ``AdamWConfig`` comes from this call's ``steps``
(so a resumed run's schedule is not the uninterrupted one), and the
schedule, the optimiser state and the data position resume from the
checkpoint. Every family trains here (``device="cpu"``, the kernels'
plain versions forward and backward) and on the card. As in the
reference, the loss is the cross-entropy alone: the MoE's load-balancing
``moe_aux_loss`` joins no loss in either package.

A config with ``embed_inputs`` (the VLM, the enc-dec) gets a batch of
random embeddings each step beside the token batch, N(0, 1) × 0.02 of
shape (batch, seq, d_model) in ``compute_dtype``, as the reference's
stub frontend: the VLM's patch embeddings (its labels come from the token
data) and the enc-dec's encoder frames. They are drawn on the device from
a generator seeded by ``(seed, global step)`` (:func:`embed_batch`), so a
resumed run sees the embeddings an uninterrupted one saw. The reference
folds the loop's index into its key instead, which restarts at 0 on
resume.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.archs import tiny_version
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.data.tokens import SyntheticTokens, TokenTaskConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import steps as ST
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.optim.compression import (CompressionConfig, compress_grads,
                                           init_state)


def make_compressed_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                               comp_cfg: CompressionConfig):
    """``train_step(state, comp_state, batch) -> (state, comp_state,
    metrics)``; the state is updated in place."""
    def train_step(state, comp_state, batch):
        loss, grads = ST.loss_and_grads(state.params, cfg, batch)
        grads, comp_state = compress_grads(comp_cfg, grads, comp_state)
        new_params, new_opt, metrics = adamw.apply_updates(
            opt_cfg, state.params, grads, state.opt)
        metrics["loss"] = loss
        return ST.TrainState(new_params, new_opt), comp_state, metrics
    return train_step


def embed_batch(cfg: ModelConfig, batch: int, seq: int, seed: int,
                step: int, device: torch.device) -> torch.Tensor:
    """The stub frontend's embeddings for global step ``step`` (counted
    from 0): N(0, 1) × 0.02, (batch, seq, d_model) in ``compute_dtype``,
    from a generator on ``device`` seeded by ``seed`` and ``step`` (mixed
    by numpy's ``SeedSequence``: the CPU generator keeps 32 bits of its
    seed)."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1)[0]
    g = torch.Generator(device=device).manual_seed(int(mixed))
    return (torch.randn((batch, seq, cfg.d_model), generator=g,
                        device=device) * 0.02).to(cfg.compute_dtype)


def run(arch: str, *, tiny: bool = True, steps: int = 100, batch: int = 8,
        seq: int = 128, lr: float = 3e-4, ckpt_dir: Optional[str] = None,
        ckpt_every: int = 50, resume: bool = False,
        compression: str = "none", log_every: int = 10,
        seed: int = 0, verbose: bool = True, device: DeviceLike = None):
    """Train ``arch`` for ``steps`` steps. Returns (state, losses), the
    losses as Python floats (read once, after the last step)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if tiny:
        cfg = tiny_version(cfg)
    opt_cfg = adamw.AdamWConfig(lr=lr, total_steps=steps,
                                warmup_steps=max(steps // 10, 1))
    comp_cfg = CompressionConfig(scheme=compression)

    params = api.init(torch.Generator(device=dev).manual_seed(seed), cfg)
    state = ST.TrainState(params, adamw.init(opt_cfg, params))
    comp_state = init_state(comp_cfg, params)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if mgr and resume and mgr.latest_step() is not None:
        state = mgr.restore(None, state)
        start_step = mgr.latest_step()
        if verbose:
            print(f"resumed from step {start_step}")

    data = SyntheticTokens(TokenTaskConfig(vocab=cfg.vocab, seq_len=seq,
                                           seed=seed))
    step_fn = make_compressed_train_step(cfg, opt_cfg, comp_cfg)

    losses = []
    t0 = time.time()
    for i, (toks, labels) in enumerate(data.epoch(batch, steps,
                                                  start=start_step)):
        bd = {"tokens": torch.from_numpy(toks).to(dev),
              "labels": torch.from_numpy(labels).to(dev)}
        if cfg.embed_inputs:
            bd["embeds"] = embed_batch(cfg, batch, seq, seed,
                                       start_step + i, dev)
        state, comp_state, metrics = step_fn(state, comp_state, bd)
        losses.append(metrics["loss"])
        gstep = start_step + i + 1
        if verbose and (gstep % log_every == 0 or i == 0):
            print(f"step {gstep}: loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"({(time.time()-t0)/max(i+1,1)*1e3:.0f} ms/step)")
        if mgr and gstep % ckpt_every == 0:
            mgr.save(gstep, state, blocking=False)
    if mgr:
        mgr.wait()
        if not (steps and (start_step + steps) % ckpt_every == 0):
            mgr.save(start_step + steps, state)   # else the loop's last save
    losses = [float(v) for v in torch.stack(losses).cpu()] if losses else []
    return state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--full", dest="tiny", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compression", choices=["none", "topk", "int8"],
                    default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None)
    args = ap.parse_args()
    _, losses = run(args.arch, tiny=args.tiny, steps=args.steps,
                    batch=args.batch, seq=args.seq, lr=args.lr,
                    ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                    resume=args.resume, compression=args.compression,
                    seed=args.seed, device=args.device)
    print(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
