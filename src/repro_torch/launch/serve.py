"""Serving entry point: prefill + greedy decode loop for an ``--arch`` of
the dense, moe, ssm or hybrid family.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --prompt-len 64 --gen 32 --batch 2

The JAX package's ``launch/serve.py`` on one card. :func:`generate` draws
random weights and a random prompt from ``seed`` on the device (the card
unless ``device="cpu"``), then :func:`greedy_decode` runs the reference
loop's steps: prefill, splice the prompt's cache into a ``prompt_len +
gen`` cache (:func:`splice`), take the argmax of the last logits, then
``gen - 1`` decode steps at ``index = prompt_len + t``. The decode steps
update the cache in place (the reference donates it).

The CLI keeps the reference's flags as they are, so ``--tiny`` (a
``store_true`` flag whose default is True) is always on; call
``generate(..., tiny=False)`` for the published widths. Only token inputs
with RoPE (or no) positions are served: precomputed embeddings and M-RoPE
raise ``NotImplementedError``, as do the vlm and encdec families.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.archs import tiny_version
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api
from repro_torch.models.transformer import NOT_PORTED


@dataclasses.dataclass
class Generation:
    """What a greedy run produced: the tokens (B, gen), each step's
    last-position logits (B, V) when kept, and the timed parts' host-clock
    times (the card synchronised around each)."""
    tokens: np.ndarray
    logits: Optional[List[torch.Tensor]]
    prefill_ms: float
    decode_ms_per_token: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def splice(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy a prefill cache leaf into the zeroed serving cache leaf, as the
    reference's ``splice`` does: whole where the shapes agree, else into
    the leading corner of every axis (the reference zero-pads ``src`` at
    the end of each axis: the KV caches' sequence axis, and a conv window
    of a prompt shorter than it)."""
    dst[tuple(slice(0, n) for n in src.shape)] = src


@torch.no_grad()
def greedy_decode(params, cfg: ModelConfig, tokens: torch.Tensor, gen: int,
                  *, keep_logits: bool = False) -> Generation:
    """Prefill ``tokens`` (B, P), then ``gen - 1`` greedy decode steps, on
    the tokens' device, under ``torch.no_grad()`` (params that need a
    gradient serve too). Returns ``gen`` tokens per row."""
    dev = tokens.device
    B, P = tokens.shape
    cache = api.init_cache(cfg, B, P + gen, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, pcache = api.prefill(params, cfg, {"tokens": tokens})
    for name, c in cache.items():
        splice(c, pcache[name])
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    cur = logits[:, -1:].argmax(-1)
    out, kept = [cur], [logits[:, -1]]
    t0 = time.perf_counter()
    for t in range(gen - 1):
        logits, cache = api.decode_step(params, cfg, {"tokens": cur}, cache,
                                        P + t)
        cur = logits[:, -1:].argmax(-1)
        out.append(cur)
        if keep_logits:
            kept.append(logits[:, -1])
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return Generation(torch.cat(out, dim=1).cpu().numpy(),
                      kept if keep_logits else None, t_prefill * 1e3,
                      t_decode * 1e3 / max(gen - 1, 1))


def generate(arch: str, *, tiny: bool = True, prompt_len: int = 64,
             gen: int = 32, batch: int = 2, seed: int = 0, verbose=True,
             device: DeviceLike = None, keep_logits: bool = False
             ) -> Generation:
    """Random weights and prompt from ``seed`` on ``device`` (the card
    unless told otherwise), then :func:`greedy_decode`."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if tiny:
        cfg = tiny_version(cfg)
    if cfg.embed_inputs or cfg.pos == "mrope":
        raise NotImplementedError(f"{cfg.name}: embedding inputs and M-RoPE "
                                  f"{NOT_PORTED}")
    g = torch.Generator(device=dev).manual_seed(seed)
    params = api.init(g, cfg)
    toks = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                         device=dev)
    res = greedy_decode(params, cfg, toks, gen, keep_logits=keep_logits)
    if verbose:
        print(f"[{cfg.name}] prefill({prompt_len} tok): {res.prefill_ms:.0f} "
              f"ms; decode {gen-1} steps: {res.decode_ms_per_token:.1f} "
              f"ms/tok")
        print("generated:", res.tokens[0][:16], "...")
    return res


def main():
    """The reference's CLI."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    generate(args.arch, tiny=args.tiny, prompt_len=args.prompt_len,
             gen=args.gen, batch=args.batch)


if __name__ == "__main__":
    main()
