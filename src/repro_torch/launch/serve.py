"""Serving entry point: prefill + greedy decode loop for any ``--arch``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --prompt-len 64 --gen 32 --batch 2

The JAX package's ``launch/serve.py`` on one card. :func:`generate` draws
random weights and a random prompt from ``seed`` on the device (the card
unless ``device="cpu"``), then :func:`greedy_decode` runs the reference
loop's steps: prefill, splice the prompt's cache into a ``prompt_len +
gen`` cache (:func:`splice`), take the argmax of the last logits, then
``gen - 1`` decode steps at ``index = prompt_len + t``. The decode steps
update the cache in place (the reference donates it). As the reference
does, :func:`generate` gives an ``embed_inputs`` config a prompt of
random embeddings (N(0, 1) × 0.02): the VLM's patch embeddings, which
replace its prompt's tokens, and the enc-dec's encoder frames, beside its
decoder prompt; an M-RoPE config gets (3, B, P) positions, the three
streams equal. Decode steps embed the generated tokens.

The CLI keeps the reference's flags as they are, so ``--tiny`` (a
``store_true`` flag whose default is True) is always on; call
``generate(..., tiny=False)`` for the published widths.

On a ``DeviceMesh`` (``greedy_decode(..., mesh=mesh)``) the loop runs
the mesh's prefill and serve steps (``launch.steps.mesh_step``): with
``model`` > 1 every LM family tensor-parallel, on params cut by
``parallel.tensor.shard_params(..., kind="decode")``, and the argmax taken
across the vocabulary shards (:func:`repro_torch.parallel.tensor.argmax`).

One difference from the reference: an enc-dec's cross cache holds exactly
the encoder's rows (``api.init_cache(..., enc_len=...)``). The reference
zero-pads it to ``prompt_len + gen`` rows and attends to the padding at
every decode step (``models/encdec.py`` says more). Its encoder also
reads ``prompt_len`` frames; :func:`generate` takes ``frames`` for another
length (Whisper's 30-second window is 1500 frames).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.compat import Shard, axis_names, local, mesh_shape
from repro_torch.configs.archs import tiny_version
from repro_torch.configs.base import ModelConfig, ShapeConfig, get_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import steps as ST
from repro_torch.models import api
from repro_torch.parallel import tensor as TP


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


def _mesh_tokens(logits, mesh) -> torch.Tensor:
    """The greedy tokens (B, 1) of a mesh step's last-position logits (a
    DTensor): the argmax across the vocabulary shards where ``model``
    shards it, then every data rank's rows gathered (the next step takes
    the global batch)."""
    names = axis_names(mesh)
    loc = local(logits)[:, -1:]
    tok = loc.argmax(-1)
    if "model" in names and isinstance(
            logits.placements[names.index("model")], Shard):
        m = mesh_shape(mesh)["model"]
        tok = TP.argmax(loc, mesh.get_group("model"), m,
                        mesh.get_local_rank("model") * loc.shape[-1])
    for a in ("data", "pod"):                       # inner axis first
        if mesh_shape(mesh).get(a, 1) > 1:
            tok = TP.all_gather(tok, mesh.get_group(a),
                                mesh_shape(mesh)[a]).flatten(0, 1)
    return tok


@torch.no_grad()
def greedy_decode(params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
                  gen: int, *, embeds: Optional[torch.Tensor] = None,
                  positions: Optional[torch.Tensor] = None,
                  keep_logits: bool = False, mesh=None,
                  forced: Optional[torch.Tensor] = None) -> Generation:
    """Prefill a prompt, then ``gen - 1`` greedy decode steps, on the
    prompt's device, under ``torch.no_grad()`` (params that need a
    gradient serve too). The prompt is ``tokens`` (B, P), or ``embeds``
    (B, P, d) where they replace the tokens (the VLM); the enc-dec takes
    both, its encoder frames ``embeds`` (B, S_enc, d) of any length
    beside the decoder prompt ``tokens``. ``positions`` go to the prefill
    only. Returns ``gen`` tokens per row.

    With ``mesh`` the steps are the mesh's (``launch.steps.mesh_step``;
    ``params`` as they take them, the prompt global, the same on every
    rank) and a kept logit row is this rank's block (its batch rows, its
    vocabulary columns). An enc-dec's frames size its cross cache on the
    mesh as off it; a VLM's ``positions`` reach the prefill, each rank
    taking its batch rows of the three streams. Its cache holds the
    ``P + gen - 1`` positions the steps write (the reference's loop
    allocates one more, which no step reads), so that a sequence-sharded
    cache splits evenly at the usual lengths (512 + 32 over 2, 4, 8
    ranks). ``forced`` (B, gen) feeds its tokens to the decode steps in
    place of the argmax (teacher forcing); the returned tokens are still
    each step's argmax."""
    lead = tokens if tokens is not None else embeds
    dev = lead.device
    B, P = lead.shape[:2]
    batch = {k: v for k, v in (("tokens", tokens), ("embeds", embeds),
                               ("positions", positions)) if v is not None}
    enc_len = embeds.shape[1] if cfg.family == "encdec" else None
    if mesh is None:
        cache = api.init_cache(cfg, B, P + gen, enc_len=enc_len, device=dev)

        def prefill():
            logits, pcache = api.prefill(params, cfg, batch)
            for name, c in cache.items():
                splice(c, pcache[name])
            return logits, cache

        def serve(cache, cur, index):
            return api.decode_step(params, cfg, {"tokens": cur}, cache,
                                   index)[0]

        def pick(logits):
            return logits[:, -1:].argmax(-1)

        def row(logits):
            return logits[:, -1]
    else:
        n = P + max(gen - 1, 0)           # the positions the steps write
        pstep = ST.mesh_step(cfg, ShapeConfig("prefill", P, B, "prefill"),
                             mesh, cache_len=n)
        sstep = ST.mesh_step(cfg, ShapeConfig("decode", n, B, "decode"),
                             mesh, enc_len=enc_len)

        def prefill():
            return pstep(params, batch)

        def serve(cache, cur, index):
            return sstep(params, cache, {"tokens": cur}, index)[0]

        def pick(logits):
            return _mesh_tokens(logits, mesh)

        def row(logits):
            return local(logits)[:, -1]
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill()
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    cur = pick(logits)
    out, kept = [cur], [row(logits)]
    t0 = time.perf_counter()
    for t in range(gen - 1):
        feed = cur if forced is None else forced[:, t:t + 1]
        logits = serve(cache, feed, P + t)
        cur = pick(logits)
        out.append(cur)
        if keep_logits:
            kept.append(row(logits))
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return Generation(torch.cat(out, dim=1).cpu().numpy(),
                      kept if keep_logits else None, t_prefill * 1e3,
                      t_decode * 1e3 / max(gen - 1, 1))


def random_prompt(cfg: ModelConfig, batch: int, prompt_len: int,
                  gen: torch.Generator, *, frames: Optional[int] = None
                  ) -> dict:
    """:func:`generate`'s prompt, drawn from ``gen`` on its device: tokens
    (B, P); for an ``embed_inputs`` config embeddings N(0, 1) × 0.02 in
    ``compute_dtype``, the VLM's (B, P, d) patch embeddings or the
    enc-dec's (B, frames, d) encoder frames (``frames`` defaults to P);
    for M-RoPE (3, B, P) positions, the three streams equal."""
    dev = gen.device
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt_len),
                                   generator=gen, device=dev)}
    if cfg.embed_inputs:
        n = frames if frames is not None and cfg.family == "encdec" \
            else prompt_len
        out["embeds"] = (torch.randn((batch, n, cfg.d_model), generator=gen,
                                     device=dev) * 0.02).to(cfg.compute_dtype)
    if cfg.pos == "mrope":
        out["positions"] = torch.arange(prompt_len, dtype=torch.int32,
                                        device=dev).expand(3, batch,
                                                           prompt_len)
    return out


def generate(arch: str, *, tiny: bool = True, prompt_len: int = 64,
             gen: int = 32, batch: int = 2, seed: int = 0, verbose=True,
             device: DeviceLike = None, keep_logits: bool = False,
             frames: Optional[int] = None) -> Generation:
    """Random weights and prompt (:func:`random_prompt`) from ``seed`` on
    ``device`` (the card unless told otherwise), then
    :func:`greedy_decode`. ``frames`` is the enc-dec's encoder length
    (``prompt_len`` when not given)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if tiny:
        cfg = tiny_version(cfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = api.init(g, cfg)
    prompt = random_prompt(cfg, batch, prompt_len, g, frames=frames)
    res = greedy_decode(params, cfg, prompt["tokens"], gen,
                        embeds=prompt.get("embeds"),
                        positions=prompt.get("positions"),
                        keep_logits=keep_logits)
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
