"""How the scan's rounding reaches jamba-v0.1-52b's MoE routes on the card.

    PYTHONPATH=src python3 tools/ssd_routes.py

One period of jamba-v0.1-52b (8 layers) at full width in bf16, with the
weights and the prompt that ``chip_smoke.py`` phase 15 draws (seed 0,
batch 4, prompt 512), prefilled with the SSM scan taken three ways: the
tensor-core kernel (serving's path), the CUDA-core kernel on the same bf16
operands, and the plain version. Against the plain version each kernel
gives, per batch row, max |logit difference| at the last position over
the row's largest |logit|, and the router rows (token x MoE layer) whose
chosen experts differ. Then, per way, phase 15's decode step against a
prefill of the same tokens (255 + 1 against 256 tokens, capacity factor
E/k), relative to each row's largest |logit|. Prints the card's name and
power limit, the readings, then one JSON line.
"""
from __future__ import annotations

import contextlib
import json
import subprocess

import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as SS
from repro_torch.launch.serve import splice
from repro_torch.models import api

ARCH, BATCH, PROMPT = "jamba-v0.1-52b", 4, 512


@contextlib.contextmanager
def scan_way(way: str):
    """``ops.ssd_scan`` as the tensor-core kernel ("tensor"), the CUDA-core
    kernel ("cuda_core") or the plain version ("plain")."""
    scan, takes = ops.ssd_scan, SS.mma_takes
    if way == "cuda_core":
        SS.mma_takes = lambda P, N: False
    elif way == "plain":
        ops.ssd_scan = ops.ssd_scan_ref
    try:
        yield
    finally:
        ops.ssd_scan, SS.mma_takes = scan, takes


@contextlib.contextmanager
def recorded_routes():
    """The experts each ``topk_gating`` call picks, sorted per row."""
    routes, gate = [], ops.topk_gating

    def recorded(logits, k):
        w, i = gate(logits, k)
        routes.append(i.sort(-1).values.cpu())
        return w, i
    ops.topk_gating = recorded
    try:
        yield routes
    finally:
        ops.topk_gating = gate


def step_vs_prefill(params, cfg, toks) -> list:
    """Per batch row, a decode step after a prefill of ``toks`` against a
    prefill of the same tokens and the step's, over the row's largest
    |logit| (``chip_smoke.py``'s check)."""
    B, P = toks.shape
    cache = api.init_cache(cfg, B, P + 1, device=toks.device)
    logits, pcache = api.prefill(params, cfg, {"tokens": toks})
    for name, c in cache.items():
        splice(c, pcache[name])
    nxt = logits[:, -1:].argmax(-1)
    step, _ = api.decode_step(params, cfg, {"tokens": nxt}, cache, P)
    full, _ = api.prefill(params, cfg, {"tokens": torch.cat([toks, nxt], 1)})
    a, b = step[:, -1].float(), full[:, -1].float()
    return ((a - b).abs().amax(-1) / b.abs().amax(-1)).tolist()


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    cfg = get_config(ARCH).with_(n_layers=8)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = api.init(g, cfg)
    toks = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=g,
                         device="cuda")
    ways = ("tensor", "cuda_core", "plain")
    last, routes = {}, {}
    with torch.no_grad():
        for way in ways:
            with scan_way(way), recorded_routes() as r:
                logits, _ = api.prefill(params, cfg, {"tokens": toks})
            last[way], routes[way] = logits[:, -1].float(), r
        out = {}
        ref = last["plain"]
        scale = ref.abs().amax(-1)
        for way in ways[:2]:
            rel = ((last[way] - ref).abs().amax(-1) / scale).tolist()
            differ = [0] * BATCH
            for a, b in zip(routes[way], routes["plain"]):
                rows = (a != b).any(-1).reshape(BATCH, -1).sum(-1)
                differ = [d + int(n) for d, n in zip(differ, rows)]
            out[way] = dict(rel_logit_diff=rel, router_rows_differing=differ)
            print(f"{way} kernel vs plain, prefill {PROMPT} x batch {BATCH}: "
                  f"per batch row max |logit diff| / largest |logit| "
                  f"{[round(v, 4) for v in rel]}; router rows differing "
                  f"{differ} of {PROMPT * len(routes[way])} each")
        ccfg = cfg.with_(capacity_factor=cfg.n_experts / cfg.top_k)
        for way in ways:
            with scan_way(way):
                rel = step_vs_prefill(params, ccfg, toks[:, :PROMPT // 2 - 1])
            out.setdefault(way, {})["step_vs_prefill"] = rel
            print(f"{way}: decode step at {PROMPT // 2 - 1} vs prefill of "
                  f"the same {PROMPT // 2} tokens, per batch row "
                  f"{[round(v, 4) for v in rel]} of the row's largest "
                  f"|logit|")
    print(json.dumps(dict(card=card, **out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
