"""Wall time of the LM decode step and the host cost of one
``decode_attention`` call on the card, for whichever ``repro_torch`` is
first on ``PYTHONPATH``, so that two checkouts can be compared on one card
in one run (A, B, B, A):

    PYTHONPATH=<checkout>/src python3 tools/lm_decode_wall.py --label B

Serves llama3.2-1b at full width in bf16 (random weights and prompt from
seed 0, batch 4, prompt 512, 32 tokens) through ``generate`` once to build
and warm up, then through ``greedy_decode`` ``--runs`` times on the same
weights, and times ``decode_attention`` at the serving shape (cache 544,
length 528): host µs per call over ``--blocks`` loops of ``--calls`` calls
with no sync inside (the card keeps up with them), the least and the
median block, and ms per call back to back under CUDA events. The host's
clock swings with other work on the machine's cores, so the least block
and the least run are the steadiest numbers. Prints the card's name and
power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels import ops
from repro_torch.launch.serve import generate, greedy_decode
from repro_torch.models import api

ARCH, BATCH, PROMPT, GEN, LENGTH = "llama3.2-1b", 4, 512, 32, 528


def wrapper_times(blocks: int, calls: int) -> tuple:
    """(host µs per call of each block, ms per call back to back) of
    decode_attention at llama3.2-1b's serving shape, its operands as the
    model has them."""
    cfg = get_config(ARCH)
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    G, S = cfg.n_heads // KV, PROMPT + GEN
    g = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16
    q = torch.randn((BATCH, 1, KV * G, hd), generator=g, device="cuda").to(bf)
    kc = torch.randn((BATCH, S, KV, hd), generator=g, device="cuda").to(bf)
    vc = torch.randn((BATCH, S, KV, hd), generator=g, device="cuda").to(bf)
    q, kc, vc = q.view(BATCH, KV, G, hd), kc.permute(0, 2, 1, 3), \
        vc.permute(0, 2, 1, 3)
    for _ in range(20):
        ops.decode_attention(q, kc, vc, LENGTH)
    host_us = []
    for _ in range(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            ops.decode_attention(q, kc, vc, LENGTH)
        host_us.append((time.perf_counter() - t0) * 1e6 / calls)
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        ops.decode_attention(q, kc, vc, LENGTH)
    end.record()
    torch.cuda.synchronize()
    return host_us, start.elapsed_time(end) / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--blocks", type=int, default=10)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cfg = get_config(ARCH)
    generate(ARCH, tiny=False, prompt_len=PROMPT, gen=GEN, batch=BATCH,
             seed=0, device="cuda", verbose=False)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = api.init(g, cfg)
    toks = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=g,
                         device="cuda")
    runs = [greedy_decode(params, cfg, toks, GEN) for _ in range(args.runs)]
    host_us, ms = wrapper_times(args.blocks, args.calls)
    per_token = [r.decode_ms_per_token for r in runs]
    print(json.dumps(dict(
        label=args.label, arch=ARCH, batch=BATCH, prompt=PROMPT, gen=GEN,
        prefill_ms=[r.prefill_ms for r in runs],
        decode_ms_per_token=per_token,
        decode_ms_per_token_min=min(per_token),
        decode_ms_per_token_median=statistics.median(per_token),
        decode_attention_host_us_min=min(host_us),
        decode_attention_host_us_median=statistics.median(host_us),
        decode_attention_ms_back_to_back=ms)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
