"""Wall and device-busy ms of one full-width training step, for whichever
``repro_torch`` is first on ``PYTHONPATH``, so that two checkouts can be
compared on one card in one run (A, B, B, A):

    PYTHONPATH=<checkout>/src python3 tools/train_step_time.py --label B

``--arch`` (default mamba2-130m) uncut, bf16 over the fp32 master and
moments, at batch 4 x 512 (``--batch``, ``--seq``): weights from seed 0,
one batch of the token data, ``launch.steps.make_train_step`` with AdamW.
After ``--warmup`` steps, the mean wall ms of ``--steps`` steps (host
clock, the loss read after the last one), then a ``torch.profiler`` pass
over 3 steps: device-busy ms a step (the union of the kernels'
intervals) and the ``ssd_bwd_`` kernels' ms a step. A step whose busy
share is low is host-bound: its wall moves with the host's load, so only
runs of one call compare. Prints the card's name and power limit, a line
per run, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.data.tokens import SyntheticTokens, TokenTaskConfig
from repro_torch.launch import steps as ST
from repro_torch.models import api
from repro_torch.optim import adamw


def busy_ms(fn, calls: int) -> tuple:
    """(device-busy ms, ``ssd_bwd_`` kernels' ms) per call of ``fn`` from a
    profile of ``calls`` calls."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    busy, end, scan = 0.0, float("-inf"), 0.0
    for e in events:
        start = max(e.time_range.start, end)
        if e.time_range.end > start:
            busy += e.time_range.end - start
        end = max(end, e.time_range.end)
        if "ssd_bwd_" in e.name:
            scan += e.time_range.elapsed_us()
    return busy / 1e3 / calls, scan / 1e3 / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    params = api.init(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = adamw.AdamWConfig(lr=3e-4, total_steps=args.warmup + args.steps
                            + 3, warmup_steps=1)
    box = {"state": ST.TrainState(params, adamw.init(opt, params))}
    toks, labels = next(iter(SyntheticTokens(TokenTaskConfig(
        vocab=cfg.vocab, seq_len=args.seq, seed=0)).epoch(args.batch, 1)))
    batch = {"tokens": torch.from_numpy(toks).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    step = ST.make_train_step(cfg, opt)

    def one():
        box["state"], m = step(box["state"], batch)
        return m
    for _ in range(args.warmup):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        m = one()
    loss = float(m["loss"])
    wall = (time.perf_counter() - t0) * 1e3 / args.steps
    busy, scan = busy_ms(one, 3)
    out = dict(label=args.label, card=card, arch=args.arch,
               shape=[args.batch, args.seq], step_ms=wall, busy_ms=busy,
               ssd_scan_bwd_ms=scan, loss=loss)
    print(f"{args.label}: {args.arch} step {wall:.3f} ms wall, {busy:.3f} "
          f"ms busy ({busy / wall:.1%}), ssd_bwd_ kernels {scan:.3f} ms, "
          f"loss {loss:.4f}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
