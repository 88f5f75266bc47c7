"""Host and device cost of one ``coded_decode`` and one ``rmsnorm`` call on
the card, for whichever ``repro_torch`` is first on ``PYTHONPATH``, so that
two checkouts can be compared on one card in one run (A, B, B, A):

    PYTHONPATH=<checkout>/src python3 tools/small_kernel_wall.py --label B

Cases, operands drawn from seed 0:

- ``coded_decode`` at the fused output-coded shape (B 256, R 6, K 4, F 64),
  fp32 and int8 shares, and at B = 1; ``recovery`` is the call as the
  serving path makes it, shares taken from an (R, B, F) stack transposed
  (a checkout whose wrapper refuses that view is timed with the copy it
  needs, and the line says so);
- ``rmsnorm`` in bf16 at 2048 rows of D 768, 1536, 2048, 4096 and 8192 (the
  LM prefills' widths) and at the decode shape (4, 2048).

For each: host µs per call over ``--blocks`` loops of ``--calls`` calls
with no sync inside (least and median block), ms per call back to back
under CUDA events, device ms per call (``time_callable``: the calls queued
behind a spin kernel, so the host's launch work is out of the time) on one
input (warm: it stays in the 50 MB L2) and, for ``rmsnorm``, rotating over
inputs that together exceed 100 MB (cold). Beside them, host µs of the
pieces of a launch that a wrapper may or may not pay, whichever checkout
runs: entering ``torch.cuda.device`` on the current device, building the
current ``torch.cuda.Stream``, asking for the current device, and reading
the raw stream handle. Prints the card's name and power limit, then one
JSON line.
"""
from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import time

import torch

from repro_torch.kernels import ops
from repro_torch.launch.microbench import time_callable

COLD_BYTES = 100 * 2 ** 20             # twice the H100's L2
NORM_SHAPES = ((2048, 768), (2048, 1536), (2048, 2048), (2048, 4096),
               (2048, 8192), (4, 2048))


def host_us(fn, blocks: int, calls: int) -> list:
    """Host µs per call of each block of ``calls`` calls, no sync inside."""
    for _ in range(20):
        fn()
    out = []
    for _ in range(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) * 1e6 / calls)
    return out


def per_call_ms(fn, calls: int) -> float:
    """ms per call of ``calls`` back-to-back calls under CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(fn) -> float:
    return time_callable(fn, repeats=200, warmup=3) * 1e3


def decode_cases(g) -> dict:
    """The coded_decode calls, by name."""
    cases = {}
    for B, int8 in ((256, False), (256, True), (1, False)):
        R, K, F = 6, 4, 64
        if int8:
            sh = torch.randint(-127, 128, (B, R, F), generator=g,
                               device="cuda", dtype=torch.int8)
            s = (0.5 + torch.rand((R,), generator=g, device="cuda")) / 127
        else:
            sh = torch.randn((B, R, F), generator=g, device="cuda")
            s = None
        dec = torch.randn((B, K, R), generator=g, device="cuda")
        m = torch.ones((B, R), dtype=torch.int32, device="cuda")
        name = f"coded_decode {'int8' if int8 else 'fp32'} B{B}"
        cases[name] = (lambda sh=sh, dec=dec, m=m, s=s:
                       ops.coded_decode(sh, dec, m, s))
    stack = torch.randn((6, 256, 64), generator=g, device="cuda")
    dec = torch.randn((256, 4, 6), generator=g, device="cuda")
    m = torch.ones((256, 6), dtype=torch.int32, device="cuda")
    try:
        ops.coded_decode(stack.transpose(0, 1), dec, m)
        copies = False
    except ValueError:                 # a wrapper that needs a copy
        copies = True
    if copies:
        cases["recovery (copy)"] = lambda: ops.coded_decode(
            stack.transpose(0, 1).contiguous(), dec, m)
    else:
        cases["recovery"] = lambda: ops.coded_decode(stack.transpose(0, 1),
                                                     dec, m)
    return cases


def norm_cases(g) -> dict:
    """The rmsnorm calls, by name: (warm call, cold call)."""
    cases = {}
    for rows, D in NORM_SHAPES:
        n = max(2, -(-COLD_BYTES // (rows * D * 2)))
        buf = torch.randn((n * rows, D), generator=g, device="cuda").to(
            torch.bfloat16)
        xs = itertools.cycle(buf.view(n, rows, D).unbind(0))
        sc = (1 + 0.1 * torch.randn((D,), generator=g, device="cuda")).to(
            torch.bfloat16)
        x = buf[:rows]
        cases[f"rmsnorm ({rows}, {D})"] = (
            lambda x=x, sc=sc: ops.rmsnorm(x, sc),
            lambda xs=xs, sc=sc: ops.rmsnorm(next(xs), sc))
    return cases


def launch_pieces(blocks: int, calls: int) -> dict:
    """Least host µs per call of each piece of a launch's host work."""
    dev = torch.device("cuda", torch.cuda.current_device())

    def enter_device():
        with torch.cuda.device(dev):
            pass
    pieces = {
        "torch.cuda.device context": enter_device,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "raw stream handle":
            lambda: torch._C._cuda_getCurrentRawStream(dev.index),
    }
    return {name: min(host_us(fn, blocks, calls))
            for name, fn in pieces.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--blocks", type=int, default=30)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, fn in decode_cases(g).items():
        h = host_us(fn, args.blocks, args.calls)
        rows[name] = dict(host_us_min=min(h),
                          host_us_median=statistics.median(h),
                          ms=per_call_ms(fn, args.calls),
                          device_ms=device_ms(fn))
    for name, (warm, cold) in norm_cases(g).items():
        h = host_us(warm, args.blocks, args.calls)
        rows[name] = dict(host_us_min=min(h),
                          host_us_median=statistics.median(h),
                          ms=per_call_ms(warm, args.calls),
                          device_ms=device_ms(warm),
                          cold_device_ms=device_ms(cold))
    print(json.dumps({"label": args.label,
                      "device": torch.cuda.get_device_name(0),
                      "cases": rows,
                      "pieces_us": launch_pieces(args.blocks, args.calls)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
