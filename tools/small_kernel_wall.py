"""Host and device cost of single calls of the port's small kernels
(``coded_decode``, ``rmsnorm``, ``topk_gating``, ``quorum_aggregate`` and one
``decode_attention``) on the card, for whichever ``repro_torch`` is first on
``PYTHONPATH``, so that two checkouts can be compared on one card in one
run (A, B, B, A):

    PYTHONPATH=<checkout>/src python3 tools/small_kernel_wall.py --label B

Cases, operands drawn from seed 0:

- ``coded_decode`` at the fused output-coded shape (B 256, R 6, K 4, F 64),
  fp32 and int8 shares, and at B = 1; ``recovery`` is the call as the
  serving path makes it, shares taken from an (R, B, F) stack transposed
  (a checkout whose wrapper refuses that view is timed with the copy it
  needs, and the line says so);
- ``rmsnorm`` in bf16 at 2048 rows of D 768, 1536, 2048, 4096 and 8192 (the
  LM prefills' widths) and at the decode shape (4, 2048);
- ``topk_gating`` at moonshot's prefill (2048, 64, 6), jamba's (2048, 16,
  2) and the decode steps' (4, 64, 6) and (4, 16, 2);
- ``quorum_aggregate`` at the serving shape (K 8, B 256, Dk 32, C 10) with
  fp32 and int8 weights, at B = 1 and at the sweep's widest merge (8,
  1000, 640, 100); ``merge view`` is the output-coded path's call, the
  portions a transposed (B, K, Dk) stack (a checkout whose wrapper refuses
  that view is timed with the copy it needs, and the line says so);
- ``decode_attention`` at llama3.2-1b's decode step (B 4, KV 8, G 4, D 64,
  bf16, cache 544, length 528), the caches views of (B, S, KV, D) ones;
- one call each of the other wrappers: ``flash_attention`` at llama3.2-1b's
  prefill (4, 8, 4, 512, 64) bf16, ``ssd_scan`` at mamba2-130m's (4, 512,
  24, 64, 128, chunk 256) bf16 with fp32 y and state;
- ``dequant_matmul`` at bench_roofline's (1024, 64, 256) and (64, 64, 512)
  and at llama3.2-1b's gate projection (2048, 2048, 8192), per-channel
  scales, and ``coded_matmul`` at (5, 3), B 256, D 64, w 43 and at (8, 5),
  B 256, D 1024, w 200 (the gate projection with fewer blocks and calls).

``--only`` keeps the cases whose name holds one of its words, e.g.
``--only dequant_matmul coded_matmul``.

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


def gating_merge_cases(g) -> dict:
    """The topk_gating, quorum_aggregate and decode_attention calls, by
    name."""
    cases = {}
    for N, E, k in ((2048, 64, 6), (2048, 16, 2), (4, 64, 6), (4, 16, 2)):
        x = torch.randn((N, E), generator=g, device="cuda")
        cases[f"topk_gating ({N}, {E}, {k})"] = (
            lambda x=x, k=k: ops.topk_gating(x, k))
    for name, (K, B, Dk, C, int8) in {
            "fp32": (8, 256, 32, 10, False), "int8": (8, 256, 32, 10, True),
            "fp32 B1": (8, 1, 32, 10, False),
            "fp32 widest": (8, 1000, 640, 100, False)}.items():
        p = torch.rand((K, B, Dk), generator=g, device="cuda")
        b = torch.randn((C,), generator=g, device="cuda")
        m = torch.ones((K,), dtype=torch.int32, device="cuda")
        if int8:
            w = torch.randint(-127, 128, (K, Dk, C), generator=g,
                              device="cuda", dtype=torch.int8)
            s = (0.5 + torch.rand((K,), generator=g, device="cuda")) / 127
        else:
            w = torch.randn((K, Dk, C), generator=g, device="cuda")
            s = None
        cases[f"quorum_aggregate {name}"] = (
            lambda p=p, w=w, b=b, m=m, s=s: ops.quorum_aggregate(p, w, b, m,
                                                                 s))
    stack = torch.rand((256, 4, 64), generator=g, device="cuda")
    w = torch.randn((4, 64, 10), generator=g, device="cuda")
    b = torch.randn((10,), generator=g, device="cuda")
    m = torch.ones((4,), dtype=torch.int32, device="cuda")
    try:
        ops.quorum_aggregate(stack.transpose(0, 1), w, b, m)
        cases["quorum_aggregate merge view"] = lambda: ops.quorum_aggregate(
            stack.transpose(0, 1), w, b, m)
    except ValueError:                 # a wrapper that needs a copy
        cases["quorum_aggregate merge view (copy)"] = \
            lambda: ops.quorum_aggregate(stack.transpose(0, 1).contiguous(),
                                         w, b, m)
    B, KV, G, S, D = 4, 8, 4, 544, 64
    q = torch.randn((B, 1, KV * G, D), generator=g, device="cuda").to(
        torch.bfloat16).view(B, KV, G, D)
    kc, vc = (torch.randn((B, S, KV, D), generator=g, device="cuda").to(
        torch.bfloat16).permute(0, 2, 1, 3) for _ in range(2))
    cases["decode_attention (4, 8, 4, 64) length 528"] = \
        lambda: ops.decode_attention(q, kc, vc, 528)
    return cases


def other_cases(g) -> dict:
    """One call of each remaining wrapper, by name."""
    bf = torch.bfloat16
    B, KV, G, S, D = 4, 8, 4, 512, 64
    qm = torch.randn((B, S, KV, G, D), generator=g, device="cuda").to(bf)
    km, vm = (torch.randn((B, S, KV, D), generator=g, device="cuda").to(bf)
              for _ in range(2))
    q, k, v = (qm.permute(0, 2, 3, 1, 4), km.permute(0, 2, 1, 3),
               vm.permute(0, 2, 1, 3))
    H, L, P, N = 24, 512, 64, 128
    x = torch.randn((B, L, H, P), generator=g, device="cuda").to(bf)
    dt = torch.nn.functional.softplus(
        torch.randn((B, L, H), generator=g, device="cuda"))
    A = -torch.exp(torch.randn((H,), generator=g, device="cuda"))
    Bm, Cm = (torch.randn((B, L, N), generator=g, device="cuda")
              .div(N ** 0.5).to(bf) for _ in range(2))
    scan = (x.permute(0, 2, 1, 3), dt.permute(0, 2, 1), A.expand(B, H),
            Bm[:, None].expand(B, H, L, N), Cm[:, None].expand(B, H, L, N))
    return {
        "flash_attention (4, 8, 4, 512, 64)":
            lambda: ops.flash_attention(q, k, v, causal=True),
        "ssd_scan (4, 512, 24, 64, 128, 256)":
            lambda: ops.ssd_scan(*scan, chunk=256, return_state=True,
                                 out_dtype=torch.float32),
    }


def matmul_cases(g) -> dict:
    """The dequant_matmul and coded_matmul calls, by name."""
    cases = {}
    for B, D, N in ((1024, 64, 256), (64, 64, 512), (2048, 2048, 8192)):
        x = torch.randn((B, D), generator=g, device="cuda")
        q = torch.randint(-127, 128, (D, N), generator=g, device="cuda",
                          dtype=torch.int8)
        s = 0.01 + 0.09 * torch.rand((N,), generator=g, device="cuda")
        cases[f"dequant_matmul ({B}, {D}, {N})"] = (
            lambda x=x, q=q, s=s: ops.dequant_matmul(x, q, s))
    for n, k, D, w in ((5, 3, 64, 43), (8, 5, 1024, 200)):
        x = torch.randn((256, D), generator=g, device="cuda")
        sh = torch.randn((n, D, w), generator=g, device="cuda")
        cases[f"coded_matmul ({n}, {k}) B256 D{D} w{w}"] = (
            lambda x=x, sh=sh: ops.coded_matmul(x, sh))
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
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()

    def wanted(name: str) -> bool:
        return args.only is None or any(w in name for w in args.only)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, fn in {**decode_cases(g), **gating_merge_cases(g),
                     **other_cases(g), **matmul_cases(g)}.items():
        if not wanted(name):
            continue
        heavy = "8192" in name                    # milliseconds a call
        blocks, calls = (3, 10) if heavy else (args.blocks, args.calls)
        h = host_us(fn, blocks, calls)
        rows[name] = dict(host_us_min=min(h),
                          host_us_median=statistics.median(h),
                          ms=per_call_ms(fn, calls),
                          device_ms=device_ms(fn))
    for name, (warm, cold) in norm_cases(g).items():
        if not wanted(name):
            continue
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
