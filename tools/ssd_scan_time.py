"""Device time of ``ssd_scan`` at the SSM serving widths over prompt
lengths, for whichever ``repro_torch`` is first on ``PYTHONPATH``, so that
two checkouts can be compared on one card in one run (A, B, B, A):

    PYTHONPATH=<checkout>/src python3 tools/ssd_scan_time.py --label B

At mamba2-130m's widths (24 heads, P 64, N 128, chunk 256) and
jamba-v0.1-52b's (128 heads, P 64, N 16, chunk 256), batch 4 and each of
``--lengths``, the scan takes its operands as the SSM prefill passes them
(bf16 x a strided view of (B, L, H, P), B and C shared by the heads with
stride 0, fp32 dt and A; random, from seed 0) and returns fp32 y and the
final state. Each shape's device time is the mean of back-to-back calls
under CUDA events (``time_callable``), and its output is held to the plain
version within the fp32 bound 2e-3. Prints the card's name and power
limit, a line per shape, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from repro_torch.kernels import ops
from repro_torch.launch.microbench import time_callable

WIDTHS = {"mamba2-130m": (24, 64, 128, 256),
          "jamba-v0.1-52b": (128, 64, 16, 256)}     # H, P, N, chunk
BATCH = 4
TOL = 2e-3


def operands(B, H, L, P, N, gen):
    """The prefill's layout: x (B, H, L, P) over (B, L, H, P) memory, dt
    (B, H, L) over (B, L, H), A expanded over the batch, B and C (B, L, N)
    expanded over the heads; B and C scaled to unit-variance scores."""
    dev = "cuda"
    x = torch.randn((B, L, H, P), generator=gen, device=dev).bfloat16()
    dt = torch.nn.functional.softplus(
        torch.randn((B, L, H), generator=gen, device=dev))
    A = -torch.exp(torch.randn((H,), generator=gen, device=dev))
    Bm, Cm = (torch.randn((B, L, N), generator=gen, device=dev)
              .div(N ** 0.5).bfloat16() for _ in "BC")
    return (x.permute(0, 2, 1, 3), dt.permute(0, 2, 1), A.expand(B, H),
            Bm[:, None].expand(B, H, L, N), Cm[:, None].expand(B, H, L, N))


def share_of_bound(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / (TOL + TOL |ref|): at most 1 within the bound."""
    return float(((out - ref).abs() / (TOL + TOL * ref.abs())).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--lengths", default="512,2048,8192")
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    rows = []
    for arch, (H, P, N, Q) in WIDTHS.items():
        for L in (int(v) for v in args.lengths.split(",")):
            gen = torch.Generator(device="cuda").manual_seed(0)
            ops_ = operands(BATCH, H, L, P, N, gen)
            kw = dict(chunk=Q, return_state=True, out_dtype=torch.float32)
            y, h = ops.ssd_scan(*ops_, **kw)
            ry, rh = ops.ssd_scan_ref(*ops_, **kw)
            share = max(share_of_bound(y, ry), share_of_bound(h, rh))
            del y, h, ry, rh
            torch.cuda.empty_cache()
            ms = time_callable(lambda: ops.ssd_scan(*ops_, **kw),
                               repeats=args.repeats, warmup=3) * 1e3
            if not share <= 1.0:
                raise AssertionError(f"{arch} L {L}: {share:.3f} of the "
                                     f"bound off the plain version")
            rows.append(dict(arch=arch, L=L, chunks=L // Q, device_ms=ms,
                             share_of_bound=share))
            print(f"{args.label}: {arch} widths, B {BATCH}, L {L} ({L // Q} "
                  f"chunks): device {ms:.5f} ms, {share:.3f} of the 2e-3 "
                  f"bound off the plain version")
    print(json.dumps(dict(label=args.label, card=card, rows=rows)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
