"""Device time of ``ssd_scan_bwd`` at mamba2-130m's and jamba's training
shapes, for whichever ``repro_torch`` is first on ``PYTHONPATH``, so that
two checkouts can be compared on one card in one run (A, B, B, A):

    PYTHONPATH=<checkout>/src python3 tools/ssd_bwd_time.py --label B

(B, H, L, P, N, Q) = (4, 24, 512, 64, 128, 256) and (4, 128, 512, 64, 16,
256), bf16 x, B and C as the model's views (B and C (B, L, N) shared by
the heads), dy fp32: the route, the device ms of the kernel (the mean of
back-to-back calls under CUDA events, ``time_callable``), each launch's
device ms from a profile, autograd of the plain forward, the function's
bound (fp32 operations or bytes, as ``chip_smoke.py``'s ``ssd_bwd_bound``)
and, on the tensor route, the route's bound (its bf16 operations,
``ssd_scan.bwd_mma_flops``); the result held to the plain version and a
rerun bit-equal. With ``--sweep``, every shape of ``SCAN_BWD_SWEEP`` (read
from ``chip_smoke.py`` beside this tool, phase 23's sweep) first, fp32 and
bf16, B and C shared, expanded with stride 0 or per head, dh zero or not,
and a chunk of 256 at dt = softplus(0), A = -1, against the plain
version. ``--no-check`` times without holding the result to the plain
version, for a copy of the kernel changed to measure a part of it (a
product taken out: its results are no longer the function's). Prints the
card's name and power limit, a line per measurement, then one JSON
line. ``share_of_tol`` is the largest error over the bound
(at most 1 within it): 2e-3 of each gradient's largest entry, plus one
bf16 step of each value for bf16 gradients.
"""
from __future__ import annotations

import argparse
import ast
import json
import re
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as SS
from repro_torch.launch.microbench import time_callable
from repro_torch.launch.roofline import (H100_SXM, H100_SXM_FP32_FLOPS,
                                         KERNEL_FLOPS)

HBM = H100_SXM.hbm_bw               # bytes/s
BF16_OPS = H100_SXM.peak_flops      # bf16 tensor cores, dense
FP32_OPS = H100_SXM_FP32_FLOPS      # fp32 outside the tensor cores
TOL, BF16_STEP = 2e-3, 2.0 ** -7
SHAPES = {"mamba2-130m": (4, 24, 512, 64, 128, 256),
          "jamba-v0.1-52b": (4, 128, 512, 64, 16, 256)}


def phase23_sweep() -> tuple:
    """``SCAN_BWD_SWEEP`` of ``chip_smoke.py``, read from its source."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign) and
                [getattr(t, "id", None) for t in node.targets]
                == ["SCAN_BWD_SWEEP"]):
            return ast.literal_eval(node.value)
    raise LookupError(f"no SCAN_BWD_SWEEP in {path}")


def route_of(dtype, P, N) -> str:
    """The backward's route; a tree from before the tensor route had only
    the CUDA-core kernels."""
    if not hasattr(SS, "bwd_route"):
        return "cuda_cores"
    return SS.bwd_route(dtype, P, N)


def operands(Bsz, H, L, P, N, dtype, layout, gen, dt_value=None):
    """x a view of (B, L, H, P), dt (B, L, H) softplus of a normal (or
    ``dt_value``), A = -exp(normal) (or -1 with ``dt_value``), B and C of
    (B, L, N) scaled to unit-variance scores: shared (B, L, N), expanded
    over the heads with stride 0, or per head."""
    dev = "cuda"
    x = torch.randn((Bsz, L, H, P), generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((Bsz, L, H), generator=gen, device=dev))
    A = -torch.exp(torch.randn((H,), generator=gen, device=dev))
    if dt_value is not None:
        dt, A = torch.full_like(dt, dt_value), -torch.ones_like(A)
    Bm, Cm = (torch.randn((Bsz, L, N), generator=gen, device=dev)
              .div(N ** 0.5).to(dtype) for _ in "BC")
    args = [x.permute(0, 2, 1, 3), dt.permute(0, 2, 1), A.expand(Bsz, H)]
    if layout == "shared":
        return (*args, Bm, Cm)
    Bh, Ch = (t[:, None].expand(Bsz, H, L, N) for t in (Bm, Cm))
    if layout == "per_head":
        Bh, Ch = ((t.float() + 0.1 * torch.randn(t.shape, generator=gen,
                                                 device=dev)).to(dtype)
                  for t in (Bh, Ch))
    return (*args, Bh, Ch)


def checked(args, dy, dh, Q, label) -> float:
    """The kernel twice (bit-equal) against the plain backward."""
    a = ops.ssd_scan_bwd(*args, dy, dh, chunk=Q)
    b = ops.ssd_scan_bwd(*args, dy, dh, chunk=Q)
    torch.cuda.synchronize()
    if not all(torch.equal(u, v) for u, v in zip(a, b)):
        raise AssertionError(f"{label}: a rerun gave other bits")
    want = ops.ssd_scan_bwd_ref(*args, dy, dh, chunk=Q)
    bf = args[0].dtype == torch.bfloat16
    worst = 0.0
    for name, u, v in zip(("dx", "ddt", "dA", "dB", "dC"), a, want):
        if u.shape != v.shape or u.dtype != v.dtype:
            raise AssertionError(f"{label} {name}: {u.shape}/{u.dtype} vs "
                                 f"{v.shape}/{v.dtype}")
        u, v = u.double(), v.double()
        if not bool(torch.isfinite(u).all()):
            raise AssertionError(f"{label} {name}: not finite")
        step = BF16_STEP if bf and name in ("dx", "dB", "dC") else 0.0
        bound = TOL * float(v.abs().max()) + step * v.abs()
        share = float(((u - v).abs() / bound.clamp_min(1e-30)).max())
        if not share <= 1.0:
            raise AssertionError(f"{label} {name}: {share:.3f} of the bound")
        worst = max(worst, share)
    return worst


def sweep() -> int:
    gen = torch.Generator(device="cuda").manual_seed(23)
    cases = 0
    for B, H, L, P, N, Q in phase23_sweep():
        for dtype in (torch.float32, torch.bfloat16):
            worst = 0.0
            for layout in ("shared", "stride0", "per_head"):
                for with_dh in (False, True):
                    args = operands(B, H, L, P, N, dtype, layout, gen)
                    dy = torch.randn(args[0].shape, generator=gen,
                                     device="cuda")
                    dh = (torch.randn((B, H, P, N), generator=gen,
                                      device="cuda") if with_dh else None)
                    worst = max(worst, checked(
                        args, dy, dh, Q, f"{(B, H, L, P, N, Q)} {dtype} "
                        f"{layout} dh={with_dh}"))
                    cases += 1
            print(f"sweep {(B, H, L, P, N, Q)} {str(dtype)[6:]} "
                  f"{route_of(dtype, P, N)}: worst {worst:.3f} of the bound")
    for P, N in ((64, 128), (64, 16)):               # no positive exponent
        args = operands(1, 4, 512, P, N, torch.bfloat16, "shared", gen,
                        dt_value=0.6931472)
        dy = torch.randn(args[0].shape, generator=gen, device="cuda")
        share = checked(args, dy, None, 256, f"chunk 256 dt=softplus(0) "
                        f"{(P, N)}")
        cases += 1
        print(f"chunk 256 at dt = softplus(0), A = -1, (P, N) = {(P, N)}: "
              f"finite, {share:.3f} of the bound")
    return cases


def fn_bound_ms(args, Q) -> tuple:
    """The function's bound, as ``chip_smoke.py``'s ``ssd_bwd_bound`` at
    bf16 x, B and C shared by the heads: its bytes (each input read once,
    each gradient written once) at the HBM rate, its fp32 operations (the
    roofline's count, ``KERNEL_FLOPS``) at the fp32 rate."""
    x, Bm = args[0], args[3]
    (Bsz, H, L, P), N = x.shape, Bm.shape[-1]
    e, bc = 2, Bsz * L * N
    nbytes = (2 * Bsz * L * H * P * e + 2 * Bsz * L * H * 4 + H * 4
              + Bsz * H * 4 + 4 * bc * e + Bsz * L * H * P * 4)
    flops = KERNEL_FLOPS["ssd_scan_bwd"](args, {"chunk": Q})
    t_bytes, t_ops = nbytes / HBM * 1e3, flops / FP32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launch_profile(fn, calls: int = 20) -> dict:
    """Device ms per call of each kernel ``fn`` launches, apart."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = re.search(r"(\w+)(<|\()", e.key.split("::")[-1])
            key = name.group(1) if name else e.key[:40]
            out[key] = out.get(key, 0.0) + e.device_time_total / calls / 1e3
    return out


def times(name, shape, repeats, gen, check=True) -> dict:
    B, H, L, P, N, Q = shape
    bf = torch.bfloat16
    args = operands(B, H, L, P, N, bf, "shared", gen)
    dy = torch.randn(args[0].shape, generator=gen, device="cuda")
    share = checked(args, dy, None, Q, name) if check else None
    leaves = [t.detach().requires_grad_() for t in args]
    out = SS.ssd_scan_ref(*leaves, chunk=Q, out_dtype=torch.float32)

    def auto():
        return torch.autograd.grad(out, leaves, dy, retain_graph=True)
    route = route_of(bf, P, N)
    bound, by = fn_bound_ms(args, Q)
    t = dict(shape=list(shape), route=route, share_of_tol=share,
             ms=time_callable(lambda: ops.ssd_scan_bwd(*args, dy, chunk=Q),
                              repeats=repeats, warmup=3) * 1e3,
             autograd_ms=time_callable(auto, repeats=max(3, repeats // 4),
                                       warmup=1) * 1e3,
             bound_ms=bound, bound_by=by)
    if route == "mma":
        t["route_bound_ms"] = SS.bwd_mma_flops(B, H, L, P, N, Q) \
            / BF16_OPS * 1e3
    t["launches_ms"] = launch_profile(
        lambda: ops.ssd_scan_bwd(*args, dy, chunk=Q))
    print(f"ssd_scan_bwd {name} {tuple(shape)}: " + ", ".join(
        f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in t.items() if k != "shape"))
    return t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--repeats", type=int, default=40)
    ap.add_argument("--sweep", action="store_true",
                    help="first hold the phase-23 sweep to the plain version")
    ap.add_argument("--no-check", action="store_true",
                    help="time without holding the result to the plain "
                         "version (a kernel changed to measure a part)")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    out = dict(label=args.label, card=card)
    if args.sweep:
        out["sweep_cases"] = sweep()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out["ssd_scan_bwd"] = {name: times(name, shape, args.repeats, gen,
                                       not args.no_check)
                           for name, shape in SHAPES.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
