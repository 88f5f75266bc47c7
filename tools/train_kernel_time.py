"""Device time of the two training kernels, ``flash_attention_bwd`` and
``rmsnorm_bwd``, at the dense LM's training shapes, for whichever
``repro_torch`` is first on ``PYTHONPATH``, so that two checkouts can be
compared on one card in one run (A, B, B, A):

    PYTHONPATH=<checkout>/src python3 tools/train_kernel_time.py --label B

``flash_attention_bwd`` at llama3.2-1b's (B, KV, G, S, D) = (4, 8, 4, 512,
64), its students' (4, 8, 2, 512, 64) and a D 128 shape (4, 8, 4, 512,
128), bf16, causal, q and dO as the model's strided views: the route the
plan takes, its device ms (the mean of back-to-back calls under CUDA
events, ``time_callable``), that of the CUDA-core route (``--cores``),
SDPA's autograd backward and the bound; the result held to the plain
version (3e-2) and a rerun bit-equal. ``rmsnorm_bwd`` at (2048, 2048) bf16
the same beside ``F.rms_norm``'s autograd backward, and a profile giving
each of its launches' device time apart. With ``--sweep``, every shape of
``FLASH_BWD_SWEEP`` (read from ``chip_smoke.py`` beside this tool, phase
19's sweep) first, both dtypes, causal or not, strided or not, against the
plain version. Prints the card's name and power limit, a line per
measurement, then one JSON line. ``share_of_tol`` is the error as a share
of the tolerance (at most 1 within it).
"""
from __future__ import annotations

import argparse
import ast
import json
import re
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.launch.microbench import time_callable
from repro_torch.launch.roofline import H100_SXM

HBM = H100_SXM.hbm_bw               # bytes/s
BF16_OPS = H100_SXM.peak_flops      # bf16 tensor cores, dense
TOL = {torch.float32: 3e-5, torch.bfloat16: 3e-2}
FLASH_SHAPES = {"llama3.2-1b": (4, 8, 4, 512, 64),
                "student": (4, 8, 2, 512, 64),
                "d128": (4, 8, 4, 512, 128)}
NORM_SHAPE = (2048, 2048)


def phase19_sweep() -> tuple:
    """``FLASH_BWD_SWEEP`` of ``chip_smoke.py``, read from its source:
    importing the script would put its own tree first on the path."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign) and
                [getattr(t, "id", None) for t in node.targets]
                == ["FLASH_BWD_SWEEP"]):
            return ast.literal_eval(node.value)
    raise LookupError(f"no FLASH_BWD_SWEEP in {path}")


def flash_operands(B, KV, G, Sq, Skv, D, dtype, strided, gen):
    """q and dO as views of (B, S, KV, G, D) memory and k, v of (B, S, KV,
    D), as the model hands them to the backward (or contiguous copies)."""
    dev = "cuda"
    qm = torch.randn((B, Sq, KV, G, D), generator=gen, device=dev).to(dtype)
    km = torch.randn((B, Skv, KV, D), generator=gen, device=dev).to(dtype)
    vm = torch.randn((B, Skv, KV, D), generator=gen, device=dev).to(dtype)
    dm = torch.randn((B, Sq, KV, G, D), generator=gen, device=dev).to(dtype)
    ts = (qm.permute(0, 2, 3, 1, 4), km.permute(0, 2, 1, 3),
          vm.permute(0, 2, 1, 3), dm.permute(0, 2, 3, 1, 4))
    return ts if strided else tuple(t.contiguous() for t in ts)


def route_of(dtype, D) -> str:
    """The backward's route; a tree from before the tensor route had only
    the CUDA-core kernels."""
    if not hasattr(FA, "bwd_route"):
        return "cuda_cores"
    return FA.bwd_route(dtype, D)


def share_of_tol(got, want, tol: float) -> float:
    """The largest |got - want| / (tol + tol |want|) over the outputs: at
    most 1 within the bound."""
    return max(float(((a.float() - b.float()).abs()
                      / (tol + tol * b.float().abs())).max())
               for a, b in zip(got, want))


def same_twice(fn) -> tuple:
    a, b = fn(), fn()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("a rerun gave other bits")
    return a


def backward_only(fwd, inputs, grad_out):
    """A callable running only the autograd backward of ``fwd(*inputs)``."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fwd(*leaves)
    return lambda: torch.autograd.grad(out, leaves, grad_out,
                                       retain_graph=True)


def device_ms(fn, repeats: int) -> float:
    return time_callable(fn, repeats=repeats, warmup=3) * 1e3


def launch_profile(fn, calls: int = 50) -> dict:
    """Device ms per call of each kernel ``fn`` launches, apart, from a
    profile of ``calls`` calls."""
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


def sweep() -> int:
    gen = torch.Generator(device="cuda").manual_seed(19)
    cases, copies = 0, ops.flash_attention_bwd.copies
    for dtype in (torch.float32, torch.bfloat16):
        for B, KV, G, Sq, Skv, D in phase19_sweep():
            worst = 0.0
            for causal in (True, False):
                for strided in (False, True):
                    q, k, v, do = flash_operands(B, KV, G, Sq, Skv, D, dtype,
                                                 strided, gen)
                    o = ops.flash_attention_ref(q, k, v, causal=causal)
                    got = same_twice(lambda: ops.flash_attention_bwd(
                        q, k, v, o, do, causal=causal))
                    torch.cuda.synchronize()
                    share = share_of_tol(got, ops.flash_attention_bwd_ref(
                        q, k, v, o, do, causal), TOL[dtype])
                    if not share <= 1.0:
                        raise AssertionError(
                            f"{dtype} {(B, KV, G, Sq, Skv, D)} causal="
                            f"{causal} strided={strided}: {share:.3f} of "
                            f"the tolerance off the plain version")
                    worst = max(worst, share)
                    cases += 1
            route = route_of(dtype, D)
            print(f"sweep {str(dtype)[6:]} {(B, KV, G, Sq, Skv, D)} "
                  f"{route}: worst {worst:.3f} of the tolerance")
    if ops.flash_attention_bwd.copies != copies:
        raise AssertionError("flash_attention_bwd copied an operand")
    return cases


def flash_times(name, shape, repeats, cores, gen) -> dict:
    B, KV, G, S, D = shape
    bf = torch.bfloat16
    q, k, v, do = flash_operands(B, KV, G, S, S, D, bf, True, gen)
    o = ops.flash_attention(q, k, v, causal=True)
    got = same_twice(lambda: ops.flash_attention_bwd(q, k, v, o, do))
    share = share_of_tol(got, ops.flash_attention_bwd_ref(
        q, k, v, o, do, True), TOL[bf])
    if not share <= 1.0:
        raise AssertionError(f"{name}: {share:.3f} of the tolerance")
    pairs = sum(min(i + 1, S) for i in range(S))
    nbytes = (4 * B * KV * G * S * D + 4 * B * KV * S * D) * 2
    flops = 10 * D * B * KV * G * pairs
    sdpa = backward_only(
        lambda a, b_, c: torch.nn.functional.scaled_dot_product_attention(
            a, b_, c, is_causal=True, enable_gqa=G > 1),
        (q.reshape(B, KV * G, S, D), k.contiguous(), v.contiguous()),
        do.reshape(B, KV * G, S, D))
    t = dict(shape=list(shape), route=route_of(bf, D),
             share_of_tol=share,
             ms=device_ms(lambda: ops.flash_attention_bwd(q, k, v, o, do),
                          repeats),
             sdpa_ms=device_ms(sdpa, repeats),
             bound_ms=max(nbytes / HBM, flops / BF16_OPS) * 1e3)
    t["launches_ms"] = launch_profile(
        lambda: ops.flash_attention_bwd(q, k, v, o, do))
    if cores and hasattr(FA, "_bwd"):
        t["cuda_cores_ms"] = device_ms(lambda: FA._bwd(
            q, k, v, o, do, True, cuda_cores=True), max(3, repeats // 10))
    print(f"flash_attention_bwd {name} {shape}: " + ", ".join(
        f"{k_} {v_:.5f}" if isinstance(v_, float) else f"{k_} {v_}"
        for k_, v_ in t.items() if k_ != "shape"))
    return t


def norm_times(repeats, gen) -> dict:
    rows, D = NORM_SHAPE
    bf = torch.bfloat16
    x = torch.randn((rows, D), generator=gen, device="cuda").to(bf)
    sc = (1 + 0.1 * torch.randn((D,), generator=gen, device="cuda")).to(bf)
    g = torch.randn((rows, D), generator=gen, device="cuda").to(bf)
    got = same_twice(lambda: ops.rmsnorm_bwd(x, sc, g))
    dx, ds = ops.rmsnorm_bwd_ref(x.double(), sc.double(), g.double())
    share = share_of_tol(got, (dx.to(bf), ds.to(bf)), TOL[bf])
    if not share <= 1.0:
        raise AssertionError(f"rmsnorm_bwd: {share:.3f} of the tolerance")
    lib = backward_only(
        lambda a, s: torch.nn.functional.rms_norm(a, (D,), s, 1e-6), (x, sc),
        g)
    t = dict(shape=[rows, D], share_of_tol=share,
             ms=device_ms(lambda: ops.rmsnorm_bwd(x, sc, g), repeats),
             library_ms=device_ms(lib, repeats),
             bound_ms=(3 * rows * D * 2 + 2 * D * 2) / HBM * 1e3)
    t["launches_ms"] = launch_profile(lambda: ops.rmsnorm_bwd(x, sc, g))
    print(f"rmsnorm_bwd {NORM_SHAPE}: " + ", ".join(
        f"{k_} {v_}" for k_, v_ in t.items() if k_ != "shape"))
    return t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--repeats", type=int, default=100)
    ap.add_argument("--cores", action="store_true",
                    help="also time the CUDA-core route of the flash shapes")
    ap.add_argument("--sweep", action="store_true",
                    help="first hold the phase-19 sweep to the plain version")
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
    out["flash_attention_bwd"] = {
        name: flash_times(name, shape, args.repeats, args.cores, gen)
        for name, shape in FLASH_SHAPES.items()}
    out["rmsnorm_bwd"] = norm_times(args.repeats, gen)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
