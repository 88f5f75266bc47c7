#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

The main path is RoCoIn's runtime phase: the continuous-batching
``ServingEngine`` closes micro-batches of CIFAR-10 images and the
``QuorumServer`` serves each one — the K student portion forwards, the
per-row failure mask, and ONE launch of the hand-written CUDA kernel
``quorum_aggregate`` (``src/repro_torch/kernels/csrc/quorum_aggregate.cu``)
that merges the portions into logits. The students are full-width
WRN-16-1s sized to the knowledge partitions that the planner cuts from a
256-filter final conv (WRN-16-4's) for the paper's 8-device fleet; the
weights are random, drawn from a seed.

Phases (each raises on failure, and the script then exits non-zero with no
result line):

1. device: the card's name and power limit, capability (9, 0), TF32 off;
2. build the kernel from the checkout's source (nvcc, sm_90a);
3. kernel vs its plain PyTorch version on the card over a sweep of shapes
   and masks, and timings at the main-path shape;
4. fused serve: the K=8 uniform ensemble through the engine; kernel
   launches == dispatched batches + warm-up calls; every batch's logits vs
   the same server built on the CPU;
5. legacy serve: the K=6 mixed-width ensemble, the per-slot loop;
6. int8: phase 4 with ``quantize="int8"``, also held to the fp32 server
   with the JAX package's int8 bounds.

The last two lines of standard output are the ``kernels`` JSON line and the
``ok`` JSON line. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import planner as PL  # noqa: E402
from repro_torch.core.assignment import StudentArch  # noqa: E402
from repro_torch.core.pipeline import Ensemble  # noqa: E402
from repro_torch.core.simulator import FailureModel, make_fleet  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.runtime.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.runtime.serving import server_from_ensemble  # noqa: E402

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/quorum_aggregate.cu"
TPU_KERNEL = "src/repro/kernels/quorum_aggregate.py:33"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_FLOPS = 67e12              # H100 SXM fp32 outside the tensor cores
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
# GPU (cuDNN, TF32 off) vs CPU (oneDNN) fp32: the same 16 conv layers summed
# in other orders, and cuDNN may pick Winograd or FFT algorithms. On the
# CPU these logits (|x| < 5) sit within 1e-6 of their fp64 values; the
# bound leaves room for the card's algorithms, far below a wrong merge
SERVE_TOL = dict(rtol=1e-3, atol=1e-3)
# int8 vs fp32 deployment: the JAX package's bounds
# (tests/test_fastpath.py::test_int8_masks_failures_like_fp32)
INT8_TOL = dict(rtol=0.1, atol=0.05)
INT8_MIN_AGREEMENT = 0.95
MAIN_SHAPE = dict(K=8, B=256, Dk=32, C=10)
N_REQUESTS = 64                 # per serving phase, Poisson at 200/s
MAX_REQUEST_ROWS = 32           # request sizes uniform in 1..32 images
PROFILE_ROWS, PROFILE_CALLS = 256, 5


# -- the planner benchmarks' fleet definition (benchmarks/common.py) -----------

def paper_students():
    """The three-tier student cost zoo the planner benchmarks share."""
    return [StudentArch("small", 5e6, 0.6e6, 64, 0.15e6),
            StudentArch("mid", 2e7, 1.5e6, 64, 0.4e6),
            StudentArch("big", 5e7, 3.5e6, 64, 1.2e6)]


def affinity_graph(M: int, seed: int = 0) -> np.ndarray:
    """Synthetic filter-affinity graph with the benchmarks' shared spectrum."""
    rng = np.random.default_rng(seed)
    a = np.abs(rng.normal(size=(2 * M, M)))
    A = (a.T @ a) * np.abs(a.mean(0)[:, None] - a.mean(0)[None, :])
    np.fill_diagonal(A, 0)
    return 0.5 * (A + A.T)


# -- helpers -------------------------------------------------------------------

def max_err(out: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float
            ) -> float:
    """Max abs error; raises when any element is outside atol + rtol·|ref|."""
    if out.shape != ref.shape:
        raise AssertionError(f"shape {tuple(out.shape)} != "
                             f"{tuple(ref.shape)}")
    if not torch.isfinite(out).all():
        raise AssertionError("non-finite output")
    diff = (out - ref).abs()
    if (diff > atol + rtol * ref.abs()).any():
        raise AssertionError(f"max abs err {diff.max().item():.3e} outside "
                             f"rtol {rtol} atol {atol}")
    return float(diff.max()) if diff.numel() else 0.0


def cuda_ms(fn, iters: int = 200, warm: int = 20) -> float:
    """Mean device time of one call, from CUDA events around ``iters``."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def qa_operands(K, B, Dk, C, mask, int8, gen, dev):
    """Merge operands shaped like the serving path's: pooled ReLU features
    in [0, 1) and FC slices of scale 1/sqrt(K·Dk)."""
    p = torch.rand((K, B, Dk), generator=gen, device=dev)
    b = torch.randn((C,), generator=gen, device=dev)
    m = torch.as_tensor(mask, dtype=torch.int32, device=dev)
    if int8:
        w = torch.randint(-127, 128, (K, Dk, C), generator=gen, device=dev,
                          dtype=torch.int8)
        s = (0.5 + torch.rand((K,), generator=gen, device=dev)) \
            / (127 * (K * Dk) ** 0.5)
    else:
        w = torch.randn((K, Dk, C), generator=gen, device=dev) \
            / (K * Dk) ** 0.5
        s = None
    return p, w, b, m, s


def qa_bound(K, B, Dk, C, mask, int8) -> tuple:
    """(bound_ms, bound_by) of one merge: the bytes it must move (arrived
    slots' portions and weights, bias, mask, scales, the logits) over the
    HBM rate vs its flops over the fp32 rate."""
    alive = int(np.count_nonzero(mask))
    nbytes = (alive * B * Dk * 4 + alive * Dk * C * (1 if int8 else 4)
              + C * 4 + K * 4 + (K * 4 if int8 else 0) + B * C * 4)
    flops = 2 * alive * B * Dk * C
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- phases ----------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (capability (9, 0)), "
                           f"got {cap}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32: off (cudnn.allow_tf32 = cuda.matmul.allow_tf32 = False); "
          "convolutions and matmuls run in full fp32")
    return line


def phase_build() -> float:
    t0 = time.perf_counter()
    build.load("quorum_aggregate")                  # nvcc, then dlopen
    secs = time.perf_counter() - t0
    print(f"build: {build.library_path('quorum_aggregate').name} "
          f"in {secs:.2f} s")
    return secs


def phase_kernel(dev) -> dict:
    """Kernel vs plain version over the sweep; timings at the main shape."""
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    n_cases = 0
    for int8 in (False, True):
        for K in (6, 8):
            masks = {"ones": np.ones(K, np.int32),
                     "mixed": (np.arange(K) % 3 != 1).astype(np.int32),
                     "zeros": np.zeros(K, np.int32)}
            for Dk in (32, 43, 640):
                for C in (10, 100):
                    errs = []
                    for B in (0, 1, 7, 256, 1000):
                        for mname, mask in masks.items():
                            p, w, b, m, s = qa_operands(K, B, Dk, C, mask,
                                                        int8, gen, dev)
                            out = ops.quorum_aggregate(p, w, b, m, s)
                            ref = ops.quorum_aggregate_ref(p, w, b, m, s)
                            torch.cuda.synchronize()
                            e = max_err(out, ref, **KERNEL_TOL)
                            errs.append(f"B{B}/{mname}:{e:.1e}")
                            worst = max(worst, e)
                            n_cases += 1
                    print(f"kernel {'int8' if int8 else 'fp32'} K={K} "
                          f"Dk={Dk} C={C}: " + " ".join(errs))
    print(f"kernel vs plain: {n_cases} cases within rtol/atol 1e-5, "
          f"max abs err {worst:.3e}")

    K, B, Dk, C = (MAIN_SHAPE[k] for k in ("K", "B", "Dk", "C"))
    mask = np.ones(K, np.int32)
    p, w, b, m, s = qa_operands(K, B, Dk, C, mask, False, gen, dev)
    ms = cuda_ms(lambda: ops.quorum_aggregate(p, w, b, m))
    plain_ms = cuda_ms(lambda: ops.quorum_aggregate_ref(p, w, b, m))
    library_ms = cuda_ms(lambda: torch.einsum("kbd,kdc->bc", p, w) + b)
    bound_ms, bound_by = qa_bound(K, B, Dk, C, mask, False)
    print(f"timing at K={K} B={B} Dk={Dk} C={C} fp32: kernel {ms:.5f} ms, "
          f"plain {plain_ms:.5f} ms, einsum+bias {library_ms:.5f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by})")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def phase_profile(ens: Ensemble, dev) -> None:
    """Where one fused batch's time goes: ``torch.profiler`` over a few
    clean ``serve_batch`` calls of PROFILE_ROWS images (after warm-up). Prints
    wall and device-busy time per batch, the merge kernel's share, and the
    kernels that take the most device time."""
    rows, calls = PROFILE_ROWS, PROFILE_CALLS
    srv = server_from_ensemble(ens, failure=FailureModel(outages=False),
                               device=dev)
    x = torch.randn((rows, 32, 32, 3), device=dev)
    for _ in range(3):
        srv.serve_batch([x])[0].block_until_ready()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            srv.serve_batch([x])[0].block_until_ready()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        print(f"profile: fused batch of {rows}: wall {wall_ms:.3f} ms; "
              f"device time not measured (the profiler saw no kernels)")
        return
    per_name = {}                    # kernel name → ms per batch
    for e in events:
        per_name[e.name] = per_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3 / calls
    # busy = the union of the kernels' intervals on the device timeline
    # (kernels on several streams may overlap, so their sum can exceed it)
    busy_us, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e.time_range.start):
        start = max(e.time_range.start, end)
        if e.time_range.end > start:
            busy_us += e.time_range.end - start
        end = max(end, e.time_range.end)
    busy = busy_us / 1e3 / calls
    total = sum(per_name.values())
    merge = sum(t for k, t in per_name.items() if "quorum_aggregate" in k)
    top = "; ".join(f"{k[:60]} {t:.4f} ms" for k, t in
                    sorted(per_name.items(), key=lambda kv: -kv[1])[:5])
    print(f"profile: fused batch of {rows}: wall {wall_ms:.3f} ms, device "
          f"busy {busy:.3f} ms ({busy / wall_ms:.1%} of wall; kernel times "
          f"sum to {total:.3f} ms over {len(events) // calls} launches), "
          f"merge kernel {merge:.4f} ms; top: {top}")


def ensemble(mem_range=None, seed: int = 0) -> Ensemble:
    """WRN-16-1 students over the planner's cut of a 256-filter final conv
    for the paper's 8-device fleet, random weights from ``seed``."""
    kw = {} if mem_range is None else {"mem_range": mem_range}
    ir = PL.tune_d_th_ir(make_fleet(8, seed=1, **kw), affinity_graph(256),
                         paper_students(), p_th=0.25)
    dims = [int(d) for d in ir.partition.sum(1)]
    gen = torch.Generator().manual_seed(seed)
    students = [cnn.make_student(gen, "wrn-16-1", 10, d) for d in dims]
    fc = {"kernel": torch.randn((sum(dims), 10), generator=gen)
          / sum(dims) ** 0.5,
          "bias": 0.1 * torch.randn((10,), generator=gen)}
    return Ensemble(ir.to_plan(), students, fc, dims, float("nan"), ir=ir)


def record_calls(server) -> list:
    """Wrap ``server.serve_batch`` to keep each call's inputs, failure model,
    a copy of its generator, and results, for replay on another server."""
    calls = []
    serve = server.serve_batch

    def recorded(xs, *, rng=None):
        entry = (list(xs), server.failure, copy.deepcopy(rng))
        out = serve(xs, rng=rng)
        calls.append(entry + (out,))
        return out
    server.serve_batch = recorded
    return calls


def warmup_calls(sizes: np.ndarray, cfg: EngineConfig) -> int:
    """serve_batch calls of ``ServingEngine._warmup``: every power-of-two
    row bucket up to max(sizes)·max_batch, clean and with one slot down."""
    buckets, b = 1, 1
    while b < int(sizes.max()) * cfg.max_batch:
        b <<= 1
        buckets += 1
    return 2 * buckets


def phase_serve(name: str, ens: Ensemble, dev, *, quantize="none",
                fused: bool, seed: int = 0, fp32_twin=None) -> dict:
    """Serve a Poisson trace through the engine on ``dev``; hold every
    batch to the same server built on the CPU (and, for int8, to the fp32
    server on ``dev``). Returns the phase's counts and errors."""
    failure = FailureModel(crash_prob=0.05, outages=True)
    srv = server_from_ensemble(ens, failure=failure, seed=seed,
                               quantize=quantize, device=dev)
    cpu = server_from_ensemble(ens, failure=failure, seed=seed,
                               quantize=quantize, device="cpu")
    if srv.fastpath_active is not fused:
        raise AssertionError(f"{name}: fused path active = "
                             f"{srv.fastpath_active}, expected {fused}")
    calls = record_calls(srv)
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1 / 200.0, N_REQUESTS))
    sizes = rng.integers(1, MAX_REQUEST_ROWS + 1, N_REQUESTS)
    cfg = EngineConfig(max_batch=8, max_wait=0.01, slo=1.0, seed=seed)

    def images(r, rows):
        x = r.standard_normal((rows, 32, 32, 3)).astype(np.float32)
        return torch.from_numpy(x).to(dev)

    engine = ServingEngine(srv, cfg, make_input=images)
    ops.quorum_aggregate.launches = 0           # the main path's window
    t0 = time.perf_counter()
    report = engine.run(times, sizes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.quorum_aggregate.launches

    warm = warmup_calls(sizes, cfg)
    if not (launches == len(calls) == len(report.batches) + warm):
        raise AssertionError(
            f"{name}: {launches} kernel launches for {len(calls)} "
            f"serve_batch calls = {len(report.batches)} batches + {warm} "
            f"warm-up calls")
    summary = report.summary()
    if summary["n"] != N_REQUESTS:
        raise AssertionError(f"{name}: served {summary['n']} of "
                             f"{N_REQUESTS} requests")

    worst = 0.0
    agree, total, worst_int8 = 0, 0, 0.0
    for xs, fm, rng_b, out in calls[warm:]:
        cpu.failure = fm
        ref = cpu.serve_batch([x.cpu() for x in xs],
                              rng=copy.deepcopy(rng_b))
        twin = None
        if fp32_twin is not None:
            fp32_twin.failure = fm
            twin = fp32_twin.serve_batch(xs, rng=copy.deepcopy(rng_b))
        for i, (a, b) in enumerate(zip(out, ref)):
            if not ((a.arrived == b.arrived).all() and a.latency == b.latency
                    and a.degraded == b.degraded):
                raise AssertionError(f"{name}: quorum fields differ from "
                                     f"the CPU server")
            la = torch.from_numpy(a.logits)
            if la.shape != (xs[i].shape[0], 10):
                raise AssertionError(f"{name}: logits {tuple(la.shape)}")
            worst = max(worst, max_err(la, torch.from_numpy(b.logits),
                                       **SERVE_TOL))
            if twin is not None:
                lf = torch.from_numpy(twin[i].logits)
                worst_int8 = max(worst_int8, max_err(la, lf, **INT8_TOL))
                agree += int((la.argmax(-1) == lf.argmax(-1)).sum())
                total += la.shape[0]
    rows = int(sum(b.rows for b in report.batches))
    line = (f"{name}: {summary['n']} requests, {rows} rows in "
            f"{len(report.batches)} batches, degraded share "
            f"{summary['degraded_rate']:.3f}, wall {wall:.3f} s, "
            f"launches {launches} (= {len(report.batches)} batches + {warm} "
            f"warm-up), max abs err vs CPU {worst:.3e}")
    out = dict(launches=launches, max_abs_err=worst)
    if fp32_twin is not None:
        share = agree / total
        if share < INT8_MIN_AGREEMENT:
            raise AssertionError(f"{name}: int8 top-1 agreement {share:.3f}"
                                 f" < {INT8_MIN_AGREEMENT}")
        line += (f", int8 vs fp32: top-1 agreement {share:.4f}, max abs "
                 f"err {worst_int8:.3e}")
    print(line)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = phase_device()
    phase_build()
    timing = phase_kernel(dev)

    uniform = ensemble()
    mixed = ensemble(mem_range=(1e6, 4e6))
    for name, ens in (("fused", uniform), ("legacy", mixed)):
        # a slot the planner gave no student never arrives: every answer
        # of such a plan is degraded
        print(f"plan {name}: K={len(ens.part_dims)}, widths "
              f"{sorted(set(ens.part_dims))}, replicas per slot "
              f"{ens.ir.member.sum(1).tolist()}, slots without a student "
              f"{int((ens.ir.student_of < 0).sum())}")
    phase_profile(uniform, dev)
    phases = [
        phase_serve("fused", uniform, dev, fused=True),
        phase_serve("legacy", mixed, dev, fused=False, seed=1),
        phase_serve("int8", uniform, dev, quantize="int8", fused=True,
                    seed=2, fp32_twin=server_from_ensemble(
                        uniform, seed=2, device=dev)),
    ]
    kernel = dict(name="quorum_aggregate", route="cuda",
                  source=KERNEL_SOURCE, replaces=TPU_KERNEL,
                  launches=sum(p["launches"] for p in phases),
                  max_abs_err=timing["max_abs_err"], ms=timing["ms"],
                  plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
                  bound_by=timing["bound_by"],
                  library_ms=timing["library_ms"])
    print(smi)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
