"""Microbench → fit: measured device specs from timed forwards.

The paper's Eq. 1a latency model divides declared per-device capacities
(``c_core``, ``r_tran``); a real fleet must be measured. This harness
closes that gap on the host that serves (the card unless the caller asks
for the CPU):

1. **Time** portion forwards across a shape sweep (:func:`measure_op`,
   :func:`portion_forward_samples`) after a warm-up call: on the card the
   mean device time of ``repeats`` back-to-back calls between CUDA events,
   on the CPU the median wall time of ``repeats`` calls.
2. **Count** each op's FLOPs with ``torch.utils.flop_counter``
   (:func:`op_counts`) and take its bytes from the caller's analytic
   estimate.
3. **Fit** ``t ≈ latency_floor + flops/peak_flops + 8·bytes/peak_bw`` by
   non-negative least squares (:func:`repro_torch.core.hwspec
   .fit_device_spec`) into a :class:`~repro_torch.core.hwspec.DeviceSpec`.

The fitted host spec is projected onto a declared heterogeneous fleet with
:func:`~repro_torch.core.hwspec.scaled_fleet_specs` (measured scale ×
declared capacity ratios), and those specs feed ``make_plan_ir(...,
device_specs=...)`` / ``PlanIR.with_measured_latency``, so planning, coding
mode selection and the engine's SLO admission run on measured numbers. The
same timer drives the block-size autotuner
(:mod:`repro_torch.kernels.autotune`).

Run standalone for the host-spec artifact (the JAX CLI's format)::

    PYTHONPATH=src python -m repro_torch.launch.microbench --out microbench.json
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.hwspec import (DeviceSpec, fit_device_spec,
                                     scaled_fleet_specs)
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class BenchSample:
    """One timed op: seconds per call (:func:`time_callable`) plus its
    FLOP/byte footprint."""

    name: str
    shape: Tuple[int, ...]
    flops: float
    xfer_bytes: float
    wall_s: float

    def to_dict(self) -> dict:
        """JSON-friendly record."""
        return {"name": self.name, "shape": list(self.shape),
                "flops": self.flops, "xfer_bytes": self.xfer_bytes,
                "wall_s": self.wall_s}


def _tensors(out) -> List[torch.Tensor]:
    """The tensors in a result (a tensor, or tuples/lists of them)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def _wait(out) -> None:
    """Wait for the devices the result's tensors live on (nothing to wait
    for on the CPU: its ops return finished)."""
    for dev in {t.device for t in _tensors(out) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def _cuda_device(out) -> Optional[torch.device]:
    """The card the result lies on, or ``None`` for a host result."""
    for t in _tensors(out):
        if t.device.type == "cuda":
            return t.device
    return None


# clock cycles per second the spin kernel is sized with: an H100's top
# clock rounded up, so the spin lasts at least as long as it is asked to
_SPIN_HZ = 2e9


def _device_seconds(fn: Callable, args: Sequence, repeats: int,
                    dev: torch.device, host_s: float) -> float:
    """Mean device seconds per call of ``repeats`` back-to-back calls
    between two CUDA events on ``dev``'s current stream. A spin kernel
    ahead of them holds the stream for ``repeats`` times ``host_s`` (one
    waited call's wall time) while the host queues the calls, so the events
    time the card's work and not the host's launch rate."""
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(min(host_s * repeats, 1.0) * _SPIN_HZ))
        start.record()
        for _ in range(repeats):
            fn(*args)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) * 1e-3 / repeats


def time_callable(fn: Callable, *args, repeats: int = 5,
                  warmup: int = 1) -> float:
    """Seconds per call of ``fn(*args)`` after ``warmup`` calls. For a host
    result, the median wall time of ``repeats`` calls. For a result on the
    card, the mean device time of ``repeats`` back-to-back calls
    (:func:`_device_seconds`): a call's wall time there is mostly the host's
    launch work, which no tile changes."""
    for _ in range(max(warmup, 0)):
        _wait(fn(*args))
    repeats = max(repeats, 1)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args)
        _wait(out)
        ts.append(time.perf_counter() - t0)
        dev = _cuda_device(out)
        if dev is not None:
            return _device_seconds(fn, args, repeats, dev, ts[0])
    return float(np.median(ts))


def op_counts(fn: Callable, *args) -> float:
    """FLOPs of one call of ``fn(*args)``: those of its matrix products and
    convolutions as ``torch.utils.flop_counter`` counts them (no elementwise
    FLOPs). It stands where the JAX package's ``hlo_counts`` reads the
    compiled HLO; PyTorch has no byte counter, so :func:`measure_op` takes
    the bytes from its caller."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def measure_op(name: str, fn: Callable, args: Sequence, *,
               flops: Optional[float] = None,
               xfer_bytes: Optional[float] = None,
               repeats: int = 5) -> BenchSample:
    """Time one op as it is (no ``torch.compile``) and attach its counted
    FLOPs (``flops`` where the count is zero) and the caller's
    ``xfer_bytes`` (0 when not given)."""
    wall = time_callable(fn, *args, repeats=repeats)
    hf = op_counts(fn, *args)
    if hf <= 0 and flops is not None:
        hf = float(flops)
    hb = float(xfer_bytes) if xfer_bytes is not None else 0.0
    shape = tuple(int(d) for a in args for d in getattr(a, "shape", ()))
    return BenchSample(name, shape, hf, hb, wall)


def _portion_forward(x: torch.Tensor, trunk: torch.Tensor,
                     head: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x @ trunk) @ head


def portion_forward_samples(*, feat: int = 32, hidden: int = 64,
                            widths: Sequence[int] = (8, 32, 128),
                            batches: Sequence[int] = (16, 64, 256, 1024),
                            seed: int = 0, repeats: int = 5,
                            device: DeviceLike = None) -> List[BenchSample]:
    """Time the demo-server portion forward ``tanh(x @ trunk) @ head`` over
    a (batch × head-width) sweep on ``device`` (the card unless
    ``"cpu"``): the serving hot path's student shape family. The numpy
    draws are the JAX package's, in its order. Returns one sample per
    cell."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def put(shape) -> torch.Tensor:
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(a).to(dev)
    trunk = put((feat, hidden))
    out: List[BenchSample] = []
    for w in widths:
        head = put((hidden, w))
        for b in batches:
            x = put((b, feat))
            flops = 2.0 * b * feat * hidden + 2.0 * b * hidden * w
            nbytes = 4.0 * (b * feat + feat * hidden + hidden * w + b * w
                            + 2 * b * hidden)
            out.append(measure_op(f"portion_b{b}_w{w}", _portion_forward,
                                  (x, trunk, head), flops=flops,
                                  xfer_bytes=nbytes, repeats=repeats))
    return out


def fit_host_spec(samples: Sequence[BenchSample], *,
                  name: str = "host") -> DeviceSpec:
    """Least-squares :class:`DeviceSpec` from a sample sweep."""
    return fit_device_spec(
        np.array([s.flops for s in samples]),
        np.array([s.xfer_bytes for s in samples]),
        np.array([s.wall_s for s in samples]), name=name)


def fleet_specs_from_microbench(devices: Sequence,
                                samples: Optional[Sequence[BenchSample]]
                                = None) -> Tuple[DeviceSpec, ...]:
    """Measured specs for a declared fleet: fit the host, project the
    declared heterogeneity onto the measured scale. Runs a default portion
    -forward sweep on the card when no samples are given."""
    if samples is None:
        samples = portion_forward_samples()
    return scaled_fleet_specs(fit_host_spec(samples), devices)


def samples_to_json(samples: Sequence[BenchSample],
                    spec: DeviceSpec) -> Dict:
    """The microbench artifact: fitted spec + raw samples."""
    return {"spec": spec.to_dict(),
            "samples": [s.to_dict() for s in samples]}


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI: run the default sweep, print + optionally save the fit."""
    import argparse
    import pathlib
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, default=None,
                    help="write the microbench artifact JSON here")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    samples = portion_forward_samples(repeats=args.repeats,
                                      device=args.device)
    spec = fit_host_spec(samples)
    print(f"fitted {spec.name}: peak_flops={spec.peak_flops:.3e} "
          f"peak_bw={spec.peak_bw:.3e} floor={spec.latency_floor*1e6:.1f}us "
          f"({len(samples)} samples)")
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(samples_to_json(samples, spec), indent=1))
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
