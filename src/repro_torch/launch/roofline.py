"""Roofline terms of a step, counted on ``meta`` tensors.

compute term    = FLOPs / peak FLOP/s            (per chip)
memory term     = bytes / HBM bandwidth          (per chip)
collective term = modelled wire bytes / link bw  (per chip)

The counterpart of the JAX package's ``launch/roofline.py``. Torch has no
HLO, so :func:`analyze` runs the step itself on ``meta`` tensors (shapes
and dtypes, nothing computed, no device) under :func:`count`, a
``TorchDispatchMode`` that sees every aten op eager PyTorch would launch:

  - FLOPs: the matrix products and convolutions, by the formulas of
    ``torch.utils.flop_counter`` (``FlopCounterMode``'s registry), as the
    reference's ``analyze_hlo`` counts dots and convolutions;
  - bytes: each op's input and output bytes (an expanded input once per
    distinct element), views free: eager PyTorch's HBM traffic, as fusion
    boundaries are XLA's. This is the program's own traffic, not a floor
    of the work: a fused program moves fewer bytes and has a lower bound,
    so a step's share of this bound is not a share of the card's peak
    (that is ``model_flops`` over time × ``peak_flops``);
  - each hand-written kernel is ONE op: its inputs and outputs as bytes,
    and its FLOPs by the count its bound in ``PERF.md`` uses
    (:data:`KERNEL_FLOPS`), not its plain version's intermediates. The
    wrappers run their plain version on ``meta`` tensors through
    ``kernels._layout.plain``, which this mode hooks.

Collectives do not run on ``meta`` tensors, so :func:`analyze` counts
none; the dry run models their wire bytes (:func:`wire_bytes`, the
reference's ring factors). :data:`H100_SXM`
holds the card's peaks, the one copy the port and ``chip_smoke.py`` read.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import conv_flop_count, flop_registry

from repro_torch.core.hwspec import HardwareSpec
from repro_torch.kernels import _layout

# NVIDIA H100 SXM5 80GB at its 700 W limit: datasheet peaks, not measured
# rates. bf16 on the tensor cores, dense (no 2:4 sparsity); HBM3; NVLink 4
# at 450 GB/s each way; no launch floor. fp32 outside the tensor cores.
H100_SXM = HardwareSpec(name="h100-sxm-700w-datasheet", peak_flops=989e12,
                        hbm_bw=3.35e12, link_bw=450e9, latency_floor=0.0)
H100_SXM_FP32_FLOPS = 67e12

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def wire_bytes(kind: str, size: float, group: int) -> float:
    """Per-chip wire bytes of one collective of ``size`` result bytes over
    ``group`` ranks, with the reference's ring factors."""
    frac = (group - 1) / max(group, 1)
    if kind == "all-reduce":
        return 2 * size * frac
    if kind == "all-gather":
        return size * frac
    if kind == "reduce-scatter":
        return size * group * frac
    if kind == "all-to-all":
        return size * frac
    if kind == "collective-permute":
        return size
    raise ValueError(f"unknown collective {kind!r}; one of {_COLLECTIVES}")


# ---------------------------------------------------------------------------
# the hand-written kernels as one op each
# ---------------------------------------------------------------------------

def attention_pairs(Sq: int, Skv: int, causal: bool) -> int:
    """(query, key) pairs a call must score: ``j <= i`` when causal."""
    if not causal:
        return Sq * Skv
    n = min(Sq, Skv)
    return n * (n + 1) // 2 + (Sq - n) * Skv


def _scan_dims(x, Bm, chunk):
    L, P, N = x.shape[-2], x.shape[-1], Bm.shape[-1]
    Q = min(chunk, L)
    return (math.prod(x.shape[:-2]), math.prod(Bm.shape[:-2]), L // Q,
            Q * (Q + 1) // 2, Q, P, N)


def _ssd_flops(a, kw):
    BH, bc, nc, pairs, Q, P, N = _scan_dims(a[0], a[3], kw.get("chunk", 128))
    return nc * (bc * pairs * 2 * N + BH * (pairs * 2 * P + 4 * Q * P * N))


def _ssd_bwd_flops(a, kw):
    BH, bc, nc, pairs, Q, P, N = _scan_dims(a[0], a[3], kw["chunk"])
    return nc * (bc * N * pairs * 6 + BH * (pairs * 4 * P + 10 * Q * P * N))


def _flash_flops(a, kw, per_pair):
    q, k = a[0], a[1]
    causal = kw.get("causal", a[5] if len(a) > 5 else True)
    B, KV, G, Sq, D = q.shape
    return per_pair * D * B * KV * G * attention_pairs(Sq, k.shape[2], causal)


def _decode_flops(a, kw):
    B, KV, G, D = a[0].shape
    return 4 * D * B * KV * G * int(a[3])


# name → FLOPs of one call from its (args, kwargs), the count of the
# kernel's bound in chip_smoke.py / PERF.md
KERNEL_FLOPS: Dict[str, Callable] = {
    "rmsnorm": lambda a, kw: 4 * a[0].numel(),
    "rmsnorm_bwd": lambda a, kw: 10 * a[0].numel(),
    "flash_attention": lambda a, kw: _flash_flops(a, kw, 4),
    "flash_attention_bwd": lambda a, kw: _flash_flops(a, kw, 10),
    "decode_attention": _decode_flops,
    "ssd_scan": _ssd_flops,
    "ssd_scan_bwd": _ssd_bwd_flops,
    "topk_gating": lambda a, kw: a[0].numel() * (4 + a[1]),
    "topk_gating_bwd": lambda a, kw: a[0].numel() * (7 + a[1].shape[1]),
    "quorum_aggregate": lambda a, kw: 2 * a[0].numel() * a[1].shape[-1],
    "coded_decode": lambda a, kw: 2 * a[1].shape[1] * a[0].numel(),
    "dequant_matmul": lambda a, kw: 2 * a[0].numel() * a[1].shape[1],
    "coded_matmul": lambda a, kw: 2 * a[0].numel() * a[1].shape[0]
    * a[1].shape[2],
}


# ---------------------------------------------------------------------------
# the counting mode
# ---------------------------------------------------------------------------

def _conv_backward_flops(grad_out, x, w, _bias, _stride, _padding,
                         _dilation, transposed, _out_pad, _groups,
                         output_mask, *rest) -> int:
    """The forward's FLOPs per gradient asked for: the registry's formula
    drops the groups of the weight gradient (a depthwise conv, the SSM's,
    counts as a dense one there); each gradient of a convolution does the
    forward's multiplies, grouped as it is."""
    fwd = conv_flop_count(list(x.shape), list(w.shape),
                          list(grad_out.shape), transposed)
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """Distinct elements' bytes: an axis of stride 0 is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _ref(t: torch.Tensor):
    return StorageWeakRef(t.untyped_storage())


@dataclasses.dataclass
class Counts:
    """What :func:`count` saw: totals and, per op (an aten overload
    packet or a kernel's name), [calls, FLOPs, bytes]."""
    flops: float = 0.0
    bytes: float = 0.0
    by_op: Dict[str, list] = dataclasses.field(default_factory=dict)

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes


# ops whose output is their input in other memory or another dtype
_COPIES = ("_to_copy", "clone", "copy_", "contiguous")


class _CountMode(TorchDispatchMode):
    """Counts every op below autograd; a kernel (:meth:`kernel`, the
    ``_layout.COUNTER`` hook) as one op whose inner ops are not counted.

    With ``model`` > 1 it models one chip's share of tensor parallelism by
    one rule: an op with FLOPs (a product or a kernel) that reads a
    ``sharded`` tensor (a weight or cache leaf sharded on ``model``), and a
    cast or copy of one (which stays sharded), counts 1/``model`` of its
    FLOPs and bytes. Every other op counts whole, the weight gradients'
    products (which read no weight) among them."""

    def __init__(self, counts: Counts, sharded: Iterable[torch.Tensor] = (),
                 model: int = 1):
        super().__init__()
        self.counts, self.model = counts, model
        self.sharded = set()
        self.keep = []            # marked storages stay alive: no reuse
        for t in sharded:
            self._mark(t)
        self.depth = 0

    def _mark(self, t: torch.Tensor) -> None:
        self.sharded.add(_ref(t))
        self.keep.append(t.untyped_storage())

    def _record(self, name, flops, ins, outs):
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if (self.model > 1 and (flops or name in _COPIES)
                and any(_ref(t) in self.sharded for t in ins)):
            flops, nbytes = flops / self.model, nbytes / self.model
            if name in _COPIES:
                for t in outs:
                    self._mark(t)
        self.counts.add(name, flops, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.depth:
            return out
        name = func._overloadpacket.__name__
        if name.startswith(("empty", "new_empty")) or name in (
                "_local_scalar_dense", "lift_fresh", "detach"):
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        refs = {_ref(t) for t in ins}
        if not func._schema.is_mutable and outs and all(
                _ref(t) in refs for t in outs):
            return out                          # a view: free
        if name == "copy_":
            ins = ins[1:]                       # dst is written, not read
        flops = 0.0
        packet = func._overloadpacket
        if name == "convolution_backward":
            flops = float(_conv_backward_flops(*args))
        elif packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        self._record(name, flops, ins, outs)
        return out

    def kernel(self, name: str, fn: Callable, args, kwargs):
        self.depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self.depth -= 1
        self._record(name, float(KERNEL_FLOPS[name](args, kwargs)),
                     _tensors((args, kwargs)), _tensors(out))
        return out


@contextlib.contextmanager
def count(sharded: Iterable[torch.Tensor] = (), model: int = 1):
    """Count the ops run inside (see :class:`_CountMode`); yields the
    :class:`Counts`."""
    counts = Counts()
    mode = _CountMode(counts, sharded, model)
    prev = _layout.COUNTER
    _layout.COUNTER = mode.kernel
    try:
        with mode:
            yield counts
    finally:
        _layout.COUNTER = prev


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    flops: float                 # per-chip FLOPs (products, kernels)
    bytes_accessed: float        # per-chip modelled HBM bytes
    collective_bytes: float      # per-chip modelled wire bytes
    collective_counts: Dict[str, int]
    n_devices: int
    xla_flops: float = 0.0       # the reference's raw cost_analysis; none here
    xla_bytes: float = 0.0
    # the reference's bf16-native estimate undoes an XLA:CPU artifact that
    # eager PyTorch does not have: here it is the bytes as counted
    bytes_bf16: float = 0.0
    spec: HardwareSpec = H100_SXM

    @property
    def compute_s(self) -> float:
        return self.flops / self.spec.peak_flops + self.spec.latency_floor

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / self.spec.hbm_bw + self.spec.latency_floor

    @property
    def memory_bf16_s(self) -> float:
        return self.bytes_bf16 / self.spec.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / self.spec.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops, "bytes": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "collective_counts": self.collective_counts,
            "xla_flops": self.xla_flops, "xla_bytes": self.xla_bytes,
            "bytes_bf16": self.bytes_bf16, "memory_bf16_s": self.memory_bf16_s,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "n_devices": self.n_devices, "hw_spec": self.spec.name,
        }

    def with_spec(self, spec: HardwareSpec) -> "Roofline":
        """The same counts re-anchored to different hardware."""
        return dataclasses.replace(self, spec=spec)


def analyze(step_fn: Callable, *args, n_devices: int = 1,
            spec: HardwareSpec = H100_SXM, sharded: Iterable[torch.Tensor] = (),
            model: int = 1, counts: Optional[list] = None) -> Roofline:
    """Run ``step_fn(*args)`` on ``meta`` tensors under :func:`count` and
    return its :class:`Roofline`, with no collective (none runs on
    ``meta`` tensors; ``sharded`` and ``model`` as :func:`count` takes
    them). ``counts``, a list, receives the :class:`Counts`."""
    with count(sharded, model) as c:
        step_fn(*args)
    if counts is not None:
        counts.append(c)
    return Roofline(c.flops, c.bytes, 0.0, {}, n_devices, 0.0, 0.0, c.bytes,
                    spec)


def model_flops(n_params: int, n_active_params: int, tokens: int,
                kind: str) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (forward-only), N = active params."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens
