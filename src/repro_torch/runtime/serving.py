"""Fault-tolerant quorum serving on the card (RoCoIn Fig. 1, runtime phase).

The source node batches incoming requests, broadcasts the input to every
live replica, collects portions — a partition is satisfied by its FIRST
arriving replica — and merges them with the FC head as soon as one replica
of every partition arrived or the deadline expired; late or missing
portions are zeroed (degraded mode, the paper's §V behaviour).

Latency accounting uses the paper's Eq. 1a device model (the numpy
simulator, copied from the JAX package so both draw the same failures from
the same seed); the portion math runs as PyTorch on the server's
``device``, and every merge is ONE launch of the hand-written CUDA kernel
:func:`repro_torch.kernels.ops.quorum_aggregate`.

Two paths, as in the JAX package:

* the fused step, when the students share an arch family: their weights
  are stacked once along a leading K axis (feature dims padded, int8
  quantized under ``quantize="int8"``), one ``torch.func.vmap`` of the
  shared forward computes all K portions, the per-row arrived mask is
  applied before the merge, and the merge consumes int8 FC slices in-kernel;
* the legacy per-slot loop (``fastpath=False`` or mixed-width students):
  one forward per slot that anybody received, zeros for a slot nobody
  received, the same merge.

The results stay on the device: :class:`ServeResult` copies the logits to
the host on first access, and its ``block_until_ready`` waits for the CUDA
work behind them.

Served here: replicate-only plans. Live repair (``migrate``,
``deploy_slot``, ``remove_device``) and coded plans are later slices of the
port; the server raises ``NotImplementedError`` naming their ROADMAP item,
and refuses a coded plan when it is built.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.plan_ir import PlanIR
from repro_torch.core.simulator import FailureModel, plan_arrays, reduce_trials
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as K
from repro_torch.optim.compression import (Int8Weights, dequantize_tree,
                                           quantize_tree, quantize_weight)
from repro_torch.tree import stack_trees, tree_to

LIVE_REPAIR = "ROADMAP.md Queue 1 item 3 (live repair)"
CODED_SERVING = "ROADMAP.md Queue 1 items 5-6 (coded serving)"


@dataclasses.dataclass
class ServeResult:
    """One request's answer. ``logits`` is lazy: the device tensor backing
    the whole micro-batch is held until first access, so callers that only
    look at quorum metadata (the serving engine) never copy to the host —
    and ``failed_devices`` is derived on demand from the aliveness row."""
    latency: float
    arrived: np.ndarray           # (K,) bool
    degraded: bool
    _logits: Any = dataclasses.field(default=None, repr=False)
    _span: Optional[Tuple[int, int]] = dataclasses.field(
        default=None, repr=False)
    _alive: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    _names: Optional[Sequence[str]] = dataclasses.field(
        default=None, repr=False)
    _np_logits: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)
    # recorded on the current stream right after the merge (CUDA only)
    _done: Optional[torch.cuda.Event] = dataclasses.field(
        default=None, repr=False)

    @property
    def logits(self) -> np.ndarray:
        """This request's merged logits (B, C), copied to the host lazily
        from the shared micro-batch tensor."""
        if self._np_logits is None:
            x = self._logits
            if self._span is not None:
                x = x[self._span[0]:self._span[1]]
            self._np_logits = x.cpu().numpy()
            self._logits = None    # release the shared micro-batch tensor
            self._done = None
        return self._np_logits

    @property
    def coverage(self) -> float:
        """Fraction of partitions that arrived — mirrors
        ``TrialResult.coverage``."""
        return float(self.arrived.mean()) if len(self.arrived) else 0.0

    @property
    def failed_devices(self) -> List[str]:
        """Names of the devices that were down for this request."""
        if self._alive is None:
            return []
        return [self._names[j] for j in np.flatnonzero(~self._alive)]

    def block_until_ready(self) -> "ServeResult":
        """Wait for the device work behind ``logits`` (shared by the whole
        micro-batch). The engine calls this inside its timed region in
        measured-wall mode so service times include the device time."""
        if self._done is not None:
            self._done.synchronize()
        return self


@dataclasses.dataclass
class FusedStudents:
    """The stacked-student export behind the fused step.

    ``apply(slot_params, x) -> (B, Dk)`` is ONE portion forward shared by
    every slot; ``params`` holds each slot's UNPADDED parameter tree, and
    ``pad(slot_params, Dk)`` pads a slot's feature dims to the uniform width
    (identity when ``None``). ``pre(x)``, when set, is a slot-independent
    prefix (a shared trunk) computed once per batch outside the map."""
    apply: Callable[[Any, torch.Tensor], torch.Tensor]
    params: List[Any]
    pad: Optional[Callable[[Any, int], Any]] = None
    pre: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def padded(self, k: int, width: int) -> Any:
        """Slot ``k``'s params padded to the uniform feature ``width``."""
        p = self.params[k]
        return self.pad(p, width) if self.pad is not None else p


@dataclasses.dataclass
class QuorumServer:
    """Quorum-of-portions inference server over a replicate-only plan.

    Runs every placed student portion on ``device`` (the card unless
    ``device="cpu"``), masks the ones whose devices failed, and merges with
    the ``quorum_aggregate`` kernel. ``portion_fns`` and the ``fused``
    export must compute on ``device``; ``fc_weights``/``fc_bias`` are moved
    there."""

    plan: Any                     # planner.Plan or the canonical PlanIR
    portion_fns: List[Callable[[torch.Tensor], torch.Tensor]]  # per partition
    fc_weights: torch.Tensor      # (K, Dk, C) padded per-partition FC slices
    fc_bias: torch.Tensor         # (C,)
    deadline: float = float("inf")
    failure: Any = dataclasses.field(default_factory=FailureModel)
    rng: np.random.Generator = dataclasses.field(
        default_factory=lambda: np.random.default_rng(0))
    # fused step: stacked-student export; None → legacy per-slot loop.
    fused: Optional[FusedStudents] = None
    # None = auto (fused whenever an export exists); False pins the legacy
    # per-slot loop
    fastpath: Optional[bool] = None
    quantize: str = "none"        # none | int8 (weight-only deployment)
    device: DeviceLike = None     # None → cuda; raises when there is no card
    _arrays: Optional[Any] = dataclasses.field(
        default=None, init=False, repr=False)
    _ir: Optional[PlanIR] = dataclasses.field(
        default=None, init=False, repr=False)
    _fused_stacked: Optional[Any] = dataclasses.field(
        default=None, init=False, repr=False)
    _fc_q: Optional[Int8Weights] = dataclasses.field(
        default=None, init=False, repr=False)
    _det_cache: Dict = dataclasses.field(
        default_factory=dict, init=False, repr=False)

    # optional obs plane (plain class attributes, not dataclass fields —
    # the owning engine wires them; timestamps come from ``tracer.now``)
    tracer = None
    trace_name = ""

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.quantize not in ("none", "int8"):
            raise ValueError(f"quantize must be 'none' or 'int8', not "
                             f"{self.quantize!r}")
        ir = self.ir
        if ir.coding is not None or ir.compute_coding is not None:
            raise NotImplementedError(
                f"the port serves replicate-only plans; this plan carries "
                f"a coding layout — see {CODED_SERVING}")
        self.fc_weights = torch.as_tensor(
            self.fc_weights, dtype=torch.float32).to(self.device)
        self.fc_bias = torch.as_tensor(
            self.fc_bias, dtype=torch.float32).to(self.device)

    # -- plan views ----------------------------------------------------------

    @property
    def ir(self) -> PlanIR:
        """Canonical array-backed view of the current plan."""
        if isinstance(self.plan, PlanIR):
            return self.plan
        if self._ir is None:
            self._ir = PlanIR.from_plan(self.plan)
        return self._ir

    @property
    def arrays(self):
        """Cached PlanArrays view of the plan."""
        if self._arrays is None:
            self._arrays = plan_arrays(self.plan)
        return self._arrays

    @property
    def fastpath_active(self) -> bool:
        """True when serve_batch will take the fused step."""
        if self.fastpath is False:
            return False
        if self.fastpath and self.fused is None:
            raise ValueError("fastpath=True but the server has no stacked "
                             "student export (fused=None)")
        return self.fused is not None

    # -- fused step ----------------------------------------------------------

    def _ensure_fused(self) -> Any:
        """Build (once) the stacked parameter tree on the device — int8
        quantized per slot under ``quantize='int8'`` — and the int8 FC
        slices."""
        if self._fused_stacked is None:
            Dk = int(self.fc_weights.shape[1])
            padded = [self.fused.padded(k, Dk)
                      for k in range(len(self.fused.params))]
            stacked = tree_to(stack_trees(padded), self.device)
            if self.quantize == "int8":
                stacked = quantize_tree(stacked, axis=0)
            self._fused_stacked = stacked
        if self._fc_q is None and self.quantize == "int8":
            self._fc_q = quantize_weight(self.fc_weights, axis=0)
        return self._fused_stacked

    def _fused_step(self, stacked: Any, x: torch.Tensor,
                    row_mask: Optional[torch.Tensor],
                    any_mask: torch.Tensor, fc_w: torch.Tensor,
                    fc_scales: Optional[torch.Tensor],
                    fc_b: torch.Tensor) -> torch.Tensor:
        """(int8 dequant →) the shared forward mapped over the stacked K
        axis → per-row arrived mask (K, B) → one quorum_aggregate launch."""
        fused = self.fused
        params = dequantize_tree(stacked) if self.quantize == "int8" \
            else stacked
        if fused.pre is not None:
            x = fused.pre(x)                 # shared trunk: once, not K times
        portions = torch.func.vmap(fused.apply, in_dims=(0, None))(params, x)
        if row_mask is not None:
            portions = portions * row_mask[:, :, None]
        return K.quorum_aggregate(portions.contiguous(), fc_w, fc_b,
                                  any_mask, fc_scales)

    # -- serving -------------------------------------------------------------

    def serve(self, x, *, rng: Optional[np.random.Generator] = None
              ) -> ServeResult:
        """Serve one request: ``serve_batch([x])[0]``."""
        return self.serve_batch([x], rng=rng)[0]

    def serve_batch(self, xs: Sequence[Any], *,
                    rng: Optional[np.random.Generator] = None
                    ) -> List[ServeResult]:
        """Serve R stacked requests — see :meth:`_serve_batch`. With a
        tracer wired this adds the ``serve_batch`` span (dispatch wall time,
        request/row counts); with none it is a tail call."""
        if self.tracer is None:
            return self._serve_batch(xs, rng=rng)
        t0 = time.perf_counter()
        out = self._serve_batch(xs, rng=rng)
        t = self.tracer.now
        self.tracer.complete(
            "serve_batch", f"{self.trace_name}server", t, t,
            requests=len(xs),
            rows=int(sum(int(x.shape[0]) for x in xs)),
            wall_us=(time.perf_counter() - t0) * 1e6)
        return out

    def _serve_batch(self, xs: Sequence[Any], *,
                     rng: Optional[np.random.Generator] = None
                     ) -> List[ServeResult]:
        """Serve R stacked requests (numpy arrays or tensors, stacked along
        rows on the device). Failures are drawn per request (one vectorized
        sample for the whole batch) from ``rng`` — the server's own
        generator unless the caller hands one in, as the engine does per
        batch. Each call launches the merge kernel once (on the card), and
        returns WITHOUT waiting for the device."""
        R = len(xs)
        if R == 0:
            return []
        fastpath = self.fastpath_active
        stacked = self._ensure_fused() if fastpath else None
        fc_q = self._fc_q if fastpath else None
        fc_weights, fc_bias = self.fc_weights, self.fc_bias
        portion_fns = self.portion_fns
        arrays = self.arrays
        failure = self.failure
        rng = self.rng if rng is None else rng
        dev = self.device
        Kp = len(fc_weights)

        sizes = [int(x.shape[0]) for x in xs]
        offs = np.concatenate([[0], np.cumsum(sizes)])
        x_all = _stack_rows(xs, dev)
        B = int(offs[-1])

        # a scenario deadline can only TIGHTEN the server's own SLO deadline
        deadline = self.deadline
        scenario_deadline = getattr(failure, "deadline", None)
        if scenario_deadline is not None:
            deadline = min(deadline, scenario_deadline)
        # a fully deterministic failure model draws nothing and always gives
        # the same per-row outcome for a (plan, deadline): memoized
        if (type(failure) is FailureModel and not failure.forced_failures
                and failure.crash_prob == 0 and not failure.outages):
            alive1, arrived1, lat1 = self._deterministic_outcome(arrays,
                                                                 deadline)
            alive = np.broadcast_to(alive1, (R, alive1.shape[0]))
            arrived = np.broadcast_to(arrived1, (R, arrived1.shape[0]))
            latency = np.broadcast_to(lat1, (R,))
        else:
            alive, delay = failure.sample(rng, arrays, R)
            _, arrived, latency = reduce_trials(arrays, alive, delay,
                                                deadline)

        # per-sample row mask: request r's rows of portion k are zeroed when
        # k missed r's quorum (linear merge ⇒ exact per-request masking)
        clean = bool(arrived.all())
        any_arrived = arrived.any(axis=0)                   # (K,)
        row_arrived = None if clean else np.repeat(arrived, sizes, axis=0)
        row_mask = None if clean else torch.from_numpy(      # (K, B)
            np.ascontiguousarray(row_arrived.T, np.float32)).to(dev)
        any_mask = torch.from_numpy(any_arrived.astype(np.int32)).to(dev)

        if fastpath:
            if fc_q is not None:
                fc_w, fc_scales = fc_q.q, fc_q.scale
            else:
                fc_w, fc_scales = fc_weights, None
            logits = self._fused_step(stacked, x_all, row_mask, any_mask,
                                      fc_w, fc_scales, fc_bias)
        else:
            Dk = int(fc_weights.shape[1])
            portions = []
            for kslot in range(Kp):
                if not any_arrived[kslot]:
                    # nobody received this slot: no forward at all
                    portions.append(torch.zeros((B, Dk), dtype=torch.float32,
                                                device=dev))
                    continue
                p = portion_fns[kslot](x_all)
                if p.shape[-1] < Dk:
                    p = F.pad(p, (0, Dk - p.shape[-1]))
                if not clean and not row_arrived[:, kslot].all():
                    p = p * row_mask[kslot, :, None]
                portions.append(p)
            logits = K.quorum_aggregate(torch.stack(portions), fc_weights,
                                        fc_bias, any_mask)
        return self._package(R, offs, logits, arrived, latency, alive,
                             arrays)

    def _package(self, R, offs, logits, arrived, latency, alive,
                 arrays) -> List[ServeResult]:
        """One vectorized pass extracts every per-request scalar; one CUDA
        event marks the end of the batch's device work."""
        done = None
        if logits.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(logits.device))
        lat_list = latency.tolist()
        complete = arrived.all(axis=1).tolist()
        offs_list = offs.tolist()
        return [ServeResult(
            latency=lat_list[r],
            arrived=arrived[r],
            degraded=not complete[r],
            _logits=logits,
            _span=(offs_list[r], offs_list[r + 1]),
            _alive=alive[r],
            _names=arrays.names,
            _done=done,
        ) for r in range(R)]

    def _deterministic_outcome(self, arrays, deadline: float):
        """One cached (alive row, arrived row, latency) for the
        deterministic failure-free model, keyed by the PlanArrays object."""
        key = (id(arrays), deadline)
        hit = self._det_cache.get(key)
        if hit is None or hit[0] is not arrays:
            alive = np.ones((1, len(arrays.names)), bool)
            _, arrived, latency = reduce_trials(arrays, alive, None, deadline)
            hit = (arrays, alive[0], arrived[0], latency)
            self._det_cache[key] = hit
        return hit[1], hit[2], hit[3]

    # -- later slices ----------------------------------------------------------

    def migrate(self, new_ir: PlanIR, mapping=None) -> Dict:
        """Adopt a repaired plan — not ported yet."""
        raise NotImplementedError(f"QuorumServer.migrate: {LIVE_REPAIR}")

    def deploy_slot(self, k: int, fn: Callable, fc_slice, params=None):
        """Push re-distilled weights for one slot — not ported yet."""
        raise NotImplementedError(f"QuorumServer.deploy_slot: {LIVE_REPAIR}")

    def remove_device(self, name: str, *, repair: bool = True):
        """Permanent device loss — not ported yet."""
        raise NotImplementedError(
            f"QuorumServer.remove_device: {LIVE_REPAIR}")


def _stack_rows(xs: Sequence[Any], device: torch.device) -> torch.Tensor:
    """Concatenate request payloads (numpy or tensors) along rows, as one
    float32 tensor on ``device``."""
    ts = [torch.as_tensor(x).to(device=device, dtype=torch.float32)
          for x in xs]
    return ts[0] if len(ts) == 1 else torch.cat(ts, dim=0)


def server_from_ensemble(ens, deadline: float = float("inf"),
                         failure: Optional[FailureModel] = None,
                         seed: int = 0, fastpath: Optional[bool] = None,
                         quantize: str = "none",
                         device: DeviceLike = None) -> QuorumServer:
    """Build a QuorumServer from a :class:`repro_torch.core.pipeline
    .Ensemble`: the FC kernel is split into per-partition slices padded to
    the uniform width, each student's parameters move to ``device``, and a
    stackable (one arch family) ensemble gets the fused step;
    ``quantize="int8"`` deploys its stacked students and FC slices int8."""
    device = resolve_device(device)
    Dk = max(ens.part_dims)
    C = int(ens.fc["bias"].shape[0])
    Kp = len(ens.students)
    kernel = ens.fc["kernel"].detach().cpu().numpy()
    weights = np.zeros((Kp, Dk, C), np.float32)
    off = 0
    for kslot, dim in enumerate(ens.part_dims):
        weights[kslot, :dim] = kernel[off:off + dim]
        off += dim
    on_device = dataclasses.replace(
        ens, students=[(cfg, tree_to(params, device), fwd)
                       for cfg, params, fwd in ens.students])

    def make_fn(kslot):
        cfg, params, fwd = on_device.students[kslot]

        def fn(x):
            _, feats, _ = fwd(params, cfg, x)
            return feats
        return fn

    return QuorumServer(
        plan=ens.ir or ens.plan,
        portion_fns=[make_fn(i) for i in range(Kp)],
        fc_weights=torch.from_numpy(weights),
        fc_bias=ens.fc["bias"],
        deadline=deadline,
        failure=failure or FailureModel(),
        rng=np.random.default_rng(seed),
        fused=on_device.fused_export(),
        fastpath=fastpath,
        quantize=quantize,
        device=device,
    )
