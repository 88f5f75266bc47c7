"""Fault-tolerant quorum serving on the card (RoCoIn Fig. 1, runtime phase).

The source node batches incoming requests, broadcasts the input to every
live replica, collects portions — a partition is satisfied by its FIRST
arriving replica — and merges them with the FC head as soon as one replica
of every partition arrived or the deadline expired; late or missing
portions are zeroed (degraded mode, the paper's §V behaviour). On
permanent device loss the controller repairs the plan and the server
migrates onto it in place.

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
  one forward per slot, zeros for a slot nobody received, the same merge.

Coded plans serve through both paths. A plan carrying a
:class:`~repro_torch.coding.spec.CodingSpec` (output coding) serves
exactly like a replicate-only plan while every systematic share arrives;
when one is erased but its group holds ≥ k shares, the parity shares are
emulated by one einsum against the generator's parity rows, and the
hand-written CUDA kernel :func:`repro_torch.kernels.ops.coded_decode`
recovers the missing portions from host-built pseudo-inverse weights
before the merge. A plan carrying a
:class:`~repro_torch.coding.compute.ComputeCodingSpec` splits a coded
slot's portion column-wise into k blocks plus r parity blocks and recovers
it from the FIRST k shard arrivals (cancel-on-first-k), one
``coded_decode`` launch per coded slot; per-request shard arrival times
are exposed on :attr:`ServeResult.share_times` for the engine's share
futures.

The results stay on the device: :class:`ServeResult` copies the logits to
the host on first access, and its ``block_until_ready`` waits for the CUDA
work behind them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.grouping import Device
from repro_torch.core.plan_ir import PlanIR
from repro_torch.core.simulator import (FailureModel, plan_arrays,
                                        reduce_trials, reduce_trials_coded)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as K
from repro_torch.optim.compression import (Int8Weights, dequantize_tree,
                                           quantize_tree, quantize_weight)
from repro_torch.tree import stack_trees, tree_map, tree_to


@dataclasses.dataclass
class ServeResult:
    """One request's answer. ``logits`` is lazy: the device tensor backing
    the whole micro-batch is held until first access, so callers that only
    look at quorum metadata (the serving engine) never copy to the host —
    and ``failed_devices`` is derived on demand from the aliveness row."""
    latency: float
    arrived: np.ndarray           # (K,) bool
    degraded: bool
    # coded plans only: per-share arrival times (R_sh,), ∞ = never — the
    # serving engine turns these into per-share future events on its
    # virtual clock (cancel-on-first-k accounting)
    share_times: Optional[np.ndarray] = None
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
        """Fraction of partitions recovered (arrived directly or decoded
        from coded shares) — mirrors ``TrialResult.coverage``."""
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


def _set_stacked_row(stacked: Any, k: int, row: Any) -> Any:
    """A copy of the stacked tree with row ``k`` replaced by one slot's
    (possibly int8-quantized) padded tree — the single definition both
    migrate and deploy_slot use. The live stacked tensors are never written:
    an in-flight batch may still read them."""
    def put(leaf, new_leaf):
        if isinstance(leaf, Int8Weights):
            return Int8Weights(put(leaf.q, new_leaf.q),
                               put(leaf.scale, new_leaf.scale))
        out = leaf.clone()
        out[k] = new_leaf
        return out
    return tree_map(put, stacked, row)


@dataclasses.dataclass
class QuorumServer:
    """Quorum-of-portions inference server over a (possibly coded) plan.

    Runs every placed student portion on ``device`` (the card unless
    ``device="cpu"``), masks the ones whose devices failed, decodes coded
    shares when needed with the ``coded_decode`` kernel, and merges with
    the ``quorum_aggregate`` kernel. Live-migratable via :meth:`migrate`.
    ``portion_fns`` and the ``fused`` export must compute on ``device``;
    ``fc_weights``/``fc_bias`` are moved there."""

    plan: Any                     # planner.Plan or the canonical PlanIR
    portion_fns: List[Callable[[torch.Tensor], torch.Tensor]]  # per partition
    fc_weights: torch.Tensor      # (K, Dk, C) padded per-partition FC slices
    fc_bias: torch.Tensor         # (C,)
    deadline: float = float("inf")
    failure: Any = dataclasses.field(default_factory=FailureModel)
    rng: np.random.Generator = dataclasses.field(
        default_factory=lambda: np.random.default_rng(0))
    part_dims: Optional[Tuple[int, ...]] = None   # true per-slot feature dims
    # slots whose FC slice a migration zeroed (no stored weights for their
    # new partition): they contribute nothing to the merge, so results are
    # reported degraded until deploy_slot pushes real weights
    zeroed_slots: frozenset = frozenset()
    # content-addressed weight store: (new_ir, slot) -> (portion_fn, fc_slice)
    # or (portion_fn, fc_slice, slot_params) for the slot's partition, or
    # None when no weights exist for it. Used by :meth:`migrate` to rebuild
    # slots whose partition mask changed (slot_params feeds the fused step).
    redeploy_fn: Optional[Callable[[PlanIR, int], Optional[Tuple]]] = None
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
    _coded_rt: Optional[Any] = dataclasses.field(
        default=None, init=False, repr=False)
    _compute_rt: Optional[Any] = dataclasses.field(
        default=None, init=False, repr=False)
    # per coded slot of the compute runtime: (slot, k, parity rows (r, k))
    _compute_entries: Optional[List[Tuple[int, int, torch.Tensor]]] = \
        dataclasses.field(default=None, init=False, repr=False)
    _det_cache: Dict = dataclasses.field(
        default_factory=dict, init=False, repr=False)
    last_migration: Optional[Dict] = dataclasses.field(
        default=None, init=False, repr=False)

    # optional obs plane (plain class attributes, not dataclass fields —
    # the owning engine wires them; timestamps come from ``tracer.now``)
    tracer = None
    trace_name = ""

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.quantize not in ("none", "int8"):
            raise ValueError(f"quantize must be 'none' or 'int8', not "
                             f"{self.quantize!r}")
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
        """Cached PlanArrays view of the plan (rebuilt after migrations)."""
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

    def _invalidate_fused(self) -> None:
        self._fused_stacked = None
        self._fc_q = None

    def _fused_portions(self, stacked: Any, x: torch.Tensor) -> torch.Tensor:
        """(int8 dequant →) the shared forward mapped over the stacked K
        axis: the (K, B, Dk) portions."""
        fused = self.fused
        params = dequantize_tree(stacked) if self.quantize == "int8" \
            else stacked
        if fused.pre is not None:
            x = fused.pre(x)                 # shared trunk: once, not K times
        return torch.func.vmap(fused.apply, in_dims=(0, None))(params, x)

    # -- coded-redundancy state ----------------------------------------------

    def _coded_runtime(self, ir):
        """The plan's coded-serving glue (encode matrix + memoized decode
        weights), rebuilt whenever a migration installs a new IR; None for
        replicate-only plans."""
        spec = getattr(ir, "coding", None)
        if spec is None or not spec.n_groups:
            return None
        rt = self._coded_rt
        if rt is None or rt.ir is not ir:
            from repro_torch.coding.runtime import CodedRuntime
            rt = CodedRuntime(ir)
            self._coded_rt = rt
        return rt

    def _compute_runtime(self, ir):
        """The plan's compute-coding glue (per-slot generators + memoized
        first-k decode weights, see :class:`repro_torch.coding.compute
        .ComputeRuntime`) and its parity rows on the device, rebuilt
        whenever a migration installs a new IR; None for plans without
        intermediate-computation coding."""
        spec = getattr(ir, "compute_coding", None)
        if spec is None or not spec.Q:
            return None
        rt = self._compute_rt
        if rt is None or rt.ir is not ir:
            from repro_torch.coding.compute import ComputeRuntime
            rt = ComputeRuntime(ir)
            self._compute_rt = rt
            self._compute_entries = [
                (e.slot, e.k, torch.tensor(e.G[e.k:], dtype=torch.float32,
                                           device=self.device))
                for e in rt.entries]
        return rt

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
        batch. Each call launches the merge kernel once (on the card), plus
        one decode launch (output coding) or one per coded slot (compute
        coding) when a coded slot needs recovery, and returns WITHOUT
        waiting for the device.

        Re-entrant with :meth:`migrate`: every field the call reads is
        read once up front, and a migration installs fresh objects instead
        of writing the ones an in-flight batch holds."""
        R = len(xs)
        if R == 0:
            return []
        # -- migration handoff snapshot (one read of every mutable field) ----
        fastpath = self.fastpath_active
        ir = self.ir
        rt = self._coded_runtime(ir)           # None for replicate-only plans
        rtc = self._compute_runtime(ir)        # None without compute coding
        entries = self._compute_entries
        stacked = self._ensure_fused() if fastpath else None
        fc_q = self._fc_q if fastpath else None
        fc_weights, fc_bias = self.fc_weights, self.fc_bias
        portion_fns = self.portion_fns
        arrays = self.arrays
        failure = self.failure
        knowledge_gap = bool(self.zeroed_slots)
        rng = self.rng if rng is None else rng
        dev = self.device
        Dk = int(fc_weights.shape[1])

        sizes = [int(x.shape[0]) for x in xs]
        offs = np.concatenate([[0], np.cumsum(sizes)])
        x_all = _stack_rows(xs, dev)

        # a scenario deadline can only TIGHTEN the server's own SLO deadline
        deadline = self.deadline
        scenario_deadline = getattr(failure, "deadline", None)
        if scenario_deadline is not None:
            deadline = min(deadline, scenario_deadline)
        # a fully deterministic failure model draws nothing and always gives
        # the same per-row outcome for a (plan, deadline): memoized
        share_arrived = share_t = None
        if (type(failure) is FailureModel and not failure.forced_failures
                and failure.crash_prob == 0 and not failure.outages):
            alive1, arrived1, lat1, share1, share_t1 = (
                self._deterministic_outcome(arrays, deadline))
            alive = np.broadcast_to(alive1, (R, alive1.shape[0]))
            arrived = np.broadcast_to(arrived1, (R, arrived1.shape[0]))
            latency = np.broadcast_to(lat1, (R,))
            if share1 is not None:
                share_arrived = np.broadcast_to(share1, (R, share1.shape[0]))
                share_t = np.broadcast_to(share_t1, (R, share_t1.shape[0]))
        else:
            alive, delay = failure.sample(rng, arrays, R)
            if rt is not None or rtc is not None:
                _, arrived, latency, share_arrived, share_t = (
                    reduce_trials_coded(arrays, alive, delay, deadline,
                                        return_share_times=True))
            else:
                _, arrived, latency = reduce_trials(arrays, alive, delay,
                                                    deadline)

        clean = bool(arrived.all())
        any_arrived = arrived.any(axis=0)                   # (K,)
        any_mask = torch.from_numpy(any_arrived.astype(np.int32)).to(dev)
        if fastpath and fc_q is not None:
            fc_w, fc_scales = fc_q.q, fc_q.scale
        else:
            fc_w, fc_scales = fc_weights, None
        # coded recovery engages only when a CODED slot's systematic share
        # is erased — while those all arrive the coded flow IS the plain
        # flow (identity decode), so it is skipped entirely
        decode_needed = (rt is not None and share_arrived is not None
                         and not bool(
                             share_arrived[:, rt.coded_slots].all()))
        # compute-coded slots decode from the k EARLIEST shard arrivals;
        # while those are the systematic shards (the all-alive steady state,
        # by the planner's placement) the decode is the identity and skipped
        compute_decode = (rtc is not None and share_t is not None
                          and rtc.needs_decode(share_t))

        if decode_needed:
            # host-built per-request decode operators (memoized pinv per
            # arrival pattern), expanded to rows
            dec = _rows(rt.decode_weights(share_arrived), sizes, dev)
            share_mask = _rows(share_arrived, sizes, dev, torch.int32)
            # every portion is computed: the parity emulation combines them
            portions = (self._fused_portions(stacked, x_all) if fastpath
                        else _slot_portions(portion_fns, x_all, Dk))
            parity = torch.einsum("pk,kbf->pbf", rt.enc_device(dev), portions)
            shares = torch.cat([portions, parity], dim=0)   # (K+P, B, F)
            # the (B, R, F) view, read in place: unit stride along F
            decoded = K.coded_decode(shares.transpose(0, 1), dec,
                                     share_mask)            # (B, K, F)
            portions = decoded.transpose(0, 1)
        else:
            # the legacy loop runs no forward for a slot nobody received
            portions = (self._fused_portions(stacked, x_all) if fastpath
                        else _slot_portions(portion_fns, x_all, Dk,
                                            any_arrived))
            if compute_decode:
                # per-trial first-k decode operators (memoized pinv per
                # chosen-shard pattern), expanded to rows
                decs, masks = rtc.decode_weights(share_t)
                portions = _compute_recover(
                    portions, entries, [_rows(d, sizes, dev) for d in decs],
                    [_rows(m, sizes, dev, torch.int32) for m in masks])
            if not clean:
                # request r's rows of portion k are zeroed when k missed r's
                # quorum (linear merge ⇒ exact per-request masking)
                portions = portions * _rows(arrived.T, sizes, dev, axis=1)[
                    :, :, None]
        # a view (the output-coded path's transposed decode) is read in
        # place: unit stride along Dk
        logits = K.quorum_aggregate(portions, fc_w, fc_bias,
                                    any_mask, fc_scales)
        return self._package(R, offs, logits, arrived, latency, alive,
                             arrays, knowledge_gap=knowledge_gap,
                             share_t=share_t)

    def _package(self, R, offs, logits, arrived, latency, alive, arrays, *,
                 knowledge_gap: bool = False,
                 share_t: Optional[np.ndarray] = None) -> List[ServeResult]:
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
            # a migration-zeroed slot contributes nothing even when its
            # replicas arrive — that answer is degraded, not complete
            degraded=not complete[r] or knowledge_gap,
            share_times=None if share_t is None else share_t[r],
            _logits=logits,
            _span=(offs_list[r], offs_list[r + 1]),
            _alive=alive[r],
            _names=arrays.names,
            _done=done,
        ) for r in range(R)]

    def _deterministic_outcome(self, arrays, deadline: float):
        """One cached (alive row, arrived row, latency, share-arrived row,
        share-time row) for the deterministic failure-free model, keyed by
        the PlanArrays object — migrations install a fresh object, so stale
        plans can't hit. The share rows are None for replicate-only
        plans."""
        key = (id(arrays), deadline)
        hit = self._det_cache.get(key)
        if hit is None or hit[0] is not arrays:
            alive = np.ones((1, len(arrays.names)), bool)
            if arrays.layout is not None:
                _, arrived, latency, share, share_t = reduce_trials_coded(
                    arrays, alive, None, deadline, return_share_times=True)
                share_row, share_t_row = share[0], share_t[0]
            else:
                _, arrived, latency = reduce_trials(arrays, alive, None,
                                                    deadline)
                share_row = share_t_row = None
            hit = (arrays, alive[0], arrived[0], latency, share_row,
                   share_t_row)
            self._det_cache[key] = hit
        return hit[1], hit[2], hit[3], hit[4], hit[5]

    # -- elastic re-planning -------------------------------------------------

    def migrate(self, new_ir: PlanIR, mapping: Optional[Dict[int, int]] = None
                ) -> Dict:
        """Adopt a new plan, keeping the portion forwards of untouched slots.

        `mapping` maps NEW slot → OLD slot (e.g. from
        :func:`repro_torch.runtime.failures.remap_students`); identity by
        default. A slot whose knowledge-partition mask is unchanged keeps
        its portion forward and FC slice. A slot whose mask changed must NOT
        keep the mapped slot's FC slice — its portion features belong to the
        new partition. Instead the slice is rebuilt from the
        content-addressed weight store (:attr:`redeploy_fn`, which also
        supplies the matching portion forward and — for fused servers — the
        slot's parameter tree); when no weights exist for the new partition
        the slice is zeroed — the slot contributes nothing until real
        weights arrive via :meth:`deploy_slot` — and the mapped slot's
        student stays deployed as the placement-only warm start.

        The fused step keeps its incremental-repair guarantee: only the
        touched rows of the stacked tree are rebuilt (untouched rows are
        gathered from the old stack), and a store that cannot supply a
        refit slot's parameter tree drops the server back to the legacy
        loop instead of serving wrong fused weights.

        Out-of-range ``mapping`` sources raise ``ValueError``. Returns and
        stores migration stats under the JAX package's keys:
        ``rejitted_slots`` (the slot's portion wrapper was replaced by the
        store's — exactly the store-refit slots; the port compiles nothing,
        so this is the JAX package's "re-jitted"), ``reused_slots`` (mask
        unchanged, everything kept), ``refit_slots``, ``zeroed_slots``
        (forward kept, FC zeroed), ``fused_rows_rebuilt`` (stacked rows
        rewritten).

        Safe against an in-flight :meth:`serve_batch`: every field is
        replaced with a freshly built object, never written in place."""
        old_ir = self.ir
        old_count = len(self.portion_fns)
        K_new = new_ir.K
        if mapping is None:
            mapping = {k: k for k in range(min(K_new, old_ir.K))}
        old_dims = list(self.part_dims) if self.part_dims is not None else \
            [int(self.fc_weights.shape[1])] * old_count
        C = int(self.fc_weights.shape[2])
        fused = self.fused
        fused_ok = fused is not None
        new_fns: List[Callable] = []
        slices: List[torch.Tensor] = []
        dims: List[int] = []
        fused_params: List[Any] = []
        srcs: List[int] = []
        rejit, refit, zeroed = [], [], []
        for k in range(K_new):
            if k in mapping:
                src = int(mapping[k])
                if not 0 <= src < old_count:
                    raise ValueError(
                        f"migration mapping for slot {k} points at source "
                        f"slot {src}, but the server holds {old_count} "
                        f"portions")
            elif k < old_count:
                src = k
            else:
                src = -1        # grown slot: only the weight store can fill it
            same_mask = (0 <= src < old_ir.K
                         and new_ir.partition.shape[1] == old_ir.partition.shape[1]
                         and bool((new_ir.partition[k] == old_ir.partition[src]).all()))
            if same_mask:
                new_fns.append(self.portion_fns[src])
                slices.append(self.fc_weights[src])
                dims.append(old_dims[src])
                if fused_ok:
                    fused_params.append(fused.params[src])
                srcs.append(src)
                if src in self.zeroed_slots:
                    zeroed.append(k)   # carried slice is still all-zero:
                                       # the knowledge gap survives the move
                continue
            weights = (self.redeploy_fn(new_ir, k)
                       if self.redeploy_fn is not None else None)
            if weights is not None:
                fn, fc_slice = weights[0], weights[1]
                slot_params = weights[2] if len(weights) > 2 else None
                fc_slice = torch.as_tensor(
                    fc_slice, dtype=torch.float32).to(self.device)
                new_fns.append(fn)
                slices.append(fc_slice)
                dims.append(int(fc_slice.shape[0]))
                if fused_ok:
                    if slot_params is None:
                        # the store cannot feed the stacked tree: fall back
                        # to the (always-correct) legacy loop
                        fused_ok = False
                    else:
                        fused_params.append(slot_params)
                srcs.append(-1)
                rejit.append(k)
                refit.append(k)
            elif src >= 0:
                # the src student stays deployed unchanged (only its FC
                # slice is zeroed), so its portion wrapper stays too and the
                # slot does NOT count as re-jitted
                new_fns.append(self.portion_fns[src])
                slices.append(torch.zeros_like(self.fc_weights[src]))
                dims.append(old_dims[src])     # the deployed forward's width
                if fused_ok:
                    fused_params.append(fused.params[src])
                srcs.append(src)
                zeroed.append(k)
            else:
                raise ValueError(
                    f"slot {k} has no mapping source and the weight store "
                    f"holds nothing for its partition")
        Dk = max([int(s.shape[0]) for s in slices], default=1)
        Dk_old = int(self.fc_weights.shape[1])
        padded = [s if s.shape[0] == Dk
                  else F.pad(s, (0, 0, 0, Dk - s.shape[0])) for s in slices]
        if Dk != Dk_old and fused_ok and fused.pad is None:
            # a pad-less export (uniform-width ensembles) cannot follow a
            # width change — fall back to the legacy loop
            fused_ok = False
        new_fused = (FusedStudents(fused.apply, fused_params, fused.pad,
                                   fused.pre)
                     if fused_ok else None)
        new_stacked = (self._migrated_stacked(new_fused, srcs, refit, Dk,
                                              Dk_old)
                       if fused_ok else None)
        self.portion_fns = new_fns
        self.fc_weights = (torch.stack(padded) if padded
                           else torch.zeros((0, Dk, C), dtype=torch.float32,
                                            device=self.device))
        self.part_dims = tuple(dims)
        self.zeroed_slots = frozenset(zeroed)
        self.plan = new_ir
        self._ir = new_ir
        self._arrays = None
        self._det_cache = {}       # keyed by the replaced PlanArrays object
        if new_fused is None and fused is not None and self.fastpath:
            # the export was dropped mid-migration (store without slot
            # params / width change on a pad-less export): un-pin the
            # explicit fastpath=True so serving falls back to the legacy
            # loop instead of raising at the next serve_batch
            self.fastpath = None
        self.fused = new_fused
        self._fused_stacked = new_stacked
        self._fc_q = None                       # re-quantized lazily
        self.last_migration = {"rejitted_slots": tuple(rejit),
                               "reused_slots": K_new - len(rejit) - len(zeroed),
                               "refit_slots": tuple(refit),
                               "zeroed_slots": tuple(zeroed),
                               "fused_rows_rebuilt":
                                   tuple(refit) if fused_ok else ()}
        if self.tracer is not None:
            self.tracer.instant(
                "migrate", f"{self.trace_name}server",
                rejitted=list(rejit), refit=list(refit),
                zeroed=list(zeroed),
                reused=K_new - len(rejit) - len(zeroed))
        return self.last_migration

    def _migrated_stacked(self, new_fused: FusedStudents, srcs: List[int],
                          refit: List[int], Dk: int, Dk_old: int
                          ) -> Optional[Any]:
        """Rebuild ONLY the touched rows of the stacked tree: carried rows
        are gathered from the old stack (no re-pad, no re-quantize), refit
        rows are padded/quantized fresh. A width change forces a full
        restack (lazily, on the next serve)."""
        old = self._fused_stacked
        if old is None:
            return None                    # nothing built yet — stay lazy
        if Dk != Dk_old:
            return None                    # width changed: full restack
        # carried rows gather from their src; refit rows are overwritten
        # below, so any in-range placeholder works for them
        gather = torch.as_tensor([s if s >= 0 else 0 for s in srcs],
                                 dtype=torch.int64, device=self.device)

        def take(leaf):
            if isinstance(leaf, Int8Weights):
                return Int8Weights(leaf.q[gather], leaf.scale[gather])
            return leaf[gather]

        stacked = tree_map(take, old)
        for k in sorted(set(refit)):
            row = tree_to(new_fused.padded(k, Dk), self.device)
            stacked = _set_stacked_row(
                stacked, k,
                quantize_tree(row) if self.quantize == "int8" else row)
        return stacked

    def deploy_slot(self, k: int, fn: Callable, fc_slice,
                    params: Optional[Any] = None) -> None:
        """Push (re-)distilled weights for slot ``k`` — the deployment
        layer's handshake for slots a migration left zeroed. Installs the
        portion forward, the FC slice, and — for fused servers — the slot's
        parameter tree (only that row of the stacked tree is rebuilt).
        Omitting ``params`` on a fused server drops it back to the legacy
        loop (the stacked export would be stale). Grows the uniform slice
        width when needed. Safe against in-flight serves (fresh objects, no
        in-place writes)."""
        if not 0 <= k < len(self.portion_fns):
            raise ValueError(f"slot {k} out of range "
                             f"(server holds {len(self.portion_fns)})")
        fc_slice = torch.as_tensor(fc_slice,
                                   dtype=torch.float32).to(self.device)
        d = int(fc_slice.shape[0])
        Dk = int(self.fc_weights.shape[1])
        weights = self.fc_weights
        grew = d > Dk
        if grew:
            weights = F.pad(weights, (0, 0, 0, d - Dk))
            Dk = d
        if d < Dk:
            fc_slice = F.pad(fc_slice, (0, 0, 0, Dk - d))
        weights = weights.clone()
        weights[k] = fc_slice
        self.fc_weights = weights
        fns = list(self.portion_fns)
        fns[k] = fn
        self.portion_fns = fns
        if self.part_dims is not None:
            dims = list(self.part_dims)
            dims[k] = d
            self.part_dims = tuple(dims)
        self.zeroed_slots = self.zeroed_slots - {k}
        if self.fused is not None:
            if params is None or (grew and self.fused.pad is None):
                # no slot tree supplied, or the uniform width grew under a
                # pad-less export (its rows cannot be re-padded): the
                # stacked export would be stale — serve the legacy loop
                # (and un-pin an explicit fastpath=True so serving keeps
                # working instead of raising at the next batch)
                if self.fastpath:
                    self.fastpath = None
                self.fused = None
                self._invalidate_fused()
                return
            new_params = list(self.fused.params)
            new_params[k] = params
            self.fused = FusedStudents(self.fused.apply, new_params,
                                       self.fused.pad, self.fused.pre)
            if self._fused_stacked is not None and not grew:
                row = tree_to(self.fused.padded(k, Dk), self.device)
                self._fused_stacked = _set_stacked_row(
                    self._fused_stacked, k,
                    quantize_tree(row) if self.quantize == "int8" else row)
            else:
                self._fused_stacked = None
        self._fc_q = None

    def remove_device(self, name: str, *, repair: bool = True):
        """Permanent loss. With ``repair=True`` (default) the loss routes
        through :class:`repro_torch.runtime.controller.ClusterController`:
        groups that lost quorum are repaired incrementally (donor devices
        moved in, lost coded shares re-encoded onto spares, full
        Algorithm-1 replan as fallback) and this server migrates onto the
        repaired plan in place. Returns the controller's ``RepairOutcome``
        — ``kind == "noop"`` when the loss broke no group (the server still
        adopts the shrunken plan).

        ``repair=False`` keeps the drop-only behaviour (returns ``None``) —
        the partition of an emptied group then permanently misses
        quorum."""
        if not repair:
            if isinstance(self.plan, PlanIR):
                self.plan = self.plan.drop_device(name)
                self._ir = self.plan
            else:
                for g in self.plan.groups:
                    g.devices = [d for d in g.devices if d.name != name]
                self._ir = None
            self._arrays = None
            self._det_cache = {}
            return None
        from repro_torch.runtime.controller import ClusterController
        ctl = ClusterController(self.ir, server=self)
        return ctl.permanent_loss(name)

    def live_devices(self) -> List[Device]:
        """Devices with at least one placed share (systematic or parity)."""
        if isinstance(self.plan, PlanIR):
            devs = self.plan.devices()
            used = self.plan.member.any(0)
            cs = self.plan.coding
            if cs is not None and cs.P:
                used = used | cs.parity_member.any(0)
            return [devs[n] for n in np.flatnonzero(used)]
        return [d for g in self.plan.groups for d in g.devices]


def _rows(a: np.ndarray, sizes: Sequence[int], device: torch.device,
          dtype: torch.dtype = torch.float32, axis: int = 0) -> torch.Tensor:
    """A per-request array expanded to one entry per row (``sizes[r]``
    copies of request r's entry along ``axis``), as a contiguous tensor on
    ``device``."""
    rows = np.repeat(np.asarray(a), sizes, axis=axis)
    return torch.from_numpy(np.ascontiguousarray(rows)).to(device=device,
                                                           dtype=dtype)


def _slot_portions(portion_fns: Sequence[Callable], x: torch.Tensor,
                   Dk: int, any_arrived: Optional[np.ndarray] = None
                   ) -> torch.Tensor:
    """The legacy loop's (K, B, Dk) portions: one forward per slot, padded
    to the uniform width. With ``any_arrived`` a slot nobody received gets
    zeros and no forward."""
    portions = []
    for kslot, fn in enumerate(portion_fns):
        if any_arrived is not None and not any_arrived[kslot]:
            portions.append(torch.zeros((x.shape[0], Dk),
                                        dtype=torch.float32, device=x.device))
            continue
        p = fn(x)
        if p.shape[-1] < Dk:
            p = F.pad(p, (0, Dk - p.shape[-1]))
        portions.append(p)
    return torch.stack(portions)


def _compute_recover(portions: torch.Tensor,
                     entries: Sequence[Tuple[int, int, torch.Tensor]],
                     decs: Sequence[torch.Tensor],
                     masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Compute-coded recovery of the (K, B, Dk) portions: each coded slot's
    portion is split column-wise into k blocks (the systematic shards'
    outputs), the parity rows emulate the r parity shards, and one
    ``coded_decode`` launch rebuilds the slot from its first-k shards."""
    rec = list(portions.unbind(0))
    for (slot, k, Gpar), dec, m in zip(entries, decs, masks):
        y = portions[slot]                                  # (B, F)
        Fw = int(y.shape[1])
        w = -(-Fw // k)
        blocks = F.pad(y, (0, k * w - Fw)).reshape(-1, k, w)  # (B, k, w)
        par = torch.einsum("rk,bkw->brw", Gpar, blocks)
        shares = torch.cat([blocks, par], dim=1)            # (B, n, w)
        decoded = K.coded_decode(shares, dec, m)            # (B, k, w)
        rec[slot] = decoded.reshape(-1, k * w)[:, :Fw]
    return torch.stack(rec)


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
    ``quantize="int8"`` deploys its stacked students and FC slices int8.

    The server carries a content-addressed weight store over the
    ensemble's students (keyed by partition filter set): a migration onto a
    plan whose partition matches one the ensemble was distilled for refits
    that slot's portion forward AND FC slice from the store instead of
    serving stale columns."""
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

    portion_fns = [make_fn(i) for i in range(Kp)]
    fused = on_device.fused_export()
    ir = ens.ir
    groups = sorted(ens.plan.groups, key=lambda g: g.partition_idx)
    store: Dict[frozenset, Tuple] = {}
    for kslot in range(Kp):
        if ir is not None and kslot < ir.K:
            filters = np.flatnonzero(ir.partition[kslot])
        else:
            filters = np.asarray(groups[kslot].filters, np.int64)
        store[frozenset(filters.tolist())] = (
            portion_fns[kslot],
            torch.from_numpy(weights[kslot, :ens.part_dims[kslot]]).to(device),
            fused.params[kslot] if fused is not None else None)

    def redeploy(new_ir: PlanIR, slot: int):
        key = frozenset(np.flatnonzero(new_ir.partition[slot]).tolist())
        return store.get(key)

    return QuorumServer(
        plan=ir or ens.plan,
        portion_fns=portion_fns,
        fc_weights=torch.from_numpy(weights),
        fc_bias=ens.fc["bias"],
        deadline=deadline,
        failure=failure or FailureModel(),
        rng=np.random.default_rng(seed),
        part_dims=tuple(int(d) for d in ens.part_dims),
        redeploy_fn=redeploy,
        fused=fused,
        fastpath=fastpath,
        quantize=quantize,
        device=device,
    )
