"""Runtime simulator for distributed inference (RoCoIn §V) — vectorized.

Implements the paper's evaluation model exactly:
  - per-device latency  = C_j^flops / c_n^core + Q_j / r_n^tran   (Eq. 1a)
  - Rayleigh channel → exponential channel gain → outage events with
    probability p_n^out; crashed/timeout devices contribute nothing,
  - a partition's output arrives when its FIRST live replica reports
    (replicas mask failures), inference completes when every partition has
    at least one arrival (quorum), latency = slowest partition,
  - missing partitions are zeroed at aggregation (the paper's §V emulation),
    degrading accuracy instead of failing the query.

Monte-Carlo engine
------------------
The hot path is a matrix formulation: :func:`plan_arrays` precomputes the
Eq. 1a latency vector once per plan, a failure model/scenario draws ALL
``(trials, devices)`` aliveness samples in one RNG call, and
:func:`reduce_trials` collapses them to per-trial latency/coverage/completion
with masked min/max. 10k-trial sweeps are a single NumPy pass instead of
minutes of Python. The legacy per-trial path survives as
:func:`simulate_trial` / :func:`simulate_loop` (also the reference oracle:
at fixed seeds the vectorized engine reproduces it bit-for-bit whenever the
legacy RNG-draw count is shape-deterministic — see
``FailureModel.sample``).

Richer failure scenarios (correlated domains, straggler deadlines, Markov
link flapping) live in :mod:`repro.core.scenarios`; anything exposing
``sample(rng, arrays, trials)`` plugs into :func:`simulate`.

Erasure-coded plans (a PlanIR carrying a :class:`repro.coding.spec
.CodingSpec`) flow through the same engine: ``to_arrays`` appends parity
-share columns and a :class:`ShareLayout`, the failure models sample those
columns like any replica, and :func:`reduce_trials` scores coded recovery —
a coded group completes iff ≥ k of its n shares arrive.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.grouping import Device
from repro_torch.core.plan_ir import PlanIR
from repro_torch.core.planner import Plan
from repro_torch.obs.stats import percentile


@dataclasses.dataclass
class TrialResult:
    latency: float               # ∞ if no partition ever arrives
    arrived: np.ndarray          # bool per partition
    failed_devices: List[str]

    @property
    def complete(self) -> bool:
        return bool(self.arrived.all())

    @property
    def coverage(self) -> float:
        return float(self.arrived.mean()) if len(self.arrived) else 0.0


# ---------------------------------------------------------------------------
# plan precomputation (the per-plan constants of the Monte-Carlo kernel)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShareLayout:
    """Erasure-coded share structure of a coded plan's replica columns
    (built by :meth:`repro.core.plan_ir.PlanIR.to_arrays`). Share ids:
    share ``s < K`` is slot ``s``'s systematic share, the rest are parity.
    A coded group decodes — covering ALL its slots — once any ``k`` of its
    ``n`` shares arrive; a systematic share alone covers its own slot."""
    share_cols: Tuple[np.ndarray, ...]    # per-share replica column indices
    group_shares: Tuple[np.ndarray, ...]  # per-group share ids (sys first)
    group_slots: Tuple[np.ndarray, ...]   # per-group member slot ids
    group_k: np.ndarray                   # (C,) data shares per group

    @property
    def n_shares(self) -> int:
        return len(self.share_cols)


@dataclasses.dataclass(frozen=True)
class PlanArrays:
    """Flattened replica-device view of a plan: one column per device of a
    group that actually holds a student. Student-less groups keep their slot
    (they can never arrive) but contribute no columns. Coded plans carry
    extra parity-share columns (``slot == -1``) plus the :class:`ShareLayout`
    describing which shares decode which slots."""
    t: np.ndarray                    # (D,) Eq. 1a latency per replica device
    slot: np.ndarray                 # (D,) partition slot (-1 = parity share)
    p_out: np.ndarray                # (D,) transmission outage probability
    names: Tuple[str, ...]           # (D,) device names, plan order
    n_slots: int                     # plan.K (incl. student-less slots)
    slot_cols: Tuple[np.ndarray, ...]  # per-slot device-column indices
    # reduceat group starts when every slot is non-empty and columns are
    # emitted slot-by-slot (both constructors do); None → ragged layout.
    # Precomputed because the serving hot path reduces once per micro-batch
    slot_starts: Optional[np.ndarray] = None
    layout: Optional[ShareLayout] = None   # coded plans only

    def __post_init__(self):
        if self.slot_starts is not None or self.n_slots == 0:
            return
        if self.layout is not None:
            return                   # coded plans reduce share-wise
        lens = np.fromiter((len(c) for c in self.slot_cols), np.int64,
                           self.n_slots)
        if (lens.all() and int(lens.sum()) == len(self.slot)
                and bool((np.diff(self.slot) >= 0).all())):
            starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
            object.__setattr__(self, "slot_starts", starts)


def plan_arrays(plan) -> PlanArrays:
    """Flatten a plan (legacy ``Plan`` or canonical ``PlanIR``) into the
    Monte-Carlo replica-device view. For a PlanIR this is a pure derivation
    from the canonical arrays; the legacy loop is kept bit-compatible."""
    if isinstance(plan, PlanIR):
        return plan.to_arrays()
    t, slot, p_out, names = [], [], [], []
    for s, g in enumerate(plan.groups):
        if g.student is None:
            continue
        for d in g.devices:
            t.append(g.student.flops / d.c_core
                     + 8.0 * g.student.out_bytes / d.r_tran)
            slot.append(s)
            p_out.append(d.p_out)
            names.append(d.name)
    slot_arr = np.asarray(slot, np.int64)
    cols = tuple(np.flatnonzero(slot_arr == k) for k in range(plan.K))
    return PlanArrays(np.asarray(t, np.float64), slot_arr,
                      np.asarray(p_out, np.float64), tuple(names),
                      plan.K, cols)


def reduce_trials(arrays: PlanArrays, alive: np.ndarray,
                  delay: Optional[np.ndarray] = None,
                  deadline: Optional[float] = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Collapse an aliveness matrix to per-trial outcomes.

    alive: (T, D) bool; delay: optional (T, D) additive straggler latency.
    Returns (lat (T, K) per-slot arrival time, arrived (T, K) bool,
    latency (T,) quorum completion time, ∞ when nothing arrives).

    Coded plans (``arrays.layout`` set) score erasure recovery instead of
    plain replication: a coded group's slots all complete once ≥ k of its
    n shares arrive (see :func:`reduce_trials_coded`)."""
    if arrays.layout is not None:
        lat, arrived, latency, _ = reduce_trials_coded(arrays, alive, delay,
                                                       deadline)
        return lat, arrived, latency
    eff = arrays.t[None, :] if delay is None else arrays.t[None, :] + delay
    eff = np.where(alive, eff, np.inf)
    if deadline is not None and np.isfinite(deadline):
        eff = np.where(eff <= deadline, eff, np.inf)
    T = alive.shape[0]
    # plan_arrays/to_arrays emit replica columns slot by slot, so the
    # per-slot min collapses to ONE ufunc.reduceat over contiguous column
    # groups (bit-identical: min over the same floats) — the serving hot
    # path calls this per micro-batch, where the K-iteration python loop
    # was measurable. Empty slots (student-less groups) break reduceat's
    # group encoding; those plans keep the loop.
    if arrays.slot_starts is not None:
        lat = np.minimum.reduceat(eff, arrays.slot_starts, axis=1)
    else:
        lat = np.full((T, arrays.n_slots), np.inf)
        for k, cols in enumerate(arrays.slot_cols):
            if len(cols):
                lat[:, k] = eff[:, cols].min(axis=1)
    arrived = np.isfinite(lat)
    latency = np.where(arrived.any(axis=1),
                       np.where(arrived, lat, -np.inf).max(axis=1), np.inf)
    return lat, arrived, latency


def reduce_trials_coded(arrays: PlanArrays, alive: np.ndarray,
                        delay: Optional[np.ndarray] = None,
                        deadline: Optional[float] = None, *,
                        return_share_times: bool = False):
    """Coded-recovery reduction over a coded plan's aliveness matrix.

    Per-share arrival time = min over the share's replica columns; a coded
    group decodes at the k-th smallest of its n share times (∞ while fewer
    than k arrive — complete iff ≥ k of n shares arrive), covering every
    member slot; a slot's own systematic share also covers it alone (the
    code is systematic). Compute-coded slots (groups of n shard shares
    appended by ``PlanIR.to_arrays`` with an empty systematic share) score
    identically: recovery latency IS the k-th order statistic of shard
    arrivals — the cancel-on-first-k dispatch model. Replicate slots reduce
    exactly as before.

    Returns ``(lat (T, K), arrived (T, K), latency (T,),
    share_arrived (T, R))`` — the extra share-level mask is what the
    serving path feeds the decode-weight builder. With
    ``return_share_times=True`` a fifth element, the raw per-share arrival
    times ``share_t (T, R)`` (∞ = never), is appended: the serving path
    uses it to pick each trial's first-k shard set (later arrivals are
    cancelled) and the engine uses it to schedule per-share future events
    on the virtual clock."""
    L = arrays.layout
    if L is None:
        raise ValueError("reduce_trials_coded needs a coded PlanArrays "
                         "(layout attached by PlanIR.to_arrays)")
    eff = arrays.t[None, :] if delay is None else arrays.t[None, :] + delay
    eff = np.where(alive, eff, np.inf)
    if deadline is not None and np.isfinite(deadline):
        eff = np.where(eff <= deadline, eff, np.inf)
    T = alive.shape[0]
    share_t = np.full((T, L.n_shares), np.inf)
    for s, cols in enumerate(L.share_cols):
        if len(cols):
            share_t[:, s] = eff[:, cols].min(axis=1)
    lat = share_t[:, :arrays.n_slots].copy()
    for c in range(len(L.group_shares)):
        k = int(L.group_k[c])
        rec = np.sort(share_t[:, L.group_shares[c]], axis=1)[:, k - 1]
        slots = L.group_slots[c]
        lat[:, slots] = np.minimum(lat[:, slots], rec[:, None])
    arrived = np.isfinite(lat)
    latency = np.where(arrived.any(axis=1),
                       np.where(arrived, lat, -np.inf).max(axis=1), np.inf)
    if return_share_times:
        return lat, arrived, latency, np.isfinite(share_t), share_t
    return lat, arrived, latency, np.isfinite(share_t)


# ---------------------------------------------------------------------------
# failure models
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FailureModel:
    """Independent per-device failures. `crash_prob` models device crashes
    (power depletion, preemption); transmission outages use each device's
    p_out (Rayleigh channel). `outages=False` disables the stochastic channel
    (deterministic testing)."""
    crash_prob: float = 0.0
    forced_failures: Optional[Sequence[str]] = None   # device names down
    outages: bool = True

    def device_alive(self, rng: np.random.Generator, d: Device) -> bool:
        if self.forced_failures and d.name in self.forced_failures:
            return False
        if self.crash_prob > 0 and rng.random() < self.crash_prob:
            return False
        if not self.outages:
            return True
        # transmission outage (Rayleigh channel): outage w.p. p_out
        return rng.random() >= d.p_out

    def sample(self, rng: np.random.Generator, arrays: PlanArrays,
               trials: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """All-trials aliveness in one RNG call: (T, D) bool, no delay.

        Whenever the scalar `device_alive` loop consumes a shape-deterministic
        number of draws (crash_prob == 0, or outages disabled), this consumes
        the generator stream identically, so results are bit-for-bit equal to
        the legacy loop at a fixed seed. With crash AND outage enabled the
        legacy loop skips the outage draw for crashed devices (data-dependent
        stream); here both matrices are drawn unconditionally — a different
        stream layout with the identical aliveness distribution."""
        D = len(arrays.names)
        if not self.forced_failures:
            # serving hot path: no forced-down set means every device draws
            # (or trivially lives) — skip the per-name membership scan and
            # the masked copy. Stream consumption is unchanged (same draw
            # shapes as the nf == D general case below)
            if self.crash_prob > 0 and self.outages:
                return ((rng.random((trials, D)) >= self.crash_prob)
                        & (rng.random((trials, D))
                           >= arrays.p_out[None, :])), None
            if self.crash_prob > 0:
                return rng.random((trials, D)) >= self.crash_prob, None
            if self.outages:
                return rng.random((trials, D)) >= arrays.p_out[None, :], None
            return np.ones((trials, D), bool), None
        forced = frozenset(self.forced_failures)
        free = np.array([n not in forced for n in arrays.names], bool)
        nf = int(free.sum())
        alive = np.zeros((trials, D), bool)
        if nf == 0:
            return alive, None
        if self.crash_prob > 0 and self.outages:
            ok = ((rng.random((trials, nf)) >= self.crash_prob)
                  & (rng.random((trials, nf)) >= arrays.p_out[free][None, :]))
        elif self.crash_prob > 0:
            ok = rng.random((trials, nf)) >= self.crash_prob
        elif self.outages:
            ok = rng.random((trials, nf)) >= arrays.p_out[free][None, :]
        else:
            ok = np.ones((trials, nf), bool)
        alive[:, free] = ok
        return alive, None


# ---------------------------------------------------------------------------
# Monte-Carlo engines
# ---------------------------------------------------------------------------

def simulate_trial(plan: Plan, rng: np.random.Generator,
                   failure: Optional[FailureModel] = None) -> TrialResult:
    """Legacy per-trial path (API-compat shim; also the reference oracle)."""
    failure = failure or FailureModel()
    K = plan.K
    arrived = np.zeros(K, bool)
    lat = np.full(K, np.inf)
    failed: List[str] = []
    for slot, g in enumerate(plan.groups):
        if g.student is None:
            continue
        for d in g.devices:
            if not failure.device_alive(rng, d):
                failed.append(d.name)
                continue
            t = g.student.flops / d.c_core + 8.0 * g.student.out_bytes / d.r_tran
            lat[slot] = min(lat[slot], t)
            arrived[slot] = True
    latency = float(lat[arrived].max()) if arrived.any() else float("inf")
    return TrialResult(latency, arrived, failed)


def _stats(latency: np.ndarray, arrived: np.ndarray, trials: int
           ) -> Dict[str, float]:
    lats = latency[np.isfinite(latency)]
    covs = arrived.mean(axis=1) if arrived.shape[1] else np.zeros(trials)
    completes = int(arrived.all(axis=1).sum())
    return {
        "mean_latency": float(np.mean(lats)) if len(lats) else float("inf"),
        "p99_latency": percentile(lats, 99),
        "mean_coverage": float(np.mean(covs)),
        "complete_rate": completes / trials,
    }


def simulate_loop(plan: Plan, trials: int = 100, seed: int = 0,
                  failure: Optional[FailureModel] = None) -> Dict[str, float]:
    """The seed per-trial implementation, kept as reference + benchmark
    baseline for the vectorized engine."""
    rng = np.random.default_rng(seed)
    lats, covs, completes = [], [], 0
    for _ in range(trials):
        r = simulate_trial(plan, rng, failure)
        if np.isfinite(r.latency):
            lats.append(r.latency)
        covs.append(r.coverage)
        completes += int(r.complete)
    return {
        "mean_latency": float(np.mean(lats)) if lats else float("inf"),
        "p99_latency": percentile(lats, 99),
        "mean_coverage": float(np.mean(covs)),
        "complete_rate": completes / trials,
    }


def simulate(plan: Plan, trials: int = 100, seed: int = 0,
             failure=None, engine: str = "vectorized") -> Dict[str, float]:
    """Monte-Carlo sweep. `failure` is a :class:`FailureModel` or any scenario
    from :mod:`repro.core.scenarios` exposing ``sample(rng, arrays, trials)``
    (+ optional ``deadline``). ``engine="loop"`` forces the legacy per-trial
    path (FailureModel only)."""
    failure = failure or FailureModel()
    if engine == "loop":
        if not isinstance(failure, FailureModel):
            raise ValueError("engine='loop' supports only FailureModel")
        if isinstance(plan, PlanIR):
            plan = plan.to_plan()
        return simulate_loop(plan, trials, seed, failure)
    if engine != "vectorized":
        raise ValueError(f"unknown engine {engine!r}")
    rng = np.random.default_rng(seed)
    arrays = plan_arrays(plan)
    alive, delay = failure.sample(rng, arrays, trials)
    _, arrived, latency = reduce_trials(
        arrays, alive, delay, getattr(failure, "deadline", None))
    return _stats(latency, arrived, trials)


# ---------------------------------------------------------------------------
# accuracy under k random device deletions (paper Fig. 5/6)
# ---------------------------------------------------------------------------

def _slot_device_names(plan) -> List[List[str]]:
    """Per-slot member device names for a legacy Plan or a PlanIR."""
    if isinstance(plan, PlanIR):
        return [[plan.device_names[n] for n in np.flatnonzero(row)]
                for row in plan.member]
    return [[d.name for d in g.devices] for g in plan.groups]


def sample_failure_masks(plan, n_failed: int, trials: int,
                         rng: np.random.Generator) -> np.ndarray:
    """Draw `trials` random n_failed-device deletions; returns the (T, K)
    arrived mask per trial (a slot arrives while any replica survives).
    Consumes the generator exactly like the seed per-trial loop."""
    slots = _slot_device_names(plan)
    all_devices = [n for names in slots for n in names]
    masks = np.zeros((trials, plan.K), bool)
    for t in range(trials):
        down = set(rng.choice(all_devices,
                              size=min(n_failed, len(all_devices)),
                              replace=False))
        for slot, names in enumerate(slots):
            masks[t, slot] = any(n not in down for n in names)
    return masks


def accuracy_under_failures(plan, accuracy_fn: Callable[[np.ndarray], float],
                            n_failed: int, trials: int = 30, seed: int = 0
                            ) -> float:
    """Paper Fig. 5/6: randomly delete `n_failed` devices, zero the portions
    whose every replica is gone, average accuracy_fn(arrived_mask).

    accuracy_fn (the expensive part: a forward pass over the eval set) is
    called once per UNIQUE arrival mask instead of once per trial; with 8
    devices there are at most 2^K ≪ trials distinct masks, so 10k-trial
    sweeps cost a handful of evaluations. Results are bit-for-bit identical
    to the per-trial loop at a fixed seed."""
    rng = np.random.default_rng(seed)
    masks = sample_failure_masks(plan, n_failed, trials, rng)
    uniq, inverse = np.unique(masks, axis=0, return_inverse=True)
    vals = np.asarray([accuracy_fn(u) for u in uniq], np.float64)
    return float(np.mean(vals[np.ravel(inverse)]))


# ---------------------------------------------------------------------------
# heterogeneous fleet generation (paper §V-A + Table IV)
# ---------------------------------------------------------------------------

def make_fleet(n: int = 8, *, seed: int = 0,
               flops_range: Tuple[float, float] = (5e6, 30e6),
               rate_range: Tuple[float, float] = (0.5e3, 1e3),
               mem_range: Tuple[float, float] = (0.5e6, 4e6),
               success_prob: float = 0.8) -> List[Device]:
    """The paper's setup: 8 devices, 5–30 MFLOPS, 0.5–1 kbps, avg success 0.8."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(Device(
            name=f"d{i}",
            c_core=float(rng.uniform(*flops_range)),
            c_mem=float(rng.uniform(*mem_range)),
            r_tran=float(rng.uniform(*rate_range)),
            p_out=float(np.clip(1 - success_prob + rng.normal(0, 0.05), 0.01, 0.99)),
        ))
    return out


def make_fleet_heterogeneity(level: int, n: int = 8, seed: int = 0,
                             base_flops: float = 5e6,
                             base_rate: float = 300.0) -> List[Device]:
    """Paper Table IV heterogeneity levels 0..5: FLOPS spread 0..30 M and
    data-rate spread 0..500 bps around the base point. Memory is ample and
    uniform — Table IV varies only compute and transmission (the Fig. 7
    mechanism is the compute/link straggler, not the memory bottleneck)."""
    spread_flops = [0, 10e6, 15e6, 20e6, 25e6, 30e6][level]
    spread_rate = [0, 100, 200, 300, 400, 500][level]
    rng = np.random.default_rng(seed)
    base_flops = max(base_flops, spread_flops / 2 + 2e6)  # keep c_core > 0
    base_rate = max(base_rate, spread_rate / 2 + 50.0)
    out = []
    for i in range(n):
        out.append(Device(
            name=f"d{i}",
            c_core=float(base_flops + spread_flops * rng.uniform(-0.5, 0.5)),
            c_mem=4e6,
            r_tran=float(base_rate + spread_rate * rng.uniform(-0.5, 0.5)),
            p_out=float(rng.uniform(0.1, 0.3)),
        ))
    return out
