"""Failout: training students to degrade gracefully under aliveness masks.

RoCoIn's resilience so far is placement-side — replication, MDS coding,
controller repair — while distillation is failure-blind: students are
trained as if every quorum member always answers. ResiliNet
(arxiv 2002.07386) and DFG (arxiv 1909.00995) show that *failout* —
dropping whole nodes during training — hardens distributed inference well
beyond what redundancy alone buys. This module is the mask-sampling layer
of that objective:

- :func:`enumerate_loss_patterns` lists every ≤r-slot-loss aliveness
  pattern (the all-alive pattern always first, so the failure-free path is
  always part of the objective and never regresses);
- :class:`FailoutSampler` turns a :class:`FailoutConfig` into per-step
  ``(P, K)`` slot-aliveness masks, either by enumeration or by sampling the
  vectorized failure simulator (any :mod:`repro.core.scenarios` scenario)
  and reducing device aliveness to slot arrival with
  :func:`repro.core.simulator.reduce_trials`. Sampling is split
  per-step from a deterministic ``(seed, step)`` stream so runs are
  bit-reproducible;
- :class:`RobustnessCurve` is the measured accuracy-vs-#losses export the
  planner consumes (:func:`repro.core.planner.thin_replicas`): a
  failout-trained ensemble that tolerates ℓ losses within ``max_acc_drop``
  can legitimately ship with fewer replicas per group.

The merged-loss side (vmapping the quorum merge + FC head over the leading
pattern axis) lives in :func:`repro.core.distill.failout_merged_loss`; the
training loops that consume it are
:func:`repro.core.pipeline.failout_finetune` (CNN student zoos) and
:func:`repro.core.lm_students.failout_finetune_lm` (LM students).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class FailoutConfig:
    """How aliveness masks are drawn inside the distillation step.

    mode:
      - ``"enumerate"``: every pattern with 1..``max_losses`` slot losses
        (plus all-alive), exact and step-independent — the default for the
        small K the paper's fleets produce. ``max_losses=0`` degenerates to
        failure-blind training through the same code path (the equal-compute
        baseline the benchmarks compare against).
      - ``"scenario"``: ``n_samples`` patterns per step drawn from a
        failure scenario (anything exposing ``sample(rng, arrays, trials)``)
        against the plan's :class:`~repro.core.simulator.PlanArrays`,
        reduced to slot-arrival masks. Beyond-quorum-distance patterns are
        kept — the hardened merge defines them (zero features → FC bias).

    The all-alive pattern is ALWAYS included as pattern 0 with weight
    ``alive_weight`` (the remaining mass is split uniformly over the loss
    patterns), so the failure-free prediction stays in the objective.
    ``seed`` + the step index fully determine every mask draw."""
    mode: str = "enumerate"
    max_losses: int = 1
    n_samples: int = 4
    scenario: Any = None
    seed: int = 0
    alive_weight: float = 0.5
    steps: int = 60

    def __post_init__(self):
        if self.mode not in ("enumerate", "scenario"):
            raise ValueError(f"unknown failout mode {self.mode!r}")
        if self.mode == "scenario" and self.scenario is None:
            raise ValueError("mode='scenario' needs a failure scenario")
        if not 0.0 < self.alive_weight <= 1.0:
            raise ValueError("alive_weight must be in (0, 1]")


def enumerate_loss_patterns(K: int, max_losses: int) -> np.ndarray:
    """All slot-aliveness patterns with at most ``max_losses`` losses.

    Returns ``(P, K)`` bool — row 0 is all-alive, then every
    ``C(K, l)``-combination for l = 1..min(max_losses, K) in deterministic
    lexicographic order. ``max_losses >= K`` includes the all-dead pattern
    (defined by the hardened merge, not an error)."""
    rows = [np.ones(K, bool)]
    for losses in range(1, min(max_losses, K) + 1):
        for combo in itertools.combinations(range(K), losses):
            m = np.ones(K, bool)
            m[list(combo)] = False
            rows.append(m)
    return np.stack(rows) if rows else np.zeros((0, K), bool)


class FailoutSampler:
    """Per-step mask source bound to one plan: ``masks(step) -> (P, K)``.

    ``P`` is constant across steps (one jit compilation of the training
    step). Enumerate mode returns the same pattern set each step; scenario
    mode draws ``n_samples`` fresh device-aliveness rows per step from
    ``np.random.default_rng((seed, step))`` — deterministic per
    ``(config, step)`` regardless of call order — and reduces them to slot
    arrival through the plan's replica layout (a slot is alive while any
    replica is), always prepending the all-alive row."""

    def __init__(self, cfg: FailoutConfig, n_slots: int, arrays=None):
        self.cfg = cfg
        self.K = int(n_slots)
        self.arrays = arrays
        if cfg.mode == "enumerate":
            self._fixed = enumerate_loss_patterns(self.K, cfg.max_losses)
        else:
            if arrays is None:
                raise ValueError(
                    "scenario failout needs the plan's PlanArrays "
                    "(repro.core.simulator.plan_arrays)")
            self._fixed = None

    @property
    def n_patterns(self) -> int:
        if self._fixed is not None:
            return int(self._fixed.shape[0])
        return 1 + int(self.cfg.n_samples)

    def masks(self, step: int) -> np.ndarray:
        if self._fixed is not None:
            return self._fixed
        from repro_torch.core.simulator import reduce_trials
        rng = np.random.default_rng((self.cfg.seed, int(step)))
        alive, delay = self.cfg.scenario.sample(rng, self.arrays,
                                                self.cfg.n_samples)
        _, arrived, _ = reduce_trials(
            self.arrays, alive, delay,
            getattr(self.cfg.scenario, "deadline", None))
        return np.concatenate([np.ones((1, self.K), bool),
                               arrived[:, :self.K]], axis=0)

    def weights(self) -> np.ndarray:
        """(P,) pattern weights: ``alive_weight`` on the all-alive pattern,
        the rest uniform over the loss patterns. Sums to 1."""
        P = self.n_patterns
        if P == 1:
            return np.ones(1)
        w = np.full(P, (1.0 - self.cfg.alive_weight) / (P - 1))
        w[0] = self.cfg.alive_weight
        return w


# ---------------------------------------------------------------------------
# the measured robustness curve the planner consumes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RobustnessCurve:
    """Measured accuracy vs #slot losses for one trained ensemble.

    ``accuracy[l]`` is the MEAN accuracy over every exactly-l-slot-loss
    pattern and ``worst[l]`` the minimum — the planner's thinning decision
    (:func:`repro.core.planner.thin_replicas`) keys on the worst case, so a
    single fragile partition blocks the trade. ``losses[0] == 0`` is the
    all-alive baseline."""
    losses: np.ndarray           # (L+1,) ints 0..L
    accuracy: np.ndarray         # (L+1,) mean accuracy per loss count
    worst: np.ndarray            # (L+1,) min accuracy per loss count

    def __post_init__(self):
        object.__setattr__(self, "losses", np.asarray(self.losses, np.int64))
        object.__setattr__(self, "accuracy",
                           np.asarray(self.accuracy, np.float64))
        object.__setattr__(self, "worst", np.asarray(self.worst, np.float64))
        if not (len(self.losses) == len(self.accuracy) == len(self.worst)):
            raise ValueError("curve arrays must share one length")
        if len(self.losses) == 0 or self.losses[0] != 0:
            raise ValueError("curve must start at the all-alive point")

    def drop(self) -> np.ndarray:
        """(L+1,) worst-case accuracy drop vs the all-alive baseline."""
        return self.accuracy[0] - self.worst

    def tolerated(self, max_acc_drop: float) -> int:
        """Largest l such that EVERY loss count 1..l stays within
        ``max_acc_drop`` of the all-alive accuracy (worst-case pattern) —
        the contiguous-prefix rule keeps the guarantee monotone."""
        d = self.drop()
        tol = 0
        for l in range(1, len(d)):
            if d[l] <= max_acc_drop + 1e-12:
                tol = int(self.losses[l])
            else:
                break
        return tol


def measure_robustness_curve(accuracy_fn: Callable[[np.ndarray], float],
                             n_slots: int, max_losses: int,
                             patterns: Optional[Sequence[np.ndarray]] = None
                             ) -> RobustnessCurve:
    """Evaluate ``accuracy_fn(arrived_mask)`` over every ≤``max_losses``
    slot-loss pattern and fold into a :class:`RobustnessCurve`.

    ``accuracy_fn`` is the expensive part (a forward pass over the eval
    set); with the paper-scale K it runs ``Σ C(K, l)`` times. An explicit
    ``patterns`` sequence overrides the exhaustive enumeration (e.g. a
    sampled subset at large K)."""
    masks = (np.stack([np.asarray(p, bool) for p in patterns])
             if patterns is not None
             else enumerate_loss_patterns(n_slots, max_losses))
    n_lost = (~masks).sum(axis=1)
    accs = np.asarray([accuracy_fn(m) for m in masks], np.float64)
    losses: List[int] = sorted(set(int(l) for l in n_lost))
    mean = np.asarray([accs[n_lost == l].mean() for l in losses])
    worst = np.asarray([accs[n_lost == l].min() for l in losses])
    return RobustnessCurve(np.asarray(losses), mean, worst)
