"""Pluggable failure scenarios for the vectorized Monte-Carlo engine.

The seed simulator modelled only independent crashes + Rayleigh outages
(:class:`repro.core.simulator.FailureModel`). Real edge fleets fail in
richer ways — CoCoI-style stragglers, rack/power-domain blackouts, flapping
radio links — and covering them is tractable now that trials are a single
matrix pass. Every scenario exposes

    sample(rng, arrays: PlanArrays, trials) -> (alive (T, D) bool,
                                                delay  (T, D) float | None)

plus an optional ``deadline`` attribute (trials whose per-device latency
``t + delay`` exceeds it count as missed). :func:`repro.core.simulator.simulate`
and the batched quorum server consume scenarios interchangeably with the
plain ``FailureModel``.

The module also hosts the open-loop request ARRIVAL processes
(:class:`PoissonArrivals`, :class:`MMPPArrivals`) that feed the
continuous-batching serving engine (:mod:`repro.runtime.engine`) —
failure scenarios model the fleet, arrival processes model the traffic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.simulator import FailureModel, PlanArrays


@dataclasses.dataclass
class CorrelatedFailures:
    """Correlated group failures: devices share failure domains (a power rail,
    a rack switch, a cell tower). Each domain blacks out independently with
    ``domain_fail_prob`` per trial, killing EVERY member at once; survivors
    still face the base model's independent crash/outage draws.

    `domains` maps domain name → member device names; devices absent from
    every domain only see the base model."""
    domains: Dict[str, Sequence[str]]
    domain_fail_prob: float = 0.1
    base: FailureModel = dataclasses.field(default_factory=FailureModel)
    deadline: Optional[float] = None

    def sample(self, rng: np.random.Generator, arrays: PlanArrays,
               trials: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        names = list(self.domains)
        down = rng.random((trials, len(names))) < self.domain_fail_prob
        member = np.zeros((len(names), len(arrays.names)), bool)
        for gi, g in enumerate(names):
            members = set(self.domains[g])
            member[gi] = [n in members for n in arrays.names]
        domain_dead = down @ member                  # (T, D) via bool matmul
        alive, delay = self.base.sample(rng, arrays, trials)
        return alive & ~domain_dead, delay


@dataclasses.dataclass
class StragglerScenario:
    """Straggler delay with a deadline timeout: every live device's Eq. 1a
    latency is inflated by a random slowdown (queueing, thermal throttling,
    contention). ``dist`` is ``"lognormal"`` (heavy tail, CoCoI's empirical
    fit) or ``"exponential"``; ``scale`` multiplies the plan's median Eq. 1a
    latency so the knob is fleet-independent. Devices past ``deadline`` miss
    the quorum — replication is what masks them."""
    dist: str = "lognormal"
    sigma: float = 1.0               # lognormal shape
    scale: float = 0.5               # delay scale, × median plan latency
    deadline: Optional[float] = None
    base: FailureModel = dataclasses.field(default_factory=FailureModel)

    def sample(self, rng: np.random.Generator, arrays: PlanArrays,
               trials: int) -> Tuple[np.ndarray, np.ndarray]:
        alive, _ = self.base.sample(rng, arrays, trials)
        D = len(arrays.names)
        unit = self.scale * float(np.median(arrays.t)) if D else 0.0
        if self.dist == "lognormal":
            delay = unit * rng.lognormal(mean=0.0, sigma=self.sigma,
                                         size=(trials, D))
        elif self.dist == "exponential":
            delay = unit * rng.exponential(scale=1.0, size=(trials, D))
        else:
            raise ValueError(f"unknown straggler dist {self.dist!r}")
        return alive, delay


@dataclasses.dataclass
class MarkovLinkScenario:
    """Markov link flapping: each device's uplink is a two-state Gilbert
    chain advanced once per trial (up → down w.p. ``p_fail``, down → up
    w.p. ``p_recover``). The chain is realized as a
    :class:`repro.runtime.failures.FailureInjector` schedule — the same event
    stream drives chaos-testing of the live serving loop — and replayed into
    the (T, D) aliveness matrix. Devices with a down link still obey the base
    model's crash/outage draws while up."""
    p_fail: float = 0.05
    p_recover: float = 0.3
    base: FailureModel = dataclasses.field(default_factory=FailureModel)
    deadline: Optional[float] = None

    def schedule(self, rng: np.random.Generator, names: Sequence[str],
                 trials: int):
        from repro_torch.runtime.failures import markov_flap_schedule
        return markov_flap_schedule(names, self.p_fail, self.p_recover,
                                    trials, rng)

    def sample(self, rng: np.random.Generator, arrays: PlanArrays,
               trials: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        from repro_torch.runtime.failures import FailureInjector
        events = self.schedule(rng, arrays.names, trials)
        up = FailureInjector(events).alive_matrix(arrays.names, trials)
        alive, delay = self.base.sample(rng, arrays, trials)
        return alive & up, delay


# ---------------------------------------------------------------------------
# open-loop request arrival processes (the serving engine's traffic models)
# ---------------------------------------------------------------------------

def _sample_sizes(rng: np.random.Generator, n: int, sizes: Sequence[int],
                  probs: Optional[Sequence[float]]) -> np.ndarray:
    """Draw heterogeneous request sizes (rows per request)."""
    arr = np.asarray(sizes, np.int64)
    if len(arr) == 1:
        return np.full(n, arr[0], np.int64)
    p = None
    if probs is not None:
        p = np.asarray(probs, np.float64)
        p = p / p.sum()
    return rng.choice(arr, size=n, p=p)


@dataclasses.dataclass
class PoissonArrivals:
    """Open-loop Poisson arrival process: exponential inter-arrival gaps at
    ``rate`` requests/second, each request carrying a size (rows) drawn from
    the ``sizes``/``size_probs`` categorical — the memoryless baseline
    traffic model for the continuous-batching engine."""
    rate: float
    sizes: Sequence[int] = (1,)
    size_probs: Optional[Sequence[float]] = None

    def generate(self, rng: np.random.Generator, horizon: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """All arrivals in [0, horizon): (times (R,) sorted, sizes (R,))."""
        if self.rate <= 0 or horizon <= 0:
            return np.zeros(0), np.zeros(0, np.int64)
        times = np.zeros(0, np.float64)
        t_last = 0.0
        while t_last < horizon:
            n = max(int(self.rate * (horizon - t_last) * 1.5) + 16, 16)
            gaps = rng.exponential(1.0 / self.rate, n)
            times = np.concatenate([times, t_last + np.cumsum(gaps)])
            t_last = float(times[-1])
        times = times[times < horizon]
        return times, _sample_sizes(rng, len(times), self.sizes,
                                    self.size_probs)


@dataclasses.dataclass
class MMPPArrivals:
    """Markov-modulated Poisson process (2-state MMPP): a hidden Gilbert
    chain alternates between a calm state and a burst state, dwelling an
    exponential time in each (``dwell`` mean seconds), and requests arrive
    as a Poisson process at the current state's rate. The classic bursty
    edge-traffic model — same mean load as a Poisson process of the
    time-averaged rate but a far higher index of dispersion."""
    rates: Tuple[float, float] = (10.0, 100.0)
    dwell: Tuple[float, float] = (1.0, 0.25)
    sizes: Sequence[int] = (1,)
    size_probs: Optional[Sequence[float]] = None
    start_state: int = 0

    def mean_rate(self) -> float:
        w = np.asarray(self.dwell, np.float64)
        r = np.asarray(self.rates, np.float64)
        return float((w * r).sum() / w.sum())

    def generate(self, rng: np.random.Generator, horizon: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """All arrivals in [0, horizon): (times (R,) sorted, sizes (R,)).
        Within each dwell segment the arrivals are the order statistics of
        uniforms — exactly a conditional Poisson process."""
        if min(self.dwell) <= 0:
            raise ValueError(f"dwell means must be positive, got {self.dwell}"
                             " (a zero dwell would never advance time)")
        chunks: List[np.ndarray] = []
        t, state = 0.0, int(self.start_state)
        while t < horizon:
            seg = float(rng.exponential(self.dwell[state]))
            seg_end = min(t + seg, horizon)
            lam = float(self.rates[state])
            if lam > 0 and seg_end > t:
                n = int(rng.poisson(lam * (seg_end - t)))
                if n:
                    chunks.append(np.sort(rng.uniform(t, seg_end, n)))
            t += seg
            state = 1 - state
        times = (np.concatenate(chunks) if chunks else np.zeros(0))
        return times, _sample_sizes(rng, len(times), self.sizes,
                                    self.size_probs)


@dataclasses.dataclass
class ScheduledScenario:
    """Deterministic replay of a :class:`FailureInjector` event schedule
    (trial/request index = injector tick) — the bridge between chaos-test
    scripts and Monte-Carlo sweeps. Each ``sample`` consumes its window of
    ticks, so sequential ``serve``/``serve_batch`` calls CONTINUE the script
    exactly like the per-request ``tick()`` flow (request 6 of two 5-request
    batches sees tick 6, not tick 1). Optionally composes with a stochastic
    base model."""
    injector: "object"               # repro.runtime.failures.FailureInjector
    base: Optional[FailureModel] = None
    deadline: Optional[float] = None

    def sample(self, rng: np.random.Generator, arrays: PlanArrays,
               trials: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        start = getattr(self.injector, "_count", 0)
        up = self.injector.alive_matrix(arrays.names, trials, start=start)
        self.injector.advance(trials)
        if self.base is None:
            return up, None
        alive, delay = self.base.sample(rng, arrays, trials)
        return alive & up, delay
