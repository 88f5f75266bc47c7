"""Hardware specifications: declared chip constants and fitted device specs.

Two closely-related records live here, both consumed by the roofline and
planning layers:

- :class:`HardwareSpec` — chip-level peak numbers (FLOP/s, HBM bandwidth,
  interconnect bandwidth). ``launch/roofline.py`` converts HLO-derived
  FLOPs/bytes into time against one of these; the TPU v5e constants that
  used to be hard-coded there are now just :data:`TPU_V5E`.

- :class:`DeviceSpec` — a *fitted* per-device latency model
  ``(peak_flops, peak_bw, latency_floor)`` produced by the microbench
  harness (:mod:`repro.launch.microbench`): time portion forwards across
  shapes, take bytes/FLOPs per shape from the compiled HLO, and least
  -squares fit ``t ≈ latency_floor + flops/peak_flops + 8·bytes/peak_bw``.
  A :class:`~repro.core.plan_ir.PlanIR` can carry one spec per device, in
  which case its Eq. 1a latency matrix is the *measured* model rather than
  the declared ``flops/c_core + 8·out_bytes/r_tran`` — and everything
  downstream (planner, ``select_redundancy``, engine SLO admission) plans
  on measured numbers.

``DeviceSpec.from_declared`` maps a declared
:class:`~repro.core.grouping.Device` onto the measured form
(``peak_flops = c_core``, ``peak_bw = r_tran``, zero floor), so a fleet
whose measured specs equal its declared capacities plans *identically* —
the fixed-seed equivalence the tests pin.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Chip-level peak capacities the roofline terms divide by."""

    name: str = "tpu-v5e"
    peak_flops: float = 197e12       # FLOP/s per chip (bf16)
    hbm_bw: float = 819e9            # HBM bytes/s per chip
    link_bw: float = 50e9            # interconnect bytes/s per link
    latency_floor: float = 0.0       # per-launch overhead (s)

    def with_(self, **kw) -> "HardwareSpec":
        """Functional update."""
        return dataclasses.replace(self, **kw)


# The assignment-specified TPU v5e-class constants (previously hard-coded
# as module globals in launch/roofline.py).
TPU_V5E = HardwareSpec()


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Fitted per-device latency model: ``t(flops, xfer_bytes) =
    latency_floor + flops / peak_flops + 8 · xfer_bytes / peak_bw``.

    The ``8 ·`` mirrors Eq. 1a's transmit term (``r_tran`` is declared in
    bits/s), so a spec built by :meth:`from_declared` reproduces the
    declared matrix exactly.
    """

    name: str
    peak_flops: float                # sustained FLOP/s (fitted, not peak-sheet)
    peak_bw: float                   # sustained transfer rate (Eq. 1a units)
    latency_floor: float = 0.0       # fixed per-call overhead (s)
    source: str = "measured"         # "measured" | "declared"

    def latency(self, flops, xfer_bytes):
        """Predicted seconds for one portion forward (array-friendly)."""
        return (self.latency_floor
                + np.asarray(flops, np.float64) / self.peak_flops
                + 8.0 * np.asarray(xfer_bytes, np.float64) / self.peak_bw)

    @classmethod
    def from_declared(cls, device) -> "DeviceSpec":
        """The declared-capacity view of a :class:`Device`: Eq. 1a with
        ``peak_flops = c_core``, ``peak_bw = r_tran`` and no floor."""
        return cls(device.name, float(device.c_core), float(device.r_tran),
                   0.0, source="declared")

    def to_dict(self) -> dict:
        """JSON-friendly record (microbench artifacts)."""
        return {"name": self.name, "peak_flops": self.peak_flops,
                "peak_bw": self.peak_bw, "latency_floor": self.latency_floor,
                "source": self.source}

    @classmethod
    def from_dict(cls, d: dict) -> "DeviceSpec":
        """Inverse of :meth:`to_dict`."""
        return cls(d["name"], float(d["peak_flops"]), float(d["peak_bw"]),
                   float(d.get("latency_floor", 0.0)),
                   d.get("source", "measured"))


def declared_specs(devices: Sequence) -> Tuple[DeviceSpec, ...]:
    """One :meth:`DeviceSpec.from_declared` per fleet device."""
    return tuple(DeviceSpec.from_declared(d) for d in devices)


def measured_latency_matrix(specs: Sequence[DeviceSpec],
                            student_caps: np.ndarray) -> np.ndarray:
    """The measured Eq. 1a analogue, ``(S, N)``: student ``s`` on device
    ``n`` costs ``floor_n + flops_s / peak_flops_n + 8 · out_bytes_s /
    peak_bw_n``. Drop-in replacement for the declared matrix."""
    scaps = np.asarray(student_caps, np.float64).reshape(-1, 4)
    pf = np.array([s.peak_flops for s in specs], np.float64)
    bw = np.array([s.peak_bw for s in specs], np.float64)
    floor = np.array([s.latency_floor for s in specs], np.float64)
    return (floor[None, :]
            + scaps[:, 0:1] / pf[None, :]
            + 8.0 * scaps[:, 2:3] / bw[None, :])


def fit_device_spec(flops: np.ndarray, xfer_bytes: np.ndarray,
                    wall_s: np.ndarray, *, name: str = "host",
                    min_floor: float = 0.0) -> DeviceSpec:
    """Fit ``(peak_flops, peak_bw, latency_floor)`` to measured samples.

    Non-negative least squares on ``t = θ0 + θ1·flops + θ2·8·bytes`` via a
    tiny active-set loop (drop negative coefficients, re-solve): three
    parameters, a handful of samples, exactness over generality. A dropped
    compute or memory coefficient degenerates to an effectively-infinite
    peak (the device is not bound by that resource over the sampled
    shapes); a dropped floor clamps to ``min_floor``.
    """
    f = np.asarray(flops, np.float64).ravel()
    b = np.asarray(xfer_bytes, np.float64).ravel()
    t = np.asarray(wall_s, np.float64).ravel()
    if not (len(f) == len(b) == len(t)) or len(t) == 0:
        raise ValueError("flops/bytes/wall sample vectors must match, non-empty")
    X = np.stack([np.ones_like(t), f, 8.0 * b], axis=1)
    active = [0, 1, 2]
    theta = np.zeros(3)
    for _ in range(3):
        sol, *_ = np.linalg.lstsq(X[:, active], t, rcond=None)
        theta = np.zeros(3)
        theta[active] = sol
        neg = [i for i in active if theta[i] < 0]
        if not neg:
            break
        active = [i for i in active if i not in neg]
        if not active:
            theta = np.zeros(3)
            break
    floor = max(float(theta[0]), min_floor)
    # θ1 = 1/peak_flops, θ2 = 1/peak_bw; a zero coefficient means the term
    # never binds on the sampled shapes — represent as a huge finite peak
    # so downstream ratios stay well-defined
    peak_flops = 1.0 / theta[1] if theta[1] > 0 else 1e30
    peak_bw = 1.0 / theta[2] if theta[2] > 0 else 1e30
    return DeviceSpec(name, peak_flops, peak_bw, floor)


def scaled_fleet_specs(host: DeviceSpec, devices: Sequence,
                       reference_c_core: Optional[float] = None
                       ) -> Tuple[DeviceSpec, ...]:
    """Project one host-measured spec onto a declared heterogeneous fleet.

    Each fleet device keeps its declared capacity *ratios* (``c_core`` and
    ``r_tran`` relative to the reference device) but anchors them to the
    host's measured sustained numbers — the microbench calibrates the
    scale, the declaration keeps the heterogeneity. The host's fitted
    latency floor applies uniformly (launch overhead is per-call, not
    per-capacity)."""
    devices = list(devices)
    if not devices:
        return ()
    ref_core = float(reference_c_core if reference_c_core is not None
                     else max(d.c_core for d in devices))
    ref_tran = max(float(d.r_tran) for d in devices)
    return tuple(
        DeviceSpec(d.name,
                   host.peak_flops * float(d.c_core) / ref_core,
                   host.peak_bw * float(d.r_tran) / ref_tran,
                   host.latency_floor)
        for d in devices)
