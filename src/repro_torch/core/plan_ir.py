"""Canonical array-backed plan intermediate representation (PlanIR).

Before this module the plan existed in three private, mutually-inconsistent
encodings: the planner's object graph (``planner.Plan`` → ``GroupPlan`` →
``Device``/``StudentArch``), the Monte-Carlo engine's flattened replica view
(``simulator.PlanArrays``), and the quorum server's lazily-rebuilt
``_arrays`` cache. :class:`PlanIR` replaces them with one frozen, array-backed
record from which every other view is derived:

  - device catalogue: names + a ``(N, 4)`` capacity matrix
    (``c_core, c_mem, r_tran, p_out``),
  - student catalogue: names + a ``(S, 4)`` profile matrix
    (``flops, params, out_bytes, capacity``),
  - ``member``   ``(K, N)`` bool — group membership (slot-major; slot k
    serves partition k),
  - ``partition`` ``(K, M)`` bool — knowledge-partition filter masks,
  - ``student_of`` ``(K,)`` int — student index per slot (−1 = none),
  - ``latency_nd`` ``(S, N)`` — the precomputed Eq. 1a latency matrix
    ``flops_s / c_core_n + 8 · out_bytes_s / r_tran_n``.

All arrays are defensively copied and frozen (read-only) at construction;
"mutation" is :meth:`with_` / :meth:`drop_device`, which return new IRs.
Legacy interop: :meth:`from_plan` / :meth:`to_plan` round-trip the object
graph, :meth:`to_arrays` derives the Monte-Carlo ``PlanArrays`` view.

Redundancy is per-group: by default every slot replicates its student
across its members (the paper's scheme). An optional ``coding`` field
(:class:`repro.coding.spec.CodingSpec`) switches chosen groups to
erasure-coded mode — ``redundancy_modes()`` reports ``"replicate"`` or
``"coded(n,k)"`` per slot — where a coded group's ``k`` slots plus
``n - k`` parity shares form a systematic MDS code: the slot's portion is
recoverable while its own share OR any ``k`` of the group's ``n`` shares
arrive. Latency (k-th order statistic of share arrivals), quorum, the
Eq. 1f outage analogue (a Poisson-binomial shortfall), the Fig. 4 profile
and the Monte-Carlo view all account for parity shares.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.coding.compute import ComputeCodingSpec
from repro_torch.coding.spec import CodingSpec
from repro_torch.core.assignment import StudentArch
from repro_torch.core.grouping import Device
from repro_torch.core.hwspec import DeviceSpec, measured_latency_matrix

DEVICE_COLS = ("c_core", "c_mem", "r_tran", "p_out")
STUDENT_COLS = ("flops", "params", "out_bytes", "capacity")


def device_matrix(devices: Sequence[Device]) -> Tuple[Tuple[str, ...], np.ndarray]:
    """Pack Device objects into (names, (N, 4) float64 matrix)."""
    names = tuple(d.name for d in devices)
    caps = np.array([[d.c_core, d.c_mem, d.r_tran, d.p_out] for d in devices],
                    np.float64).reshape(len(names), 4)
    return names, caps


def student_matrix(students: Sequence[StudentArch]
                   ) -> Tuple[Tuple[str, ...], np.ndarray]:
    """Pack StudentArch objects into (names, (S, 4) float64 matrix)."""
    names = tuple(s.name for s in students)
    caps = np.array([[s.flops, s.params, s.out_bytes, s.capacity]
                     for s in students], np.float64).reshape(len(names), 4)
    return names, caps


def eq1a_latency(student_caps: np.ndarray, device_caps: np.ndarray,
                 device_specs: Optional[Sequence[DeviceSpec]] = None
                 ) -> np.ndarray:
    """Eq. 1a latency matrix (S, N): flops/c_core + 8·out_bytes/r_tran.

    Measured mode: pass fitted ``device_specs`` (one per device column) and
    the matrix is ``latency_floor + flops/peak_flops + 8·out_bytes/peak_bw``
    instead of the declared-capacity model — same shape, same consumers.
    A spec built by :meth:`DeviceSpec.from_declared` reproduces the
    declared matrix exactly."""
    scaps = np.asarray(student_caps, np.float64).reshape(-1, 4)
    dcaps = np.asarray(device_caps, np.float64).reshape(-1, 4)
    if device_specs is not None:
        if len(device_specs) != dcaps.shape[0]:
            raise ValueError(
                f"{len(device_specs)} device specs for {dcaps.shape[0]} "
                "devices")
        return measured_latency_matrix(device_specs, scaps)
    return (scaps[:, 0:1] / dcaps[None, :, 0]
            + 8.0 * scaps[:, 2:3] / dcaps[None, :, 2])


@dataclasses.dataclass(frozen=True)
class PlanIR:
    device_names: Tuple[str, ...]        # (N,)
    device_caps: np.ndarray              # (N, 4) DEVICE_COLS
    student_names: Tuple[str, ...]       # (S,)
    student_caps: np.ndarray             # (S, 4) STUDENT_COLS
    member: np.ndarray                   # (K, N) bool
    partition: np.ndarray                # (K, M) bool
    student_of: np.ndarray               # (K,) int64, -1 = no student
    group_idx: np.ndarray                # (K,) int64 legacy group ids
    latency_nd: np.ndarray               # (S, N) Eq. 1a matrix
    A: np.ndarray                        # (M, M) activation graph
    d_th: float
    p_th: float
    # per-group redundancy layout: None = pure replication (the default);
    # a CodingSpec marks chosen groups as erasure-coded and places their
    # parity shares (see repro.coding)
    coding: Optional[CodingSpec] = None
    # intermediate-computation coding: chosen slots split their own matmul
    # into (n, k) compute shards, one per member device (repro.coding
    # .compute). Mutually exclusive with ``coding``.
    compute_coding: Optional[ComputeCodingSpec] = None
    # measured mode: fitted per-device specs (repro.core.hwspec.DeviceSpec,
    # one per device column). When present, ``latency_nd`` is the
    # measured-model matrix and ``latency_source`` reports "measured" —
    # the planner, coding mode-selection and engine admission then all
    # consume microbenched numbers instead of declared capacities.
    device_specs: Optional[Tuple[DeviceSpec, ...]] = None

    def __post_init__(self):
        N, S = len(self.device_names), len(self.student_names)
        specs = [
            ("device_caps", np.float64, (N, 4)),
            ("student_caps", np.float64, (S, 4)),
            ("member", bool, None),
            ("partition", bool, None),
            ("student_of", np.int64, None),
            ("group_idx", np.int64, None),
            ("latency_nd", np.float64, (S, N)),
            ("A", np.float64, None),
        ]
        for field, dtype, shape in specs:
            arr = np.array(getattr(self, field), dtype=dtype, copy=True)
            if shape is not None:
                arr = arr.reshape(shape)
            arr.setflags(write=False)
            object.__setattr__(self, field, arr)
        object.__setattr__(self, "device_names", tuple(self.device_names))
        object.__setattr__(self, "student_names", tuple(self.student_names))
        object.__setattr__(self, "d_th", float(self.d_th))
        object.__setattr__(self, "p_th", float(self.p_th))
        if self.device_specs is not None:
            object.__setattr__(self, "device_specs", tuple(self.device_specs))

    # -- shape accessors -----------------------------------------------------

    @property
    def K(self) -> int:
        return int(self.member.shape[0])

    @property
    def N(self) -> int:
        return len(self.device_names)

    @property
    def M(self) -> int:
        return int(self.partition.shape[1])

    @property
    def S(self) -> int:
        return len(self.student_names)

    @property
    def latency_source(self) -> str:
        """``"measured"`` when fitted device specs back ``latency_nd``,
        ``"declared"`` for the paper's capacity-derived matrix."""
        return "measured" if self.device_specs is not None else "declared"

    def with_measured_latency(self, specs: Sequence[DeviceSpec]) -> "PlanIR":
        """The same plan re-anchored to fitted device specs: ``latency_nd``
        is recomputed from ``specs`` (order must match ``device_names``)
        and the specs ride along so :meth:`validate` can re-derive it.
        Every latency consumer — :meth:`objective`, :meth:`group_latency`,
        :meth:`to_arrays`, the planner and ``select_redundancy`` — then
        sees measured numbers."""
        specs = tuple(specs)
        return self.with_(
            latency_nd=eq1a_latency(self.student_caps, self.device_caps,
                                    specs),
            device_specs=specs)

    # -- objective / constraints (Eq. 1a, 1f, 1g) ----------------------------

    def _member_latency(self, member: np.ndarray, students: np.ndarray,
                        alive: Optional[np.ndarray]) -> np.ndarray:
        """Min Eq. 1a latency over each row's (live) placements; ∞ for
        student-less or (live-)empty rows."""
        if not self.N:
            return np.full(len(students), np.inf)
        lat = np.where(students[:, None] >= 0,
                       self.latency_nd[np.maximum(students, 0)], np.inf)
        m = member if alive is None else member & alive[None, :]
        return np.where(m, lat, np.inf).min(axis=1)

    def share_latencies(self, alive: Optional[np.ndarray] = None
                        ) -> np.ndarray:
        """(K + P,) per-share arrival latency: shares 0..K-1 are the slots'
        systematic shares, the rest the coding spec's parity shares."""
        base = self._member_latency(self.member, self.student_of, alive)
        cs = self.coding
        if cs is None or not cs.P:
            return base
        par = self._member_latency(cs.parity_member, cs.parity_student, alive)
        return np.concatenate([base, par])

    def group_latency(self, alive: Optional[np.ndarray] = None) -> np.ndarray:
        """(K,) Eq. 1a inner: min over (live) members of the slot student's
        latency; ∞ for student-less or (live-)empty slots. A coded slot is
        additionally served once its group can decode — the k-th smallest
        (live) share arrival — so parity can mask a dead systematic share
        (or a merely SLOW one: the coded objective is never worse than the
        replicated one, and can beat it)."""
        cs = self.coding
        cc = self.compute_coding
        if (cs is None or not cs.n_groups) and (cc is None or not cc.Q):
            return self._member_latency(self.member, self.student_of, alive)
        share = self.share_latencies(alive)
        base = share[:self.K]
        out = np.array(base)
        if cs is not None:
            for c in range(cs.n_groups):
                _, k = cs.code_nk(c)
                slots = cs.group_slots(c)
                rec = np.sort(share[cs.group_shares(c)])[k - 1]
                out[slots] = np.minimum(base[slots], rec)
        if cc is not None:
            for q, tt in enumerate(self.compute_shard_latencies(alive)):
                k = int(cc.k[q])
                s = int(cc.slots[q])
                srt = np.sort(tt)
                out[s] = srt[k - 1] if srt.size >= k else np.inf
        return out

    def compute_shard_latencies(self, alive: Optional[np.ndarray] = None
                                ) -> Tuple[np.ndarray, ...]:
        """Per compute-coded slot, the (live) shard arrival latencies in
        generator-row order: ``latency_nd[stu, dev] / k`` (Eq. 1a with both
        the FLOP and transmit terms cut by the 1/k output split); ∞ for
        unplaced or dead shards."""
        cc = self.compute_coding
        if cc is None:
            return ()
        out = []
        for q in range(cc.Q):
            s = int(cc.slots[q])
            stu = int(self.student_of[s])
            mem = cc.shard_member[q]
            k = int(cc.k[q])
            tt = np.full(len(mem), np.inf)
            for i, n in enumerate(mem):
                if n < 0 or stu < 0:
                    continue
                if alive is not None and not alive[n]:
                    continue
                tt[i] = float(self.latency_nd[stu, n]) / k
            out.append(tt)
        return tuple(out)

    def objective(self, alive: Optional[np.ndarray] = None) -> float:
        """Eq. 1a outer: blocked by the slowest slot (∞ if any slot serves
        nothing)."""
        if self.K == 0:
            return float("inf")
        return float(self.group_latency(alive).max())

    @property
    def latency(self) -> float:
        return self.objective()

    def group_outage(self, alive: Optional[np.ndarray] = None) -> np.ndarray:
        """(K,) Eq. 1f: Π p_out over (live) members; 1.0 for empty slots.
        For a coded slot the analogue is the exact Poisson-binomial
        shortfall: P(own share misses AND fewer than k of the group's other
        shares arrive)."""
        m = self.member if alive is None else self.member & alive[None, :]
        p_out = self.device_caps[None, :, 3]
        out = np.where(m, p_out, 1.0).prod(axis=1)
        if self.compute_coding is not None and self.compute_coding.Q:
            out = self._compute_outage(out, alive)
        cs = self.coding
        if cs is None or not cs.n_groups:
            return out
        pm = cs.parity_member if alive is None else \
            cs.parity_member & alive[None, :]
        par_out = np.where(pm, p_out, 1.0).prod(axis=1) if cs.P else \
            np.zeros(0)
        arrive = 1.0 - np.concatenate([out, par_out])
        for k in np.flatnonzero(cs.group_of >= 0):
            out[k] = cs.slot_shortfall(int(k), arrive)
        return out

    def _compute_outage(self, out: np.ndarray,
                        alive: Optional[np.ndarray]) -> np.ndarray:
        """Overwrite compute-coded slots with the Eq. 1f coded analogue:
        P(fewer than k of the slot's placed, live shards arrive)."""
        cc = self.compute_coding
        p_out = np.array(self.device_caps[:, 3])
        if alive is not None:
            p_out = np.where(alive, p_out, 1.0)
        for q in range(cc.Q):
            out[int(cc.slots[q])] = cc.slot_shortfall(q, p_out)
        return out

    def quorum(self, alive: Optional[np.ndarray] = None) -> np.ndarray:
        """(K,) bool — the slot's portion is obtainable: at least one (live)
        member, or — for a coded slot — at least k of its group's n shares
        still placeable on (live) devices."""
        m = self.member if alive is None else self.member & alive[None, :]
        ok = m.any(axis=1)
        cc = self.compute_coding
        if cc is not None and cc.Q:
            ok = np.array(ok)
            for q in range(cc.Q):
                mem = cc.shard_member[q]
                placed = mem[mem >= 0]
                if alive is not None:
                    placed = placed[alive[placed]]
                ok[int(cc.slots[q])] = placed.size >= int(cc.k[q])
        cs = self.coding
        if cs is None or not cs.n_groups:
            return ok
        pm = cs.parity_member if alive is None else \
            cs.parity_member & alive[None, :]
        share_live = np.concatenate([ok, pm.any(axis=1) if cs.P
                                     else np.zeros(0, bool)])
        out = np.array(ok)
        for c in range(cs.n_groups):
            _, k = cs.code_nk(c)
            if int(share_live[cs.group_shares(c)].sum()) >= k:
                out[cs.group_slots(c)] = True
        return out

    @property
    def feasible(self) -> bool:
        return bool(self.K > 0
                    and (self.student_of >= 0).all()
                    and self.quorum().all()
                    and (self.group_outage() <= self.p_th).all())

    def total_params(self) -> float:
        """S-Total: all student replicas, plus parity-share networks (Fig. 4)."""
        has = self.student_of >= 0
        params = self.student_caps[np.maximum(self.student_of, 0), 1]
        total = float((params * self.member.sum(axis=1) * has).sum())
        cs = self.coding
        if cs is not None and cs.P:
            pp = self.student_caps[np.maximum(cs.parity_student, 0), 1]
            total += float((pp * cs.parity_member.sum(axis=1)).sum())
        total += self._compute_overhead(params)
        return total

    def _compute_overhead(self, per_replica: np.ndarray) -> float:
        """Correction replacing a compute-coded slot's ``n × cost`` member
        accounting with ``n/k ×`` — each shard holds/computes 1/k of the
        portion."""
        cc = self.compute_coding
        if cc is None or not cc.Q:
            return 0.0
        delta = 0.0
        for q in range(cc.Q):
            s = int(cc.slots[q])
            if self.student_of[s] < 0:
                continue
            mem = cc.shard_member[q]
            placed = int((mem >= 0).sum())
            k = int(cc.k[q])
            delta += float(per_replica[s]) * placed * (1.0 / k - 1.0)
        return delta

    def deployed_compute(self) -> float:
        """Aggregate deployed compute (shares × portion FLOPs): every
        placed replica or parity share costs its student's forward FLOPs —
        the redundancy-efficiency axis ``benchmarks/bench_coding.py``
        sweeps (replicate-K pays group-size×, coded-(n,k) pays n/k×)."""
        has = self.student_of >= 0
        fl = self.student_caps[np.maximum(self.student_of, 0), 0]
        total = float((fl * self.member.sum(axis=1) * has).sum())
        cs = self.coding
        if cs is not None and cs.P:
            pf = self.student_caps[np.maximum(cs.parity_student, 0), 0]
            total += float((pf * cs.parity_member.sum(axis=1)).sum())
        total += self._compute_overhead(fl)
        return total

    def redundancy_modes(self) -> Tuple[str, ...]:
        """Per-slot mode: ``"replicate"``, ``"coded(n,k)"`` (output coding)
        or ``"coded_compute(n,k)"`` (intermediate-computation coding)."""
        if self.coding is not None:
            return self.coding.modes()
        if self.compute_coding is not None:
            cm = self.compute_coding.modes()
            return tuple(cm.get(k, "replicate") for k in range(self.K))
        return ("replicate",) * self.K

    def valid_params(self) -> float:
        """S-Valid: one replica per partition (Fig. 4)."""
        has = self.student_of >= 0
        params = self.student_caps[np.maximum(self.student_of, 0), 1]
        return float((params * has).sum())

    def partition_sizes(self) -> np.ndarray:
        """C^para proxy per slot: degree-mass volume, normalized to Σ = 1
        (same quantity as :func:`planner.partition_sizes`)."""
        vols = np.array([self.A[np.flatnonzero(row)].sum()
                         for row in self.partition], np.float64)
        return vols / max(vols.sum(), 1e-12)

    def alive_mask(self, down_names: Sequence[str]) -> np.ndarray:
        down = set(down_names)
        return np.array([n not in down for n in self.device_names], bool)

    def summary(self) -> Dict:
        has = self.student_of >= 0
        return {
            "K": self.K,
            "latency": self.objective(),
            "feasible": self.feasible,
            "s_total": self.total_params(),
            "s_valid": self.valid_params(),
            "group_sizes": self.member.sum(axis=1).tolist(),
            "students": [self.student_names[s] if ok else None
                         for s, ok in zip(self.student_of, has)],
            "modes": list(self.redundancy_modes()),
            "deployed_compute": self.deployed_compute(),
        }

    def validate(self) -> "PlanIR":
        """Structural invariants: disjoint membership, disjoint + covering
        partitions, indices in range. Returns self for chaining."""
        if (self.member.sum(axis=0) > 1).any():
            raise ValueError("a device belongs to more than one group")
        if (self.partition.sum(axis=0) > 1).any():
            raise ValueError("a filter belongs to more than one partition")
        if self.K and not self.partition.any(axis=0).all():
            raise ValueError("partitions do not cover all filters")
        if (self.student_of >= self.S).any():
            raise ValueError("student index out of range")
        if self.coding is not None:
            self.coding.validate(self.member)
            if self.coding.P and (self.coding.parity_student >= self.S).any():
                raise ValueError("parity-share student index out of range")
        if self.compute_coding is not None:
            if self.coding is not None:
                raise ValueError(
                    "a plan carries either output coding or compute coding, "
                    "not both")
            self.compute_coding.validate(self.member)
        if self.device_specs is not None:
            if len(self.device_specs) != self.N:
                raise ValueError(
                    f"{len(self.device_specs)} device specs for "
                    f"{self.N} devices")
            want = eq1a_latency(self.student_caps, self.device_caps,
                                self.device_specs)
            if not np.allclose(self.latency_nd, want, rtol=1e-9, atol=0.0):
                raise ValueError(
                    "latency_nd disagrees with the attached device specs")
        return self

    # -- functional updates --------------------------------------------------

    def with_(self, **changes) -> "PlanIR":
        """Functional update (frozen arrays are re-copied by __post_init__)."""
        return dataclasses.replace(self, **changes)

    def drop_device(self, name: str) -> "PlanIR":
        """Permanent loss: remove the device column everywhere (parity
        placements included)."""
        if name not in self.device_names:
            return self
        keep = np.array([n != name for n in self.device_names], bool)
        coding = self.coding
        if coding is not None and coding.P:
            coding = coding.drop_device(int(np.flatnonzero(~keep)[0]))
        compute_coding = self.compute_coding
        if compute_coding is not None:
            compute_coding = compute_coding.drop_device(
                int(np.flatnonzero(~keep)[0]))
        specs = self.device_specs
        if specs is not None:
            specs = tuple(s for s, k in zip(specs, keep) if k)
        return self.with_(
            device_names=tuple(n for n in self.device_names if n != name),
            device_caps=self.device_caps[keep],
            member=self.member[:, keep],
            latency_nd=self.latency_nd[:, keep],
            coding=coding,
            compute_coding=compute_coding,
            device_specs=specs,
        )

    def add_devices(self, devices: Sequence[Device],
                    specs: Optional[Sequence[DeviceSpec]] = None
                    ) -> "PlanIR":
        """Widen the device axis with new UNASSIGNED columns — how a tenant
        plan gains visibility of the fleet's shared spare pool without any
        placement changing. New columns carry no membership, no parity
        share and no compute shard; ``latency_nd`` grows the matching
        Eq. 1a columns (from ``specs`` when this IR runs the measured
        model, from declared capacities otherwise — missing specs fall
        back to :meth:`DeviceSpec.from_declared`). Devices already in the
        catalogue are skipped, so re-offering the same spare pool is
        idempotent."""
        have = set(self.device_names)
        fresh = [d for d in devices if d.name not in have]
        if not fresh:
            return self
        by_name = ({s.name: s for s in specs} if specs is not None else {})
        new_names, new_caps = device_matrix(fresh)
        kw: Dict = {
            "device_names": self.device_names + new_names,
            "device_caps": np.concatenate([self.device_caps, new_caps]),
            "member": np.concatenate(
                [self.member, np.zeros((self.K, len(fresh)), bool)], axis=1),
        }
        if self.device_specs is not None:
            new_specs = tuple(by_name.get(d.name, DeviceSpec.from_declared(d))
                              for d in fresh)
            kw["device_specs"] = self.device_specs + new_specs
            new_cols = eq1a_latency(self.student_caps, new_caps, new_specs)
        else:
            new_cols = eq1a_latency(self.student_caps, new_caps)
        kw["latency_nd"] = np.concatenate([self.latency_nd, new_cols],
                                          axis=1)
        if self.coding is not None and self.coding.P:
            pm = np.concatenate(
                [self.coding.parity_member,
                 np.zeros((self.coding.P, len(fresh)), bool)], axis=1)
            kw["coding"] = self.coding.with_(parity_member=pm)
        # compute_coding stores device *indices*; appending columns at the
        # end leaves every existing index valid
        return self.with_(**kw)

    def fleet_slice(self, names: Sequence[str]) -> "PlanIR":
        """Tenant view of a fleet-wide catalogue: restrict the device axis
        to ``names`` (this IR's column order is preserved). Placements on
        devices outside the slice are dropped — the fleet builder slices
        along assignment boundaries, so a tenant's plan stays independently
        valid and two tenants' slices share no assigned column. Unknown
        names raise."""
        want = set(names)
        missing = want - set(self.device_names)
        if missing:
            raise KeyError(f"unknown devices in slice: {sorted(missing)}")
        out = self
        for n in self.device_names:
            if n not in want:
                out = out.drop_device(n)
        return out.validate()

    # -- reconstruction of the object views ----------------------------------

    def devices(self) -> Tuple[Device, ...]:
        return tuple(Device(n, *map(float, self.device_caps[i]))
                     for i, n in enumerate(self.device_names))

    def students(self) -> Tuple[StudentArch, ...]:
        return tuple(StudentArch(n, *map(float, self.student_caps[i]))
                     for i, n in enumerate(self.student_names))

    # -- legacy interop ------------------------------------------------------

    @classmethod
    def from_plan(cls, plan, students: Optional[Sequence[StudentArch]] = None,
                  devices: Optional[Sequence[Device]] = None,
                  device_specs: Optional[Sequence[DeviceSpec]] = None
                  ) -> "PlanIR":
        """Build the canonical IR from a legacy ``planner.Plan``. Slots are
        ordered by partition index. `students`/`devices` widen the catalogues
        beyond what the plan references (e.g. the full zoo / fleet).
        ``device_specs`` (order matching the device catalogue) switches
        ``latency_nd`` to the measured model."""
        groups = sorted(plan.groups, key=lambda g: g.partition_idx)
        if devices is None:
            seen: Dict[str, Device] = {}
            for g in groups:
                for d in g.devices:
                    seen.setdefault(d.name, d)
            devices = list(seen.values())
        if students is None:
            sd: Dict[str, StudentArch] = {}
            for g in groups:
                if g.student is not None:
                    sd.setdefault(g.student.name, g.student)
            students = list(sd.values())
        names, dcaps = device_matrix(devices)
        snames, scaps = student_matrix(students)
        col = {n: i for i, n in enumerate(names)}
        sidx = {n: i for i, n in enumerate(snames)}
        A = np.asarray(plan.A, np.float64)
        M, K, N = A.shape[0], len(groups), len(names)
        member = np.zeros((K, N), bool)
        partition = np.zeros((K, M), bool)
        student_of = np.full(K, -1, np.int64)
        group_idx = np.zeros(K, np.int64)
        for k, g in enumerate(groups):
            for d in g.devices:
                member[k, col[d.name]] = True
            partition[k, np.asarray(g.filters, np.int64)] = True
            if g.student is not None:
                student_of[k] = sidx[g.student.name]
            group_idx[k] = g.group_idx
        return cls(names, dcaps, snames, scaps, member, partition, student_of,
                   group_idx, eq1a_latency(scaps, dcaps, device_specs), A,
                   float(plan.d_th), float(plan.p_th),
                   device_specs=(tuple(device_specs)
                                 if device_specs is not None else None))

    def to_plan(self, devices: Optional[Sequence[Device]] = None,
                students: Optional[Sequence[StudentArch]] = None):
        """Rebuild the legacy object graph (slot k → partition_idx k).
        `devices`/`students` supply the original objects (matched by name);
        otherwise equal-valued objects are reconstructed from the arrays.
        The object graph predates the coding subsystem, so an attached
        ``coding`` spec does not survive the round trip."""
        from repro_torch.core import planner as PL
        dev_by_name = {d.name: d for d in (devices or ())}
        stu_by_name = {s.name: s for s in (students or ())}
        devs = [dev_by_name.get(n, d) for n, d in
                zip(self.device_names, self.devices())]
        studs = [stu_by_name.get(n, s) for n, s in
                 zip(self.student_names, self.students())]
        groups = []
        for k in range(self.K):
            s = int(self.student_of[k])
            groups.append(PL.GroupPlan(
                group_idx=int(self.group_idx[k]),
                devices=[devs[n] for n in np.flatnonzero(self.member[k])],
                partition_idx=k,
                filters=np.flatnonzero(self.partition[k]),
                student=studs[s] if s >= 0 else None,
            ))
        return PL.Plan(groups, np.array(self.A), self.d_th, self.p_th)

    def to_arrays(self):
        """Derive the Monte-Carlo ``PlanArrays`` view (flattened replica
        devices; student-less slots keep their slot but contribute no
        columns — same contract as the legacy ``simulator.plan_arrays``).
        Coded plans append one column per parity-share placement (marked
        ``slot = -1``) and attach the :class:`~repro.core.simulator
        .ShareLayout` that lets ``reduce_trials`` score ≥k-of-n recovery."""
        from repro_torch.core.simulator import PlanArrays, ShareLayout
        t, slot, p_out, names = [], [], [], []
        cs = self.coding if (self.coding is not None
                             and self.coding.n_groups) else None
        cc = self.compute_coding if (self.compute_coding is not None
                                     and self.compute_coding.Q) else None
        R = self.K + (cs.P if cs is not None else 0)
        share_cols: list = [[] for _ in range(R)]
        compute_slots = set(int(s) for s in cc.slots) if cc is not None else ()
        for k in range(self.K):
            s = int(self.student_of[k])
            if s < 0 or k in compute_slots:
                # compute-coded slots arrive only via their shard shares
                continue
            for n in np.flatnonzero(self.member[k]):
                share_cols[k].append(len(t))
                t.append(float(self.latency_nd[s, n]))
                slot.append(k)
                p_out.append(float(self.device_caps[n, 3]))
                names.append(self.device_names[n])
        layout = None
        group_shares: list = []
        group_slots: list = []
        group_k: list = []
        if cs is not None:
            for p in range(cs.P):
                s = int(cs.parity_student[p])
                for n in np.flatnonzero(cs.parity_member[p]):
                    share_cols[self.K + p].append(len(t))
                    t.append(float(self.latency_nd[s, n]))
                    slot.append(-1)
                    p_out.append(float(self.device_caps[n, 3]))
                    names.append(self.device_names[n])
            group_shares += [cs.group_shares(c) for c in range(cs.n_groups)]
            group_slots += [cs.group_slots(c) for c in range(cs.n_groups)]
            group_k += [cs.code_nk(c)[1] for c in range(cs.n_groups)]
        if cc is not None:
            # one appended share per compute shard, generator-row order; a
            # shard's Eq. 1a latency is the full portion's divided by k
            for q in range(cc.Q):
                sid = int(cc.slots[q])
                stu = int(self.student_of[sid])
                kq = int(cc.k[q])
                ids = []
                for n in cc.shard_member[q]:
                    ids.append(len(share_cols))
                    if n < 0 or stu < 0:
                        share_cols.append([])
                        continue
                    share_cols.append([len(t)])
                    t.append(float(self.latency_nd[stu, n]) / kq)
                    slot.append(-1)
                    p_out.append(float(self.device_caps[n, 3]))
                    names.append(self.device_names[n])
                group_shares.append(np.asarray(ids, np.int64))
                group_slots.append(np.asarray([sid], np.int64))
                group_k.append(kq)
        if cs is not None or cc is not None:
            layout = ShareLayout(
                share_cols=tuple(np.asarray(c, np.int64)
                                 for c in share_cols),
                group_shares=tuple(group_shares),
                group_slots=tuple(group_slots),
                group_k=np.asarray(group_k, np.int64))
        slot_arr = np.asarray(slot, np.int64)
        cols = tuple(np.flatnonzero(slot_arr == k) for k in range(self.K))
        return PlanArrays(np.asarray(t, np.float64), slot_arr,
                          np.asarray(p_out, np.float64), tuple(names),
                          self.K, cols, layout=layout)
