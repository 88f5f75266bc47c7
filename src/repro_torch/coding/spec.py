"""Array-backed coding layout attached to a :class:`~repro.core.plan_ir.PlanIR`.

A plan's redundancy is per-group: a slot either keeps RoCoIn's replication
(``group_of[k] == -1``) or belongs to a coded group ``c`` whose ``k_c``
member slots plus ``r_c`` parity shares form a systematic MDS-(n, k) code
(:mod:`repro.coding.codes`). Systematic share ``s < K`` is slot ``s``'s own
portion (placed by the IR's ``member`` matrix as usual); parity share ``p``
is placed by ``parity_member[p]`` and computed by a student-sized coded
network (``parity_student[p]``, Hadidi-style). The spec is pure placement
and structure — generators are derived deterministically from ``(n, k)``,
so a share lost to a device failure is rebuilt by *re-encoding*, never by
re-distillation.

Kept separate from the IR's core arrays (an optional ``coding`` field) so
replicate-only plans pay nothing and every legacy code path sees exactly
the shapes it always did.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.coding.codes import arrival_shortfall_prob, make_generator


@dataclasses.dataclass(frozen=True)
class CodingSpec:
    """Output-coding layout: which slots form MDS groups and where each
    group's parity shares live.

    Immutable (arrays are frozen); evolve with :meth:`with_`. Share id
    convention: share ``s < K`` is slot ``s``'s systematic share, share
    ``K + p`` is parity row ``p``.
    """

    group_of: np.ndarray        # (K,) int64 coded-group id per slot, -1 = replicate
    parity_group: np.ndarray    # (P,) int64 coded-group id per parity share
    parity_member: np.ndarray   # (P, N) bool parity-share device placement
    parity_student: np.ndarray  # (P,) int64 student index per parity share
    construction: str = "vandermonde"

    def __post_init__(self):
        for field, dtype in (("group_of", np.int64),
                             ("parity_group", np.int64),
                             ("parity_member", bool),
                             ("parity_student", np.int64)):
            arr = np.array(getattr(self, field), dtype=dtype, copy=True)
            arr.setflags(write=False)
            object.__setattr__(self, field, arr)
        pm = self.parity_member.reshape(len(self.parity_group), -1)
        pm.setflags(write=False)
        object.__setattr__(self, "parity_member", pm)
        object.__setattr__(self, "construction", str(self.construction))

    # -- shapes --------------------------------------------------------------

    @property
    def K(self) -> int:
        """Number of partition slots covered by this spec."""
        return int(self.group_of.shape[0])

    @property
    def P(self) -> int:
        """Total number of parity shares across all groups."""
        return int(self.parity_group.shape[0])

    @property
    def n_groups(self) -> int:
        """Number of coded groups (0 when every slot replicates)."""
        return int(self.group_of.max()) + 1 if (self.group_of >= 0).any() \
            else 0

    @property
    def n_shares(self) -> int:
        """Global share ids: share s < K is slot s's systematic share,
        share K + p is parity share p."""
        return self.K + self.P

    # -- group structure -----------------------------------------------------

    def group_slots(self, c: int) -> np.ndarray:
        """Slot ids of group ``c`` in ascending order — the order defining
        the code's systematic symbol positions."""
        return np.flatnonzero(self.group_of == c)

    def group_parities(self, c: int) -> np.ndarray:
        """Parity-share row ids of group ``c`` in ascending order — symbol
        positions ``k .. n-1`` of the code."""
        return np.flatnonzero(self.parity_group == c)

    def group_shares(self, c: int) -> np.ndarray:
        """Global share ids of group ``c``: systematic first (slot order),
        then parity — exactly the generator's row order."""
        return np.concatenate([self.group_slots(c),
                               self.K + self.group_parities(c)])

    def code_nk(self, c: int) -> Tuple[int, int]:
        """The (n, k) parameters of group ``c``'s MDS code."""
        k = len(self.group_slots(c))
        return k + len(self.group_parities(c)), k

    def generator(self, c: int) -> np.ndarray:
        """Group ``c``'s (n, k) systematic generator matrix."""
        n, k = self.code_nk(c)
        return make_generator(n, k, self.construction)

    # -- the per-group redundancy_mode / code-rate view ---------------------

    def mode(self, slot: int) -> str:
        """Redundancy-mode label for one slot: ``replicate`` or ``coded(n,k)``."""
        c = int(self.group_of[slot])
        if c < 0:
            return "replicate"
        n, k = self.code_nk(c)
        return f"coded({n},{k})"

    def modes(self) -> Tuple[str, ...]:
        """Per-slot redundancy-mode labels, slot order."""
        return tuple(self.mode(k) for k in range(self.K))

    def code_rate(self, slot: int) -> float:
        """k/n for coded slots (deployed-compute multiplier is its inverse);
        1/|group| for replicated ones."""
        c = int(self.group_of[slot])
        if c < 0:
            return 1.0
        n, k = self.code_nk(c)
        return k / n

    # -- reliability (the coded Eq. 1f analogue) ----------------------------

    def slot_shortfall(self, slot: int, share_arrive_prob: np.ndarray
                       ) -> Optional[float]:
        """P(slot ``slot`` is NOT covered): its own share misses AND fewer
        than k of the group's remaining shares arrive. ``share_arrive_prob``
        is the (n_shares,) per-share arrival probability. None for
        replicate slots (the plain Eq. 1f product applies)."""
        c = int(self.group_of[slot])
        if c < 0:
            return None
        shares = self.group_shares(c)
        _, k = self.code_nk(c)
        p = np.asarray(share_arrive_prob, np.float64)
        own_miss = 1.0 - p[slot]
        others = shares[shares != slot]
        return float(own_miss * arrival_shortfall_prob(p[others], k))

    def group_shortfall(self, c: int, share_arrive_prob: np.ndarray) -> float:
        """P(group ``c`` cannot decode): fewer than k of its n shares
        arrive — the planner's parity-sizing target."""
        shares = self.group_shares(c)
        _, k = self.code_nk(c)
        p = np.asarray(share_arrive_prob, np.float64)
        return arrival_shortfall_prob(p[shares], k)

    # -- functional updates --------------------------------------------------

    def with_(self, **changes) -> "CodingSpec":
        """Return a copy with the given fields replaced (frozen-safe)."""
        return dataclasses.replace(self, **changes)

    def drop_device(self, col: int) -> "CodingSpec":
        """Remove a device column from every parity placement (the IR's
        ``drop_device`` calls this alongside its own column removal)."""
        keep = np.ones(self.parity_member.shape[1], bool)
        keep[col] = False
        return self.with_(parity_member=self.parity_member[:, keep])

    # -- invariants ----------------------------------------------------------

    def validate(self, member: np.ndarray) -> "CodingSpec":
        """Structural invariants against the owning IR's (K, N) membership:
        consistent shapes, real groups, and parity devices disjoint from
        systematic members (a device computes at most one share)."""
        K, N = member.shape
        if self.group_of.shape != (K,):
            raise ValueError(f"group_of has shape {self.group_of.shape}, "
                             f"plan has K={K} slots")
        if self.parity_member.shape[1] != N and self.P:
            raise ValueError("parity_member device axis does not match the "
                             "plan's device catalogue")
        C = self.n_groups
        if self.P and ((self.parity_group < 0).any()
                       or (self.parity_group >= max(C, 1)).any()):
            raise ValueError("parity share references a nonexistent group")
        for c in range(C):
            if not len(self.group_slots(c)):
                raise ValueError(f"coded group {c} has no member slots")
        if self.P and (self.parity_member.sum(axis=0) > 1).any():
            raise ValueError("a device computes more than one parity share")
        if self.P and (self.parity_member.any(axis=0)
                       & member.any(axis=0)).any():
            raise ValueError("a parity device is also a systematic member")
        return self
