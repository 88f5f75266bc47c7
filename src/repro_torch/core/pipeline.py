"""The runtime-phase view of a RoCoIn ensemble.

Only :class:`Ensemble` and its stacked-student export are ported so far;
the offline phase (teacher training, distillation, failout fine-tuning,
``build_rocoin``) is queued in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import planner as PL
from repro_torch.core.plan_ir import PlanIR
from repro_torch.tree import tree_leaves, tree_structure


@dataclasses.dataclass
class Ensemble:
    """A planned, distilled ensemble: per-partition students and the FC
    head over their concatenated portions."""
    plan: PL.Plan
    students: List[Tuple[Any, Any, Callable]]   # (cfg, params, forward) per partition
    fc: Dict[str, torch.Tensor]                 # {"kernel": (ΣDk, C), "bias": (C,)}
    part_dims: List[int]
    teacher_acc: float
    ir: Optional[PlanIR] = None                 # canonical array-backed plan

    def fused_export(self):
        """Stacked-student export for the serving fast path, or None.

        Students are stackable when they share ONE arch family: identical
        configs and identical parameter-tree structure, shapes and dtypes
        (uniform ``part_dims``). The export is a
        :class:`repro_torch.runtime.serving.FusedStudents`: per-slot
        parameter trees plus the single shared forward, which the server
        stacks along a leading K axis and maps over in one step.
        Heterogeneous zoos fall back to the per-slot loop (returns None)."""
        from repro_torch.runtime.serving import FusedStudents
        if len(self.students) < 2:
            return None
        cfg0, params0, fwd0 = self.students[0]

        def shapes(params):
            return [(t.shape, t.dtype) for t in tree_leaves(params)]

        shapes0, td0 = shapes(params0), tree_structure(params0)
        for cfg, params, _ in self.students[1:]:
            if (cfg != cfg0 or tree_structure(params) != td0
                    or shapes(params) != shapes0):
                return None

        def apply(params, x):
            _, feats, _ = fwd0(params, cfg0, x)
            return feats

        return FusedStudents(apply=apply,
                             params=[p for _, p, _ in self.students])
