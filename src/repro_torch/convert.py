"""Parameters from the JAX package into the port's trees.

``params_from_jax`` takes a parameter tree of numpy arrays (what
``jax.device_get`` returns for the JAX package's student params) and gives
the port's dict of CPU tensors: 4-D conv kernels go from HWIO to OIHW,
an absent ``expand`` conv (``None`` in the JAX tree) is left out, and
everything else — dense kernels, BN ``scale``/``bias``/``mean``/``var`` —
carries across as it is. ``fc_from_jax`` converts the FC head (or the
per-slot FC slices) without any permutation. ``lm_params_from_jax``
converts an LM parameter tree of any ported family leaf by leaf, with no
permutation: the dense and MoE ``layers`` and the SSM ``layers`` stacked on
axis 0, the hybrid's stacked ``periods`` with their ``sub{i}`` dicts; bf16
leaves bit for bit, fp32 ones (the MoE router, the SSM ``A_log``, ``D``
and ``dt_bias``) as they are. ``teacher_from_jax`` and ``ensemble_from_jax``
carry a trained ``TeacherBundle`` or ``Ensemble`` of the JAX package across
whole: configs, weights, plan and head. ``train_state_from_jax`` carries a
trainer's ``TrainState`` (params, the AdamW master copy and moments, the
step), and ``lm_students_from_jax`` the LM students of
``repro.core.lm_students`` (config, weights, feature head, partition).
With converted weights both packages compute the same function.

Nothing here imports JAX: leaves are read with ``numpy.asarray``, so they
may be numpy arrays (what ``jax.device_get`` returns) or JAX arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree: Any) -> Any:
    """A JAX student parameter tree (numpy leaves) → the port's tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if v is None:
                continue
            if k == "kernel" and np.ndim(v) == 4:          # HWIO → OIHW
                out[k] = _tensor(np.transpose(np.asarray(v), (3, 2, 0, 1)))
            else:
                out[k] = params_from_jax(v)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v) for v in tree)
    return _tensor(tree)


def fc_from_jax(tree: Any) -> Any:
    """The FC head ``{"kernel", "bias"}`` or an FC slice array, as tensors."""
    if isinstance(tree, dict):
        return {k: fc_from_jax(v) for k, v in tree.items()}
    return _tensor(tree)


def _lm_tensor(a) -> torch.Tensor:
    """One leaf: bf16 arrays (``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses) go through their uint16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16), copy=True)
                                ).view(torch.bfloat16)
    return _tensor(a)


def lm_params_from_jax(tree: Any) -> Any:
    """A JAX LM parameter tree (numpy leaves) → the port's tree: the same
    keys and shapes, every leaf as it is (no HWIO→OIHW rule)."""
    if isinstance(tree, dict):
        return {k: lm_params_from_jax(v) for k, v in tree.items()}
    return _lm_tensor(tree)


def train_state_from_jax(state: Any):
    """A JAX ``TrainState(params, OptState(step, master, m, v))`` (numpy
    leaves) → the port's, every leaf as it is, the step an int32 scalar."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim.adamw import OptState
    opt = state.opt
    return TrainState(
        lm_params_from_jax(state.params),
        OptState(torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32),
                 lm_params_from_jax(opt.master), lm_params_from_jax(opt.m),
                 lm_params_from_jax(opt.v)))


def lm_config_from_jax(cfg: Any):
    """A JAX ``ModelConfig`` → the port's: every field as it is, the dtypes
    by name."""
    from repro_torch.configs.base import ModelConfig
    fields = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name.endswith("_dtype"):
            v = getattr(torch, np.dtype(v).name)
        fields[f.name] = v
    return ModelConfig(**fields)


def lm_students_from_jax(students: Any) -> list:
    """JAX ``LMStudent``s → the port's: config, params, feature head
    ``proj`` and partition."""
    from repro_torch.core.lm_students import LMStudent
    return [LMStudent(lm_config_from_jax(st.cfg),
                      lm_params_from_jax(st.params), _lm_tensor(st.proj),
                      np.asarray(st.partition)) for st in students]


def _cnn_cfg(cfg):
    """A JAX CNN config → the port's config of the same class name."""
    from repro_torch.models import cnn
    return getattr(cnn, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _forward(cfg):
    from repro_torch.models import cnn
    return (cnn.wrn_forward if isinstance(cfg, cnn.WRNConfig)
            else cnn.mbv2_forward)


def _same_class(obj, cls):
    return cls(**dataclasses.asdict(obj))


def teacher_from_jax(bundle: Any):
    """A JAX ``TeacherBundle`` → the port's, weights on the CPU."""
    from repro_torch.core.pipeline import TeacherBundle
    from repro_torch.data.images import ImageTaskConfig, SyntheticImages
    return TeacherBundle(
        cfg=_cnn_cfg(bundle.cfg), params=params_from_jax(bundle.params),
        acc=float(bundle.acc), A=np.asarray(bundle.A),
        data=SyntheticImages(_same_class(bundle.data.cfg, ImageTaskConfig)))


def _plan_from_jax(plan: Any):
    from repro_torch.core.assignment import StudentArch
    from repro_torch.core.grouping import Device
    from repro_torch.core.planner import GroupPlan, Plan
    groups = [GroupPlan(
        g.group_idx, [_same_class(d, Device) for d in g.devices],
        g.partition_idx, np.asarray(g.filters),
        None if g.student is None else _same_class(g.student, StudentArch))
        for g in plan.groups]
    return Plan(groups, np.asarray(plan.A), plan.d_th, plan.p_th)


def _ir_from_jax(ir: Any):
    """A replicate-only JAX ``PlanIR`` → the port's (every field is numpy,
    a tuple of names or a float)."""
    from repro_torch.core.plan_ir import PlanIR
    fields = {f.name: getattr(ir, f.name) for f in dataclasses.fields(ir)}
    if any(fields[k] is not None for k in
           ("coding", "compute_coding", "device_specs")):
        raise ValueError("only replicate-only plans with declared latency "
                         "carry across")
    return PlanIR(**fields)


def ensemble_from_jax(ens: Any):
    """A JAX ``Ensemble`` → the port's: each student's config and forward,
    its weights (HWIO → OIHW), the head, the plan and its IR."""
    from repro_torch.core.pipeline import Ensemble
    students = []
    for cfg, params, _ in ens.students:
        tcfg = _cnn_cfg(cfg)
        students.append((tcfg, params_from_jax(params), _forward(tcfg)))
    return Ensemble(_plan_from_jax(ens.plan), students, fc_from_jax(ens.fc),
                    [int(d) for d in ens.part_dims], float(ens.teacher_acc),
                    ir=None if ens.ir is None else _ir_from_jax(ens.ir))
