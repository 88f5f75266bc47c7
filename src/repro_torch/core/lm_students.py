"""RoCoIn at LM scale: the paper's technique applied to transformer teachers.

The analogue of the teacher's "final convolution filters" is the final-block
hidden feature channels feeding the LM head. The same pipeline applies:

  1. run validation tokens through the teacher LM; average |activation| per
     final-hidden channel = a_m,
  2. activation graph A_mm' (Eq. §IV-B2) over d_model channels,
  3. Ncut partition into K channel groups (one per device group),
  4. students = width/depth-reduced LMs whose final feature dim equals the
     partition size; each student mimics its channel slice (AT loss) + the
     teacher's token distribution (KD loss),
  5. quorum serving: student feature portions concatenate → shared LM head.

The torch twin of the JAX package's ``core/lm_students.py``, for the dense
and MoE families. Every teacher forward runs under ``torch.no_grad()`` (an
MoE teacher's router then reaches ``topk_gating`` forward only). The
students are dense (``n_experts=0``), so on the
card their training runs the hand-written ``rmsnorm`` and
``flash_attention`` kernels forward and their backward kernels.
:func:`distill_lm_step` and :func:`failout_lm_step` are one step each of
the two trainers, callable on given students (the reference jits them
inside its loops); each update is plain SGD (``a - lr·g``), functional:
new tensors, the inputs left as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import activation_graph as AG
from repro_torch.core import distill as DS
from repro_torch.core.assignment import StudentArch
from repro_torch.core.grouping import Device
from repro_torch.core.planner import Plan, tune_d_th
from repro_torch.models import api
from repro_torch.models import transformer as T
from repro_torch.tree import trainable, tree_leaves, tree_map


def lm_activation_graph(params, cfg: ModelConfig, tokens: torch.Tensor
                        ) -> np.ndarray:
    """Filter-activation graph over the teacher LM's final hidden channels."""
    with torch.no_grad():
        hidden = lm_final_hidden(params, cfg, tokens)      # (B, S, d)
        acts = AG.average_activity(hidden)                 # (B, d)
        return AG.activation_graph(acts).cpu().numpy()


def lm_final_hidden(params, cfg: ModelConfig, tokens: torch.Tensor
                    ) -> torch.Tensor:
    """Forward to the pre-head hidden states (dense/moe families)."""
    x = T._embed(params, cfg, tokens, None)
    B, S = tokens.shape
    rope = T.rope_table(cfg, T.default_positions(cfg, B, S, device=x.device))
    for i in range(cfg.n_layers):
        x = T.block_apply(T._layer(params, i), cfg, x, rope)
    return T.norm_apply(cfg, params["out_norm"], x)


def student_config(teacher: ModelConfig, part_dim: int, *,
                   width_frac: float = 0.5, depth_frac: float = 0.5
                   ) -> ModelConfig:
    """A width/depth-reduced student of the teacher's family whose output
    feature dim equals its knowledge-partition size."""
    d = max(int(teacher.d_model * width_frac) // 16 * 16, 32)
    heads = max(teacher.n_heads // 2, 2) if teacher.n_heads else 0
    return teacher.with_(
        name=f"{teacher.name}-student{part_dim}",
        n_layers=max(int(teacher.n_layers * depth_frac), 1),
        d_model=d,
        n_heads=heads,
        n_kv_heads=max(min(teacher.n_kv_heads, heads), 1) if heads else 0,
        d_ff=0 if teacher.d_ff == 0 else max(int(teacher.d_ff * width_frac), 64),
        n_experts=0, top_k=0,   # students are dense (paper: compact students)
        pad_heads_to=0,
    )


def lm_student_archs(teacher: ModelConfig, part_dims: Sequence[int],
                     fracs: Sequence[float] = (0.25, 0.5, 1.0)
                     ) -> List[StudentArch]:
    """Profile the student zoo analytically (6·N FLOPs/token) for Eq. 5."""
    out = []
    for frac in fracs:
        cfg = student_config(teacher, max(part_dims), width_frac=frac,
                             depth_frac=frac)
        n = (cfg.n_layers * (4 * cfg.d_model * cfg.n_heads * cfg.head_dim
                             + 3 * cfg.d_model * cfg.d_ff)
             + cfg.vocab * cfg.d_model)
        out.append(StudentArch(
            name=f"lm-student-{frac}", flops=2.0 * n, params=2.0 * n,
            out_bytes=2.0 * max(part_dims), capacity=float(n)))
    return out


@dataclasses.dataclass
class LMStudent:
    cfg: ModelConfig
    params: Any
    proj: torch.Tensor         # (d_student, part_dim) feature head
    partition: np.ndarray      # teacher channel indices


def _split(gen: torch.Generator, n: int) -> List[torch.Generator]:
    """``n`` generators on ``gen``'s device, seeded from ``gen`` (the torch
    stand-in for ``jax.random.fold_in`` over the student index)."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=gen,
                          device=gen.device).tolist()
    return [torch.Generator(device=gen.device).manual_seed(int(s))
            for s in seeds]


def init_lm_student(gen: torch.Generator, teacher: ModelConfig,
                    part: np.ndarray, width_frac: float = 0.5) -> LMStudent:
    """A student drawn from ``gen``, on its device."""
    cfg = student_config(teacher, len(part), width_frac=width_frac)
    params = api.init(gen, cfg)
    proj = torch.randn((cfg.d_model, len(part)), generator=gen,
                       device=gen.device) / cfg.d_model ** 0.5
    return LMStudent(cfg, params, proj, np.asarray(part))


def student_portion(st: LMStudent, tokens: torch.Tensor) -> torch.Tensor:
    """Student's feature portion for its partition: (B, S, part_dim)."""
    hidden = lm_final_hidden(st.params, st.cfg, tokens)
    return hidden.float() @ st.proj


@torch.no_grad()
def _sgd(tree, lr: float):
    """``a - lr·g`` on every leaf of a tree of autograd leaves (a leaf the
    loss did not reach has a zero gradient)."""
    return tree_map(lambda a: a.detach() if a.grad is None
                    else a.detach() - lr * a.grad.to(a.dtype), tree)


def _teacher_targets(teacher_params, teacher_cfg: ModelConfig,
                     tokens: torch.Tensor):
    with torch.no_grad():
        t_hidden = lm_final_hidden(teacher_params, teacher_cfg, tokens)
        t_logits = T._lm_head(teacher_params, teacher_cfg, t_hidden)
    return t_hidden, t_logits, t_logits.argmax(-1)


def distill_lm_step(st: LMStudent, teacher_params, teacher_cfg: ModelConfig,
                    tokens: torch.Tensor, *, lr: float = 1e-3,
                    dcfg: DS.DistillConfig = DS.DistillConfig(alpha=1.0)
                    ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """One distillation step of ``st``: KD on the teacher's logits + AT on
    its partition's channels of the final hidden states (Eq. 6). Returns
    (params, proj, loss)."""
    part = torch.as_tensor(st.partition, dtype=torch.int64,
                           device=tokens.device)
    t_hidden, t_logits, labels = _teacher_targets(teacher_params,
                                                  teacher_cfg, tokens)
    t_part = t_hidden.float()[..., part]
    p, pr = trainable(st.params), st.proj.detach().requires_grad_()
    hidden = lm_final_hidden(p, st.cfg, tokens)
    feats = hidden.float() @ pr
    logits = T._lm_head(p, st.cfg, hidden)
    kd = DS.kd_loss(logits.reshape(-1, st.cfg.vocab),
                    t_logits.reshape(-1, teacher_cfg.vocab),
                    labels.reshape(-1), dcfg)
    at = DS.at_loss(feats.reshape(-1, feats.shape[-1]),
                    t_part.reshape(-1, t_part.shape[-1]))
    loss = kd + dcfg.beta * at
    loss.backward()
    return _sgd(p, lr), _sgd(pr, lr), loss.detach()


def _tokens(tokens, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(tokens).to(device)


def distill_lm_students(gen: torch.Generator, teacher_params,
                        teacher_cfg: ModelConfig,
                        parts: Sequence[np.ndarray], data_batches,
                        *, steps: int = 20, lr: float = 1e-3,
                        dcfg: DS.DistillConfig = DS.DistillConfig(alpha=1.0)
                        ) -> List[LMStudent]:
    """Distill one student per partition: KD on teacher logits + AT on the
    partition's channel slice of the final hidden states (Eq. 6). Students
    are drawn from ``gen`` on its device (the teacher's)."""
    students = [init_lm_student(g, teacher_cfg, p)
                for g, p in zip(_split(gen, len(parts)), parts)]
    dev = tree_leaves(teacher_params)[0].device
    for st in students:
        for i, tokens in enumerate(data_batches()):
            if i >= steps:
                break
            st.params, st.proj, _ = distill_lm_step(
                st, teacher_params, teacher_cfg, _tokens(tokens, dev),
                lr=lr, dcfg=dcfg)
    return students


def merge_order(students: Sequence[LMStudent], d: int) -> np.ndarray:
    """``inv`` with ``concat(portions)[..., inv]`` in teacher channel order;
    raises unless the partitions cover every channel exactly once."""
    perm = np.concatenate([st.partition for st in students])
    if sorted(perm.tolist()) != list(range(d)):
        raise ValueError("student partitions must cover every teacher "
                         "channel exactly once")
    inv = np.empty(d, np.int64)
    inv[perm] = np.arange(d)
    return inv


def column_masks(students: Sequence[LMStudent], slot_masks: np.ndarray,
                 d: int) -> np.ndarray:
    """(P, K) slot aliveness → (P, d) teacher-channel masks."""
    col_masks = np.zeros((slot_masks.shape[0], d), np.float32)
    for k, st in enumerate(students):
        col_masks[:, st.partition] = slot_masks[:, k:k + 1]
    return col_masks


def failout_lm_step(students: Sequence[LMStudent], teacher_params,
                    teacher_cfg: ModelConfig, tokens: torch.Tensor,
                    col_masks: torch.Tensor, weights: torch.Tensor, *,
                    lr: float = 1e-3,
                    dcfg: DS.DistillConfig = DS.DistillConfig(alpha=1.0)
                    ) -> Tuple[List[Any], List[torch.Tensor], torch.Tensor]:
    """One failout step over every student jointly: the portions merged in
    teacher channel order, each of the P aliveness patterns of
    ``col_masks`` (P, d) through the teacher's head, the KD losses summed
    under ``weights`` (P,). Returns (params list, proj list, loss)."""
    d, V = teacher_cfg.d_model, teacher_cfg.vocab
    inv = torch.as_tensor(merge_order(students, d), device=tokens.device)
    _, t_logits, labels = _teacher_targets(teacher_params, teacher_cfg,
                                           tokens)
    ps = [trainable(st.params) for st in students]
    prs = [st.proj.detach().requires_grad_() for st in students]
    portions = [lm_final_hidden(p, st.cfg, tokens).float() @ pr
                for p, st, pr in zip(ps, students, prs)]
    merged = torch.cat(portions, dim=-1)[..., inv]
    losses = []
    for cm in col_masks:                 # one pattern at a time (vmap)
        logits = T._lm_head(teacher_params, teacher_cfg,
                            (merged * cm).to(teacher_cfg.compute_dtype))
        losses.append(DS.kd_loss(logits.reshape(-1, V),
                                 t_logits.reshape(-1, V),
                                 labels.reshape(-1), dcfg))
    loss = (weights * torch.stack(losses)).sum()
    loss.backward()
    return ([_sgd(p, lr) for p in ps], [_sgd(pr, lr) for pr in prs],
            loss.detach())


def failout_finetune_lm(students: Sequence[LMStudent], teacher_params,
                        teacher_cfg: ModelConfig, data_batches,
                        cfg: "FO.FailoutConfig", *,
                        steps: Optional[int] = None, lr: float = 1e-3,
                        dcfg: DS.DistillConfig = DS.DistillConfig(alpha=1.0),
                        arrays=None) -> List[LMStudent]:
    """Failout phase at LM scale: jointly fine-tune every student (params +
    feature head) on the quorum-merged token prediction under sampled
    aliveness masks.

    The merge mirrors serving: each student's portion is scattered back to
    its partition's teacher channels, masked portions contribute zeros, and
    the merged hidden state flows through the TEACHER's LM head (the source
    device's shared head). Masks come from the same
    :class:`~repro_torch.core.failout.FailoutSampler` as the CNN path
    (``arrays`` supplies the plan's ``PlanArrays`` for scenario mode), so
    runs are reproducible per ``(seed, step)``. Students are updated
    functionally; the returned list replaces the input."""
    from repro_torch.core import failout as FO
    steps = cfg.steps if steps is None else steps
    K = len(students)
    sampler = FO.FailoutSampler(cfg, n_slots=K, arrays=arrays)
    dev = tree_leaves(teacher_params)[0].device
    weights = torch.as_tensor(sampler.weights(), dtype=torch.float32,
                              device=dev)
    d = teacher_cfg.d_model
    merge_order(students, d)
    cur = list(students)
    for i, tokens in enumerate(data_batches()):
        if i >= steps:
            break
        col_masks = torch.from_numpy(
            column_masks(students, sampler.masks(i), d)).to(dev)
        plist, projlist, _ = failout_lm_step(
            cur, teacher_params, teacher_cfg, _tokens(tokens, dev),
            col_masks, weights, lr=lr, dcfg=dcfg)
        cur = [LMStudent(st.cfg, p, pr, st.partition)
               for st, p, pr in zip(students, plist, projlist)]
    return cur


def plan_lm_rocoin(devices: Sequence[Device], teacher_params,
                   teacher_cfg: ModelConfig, val_tokens: torch.Tensor,
                   *, p_th: float = 0.25) -> Tuple[Plan, np.ndarray]:
    """End-to-end LM plan: graph → grouping → Ncut → KM (Alg. 1)."""
    A = lm_activation_graph(teacher_params, teacher_cfg, val_tokens)
    zoo = lm_student_archs(teacher_cfg, [A.shape[0] // max(len(devices) // 2, 1)])
    plan = tune_d_th(devices, A, zoo, p_th=p_th)
    return plan, A
