"""Knowledge distillation with activation transfer (RoCoIn Eq. 6).

    Loss(θ_S) = (1−α)·H(y, P_S)  +  α·H(P_T^τ, P_S^τ)          (KD loss)
              + β · Σ_{P_k} ‖ v_T(p)/‖v_T(p)‖ − v_S(p)/‖v_S(p)‖ ‖²   (AT loss)

where v_T(p) are the teacher's final-layer activations restricted to the
filters of the student's knowledge partition, and v_S(p) the student's
corresponding features. Each student learns ONLY its partition; student
outputs are concatenated and merged by the source device's FC head.

The torch twin of the JAX package's module: the same formulas on tensors.
The failout loss evaluates its P aliveness patterns as one batched product
over a leading pattern axis (where the JAX package maps one pattern at a
time with ``vmap``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    alpha: float = 0.9        # soft-label weight
    # NoNN uses β≈1000 on spatial attention maps summed over H×W; this AT
    # term acts on L2-NORMALIZED pooled features (bounded ≤4), so the
    # equivalent gradient scale is far smaller; default β=10 (the JAX
    # package's validated value).
    beta: float = 10.0
    temperature: float = 4.0


def _kd_rows(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
             labels: torch.Tensor, cfg: DistillConfig) -> torch.Tensor:
    """Per-row KD loss; leading axes of ``student_logits`` (a pattern axis)
    broadcast against the teacher's logits and the labels."""
    sl = student_logits.float()
    tl = teacher_logits.float()
    # hard loss
    logp = F.log_softmax(sl, dim=-1)
    idx = labels[..., None].expand(*logp.shape[:-1], 1)
    hard = -logp.gather(-1, idx)[..., 0]
    # soft loss
    t = cfg.temperature
    pt = F.softmax(tl / t, dim=-1)
    logps = F.log_softmax(sl / t, dim=-1)
    soft = -(pt * logps).sum(dim=-1) * (t * t)
    return (1 - cfg.alpha) * hard + cfg.alpha * soft


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            labels: torch.Tensor, cfg: DistillConfig) -> torch.Tensor:
    """(1−α)·H(y, P_S) + α·τ²·KL(P_T^τ ‖ P_S^τ)  (τ² keeps gradient scale)."""
    return _kd_rows(student_logits, teacher_logits, labels, cfg).mean()


def at_loss(student_feats: torch.Tensor, teacher_feats: torch.Tensor,
            eps: float = 1e-8) -> torch.Tensor:
    """Activation-transfer term: L2 between l2-normalized feature vectors.
    feats: (B, F) pooled activations (student's F == len(partition))."""
    s = student_feats.float()
    t = teacher_feats.float()
    s = s / (torch.linalg.vector_norm(s, dim=-1, keepdim=True) + eps)
    t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + eps)
    return ((s - t) ** 2).sum(dim=-1).mean()


def distill_loss(student_logits: torch.Tensor, student_feats: torch.Tensor,
                 teacher_logits: torch.Tensor,
                 teacher_part_feats: torch.Tensor, labels: torch.Tensor,
                 cfg: DistillConfig) -> torch.Tensor:
    """Full Eq. 6 for one student (its partition's teacher features given)."""
    return (kd_loss(student_logits, teacher_logits, labels, cfg)
            + cfg.beta * at_loss(student_feats, teacher_part_feats))


# ---------------------------------------------------------------------------
# quorum aggregation (runtime): concat portions → FC head
# ---------------------------------------------------------------------------

def aggregate_portions(portions: Sequence[Optional[torch.Tensor]],
                       part_dims: Sequence[int], *,
                       batch: Optional[int] = None,
                       device=None) -> torch.Tensor:
    """Concatenate per-partition feature portions; missing (failed) portions
    are zeroed — the paper's §V emulation of local failures.

    portions[k]: (B, part_dims[k]) or None. Returns (B, Σ dims) in fp32, on
    the device of the portions that arrived (``device``, the CPU by
    default, when none did).

    The all-portions-missing pattern (beyond quorum distance) is DEFINED
    when ``batch`` supplies the row count the portions can no longer
    provide: the result is the all-zero feature matrix, so the FC head
    emits its bias. Without a ``batch`` hint the row count is unrecoverable
    and the pattern raises.
    """
    B = batch
    for p in portions:
        if p is not None:
            B, device = p.shape[0], p.device
            break
    if B is None:
        raise ValueError("no portion arrived and no batch hint — "
                         "inference failed")
    outs = [torch.zeros((B, dim), dtype=torch.float32, device=device)
            if portions[k] is None else portions[k].float()
            for k, dim in enumerate(part_dims)]
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# failout: the quorum-merged objective under sampled aliveness masks
# ---------------------------------------------------------------------------

def expand_slot_masks(masks: np.ndarray,
                      part_dims: Sequence[int]) -> np.ndarray:
    """Expand (P, K) slot-aliveness masks to (P, Σ dims) feature-column
    masks — column-space twin of :func:`aggregate_portions`' zeroing, so
    ``feats_cat * col_mask`` is exactly the merged feature matrix the
    serving path would build under that pattern."""
    masks = np.asarray(masks, bool)
    dims = np.asarray(list(part_dims), np.int64)
    if masks.ndim != 2 or masks.shape[1] != len(dims):
        raise ValueError(f"masks {masks.shape} do not match "
                         f"{len(dims)} partitions")
    return np.repeat(masks, dims, axis=1).astype(np.float32)


def failout_merged_loss(fc: Dict[str, torch.Tensor], feats_cat: torch.Tensor,
                        teacher_logits: torch.Tensor, labels: torch.Tensor,
                        col_masks, weights, cfg: DistillConfig
                        ) -> torch.Tensor:
    """Failout objective: the quorum-merged KD loss under P aliveness
    patterns, evaluated for all P at once over a leading pattern axis.

    ``feats_cat`` (B, ΣDk) are the concatenated student portions (computed
    once per step — masking is a multiply, so patterns share the forward),
    ``col_masks`` (P, ΣDk) the expanded patterns
    (:func:`expand_slot_masks`), ``weights`` (P,) the pattern weights
    (all-alive first — see :class:`repro_torch.core.failout.FailoutSampler`).
    Each pattern's merged prediction ``fc(feats ∘ mask)`` is scored with
    the same Eq. 6 KD loss as failure-free distillation; the weighted sum
    makes accuracy-under-failure a *training* objective."""
    dev = feats_cat.device
    cm = torch.as_tensor(col_masks, dtype=torch.float32, device=dev)
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    logits = fc_head_apply(fc, feats_cat.float()[None] * cm[:, None])
    losses = _kd_rows(logits, teacher_logits, labels, cfg).mean(dim=-1)
    return (w * losses).sum()


def fc_head_init(gen: torch.Generator, in_dim: int, n_classes: int
                 ) -> Dict[str, torch.Tensor]:
    """The aggregation head, drawn on the CPU from ``gen``."""
    std = 1.0 / np.sqrt(in_dim)
    return {"kernel": std * torch.randn((in_dim, n_classes), generator=gen),
            "bias": torch.zeros((n_classes,))}


def fc_head_apply(p: Dict[str, torch.Tensor], feats: torch.Tensor
                  ) -> torch.Tensor:
    return feats @ p["kernel"] + p["bias"]
