"""RoCoIn offline setup phase end-to-end (Fig. 1 left half).

1. Train the teacher on the (synthetic-CIFAR) task.
2. Record execution profiles; pass a validation set through the teacher and
   build the filter-activation graph of its final conv layer.
3. Run the knowledge-assignment planner against a heterogeneous fleet.
4. Distill one student per knowledge partition (Eq. 6) and train the
   aggregation FC head over concatenated student portions.
5. Optionally, failout: jointly fine-tune students and head under sampled
   aliveness masks.

Returns an :class:`Ensemble` ready for the runtime phase (quorum
aggregation with failure masking).

The torch twin of the JAX package's pipeline. Random keys become explicit
``torch.Generator``s; every initial weight is drawn on the CPU and then
moved, so a run on the card and one on the CPU start from the same weights.
The entry points (:func:`build_rocoin`, :func:`prepare_teacher`,
:func:`train_teacher`, :func:`failout_finetune`) run on the card unless
given ``device="cpu"``. Each step is eager PyTorch (forward, ``backward``,
then the SGD update) where the JAX package jits one step. Student FLOPs come
from ``torch.utils.flop_counter`` (matrix products and convolutions only),
where the JAX package reads XLA's cost analysis.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import activation_graph as AG
from repro_torch.core import distill as DS
from repro_torch.core import failout as FO
from repro_torch.core import planner as PL
from repro_torch.core.assignment import StudentArch
from repro_torch.core.grouping import Device
from repro_torch.core.plan_ir import PlanIR
from repro_torch.data.images import ImageTaskConfig, SyntheticImages
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import cnn
from repro_torch.tree import (trainable, tree_leaves, tree_map,
                              tree_structure, tree_to)


# ---------------------------------------------------------------------------
# simple SGD-momentum trainer for CNNs
# ---------------------------------------------------------------------------

def sgd_init(params):
    return tree_map(torch.zeros_like, params)


@torch.no_grad()
def sgd_update(params, grads, mom, lr=0.05, momentum=0.9, wd=5e-4):
    """``g += wd·p; m = momentum·m + g; p -= lr·m`` on every float leaf
    (a missing gradient counts as zero: the BN statistics take weight decay
    too, before :func:`merge_bn_stats` overwrites them). Returns new trees;
    the inputs are left as they are."""
    def new_m(p, g, m):
        if not p.is_floating_point():
            return m
        return momentum * m + (wd * p if g is None else g + wd * p)

    mom2 = tree_map(new_m, params, grads, mom)
    params2 = tree_map(lambda p, m: p - lr * m if p.is_floating_point()
                       else p, params, mom2)
    return params2, mom2


def _xent(logits, labels):
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


def merge_bn_stats(params, newp):
    """Carry ONLY the BatchNorm running statistics from the forward pass —
    every other leaf keeps its (SGD-updated) value."""
    if isinstance(params, dict):
        return {k: (newp[k] if k in ("mean", "var")
                    and not isinstance(v, dict)
                    else merge_bn_stats(v, newp[k]))
                for k, v in params.items()}
    return params


def _grads(params):
    return tree_map(lambda t: t.grad, params)


def _batch(x: np.ndarray, y: np.ndarray, dev: torch.device):
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


class _Stages:
    """Wall seconds per stage into ``out`` (nothing when ``out`` is None),
    the device synchronised at each stage's end."""

    def __init__(self, out: Optional[Dict[str, float]], dev: torch.device):
        self.out, self.dev = out, dev
        self.t0 = time.perf_counter()

    def end(self, name: str) -> None:
        if self.out is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        t = time.perf_counter()
        self.out[name] = t - self.t0
        self.t0 = t


def split_generator(gen: torch.Generator, n: int) -> List[torch.Generator]:
    """``n`` independent CPU generators seeded from ``gen`` (the torch
    stand-in for ``jax.random.split``). :func:`build_rocoin` splits its
    generator in three (teacher, students, head): a teacher prepared from
    the first of them gives the ensemble of the same call without one."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=gen).tolist()
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def train_teacher(gen: torch.Generator, teacher_cfg: cnn.WRNConfig,
                  data: SyntheticImages, steps: int = 200, batch: int = 128,
                  lr: float = 0.05, device: DeviceLike = None
                  ) -> Tuple[Any, Dict]:
    """SGD on cross-entropy from a WRN drawn from ``gen`` (on the CPU, then
    moved to ``device``). Returns the params and ``{"losses": [...]}``."""
    dev = resolve_device(device)
    params = tree_to(cnn.wrn_init(gen, teacher_cfg), dev)
    mom = sgd_init(params)
    losses = []
    for x, y in data.epoch(batch, steps):
        x, y = _batch(x, y, dev)
        p = trainable(params)
        logits, _, newp = cnn.wrn_forward(p, teacher_cfg, x, train=True)
        loss = _xent(logits, y)
        loss.backward()
        params, mom = sgd_update(p, _grads(p), mom, lr=lr)
        params = merge_bn_stats(params, newp)   # BN running stats only
        losses.append(loss.detach())
    return params, {"losses": [float(v) for v in
                               torch.stack(losses).cpu()] if losses else []}


@torch.no_grad()
def evaluate(forward, params, cfg, data: SyntheticImages, batches: int = 5,
             batch: int = 256, seed0: int = 10_000) -> float:
    """Top-1 accuracy at eval over ``batches`` held-out batches, on the
    device of ``params``."""
    dev = tree_leaves(params)[0].device
    correct = total = 0
    for i in range(batches):
        x, y = data.batch(batch, seed0 + i)
        logits, _, _ = forward(params, cfg, torch.from_numpy(x).to(dev))
        correct += int((logits.argmax(-1).cpu().numpy() == y).sum())
        total += len(y)
    return correct / total


# ---------------------------------------------------------------------------
# profiling the student zoo → StudentArch entries (Eq. 5 inputs)
# ---------------------------------------------------------------------------

def profile_student(name: str, n_classes: int, final_channels: int,
                    example: np.ndarray) -> StudentArch:
    """A zoo entry's cost row: its eval forward's FLOPs on ``example``'s
    shape, counted on the ``meta`` device (the same count everywhere), and
    its parameter count."""
    cfg, params, forward = cnn.make_student(torch.Generator().manual_seed(0),
                                            name, n_classes, final_channels)
    meta = tree_to(params, torch.device("meta"))
    x = torch.empty(example.shape, dtype=torch.float32, device="meta")
    with FlopCounterMode(display=False) as counter:
        forward(meta, cfg, x)
    flops = float(counter.get_total_flops())
    n_params = cnn.count_params(params)
    return StudentArch(name=f"{name}-f{final_channels}", flops=flops,
                       params=4.0 * n_params, out_bytes=4.0 * final_channels,
                       capacity=float(n_params))


# ---------------------------------------------------------------------------
# full offline pipeline
# ---------------------------------------------------------------------------

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

    @property
    def device(self) -> torch.device:
        """Where the head (and, after training, every student) lies."""
        return self.fc["kernel"].device

    @torch.no_grad()
    def portions(self, x: torch.Tensor, arrived: Optional[np.ndarray] = None
                 ) -> torch.Tensor:
        outs = []
        for k, (cfg, params, forward) in enumerate(self.students):
            if arrived is not None and not arrived[k]:
                outs.append(None)
            else:
                _, feats, _ = forward(params, cfg, x)
                outs.append(feats)
        # batch hint keeps the beyond-quorum all-missing pattern defined
        # (zero features → FC bias) instead of raising mid-sweep
        return DS.aggregate_portions(outs, self.part_dims,
                                     batch=int(x.shape[0]),
                                     device=self.device)

    @torch.no_grad()
    def predict(self, x: torch.Tensor, arrived: Optional[np.ndarray] = None
                ) -> torch.Tensor:
        return DS.fc_head_apply(self.fc, self.portions(x, arrived))

    def accuracy(self, data: SyntheticImages, arrived=None, batches: int = 4,
                 batch: int = 256, seed0: int = 10_000) -> float:
        correct = total = 0
        for i in range(batches):
            x, y = data.batch(batch, seed0 + i)
            logits = self.predict(torch.from_numpy(x).to(self.device),
                                  arrived)
            correct += int((logits.argmax(-1).cpu().numpy() == y).sum())
            total += len(y)
        return correct / total

    def robustness_curve(self, data: SyntheticImages, *, max_losses: int = 2,
                         batches: int = 2, batch: int = 256,
                         seed0: int = 10_000) -> "FO.RobustnessCurve":
        """Measured accuracy-vs-#slot-losses export (every ≤max_losses
        pattern) — the contract :func:`repro_torch.core.planner.thin_replicas`
        consumes to trade replicas against trained-in robustness."""
        return FO.measure_robustness_curve(
            lambda m: self.accuracy(data, arrived=m, batches=batches,
                                    batch=batch, seed0=seed0),
            len(self.students), max_losses)


@dataclasses.dataclass
class TeacherBundle:
    """A trained teacher + its activation graph (shareable across planner
    variants — the offline phase's expensive part)."""
    cfg: cnn.WRNConfig
    params: Any
    acc: float
    A: np.ndarray
    data: SyntheticImages


def prepare_teacher(gen: torch.Generator, *, n_classes: int = 10,
                    teacher_depth: int = 16, teacher_widen: int = 4,
                    teacher_steps: int = 150, batch: int = 128,
                    data: Optional[SyntheticImages] = None,
                    device: DeviceLike = None,
                    timings: Optional[Dict[str, float]] = None
                    ) -> TeacherBundle:
    """Train the teacher, evaluate it and build its activation graph.
    ``timings``, when given, gets the wall seconds of ``teacher`` (training)
    and ``graph`` (evaluation and graph), the device synchronised at each
    stage's end."""
    dev = resolve_device(device)
    stages = _Stages(timings, dev)
    data = data or SyntheticImages(ImageTaskConfig(n_classes=n_classes))
    tcfg = cnn.WRNConfig(f"wrn-{teacher_depth}-{teacher_widen}", teacher_depth,
                         teacher_widen, n_classes)
    tparams, _ = train_teacher(gen, tcfg, data, steps=teacher_steps,
                               batch=batch, device=dev)
    stages.end("teacher")
    teacher_acc = evaluate(cnn.wrn_forward, tparams, tcfg, data)
    xs, _ = data.batch(256, 77_000)
    with torch.no_grad():
        _, tfeats, _ = cnn.wrn_forward(tparams, tcfg,
                                       torch.from_numpy(xs).to(dev))
        acts = AG.average_activity(tfeats)
        A = AG.activation_graph(acts).cpu().numpy()
    stages.end("graph")
    return TeacherBundle(tcfg, tparams, teacher_acc, A, data)


def build_rocoin(gen: torch.Generator, *, n_classes: int = 10,
                 teacher_depth: int = 16, teacher_widen: int = 4,
                 devices: Optional[Sequence[Device]] = None,
                 d_th: Optional[float] = None, p_th: float = 0.25,
                 teacher_steps: int = 150, student_steps: int = 150,
                 zoo: Optional[List[str]] = None,
                 data: Optional[SyntheticImages] = None,
                 planner: str = "rocoin",
                 teacher: Optional[TeacherBundle] = None,
                 failout: Optional[FO.FailoutConfig] = None,
                 batch: int = 128, device: DeviceLike = None,
                 timings: Optional[Dict[str, float]] = None) -> Ensemble:
    """Run the whole offline phase. planner ∈ {rocoin, rocoin-g, hetnonn, nonn}.

    ``gen`` is split into three generators (teacher, students, head), so a
    ``teacher`` prepared from the first of them gives the same ensemble as
    one trained here. ``failout`` appends the failure-aware phase: after
    per-student distillation and FC training, students + head are jointly
    fine-tuned on the quorum-merged prediction under sampled aliveness
    masks (:func:`failout_finetune`). ``timings``, when given, gets the
    wall seconds of each stage (``teacher``, ``graph``, ``plan``,
    ``student{k}``, ``fc``, ``failout``), the device synchronised at each
    stage's end."""
    from repro_torch.core import simulator as SIM

    dev = resolve_device(device)
    devices = list(devices) if devices is not None else SIM.make_fleet(8, seed=1)
    zoo = zoo or (cnn.STUDENT_ZOO_C10 if n_classes <= 10 else cnn.STUDENT_ZOO_C100)

    g_t, g_s, g_fc = split_generator(gen, 3)
    if teacher is None:
        teacher = prepare_teacher(g_t, n_classes=n_classes,
                                  teacher_depth=teacher_depth,
                                  teacher_widen=teacher_widen,
                                  teacher_steps=teacher_steps, batch=batch,
                                  data=data, device=dev, timings=timings)
    stages = _Stages(timings, dev)
    teacher = dataclasses.replace(teacher, params=tree_to(teacher.params, dev))
    data = teacher.data
    tcfg, tparams, teacher_acc, A = (teacher.cfg, teacher.params,
                                     teacher.acc, teacher.A)
    xs, _ = data.batch(256, 77_000)

    # student zoo profiled at a nominal final width
    M = A.shape[0]
    example = xs[:1]

    def zoo_for(final_ch: int) -> List[StudentArch]:
        return [profile_student(n, n_classes, final_ch, example) for n in zoo]

    nominal = zoo_for(max(M // max(len(devices) // 2, 1), 8))

    ir = None
    if planner == "rocoin":
        # the canonical IR is the planner's native output; the legacy Plan
        # below is a derived view for the distillation loop
        ir = (PL.make_plan_ir(devices, A, nominal, d_th=d_th, p_th=p_th)
              if d_th is not None else
              PL.tune_d_th_ir(devices, A, nominal, p_th=p_th))
        plan = ir.to_plan(devices=devices, students=nominal)
    elif planner == "rocoin-g":
        plan = PL.plan_rocoin_g(devices, A, nominal, d_th=d_th or 1.0, p_th=p_th)
    elif planner == "hetnonn":
        plan = PL.plan_hetnonn(devices, A, nominal, p_th=p_th)
    elif planner == "nonn":
        plan = PL.plan_nonn(devices, A, nominal, p_th=p_th)
    else:
        raise KeyError(planner)
    stages.end("plan")

    # distill one student per partition
    students, part_dims = [], []
    plan.groups.sort(key=lambda g: g.partition_idx)
    sgens = split_generator(g_s, max(plan.K, 1))
    for slot, g in enumerate(plan.groups):
        part = np.asarray(g.filters, np.int64)
        dim = max(len(part), 1)
        part_dims.append(dim)
        sname = (g.student.name.rsplit("-f", 1)[0] if g.student else zoo[-1])
        scfg, sparams, sfwd = cnn.make_student(sgens[slot], sname, n_classes,
                                               dim)
        sparams = _distill_student(tree_to(sparams, dev), scfg, sfwd, tparams,
                                   tcfg, part, data, steps=student_steps,
                                   batch=batch)
        students.append((scfg, sparams, sfwd))
        stages.end(f"student{slot}")

    # train the FC aggregation head on concatenated portions
    fc = tree_to(DS.fc_head_init(g_fc, sum(part_dims), n_classes), dev)
    fc = _train_fc(fc, students, part_dims, data,
                   steps=max(student_steps // 2, 10), batch=batch)
    stages.end("fc")
    if ir is None:      # baseline planners produce object plans; lift them
        ir = PlanIR.from_plan(plan, students=nominal, devices=devices)
    ens = Ensemble(plan, students, fc, part_dims, teacher_acc, ir=ir)
    if failout is not None:
        ens = failout_finetune(ens, teacher, failout, batch=batch, device=dev)
        stages.end("failout")
    return ens


def failout_finetune(ens: Ensemble, teacher: TeacherBundle,
                     cfg: FO.FailoutConfig, *, steps: Optional[int] = None,
                     batch: int = 128, lr: float = 0.01,
                     dcfg: DS.DistillConfig = DS.DistillConfig(),
                     device: DeviceLike = None) -> Ensemble:
    """Failout phase: jointly fine-tune every student AND the FC head on the
    quorum-merged prediction under sampled aliveness masks.

    Per step, the concatenated student portions are computed ONCE and the
    merged KD loss is evaluated over the leading pattern axis
    (:func:`repro_torch.core.distill.failout_merged_loss`). Masks come from
    the config's :class:`~repro_torch.core.failout.FailoutSampler` (pattern
    enumeration or the vectorized failure simulator), split per-step from a
    deterministic ``(seed, step)`` stream; the all-alive pattern is always
    pattern 0, so the failure-free path stays in the objective and does not
    regress. ``FailoutConfig(max_losses=0)`` runs the identical loop on the
    all-alive pattern only — the equal-compute failure-blind baseline.
    ``lr`` is fine-tune-scale (well below the distillation lr); the head
    runs at ``2·lr`` with no weight decay. The teacher runs at eval, with no
    gradient.

    Returns a NEW :class:`Ensemble` on ``device`` (the input is not
    mutated — benchmarks branch failout and failure-blind arms off one base
    ensemble)."""
    from repro_torch.core import simulator as SIM
    dev = resolve_device(device)
    steps = cfg.steps if steps is None else steps
    arrays = None
    if cfg.mode == "scenario":
        arrays = SIM.plan_arrays(ens.ir if ens.ir is not None else ens.plan)
    sampler = FO.FailoutSampler(cfg, n_slots=len(ens.students), arrays=arrays)
    weights = torch.as_tensor(sampler.weights(), dtype=torch.float32,
                              device=dev)
    data = teacher.data
    tparams, tcfg = tree_to(teacher.params, dev), teacher.cfg

    cfgs = [c for c, _, _ in ens.students]
    fwds = [f for _, _, f in ens.students]
    plist = [tree_to(p, dev) for _, p, _ in ens.students]
    moms = [sgd_init(p) for p in plist]
    fc = tree_to(ens.fc, dev)
    fcm = sgd_init(fc)

    for i, (x, y) in enumerate(data.epoch(batch, steps, seed0=130_000)):
        x, y = _batch(x, y, dev)
        col_masks = torch.from_numpy(DS.expand_slot_masks(
            sampler.masks(i), ens.part_dims)).to(dev)
        with torch.no_grad():
            t_logits, _, _ = cnn.wrn_forward(tparams, tcfg, x)
        ps = [trainable(p) for p in plist]
        f = trainable(fc)
        feats, newps = [], []
        for scfg, sfwd, p in zip(cfgs, fwds, ps):
            _, fk, newp = sfwd(p, scfg, x, train=True)
            feats.append(fk)
            newps.append(newp)
        loss = DS.failout_merged_loss(f, torch.cat(feats, dim=-1), t_logits,
                                      y, col_masks, weights, dcfg)
        loss.backward()
        out_p, out_m = [], []
        for p, m, newp in zip(ps, moms, newps):
            p2, m2 = sgd_update(p, _grads(p), m, lr=lr)
            out_p.append(merge_bn_stats(p2, newp))   # BN running stats only
            out_m.append(m2)
        plist, moms = out_p, out_m
        fc, fcm = sgd_update(f, _grads(f), fcm, lr=2 * lr, wd=0.0)
    students = [(c, p, fw) for (c, _, fw), p in zip(ens.students, plist)]
    return dataclasses.replace(ens, students=students, fc=fc)


def _distill_student(sparams, scfg, sfwd, tparams, tcfg, part, data,
                     steps=150, batch=128,
                     dcfg: DS.DistillConfig = DS.DistillConfig()):
    """Eq. 6 distillation of one student onto its partition ``part`` of the
    teacher's final filters, on the device of ``sparams``."""
    dev = tree_leaves(sparams)[0].device
    mom = sgd_init(sparams)
    part = torch.as_tensor(part, dtype=torch.int64, device=dev)
    for x, y in data.epoch(batch, steps, seed0=50_000):
        x, y = _batch(x, y, dev)
        with torch.no_grad():
            t_logits, t_feats, _ = cnn.wrn_forward(tparams, tcfg, x)
            t_part = t_feats[:, part]
        p = trainable(sparams)
        logits, feats, newp = sfwd(p, scfg, x, train=True)
        loss = DS.distill_loss(logits, feats, t_logits, t_part, y, dcfg)
        loss.backward()
        sparams, mom = sgd_update(p, _grads(p), mom)
        sparams = merge_bn_stats(sparams, newp)   # BN running stats only
    return sparams


def _train_fc(fc, students, part_dims, data, steps=80, batch=128):
    """Cross-entropy on the head over the students' concatenated portions
    (students at eval, no gradient), on the device of ``fc``."""
    dev = fc["kernel"].device
    m = sgd_init(fc)
    for x, y in data.epoch(batch, steps, seed0=90_000):
        x, y = _batch(x, y, dev)
        with torch.no_grad():
            feats = torch.cat([fwd(params, cfg, x)[1]
                               for cfg, params, fwd in students], dim=-1)
        f = trainable(fc)
        _xent(DS.fc_head_apply(f, feats), y).backward()
        fc, m = sgd_update(f, _grads(f), m, lr=0.1, wd=0.0)
    return fc
