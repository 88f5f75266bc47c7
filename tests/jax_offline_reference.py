"""The JAX package's offline phase at the budget ``chip_smoke.py`` phase 18
holds the port to: ``build_rocoin`` with a WRN-16-4 teacher, 150 teacher
and 150 student steps at batch 128, the ``rocoin`` planner on
``make_fleet(8, seed=1)`` and failout at its default config, from
``jax.random.key(seed)``. Runs on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/jax_offline_reference.py

``--teacher-steps``/``--student-steps``/``--width`` cut the budget for a
quick look. Prints each stage's wall time as it ends, then one JSON line
with the teacher accuracy (5 × 256 held-out images), the all-alive
ensemble accuracy (4 × 256), the plan (K, widths, replicas per slot) and
the robustness curve over at most two slot losses. This is a tool of the
JAX package's side: the port imports nothing of it.
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import numpy as np

from repro.core import failout as FO
from repro.core import pipeline as PP
from repro.data.images import ImageTaskConfig, SyntheticImages


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--teacher-steps", type=int, default=150)
    ap.add_argument("--student-steps", type=int, default=150)
    ap.add_argument("--width", type=int, default=4)
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()

    data = SyntheticImages(ImageTaskConfig(n_classes=10))
    key = jax.random.key(args.seed)
    k_t, _, _ = jax.random.split(key, 3)      # build_rocoin's own split
    t0 = time.perf_counter()
    teacher = PP.prepare_teacher(k_t, n_classes=10, teacher_depth=16,
                                 teacher_widen=args.width,
                                 teacher_steps=args.teacher_steps,
                                 batch=args.batch, data=data)
    t_teacher = time.perf_counter() - t0
    print(f"teacher (training, evaluation, activation graph): "
          f"{t_teacher:.1f} s, acc {teacher.acc:.4f}", flush=True)
    t0 = time.perf_counter()
    ens = PP.build_rocoin(key, n_classes=10, teacher_depth=16,
                          teacher_widen=args.width,
                          teacher_steps=args.teacher_steps,
                          student_steps=args.student_steps, batch=args.batch,
                          planner="rocoin", teacher=teacher,
                          failout=FO.FailoutConfig())
    t_rest = time.perf_counter() - t0
    print(f"plan, distillation, FC head, failout: {t_rest:.1f} s", flush=True)
    acc = ens.accuracy(data)
    curve = ens.robustness_curve(data, max_losses=2)
    print(json.dumps({
        "seed": args.seed, "teacher_steps": args.teacher_steps,
        "student_steps": args.student_steps, "width": args.width,
        "batch": args.batch, "teacher_acc": teacher.acc,
        "ensemble_acc": acc, "K": ens.plan.K, "part_dims": ens.part_dims,
        "replicas": [int(r) for r in np.asarray(ens.ir.member).sum(1)],
        "curve_mean": [float(a) for a in curve.accuracy],
        "curve_worst": [float(a) for a in curve.worst],
        "seconds": {"teacher": t_teacher, "rest": t_rest},
        "backend": jax.default_backend()}))


if __name__ == "__main__":
    main()
