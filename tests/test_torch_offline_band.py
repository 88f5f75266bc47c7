"""The accuracy of the port's offline phase against the JAX package's, on
the CPU, at a small budget and from the same initial weights (drawn by the
JAX package and carried across): the teacher's and the all-alive
ensemble's accuracy within ±0.05."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import distill as JDS  # noqa: E402
from repro.core import pipeline as JPP  # noqa: E402
from repro.core.simulator import make_fleet as jmake_fleet  # noqa: E402
from repro.data.images import ImageTaskConfig as JImageCfg  # noqa: E402
from repro.data.images import SyntheticImages as JImages  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.convert import (fc_from_jax, params_from_jax,  # noqa: E402
                                 teacher_from_jax)
from repro_torch.core import pipeline as TPP  # noqa: E402
from repro_torch.core.simulator import make_fleet as tmake_fleet  # noqa: E402
from repro_torch.data.images import ImageTaskConfig as TImageCfg  # noqa: E402
from repro_torch.data.images import SyntheticImages as TImages  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from test_torch_offline import (_one_torch_thread,  # noqa: E402,F401
                                _teacher_cfgs)

TEACHER_BUDGET = dict(teacher_depth=10, teacher_widen=1, teacher_steps=150,
                      batch=32)


@pytest.fixture(scope="module")
def jax_teacher():
    """The JAX package's WRN-10-1 teacher (64 final filters), 150 steps at
    batch 32 from key 0, with its activation graph."""
    return JPP.prepare_teacher(jax.random.key(0), data=JImages(JImageCfg()),
                               **TEACHER_BUDGET)


FLEET2 = dict(n=2, seed=1)         # two 32-filter slots on a 64-filter teacher


@pytest.fixture(scope="module")
def trained_pair(jax_teacher):
    """Both packages' offline phase from the SAME initial weights (drawn
    by the JAX package and carried across) at one small budget: the
    teacher as ``jax_teacher`` (WRN-10-1, 150 steps at batch 32), then
    ``build_rocoin`` on the JAX teacher with two WRN-10-1 students over
    ``make_fleet(2, seed=1)``'s plan, 40 steps each at batch 32, and the
    head. Returns the teacher and all-alive ensemble accuracies, JAX
    first."""
    jcfg, tcfg = _teacher_cfgs()
    with pytest.MonkeyPatch.context() as mp:
        init = jax.device_get(jcnn.wrn_init(jax.random.key(0), jcfg))
        mp.setattr(TPP.cnn, "wrn_init", lambda gen, cfg: params_from_jax(
            init))
        tp, _ = TPP.train_teacher(torch.Generator(), tcfg, TImages(
            TImageCfg()), steps=TEACHER_BUDGET["teacher_steps"],
            batch=TEACHER_BUDGET["batch"], device="cpu")
    t_acc = TPP.evaluate(tcnn.wrn_forward, tp, tcfg, TImages(TImageCfg()))

    kw = dict(teacher_depth=10, teacher_widen=1, student_steps=40, batch=32,
              zoo=["wrn-10-1"])
    jens = JPP.build_rocoin(jax.random.key(0), devices=jmake_fleet(**FLEET2),
                            teacher=jax_teacher, **kw)
    # the JAX run's student and head keys, in the order it draws them;
    # build_rocoin first profiles the zoo's one entry (no key: the port's
    # own draw), then makes one student per slot
    _, k_s, k_fc = jax.random.split(jax.random.key(0), 3)
    keys = iter([None, *jax.random.split(k_s, len(jens.students))])
    own = tcnn.make_student
    with pytest.MonkeyPatch.context() as mp:
        def make_student(gen, name, n_classes, width):
            key = next(keys)
            if key is None:
                return own(gen, name, n_classes, width)
            cfg, p, _ = jcnn.make_student(key, name, n_classes, width)
            return (tcnn.WRNConfig(**dataclasses.asdict(cfg)),
                    params_from_jax(jax.device_get(p)), tcnn.wrn_forward)
        mp.setattr(TPP.cnn, "make_student", make_student)
        mp.setattr(TPP.DS, "fc_head_init", lambda gen, d, c: fc_from_jax(
            jax.device_get(JDS.fc_head_init(k_fc, d, c))))
        tens = TPP.build_rocoin(torch.Generator(),
                                devices=tmake_fleet(**FLEET2),
                                teacher=teacher_from_jax(jax_teacher),
                                device="cpu", **kw)
    return (jax_teacher.acc, jens.accuracy(JImages(JImageCfg())),
            t_acc, tens.accuracy(TImages(TImageCfg())))


def test_accuracy_band_against_jax(trained_pair):
    """From the same initial weights, the teacher's accuracy (1280
    held-out images) and the all-alive ensemble's (1024) within ±0.05 of
    the JAX package's at the same budget (about three standard errors of
    a 1000-image accuracy near 0.8, σ ≈ 0.013; the runs part only by the
    frameworks' rounding), with the JAX run well above chance (0.1)."""
    jt, je, tt, te = trained_pair
    assert jt > 0.5 and je > 0.5, (jt, je)
    assert abs(tt - jt) <= 0.05, (tt, jt)
    assert abs(te - je) <= 0.05, (te, je)
