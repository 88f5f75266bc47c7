"""The plan and the carried ensemble of the port's offline phase against
the JAX package's, on the CPU: ``build_rocoin``'s plan on a carried JAX
teacher (numpy fields exactly equal) and ``ensemble_from_jax``
(``predict`` within 1e-4). ``tests/test_torch_offline_band.py`` holds the
accuracy."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import pipeline as JPP  # noqa: E402
from repro.core.simulator import make_fleet as jmake_fleet  # noqa: E402
from repro.data.images import ImageTaskConfig as JImageCfg  # noqa: E402
from repro.data.images import SyntheticImages as JImages  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.convert import (ensemble_from_jax,  # noqa: E402
                                 teacher_from_jax)
from repro_torch.core import pipeline as TPP  # noqa: E402
from repro_torch.core.simulator import make_fleet as tmake_fleet  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from test_torch_offline import _close, _one_torch_thread  # noqa: E402,F401

@pytest.fixture(scope="module")
def jax_teacher():
    """The JAX package's WRN-10-1 teacher (64 final filters), 3 steps at
    batch 16 from key 0 (the plan needs its graph, not its accuracy)."""
    return JPP.prepare_teacher(jax.random.key(0), data=JImages(JImageCfg()),
                               teacher_depth=10, teacher_widen=1,
                               teacher_steps=3, batch=16)


def _untrained(monkeypatch):
    """Skip the distillation and head training loops (the plan is made
    before them)."""
    for pp in (JPP, TPP):
        monkeypatch.setattr(pp, "_distill_student",
                            lambda sparams, *a, **k: sparams)
        monkeypatch.setattr(pp, "_train_fc", lambda fc, *a, **k: fc)


@pytest.fixture(scope="module")
def carried(jax_teacher):
    """The JAX package's ensemble over the phase's fleet
    (``make_fleet(8, seed=1)``, the CIFAR-10 zoo) on its teacher, beside
    the port's ensemble built on the carried teacher; students and head
    left at their initial weights."""
    with pytest.MonkeyPatch.context() as mp:
        _untrained(mp)
        jens = JPP.build_rocoin(jax.random.key(0), batch=16,
                                devices=jmake_fleet(8, seed=1),
                                teacher=jax_teacher)
        tens = TPP.build_rocoin(torch.Generator().manual_seed(0), batch=16,
                                devices=tmake_fleet(8, seed=1),
                                teacher=teacher_from_jax(jax_teacher),
                                device="cpu")
    return jens, tens


def test_build_rocoin_plan_equals_jax_with_carried_teacher(carried):
    """The plan the port builds on the JAX teacher's activation graph:
    ``member``, ``partition``, ``student_of``, ``group_idx`` and
    ``part_dims`` equal, each slot's zoo entry the same."""
    jens, tens = carried
    for f in ("member", "partition", "student_of", "group_idx"):
        np.testing.assert_array_equal(getattr(tens.ir, f),
                                      getattr(jens.ir, f))
    assert tens.part_dims == jens.part_dims
    assert [c for c, _, _ in tens.students] == [
        tcnn.WRNConfig(**dataclasses.asdict(c)) if isinstance(
            c, jcnn.WRNConfig) else tcnn.MBV2Config(**dataclasses.asdict(c))
        for c, _, _ in jens.students]


def test_ensemble_from_jax_predicts_as_jax(carried):
    """A JAX ensemble carried whole: the same plan arrays, and
    ``predict`` within 1e-4 all alive, with slot 1 lost, and with every
    slot lost (the head's bias)."""
    jens, _ = carried
    tens = ensemble_from_jax(jens)
    for f in dataclasses.fields(jens.ir):
        a = getattr(jens.ir, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, getattr(tens.ir, f.name))
    assert tens.plan.K == jens.plan.K
    x, _ = JImages(JImageCfg()).batch(4, 10_000)
    K = len(jens.students)
    for arrived in [None, np.arange(K) != 1, np.zeros(K, bool)]:
        jl = jens.predict(jnp.asarray(x), arrived)
        tl = tens.predict(torch.from_numpy(x), arrived)
        _close(tl, jl, 1e-4, 1e-4)


# -- accuracy against the JAX package ------------------------------------------
