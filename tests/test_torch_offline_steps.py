"""One SGD step and a 3-step trajectory of each trainer of the port's
offline phase (``train_teacher``, ``_distill_student``, ``_train_fc``,
``failout_finetune``) against the JAX package's, from weights the JAX
package draws, on the CPU. Tolerances as in ``tests/test_torch_offline.py``:
one step's loss within 1e-5, its gradients and updated parameters within
1e-4; three steps' losses within 1e-4 and parameters within 1e-3."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import distill as JDS  # noqa: E402
from repro.core import failout as JFO  # noqa: E402
from repro.core import pipeline as JPP  # noqa: E402
from repro.data.images import ImageTaskConfig as JImageCfg  # noqa: E402
from repro.data.images import SyntheticImages as JImages  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.convert import fc_from_jax, params_from_jax  # noqa: E402
from repro_torch.core import distill as TDS  # noqa: E402
from repro_torch.core import failout as TFO  # noqa: E402
from repro_torch.core import pipeline as TPP  # noqa: E402
from repro_torch.data.images import ImageTaskConfig as TImageCfg  # noqa: E402
from repro_torch.data.images import SyntheticImages as TImages  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.tree import trainable, tree_leaves  # noqa: E402
from test_torch_offline import (BATCH, DCFG, TDCFG, _close,  # noqa: E402,F401
                                _images, _one_torch_thread, _teacher_cfgs,
                                _tree_close)

@pytest.fixture(scope="module")
def teacher():
    """A WRN-10-1 teacher (64 final filters) in both packages, the JAX
    package's weights, with BN statistics moved off their init by two
    train-mode forwards so eval mode sees real statistics."""
    jcfg, tcfg = _teacher_cfgs()
    jp = jcnn.wrn_init(jax.random.key(3), jcfg)
    fwd = jax.jit(lambda p, x: jcnn.wrn_forward(p, jcfg, x, train=True)[2])
    for s in (1, 2):
        x, _ = _images(BATCH, s)
        jp = JPP.merge_bn_stats(jp, fwd(jp, jnp.asarray(x)))
    return jcfg, jp, tcfg, params_from_jax(jax.device_get(jp))


@pytest.fixture(scope="module")
def students():
    """Two WRN-10-1 students with 8 final channels each, both packages."""
    out = []
    for k in range(2):
        jcfg, jp, jfwd = jcnn.make_student(jax.random.key(10 + k), "wrn-10-1",
                                           10, 8)
        tcfg = tcnn.WRNConfig(**dataclasses.asdict(jcfg))
        out.append(((jcfg, jp, jfwd),
                    (tcfg, params_from_jax(jax.device_get(jp)),
                     tcnn.wrn_forward)))
    return out


# -- one SGD step and a 3-step trajectory of each trainer ----------------------

def _teacher_loss_fns(jcfg, tcfg, x, y):
    def jloss(p):
        return JPP._xent(jcnn.wrn_forward(p, jcfg, jnp.asarray(x),
                                          train=True)[0], jnp.asarray(y))

    def tloss(p):
        return TPP._xent(tcnn.wrn_forward(p, tcfg, torch.from_numpy(x),
                                          train=True)[0], torch.from_numpy(y))
    return jloss, tloss


def _grad_check(jloss, tloss, jparams, tparams):
    """The loss within 1e-5 and every gradient within 1e-4 (HWIO → OIHW)."""
    jv, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    tp = trainable(tparams)
    tv = tloss(tp)
    tv.backward()
    _close(tv.detach(), jv, 1e-5, 1e-5)
    _tree_close(jg, TPP._grads(tp), 1e-4, 1e-4)


@pytest.mark.parametrize("steps,ptol", [(1, 1e-4), (3, 1e-3)])
def test_train_teacher_matches_jax(teacher, monkeypatch, steps, ptol):
    """``train_teacher`` from carried weights (lr 0.05, wd on every leaf,
    BN stats from the forward): losses within 1e-5 (one step) or 1e-4
    (three), the updated tree within ``ptol``; gradients of the first
    step within 1e-4."""
    jcfg, jp, tcfg, tp = teacher
    data_j, data_t = JImages(JImageCfg()), TImages(TImageCfg())
    if steps == 1:
        x, y = data_j.batch(BATCH, 0)
        _grad_check(*_teacher_loss_fns(jcfg, tcfg, x, y), jp, tp)
    monkeypatch.setattr(JPP.cnn, "wrn_init", lambda key, cfg: jp)
    monkeypatch.setattr(TPP.cnn, "wrn_init", lambda gen, cfg: tp)
    jout, jlog = JPP.train_teacher(jax.random.key(0), jcfg, data_j,
                                   steps=steps, batch=BATCH)
    tout, tlog = TPP.train_teacher(torch.Generator(), tcfg, data_t,
                                   steps=steps, batch=BATCH, device="cpu")
    _close(tlog["losses"], jlog["losses"], 1e-5 if steps == 1 else 1e-4,
           1e-5 if steps == 1 else 1e-4)
    _tree_close(jout, tout, ptol, ptol)


@pytest.mark.parametrize("steps,ptol", [(1, 1e-4), (3, 1e-3)])
def test_distill_student_matches_jax(teacher, students, steps, ptol):
    """``_distill_student`` (teacher at eval, no gradient; Eq. 6) from
    carried weights: gradients of the first step within 1e-4, the updated
    student tree within ``ptol``."""
    jcfg, jp, tcfg, tp = teacher
    (sj, st) = students[0]
    part = np.arange(3, 64, 8)[:8]
    if steps == 1:
        x, y = JImages(JImageCfg()).batch(BATCH, 50_000)
        tl, tf, _ = jcnn.wrn_forward(jp, jcfg, jnp.asarray(x))

        def jloss(p):
            lo, fe, _ = sj[2](p, sj[0], jnp.asarray(x), train=True)
            return JDS.distill_loss(lo, fe, tl, tf[:, part], jnp.asarray(y),
                                    DCFG)

        def tloss(p):
            with torch.no_grad():
                tl2, tf2, _ = tcnn.wrn_forward(tp, tcfg, torch.from_numpy(x))
            lo, fe, _ = st[2](p, st[0], torch.from_numpy(x), train=True)
            return TDS.distill_loss(lo, fe, tl2, tf2[:, part],
                                    torch.from_numpy(y), TDCFG)
        _grad_check(jloss, tloss, sj[1], st[1])
    jout = JPP._distill_student(sj[1], sj[0], sj[2], jp, jcfg, part,
                                JImages(JImageCfg()), steps=steps,
                                batch=BATCH)
    tout = TPP._distill_student(st[1], st[0], st[2], tp, tcfg, part,
                                TImages(TImageCfg()), steps=steps,
                                batch=BATCH)
    _tree_close(jout, tout, ptol, ptol)


@pytest.mark.parametrize("steps,ptol", [(1, 1e-4), (3, 1e-3)])
def test_train_fc_matches_jax(students, steps, ptol):
    """``_train_fc`` (lr 0.1, no weight decay, students at eval): the
    head's gradients within 1e-4 and the updated head within ``ptol``."""
    dims = [8, 8]
    fc = jax.device_get(JDS.fc_head_init(jax.random.key(5), 16, 10))
    jst = [s[0] for s in students]
    tst = [s[1] for s in students]
    if steps == 1:
        x, y = JImages(JImageCfg()).batch(BATCH, 90_000)
        jfe = jnp.concatenate([f(p, c, jnp.asarray(x))[1] for c, p, f in jst],
                              axis=-1)
        tfe = torch.cat([f(p, c, torch.from_numpy(x))[1]
                         for c, p, f in tst], dim=-1)
        _grad_check(lambda f: JPP._xent(JDS.fc_head_apply(f, jfe),
                                        jnp.asarray(y)),
                    lambda f: TPP._xent(TDS.fc_head_apply(f, tfe),
                                        torch.from_numpy(y)),
                    fc, fc_from_jax(fc))
    jout = JPP._train_fc(fc, jst, dims, JImages(JImageCfg()), steps=steps,
                         batch=BATCH)
    tout = TPP._train_fc(fc_from_jax(fc), tst, dims, TImages(TImageCfg()),
                         steps=steps, batch=BATCH)
    _tree_close(jout, tout, ptol, ptol)


def _small_ensembles(teacher, students):
    """A two-slot ensemble (8 filters each) in both packages, and the
    teacher bundle it was distilled from."""
    jcfg, jp, tcfg, tp = teacher
    fc = jax.device_get(JDS.fc_head_init(jax.random.key(6), 16, 10))
    jens = JPP.Ensemble(None, [s[0] for s in students], fc, [8, 8], 0.0)
    tens = TPP.Ensemble(None, [s[1] for s in students], fc_from_jax(fc),
                        [8, 8], 0.0)
    jt = JPP.TeacherBundle(jcfg, jp, 0.0, np.zeros((64, 64)),
                           JImages(JImageCfg()))
    tt = TPP.TeacherBundle(tcfg, tp, 0.0, np.zeros((64, 64)),
                           TImages(TImageCfg()))
    return jens, tens, jt, tt


@pytest.mark.parametrize("steps,ptol", [(1, 1e-4), (3, 1e-3)])
def test_failout_finetune_matches_jax(teacher, students, steps, ptol):
    """``failout_finetune`` from carried weights (students at ``lr``, the
    head at ``2·lr`` without weight decay, the teacher at eval): gradients
    of the first step's merged loss w.r.t. both students and the head
    within 1e-4; every updated tree within ``ptol``; the input ensemble
    untouched."""
    jens, tens, jt, tt = _small_ensembles(teacher, students)
    cfg = JFO.FailoutConfig(max_losses=1, seed=7, steps=steps)
    tcfg_fo = TFO.FailoutConfig(max_losses=1, seed=7, steps=steps)
    if steps == 1:
        x, y = JImages(JImageCfg()).batch(BATCH, 130_000)
        sampler = JFO.FailoutSampler(cfg, n_slots=2)
        cm = JDS.expand_slot_masks(sampler.masks(0), [8, 8])
        w = sampler.weights()
        tl, _, _ = jcnn.wrn_forward(jt.params, jt.cfg, jnp.asarray(x))

        def jloss(tree):
            feats = [f(tree[f"s{k}"], c, jnp.asarray(x), train=True)[1]
                     for k, (c, _, f) in enumerate(jens.students)]
            return JDS.failout_merged_loss(
                tree["fc"], jnp.concatenate(feats, -1), tl, jnp.asarray(y),
                cm, jnp.asarray(w), DCFG)

        def tloss(tree):
            with torch.no_grad():
                tl2, _, _ = tcnn.wrn_forward(tt.params, tt.cfg,
                                             torch.from_numpy(x))
            feats = [f(tree[f"s{k}"], c, torch.from_numpy(x), train=True)[1]
                     for k, (c, _, f) in enumerate(tens.students)]
            return TDS.failout_merged_loss(
                tree["fc"], torch.cat(feats, -1), tl2, torch.from_numpy(y),
                cm, w, TDCFG)
        _grad_check(jloss, tloss,
                    {"s0": jens.students[0][1], "s1": jens.students[1][1],
                     "fc": jens.fc},
                    {"s0": tens.students[0][1], "s1": tens.students[1][1],
                     "fc": tens.fc})
    before = [t.clone() for t in tree_leaves(tens.students[0][1])]
    jout = JPP.failout_finetune(jens, jt, cfg, batch=BATCH)
    tout = TPP.failout_finetune(tens, tt, tcfg_fo, batch=BATCH, device="cpu")
    _tree_close(jout.fc, tout.fc, ptol, ptol)
    for (_, a, _), (_, b, _) in zip(jout.students, tout.students):
        _tree_close(a, b, ptol, ptol)
    for a, b in zip(before, tree_leaves(tens.students[0][1])):
        assert torch.equal(a, b)
