"""RoCoIn at LM scale in the port against the JAX package's
``repro.core.lm_students``, from a carried tiny teacher and carried
students (fp32, 2 layers): the activation graph (1e-5), the plan's
groups, partitions and members (equal), one distillation step and one
failout step (1e-5), bit-equal reruns, and the MoE load-balancing loss
(1e-6)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import tiny_version as jtiny  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import failout as JFO  # noqa: E402
from repro.core import lm_students as JLM  # noqa: E402
from repro.core import ncut as JNC  # noqa: E402
from repro.core.simulator import make_fleet as jfleet  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs.archs import tiny_version  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import (lm_params_from_jax,  # noqa: E402
                                 lm_students_from_jax)
from repro_torch.core import failout as TFO  # noqa: E402
from repro_torch.core import lm_students as TLM  # noqa: E402
from repro_torch.core.simulator import make_fleet as tfleet  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for PyTorch while these tests run: tier-1 runs
    six workers over the machine's cores, and the small CPU ops of eager
    training would otherwise spin against each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _teacher():
    jcfg = jtiny(jget(ARCH)).with_(n_layers=2)
    tcfg = tiny_version(get_config(ARCH)).with_(n_layers=2)
    jp = japi.init(jax.random.key(0), jcfg)
    return jcfg, tcfg, jp, lm_params_from_jax(jax.device_get(jp))


def _tokens(vocab, seed, shape=(2, 32)):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _batches(vocab, seed):
    def gen():
        i = 0
        while True:
            yield _tokens(vocab, seed + i, (2, 16))
            i += 1
    return gen


def _students(jcfg, jp, key_seed=2):
    """The JAX package's initial students (what ``distill_lm_students``
    draws), their partitions, and their port copies."""
    key = jax.random.key(key_seed)
    A = JLM.lm_activation_graph(jp, jcfg, jnp.asarray(_tokens(jcfg.vocab, 1)))
    parts = JNC.ncut_partition(A, K=2)
    students = [JLM.init_lm_student(jax.random.fold_in(key, i), jcfg, p)
                for i, p in enumerate(parts)]
    return key, parts, students, lm_students_from_jax(
        jax.device_get(students))


def _close_students(ts, js, **tol):
    for t, j in zip(ts, js):
        np.testing.assert_allclose(t.proj.numpy(), np.asarray(j.proj), **tol)
        jl, tl = jax.tree.leaves(j.params), tree_leaves(t.params)
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


def test_lm_activation_graph_matches_jax():
    jcfg, tcfg, jp, tp = _teacher()
    toks = _tokens(jcfg.vocab, 1)
    jA = JLM.lm_activation_graph(jp, jcfg, jnp.asarray(toks))
    tA = TLM.lm_activation_graph(tp, tcfg, torch.from_numpy(toks))
    assert tA.shape == (tcfg.d_model, tcfg.d_model)
    np.testing.assert_allclose(tA, jA, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jA).max()))
    np.testing.assert_allclose(
        TLM.lm_final_hidden(tp, tcfg, torch.from_numpy(toks)).numpy(),
        np.asarray(JLM.lm_final_hidden(jp, jcfg, jnp.asarray(toks))), **TOL)


def test_plan_equals_jax():
    jcfg, tcfg, jp, tp = _teacher()
    toks = _tokens(jcfg.vocab, 1)
    kw = dict(seed=1, mem_range=(1e9, 4e9), flops_range=(1e12, 5e12))
    jplan, _ = JLM.plan_lm_rocoin(jfleet(4, **kw), jp, jcfg,
                                  jnp.asarray(toks), p_th=0.3)
    tplan, _ = TLM.plan_lm_rocoin(tfleet(4, **kw), tp, tcfg,
                                  torch.from_numpy(toks), p_th=0.3)
    assert jplan.d_th == tplan.d_th and len(jplan.groups) == len(tplan.groups)
    for a, b in zip(tplan.groups, jplan.groups):
        assert a.group_idx == b.group_idx
        assert a.partition_idx == b.partition_idx
        np.testing.assert_array_equal(a.filters, b.filters)
        assert [d.name for d in a.devices] == [d.name for d in b.devices]
        assert (a.student is None) == (b.student is None)
        if a.student is not None:
            assert a.student.name == b.student.name
    filt = np.concatenate([g.filters for g in tplan.groups])
    assert sorted(filt.tolist()) == list(range(tcfg.d_model))


def test_student_configs_and_archs_equal_jax():
    jcfg, tcfg = jtiny(jget(ARCH)), tiny_version(get_config(ARCH))
    for frac in (0.25, 0.5, 1.0):
        a = TLM.student_config(tcfg, 37, width_frac=frac, depth_frac=frac)
        b = JLM.student_config(jcfg, 37, width_frac=frac, depth_frac=frac)
        for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_ff", "n_experts", "top_k", "pad_heads_to"):
            assert getattr(a, f) == getattr(b, f), f
    assert [vars(s) for s in TLM.lm_student_archs(tcfg, [40, 88])] == \
        [vars(s) for s in JLM.lm_student_archs(jcfg, [40, 88])]


def test_one_distillation_step_matches_jax():
    jcfg, tcfg, jp, tp = _teacher()
    key, parts, jst, tst = _students(jcfg, jp)
    batches = _batches(jcfg.vocab, 10)
    jout = JLM.distill_lm_students(key, jp, jcfg, parts,
                                   lambda: (jnp.asarray(t) for t in batches()),
                                   steps=1)
    toks = torch.from_numpy(next(batches()))
    outs = []
    for st in tst:
        p, pr, loss = TLM.distill_lm_step(st, tp, tcfg, toks)
        assert np.isfinite(float(loss))
        outs.append(TLM.LMStudent(st.cfg, p, pr, st.partition))
    _close_students(outs, jout, **TOL)
    # functional: the carried students are left as they were
    _close_students(tst, jst, rtol=0, atol=0)
    again = [TLM.distill_lm_step(st, tp, tcfg, toks) for st in tst]
    for (p, pr, _), o in zip(again, outs):
        assert torch.equal(pr, o.proj)
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(p), tree_leaves(o.params)))


def test_one_failout_step_matches_jax_and_reruns_bit_equal():
    jcfg, tcfg, jp, tp = _teacher()
    _, _, jst, tst = _students(jcfg, jp, key_seed=3)
    batches = _batches(jcfg.vocab, 20)
    jfc = JFO.FailoutConfig(max_losses=1, seed=9, steps=1)
    tfc = TFO.FailoutConfig(max_losses=1, seed=9, steps=1)
    jout = JLM.failout_finetune_lm(
        jst, jp, jcfg, lambda: (jnp.asarray(t) for t in batches()), jfc)
    tout = TLM.failout_finetune_lm(tst, tp, tcfg, batches, tfc)
    _close_students(tout, jout, **TOL)
    again = TLM.failout_finetune_lm(tst, tp, tcfg, batches, tfc)
    for a, b in zip(tout, again):
        assert torch.equal(a.proj, b.proj)
        assert all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(a.params), tree_leaves(b.params)))
    moved = sum(float((a.proj - s.proj).abs().sum())
                for a, s in zip(tout, tst))
    assert moved > 0
    # the merged portions through the teacher's head, either slot lost
    toks = torch.from_numpy(_tokens(tcfg.vocab, 5, (2, 16)))
    d = tcfg.d_model
    inv = TLM.merge_order(tout, d)
    with torch.no_grad():
        merged = torch.cat([TLM.student_portion(st, toks) for st in tout],
                           -1)[..., inv]
        for lost in range(2):
            mask = torch.ones(d)
            mask[tout[lost].partition] = 0.0
            logits = TT._lm_head(tp, tcfg, merged * mask)
            assert logits.shape == (2, 16, tcfg.vocab)
            assert torch.isfinite(logits).all()


def test_moe_aux_loss_matches_jax():
    jcfg = jtiny(jget("moonshot-v1-16b-a3b"))
    tcfg = tiny_version(get_config("moonshot-v1-16b-a3b"))
    jp = japi.init(jax.random.key(4), jcfg)
    lp = jax.tree.map(lambda a: a[0], jp["layers"]["ffn"])
    x = np.random.default_rng(6).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    want = JT.moe_aux_loss(lp, jcfg, jnp.asarray(x))
    got = TT.moe_aux_loss(lm_params_from_jax(jax.device_get(lp)), tcfg,
                          torch.from_numpy(x))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
