"""The port's offline phase (``repro_torch.core.{pipeline,distill,
activation_graph}``, BN in train mode) against the JAX package's, on the
CPU at small sizes: layers, losses, the merge, the graph, the SGD update,
the FLOP count, the port's own determinism and the device rule.
``tests/test_torch_offline_steps.py`` holds each trainer's steps,
``tests/test_torch_offline_plan.py`` the plan and the carried ensemble,
``tests/test_torch_offline_band.py`` the accuracy (four files for one
slice, so that each runs well inside a worker's share of the tier-1
time).

Weights are drawn by the JAX package and carried across with
``params_from_jax`` / ``teacher_from_jax`` / ``ensemble_from_jax``; images
come from the shared ``SyntheticImages`` (the port's copy is verbatim).
Tolerances, each stated where it is used:

- layers, losses and the graph: fp32, rtol/atol 1e-5 (1e-4 where a forward
  runs a CNN: the frameworks sum each convolution in another order);
- one SGD step: the loss within 1e-5, gradients and updated parameters
  within 1e-4 (BN statistics included);
- a 3-step trajectory: losses within 1e-4 and parameters within 1e-3 (three
  updates compound the per-step rounding of the convolutions);
- plans and every numpy field: exactly equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import activation_graph as JAG  # noqa: E402
from repro.core import distill as JDS  # noqa: E402
from repro.core import failout as JFO  # noqa: E402
from repro.core import pipeline as JPP  # noqa: E402
from repro.data.images import ImageTaskConfig as JImageCfg  # noqa: E402
from repro.data.images import SyntheticImages as JImages  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.convert import fc_from_jax, params_from_jax  # noqa: E402
from repro_torch.core import activation_graph as TAG  # noqa: E402
from repro_torch.core import distill as TDS  # noqa: E402
from repro_torch.core import failout as TFO  # noqa: E402
from repro_torch.core import pipeline as TPP  # noqa: E402
from repro_torch.core.simulator import make_fleet as tmake_fleet  # noqa: E402
from repro_torch.data.images import ImageTaskConfig as TImageCfg  # noqa: E402
from repro_torch.data.images import SyntheticImages as TImages  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.tree import tree_leaves, tree_structure  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for PyTorch while these tests run: tier-1 runs
    six workers over the machine's cores, and the small CPU ops of eager
    training would otherwise spin against each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DCFG = JDS.DistillConfig()
TDCFG = TDS.DistillConfig()
BATCH = 8


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


def _tree_close(jtree, ttree, rtol, atol):
    """A JAX tree (converted: HWIO → OIHW, ``None`` dropped) against a port
    tree, leaf by leaf in sorted-key order; a missing gradient (``None``)
    in the port's tree stands for zeros."""
    jconv = params_from_jax(jax.device_get(jtree))
    assert tree_structure(jconv) == tree_structure(
        _fill_none(ttree, jconv))
    for a, b in zip(tree_leaves(jconv), tree_leaves(_fill_none(ttree, jconv))):
        assert tuple(a.shape) == tuple(b.shape)
        _close(b.detach(), a, rtol, atol)


def _fill_none(ttree, like):
    if isinstance(ttree, dict):
        return {k: _fill_none(v, like[k]) for k, v in ttree.items()}
    return torch.zeros_like(like) if ttree is None else ttree


def _images(n, seed):
    x, y = JImages(JImageCfg(n_classes=10)).batch(n, seed)
    return x, y


def _teacher_cfgs(widen=1):
    return (jcnn.WRNConfig(f"wrn-10-{widen}", 10, widen, 10),
            tcnn.WRNConfig(f"wrn-10-{widen}", 10, widen, 10))


# -- layers and models in train mode -------------------------------------------

def test_batchnorm_train_matches_jax_values_stats_and_grads():
    """y and the new statistics (biased variance, momentum on the old
    stats) within fp32 1e-5, and the gradients of a weighted sum of y."""
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (4, 5, 5, 6)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
         "bias": rng.normal(0, 0.1, 6).astype(np.float32),
         "mean": rng.normal(0, 0.1, 6).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}
    jy, jnew = jlayers.batchnorm_apply(p, jnp.asarray(x), train=True)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    ty, tnew = tlayers.batchnorm_train(tp, tx)
    _close(ty, jy, 1e-5, 1e-5)
    for k in p:
        _close(tnew[k], jnew[k], 1e-5, 1e-5)
    assert not tnew["mean"].requires_grad

    def jloss(p, x):
        return jnp.sum(jlayers.batchnorm_apply(p, x, train=True)[0] * w)
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    tq = {k: v.clone().requires_grad_(k in ("scale", "bias"))
          for k, v in tp.items()}
    tx.requires_grad_(True)
    (tlayers.batchnorm_train(tq, tx)[0] * torch.from_numpy(w)).sum().backward()
    _close(tx.grad, jgx, 1e-5, 1e-5)
    for k in ("scale", "bias"):
        _close(tq[k].grad, jg[k], 1e-5, 1e-5)


@pytest.mark.parametrize("name", ["wrn-10-1", "mobilenetv2"])
def test_train_mode_forward_matches_jax(name):
    """Logits and features within 1e-4, and the new BN tree (every
    running mean/var moved) within 1e-4, the same tree as the JAX
    package's; eval mode still hands back ``p`` itself."""
    jcfg, jp, jfwd = jcnn.make_student(jax.random.key(1), name, 10, 16)
    tcfg = (tcnn.WRNConfig if name.startswith("wrn") else tcnn.MBV2Config)(
        **dataclasses.asdict(jcfg))
    tfwd = tcnn.wrn_forward if name.startswith("wrn") else tcnn.mbv2_forward
    tp = params_from_jax(jax.device_get(jp))
    x, _ = _images(4, 0)
    jl, jf, jnew = jax.jit(jfwd, static_argnums=1, static_argnames="train")(
        jp, jcfg, jnp.asarray(x), train=True)
    tl, tf, tnew = tfwd(tp, tcfg, torch.from_numpy(x), train=True)
    _close(tl, jl, 1e-4, 1e-4)
    _close(tf, jf, 1e-4, 1e-4)
    _tree_close(jnew, tnew, 1e-4, 1e-4)
    moved = [k for k in ("mean", "var") if not torch.equal(
        tnew["bn_last" if "bn_last" in tnew else "bn_out"][k],
        tp["bn_last" if "bn_last" in tp else "bn_out"][k])]
    assert moved == ["mean", "var"]
    assert tfwd(tp, tcfg, torch.from_numpy(x))[2] is tp


# -- losses, the merge and the graph -------------------------------------------

def _logits(seed, shape):
    return np.random.default_rng(seed).normal(0, 2, shape).astype(np.float32)


def test_kd_at_and_distill_losses_match_jax_values_and_grads():
    """Values and gradients (w.r.t. student logits and features) within
    fp32 1e-5."""
    sl, tl = _logits(0, (BATCH, 10)), _logits(1, (BATCH, 10))
    sf, tf = np.abs(_logits(2, (BATCH, 6))), np.abs(_logits(3, (BATCH, 6)))
    y = np.random.default_rng(4).integers(0, 10, BATCH)

    def jall(sl, sf):
        return (JDS.kd_loss(sl, tl, y, DCFG), JDS.at_loss(sf, tf),
                JDS.distill_loss(sl, sf, tl, tf, y, DCFG))

    jvals = jall(jnp.asarray(sl), jnp.asarray(sf))
    tsl = torch.from_numpy(sl).requires_grad_(True)
    tsf = torch.from_numpy(sf).requires_grad_(True)
    ty = torch.from_numpy(y)
    tvals = (TDS.kd_loss(tsl, torch.from_numpy(tl), ty, TDCFG),
             TDS.at_loss(tsf, torch.from_numpy(tf)),
             TDS.distill_loss(tsl, tsf, torch.from_numpy(tl),
                              torch.from_numpy(tf), ty, TDCFG))
    for a, b in zip(tvals, jvals):
        _close(a.detach(), b, 1e-5, 1e-5)
    jg = jax.grad(lambda a, b: jall(a, b)[2], argnums=(0, 1))(
        jnp.asarray(sl), jnp.asarray(sf))
    tvals[2].backward()
    _close(tsl.grad, jg[0], 1e-5, 1e-5)
    _close(tsf.grad, jg[1], 1e-5, 1e-5)


@pytest.mark.parametrize("max_losses", [0, 1, 2])
def test_failout_merged_loss_matches_jax_values_and_grads(max_losses):
    """The batched pattern axis against the JAX package's vmap: the loss
    and its gradients w.r.t. the head and the features within 1e-5."""
    dims = [3, 4, 2]
    feats = np.abs(_logits(5, (BATCH, sum(dims))))
    tl = _logits(6, (BATCH, 10))
    y = np.random.default_rng(7).integers(0, 10, BATCH)
    sampler = JFO.FailoutSampler(JFO.FailoutConfig(max_losses=max_losses),
                                 n_slots=3)
    cm = JDS.expand_slot_masks(sampler.masks(0), dims)
    np.testing.assert_array_equal(
        cm, TDS.expand_slot_masks(sampler.masks(0), dims))
    w = sampler.weights()
    fc = {"kernel": _logits(8, (sum(dims), 10)) / 3, "bias": _logits(9, (10,))}

    def jloss(fc, feats):
        return JDS.failout_merged_loss(fc, feats, jnp.asarray(tl), y, cm,
                                       jnp.asarray(w), DCFG)
    jv = jloss(fc, jnp.asarray(feats))
    jg = jax.grad(jloss, argnums=(0, 1))(fc, jnp.asarray(feats))
    tfc = {k: torch.from_numpy(v).requires_grad_(True) for k, v in fc.items()}
    tfeats = torch.from_numpy(feats).requires_grad_(True)
    tv = TDS.failout_merged_loss(tfc, tfeats, torch.from_numpy(tl),
                                 torch.from_numpy(y), cm, w, TDCFG)
    _close(tv.detach(), jv, 1e-5, 1e-5)
    tv.backward()
    _close(tfeats.grad, jg[1], 1e-5, 1e-5)
    for k in fc:
        _close(tfc[k].grad, jg[0][k], 1e-5, 1e-5)


@pytest.mark.parametrize("mask", [(1, 1, 1), (1, 0, 1), (0, 1, 0), (0, 0, 0)])
def test_aggregate_portions_matches_jax(mask):
    """Every arrival pattern, the all-missing one through the ``batch``
    hint: equal values, and gradients through the portions that arrived."""
    dims = [3, 4, 2]
    por = [_logits(10 + k, (5, d)) for k, d in enumerate(dims)]
    jout = JDS.aggregate_portions(
        [jnp.asarray(p) if m else None for p, m in zip(por, mask)], dims,
        batch=5)
    tpor = [torch.from_numpy(p).requires_grad_(True) for p in por]
    tout = TDS.aggregate_portions(
        [p if m else None for p, m in zip(tpor, mask)], dims, batch=5)
    assert tout.dtype == torch.float32
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    if any(mask):
        (tout * torch.arange(tout.numel()).reshape(tout.shape)).sum(
        ).backward()
        for k, (p, m) in enumerate(zip(tpor, mask)):
            assert (p.grad is not None) == bool(m)
    with pytest.raises(ValueError):
        TDS.aggregate_portions([None] * 3, dims)


@pytest.mark.parametrize("rank", [4, 3, 2])
def test_activation_graph_matches_jax(rank):
    """``average_activity`` for every feature rank and the graph within
    1e-5 relative; symmetric with a zero diagonal."""
    shape = {4: (12, 3, 3, 16), 3: (12, 5, 16), 2: (12, 16)}[rank]
    fm = _logits(20 + rank, shape)
    ja = JAG.average_activity(jnp.asarray(fm))
    ta = TAG.average_activity(torch.from_numpy(fm))
    _close(ta, ja, 1e-5, 1e-6)
    jA = np.asarray(JAG.activation_graph(ja))
    tA = TAG.activation_graph(ta).numpy()
    _close(tA, jA, 1e-5, 1e-6 * np.abs(jA).max())
    np.testing.assert_array_equal(tA, tA.T)
    assert (np.diag(tA) == 0).all()
    _close(TAG.degree(torch.from_numpy(tA)), np.asarray(JAG.degree(jA)),
           1e-5, 1e-6 * np.abs(jA).max())
    _close(TAG.filter_importance(ta), JAG.filter_importance(ja), 1e-5, 1e-7)


def test_sgd_update_formula():
    """``g += wd·p`` on every float leaf (a missing gradient is zero),
    ``m = 0.9·m + g``, ``p -= lr·m``; ``merge_bn_stats`` then takes only
    ``mean``/``var`` from the forward's tree. Exact against the JAX
    package on the same fp32 values."""
    rng = np.random.default_rng(0)
    p = {"conv": {"kernel": rng.normal(size=(3, 3)).astype(np.float32)},
         "bn": {k: rng.normal(size=4).astype(np.float32)
                for k in ("scale", "bias", "mean", "var")}}
    g = {"conv": {"kernel": rng.normal(size=(3, 3)).astype(np.float32)},
         "bn": {k: (rng.normal(size=4).astype(np.float32)
                    if k in ("scale", "bias") else np.zeros(4, np.float32))
                for k in ("scale", "bias", "mean", "var")}}
    m = jax.tree.map(lambda a: 0.5 * a, g)
    new = {"conv": {"kernel": np.zeros((3, 3), np.float32)},
           "bn": {k: np.full(4, 7.0, np.float32)
                  for k in ("scale", "bias", "mean", "var")}}
    jp, jm = JPP.sgd_update(p, g, m, lr=0.1)
    jp = JPP.merge_bn_stats(jp, new)
    tt = fc_from_jax
    tg = tt(g)
    tg["bn"]["mean"] = tg["bn"]["var"] = None
    tp, tm = TPP.sgd_update(tt(p), tg, tt(m), lr=0.1)
    tp = TPP.merge_bn_stats(tp, tt(new))
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        _close(b, a, 1e-7, 1e-7)
    for a, b in zip(jax.tree.leaves(jm), tree_leaves(tm)):
        _close(b, a, 1e-7, 1e-7)
    assert (tp["bn"]["mean"] == 7.0).all() and (tp["bn"]["scale"] != 7).all()


# -- profiling and planning ----------------------------------------------------

@pytest.mark.parametrize("name", ["wrn-22-1", "wrn-16-1", "mobilenetv2",
                                  "wrn-16-3", "wrn-16-2"])
def test_profile_student_counts_within_band_of_xla(name):
    """The FLOP count (``torch.utils.flop_counter`` on the meta device:
    matrix products and convolutions only) within 0.9-1.2x of XLA's cost
    analysis at final width 64; parameter counts equal."""
    ex = np.zeros((1, 32, 32, 3), np.float32)
    j = JPP.profile_student(name, 10, 64, ex)
    t = TPP.profile_student(name, 10, 64, ex)
    assert 0.9 <= t.flops / j.flops <= 1.2, (name, t.flops / j.flops)
    assert (t.name, t.params, t.out_bytes, t.capacity) == \
        (j.name, j.params, j.out_bytes, j.capacity)


# -- failout determinism (ports of tests/test_failout.py) -----------------------

@pytest.fixture(scope="module")
def tiny():
    """The port's own tiny ensemble, as ``tests/test_failout.py`` builds
    the JAX package's."""
    data = TImages(TImageCfg(n_classes=10))
    teacher = TPP.prepare_teacher(TPP.split_generator(
                                      torch.Generator().manual_seed(0), 3)[0],
                                  teacher_depth=10, teacher_widen=1,
                                  teacher_steps=3, batch=16, data=data,
                                  device="cpu")
    ens = TPP.build_rocoin(torch.Generator().manual_seed(0), teacher_depth=10,
                           teacher_widen=1, teacher_steps=3, student_steps=2,
                           batch=16, devices=tmake_fleet(
                               4, seed=1, mem_range=(1.2e6, 4e6)),
                           zoo=["wrn-10-1"], teacher=teacher, data=data,
                           device="cpu")
    return ens, teacher


def _trees_equal(a, b):
    for la, lb in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_array_equal(la.numpy(), lb.numpy())


def test_finetune_bit_identical_across_runs(tiny):
    ens, teacher = tiny
    cfg = TFO.FailoutConfig(max_losses=1, seed=7, steps=3)
    a = TPP.failout_finetune(ens, teacher, cfg, batch=16, device="cpu")
    b = TPP.failout_finetune(ens, teacher, cfg, batch=16, device="cpu")
    _trees_equal(a.fc, b.fc)
    for (_, pa, _), (_, pb, _) in zip(a.students, b.students):
        _trees_equal(pa, pb)
    # and it actually trained: the head moved off the base ensemble
    delta = sum(float((la - lb).abs().sum()) for la, lb in
                zip(tree_leaves(a.fc), tree_leaves(ens.fc)))
    assert delta > 0


def test_scenario_mode_bit_identical(tiny):
    from repro_torch.core.scenarios import StragglerScenario
    ens, teacher = tiny
    cfg = TFO.FailoutConfig(mode="scenario", n_samples=3, seed=11, steps=2,
                            scenario=StragglerScenario())
    a = TPP.failout_finetune(ens, teacher, cfg, batch=16, device="cpu")
    b = TPP.failout_finetune(ens, teacher, cfg, batch=16, device="cpu")
    _trees_equal(a.fc, b.fc)


def test_all_alive_accuracy_survives_failout(tiny):
    ens, teacher = tiny
    cfg = TFO.FailoutConfig(max_losses=1, seed=7, steps=3)
    tuned = TPP.failout_finetune(ens, teacher, cfg, batch=16, device="cpu")
    curve = tuned.robustness_curve(teacher.data, max_losses=1, batches=1,
                                   batch=64)
    assert curve.losses.tolist() == [0, 1]
    assert np.isfinite(curve.accuracy).all()


def test_same_seed_same_ensemble(tiny):
    """The port's offline phase is deterministic from its generator on the
    CPU, and a build that trains its own teacher equals one handed the
    teacher that the first of its generator's three splits prepares: the
    same students and head, bit for bit."""
    ens, teacher = tiny
    kw = dict(teacher_depth=10, teacher_widen=1, teacher_steps=3,
              student_steps=2, batch=16, zoo=["wrn-10-1"],
              devices=tmake_fleet(4, seed=1, mem_range=(1.2e6, 4e6)),
              data=teacher.data, device="cpu")
    own = TPP.build_rocoin(torch.Generator().manual_seed(0), **kw)
    g_t = TPP.split_generator(torch.Generator().manual_seed(0), 3)[0]
    handed = TPP.build_rocoin(
        torch.Generator().manual_seed(0), teacher=TPP.prepare_teacher(
            g_t, teacher_depth=10, teacher_widen=1, teacher_steps=3,
            batch=16, data=teacher.data, device="cpu"), **kw)
    for other in (own, handed):
        _trees_equal(ens.fc, other.fc)
        for (_, pa, _), (_, pb, _) in zip(ens.students, other.students):
            _trees_equal(pa, pb)


# -- the device rule -----------------------------------------------------------

@pytest.mark.parametrize("planner", ["rocoin", "rocoin-g", "hetnonn",
                                     "nonn"])
def test_every_planner_builds_a_servable_ensemble(tiny, planner):
    """``build_rocoin`` under each of the four planners: one student per
    slot of the lifted IR, sized to its partition, and the head over their
    concatenated portions; ``predict`` gives finite logits."""
    _, teacher = tiny
    ens = TPP.build_rocoin(
        torch.Generator().manual_seed(1), teacher_depth=10, teacher_widen=1,
        student_steps=1, batch=16, planner=planner, zoo=["wrn-10-1"],
        devices=tmake_fleet(4, seed=1, mem_range=(1.2e6, 4e6)),
        teacher=teacher, device="cpu")
    assert ens.ir is not None and len(ens.students) == ens.ir.K
    assert ens.part_dims == [max(int(n), 1) for n in
                             ens.ir.partition.sum(1)]
    assert tuple(ens.fc["kernel"].shape) == (sum(ens.part_dims), 10)
    x, _ = teacher.data.batch(4, 1)
    assert torch.isfinite(ens.predict(torch.from_numpy(x))).all()


def test_offline_entry_points_refuse_the_cpu_unasked(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ens, teacher = tiny
    gen = torch.Generator().manual_seed(0)
    jcfg = tcnn.WRNConfig("wrn-10-1", 10, 1, 10)
    for call in (lambda: TPP.build_rocoin(gen),
                 lambda: TPP.prepare_teacher(gen),
                 lambda: TPP.train_teacher(gen, jcfg, teacher.data, steps=1),
                 lambda: TPP.failout_finetune(ens, teacher,
                                              TFO.FailoutConfig())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
