"""The port's AdamW and gradient compression against the JAX package's.

Fed the same gradients, the schedule, the clipping and the AdamW update
(master, moments, params, fp32 and bf16 params) are held to
``repro.optim.adamw`` within 1e-6 relative, and top-k compression is
equal. The int8 scheme's dither comes from a ``torch.Generator`` here and
from ``jax.random`` there, so it is held to its invariants: ``c + r' = g +
r`` (to one fp32 ulp), every value on the ``scale`` grid, ``|c / scale| <=
127``, and a rerun with the same seed is bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as JA  # noqa: E402
from repro.optim import compression as JC  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim import compression as TC  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

REL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for PyTorch while these tests run: tier-1 runs
    six workers over the machine's cores, and the small CPU ops of eager
    training would otherwise spin against each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, scale=1.0):
    return {"a": {"w": (scale * rng.standard_normal((6, 5))).astype(np.float32),
                  "b": (scale * rng.standard_normal(5)).astype(np.float32)},
            "emb": (scale * rng.standard_normal((7, 3))).astype(np.float32)}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _close(t, a, rel=REL):
    a = np.asarray(a, np.float32)
    np.testing.assert_allclose(t.float().numpy(), a, rtol=rel,
                               atol=rel * max(1e-6, float(np.abs(a).max())))


@pytest.mark.parametrize("kw", [{}, dict(warmup_steps=3, total_steps=20),
                                dict(warmup_steps=1, total_steps=2,
                                     min_lr_ratio=0.3)])
def test_schedule_matches_jax(kw):
    jc, tc = JA.AdamWConfig(**kw), TA.AdamWConfig(**kw)
    for step in (0, 1, 2, 3, 5, 10, 19, 20, 99, 100, 101, 5000, 10000,
                 20000):
        _close(TA.schedule(tc, torch.tensor(step, dtype=torch.int32)),
               JA.schedule(jc, jnp.asarray(step, jnp.int32)))


@pytest.mark.parametrize("max_norm", [1.0, 0.05, 100.0])
def test_global_norm_and_clipping_match_jax(max_norm):
    tree = _tree(np.random.default_rng(0))
    jt, tt = jax.tree.map(jnp.asarray, tree), _torch(tree)
    _close(TA.global_norm(tt), JA.global_norm(jt))
    jc, jn = JA.clip_by_global_norm(jt, max_norm)
    tcl, tn = TA.clip_by_global_norm(tt, max_norm)
    _close(tn, jn)
    for a, b in zip(tree_leaves(tcl), jax.tree.leaves(jc)):
        _close(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [{}, dict(warmup_steps=2, total_steps=6,
                                         grad_clip=0.5, weight_decay=0.0)])
def test_adamw_update_from_equal_gradients_matches_jax(dtype, kw):
    """Three steps fed the same gradients in both packages: every master,
    moment and param leaf within 1e-6 relative, the step, grad norm and
    lr too. The update is in place: the returned trees are the given
    ones."""
    rng = np.random.default_rng(1)
    jd = getattr(jnp, dtype)
    params = jax.tree.map(lambda a: jnp.asarray(a, jd), _tree(rng))
    jcfg, tcfg = JA.AdamWConfig(**kw), TA.AdamWConfig(**kw)
    jstate = JA.init(jcfg, params)
    tparams = lm_params_from_jax(jax.device_get(params))
    tstate = TA.init(tcfg, tparams)
    for step in range(3):
        grads = _tree(rng, scale=0.3 + step)
        jg = jax.tree.map(lambda a: jnp.asarray(a, jd), grads)
        tg = lm_params_from_jax(jax.device_get(jg))
        params, jstate, jm = JA.apply_updates(jcfg, params, jg, jstate)
        out, tstate2, tm = TA.apply_updates(tcfg, tparams, tg, tstate)
        assert out is tparams and tstate2.master is tstate.master
        tstate = tstate2
        assert int(tstate.step) == int(jstate.step) == step + 1
        _close(tm["grad_norm"], jm["grad_norm"])
        _close(tm["lr"], jm["lr"])
        for name in ("master", "m", "v"):
            for a, b in zip(tree_leaves(getattr(tstate, name)),
                            jax.tree.leaves(getattr(jstate, name))):
                _close(a, b)
        for a, b in zip(tree_leaves(tparams), jax.tree.leaves(params)):
            assert a.dtype == getattr(torch, dtype)
            # a bf16 param is its master rounded: one bf16 ulp apart at most
            _close(a, np.asarray(b, np.float32),
                   REL if dtype == "float32" else 2 ** -8)


def test_adamw_init_copies_the_params():
    p = {"w": torch.ones(3)}
    st = TA.init(TA.AdamWConfig(), p)
    assert st.master["w"].data_ptr() != p["w"].data_ptr()
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert not st.m["w"].any() and not st.v["w"].any()


# -- gradient compression ----------------------------------------------------------

@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.5])
def test_topk_compression_equals_jax(ratio):
    """Two steps of error feedback: compressed gradients and residuals
    equal to the JAX package's."""
    rng = np.random.default_rng(2)
    jcfg = JC.CompressionConfig(scheme="topk", topk_ratio=ratio)
    tcfg = TC.CompressionConfig(scheme="topk", topk_ratio=ratio)
    g0 = _tree(rng)
    jst = JC.init_state(jcfg, jax.tree.map(jnp.asarray, g0))
    tst = TC.init_state(tcfg, _torch(g0))
    for _ in range(2):
        g = _tree(rng)
        jc, jst = JC.compress_grads(jcfg, jax.tree.map(jnp.asarray, g), jst)
        tc, tst = TC.compress_grads(tcfg, _torch(g), tst)
        for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(tst.residual),
                        jax.tree.leaves(jst.residual)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int(tst.step) == int(jst.step)


def test_int8_compression_invariants():
    rng = np.random.default_rng(3)
    cfg = TC.CompressionConfig(scheme="int8", seed=5)
    g0 = _torch(_tree(rng))
    st = TC.init_state(cfg, g0)
    for step in range(3):
        g = _torch(_tree(rng, scale=10.0 ** (step - 1)))
        r = st.residual
        c, st = TC.compress_grads(cfg, g, st)
        for gi, ri, ci, rn in zip(*(tree_leaves(t) for t in
                                    (g, r, c, st.residual))):
            total = gi + ri
            scale = TC._int8_scale(total)
            # c + r' = g + r: one fp32 rounding of the difference
            np.testing.assert_allclose((ci + rn).numpy(), total.numpy(),
                                       rtol=0, atol=float(
                                           torch.finfo(torch.float32).eps
                                           * total.abs().max()))
            k = torch.round(ci / scale)      # c = q · scale, q an integer
            assert torch.equal(k * scale, ci)
            assert k.abs().max() <= 127
    c2, _ = TC.compress_grads(cfg, g, TC.CompressionState(r, st.step - 1))
    for a, b in zip(tree_leaves(c), tree_leaves(c2)):
        assert torch.equal(a, b)


def test_none_scheme_and_wire_ratios_match_jax():
    g = _torch(_tree(np.random.default_rng(4)))
    st = TC.init_state(TC.CompressionConfig(), g)
    out, st2 = TC.compress_grads(TC.CompressionConfig(), g, st)
    assert out is g and st2 is st
    for kw in ({}, dict(scheme="topk", topk_ratio=0.05),
               dict(scheme="int8")):
        assert TC.compression_ratio(TC.CompressionConfig(**kw)) == \
            JC.compression_ratio(JC.CompressionConfig(**kw))
