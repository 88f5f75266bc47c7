"""The port's CNN students against the JAX package's, on the CPU.

Parameters in the JAX package's own tree (the structure and shapes its
``make_student`` builds, filled from a numpy seed, with random BatchNorm
statistics so the running mean/var/scale/bias really carry across) go
through ``params_from_jax``; both forwards then see the same NHWC images.
Features and logits agree to atol 1e-4: the two frameworks sum each
convolution in a different order.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models import cnn as jcnn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.convert import fc_from_jax, params_from_jax  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.tree import tree_leaves, tree_structure  # noqa: E402

ATOL = 1e-4


def _jax_student(name, n_classes, width, seed):
    """``cnn.make_student``'s config, forward and parameter tree, with
    numpy-drawn values (He-scaled conv/dense kernels, random BN stats)."""
    built = {}

    def init(key):          # traced once for shapes: no values are drawn
        cfg, params, fwd = jcnn.make_student(key, name, n_classes, width)
        built.update(cfg=cfg, fwd=fwd)
        return params

    shapes = jax.eval_shape(init, jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(tree):
        if isinstance(tree, dict):
            if set(tree) == {"scale", "bias", "mean", "var"}:
                ch = tree["scale"].shape[0]
                return {"scale": rng.uniform(0.5, 1.5, ch),
                        "bias": rng.normal(0, 0.1, ch),
                        "mean": rng.normal(0, 0.1, ch),
                        "var": rng.uniform(0.5, 2.0, ch)}
            return {k: fill(v) for k, v in tree.items()}
        if tree is None:
            return None
        fan_in = int(np.prod(tree.shape[:-1])) or 1
        return rng.normal(0, np.sqrt(2.0 / fan_in), tree.shape)

    params = jax.tree.map(lambda a: np.asarray(a, np.float32), fill(shapes))
    return built["cfg"], params, built["fwd"]


def _port_cfg(cfg):
    return getattr(tcnn, type(cfg).__name__)(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", ["wrn-10-1", "mobilenetv2"])
def test_student_forward_matches_jax(name):
    cfg, params, fwd = _jax_student(name, 10, 8, seed=0)
    x = np.random.default_rng(1).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    jl, jf = jax.jit(lambda p, x: fwd(p, cfg, x)[:2])(params, x)
    tfwd = tcnn.wrn_forward if name.startswith("wrn") else tcnn.mbv2_forward
    tl, tf, _ = tfwd(params_from_jax(params), _port_cfg(cfg),
                     torch.from_numpy(x))
    assert tf.shape == (3, 8) and tl.shape == (3, 10)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


@pytest.mark.parametrize("name", ["wrn-16-1", "wrn-22-1", "mobilenetv2"])
def test_port_init_has_the_converted_layout(name):
    """The port's own initialiser builds the tree ``params_from_jax`` gives
    (same keys, OIHW shapes, dtypes), so either feeds the same forward and
    the fused export's stacking check."""
    _, jp, _ = _jax_student(name, 10, 32, seed=0)
    _, tp, _ = tcnn.make_student(torch.Generator().manual_seed(0), name, 10,
                                 32)
    conv = params_from_jax(jp)
    assert tree_structure(tp) == tree_structure(conv)
    assert [(t.shape, t.dtype) for t in tree_leaves(tp)] == \
        [(t.shape, t.dtype) for t in tree_leaves(conv)]


@pytest.mark.parametrize("size,k,stride,groups", [
    (32, 3, 1, 1), (32, 3, 2, 1), (16, 1, 2, 1), (9, 3, 2, 1), (8, 3, 1, 4)])
def test_conv_same_padding_matches_xla(size, k, stride, groups):
    """XLA's "SAME" puts the odd padding pixel after; so must the port."""
    rng = np.random.default_rng(size * 10 + k)
    cin, cout = 4, 8
    w = rng.standard_normal((k, k, cin // groups, cout)).astype(np.float32)
    x = rng.standard_normal((2, size, size, cin)).astype(np.float32)
    y = jlayers.conv2d_apply({"kernel": w}, x, stride=stride, groups=groups)
    t = tlayers.conv2d_apply(params_from_jax({"kernel": w}),
                             torch.from_numpy(x), stride=stride,
                             groups=groups)
    np.testing.assert_allclose(t.numpy(), np.asarray(y), atol=1e-5)


def test_dense_and_batchnorm_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    fc = {"kernel": rng.standard_normal((6, 3)).astype(np.float32),
          "bias": rng.standard_normal(3).astype(np.float32)}
    np.testing.assert_allclose(
        tlayers.dense_apply(fc_from_jax(fc), torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.dense_apply(fc, x)), atol=1e-6)
    bn = {"scale": rng.uniform(0.5, 1.5, 6), "bias": rng.normal(size=6),
          "mean": rng.normal(size=6), "var": rng.uniform(0.5, 2.0, 6)}
    bn = {k: v.astype(np.float32) for k, v in bn.items()}
    y, _ = jlayers.batchnorm_apply(bn, x)
    np.testing.assert_allclose(
        tlayers.batchnorm_apply(params_from_jax(bn), torch.from_numpy(x))
        .numpy(), np.asarray(y), atol=1e-6)
