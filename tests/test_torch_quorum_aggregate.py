"""The port's ``quorum_aggregate`` and int8 quantizers against the JAX
package.

On the CPU the wrapper runs its plain version, held here to the JAX Pallas
kernel in interpret mode (fp32 atol 1e-5). The CUDA kernel itself has no
CPU mode: it is held to the plain version on the card by
``tests/test_torch_hopper.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.quorum_aggregate import quorum_aggregate as jqa  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _operands(K, B, Dk, C, mask, int8, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, (K, B, Dk)).astype(np.float32)
    b = rng.normal(size=C).astype(np.float32)
    m = np.asarray(mask, np.int32)
    if int8:
        w = rng.integers(-127, 128, (K, Dk, C)).astype(np.int8)
        s = (rng.uniform(0.5, 1.5, K) / (127 * np.sqrt(K * Dk))
             ).astype(np.float32)
    else:
        w = (rng.normal(size=(K, Dk, C)) / np.sqrt(K * Dk)).astype(np.float32)
        s = None
    return p, w, b, m, s


def _port(p, w, b, m, s, device="cpu"):
    t = [torch.from_numpy(a).to(device) for a in (p, w, b, m)]
    ts = None if s is None else torch.from_numpy(s).to(device)
    return ops.quorum_aggregate(*t, ts)


CASES = [  # K, B, Dk, C, mask, int8, JAX block_batch
    (3, 5, 4, 6, [1, 1, 1], False, 128),
    (3, 7, 8, 5, [1, 0, 1], False, 4),         # ragged B vs the block
    (4, 9, 6, 5, [1, 0, 1, 1], True, 128),     # int8 with scales
    (4, 7, 8, 3, [0, 1, 1, 0], True, 4),       # int8, ragged B
    (2, 6, 4, 10, [0, 0], False, 128),         # nothing arrived: bias only
    (3, 0, 4, 6, [1, 1, 1], False, 128),       # empty batch
]


@pytest.mark.parametrize("K,B,Dk,C,mask,int8,bb", CASES)
def test_matches_jax_kernel(K, B, Dk, C, mask, int8, bb):
    p, w, b, m, s = _operands(K, B, Dk, C, mask, int8)
    ref = jqa(jnp.asarray(p), jnp.asarray(w), jnp.asarray(b),
              jnp.asarray(m), None if s is None else jnp.asarray(s),
              block_batch=bb, interpret=True)
    out = _port(p, w, b, m, s)
    assert out.shape == (B, C) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_int8_without_scales_raises():
    p, w, b, m, _ = _operands(2, 3, 4, 5, [1, 1], True)
    with pytest.raises(ValueError, match="scales"):
        _port(p, w, b, m, None)


def test_bad_operands_raise():
    p, w, b, m, _ = _operands(2, 3, 4, 5, [1, 1], False)
    with pytest.raises(ValueError, match="do not match"):
        _port(p, w[:, :3], b, m, None)
    with pytest.raises(TypeError, match="float32"):
        _port(p.astype(np.float64), w, b, m, None)
    with pytest.raises(ValueError, match="cuda or cpu"):
        _port(p, w, b, m, None, device="meta")


def test_cpu_path_launches_no_kernel():
    before = ops.quorum_aggregate.launches
    _port(*_operands(2, 3, 4, 5, [1, 0], False))
    assert ops.quorum_aggregate.launches == before


# -- int8 quantizers: equal to the JAX package's bit for bit ------------------

@pytest.mark.parametrize("shape,axis", [((6, 11), None), ((4, 6, 5), 0),
                                        ((6, 11), 1), ((3, 3, 2, 4), 0)])
def test_quantize_weight_equals_jax_exactly(shape, axis):
    rng = np.random.default_rng(len(shape))
    w = rng.normal(size=shape).astype(np.float32)
    w.flat[0] = 0.5 * np.abs(w).max()          # exercise a rounding tie
    jq = jcomp.quantize_weight(jnp.asarray(w), axis=axis)
    tq = tcomp.quantize_weight(torch.from_numpy(w), axis=axis)
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_array_equal(
        tcomp.dequantize_weight(tq, axis=axis).numpy(),
        np.asarray(jcomp.dequantize_weight(jq, axis=axis)))


def test_dequantize_rejects_wrong_axis_scale():
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=(6, 11)).astype(np.float32))
    with pytest.raises(ValueError, match="axis"):
        tcomp.dequantize_weight(tcomp.quantize_weight(w, axis=1))


def test_quantize_tree_equals_jax():
    rng = np.random.default_rng(3)
    tree = {"a": {"kernel": rng.normal(size=(2, 3, 4)).astype(np.float32)},
            "b": rng.normal(size=(2, 5)).astype(np.float32)}
    jt = jcomp.quantize_tree({"a": {"kernel": jnp.asarray(
        tree["a"]["kernel"])}, "b": jnp.asarray(tree["b"])}, axis=0)
    tt = tcomp.quantize_tree({"a": {"kernel": torch.from_numpy(
        tree["a"]["kernel"])}, "b": torch.from_numpy(tree["b"])}, axis=0)
    for jl, tl in ((jt["a"]["kernel"], tt["a"]["kernel"]),
                   (jt["b"], tt["b"])):
        np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))
        np.testing.assert_array_equal(tl.scale.numpy(), np.asarray(jl.scale))
    np.testing.assert_array_equal(
        tcomp.dequantize_tree(tt)["a"]["kernel"].numpy(),
        np.asarray(jcomp.dequantize_tree(jt)["a"]["kernel"]))
