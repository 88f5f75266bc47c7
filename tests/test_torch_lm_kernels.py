"""The port's LM kernels (``rmsnorm``, ``flash_attention``,
``decode_attention``) against the JAX package's.

On the CPU each wrapper runs its plain version, held here to the JAX Pallas
kernel in interpret mode (as ``tests/test_kernels.py`` runs it) and to
``repro.kernels.ref``, on inputs made from a numpy seed, within the JAX
package's own kernel tolerances: rtol/atol 3e-5 in fp32 and 3e-2 in bf16.
The CUDA kernels have no CPU mode: they are held to the plain versions on
the card by ``tests/test_torch_hopper.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(atol=3e-2, rtol=3e-2) if dtype == "bfloat16" else \
        dict(atol=3e-5, rtol=3e-5)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(a, dtype):
    """The same values for both packages: rounded once to ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# -- rmsnorm -------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 64, 256), (1, 7, 512), (2, 100, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax_kernel(shape, dtype):
    rng = np.random.default_rng(3)
    jx, tx = _pair(_normal(rng, shape), dtype)
    js, ts = _pair(_normal(rng, shape[-1:]), dtype)
    out = ops.rmsnorm(tx, ts)
    assert out.shape == shape and out.dtype == tx.dtype
    kernel = jops.rmsnorm(jx, js, block_rows=32, interpret=True)
    np.testing.assert_allclose(_np(out), _np(kernel), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(jref.rmsnorm_ref(jx, js)),
                               **_tol(dtype))


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_rmsnorm_mixed_dtypes_match_jax_ref(scale_dtype):
    """bf16 activations with an fp32 or bf16 scale (the model's params may
    differ from its compute dtype)."""
    rng = np.random.default_rng(4)
    jx, tx = _pair(_normal(rng, (3, 5, 96)), "bfloat16")
    js, ts = _pair(_normal(rng, (96,)), scale_dtype)
    out = ops.rmsnorm(tx, ts)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(jref.rmsnorm_ref(jx, js)),
                               **_tol("bfloat16"))


def test_rmsnorm_zero_rows():
    x = torch.zeros((0, 128))
    out = ops.rmsnorm(x, torch.ones(128))
    assert out.shape == (0, 128) and out.dtype == torch.float32


# -- flash_attention -------------------------------------------------------------

FLASH_SHAPES = [(1, 1, 1, 128, 64), (2, 2, 4, 256, 64), (1, 4, 2, 128, 128),
                (1, 1, 4, 7, 64)]          # the last: a ragged Sq


def _flash_inputs(B, KV, G, S, D, dtype, strided, seed=0):
    """q, k, v for both packages. ``strided`` hands the port the views a
    model makes of its projections: q of a (B, S, KV, G, D) tensor and k, v
    of (B, S, KV, D) tensors, permuted."""
    rng = np.random.default_rng(seed)
    qm = _normal(rng, (B, S, KV, G, D))
    km, vm = _normal(rng, (B, S, KV, D)), _normal(rng, (B, S, KV, D))
    jq, tq = _pair(np.ascontiguousarray(qm.transpose(0, 2, 3, 1, 4)), dtype)
    jk, tk = _pair(np.ascontiguousarray(km.transpose(0, 2, 1, 3)), dtype)
    jv, tv = _pair(np.ascontiguousarray(vm.transpose(0, 2, 1, 3)), dtype)
    if strided:
        tq = _pair(qm, dtype)[1].permute(0, 2, 3, 1, 4)
        tk = _pair(km, dtype)[1].permute(0, 2, 1, 3)
        tv = _pair(vm, dtype)[1].permute(0, 2, 1, 3)
        assert not tq.is_contiguous() and not tk.is_contiguous()
    return (jq, jk, jv), (tq, tk, tv)


@pytest.mark.parametrize("B,KV,G,S,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_kernel(B, KV, G, S, D, dtype, causal):
    (jq, jk, jv), t = _flash_inputs(B, KV, G, S, D, dtype, strided=False)
    out = ops.flash_attention(*t, causal=causal)
    assert out.shape == (B, KV, G, S, D) and out.dtype == t[0].dtype
    kernel = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                  block_kv=64, interpret=True)
    np.testing.assert_allclose(_np(out), _np(kernel), **_tol(dtype))
    np.testing.assert_allclose(
        _np(out), _np(jref.flash_attention_ref(jq, jk, jv, causal=causal)),
        **_tol(dtype))


@pytest.mark.parametrize("B,KV,G,S,D", [(2, 2, 4, 256, 64), (1, 2, 4, 7, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_strided_views_match_jax_ref(B, KV, G, S, D, dtype):
    (jq, jk, jv), t = _flash_inputs(B, KV, G, S, D, dtype, strided=True)
    out = ops.flash_attention(*t, causal=True)
    np.testing.assert_allclose(
        _np(out), _np(jref.flash_attention_ref(jq, jk, jv, causal=True)),
        **_tol(dtype))


# -- decode_attention -------------------------------------------------------------

def _decode_inputs(B, KV, G, S, D, dtype, strided, seed=1):
    """q and caches for both packages; ``strided`` hands the port views of
    a (B, S, KV, D) cache, as the model does."""
    rng = np.random.default_rng(seed)
    q = _normal(rng, (B, KV, G, D))
    km, vm = _normal(rng, (B, S, KV, D)), _normal(rng, (B, S, KV, D))
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(np.ascontiguousarray(km.transpose(0, 2, 1, 3)), dtype)
    jv, tv = _pair(np.ascontiguousarray(vm.transpose(0, 2, 1, 3)), dtype)
    if strided:
        tk = _pair(km, dtype)[1].permute(0, 2, 1, 3)
        tv = _pair(vm, dtype)[1].permute(0, 2, 1, 3)
    return (jq, jk, jv), (tq, tk, tv)


@pytest.mark.parametrize("B,KV,G,S,D", [(2, 2, 4, 256, 64),
                                        (1, 1, 8, 512, 128)])
@pytest.mark.parametrize("length", [1, 100, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax_kernel(B, KV, G, S, D, length, dtype):
    (jq, jk, jv), t = _decode_inputs(B, KV, G, S, D, dtype, strided=False)
    out = ops.decode_attention(*t, length)
    assert out.shape == (B, KV, G, D) and out.dtype == t[0].dtype
    kernel = jops.decode_attention(jq, jk, jv, jnp.int32(length),
                                   block_kv=128, interpret=True)
    np.testing.assert_allclose(_np(out), _np(kernel), **_tol(dtype))
    np.testing.assert_allclose(
        _np(out), _np(jref.decode_attention_ref(jq, jk, jv, length)),
        **_tol(dtype))


@pytest.mark.parametrize("length_kind", ["int", "tensor"])
@pytest.mark.parametrize("strided", [False, True], ids=["contig", "strided"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_length_and_views_match_jax_ref(length_kind, strided,
                                                         dtype):
    (jq, jk, jv), t = _decode_inputs(2, 2, 4, 96, 64, dtype, strided)
    length = 37 if length_kind == "int" else torch.tensor([37],
                                                          dtype=torch.int32)
    out = ops.decode_attention(*t, length)
    np.testing.assert_allclose(
        _np(out), _np(jref.decode_attention_ref(jq, jk, jv, 37)),
        **_tol(dtype))


def test_decode_attention_zero_rows():
    _, (q, k, v) = _decode_inputs(0, 2, 4, 16, 64, "float32", False)
    assert ops.decode_attention(q, k, v, 5).shape == (0, 2, 4, 64)


# -- wrappers on the CPU ----------------------------------------------------------

def test_cpu_wrappers_run_the_plain_versions_and_count_no_launch():
    _, fl = _flash_inputs(1, 2, 2, 9, 32, "float32", strided=True)
    _, dc = _decode_inputs(1, 2, 2, 16, 32, "float32", strided=True)
    x, s = torch.randn(5, 32), torch.randn(32)
    calls = [(ops.rmsnorm, ops.rmsnorm_ref, (x, s), {}),
             (ops.flash_attention, ops.flash_attention_ref, fl,
              {"causal": True}),
             (ops.decode_attention, ops.decode_attention_ref, dc + (7,), {})]
    for fn, ref, args, kw in calls:
        before = fn.launches
        out = fn(*args, **kw)
        assert fn.launches == before
        torch.testing.assert_close(out, ref(*args, **kw), rtol=0, atol=0)


def test_bad_operands_raise():
    _, (q, k, v) = _flash_inputs(1, 2, 2, 8, 32, "float32", strided=False)
    with pytest.raises(TypeError, match="one dtype"):
        ops.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="do not match"):
        ops.flash_attention(q, k[:, :1], v[:, :1])
    _, (q, k, v) = _decode_inputs(1, 2, 2, 16, 32, "float32", strided=False)
    with pytest.raises(ValueError, match="one-element"):
        ops.decode_attention(q, k, v, torch.tensor([3, 4]))
    with pytest.raises(ValueError, match="scale"):
        ops.rmsnorm(torch.randn(3, 8), torch.randn(7))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.rmsnorm(torch.randn(3, 8).double(), torch.randn(8))
