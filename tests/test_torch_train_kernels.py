"""The backward of the port's two training kernels, ``rmsnorm`` and
``flash_attention``, against the JAX package.

The JAX package trains through plain ``jnp`` under ``jax.value_and_grad``
(``repro.models.layers.rmsnorm_apply``, ``repro.models.transformer
.full_attention``); it has no backward kernel. On the CPU the port's
backward wrappers run their plain versions, written as the formulas
(``rmsnorm_bwd_ref``, ``flash_attention_bwd_ref``), held here to
``jax.vjp`` of those reference functions and to torch autograd of the
port's plain forwards (fp32, 1e-5), on inputs made from a numpy seed. The
``torch.autograd.Function`` around each kernel is exercised on its CPU
route: saved tensors, views, dtypes and ``None`` gradients for ``eps`` and
``causal``. The CUDA backward kernels are held to the plain versions on
the card by ``tests/test_torch_hopper.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for PyTorch while these tests run: tier-1 runs
    six workers over the machine's cores, and the small CPU ops of eager
    training would otherwise spin against each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# -- rmsnorm -------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 16, 64), (3, 100), (1, 5, 2048)])
def test_rmsnorm_bwd_ref_matches_jax_vjp(shape):
    rng = np.random.default_rng(1)
    x, g = _normal(rng, shape), _normal(rng, shape)
    s = 1 + _normal(rng, shape[-1:], 0.1)
    _, vjp = jax.vjp(lambda xx, ss: JL.rmsnorm_apply({"scale": ss}, xx),
                     jnp.asarray(x), jnp.asarray(s))
    jdx, jds = vjp(jnp.asarray(g))
    dx, ds = ops.rmsnorm_bwd_ref(_t(x), _t(s), _t(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("eps", [1e-6, 1e-2])
def test_rmsnorm_bwd_ref_matches_autograd_of_the_plain_forward(eps):
    rng = np.random.default_rng(2)
    x = _t(_normal(rng, (6, 48))).requires_grad_()
    s = _t(1 + _normal(rng, (48,), 0.1)).requires_grad_()
    g = _t(_normal(rng, (6, 48)))
    ops.rmsnorm_ref(x, s, eps=eps).backward(g)
    dx, ds = ops.rmsnorm_bwd_ref(x.detach(), s.detach(), g, eps)
    np.testing.assert_allclose(dx.numpy(), x.grad.numpy(), **TOL)
    np.testing.assert_allclose(ds.numpy(), s.grad.numpy(), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("needs", ["both", "x", "scale"])
def test_rmsnorm_function_cpu_route(dtype, needs):
    """The Function on CPU tensors: the plain forward, the plain backward,
    gradients in each leaf's dtype, and only where one is needed; a view
    of x goes through; nothing is launched."""
    rng = np.random.default_rng(3)
    base = _t(_normal(rng, (2, 5, 32))).to(dtype)
    x = base.clone().requires_grad_(needs in ("both", "x"))
    s = _t(1 + _normal(rng, (32,), 0.1)).to(dtype).requires_grad_(
        needs in ("both", "scale"))
    g = _t(_normal(rng, (2, 4, 32))).to(dtype)
    launches = (ops.rmsnorm.launches, ops.rmsnorm_bwd.launches)
    y = ops.rmsnorm(x[:, 1:], s, eps=1e-5)
    assert y.grad_fn is not None and y.dtype == dtype
    torch.testing.assert_close(y, ops.rmsnorm_ref(x[:, 1:].detach(),
                                                  s.detach(), eps=1e-5),
                               rtol=0, atol=0)
    y.backward(g)
    dx, ds = ops.rmsnorm_bwd_ref(x[:, 1:].detach(), s.detach(), g, 1e-5)
    if x.requires_grad:
        assert x.grad.dtype == dtype
        assert torch.equal(x.grad[:, 1:], dx) and not x.grad[:, 0].any()
    else:
        assert x.grad is None
    if s.requires_grad:
        assert s.grad.dtype == dtype and torch.equal(s.grad, ds)
    else:
        assert s.grad is None
    assert (ops.rmsnorm.launches, ops.rmsnorm_bwd.launches) == launches


def test_rmsnorm_without_grad_is_the_plain_forward():
    x = torch.randn(3, 16)
    s = torch.ones(16, requires_grad=True)
    with torch.no_grad():
        y = ops.rmsnorm(x, s)
    assert y.grad_fn is None
    assert ops.rmsnorm(x, s.detach()).grad_fn is None


# -- flash attention -------------------------------------------------------------

def _jax_cfg(H, KV, hd):
    return jget("llama3.2-1b").with_(d_model=H * hd, n_heads=H,
                                     n_kv_heads=KV)


def _port_layout(q, k, v, KV):
    """(B, S, H, hd) / (B, S, KV, hd) → the kernels' views."""
    B, Sq, H, hd = q.shape
    return (q.view(B, Sq, KV, H // KV, hd).permute(0, 2, 3, 1, 4),
            k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3))


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd", [(2, 16, 16, 4, 2, 32),
                                             (1, 9, 9, 4, 1, 64),
                                             (2, 12, 20, 6, 3, 32),
                                             (1, 20, 7, 2, 2, 32),
                                             (1, 1, 13, 8, 2, 96)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_ref_matches_jax_vjp(B, Sq, Skv, H, KV, hd,
                                                 causal):
    rng = np.random.default_rng(Sq + Skv)
    q, do = _normal(rng, (B, Sq, H, hd)), _normal(rng, (B, Sq, H, hd))
    k, v = _normal(rng, (B, Skv, KV, hd)), _normal(rng, (B, Skv, KV, hd))
    cfg = _jax_cfg(H, KV, hd)
    jo, vjp = jax.vjp(lambda a, b, c: JT.full_attention(cfg, a, b, c,
                                                        causal=causal),
                      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(do))
    tq, tk, tv = _port_layout(_t(q), _t(k), _t(v), KV)
    tdo = _port_layout(_t(do), _t(k), _t(v), KV)[0]
    o = ops.flash_attention_ref(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(
        o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).numpy(),
        np.asarray(jo), **TOL)
    dq, dk, dv = ops.flash_attention_bwd_ref(tq, tk, tv, o, tdo, causal)
    np.testing.assert_allclose(
        dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).numpy(),
        np.asarray(jdq), **TOL)
    np.testing.assert_allclose(dk.permute(0, 2, 1, 3).numpy(),
                               np.asarray(jdk), **TOL)
    np.testing.assert_allclose(dv.permute(0, 2, 1, 3).numpy(),
                               np.asarray(jdv), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Skv", [(10, 10), (6, 11), (11, 4)])
def test_flash_attention_bwd_ref_matches_autograd_of_the_plain_forward(
        causal, Sq, Skv):
    rng = np.random.default_rng(7)
    q = _t(_normal(rng, (2, 2, 3, Sq, 32))).requires_grad_()
    k = _t(_normal(rng, (2, 2, Skv, 32))).requires_grad_()
    v = _t(_normal(rng, (2, 2, Skv, 32))).requires_grad_()
    do = _t(_normal(rng, (2, 2, 3, Sq, 32)))
    o = ops.flash_attention_ref(q, k, v, causal=causal)
    o.backward(do)
    got = ops.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                      o.detach(), do, causal)
    for a, t in zip(got, (q, k, v)):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("needs", ["qkv", "q", "kv"])
def test_flash_attention_function_cpu_route(dtype, needs):
    """The Function on the model's views: q as a permuted view of a
    projection, k and v views of theirs; each gradient in the input's
    dtype and only where one is needed; ``causal`` gets none."""
    rng = np.random.default_rng(4)
    B, S, KV, G, D = 2, 9, 2, 2, 32
    qm = _t(_normal(rng, (B, S, KV * G, D))).to(dtype)
    km = _t(_normal(rng, (B, S, KV, D))).to(dtype)
    qm.requires_grad_("q" in needs)
    km.requires_grad_("k" in needs)
    q = qm.view(B, S, KV, G, D).permute(0, 2, 3, 1, 4)
    k = km.permute(0, 2, 1, 3)
    launches = (ops.flash_attention.launches,
                ops.flash_attention_bwd.launches)
    o = ops.flash_attention(q, k, k, causal=True)
    assert o.grad_fn is not None and o.dtype == dtype
    do = _t(_normal(rng, tuple(o.shape))).to(dtype)
    o.backward(do)
    qd, kd = q.detach(), k.detach()
    dq, dk, dv = ops.flash_attention_bwd_ref(
        qd, kd, kd, ops.flash_attention_ref(qd, kd, kd, causal=True), do,
        True)
    if qm.requires_grad:
        assert qm.grad.dtype == dtype
        assert torch.equal(qm.grad, dq.permute(0, 3, 1, 2, 4).reshape(
            B, S, KV * G, D))
    else:
        assert qm.grad is None
    if km.requires_grad:
        assert torch.equal(km.grad, (dk + dv).permute(0, 2, 1, 3))
    else:
        assert km.grad is None
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches) == launches


def test_guarded_wrappers_pass_on_cpu_tensors():
    """The guard is for the card: on CPU tensors the plain versions run
    and autograd differentiates them."""
    logits = torch.randn(6, 8, requires_grad=True)
    w, _ = ops.topk_gating(logits, 2)
    w.sum().backward()
    assert logits.grad is not None
    x = torch.randn(3, 8, requires_grad=True)
    ops.coded_matmul(x, torch.randn(2, 8, 4)).sum().backward()
    assert x.grad is not None
