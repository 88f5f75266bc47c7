"""The backward of the port's ``ssd_scan`` and ``topk_gating`` against the
JAX package.

The JAX package trains its SSM and MoE layers through jax's autodiff of
plain functions: ``repro.models.ssm.ssd_chunked`` and the router's softmax
→ ``lax.top_k`` → renormalise (``repro.models.transformer._moe_route``);
it has no backward kernel. On the CPU the port's backward wrappers run
their plain versions, written out chunk by chunk and as the formulas
(``ssd_scan_bwd_ref``, ``topk_gating_bwd_ref``), held here to ``jax.vjp``
of those reference functions and to torch autograd of the port's plain
forwards in fp64, on inputs made from a numpy seed. The
``torch.autograd.Function`` around each kernel is exercised on its CPU
route with subsets of the inputs needing a gradient. The CUDA backward
kernels are held to the plain versions on the card by
``tests/test_torch_hopper.py`` and ``chip_smoke.py``.

The reference's own gradient of ``ssd_chunked`` is NaN in dt and A at the
configs' chunk of 256 when dt is near softplus(0): it takes
exp(cum_t − cum_s) over the whole chunk square before masking s > t, which
overflows. The port masks before the exp; the test of that quirk holds the
port to its fp64 autograd there instead.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as JS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for PyTorch while these tests run: tier-1 runs
    six workers over the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(port, ref, rel, name=""):
    """Within ``rel`` of the reference's largest entry, elementwise: the two
    sum fp32 products in other orders."""
    port = np.asarray(port.detach().numpy() if isinstance(port, torch.Tensor)
                      else port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, name
    assert np.isfinite(port).all(), name
    np.testing.assert_allclose(port, ref, rtol=rel,
                               atol=rel * np.abs(ref).max(), err_msg=name)


def _scan_inputs(rng, Bsz, H, L, P, N, dt_value=None):
    """The model's layout: x (B, L, H, P), dt (B, L, H) from softplus, A (H,)
    negative, B and C (B, L, N) shared by the heads, scaled to unit-variance
    scores."""
    x = rng.standard_normal((Bsz, L, H, P)).astype(np.float32)
    if dt_value is None:
        dt = np.log1p(np.exp(rng.standard_normal((Bsz, L, H)))).astype(
            np.float32)
    else:
        dt = np.full((Bsz, L, H), dt_value, np.float32)
    A = (-np.exp(rng.standard_normal(H))).astype(np.float32)
    Bm, Cm = ((rng.standard_normal((Bsz, L, N)) / np.sqrt(N)).astype(
        np.float32) for _ in "BC")
    return x, dt, A, Bm, Cm


def _port_operands(x, dt, A, Bm, Cm, lead, dtype=torch.float32):
    """The numpy inputs as the port's scan takes them: (B, H) leads with B
    and C shared (the model's views), or (B·H,) rows with B and C repeated
    per row."""
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    Bsz, L, H, P = x.shape
    xs, dts = t(x).permute(0, 2, 1, 3), t(dt).permute(0, 2, 1)
    As = t(A).expand(Bsz, H)
    if lead == "BH":
        return xs, dts, As, t(Bm), t(Cm)
    N = Bm.shape[-1]
    rows = lambda v: v.reshape(Bsz * H, *v.shape[2:]).contiguous()  # noqa
    rep = lambda v: t(v)[:, None].expand(Bsz, H, L, N)  # noqa: E731
    return (rows(xs), rows(dts), As.reshape(-1).contiguous(), rows(rep(Bm)),
            rows(rep(Cm)))


def _jax_vjp(x, dt, A, Bm, Cm, chunk, dy, dh):
    """``jax.vjp`` of the reference's ``ssd_chunked`` for cotangents dy (B,
    L, H, P) of y and dh (B, H, P, N) of the final state."""
    _, vjp = jax.vjp(lambda *a: JS.ssd_chunked(*a, chunk),
                     *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dh)))]


@pytest.mark.parametrize("lead", ["BH", "rows"])
@pytest.mark.parametrize("with_dh", [False, True], ids=["dh0", "dh"])
@pytest.mark.parametrize("L", [64, 96])
def test_ssd_scan_bwd_ref_matches_jax_vjp(lead, with_dh, L):
    """The tiny configs' chunk of 32 (P 32, N 16), where the reference's
    gradient is finite: every gradient within 1e-4 of its largest entry."""
    rng = np.random.default_rng(L + 2 * with_dh)
    Bsz, H, P, N, Q = 2, 3, 32, 16, 32
    x, dt, A, Bm, Cm = _scan_inputs(rng, Bsz, H, L, P, N)
    dy = rng.standard_normal((Bsz, L, H, P)).astype(np.float32)
    dh = (rng.standard_normal((Bsz, H, P, N)) if with_dh
          else np.zeros((Bsz, H, P, N))).astype(np.float32)
    jx, jdt, jA, jB, jC = _jax_vjp(x, dt, A, Bm, Cm, Q, dy, dh)
    ops_ = _port_operands(x, dt, A, Bm, Cm, lead)
    tdy = torch.from_numpy(dy).permute(0, 2, 1, 3)
    tdh = torch.from_numpy(dh) if with_dh else None
    if lead == "rows":
        tdy = tdy.reshape(Bsz * H, L, P)
        tdh = tdh.reshape(Bsz * H, P, N) if with_dh else None
    dx, ddt, dA, dB, dC = ops.ssd_scan_bwd_ref(*ops_, tdy, tdh, chunk=Q)
    assert [t.dtype for t in (dx, ddt, dA, dB, dC)] == [torch.float32] * 5
    dx = dx.reshape(Bsz, H, L, P).permute(0, 2, 1, 3)
    ddt = ddt.reshape(Bsz, H, L).permute(0, 2, 1)
    dA = dA.reshape(Bsz, H).sum(0)
    if lead == "rows":                 # per-row B and C: sum over the heads
        dB, dC = (g.reshape(Bsz, H, L, N).sum(1) for g in (dB, dC))
    for name, a, b in (("dx", dx, jx), ("ddt", ddt, jdt), ("dA", dA, jA),
                       ("dB", dB, jB), ("dC", dC, jC)):
        _close(a, b, 1e-4, name)


def _fp64_autograd(args, chunk, dy, dh):
    leaves = [a.detach().to(F64).requires_grad_() for a in args]
    y, h = ops.ssd_scan_ref(*leaves, chunk=chunk, return_state=True)
    loss = (y * dy).sum() + ((h * dh).sum() if dh is not None else 0)
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("L,Q", [(64, 16), (96, 48), (20, 32), (128, 128)])
@pytest.mark.parametrize("lead", ["BH", "rows"])
@pytest.mark.parametrize("with_dh", [False, True], ids=["dh0", "dh"])
def test_ssd_scan_bwd_ref_matches_fp64_autograd(L, Q, lead, with_dh):
    """In fp64 the chunk-by-chunk backward equals autograd of the plain
    forward to rounding (1e-10 of each largest entry): several chunks, a
    ragged chunk of 48 (the kernel's 64-row tiles), L below the chunk, one
    chunk of 128."""
    rng = np.random.default_rng(L + Q)
    x, dt, A, Bm, Cm = _scan_inputs(rng, 2, 3, L, 8, 4)
    args = _port_operands(x, dt, A, Bm, Cm, lead, F64)
    dy = torch.from_numpy(rng.standard_normal(args[0].shape))
    dh = (torch.from_numpy(rng.standard_normal((*args[0].shape[:-2], 8, 4)))
          if with_dh else None)
    got = ops.ssd_scan_bwd_ref(*args, dy, dh, chunk=Q)
    want = _fp64_autograd(args, Q, dy, dh)
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert a.dtype == F64 and a.shape == b.shape, name
        _close(a, b.numpy(), 1e-10, name)


def test_ssd_scan_bwd_ref_at_chunk_256_where_the_reference_is_nan():
    """The reference quirk: at the configs' chunk of 256 and dt = 0.7
    (softplus(0), the models' value at init, A = −1), jax's gradient of
    ``ssd_chunked`` is NaN in dt and A (exp(cum_t − cum_s) above the
    diagonal overflows before the mask), finite in x, B and C. The port's
    fp32 plain backward is finite everywhere and within 1e-4 of its own
    fp64 autograd; x, B and C also within 1e-4 of jax's."""
    rng = np.random.default_rng(256)
    Bsz, H, L, P, N, Q = 1, 2, 256, 8, 4, 256
    x, dt, A, Bm, Cm = _scan_inputs(rng, Bsz, H, L, P, N, dt_value=0.7)
    A = -np.ones(H, np.float32)
    dy = rng.standard_normal((Bsz, L, H, P)).astype(np.float32)
    dh = np.zeros((Bsz, H, P, N), np.float32)
    jx, jdt, jA, jB, jC = _jax_vjp(x, dt, A, Bm, Cm, Q, dy, dh)
    assert np.isnan(jdt).any() and np.isnan(jA).any()
    assert all(np.isfinite(g).all() for g in (jx, jB, jC))
    args = _port_operands(x, dt, A, Bm, Cm, "BH")
    tdy = torch.from_numpy(dy).permute(0, 2, 1, 3)
    got = ops.ssd_scan_bwd_ref(*args, tdy, None, chunk=Q)
    want = _fp64_autograd(args, Q, tdy.to(F64), None)
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        _close(a, b.numpy(), 1e-4, name)
    _close(got[0].permute(0, 2, 1, 3), jx, 1e-4, "dx vs jax")
    _close(got[3], jB, 1e-4, "dB vs jax")
    _close(got[4], jC, 1e-4, "dC vs jax")


@pytest.mark.parametrize("needs", ["x", "dt_A", "B_C", "all"])
@pytest.mark.parametrize("state", ["dropped", "used", "none"])
def test_ssd_scan_function_cpu_route(needs, state):
    """Grad mode on and an operand needing a gradient: ``ops.ssd_scan`` on
    CPU tensors goes through its Function, whose backward is the plain
    backward; the state's gradient is ``None`` where the state is dropped
    (training) or not asked for, and used where the loss reads it."""
    rng = np.random.default_rng(len(needs) + len(state))
    x, dt, A, Bm, Cm = _scan_inputs(rng, 2, 3, 64, 8, 4)
    base = _port_operands(x, dt, A, Bm, Cm, "BH")
    wants = {"x": (0,), "dt_A": (1, 2), "B_C": (3, 4),
             "all": (0, 1, 2, 3, 4)}[needs]
    leaves = [t.clone().requires_grad_(i in wants) for i, t in
              enumerate(base)]
    dy = torch.from_numpy(rng.standard_normal((2, 3, 64, 8)).astype(
        np.float32))
    dh = torch.from_numpy(rng.standard_normal((2, 3, 8, 4)).astype(
        np.float32))
    if state == "none":
        y = ops.ssd_scan(*leaves, chunk=32)
        loss = (y * dy).sum()
    else:
        y, h = ops.ssd_scan(*leaves, chunk=32, return_state=True)
        assert h.grad_fn is not None
        loss = (y * dy).sum() + ((h * dh).sum() if state == "used" else 0)
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"
    loss.backward()
    want = ops.ssd_scan_bwd_ref(*base, dy, dh if state == "used" else None,
                                chunk=32)
    for i, (t, g) in enumerate(zip(leaves, want)):
        if i in wants:
            assert t.grad is not None and t.grad.shape == t.shape
            np.testing.assert_array_equal(t.grad.numpy(), g.numpy())
        else:
            assert t.grad is None
    with torch.no_grad():
        assert ops.ssd_scan(*leaves, chunk=32).grad_fn is None


def _route_jax(gates, k):
    """The reference router's weights (``transformer.py:230-232``)."""
    probs = jax.nn.softmax(gates, axis=-1)
    top_w, _ = jax.lax.top_k(probs, k)
    return top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)


def _gating_logits(rng, N, E, kind):
    logits = (2 * rng.standard_normal((N, E))).astype(np.float32)
    if kind == "ties":               # equal maxima and equal runners-up
        logits[0] = 0.0
        logits[1, [E - 1, 0, E // 2]] = 3.0
        logits[2, ::2] = 1.5
        logits[3] = logits[3].round()
    return logits


@pytest.mark.parametrize("N,E,k", [(64, 8, 2), (48, 16, 6), (7, 4, 4),
                                   (5, 64, 6), (33, 100, 5), (6, 3, 3)])
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_topk_gating_bwd_ref_matches_jax_vjp(N, E, k, kind):
    """Random rows, ties (the lowest index wins in both) and k = E: the
    port's indices equal lax.top_k's and the logits' gradient within 1e-6
    (fp32 softmax and sums in other orders)."""
    rng = np.random.default_rng(N + E + k)
    logits = _gating_logits(rng, N, E, kind)
    dw = rng.standard_normal((N, k)).astype(np.float32)
    w_ref, vjp = jax.vjp(lambda g: _route_jax(g, k), jnp.asarray(logits))
    (jd,) = vjp(jnp.asarray(dw))
    tl = torch.from_numpy(logits)
    w, idx = ops.topk_gating_ref(tl, k)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=1e-6,
                               atol=1e-6)
    got = ops.topk_gating_bwd_ref(tl, idx, w, torch.from_numpy(dw))
    assert got.dtype == torch.float32 and got.shape == (N, E)
    np.testing.assert_allclose(got.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


def test_topk_gating_bwd_ref_near_zero_sums_take_the_clamp_branch():
    """Where the routed probabilities sum under 1e-9 (experts far below the
    row's maximum, as given indices can pick), the reference's
    ``maximum(sum, 1e-9)`` passes no gradient to the sum: dt = dw / 1e-9.
    The plain backward equals ``jax.vjp`` of the reference's math for the
    same indices, rows above and below the clamp alike."""
    logits = np.zeros((3, 6), np.float32)
    logits[:, 0] = [60.0, 40.0, 0.0]   # rows 0 and 1: the rest ~e^-60, e^-40
    idx = np.array([[1, 2], [3, 4], [1, 2]], np.int32)
    dw = np.array([[1.0, -2.0], [0.5, 0.25], [1.0, -2.0]], np.float32)

    def route(g):
        t = jnp.take_along_axis(jax.nn.softmax(g, axis=-1), idx, axis=-1)
        return t / jnp.maximum(t.sum(-1, keepdims=True), 1e-9)
    w_ref, vjp = jax.vjp(route, jnp.asarray(logits))
    (jd,) = vjp(jnp.asarray(dw))
    tl = torch.from_numpy(logits)
    p = torch.softmax(tl.double(), -1).gather(-1, torch.from_numpy(idx).long())
    assert (p.sum(-1) < 1e-9).tolist() == [True, True, False]
    got = ops.topk_gating_bwd_ref(tl, torch.from_numpy(idx),
                                  torch.from_numpy(np.array(w_ref)),
                                  torch.from_numpy(dw))
    np.testing.assert_allclose(got.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-12)


def test_topk_gating_function_cpu_route():
    """Under grad the CPU wrapper goes through its Function: the weights
    carry its backward (the plain backward), the indices no gradient; under
    no_grad or on logits needing none there is no graph."""
    rng = np.random.default_rng(3)
    base = torch.from_numpy(_gating_logits(rng, 40, 16, "ties"))
    logits = base.clone().requires_grad_()
    w, idx = ops.topk_gating(logits, 6)
    assert type(w.grad_fn).__name__ == "_TopkGatingBackward"
    assert not idx.requires_grad and idx.dtype == torch.int32
    dw = torch.from_numpy(rng.standard_normal((40, 6)).astype(np.float32))
    (w * dw).sum().backward()
    np.testing.assert_array_equal(
        logits.grad.numpy(), ops.topk_gating_bwd_ref(base, idx, w.detach(),
                                                     dw).numpy())
    rw, ri = ops.topk_gating_ref(base, 6)
    assert torch.equal(idx, ri) and torch.equal(w.detach(), rw)
    with torch.no_grad():
        assert ops.topk_gating(logits, 6)[0].grad_fn is None
    assert ops.topk_gating(base, 6)[0].grad_fn is None
