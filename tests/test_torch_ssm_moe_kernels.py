"""The port's SSM and MoE kernels (``ssd_scan``, ``topk_gating``) against
the JAX package's.

On the CPU each wrapper runs its plain version, held here to the JAX Pallas
kernel in interpret mode (as ``tests/test_kernels.py`` runs it), to
``repro.kernels.ref`` and to the JAX model's ``ssd_chunked`` (whose final
state the TPU kernel does not return), on inputs made from a numpy seed.
Tolerances: ``ssd_scan`` within rtol/atol 1e-4 in fp32 (two chunked fp32
computations that sum in other orders; |y| reaches about 170 at L = 256)
and 3e-2 in bf16, 2e-3 against the sequential recurrence as the JAX
package's own test holds it; ``topk_gating`` indices equal and weights
within 1e-6. The CUDA kernels have no CPU mode: they are held to the plain
versions on the card by ``tests/test_torch_hopper.py`` and
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.ssm import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
SEQ_TOL = dict(rtol=2e-3, atol=2e-3)
GATE_TOL = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _scan_inputs(lead, L, P, N, seed=0):
    """x, dt = softplus(normal), A = -exp(normal), B, C: the JAX package's
    test distribution, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, L, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((*lead, L)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(lead))).astype(np.float32)
    Bm = rng.standard_normal((*lead, L, N)).astype(np.float32)
    Cm = rng.standard_normal((*lead, L, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


# -- ssd_scan -----------------------------------------------------------------

# tests/test_kernels.py's shapes, then L < chunk (Q = L = 40)
SSD_SHAPES = [(2, 64, 16, 16, 16), (3, 128, 32, 64, 32), (1, 256, 64, 128, 64),
              (2, 40, 16, 16, 64)]


@pytest.mark.parametrize("BH,L,P,N,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_jax_kernel(BH, L, P, N, chunk, dtype):
    arrs = _scan_inputs((BH,), L, P, N)
    td = getattr(torch, dtype)
    jd = getattr(jnp, dtype)
    # x, B and C rounded once to the dtype for both packages; dt, A fp32
    j = [jnp.asarray(a, jd if i in (0, 3, 4) else jnp.float32)
         for i, a in enumerate(arrs)]
    t = [torch.from_numpy(a).to(td if i in (0, 3, 4) else torch.float32)
         for i, a in enumerate(arrs)]
    out = ops.ssd_scan(*t, chunk=chunk)
    assert out.shape == (BH, L, P) and out.dtype == td
    kernel = jops.ssd_scan(*j, chunk=chunk, interpret=True)
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(out), _np(kernel), **tol)
    if dtype == "float32":
        np.testing.assert_allclose(_np(out), _np(jref.ssd_scan_ref(*j)),
                                   **SEQ_TOL)


@pytest.mark.parametrize("Bsz,L,H,P,N,chunk", [(2, 64, 3, 16, 32, 16),
                                               (2, 96, 4, 32, 16, 32)])
@pytest.mark.parametrize("strided", [False, True], ids=["contig", "strided"])
def test_ssd_scan_state_and_views_match_ssd_chunked(Bsz, L, H, P, N, chunk,
                                                    strided):
    """The model's layout against the JAX model's ``ssd_chunked``: y and the
    final state. ``strided`` passes the views the port's model passes (x
    permuted from (B, L, H, P), B/C expanded over heads with stride 0);
    else (B·H)-row contiguous copies, the TPU kernel's layout."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((Bsz, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, L, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H))).astype(np.float32)
    Bm = rng.standard_normal((Bsz, L, N)).astype(np.float32)
    Cm = rng.standard_normal((Bsz, L, N)).astype(np.float32)
    jy, jh = j_ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                           chunk)
    tx, tdt, tA, tB, tC = (torch.from_numpy(a) for a in (x, dt, A, Bm, Cm))
    if strided:
        args = (tx.permute(0, 2, 1, 3), tdt.permute(0, 2, 1),
                tA.expand(Bsz, H), tB[:, None].expand(Bsz, H, L, N),
                tC[:, None].expand(Bsz, H, L, N))
        assert args[3].stride(1) == 0 and not args[0].is_contiguous()
        y, h = ops.ssd_scan(*args, chunk=chunk, return_state=True)
        y = y.permute(0, 2, 1, 3)
    else:
        args = (tx.permute(0, 2, 1, 3).reshape(Bsz * H, L, P),
                tdt.permute(0, 2, 1).reshape(Bsz * H, L), tA.repeat(Bsz),
                tB.repeat_interleave(H, 0), tC.repeat_interleave(H, 0))
        y, h = ops.ssd_scan(*args, chunk=chunk, return_state=True)
        y = y.reshape(Bsz, H, L, P).permute(0, 2, 1, 3)
        h = h.reshape(Bsz, H, P, N)
    assert h.dtype == torch.float32 and tuple(h.shape) == jh.shape
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)
    my, mh = ssd_chunked(tx, tdt, tA, tB, tC, chunk)
    np.testing.assert_allclose(_np(my), _np(jy), **TOL)
    np.testing.assert_allclose(_np(mh), _np(jh), **TOL)


def test_ssd_scan_fp32_output_from_bf16_inputs():
    """``out_dtype=float32`` keeps y in fp32 (as the model asks) from bf16
    x/B/C: the same values as the fp32 scan of the rounded inputs."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _scan_inputs((2,), 64, 16, 16))
    bf = [t.to(torch.bfloat16) for t in (x, Bm, Cm)]
    y = ops.ssd_scan(bf[0], dt, A, bf[1], bf[2], chunk=32,
                     out_dtype=torch.float32)
    assert y.dtype == torch.float32
    ref = ops.ssd_scan(*(t.float() for t in (bf[0], dt, A, bf[1], bf[2])),
                       chunk=32)
    torch.testing.assert_close(y, ref, rtol=0, atol=0)


def test_ssd_scan_bad_operands_raise():
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _scan_inputs((2,), 48, 16, 16))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=32)        # 48 % 32 != 0
    with pytest.raises(ValueError, match="does not match"):
        ops.ssd_scan(x, dt[:, :40], A, Bm, Cm)
    with pytest.raises(ValueError, match="expected"):
        ops.ssd_scan(x[0], dt[0], A[0], Bm[0], Cm[0])


# -- topk_gating ----------------------------------------------------------------

# tests/test_kernels.py's cases, one row, the serving shape, k = E
GATE_CASES = [(128, 8, 2), (1000, 64, 6), (77, 16, 4), (1, 4, 1),
              (2048, 64, 6), (33, 8, 8)]


@pytest.mark.parametrize("N,E,k", GATE_CASES)
def test_topk_gating_matches_jax_kernel(N, E, k):
    lg = np.random.default_rng(N + E).standard_normal((N, E)).astype(
        np.float32)
    w, i = ops.topk_gating(torch.from_numpy(lg), k)
    assert w.shape == i.shape == (N, k)
    assert w.dtype == torch.float32 and i.dtype == torch.int32
    jw, ji = jops.topk_gating(jnp.asarray(lg), k, block_rows=64,
                              interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **GATE_TOL)
    rw, ri = jref.topk_gating_ref(jnp.asarray(lg), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), **GATE_TOL)


def test_topk_gating_ties_go_to_the_lowest_index():
    lg = np.zeros((3, 8), np.float32)
    lg[1, [2, 5]] = 1.0
    lg[2] = [0, 3, 1, 3, 1, 3, 0, 0]
    w, i = ops.topk_gating(torch.from_numpy(lg), 4)
    jw, ji = jops.topk_gating(jnp.asarray(lg), 4, interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), [[0, 1, 2, 3], [2, 5, 0, 1],
                                              [1, 3, 5, 2]])
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **GATE_TOL)


def test_topk_gating_zero_rows_and_bad_operands():
    w, i = ops.topk_gating(torch.zeros((0, 16)), 3)
    assert w.shape == i.shape == (0, 3) and i.dtype == torch.int32
    with pytest.raises(ValueError, match="k <= E"):
        ops.topk_gating(torch.zeros((4, 8)), 9)
    with pytest.raises(TypeError, match="float32"):
        ops.topk_gating(torch.zeros((4, 8), dtype=torch.float64), 2)
    with pytest.raises(ValueError, match=r"\(N, E\)"):
        ops.topk_gating(torch.zeros((2, 4, 8)), 2)


def test_cpu_wrappers_run_the_plain_versions_and_count_no_launch():
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _scan_inputs((2,), 32, 16, 16))
    lg = torch.randn(9, 16)
    calls = [(ops.ssd_scan, ops.ssd_scan_ref, (x, dt, A, Bm, Cm),
              {"chunk": 16, "return_state": True}),
             (ops.topk_gating, ops.topk_gating_ref, (lg, 4), {})]
    for fn, ref, args, kw in calls:
        before = fn.launches
        out = fn(*args, **kw)
        assert fn.launches == before
        torch.testing.assert_close(out, ref(*args, **kw), rtol=0, atol=0)
