"""A model of the tensor-core route of the port's ``ssd_scan_bwd``, against
the JAX package's autodiff and fp64 autograd, with its term counts.

On the card, bf16 x, B and C at the models' (P, N) go through five
launches of ``csrc/ssd_scan_bwd.cu`` (``ssd_scan.bwd_plan``): (1) per
(batch row, head, chunk) the chunk's fp64 cumsum, its own state Σ_s (w_s
dt_s x_s)ᵀ B_s and own state gradient Σ_t (e_t dy_t)ᵀ C_t, and dy's bf16
terms; (2) their fold over the chunks into the entering states h_c and
the gradients Hn_c of the states leaving each chunk; (3) a block per
(batch row, head, chunk, 64-row tile), in one grid: the (3s) blocks walk
the t-tiles from their s-tile's diagonal down and sum dxb_s and dB_s, the
(3t) blocks walk the s-tiles up to their t-tile's diagonal and sum dC_t,
as the flash backward's key and query launches do; (4) a warp per (batch
row, head, chunk) for dla's fp64 reverse scan, ddt and the chunk's share
of dA; (5) dB and dC summed over the heads in head order, dA over the
chunks in order. Every product is an ``mma.sync`` m16n8k16 product, bf16
in and fp32 accumulate: x, B and C enter exactly (they are bf16) and
each fp32 factor as ``ss.BWD_TERMS`` bf16 terms t0 = bf16(v), t1 = bf16(v
− t0), ...; a product of two fp32 factors (Gᵀ·dy, dy·h_c) takes the
cross terms t_i u_j with i + j < ``BWD_TERMS``. The elementwise factors
(L, G, W, M), the sums of M, the reverse scan, ddt and dA stay in fp32
and fp64.

The CUDA kernel has no CPU mode, so this file holds a plain-torch model of
it: the launches, the tile walks and their decay factors, each product's
operand rounding, the per-head partial sums of dB and dC summed in head
order. The model is held to ``jax.vjp`` of the JAX package's
``ssd_chunked`` at chunk 32 (where the reference's gradient is finite) and
to fp64 autograd of the port's plain forward at chunk 256, at mamba2's and
jamba's (P, N) with their full head counts, within 2e-3 of each
gradient's largest entry (the bound the card's checks use), each
product's own rounding under a quarter of it. Rounding the fp32 factors
to bf16 once (one term fewer) breaks that bound; two terms hold it, so
the kernel uses two. The kernel itself is held to its plain version on
the card by the ``hopper`` tests and ``chip_smoke.py``.
"""
import functools
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as JS  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

BOUND = 2e-3             # each gradient within it of its largest entry
TILE = 64
F64 = torch.float64
NAMES = ("dx", "ddt", "dA", "dB", "dC")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for PyTorch while these tests run: tier-1 runs
    six workers over the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- operand rounding ---------------------------------------------------------------

OPERANDS = ("dy", "G", "W", "state", "rows")


def count(n, operand: str):
    """The terms ``operand`` enters its products as: ``n`` itself, or
    ``n[operand]`` (the kernel's count where ``n`` leaves it out) when
    ``n`` is a mapping. The operands: dy (in D, Gᵀ·dy and dy·h_c), the
    tiles G and W, the states h_c and Hn_c, the scaled rows of launch
    (1)."""
    if isinstance(n, dict):
        return n.get(operand, ss.BWD_TERMS)
    return n


def terms(v: torch.Tensor, n) -> list:
    """The bf16 terms an fp32 factor enters a product as: ``n`` of them,
    each the bf16 of what the ones before leave of v; ``None`` is v
    itself (fp32, to measure a product's own rounding); "tf32" the
    3×TF32 split, a big and a small term of 10 mantissa bits."""
    if n == "tf32":
        big = (v.view(torch.int32) & ~0x1FFF).view(torch.float32)
        small = v - big
        return [big, (small.view(torch.int32) & ~0x1FFF).view(torch.float32)]
    if n is None:
        return [v]
    out, rest = [], v
    for _ in range(n):
        out.append(rest.to(torch.bfloat16).float())
        rest = rest - out[-1]
    return out


def one(a, b, n, side="a"):
    """a @ b with the fp32 factor on ``side`` in ``n`` terms and the other
    operand exact (bf16-valued), fp32 sums."""
    if side == "a":
        return sum(t @ b for t in terms(a, n))
    return sum(a @ t for t in terms(b, n))


def two(a, b, n, ka: str, kb: str):
    """a @ b of two fp32 factors, operands ``ka`` and ``kb``: the cross
    terms t_i @ u_j with i + j < the larger count (the one fp32 product
    when both are unrounded); with ``n["cross"]`` "tf32", 3×TF32 in place
    of bf16 terms: big·big + big·small + small·big."""
    mode = n.get("cross") if isinstance(n, dict) else None
    ta = terms(a, "tf32" if mode == "tf32" else count(n, ka))
    tb = terms(b, "tf32" if mode == "tf32" else count(n, kb))
    k = max(len(ta), len(tb))
    return sum(ta[i] @ tb[j] for i in range(len(ta)) for j in range(len(tb))
               if i + j < k)


def ex(v: torch.Tensor) -> torch.Tensor:
    """exp of an fp64 difference, taken in fp32 as the kernel does."""
    return torch.exp(v.float())


# -- the model (a leading axis of heads throughout) ------------------------------

def states_launch(x, dt, a, B, C, dy, Q, n):
    """Launch (1) for one batch row: x (H, L, P), dt (H, L), a (H,), B, C
    (L, N) shared by the heads, dy (H, L, P) fp32. Returns per head and
    chunk the fp64 cumsum (H, nc, Q), the decay exp(cum_Q) (H, nc), the
    own states Σ_s (x_s dt_s w_s)ᵀ B_s and own state gradients Σ_t (dy_t
    e_t)ᵀ C_t (H, nc, P, N), each scaled row in ``n`` terms."""
    H, L, _ = x.shape
    nc = L // Q
    cum = torch.cumsum((dt * a[:, None]).reshape(H, nc, Q).double(), dim=-1)
    last = cum[..., -1:]
    fw = dt.reshape(H, nc, Q) * ex(last - cum)       # dt_s exp(cum_Q − cum_s)
    fe = ex(cum)                                     # exp(cum_t)
    own, down = [], []
    for c in range(nc):
        rows = slice(c * Q, (c + 1) * Q)
        own.append(one((x[:, rows] * fw[:, c, :, None]).transpose(1, 2),
                       B[rows], count(n, "rows")))
        down.append(one((dy[:, rows] * fe[:, c, :, None]).transpose(1, 2),
                        C[rows], count(n, "rows")))
    return cum, ex(last[..., 0]), torch.stack(own, 1), torch.stack(down, 1)


def fold(decay, own, down, dh):
    """Launch (2): the states entering each chunk (h_0 = 0) and the
    gradients of the states leaving it (the last one dh), fp32."""
    nc = decay.shape[1]
    d = decay[..., None, None]
    h, hs = torch.zeros_like(own[:, 0]), []
    for c in range(nc):
        hs.append(h)
        h = d[:, c] * h + own[:, c]
    g, gs = dh.clone(), [None] * nc
    for c in reversed(range(nc)):
        gs[c] = g
        g = d[:, c] * g + down[:, c]
    return torch.stack(hs, 1), torch.stack(gs, 1)


def decay_tile(cum, t0, s0, r):
    """exp(cum_t − cum_s) over the 64 × 64 tile of rows t0.., columns s0..
    (H, t, s), 0 for s > t and for steps past the chunk. Off the diagonal
    it is exp(cum_t − r)·exp(r − cum_s) for the block's r between the
    tiles, both factors at most 1; on it one exp of each difference."""
    H, Q = cum.shape
    out = torch.zeros(H, TILE, TILE)
    tv, sv = min(t0 + TILE, Q) - t0, min(s0 + TILE, Q) - s0
    ct, cs = cum[:, t0:t0 + tv], cum[:, s0:s0 + sv]
    if t0 != s0:
        val = ex(ct - r[:, None])[:, :, None] * ex(r[:, None] - cs)[:, None]
    else:
        live = torch.ones(tv, sv, dtype=torch.bool).tril()
        seg = (ct[:, :, None] - cs[:, None, :]).masked_fill(~live, 0.0)
        val = torch.where(live, ex(seg), 0.0)
    out[:, :tv, :sv] = val
    return out


def rows(v, r0, Q):
    """Rows r0 .. r0 + 64 of ``v`` (axis -2), those past Q zero-filled (the
    kernel's ragged tiles)."""
    out = v.new_zeros(*v.shape[:-2], TILE, v.shape[-1])
    k = min(TILE, Q - r0)
    out[..., :k, :] = v[..., r0:r0 + k, :]
    return out


def col(v, r0, Q):
    """Steps r0 .. r0 + 64 of ``v`` (last axis), zero past Q."""
    return rows(v[..., None], r0, Q)[..., 0]


def s_block(i, x, dt, B, C, dy, cum, hn, Q, n):
    """The (3s) blocks of s-tile ``i`` (one per head) for one batch row and
    chunk: the t-tiles j >= i. Returns dxb (H, 64, P), each head's dB
    (H, 64, N), and per row the column sums of M, U and dxb·x (H, 64)."""
    s0 = i * TILE
    xs, dts = rows(x, s0, Q), col(dt, s0, Q)
    Bs = rows(B, s0, Q)
    r = cum[:, min(s0 + TILE, Q) - 1]                 # the s-tile's last step
    dxb = torch.zeros(xs.shape)
    dB = torch.zeros(*xs.shape[:-1], B.shape[-1])
    colsum = torch.zeros(dts.shape)
    for j in range(i, -(-Q // TILE)):
        t0 = j * TILE
        Ct, dyr = rows(C, t0, Q), rows(dy, t0, Q)
        dyj = terms(dyr, count(n, "dy"))
        St = Bs @ Ct.T                                 # Sᵀ (s, t), exact
        Dr = sum(xs @ d.transpose(1, 2) for d in dyj)  # x_s·dy_t
        lt = decay_tile(cum, t0, s0, r).transpose(1, 2)
        W = (lt * dts[..., None]) * Dr
        G = St * lt
        colsum += (St * W).sum(-1)
        dxb += two(G, dyr, n, "G", "dy")
        dB += one(W, Ct, count(n, "W"))
    w = ex(cum[:, -1:] - cum)                          # exp(cum_Q − cum_s)
    hnb = one(Bs, hn.transpose(1, 2), count(n, "state"), "b") * \
        col(w, s0, Q)[..., None]
    dxb = dxb + hnb
    u = ((xs * dts[..., None]) * hnb).sum(-1)
    dB = dB + one(xs, hn, count(n, "state"), "b") * \
        (dts * col(w, s0, Q))[..., None]
    return dxb, dB, colsum, u, (dxb * xs).sum(-1)


def t_block(j, x, dt, B, C, dy, cum, hc, Q, n):
    """The (3t) blocks of t-tile ``j`` (one per head) for one batch row and
    chunk: the s-tiles i <= j. Returns each head's dC (H, 64, N) and per
    row the row sums of M plus C_t·(e_t dy_t h_c) (H, 64)."""
    t0 = j * TILE
    Ct, dyr = rows(C, t0, Q), rows(dy, t0, Q)
    dyj = terms(dyr, count(n, "dy"))
    r = cum[:, max(t0 - 1, 0)]                         # the step before
    dC = torch.zeros(*dyj[0].shape[:-1], C.shape[-1])
    rowsum = torch.zeros(dC.shape[:-1])
    for i in range(j + 1):
        s0 = i * TILE
        xs, dts, Bs = rows(x, s0, Q), col(dt, s0, Q), rows(B, s0, Q)
        S = Ct @ Bs.T                                  # (t, s), exact
        Dr = sum(d @ xs.transpose(1, 2) for d in dyj)
        W = (decay_tile(cum, t0, s0, r) * dts[:, None, :]) * Dr
        rowsum += (S * W).sum(-1)
        dC += one(W, Bs, count(n, "W"))
    dcs = two(dyr, hc, n, "dy", "state") * col(ex(cum), t0, Q)[..., None]
    return dC + dcs, rowsum + (dcs * Ct).sum(-1)


def model_bwd(x, dt, A, Bm, Cm, dy, dh, chunk, n=ss.BWD_TERMS):
    """The kernel's decomposition over the model's layout: x (B, L, H, P),
    dt (B, L, H), A (H,), Bm/Cm (B, L, N) shared by the heads, dy (B, L,
    H, P), dh (B, H, P, N) or None; fp32 (x, B and C bf16-valued); ``n``
    terms per fp32 factor (None: unrounded). Returns (dx, ddt, dA, dB,
    dC) in those layouts (dA (H,), dB and dC (B, L, N)), fp32. ``n`` may
    be a mapping of operands to counts (``count``)."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    nc, ntt = L // Q, -(-Q // TILE)
    dx = torch.zeros(Bsz, H, L, P)
    ddt = torch.zeros(Bsz, H, L)
    dA = torch.zeros(Bsz, H, nc)
    part_B = torch.zeros(Bsz, H, L, N)
    part_C = torch.zeros(Bsz, H, L, N)
    for b in range(Bsz):
        xh, dth, dyh = (t[b].transpose(0, 1) for t in (x, dt, dy))
        cum, decay, own, down = states_launch(xh, dth, A, Bm[b], Cm[b], dyh,
                                              Q, n)
        g = dh[b] if dh is not None else torch.zeros(H, P, N)
        hc, hn = fold(decay, own, down, g)
        for c in range(nc):
            sl = slice(c * Q, (c + 1) * Q)
            args = (xh[:, sl], dth[:, sl], Bm[b, sl], Cm[b, sl], dyh[:, sl],
                    cum[:, c])
            rs, cs, uu, xd = (torch.zeros(H, ntt * TILE) for _ in range(4))
            dxb = torch.zeros(H, ntt * TILE, P)
            dBc = torch.zeros(H, ntt * TILE, N)
            dCc = torch.zeros(H, ntt * TILE, N)
            for i in range(ntt):
                k = slice(i * TILE, (i + 1) * TILE)
                dxb[:, k], dBc[:, k], cs[:, k], uu[:, k], xd[:, k] = \
                    s_block(i, *args, hn[:, c], Q, n)
                dCc[:, k], rs[:, k] = t_block(i, *args, hc[:, c], Q, n)
            dx[b, :, sl] = dxb[:, :Q] * dth[:, sl, None]
            part_B[b, :, sl], part_C[b, :, sl] = dBc[:, :Q], dCc[:, :Q]
            # launch (4): dcum, dla's fp64 reverse scan, ddt, dA's share
            hh = (hn[:, c] * hc[:, c]).sum((-1, -2))
            dcum = rs[:, :Q].double() - cs[:, :Q].double() - uu[:, :Q].double()
            dcum[:, -1] += decay[:, c].double() * hh.double() + \
                uu[:, :Q].sum(-1).double()
            dla = dcum.flip(-1).cumsum(-1).flip(-1)
            ddt[b, :, sl] = (dla * A[:, None].double()).float() + xd[:, :Q]
            dA[b, :, c] = (dla * dth[:, sl].double()).sum(-1).float()
    # launch (5): the heads' partials in head order, dA's chunks in order
    dB, dC = part_B[:, 0].clone(), part_C[:, 0].clone()
    for h in range(1, H):
        dB += part_B[:, h]
        dC += part_C[:, h]
    dAs = dA[..., 0].clone()
    for c in range(1, nc):
        dAs += dA[..., c]
    return (dx.permute(0, 2, 1, 3), ddt.permute(0, 2, 1), dAs.sum(0), dB,
            dC)


# -- inputs and references -----------------------------------------------------------

def inputs(Bsz, H, L, P, N, seed, dh=False, dt_value=None):
    """The card's recipe from a numpy seed, model layout: x, B and C
    bf16-valued (B and C scaled to unit-variance scores), dt softplus of a
    normal (or ``dt_value``), A = −exp(normal), dy and dh normal fp32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bsz, L, H, P))
    dt = (np.log1p(np.exp(rng.standard_normal((Bsz, L, H))))
          if dt_value is None else np.full((Bsz, L, H), dt_value))
    A = -np.exp(rng.standard_normal(H))
    Bm, Cm = (rng.standard_normal((Bsz, L, N)) / np.sqrt(N) for _ in "BC")
    dy = rng.standard_normal((Bsz, L, H, P))
    g = rng.standard_normal((Bsz, H, P, N)) if dh else None
    bf = lambda a: torch.from_numpy(a).float().to(torch.bfloat16).float()  # noqa
    f32 = lambda a: torch.from_numpy(a).float()  # noqa: E731
    return (bf(x), f32(dt), f32(A), bf(Bm), bf(Cm), f32(dy),
            None if g is None else f32(g))


def fp64_autograd(x, dt, A, Bm, Cm, dy, dh, chunk):
    """fp64 autograd of the port's plain forward, model layout."""
    Bsz, L, H, P = x.shape
    leaves = [t.double().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, h = ss.ssd_scan_ref(leaves[0].permute(0, 2, 1, 3),
                           leaves[1].permute(0, 2, 1),
                           leaves[2].expand(Bsz, H), leaves[3], leaves[4],
                           chunk=chunk, return_state=True)
    loss = (y * dy.double().permute(0, 2, 1, 3)).sum()
    if dh is not None:
        loss = loss + (h * dh.double()).sum()
    return torch.autograd.grad(loss, leaves)


def jax_vjp(x, dt, A, Bm, Cm, dy, dh, chunk):
    """``jax.vjp`` of the JAX package's ``ssd_chunked``."""
    _, vjp = jax.vjp(lambda *a: JS.ssd_chunked(*a, chunk),
                     *(jnp.asarray(t.numpy()) for t in (x, dt, A, Bm, Cm)))
    Bsz, _, H, P = x.shape
    g = dh if dh is not None else torch.zeros(Bsz, H, P, Bm.shape[-1])
    return [np.asarray(v) for v in vjp((jnp.asarray(dy.numpy()),
                                        jnp.asarray(g.numpy())))]


def shares(got, want) -> dict:
    """Each gradient's largest error over its reference's largest entry."""
    out = {}
    for name, a, b in zip(NAMES, got, want):
        a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor)
                       else a, np.float64)
        b = np.asarray(b.detach().numpy() if isinstance(b, torch.Tensor)
                       else b, np.float64)
        assert a.shape == b.shape and np.isfinite(a).all(), name
        out[name] = float(np.abs(a - b).max() / np.abs(b).max())
    return out


# -- the model against the JAX package and fp64 --------------------------------------

# (H, P, N) at chunk 256: mamba2-130m's and jamba-v0.1-52b's mixers
MODELS = {"mamba2-130m": (24, 64, 128), "jamba-v0.1-52b": (128, 64, 16)}


@functools.lru_cache(maxsize=8)
def full_width(arch: str, seed: int, dh: bool):
    """One batch row of ``arch``'s heads over two chunks of 256, and the
    fp64 autograd gradients of those inputs."""
    H, P, N = MODELS[arch]
    ins = inputs(1, H, 512, P, N, seed, dh=dh)
    return ins, fp64_autograd(*ins, 256)


@functools.lru_cache(maxsize=8)
def unrounded(arch: str, seed: int):
    """The model with every factor in fp32 (no terms)."""
    ins, _ = full_width(arch, seed, False)
    return model_bwd(*ins, 256, n=None)


@pytest.mark.parametrize("L", [64, 96, 20])
@pytest.mark.parametrize("with_dh", [False, True], ids=["dh0", "dh"])
def test_model_matches_jax_vjp_at_chunk_32(L, with_dh):
    """The tiny configs' chunk of 32 (P 32, N 16, one of the kernel's
    shapes), where the reference's gradient is finite: two and three
    chunks (states passed across the chunk boundaries) and L below the
    chunk (one ragged tile of 20 steps); every gradient within the bound
    of its largest entry in ``jax.vjp`` of ``ssd_chunked``."""
    ins = inputs(2, 4, L, 32, 16, seed=L + with_dh, dh=with_dh)
    s = shares(model_bwd(*ins, 32), jax_vjp(*ins, 32))
    assert max(s.values()) <= BOUND, s


@pytest.mark.parametrize("arch", sorted(MODELS))
@pytest.mark.parametrize("with_dh", [False, True], ids=["dh0", "dh"])
def test_model_matches_fp64_autograd_at_chunk_256(arch, with_dh):
    """At the models' chunk of 256 with their full head counts: every
    gradient within the bound of its largest entry in fp64 autograd of the
    port's plain forward (where jax's own gradient is NaN for dt near
    softplus(0)); two terms leave it some 200 times inside."""
    ins, want = full_width(arch, 0, with_dh)
    s = shares(model_bwd(*ins, 256), want)
    assert max(s.values()) <= BOUND / 50, s


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_each_products_own_rounding_is_under_a_quarter_of_the_bound(arch):
    """Each operand in the kernel's terms alone, every other factor in
    fp32: the gradients move from the unrounded model's by under a quarter
    of the bound (the products that operand enters, and nothing else)."""
    ins, _ = full_width(arch, 0, False)
    exact = unrounded(arch, 0)
    for operand in OPERANDS:
        n = {o: None for o in OPERANDS}
        n[operand] = ss.BWD_TERMS
        s = shares(model_bwd(*ins, 256, n=n), exact)
        assert max(s.values()) < BOUND / 4, (operand, s)


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_one_term_fewer_breaks_the_bound(arch):
    """Why two terms: with one term fewer, every fp32 factor rounded to
    bf16 once, a gradient leaves the bound at both shapes."""
    ins, want = full_width(arch, 0, False)
    s = shares(model_bwd(*ins, 256, n=ss.BWD_TERMS - 1), want)
    assert max(s.values()) > BOUND, s


def test_one_term_fewer_on_dy_and_the_states_breaks_it_at_jambas_shape():
    """The operands that enter the most products, dy (D, Gᵀ·dy, dy·h_c
    and the states' gradients) and the states h_c and Hn_c (four
    products), with one term fewer and the rest as the kernel has them:
    out of the bound at jamba's shape."""
    ins, want = full_width("jamba-v0.1-52b", 1, False)
    fewer = {"dy": ss.BWD_TERMS - 1, "state": ss.BWD_TERMS - 1}
    s = shares(model_bwd(*ins, 256, n=fewer), want)
    assert max(s.values()) > BOUND, s


def test_tf32_triples_are_no_closer_than_the_bf16_cross_terms():
    """The alternative for the products of two fp32 factors (Gᵀ·dy and
    dy·h_c): 3×TF32 holds the bound too, no closer to the unrounded model
    than the bf16 cross terms by more than fp32 rounding, while running
    the tensor cores at half the bf16 rate; the kernel takes the bf16
    terms (dy's are D's operand already)."""
    ins, want = full_width("mamba2-130m", 0, False)
    exact = unrounded("mamba2-130m", 0)
    bf16 = model_bwd(*ins, 256)
    tf32 = model_bwd(*ins, 256, n={"cross": "tf32"})
    assert max(shares(tf32, want).values()) <= BOUND
    assert max(shares(bf16, exact).values()) < 10 * max(
        shares(tf32, exact).values())


def test_chunk_256_at_softplus_zero_is_finite():
    """dt = softplus(0), A = −1 at chunk 256 (the reference's NaN): no
    exponent the model takes is positive, every gradient is finite and
    within the bound of fp64 autograd."""
    ins = inputs(1, 8, 256, 64, 16, seed=3, dt_value=float(np.log(2.0)))
    ins = (*ins[:2], -torch.ones(8), *ins[3:])
    s = shares(model_bwd(*ins, 256), fp64_autograd(*ins, 256))
    assert max(s.values()) <= BOUND, s


@pytest.mark.parametrize("scale", [1.0, 30.0])
@pytest.mark.parametrize("t0,s0", [(0, 0), (64, 0), (192, 64), (192, 192)])
def test_decay_tiles_match_exp_and_never_overflow(scale, t0, s0):
    """The kernel's decay tiles against exp(cum_t − cum_s) in fp64, also
    where the log-decay falls by up to 60 a step: finite, within fp32
    rounding, exactly 0 above the diagonal; both launches' r (the
    s-tile's last step, the step before the t-tile) give the same."""
    rng = np.random.default_rng(t0 + s0)
    la = -scale * np.log1p(np.exp(rng.standard_normal(256)))
    cum = torch.from_numpy(np.cumsum(la))[None]          # fp64, falling
    t = torch.arange(t0, t0 + TILE)[:, None]
    s = torch.arange(s0, s0 + TILE)[None, :]
    want = torch.where(s <= t, torch.exp((cum[0, t0:t0 + TILE, None]
                                          - cum[0, None, s0:s0 + TILE])
                                         .clamp(max=0)), 0.0)
    for r in (cum[:, s0 + TILE - 1], cum[:, max(t0 - 1, 0)]):
        got = decay_tile(cum, t0, s0, r)[0]
        assert torch.isfinite(got).all()
        assert (got[(s > t).expand_as(got)] == 0).all()
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-30)


def test_folded_states_match_the_sequential_recurrences(monkeypatch):
    """Launch (2)'s fold of launch (1)'s own sums in fp64 (its exps too):
    the states entering each chunk equal the state carried step by step,
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t, and the gradients of the
    states leaving them (from the later steps' outputs and dh) equal the
    gradient carried back step by step, g_{t-1} = exp(dt_t A) (g_t + dy_t
    ⊗ C_t) from dh."""
    monkeypatch.setattr(sys.modules[__name__], "ex", torch.exp)
    x, dt, A, Bm, Cm, dy, dh = inputs(1, 1, 96, 16, 16, seed=4, dh=True)
    xh, dth, dyh = x[0].transpose(0, 1), dt[0].T, dy[0].transpose(0, 1)
    cum, decay, own, down = states_launch(
        xh.double(), dth.double(), A.double(), Bm[0].double(),
        Cm[0].double(), dyh.double(), 32, None)
    hc, hn = fold(decay.double(), own, down, dh[0].double())
    a = torch.exp(dth[0].double() * A[0].double())
    h, g = torch.zeros(16, 16, dtype=F64), dh[0, 0].double()
    for t in range(96):
        if t % 32 == 0:
            torch.testing.assert_close(hc[0, t // 32], h, rtol=1e-9,
                                       atol=1e-9)
        h = a[t] * h + dth[0, t].double() * torch.outer(
            xh[0, t].double(), Bm[0, t].double())
    for t in reversed(range(96)):
        if t % 32 == 31:
            torch.testing.assert_close(hn[0, t // 32], g, rtol=1e-9,
                                       atol=1e-9)
        g = a[t] * (g + torch.outer(dyh[0, t].double(), Cm[0, t].double()))
