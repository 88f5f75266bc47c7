"""The launch plan of the port's tensor-core ``ssd_scan`` and a model of
its chunk decomposition, against the JAX package's kernel and model.

On the card, bf16 x, B and C go through two launches of
``csrc/ssd_scan.cu``: (a) per (batch row, head, chunk) the chunk's fp64
cumsum and its own state S_c = Σ_s (w_s x_s)ᵀ B_s, w_s = dt_s·exp(cum_Q −
cum_s), after which the last block of each (batch row, head) folds the
row's states in order, in place, into the states entering each chunk,
h_{c+1} = exp(cum_Q) h_c + S_c, and the final state; (b) per (batch row,
chunk, 64-row t-tile, group of heads) y = exp(cum_t)·C h_cᵀ + G·x with the
score tile C·Bᵀ computed once for the group and G = C·Bᵀ ⊙ exp(cum_t −
cum_s) ⊙ dt_s (s <= t) per head. Every product is a bf16 tensor-core
product: x, B and C enter exactly, and each fp32 factor (w·x, h_c and G)
as three bf16 terms t0 = bf16(v), t1 = bf16(v − t0), t2 = bf16(v − t0 −
t1), which carry 24 of v's bits (the model sums their products in fp32;
the tensor cores' fp32 accumulation is not IEEE fp32's, so the kernel
differs from it in the last bits). The CUDA kernel has no CPU mode, so this file
holds a model of it in plain torch: the per-chunk states, the passing of
states between chunks, the per-head-group outputs with C·Bᵀ shared by the
group, and the operand rounding. The model is held to the JAX Pallas
kernel in interpret mode and to the JAX model's ``ssd_chunked`` within
the fp32 bound 2e-3 that the card's checks use, and the plan to its
bounds. Rounding each fp32 factor to bf16 once instead breaks that bound
at jamba's shape; two terms hold it, but on the card they flipped a
near-tied MoE route of jamba in a decode-step-vs-prefill check that three
terms pass, hence the third. The kernel
itself is held to its plain version by the ``hopper`` tests of
``tests/test_torch_hopper.py`` on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models.ssm import ssd_chunked as j_ssd_chunked  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)     # the card's fp32 bound for the scan
TILE = 64
H100_SMS = 132

# (Bsz, H, L, P, N, Q) at the serving shapes: batch 4, prompt 512
SERVING = {"mamba2-130m": (4, 24, 512, 64, 128, 256),
           "jamba-v0.1-52b": (4, 128, 512, 64, 16, 256)}


# -- the model ----------------------------------------------------------------

def rounded(v: torch.Tensor, how: str) -> list:
    """The operands an fp32 factor enters the products as: ``terms`` is
    the kernel's TERMS bf16 terms, each the bf16 of what the ones before
    leave of v; ``pair`` the first two of them; ``bf16`` rounds once,
    ``tf32`` keeps 10 mantissa bits (truncated), ``fp32`` is v itself."""
    if how in ("terms", "pair"):
        out, rest = [], v
        for _ in range(ss.TERMS if how == "terms" else 2):
            out.append(rest.to(torch.bfloat16).float())
            rest = rest - out[-1]
        return out
    if how == "bf16":
        return [v.to(torch.bfloat16).float()]
    if how == "tf32":
        return [(v.view(torch.int32) & ~0x1FFF).view(torch.float32)]
    return [v]


def product(a: torch.Tensor, b: torch.Tensor, how: str, side: str
            ) -> torch.Tensor:
    """a @ b with the fp32 factor (``side`` "a" or "b") rounded as the
    kernel rounds it and the other operand exact; fp32 sums."""
    if side == "a":
        return sum(p @ b for p in rounded(a, how))
    return sum(a @ p for p in rounded(b, how))


def chunk_states(x, dt, A, Bm, Q, how):
    """Launch (a) for one (batch row, head): x (L, P), dt (L,), A scalar,
    Bm (L, N) → the chunks' fp64 cumsums (nc, Q), their decays exp(cum_Q)
    (nc,) and own states S_c (nc, P, N), in x's type (fp32 as the kernel;
    fp64 to check the algebra)."""
    L = x.shape[0]
    nc = L // Q
    la = (dt * A).reshape(nc, Q).double()         # x's type, fp64 sums
    cum = torch.cumsum(la, dim=-1)
    last = cum[:, -1:]
    w = dt.reshape(nc, Q) * torch.exp((last - cum).to(x.dtype))
    states = torch.stack([
        product((w[c][:, None] * x[c * Q:(c + 1) * Q]).T,
                Bm[c * Q:(c + 1) * Q], how, "a") for c in range(nc)])
    return cum, torch.exp(last[:, 0].to(x.dtype)), states


def pass_states(decay, states):
    """The fold launch (a)'s last block of a row makes: the state entering
    each chunk (h_0 = 0) and the final state."""
    h = torch.zeros_like(states[0])
    entering = []
    for d, s in zip(decay, states):
        entering.append(h)
        h = h * d + s
    return torch.stack(entering), h


def decay(cum, t0, t1):
    """exp(cum_t − cum_s) for rows t in [t0, t1) and columns s < t1 as the
    kernel takes it, 0 for s > t: columns below the tile (s < t0) as
    exp(cum_t − r)·exp(r − cum_s), r = cum_{t0−1}; on the diagonal tile,
    for each warp's 16 rows from w0, columns below them as the same
    product with r = cum_{w0−1}, and its own 16 columns one exp each."""
    t = torch.arange(t0, t1)
    out = torch.zeros(t1 - t0, t1)
    ex = lambda v: torch.exp(v.float())
    if t0 > 0:
        r = cum[t0 - 1]
        out[:, :t0] = ex(cum[t0:t1] - r)[:, None] * ex(r - cum[:t0])[None, :]
    for w0 in range(t0, t1, 16):
        w1 = min(w0 + 16, t1)
        rows = slice(w0 - t0, w1 - t0)
        if w0 > t0:
            r = cum[w0 - 1]
            out[rows, t0:w0] = ex(cum[w0:w1] - r)[:, None] * \
                ex(r - cum[t0:w0])[None, :]
        live = torch.arange(w0, w1)[None, :] <= t[rows, None]
        seg = (cum[w0:w1, None] - cum[None, w0:w1]).masked_fill(~live, 0.0)
        out[rows, w0:w1] = torch.where(live, ex(seg), 0.0)
    return out


def group_outputs(xg, dtg, cumg, C, B, hg, t0, Q, how):
    """Launch (b) for one (batch row, chunk, t-tile, head group): xg (G,
    Q, P), dtg (G, Q), cumg (G, Q) fp64 and the entering states hg (G, P,
    N) of the group's heads; C, B (Q, N) shared by them. C·Bᵀ is computed
    once for the group; the decay and dt_s differ per head. Returns y
    (G, rows, P)."""
    t1 = min(Q, t0 + TILE)
    scores = C[t0:t1] @ B[:t1].T                  # once per group
    ys = []
    for x, dt, cum, h in zip(xg, dtg, cumg, hg):
        g = scores * decay(cum, t0, t1) * dt[:t1]
        y = product(C[t0:t1], h.T, how, "b") * torch.exp(
            cum[t0:t1].float())[:, None]
        ys.append(y + product(g, x[:t1], how, "a"))
    return torch.stack(ys)


def model_scan(x, dt, A, Bm, Cm, chunk, head_group, how="terms"):
    """The kernel's decomposition over model-layout operands x (B, L, H,
    P), dt (B, L, H), A (H,), Bm/Cm (B, L, N) shared by the heads. Returns
    y (B, L, H, P) and the final state (B, H, P, N), fp32."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    nc = L // Q
    y = torch.zeros(Bsz, L, H, P)
    final = torch.zeros(Bsz, H, P, N)
    for b in range(Bsz):
        cums, entering = [], []
        for h in range(H):
            cum, decay, states = chunk_states(x[b, :, h], dt[b, :, h], A[h],
                                              Bm[b], Q, how)
            ent, final[b, h] = pass_states(decay, states)
            cums.append(cum)
            entering.append(ent)
        for c in range(nc):
            rows = slice(c * Q, (c + 1) * Q)
            for h0 in range(0, H, head_group):
                heads = range(h0, h0 + head_group)
                xg = torch.stack([x[b, rows, h] for h in heads])
                dtg = torch.stack([dt[b, rows, h] for h in heads])
                cumg = torch.stack([cums[h][c] for h in heads])
                hg = torch.stack([entering[h][c] for h in heads])
                for t0 in range(0, Q, TILE):
                    out = group_outputs(xg, dtg, cumg, Cm[b, rows],
                                        Bm[b, rows], hg, t0, Q, how)
                    t1 = min(Q, t0 + TILE)
                    y[b, c * Q + t0:c * Q + t1, h0:h0 + head_group] = \
                        out.permute(1, 0, 2)
    return y, final


def operands(Bsz, H, L, P, N, seed):
    """The card's operand recipe with a numpy seed: x and B, C (scaled to
    unit-variance scores C·B) rounded to bf16 and held as fp32; dt =
    softplus(normal), A = −exp(normal) fp32. Model layout."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bsz, L, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, L, H))))
    A = -np.exp(rng.standard_normal(H))
    Bm, Cm = (rng.standard_normal((Bsz, L, N)) / np.sqrt(N) for _ in "BC")
    bf = [torch.from_numpy(a).float().to(torch.bfloat16).float()
          for a in (x, Bm, Cm)]
    return (bf[0], torch.from_numpy(dt).float(), torch.from_numpy(A).float(),
            bf[1], bf[2])


def share_of_bound(out, ref, rtol=TOL["rtol"], atol=TOL["atol"]) -> float:
    """max |out − ref| / (atol + rtol·|ref|): at most 1 within the bound."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(out - ref) / (atol + rtol * np.abs(ref))).max())


def plain_scan(x, dt, A, Bm, Cm, chunk):
    """The port's plain version on the same operands, model layout."""
    Bsz, L, H, _ = x.shape
    N = Bm.shape[-1]
    y, h = ss.ssd_scan_ref(x.permute(0, 2, 1, 3), dt.permute(0, 2, 1),
                           A.expand(Bsz, H), Bm[:, None].expand(Bsz, H, L, N),
                           Cm[:, None].expand(Bsz, H, L, N), chunk=chunk,
                           return_state=True, out_dtype=torch.float32)
    return y.permute(0, 2, 1, 3), h


# -- the launch plan ------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(SERVING))
def test_plan_at_serving_shapes(arch):
    """Several hundred blocks or more for launch (b) (the parent kernel had
    B·H = 96 at mamba2's shape; here 768 and 1024), a head group that
    divides H and keeps HG·P within 256 output columns, and both launches
    within 227 KB."""
    Bsz, H, L, P, N, Q = SERVING[arch]
    assert ss.mma_takes(P, N)
    plan = ss.mma_plan(Bsz, H, L, P, N, Q, True, H100_SMS)
    nc, tiles = L // Q, Q // TILE
    assert H % plan.head_group == 0 and plan.head_group * P <= 256
    assert plan.blocks_a == Bsz * H * nc
    assert plan.blocks_b == Bsz * nc * tiles * H // plan.head_group
    assert plan.blocks_b >= ss.BLOCKS_PER_SM * H100_SMS
    assert max(plan.smem_a, plan.smem_b) < ss.SMEM_LIMIT == 232448
    # at least two blocks of (b) fit on one SM's 228 KB
    assert 2 * (plan.smem_b + 1024) <= 228 * 1024


def test_plan_values_at_serving_shapes():
    """The numbers PERF.md quotes: mamba2's 24 heads run alone (groups of
    4 would leave 192 blocks, under 4 per SM), jamba's 128 in groups of 4
    (1024 blocks)."""
    m = ss.mma_plan(*SERVING["mamba2-130m"], True, H100_SMS)
    j = ss.mma_plan(*SERVING["jamba-v0.1-52b"], True, H100_SMS)
    assert m == ss.MmaPlan(1, 192, 768, 109568, 73984)
    assert j == ss.MmaPlan(4, 1024, 1024, 52224, 114688)


@pytest.mark.parametrize("num_sms", [1, 8, 132])
@pytest.mark.parametrize("Bsz,H,L,P,N,Q", [(1, 1, 20, 32, 16, 20),
                                           (2, 3, 64, 32, 16, 32),
                                           (4, 24, 255, 64, 128, 255),
                                           (1, 128, 4096, 64, 16, 256),
                                           (2, 8, 512, 64, 128, 256),
                                           (2, 8, 512, 128, 64, 256)])
def test_plan_bounds(Bsz, H, L, P, N, Q, num_sms):
    """The group divides H, keeps HG·P within 256 output columns, and is
    the largest such group that still leaves launch (b) its blocks per
    SM (1 when none does)."""
    plan = ss.mma_plan(Bsz, H, L, P, N, Q, True, num_sms)
    g = plan.head_group
    assert g in ss.HEAD_GROUPS and H % g == 0 and g * P <= 256
    blocks = Bsz * (L // Q) * -(-Q // TILE)
    assert plan.blocks_b == blocks * H // g
    if g > 1:
        assert plan.blocks_b >= ss.BLOCKS_PER_SM * num_sms
    larger = [k for k in ss.HEAD_GROUPS if k > g and H % k == 0
              and k * P <= 256]
    assert all(blocks * H // k < ss.BLOCKS_PER_SM * num_sms for k in larger)


def test_heads_that_do_not_share_b_and_c_are_not_grouped():
    """Contiguous per-row B/C copies (stride over heads not 0) may differ
    per head, so C·Bᵀ cannot be shared: the group is 1."""
    assert ss.mma_plan(4, 24, 512, 64, 128, 256, False, H100_SMS
                       ).head_group == 1


@pytest.mark.parametrize("H,P,shared,group", [
    (24, 64, True, 4), (4, 48, True, 4), (8, 16, True, 4), (3, 32, True, 1),
    (6, 32, True, 1), (4, 128, True, 1), (4, 64, False, 1), (24, 64, False, 1)])
def test_heads_group_by_four_where_the_kernel_takes_it(H, P, shared, group):
    """With blocks to spare (one SM), heads go in fours where 4 divides H,
    4·P is within 256 and the heads share B and C, else alone; the plan's
    blocks and shared memory follow its group."""
    plan = ss.mma_plan(2, H, 512, P, 16, 256, shared, 1)
    assert plan.head_group == group
    assert plan.blocks_b == 2 * 2 * 4 * H // group
    assert (plan.smem_a, plan.smem_b) == ss.mma_smem_bytes(P, 16, 256, group)


@pytest.mark.parametrize("P,N,takes", [(64, 128, True), (64, 16, True),
                                       (32, 16, True), (16, 16, True),
                                       (128, 64, True), (48, 32, True),
                                       (128, 128, False), (8, 16, False),
                                       (64, 8, False), (64, 20, False)])
def test_tensor_core_shapes(P, N, takes):
    """P and N multiples of 16, P <= 128, P·N <= 8192 (the kernel's 16
    state tiles per warp); other bf16 shapes take the CUDA-core kernel."""
    assert ss.mma_takes(P, N) == takes


@pytest.mark.parametrize("P,N,Q,HG", [(64, 128, 256, 1), (64, 16, 256, 4),
                                      (32, 16, 32, 1), (128, 64, 256, 1),
                                      (16, 16, 20, 4)])
def test_shared_memory_holds_the_kernels_regions(P, N, Q, HG):
    """The bytes the wrapper gives each launch (the kernel carves its
    regions from them and has no size of its own) hold at least: for (a)
    the chunk's padded x and B rows and its fp64 cumsum; for (b) the C
    tile, the larger of the ring's two stages and h_c's TERMS terms, and
    each head's fp64 cumsum, with the shared fp32 C·Bᵀ tile only for a
    group. Q counts in whole 64-row tiles."""
    a, b = ss.mma_smem_bytes(P, N, Q, HG)
    Qp = -(-Q // TILE) * TILE
    row_n, row_p = (N + 8) * 2, (P + 8) * 2
    assert a >= Qp * (row_p + row_n + 8)
    stage = TILE * row_n + HG * TILE * row_p
    assert b >= (TILE * row_n + max(2 * stage, ss.TERMS * P * row_n)
                 + HG * 8 * Qp)
    alone = ss.mma_smem_bytes(P, N, Q, 1)[1]
    assert (b - alone >= TILE * TILE * 4) == (HG > 1)
    assert ss.mma_smem_bytes(P, N, Qp, HG) == (a, b)


# -- the model against the JAX package -------------------------------------------

SHAPES = [(64, 128, 256), (64, 16, 256), (32, 16, 32)]
LENGTHS = {"1 chunk": lambda Q: Q, "2 chunks": lambda Q: 2 * Q,
           "4 chunks": lambda Q: 4 * Q, "ragged": lambda Q: Q // 2 + 4}


@pytest.mark.parametrize("P,N,Q", SHAPES)
@pytest.mark.parametrize("length", sorted(LENGTHS))
def test_model_matches_jax_kernel_and_model(P, N, Q, length):
    """y and the final state of the model (head group of 4, three terms)
    against the JAX kernel in interpret mode (y) and the JAX model's
    ``ssd_chunked`` (y and state), on the same bf16-valued inputs."""
    Bsz, H = 1, 4
    L = LENGTHS[length](Q)
    x, dt, A, Bm, Cm = operands(Bsz, H, L, P, N, seed=P + N + L)
    y, h = model_scan(x, dt, A, Bm, Cm, Q, head_group=4)
    rows = lambda t: np.asarray(t.permute(0, 2, 1, 3).reshape(Bsz * H, L, -1))
    kernel = jops.ssd_scan(
        jnp.asarray(rows(x)), jnp.asarray(np.asarray(dt.permute(0, 2, 1)
                                                     .reshape(Bsz * H, L))),
        jnp.asarray(np.tile(np.asarray(A), Bsz)),
        jnp.asarray(np.repeat(np.asarray(Bm), H, 0)),
        jnp.asarray(np.repeat(np.asarray(Cm), H, 0)), chunk=Q,
        interpret=True)
    np.testing.assert_allclose(rows(y), np.asarray(kernel), **TOL)
    jy, jh = j_ssd_chunked(*(jnp.asarray(np.asarray(t))
                             for t in (x, dt, A, Bm, Cm)), Q)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("how", ["terms", "fp32"])
def test_head_groups_share_the_score_tile_exactly(how):
    """Grouping changes which block computes C·Bᵀ, not its value: groups
    of 1 and 4 give the same bits."""
    x, dt, A, Bm, Cm = operands(2, 4, 64, 32, 16, seed=3)
    outs = [model_scan(x, dt, A, Bm, Cm, 32, g, how) for g in ss.HEAD_GROUPS]
    for y, h in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(h, outs[0][1])


@pytest.mark.parametrize("scale", [1.0, 30.0])
@pytest.mark.parametrize("t0,t1", [(0, 64), (64, 128), (192, 256), (64, 100)])
def test_factorized_decay_matches_exp_and_never_overflows(scale, t0, t1):
    """The kernel's decay tile against exp(cum_t − cum_s) in fp64, also
    where the log-decay falls by up to 60 a step (a product over one
    chunk then spans e^-10^4): finite, within fp32 rounding, and exactly
    0 above the diagonal."""
    rng = np.random.default_rng(t0 + t1)
    la = -scale * np.log1p(np.exp(rng.standard_normal(256)))
    cum = torch.from_numpy(np.cumsum(la))             # fp64, falling
    got = decay(cum, t0, t1)
    t = torch.arange(t0, t1)[:, None]
    s = torch.arange(t1)[None, :]
    want = torch.where(s <= t, torch.exp((cum[t0:t1, None] - cum[None, :t1])
                                         .clamp(max=0)), 0.0)
    assert torch.isfinite(got).all()
    assert (got[s.expand_as(got) > t.expand_as(got)] == 0).all()
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-30)


def test_passed_states_match_the_sequential_recurrence():
    """The fold of the chunks' own states equals the state carried step by
    step, h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t, in fp64."""
    x, dt, A, Bm, _ = operands(1, 1, 96, 16, 16, seed=4)
    cum, decay, states = chunk_states(x[0, :, 0].double(), dt[0, :, 0].double(),
                                      A[0].double(), Bm[0].double(), 32,
                                      "fp64")
    entering, final = pass_states(decay.double(), states)
    h = torch.zeros(16, 16, dtype=torch.float64)
    seq = []
    for t in range(96):
        if t % 32 == 0:
            seq.append(h.clone())
        a = torch.exp(dt[0, t, 0].double() * A[0].double())
        h = a * h + dt[0, t, 0].double() * torch.outer(x[0, t, 0].double(),
                                                       Bm[0, t].double())
    torch.testing.assert_close(entering, torch.stack(seq), rtol=1e-9,
                               atol=1e-9)
    torch.testing.assert_close(final, h, rtol=1e-9, atol=1e-9)


def fold_in_place(decay, states, final):
    """Launch (a)'s fold as the kernel runs it over one row's workspace:
    slot k holds S_k on entry and h_k (k >= 1) on exit, S_{k+1} read before
    h_k is stored; with ``final`` the final state is returned, without it
    S_{nc-1} is never read (it was not written)."""
    slots = states.clone()
    nc = len(states)
    if not final:
        slots[-1] = float("nan")              # never written by the kernel
    kend = nc if final else nc - 1
    h, s = torch.zeros_like(slots[0]), slots[0].clone()
    for k in range(kend):
        nxt = slots[k + 1].clone() if k + 1 < kend else s
        if k > 0:
            slots[k] = h
        h = h * decay[k] + s
        s = nxt
    if final:
        return slots, h
    slots[kend] = h
    return slots, None


@pytest.mark.parametrize("nc", [2, 3, 4, 32])
@pytest.mark.parametrize("final", [True, False])
def test_in_place_fold_leaves_each_chunk_its_entering_state(nc, final):
    """The in-place fold leaves h_c in slot c for every chunk c >= 1 that
    launch (b) reads, and the final state when one is asked for, as the
    plain fold of the chunks' own states gives them; slot 0 (chunk 0 takes
    no state) keeps S_0."""
    g = torch.Generator().manual_seed(nc)
    states = torch.randn((nc, 16, 16), generator=g, dtype=torch.float64)
    decay = torch.rand(nc, generator=g, dtype=torch.float64)
    entering, want = pass_states(decay, states)
    slots, got = fold_in_place(decay, states, final)
    assert torch.isfinite(slots[1:]).all()
    torch.testing.assert_close(slots[1:], entering[1:], rtol=0, atol=0)
    torch.testing.assert_close(slots[0], states[0], rtol=0, atol=0)
    if final:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- why the fp32 factors enter as several bf16 terms ----------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_rounding_the_factors_once_breaks_the_bound_at_jambas_shape(seed):
    """At jamba's P 64, N 16, Q 256 (two chunks), rounding G, h_c and w·x
    to bf16 once puts y outside the fp32 bound the card holds it to; TF32
    and two bf16 terms stay inside it. Against the same decomposition
    with unrounded fp32 factors, the kernel's three terms differ by fp32
    rounding, more than 10 times less than two terms."""
    x, dt, A, Bm, Cm = operands(2, 3, 512, 64, 16, seed)
    ry, rh = plain_scan(x, dt, A, Bm, Cm, 256)
    fy, fh = model_scan(x, dt, A, Bm, Cm, 256, 1, "fp32")
    shares, off = {}, {}
    for how in ("bf16", "tf32", "pair", "terms"):
        y, h = model_scan(x, dt, A, Bm, Cm, 256, 1, how)
        shares[how] = (share_of_bound(y, ry), share_of_bound(h, rh))
        off[how] = max(share_of_bound(y, fy), share_of_bound(h, fh))
    assert shares["bf16"][0] > 1.0
    assert max(shares["tf32"]) < 1.0
    assert max(shares["pair"]) < 0.05 and max(shares["terms"]) < 0.05
    assert off["terms"] < 2e-4 and 10 * off["terms"] < off["pair"]
