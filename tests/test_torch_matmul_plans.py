"""The launch plans and the arithmetic of the port's ``dequant_matmul`` and
``coded_matmul`` kernels, on the CPU (no card, no JAX).

The CUDA kernels run only on the card (``tests/test_torch_hopper.py``,
``chip_smoke.py``). What surrounds them is Python and is held here: the
route ``dequant_matmul`` picks from (B, D, N) alone, the legal launch every
tile candidate clamps to on each route, the default tiles and the distinct
candidates, the tensor route's three-term split of x
(``dequant_matmul.split_terms``), a model of its truncating tensor-core sum
(``_tensor_route``) against the plain version and the fp64 product, and
``coded_matmul``'s plan.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import autotune as AT  # noqa: E402
from repro_torch.kernels import coded_matmul as CM  # noqa: E402
from repro_torch.kernels import dequant_matmul as DQ  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_MAX = float(torch.finfo(torch.bfloat16).max)       # 3.3895e38
DQ_SHAPES = [(1, 8, 5), (7, 16, 11), (130, 8, 300), (37, 40, 300),
             (1024, 64, 256), (64, 64, 512), (2048, 2048, 8192),
             (100, 72, 144), (65, 2052, 272), (1, 68, 16), (3, 6, 16),
             (5, 8, 6), (250, 32, 100), (64, 96, 1024), (7, 100, 48)]
ODD_TILES = [(0, 0), (-5, 4), (4096, 4096), (1, 1)]
SMS = [132, 114]                  # H100 SXM and PCIe


def _walk_bound(D, exact):
    """chip_smoke.dq_walk_bound: 8 · 2^-24 · √D · max|y|."""
    return 8 * 2.0 ** -24 * D ** 0.5 * float(exact.abs().max())


def _terms_sum(x):
    return sum(t.double() for t in DQ.split_terms(x))


def _sweep(rng, lo, hi, n=4096):
    """Signed fp32 values with exponents uniform in [lo, hi] and random
    24-bit significands."""
    e = rng.integers(lo, hi + 1, n)
    m = 1 + rng.integers(0, 2 ** 23, n) / 2.0 ** 23
    s = rng.choice([-1.0, 1.0], n)
    return torch.from_numpy((s * m * np.exp2(e)).astype(np.float32))


@pytest.mark.parametrize("lo,hi", [(-110, -100), (-99, -1), (0, 30),
                                   (31, 126)])
def test_split_terms_hold_x_exactly_in_the_range(lo, hi):
    x = _sweep(np.random.default_rng(lo + 200), lo, hi)
    x = x[x.abs() <= 3.38e38]
    assert torch.equal(_terms_sum(x), x.double())
    zeros = torch.tensor([0.0, -0.0])
    t0, t1, t2 = DQ.split_terms(zeros)
    assert torch.equal(_terms_sum(zeros), zeros.double())
    assert torch.equal(t0.float().view(torch.int32),
                       zeros.view(torch.int32))           # the sign kept


def test_split_terms_hold_the_range_ends_exactly():
    ends = torch.tensor([2.0 ** -110, -2.0 ** -110, 3.38e38, -3.38e38,
                         BF16_MAX], dtype=torch.float32)
    assert torch.equal(_terms_sum(ends), ends.double())


@pytest.mark.parametrize("lo,hi", [(-126, -111), (-149, -127)])
def test_split_terms_lose_under_2_pow_minus_133_below_the_range(lo, hi):
    """Normal values under 2^-110 and fp32 subnormals: bf16's subnormals
    step by 2^-133, so the terms miss x by at most half of that."""
    rng = np.random.default_rng(-lo)
    x = _sweep(rng, lo, hi)
    if lo < -126:                  # fp32 subnormals: any bit pattern below
        bits = rng.integers(1, 2 ** 23, 4096).astype(np.int32)
        x = torch.from_numpy(bits.view(np.float32))
    loss = (_terms_sum(x) - x.double()).abs()
    assert float(loss.max()) <= 2.0 ** -134
    assert float(loss.max()) > 0          # the range is where it stops


def test_split_terms_above_the_range_and_non_finite():
    """Past bf16's largest finite value t0 rounds to inf; a non-finite t0
    carries the whole value and the other terms are 0, never NaN from
    inf - inf."""
    x = torch.tensor([3.4e38, -3.4e38, float("inf"), -float("inf"),
                      float("nan")], dtype=torch.float32)
    t0, t1, t2 = DQ.split_terms(x)
    assert torch.isinf(t0[:4]).all() and torch.isnan(t0[4])
    assert torch.equal(torch.sign(t0[:4].float()), torch.sign(x[:4]))
    assert torch.equal(t1.float(), torch.zeros(5))
    assert torch.equal(t2.float(), torch.zeros(5))


def _truncate(v, exponent):
    """v cut toward zero to a multiple of 2^(exponent - 24), exponent as
    ``torch.frexp`` gives it (|v| < 2^exponent): 24 bits below the top."""
    ulp = torch.exp2(exponent.to(torch.float64) - 24)
    return torch.trunc(v / ulp) * ulp


def _mma_step(acc, prods):
    """One k16 step of a tensor-core product into its fp32 accumulator, as
    modelled here: every addend (the accumulator and the 16 products, exact
    in fp64) cut toward zero below the 24 bits of the largest one, the
    exact sum of those cut to fp32 toward zero. Non-finite addends sum as
    they are. acc (B, N) fp64 holding fp32 values; prods (B, k, N)."""
    add = torch.cat([acc[:, None], prods], 1)
    finite = torch.isfinite(add)
    a = torch.where(finite, add, torch.zeros_like(add))
    top = torch.frexp(a.abs().amax(1)).exponent[:, None]
    s = _truncate(a, top).sum(1)                # exact: 24 + 5 bits
    s = _truncate(s, torch.frexp(s).exponent)
    return torch.where(finite.all(1), s, add.sum(1))


def _tensor_route(x, q, scale, promote=True):
    """A plain-torch model of the kernel's tensor route: per 64-deep
    k-tile the t2, t1, t0 products over its k16 steps into one accumulator
    (``_mma_step``), each k-tile's sum added in fp32 into the total
    (``promote``; else one accumulator over all of D), the finished sum
    times the scale."""
    terms = [t.double() for t in DQ.split_terms(x)]
    qd = q.double()
    B, D = x.shape
    acc = torch.zeros((B, q.shape[1]), dtype=torch.float64)
    total = torch.zeros((B, q.shape[1]), dtype=torch.float32)
    for k0 in range(0, D, DQ.K_TILE):
        if promote:
            acc = torch.zeros_like(acc)
        for t in reversed(terms):
            for k in range(k0, min(k0 + DQ.K_TILE, D), 16):
                acc = _mma_step(acc, t[:, k:k + 16, None] * qd[None, k:k + 16])
        if promote:
            total = total + acc.float()
    if not promote:
        total = acc.float()
    return total * torch.as_tensor(scale, dtype=torch.float32)


def _operands(B, D, N, per_channel, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (D, N)).astype(np.int8))
    s = torch.from_numpy((rng.uniform(0.01, 0.1, (N,)) if per_channel
                          else np.asarray(rng.uniform(0.01, 0.1))
                          ).astype(np.float32))
    return x, q, s


@pytest.mark.parametrize("seed", range(6))
def test_tensor_model_misses_the_plain_version_at_d64(seed):
    """Why D <= 64 takes the CUDA cores: at bench_roofline's (1024, 64,
    256), with phase 17's operands (per-channel scales), the modelled
    tensor route misses rtol/atol 1e-5 of the plain version near zero, as
    the kernel's tensor route does on an H100 (tools/dq_accumulation.py),
    while the CUDA-core route repeats the plain version's arithmetic."""
    B, D, N = 1024, 64, 256
    assert DQ.route(B, D, N) == "cuda_cores"
    x, q, s = _operands(B, D, N, True, seed=seed)
    out, ref = _tensor_route(x, q, s), DQ.dequant_matmul_ref(x, q, s)
    share = ((out - ref).abs() / (TOL["atol"] + TOL["rtol"] * ref.abs()))
    assert 1 < float(share.max()) < 4


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("D", [2048, 2052])
def test_tensor_model_within_the_walk_bound_at_d2048(per_channel, D):
    """The modelled tensor route (each k-tile promoted into an fp32 sum,
    the scale on the finished sum) and the plain version are each within
    the fp32 random-walk bound of the fp64 product; D 2052 ends on a
    zero-padded k-tile."""
    x, q, s = _operands(16, D, 64, per_channel, seed=D)
    exact = x.double() @ (q.double() * s.double())
    bound = _walk_bound(D, exact)
    for y in (_tensor_route(x, q, s), DQ.dequant_matmul_ref(x, q, s)):
        assert float((y.double() - exact).abs().max()) <= bound


def test_tensor_model_drifts_without_promotion():
    """Why the kernel promotes every k-tile: one accumulator over D 2048
    (384 truncating steps) lands several times further from the fp64
    product than a fresh accumulator per k-tile (22-32x on an H100)."""
    x, q, s = _operands(16, 2048, 256, True, seed=1)
    exact = x.double() @ (q.double() * s.double())
    errs = [float((_tensor_route(x, q, s, p).double() - exact).abs().max())
            for p in (True, False)]
    assert errs[1] > 5 * errs[0]
    assert errs[1] <= _walk_bound(2048, exact)


def test_tensor_model_non_finite_rows_follow_the_plain_product():
    x, q, s = _operands(6, 64, 32, True, seed=5)
    q[5, 0] = 0                                       # inf * 0 is NaN
    x[1, 5], x[2, 9], x[3, 5] = float("inf"), float("nan"), -float("inf")
    out, ref = _tensor_route(x, q, s), DQ.dequant_matmul_ref(x, q, s)
    assert torch.equal(out.isnan(), ref.isnan())
    assert torch.equal(out.isinf(), ref.isinf())
    assert torch.equal(out[out.isinf()], ref[ref.isinf()])
    fin = ref.isfinite()
    np.testing.assert_allclose(out[fin].numpy(), ref[fin].numpy(), **TOL)


@pytest.mark.parametrize("B,D,N", DQ_SHAPES)
def test_route_depends_on_the_shape_alone(B, D, N):
    r = DQ.route(B, D, N)
    assert r == ("tensor" if D > 64 and N % 16 == 0 and D % 4 == 0
                 else "cuda_cores")
    grid = AT.CANDIDATES["dequant_matmul"]
    tiles = list(itertools.product(grid["block_batch"], grid["block_n"]))
    for bb, bn in tiles + ODD_TILES:
        assert DQ.plan(B, D, N, bb, bn)[0] == r


@pytest.mark.parametrize("B,D,N", DQ_SHAPES)
def test_every_tile_candidate_is_a_legal_launch_on_its_route(B, D, N):
    grid = AT.CANDIDATES["dequant_matmul"]
    tiles = list(itertools.product(grid["block_batch"], grid["block_n"]))
    for bb, bn in tiles + ODD_TILES + [tuple(DQ.default_tile(B, D, N, sms)
                                             .values()) for sms in SMS]:
        r, rows, cols = DQ.plan(B, D, N, bb, bn)
        if r == "tensor":
            assert rows in (64, 128) and cols == DQ.TENSOR_COLS
            assert rows == 64 or min(bb, B) > 64
        else:
            assert 1 <= rows <= min(B, DQ.MAX_TILE)
            assert 1 <= cols <= min(N, DQ.MAX_TILE)
            tb, tn = DQ.tiles(B, N, bb, bn)
            if DQ.vector_rows(D, N):      # 16-byte rows of the int8 tile
                assert cols % 16 == 0 and cols <= max(tn, 16)
                tn = max(16, tn - tn % 16)
            assert (rows, cols) == (tb, tn)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B,D,N", DQ_SHAPES)
def test_default_tile_is_a_candidate_that_fills_the_card(B, D, N, sms):
    """The default is the route's largest tile that still gives each of the
    card's SMs a block, or its smallest where none does; a table miss
    resolves to it, a table entry or a pinned tile beats it."""
    d = DQ.default_tile(B, D, N, sms)
    grid = AT.CANDIDATES["dequant_matmul"]
    assert all(v in grid[k] for k, v in d.items())
    assert d == AT.resolve("dequant_matmul", (B, D, N), torch.int8, {}, d)
    assert AT.resolve("dequant_matmul", (B, D, N), torch.int8,
                      {"block_batch": 32, "block_n": None}, d) == \
        dict(d, block_batch=32)
    r, rows, cols = DQ.plan(B, D, N, d["block_batch"], d["block_n"])

    def blocks(rows, cols):
        return -(-B // rows) * -(-N // cols)
    if r == "tensor":
        assert (rows == 128) == (blocks(128, cols) >= sms)
    else:
        t = d["block_batch"]
        assert d["block_n"] == t
        assert blocks(t, t) >= sms or t == 16
        assert t == 128 or blocks(2 * t, 2 * t) < sms


@pytest.mark.parametrize("B,D,N", DQ_SHAPES)
def test_candidates_launch_each_distinct_tile_once(B, D, N):
    """The tuner's and the bit-equality check's tiles: the default first,
    then one tile for each further launch the grid makes at the shape."""
    grid = AT.CANDIDATES["dequant_matmul"]
    every = {DQ.plan(B, D, N, bb, bn) for bb, bn in
             itertools.product(grid["block_batch"], grid["block_n"])}
    for sms in SMS:
        c = DQ.candidates(B, D, N, sms)
        assert c[0] == DQ.default_tile(B, D, N, sms)
        plans = [DQ.plan(B, D, N, t["block_batch"], t["block_n"]) for t in c]
        assert len(plans) == len(set(plans))
        assert set(plans) == every
        if DQ.route(B, D, N) == "tensor":
            assert len(c) == (2 if B > 64 else 1)


def test_default_tiles_at_the_timed_shapes():
    """The gate projection takes two warpgroups a block (1024 blocks);
    bench_roofline's D 64 shapes the CUDA cores, 256 blocks of 32 x 32 and
    128 of 16 x 16."""
    def default_plan(shape):
        return DQ.plan(*shape, **DQ.default_tile(*shape, 132))
    assert default_plan((2048, 2048, 8192)) == ("tensor", 128, 128)
    assert default_plan((1024, 64, 256)) == ("cuda_cores", 32, 32)
    assert default_plan((64, 64, 512)) == ("cuda_cores", 16, 16)
    assert default_plan((130, 8, 300)) == ("cuda_cores", 16, 16)
    assert default_plan((64, 96, 1024)) == ("tensor", 64, 128)


@pytest.mark.parametrize("n,B,w,want", [(8, 256, 200, 1), (5, 256, 43, 2),
                                        (5, 256, 128, 2), (3, 1, 1, 2),
                                        (8, 1024, 1000, 0)])
def test_coded_plan_takes_the_most_outputs_that_still_fill_a_wave(n, B, w,
                                                                   want):
    """Two 64-thread blocks an SM: a warp for each of its four schedulers."""
    p = CM.plan(n, B, w, 132)
    assert p == want
    assert CM.blocks(p, n, B, w) >= 264 or p == len(CM.PLANS) - 1
    assert all(CM.blocks(i, n, B, w) < 264 for i in range(p))


def test_coded_plans_give_both_timed_shapes_a_wave():
    """(8, 5) over B 256 and a (1024, 1000) layer, (5, 3) over B 256 and
    WRN-16-1's 128-filter portion: at least one block an SM of the H100."""
    for n, B, w in ((8, 256, 200), (5, 256, 43)):
        assert CM.blocks(CM.plan(n, B, w, 132), n, B, w) >= 132


@pytest.mark.parametrize("n,B,w", [(8, 256, 200), (5, 256, 43), (4, 37, 70),
                                   (3, 1, 1)])
def test_coded_plan_covers_every_output_once(n, B, w):
    """A model of the kernel's indexing: block (bx, by, shard), thread (ty,
    tx) owns rows bx*8*tm + ty + 8i and columns by*8*tn + tn*tx + j."""
    tm, tn = CM.PLANS[CM.plan(n, B, w, 132)]
    seen = np.zeros((B, w), np.int64)
    for bx in range(-(-B // (8 * tm))):
        for by in range(-(-w // (8 * tn))):
            for ty, tx, i, j in itertools.product(range(8), range(8),
                                                  range(tm), range(tn)):
                r, c = bx * 8 * tm + ty + 8 * i, by * 8 * tn + tn * tx + j
                if r < B and c < w:
                    seen[r, c] += 1
    assert (seen == 1).all()
