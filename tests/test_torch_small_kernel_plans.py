"""The launch plans of the port's ``coded_decode`` and ``rmsnorm`` kernels.

The kernels take their launch from a Python function of the shape
(:func:`repro_torch.kernels.coded_decode.decode_plan`,
:func:`repro_torch.kernels.rmsnorm.plan` and ``bwd_plan``). The kernels
themselves run only on the card (``tests/test_torch_hopper.py``); here
each plan is held to what the kernel needs of it, by a model of the
kernel's own index arithmetic: every row and column is covered exactly
once, the vector width divides what it reads (a ragged size or an
unaligned base takes the scalar route), R passes over the shares cover R
with the compile-time bound exact at 16, and blocks stay within the
kernel's launch bound. The norm backward's grid is one wave, and a model
of its fixed-order, compensated sum of the scale gradient holds the fp32
bound at 4097 rows. The two training backwards of the SSM and MoE layers
take theirs from ``topk_gating.bwd_plan`` (every row's experts read and
written once) and ``ssd_scan.bwd_plan`` (the models' shapes within the
shared memory, every state entry and output once, what the kernel does
not take refused).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import autotune as AT  # noqa: E402
from repro_torch.kernels import coded_decode as CD  # noqa: E402
from repro_torch.kernels import rmsnorm as RN  # noqa: E402
from repro_torch.kernels import ssd_scan as SS  # noqa: E402
from repro_torch.kernels import topk_gating as TG  # noqa: E402
from repro_torch.kernels._layout import strides  # noqa: E402


# -- rmsnorm ---------------------------------------------------------------------

def _norm_cover(rows, D, p):
    """(times each row is normalised, times each column of a row is read)
    by the kernel's indexing under plan ``p``: block ``blk`` takes row groups
    blk·rpb, + blocks·rpb, ...; thread ``tid`` of a group its row slot
    tid // tpr and the accesses (i·tpr + tid % tpr) for i < nv, each of vec
    elements, below D / vec."""
    tpr = 32 * p.warps
    row_hits = np.zeros(rows, np.int64)
    for blk in range(p.blocks):
        for r0 in range(blk * p.rows_per_block, rows,
                        p.blocks * p.rows_per_block):
            for slot in range(p.rows_per_block):
                if r0 + slot < rows:
                    row_hits[r0 + slot] += 1
    vi = (np.arange(p.nv)[:, None] * tpr + np.arange(tpr)[None, :]).ravel()
    vi = vi[vi < D // p.vec]
    cols = (vi[:, None] * p.vec + np.arange(p.vec)[None, :]).ravel()
    col_hits = np.bincount(cols, minlength=D)
    return row_hits, col_hits


NORM_WIDTHS = [768, 1536, 2048, 4096, 6144, 8192,      # the paths' widths
               100, 1000, 2047, 1, 3, 128]             # ragged and tiny


@pytest.mark.parametrize("D", NORM_WIDTHS)
@pytest.mark.parametrize("x_bytes", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_rmsnorm_plan_covers_every_row_and_column_once(D, x_bytes, aligned):
    for rows, sms in ((2048, 132), (4, 132), (4097, 132), (37, 2), (1, 1)):
        p = RN.plan(rows, D, x_bytes, aligned, sms)
        row_hits, col_hits = _norm_cover(rows, D, p)
        assert (row_hits == 1).all(), (rows, sms, p)
        assert (col_hits == 1).all(), (rows, sms, p)
        assert 32 * p.warps * p.rows_per_block <= RN.MAX_THREADS
        assert p.nv in (RN.VECTOR_NV if p.vec > 1 else RN.SCALAR_NV)


@pytest.mark.parametrize("D", NORM_WIDTHS)
@pytest.mark.parametrize("x_bytes", [2, 4], ids=["bf16", "fp32"])
def test_rmsnorm_vector_width_divides_the_row(D, x_bytes):
    """16-byte accesses only where they divide D and both bases are
    aligned; a ragged D or an offset base takes the scalar route."""
    p = RN.plan(2048, D, x_bytes, True, 132)
    if D % (16 // x_bytes) == 0:
        assert p.vec == 16 // x_bytes
    else:
        assert p.vec == 1
    assert D % p.vec == 0
    assert RN.plan(2048, D, x_bytes, False, 132).vec == 1


@pytest.mark.parametrize("D,warps,nv", [
    (768, 1, 4), (1536, 1, 8), (2048, 1, 8),   # one warp up to 2048 in bf16
    (4096, 2, 8), (6144, 3, 8), (8192, 4, 8)])
def test_rmsnorm_warps_per_row_grow_with_d(D, warps, nv):
    p = RN.plan(2048, D, 2, True, 132)
    assert (p.vec, p.warps, p.nv) == (8, warps, nv)


@pytest.mark.parametrize("rows,D,warps,nv", [
    (4, 2048, 4, 2), (4, 4096, 8, 2), (4, 8192, 16, 2), (132, 2048, 4, 2),
    (133, 2048, 1, 8)])
def test_rmsnorm_few_rows_spread_over_more_warps(rows, D, warps, nv):
    """No more rows than SMs (a decode step): a thread holds 16 elements,
    two 16-byte accesses, so a row spans more warps."""
    p = RN.plan(rows, D, 2, True, 132)
    assert (p.warps, p.nv) == (warps, nv)


@pytest.mark.parametrize("rows,rpb,blocks", [
    (2048, 8, 256),       # prefill: 8 one-warp rows a block
    (4, 1, 4),            # decode: a row per block, spread over 4 SMs
    (1, 1, 1),
    (10 ** 6, 8, 132 * 8)])  # grid stops at what the SMs hold; blocks loop
def test_rmsnorm_rows_per_block_and_grid(rows, rpb, blocks):
    p = RN.plan(rows, 2048, 2, True, 132)
    assert (p.rows_per_block, p.blocks) == (rpb, blocks)


@pytest.mark.parametrize("x_bytes,aligned,largest", [
    (2, True, 32768), (4, True, 16384), (2, False, 16384)])
def test_rmsnorm_plan_refuses_rows_past_its_largest_d(x_bytes, aligned,
                                                      largest):
    RN.plan(4, largest, x_bytes, aligned, 132)
    with pytest.raises(ValueError, match="takes D up to"):
        RN.plan(4, largest + 16, x_bytes, aligned, 132)


# -- rmsnorm backward ---------------------------------------------------------

@pytest.mark.parametrize("D", NORM_WIDTHS)
@pytest.mark.parametrize("x_bytes", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_rmsnorm_bwd_plan_covers_every_row_and_column_once(D, x_bytes,
                                                           aligned):
    """The backward's groups walk rows as the forward's slots do (group
    ``grp`` of block ``blk`` takes blk·groups + grp, + blocks·groups, ...),
    so the forward's model of the indexing covers it; a block holds as
    many groups as fit, and a block of several holds a row's columns in its
    fold buffer."""
    for rows, sms in ((2048, 132), (4, 132), (4097, 132), (37, 2), (1, 1)):
        p = RN.bwd_plan(rows, D, x_bytes, aligned, sms)
        row_hits, col_hits = _norm_cover(rows, D, p)
        assert (row_hits == 1).all(), (rows, sms, p)
        assert (col_hits == 1).all(), (rows, sms, p)
        assert 32 * p.warps * p.rows_per_block <= RN.MAX_THREADS
        assert 32 * p.warps * (p.rows_per_block + 1) > RN.MAX_THREADS
        if p.rows_per_block > 1:                  # the groups' fold
            assert 32 * p.warps * p.nv * p.vec <= 4096


@pytest.mark.parametrize("D", [768, 1536, 2048, 4096, 6144, 8192])
@pytest.mark.parametrize("x_bytes", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("sms", [132, 114])
def test_rmsnorm_bwd_grid_is_one_or_two_blocks_an_sm(D, x_bytes, sms):
    """At the training rows (2048) the grid fills the card once,
    and the scale gradient's scratch, a row of D fp32 a block, stays
    under a tenth of the bytes the call must move."""
    p = RN.bwd_plan(2048, D, x_bytes, True, sms)
    assert sms <= p.blocks <= 2 * sms
    scratch = p.blocks * D * 4
    assert scratch < 0.1 * 3 * 2048 * D * x_bytes


def _kahan(s, c, v):
    y = v - c
    t = s + y
    return t, (t - s) - y


def _dscale_in_kernel_order(terms, p):
    """The scale gradient as ``csrc/rmsnorm_bwd.cu`` sums it, in fp32:
    each group of each block a compensated sum over its rows in order,
    the groups folded into group 0 in order, a scratch row a block; then
    ``BWD_REDUCE_RANGES`` ranges of the scratch rows each summed in order
    and the ranges in order, every sum compensated."""
    rows, D = terms.shape
    f32 = np.float32
    zero = lambda: np.zeros(D, f32)  # noqa: E731
    groups = p.rows_per_block
    partial = np.zeros((p.blocks, D), f32)
    for blk in range(p.blocks):
        sums = []
        for grp in range(groups):
            s, c = zero(), zero()
            for r in range(blk * groups + grp, rows, p.blocks * groups):
                s, c = _kahan(s, c, terms[r])
            sums.append((s, c))
        s, c = sums[0]
        for sg, cg in sums[1:]:
            s, c = _kahan(s, c, sg - cg)
        partial[blk] = s - c
    n = RN.BWD_REDUCE_RANGES
    per = -(-p.blocks // n)
    total, comp = zero(), zero()
    for k in range(n):
        b0 = min(p.blocks, k * per)
        s, c = zero(), zero()
        for b in range(b0, min(p.blocks, b0 + per)):
            s, c = _kahan(s, c, partial[b])
        total, comp = _kahan(total, comp, s - c)
    return total - comp


@pytest.mark.parametrize("D,x_bytes", [(2048, 2), (6144, 2), (768, 2),
                                       (1000, 4), (100, 2)])
def test_rmsnorm_bwd_scale_sum_holds_the_fp32_bound_at_4097_rows(D,
                                                                 x_bytes):
    """4097 rows of g·x̂ whose column sums cancel, summed in the kernels'
    order in fp32, land within 3e-5 of the fp64 sum (the card's check of
    the 4097-row case, chip_smoke.py phase 19)."""
    rng = np.random.default_rng(D)
    x = rng.standard_normal((4097, D)).astype(np.float32)
    g = rng.standard_normal((4097, D)).astype(np.float32)
    r = (1 / np.sqrt((x * x).mean(1, keepdims=True) + 1e-6)).astype(
        np.float32)
    terms = (g * (x * r)).astype(np.float32)
    p = RN.bwd_plan(4097, D, x_bytes, True, 132)
    got = _dscale_in_kernel_order(terms, p)
    want = terms.astype(np.float64).sum(0)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)


# -- coded_decode ------------------------------------------------------------------

def _decode_cover(B, F, p):
    """Times each (row, column) is written by the kernel's indexing under
    plan ``p``: block (bx, by), thread (tx, ty) takes columns
    (by·cols + tx)·vec .. + vec below F, and rows bx·rows + ty, + lanes,
    ... below min(B, (bx + 1)·rows)."""
    hits = np.zeros((B, F), np.int64)
    gx, gy = p.grid
    for bx in range(gx):
        b_end = min(B, (bx + 1) * p.rows)
        for by in range(gy):
            for tx in range(p.cols):
                c = (by * p.cols + tx) * p.vec
                if c >= F:
                    continue
                for ty in range(p.lanes):
                    hits[bx * p.rows + ty:b_end:p.lanes, c:c + p.vec] += 1
    return hits


DECODE_SHAPES = [(256, 64), (7, 52), (1, 43), (33, 640), (3, 5), (1024, 16),
                 (9, 48)]


@pytest.mark.parametrize("B,F", DECODE_SHAPES)
@pytest.mark.parametrize("elem", [4, 1], ids=["fp32", "int8"])
@pytest.mark.parametrize("block_batch", [1, 2, 4, 8, 16, 0, 2 ** 40])
def test_decode_plan_covers_every_row_and_column_once(B, F, elem,
                                                      block_batch):
    p = CD.decode_plan(B, 6, F, elem, 6 * F, F, 0, block_batch)
    assert (_decode_cover(B, F, p) == 1).all(), p
    assert p.cols * p.lanes <= CD.MAX_THREADS
    assert 1 <= p.lanes <= p.rows <= max(B, 1)


@pytest.mark.parametrize("F", [64, 52, 43, 640, 16, 48, 5])
@pytest.mark.parametrize("elem", [4, 1], ids=["fp32", "int8"])
def test_decode_vector_width_divides_what_it_reads(F, elem):
    """Accesses of 4 columns (16 bytes of fp32, 4 of int8) only where 4
    divides F and both strides and the base is aligned to the access; any
    of those off takes the scalar route."""
    p = CD.decode_plan(256, 6, F, elem, 6 * F, F, 0, 2)
    assert p.vec == (4 if F % 4 == 0 else 1)
    for sb, sr in ((6 * F, F), (0, F), (6 * F, 0)):
        p = CD.decode_plan(256, 6, F, elem, sb, sr, 0, 2)
        assert all(n % p.vec == 0 for n in (F, sb, sr))
    assert CD.decode_plan(256, 6, F, elem, 6 * F, F, elem, 2).vec == 1
    assert CD.decode_plan(256, 6, F, elem, 6 * F + 1, F, 0, 2).vec == 1
    assert CD.decode_plan(256, 6, F, elem, 6 * F, F + 1, 0, 2).vec == 1
    # an int8 base 4 bytes past 16 is aligned to its 4-byte access
    assert CD.decode_plan(256, 6, F, elem, 6 * F, F, 4, 2).vec == \
        (4 if F % 4 == 0 and elem == 1 else 1)


@pytest.mark.parametrize("R,r_max,passes", [
    (1, 4, 1), (4, 4, 1), (5, 8, 1), (6, 8, 1), (8, 8, 1), (12, 16, 1),
    (16, 16, 1),                        # the compile-time edge: one pass
    (17, 16, 2), (20, 16, 2), (32, 16, 2), (33, 16, 3), (128, 16, 8)])
def test_decode_r_passes_cover_r_once(R, r_max, passes):
    """The kernel loads ``r_max`` shares a pass (the smallest template
    bound that holds R, else 16) and loops passes over r0 = 0, r_max, ...
    below R: each share once, one pass up to R = 16."""
    p = CD.decode_plan(7, R, 64, 4, R * 64, 64, 0, 2)
    assert p.r_max == r_max and p.r_max in CD.R_BOUNDS
    starts = range(0, R, p.r_max)
    assert len(starts) == passes
    covered = [r0 + i for r0 in starts for i in range(p.r_max) if r0 + i < R]
    assert covered == list(range(R))


def test_recovery_path_view_takes_the_vector_route():
    """The recovery path hands the kernel its (R, B, F) share stack
    transposed, without a copy: at the fused output-coded shape that view
    still reads 16 bytes at a time."""
    stack = torch.empty((6, 256, 64))
    view = stack.transpose(0, 1)
    sb, sr, sf = strides(view)
    assert (sb, sr, sf) == (64, 256 * 64, 1)
    p = CD.decode_plan(256, 6, 64, 4, sb, sr, 0, 2)
    assert (p.vec, p.r_max, p.grid) == (4, 8, (128, 1))


@pytest.mark.parametrize("bb", AT.CANDIDATES["coded_decode"]["block_batch"])
def test_decode_block_rows_follow_the_tuner_axis(bb):
    """Every candidate of the tuner's ``block_batch`` axis is the rows a
    block serves (clamped to B), and the grid covers B with them."""
    for B in (1, 7, 256, 1000):
        p = CD.decode_plan(B, 6, 64, 4, 384, 64, 0, bb)
        assert p.rows == min(bb, B)
        assert (p.grid[0] - 1) * p.rows < B <= p.grid[0] * p.rows


# -- topk_gating_bwd and ssd_scan_bwd -------------------------------------------------

@pytest.mark.parametrize("N,E,k", [(2048, 64, 6), (2048, 16, 2), (4, 64, 6),
                                   (4, 16, 2), (77, 100, 5), (33, 256, 8),
                                   (7, 6, 6), (1, 3, 2), (5, 256, 256)])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_gating_bwd_plan_reads_and_writes_every_logit_once(N, E, k, aligned):
    """Block ``bx``, thread ``tid`` takes row (bx·threads + tid) // G and
    lane tid % G, which reads and writes the elements of its accesses (j·G
    + t)·vec .. + vec below E: over the grid each (row, expert) once."""
    for sms in (132, 3, 1):
        p = TG.bwd_plan(N, E, k, aligned, sms)
        threads = p.rows_per_block * p.lanes
        assert threads % 32 == 0 and threads <= TG.MAX_THREADS
        assert p.vec == (4 if aligned and E % 4 == 0 else 1)
        touched = np.zeros((N, E), np.int64)
        for bx in range(p.blocks):
            for tid in range(threads):
                r = (bx * threads + tid) // p.lanes
                if r >= N:
                    continue
                t = tid % p.lanes
                for j in range(p.nv):
                    e0 = (j * p.lanes + t) * p.vec
                    if e0 < E:
                        touched[r, e0:e0 + p.vec] += 1
        assert (touched == 1).all(), (sms, p)


# (B, H, L, P, N, Q): mamba2-130m's and jamba's training shapes, the tiny
# configs', a ragged chunk and L below the chunk
SCAN_BWD = [(4, 24, 512, 64, 128, 256), (4, 128, 512, 64, 16, 256),
            (4, 8, 64, 32, 16, 32), (1, 4, 96, 16, 32, 48),
            (2, 3, 20, 32, 16, 20)]
SCAN_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("Bsz,H,L,P,N,Q", SCAN_BWD)
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_head"])
@pytest.mark.parametrize("dtype", SCAN_DTYPES, ids=["fp32", "bf16"])
def test_scan_bwd_plan_covers_rows_entries_and_outputs(Bsz, H, L, P, N, Q,
                                                       shared, dtype):
    """The route from the dtype and (P, N) alone; the tensor route's two
    states blocks (own state and its gradient) and two tile blocks ((3s)
    and (3t)) per (batch row, head, chunk, 64-row tile) and a scan warp per
    (batch row, head, chunk), the CUDA-core route's block per (batch row,
    head, chunk) in the states and chunk launches; on both a thread per
    state entry in the fold, and the head sum's grid-stride loop over (B,
    L, N) or (B, H, L, N) outputs within 8 blocks an SM; both
    shared-memory sizes within the card's 227 KB; the workspace the
    kernel carves."""
    route = SS.bwd_route(dtype, P, N)
    assert route == ("mma" if dtype == torch.bfloat16 and
                     (P, N) in SS.BWD_MMA_SHAPES else "cuda_cores")
    BH, nc, tiles = Bsz * H, L // Q, -(-Q // SS.BWD_TILE)
    for sms in (132, 1):
        p = SS.bwd_plan(dtype, Bsz, H, L, P, N, Q, shared, sms)
        assert p.route == route
        if route == "mma":
            assert p.state_blocks == 2 * BH * nc
            assert p.tile_blocks == 2 * tiles * BH * nc
            assert (p.scan_blocks - 1) * 8 < BH * nc <= p.scan_blocks * 8
        else:
            assert p.state_blocks == p.tile_blocks == BH * nc
            assert p.scan_blocks == 0
        rows, groups = p.fold_grid
        assert rows == BH
        assert (groups - 1) * SS.BWD_THREADS < P * N <= groups * \
            SS.BWD_THREADS
        outs = Bsz * (1 if shared else H) * L * N
        assert 1 <= p.reduce_blocks <= 8 * sms
        assert p.reduce_blocks == min(-(-outs // SS.BWD_THREADS), 8 * sms)
        assert max(p.smem_state, p.smem_tiles) <= SS.SMEM_LIMIT
        assert (p.smem_state, p.smem_tiles) == SS.bwd_smem_bytes(P, N, Q,
                                                                 route)
        assert p.workspace == SS.bwd_workspace_bytes(Bsz, H, L, P, N, Q,
                                                     route)


def _tile_blocks(ntt: int, nc: int):
    """The tensor route's tile launch as the kernel reads blockIdx.x:
    k = x // nc, chunk x % nc, rank k // 2; side 0 the (3s) block of
    s-tile rank walking the t-tiles rank.. ntt - 1, side 1 the (3t) block
    of t-tile ntt - 1 - rank walking the s-tiles 0.. that tile."""
    for x in range(2 * ntt * nc):
        k, c = divmod(x, nc)
        rank, side = divmod(k, 2)
        if side == 0:
            yield side, c, [(rank, j) for j in range(rank, ntt)]
        else:
            j = ntt - 1 - rank
            yield side, c, [(i, j) for i in range(j + 1)]


@pytest.mark.parametrize("Bsz,H,L,P,N,Q", SCAN_BWD[:3] + SCAN_BWD[4:])
def test_scan_bwd_tiles_cover_every_pair_once_heaviest_first(Bsz, H, L, P,
                                                             N, Q):
    """Over the tile launch's grid (x as above, y the head, z the batch
    row), each (s-tile, t-tile >= s-tile) pair of every chunk, head and
    batch row is walked exactly once by a (3s) block and once by a (3t)
    block, and each side's blocks come in order of walks that never
    lengthen (the heaviest first)."""
    p = SS.bwd_plan(torch.bfloat16, Bsz, H, L, P, N, Q, True, 132)
    ntt, nc = -(-Q // SS.BWD_TILE), L // Q
    blocks = list(_tile_blocks(ntt, nc))
    assert len(blocks) * H * Bsz == p.tile_blocks
    for side in (0, 1):
        seen = np.zeros((nc, ntt, ntt), np.int64)
        walks = []
        for sd, c, pairs in blocks:
            if sd == side:
                walks.append(len(pairs))
                for i, j in pairs:
                    seen[c, i, j] += 1
        want = np.triu(np.ones((ntt, ntt), np.int64))
        assert (seen == want[None]).all(), side
        assert walks == sorted(walks, reverse=True), side


def test_scan_bwd_tensor_route_fills_the_card_at_mamba2s_shape():
    """At mamba2-130m's training shape on 132 SMs: 384 blocks of the
    states launch, 1536 of the tile launch, whose shared memory lets two
    blocks share an SM (228 KB, 1 KB reserved a block): over five blocks
    an SM in flight or waiting."""
    p = SS.bwd_plan(torch.bfloat16, 4, 24, 512, 64, 128, 256, True, 132)
    assert p.route == "mma"
    assert p.state_blocks == 384 >= 2 * 132
    assert p.tile_blocks == 1536 >= 5 * 2 * 132
    assert 2 * (p.smem_tiles + 1024) <= 228 * 1024
    assert 3 * (p.smem_state + 1024) <= 228 * 1024


def test_scan_bwd_shared_memory_at_the_models_shapes():
    """mamba2's (64, 128, 256) is the largest the models take: the
    CUDA-core chunk launch holds 225,800 bytes of the 232,448 a block may
    use, the tensor route's tile launch 102,912 (x, B and two stages of C
    and dy's two terms, 64 rows each, and 16 bytes a step) and its states
    launch 73,728."""
    assert SS.bwd_smem_bytes(64, 128, 256) == (103424, 225800)
    assert SS.bwd_smem_bytes(64, 16, 256)[1] == 111112
    assert SS.bwd_smem_bytes(32, 16, 32)[1] < 96 * 1024
    assert SS.bwd_smem_bytes(64, 128, 256, "mma") == (73728, 102912)
    assert SS.bwd_smem_bytes(64, 16, 256, "mma") == (45056, 59904)
    row = lambda w: 2 * 64 * (w + SS.PAD)  # noqa: E731  a 64-row bf16 tile
    assert 102912 == (row(64) + row(128) + 2 * (row(128) + 2 * row(64))
                      + 16 * 256 + 4 * SS.BWD_MMA_THREADS)


@pytest.mark.parametrize("P,N,route", [(64, 128, "mma"), (64, 16, "mma"),
                                       (32, 16, "mma"), (16, 32, "cuda_cores"),
                                       (32, 8, "cuda_cores"),
                                       (128, 64, "cuda_cores")])
def test_scan_bwd_route_is_the_tensor_one_at_the_models_shapes(P, N, route):
    """bf16 at the models' (P, N) takes the tensor route, other bf16 shapes
    and every fp32 one the CUDA-core route."""
    assert SS.bwd_route(torch.bfloat16, P, N) == route
    assert SS.bwd_route(torch.float32, P, N) == "cuda_cores"


def test_scan_bwd_workspace_regions_start_on_16_bytes():
    """The workspace is the sum of its regions each rounded up to 16
    bytes, the tensor route's four more (cumsums, dy's terms, per-step
    sums, ⟨Hn, h⟩) after the CUDA-core route's six."""
    Bsz, H, L, P, N, Q = 1, 3, 20, 32, 16, 20
    BH, nc = Bsz * H, L // Q
    up = lambda n: -(-n // 16) * 16  # noqa: E731
    cores = (2 * up(4 * BH * nc * P * N) + 2 * up(4 * BH * nc)
             + 2 * up(4 * BH * L * N))
    assert SS.bwd_workspace_bytes(Bsz, H, L, P, N, Q, "cuda_cores") == cores
    assert SS.bwd_workspace_bytes(Bsz, H, L, P, N, Q, "mma") == cores + (
        up(8 * BH * L) + up(2 * SS.BWD_TERMS * BH * L * P) + up(16 * BH * L)
        + up(4 * BH * nc))


@pytest.mark.parametrize("P,N,Q,match", [(48, 16, 32, "powers of two"),
                                         (64, 256, 32, "powers of two"),
                                         (2, 16, 32, "powers of two"),
                                         (128, 128, 32, "powers of two"),
                                         (128, 64, 1024, "shared memory")])
def test_scan_bwd_plan_refuses_what_the_kernel_does_not_take(P, N, Q, match):
    for dtype in SCAN_DTYPES:
        with pytest.raises(ValueError, match=match):
            SS.bwd_plan(dtype, 1, 2, Q, P, N, Q, True, 132)


def test_scan_bwd_tensor_route_counts_its_bf16_operations():
    """The route's bound counts the products its warps issue: at mamba2's
    shape 25.1 GFLOP (0.0254 ms at the bf16 rate), at jamba's 44.7."""
    assert SS.bwd_mma_flops(4, 24, 512, 64, 128, 256) == 25115492352
    assert SS.bwd_mma_flops(4, 128, 512, 64, 16, 256) == 44694503424
