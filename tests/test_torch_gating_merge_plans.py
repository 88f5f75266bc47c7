"""The launch plans of the port's ``topk_gating`` and ``quorum_aggregate``
kernels.

Both kernels take their launch from a Python function of the shape
(:func:`repro_torch.kernels.topk_gating.plan`,
:func:`repro_torch.kernels.quorum_aggregate.merge_plan`). The kernels
themselves run only on the card (``tests/test_torch_hopper.py``); here each
plan is held to what the kernel needs of it, by a model of the kernel's own
index arithmetic: every row, expert, slot element and output is covered
exactly once, the vector width divides what it reads (ragged E or Dk and
unaligned bases take the scalar route), blocks stay within the launch
bound, the gating's tie rule under its lane layout gives the plain
version's indices, and the merge's summation order does not depend on
``block_batch``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import autotune as AT  # noqa: E402
from repro_torch.kernels import quorum_aggregate as QA  # noqa: E402
from repro_torch.kernels import topk_gating as TG  # noqa: E402

GRID_LIMIT = 2 ** 31 - 1


# -- topk_gating -------------------------------------------------------------------

def _lane_elements(E, p, t):
    """The experts lane ``t`` of a row holds under plan ``p``, in the order
    it scans them: access j covers (j·G + t)·vec .. + vec, below E."""
    out = []
    for j in range(p.nv):
        e0 = (j * p.lanes + t) * p.vec
        if e0 < E:
            out.extend(range(e0, e0 + p.vec))
    return out


def _gating_cover(N, E, k, p):
    """(times each (row, expert) is read, times each (row, round) is
    stored): block ``bx``, thread ``tid`` takes row (bx·threads + tid) // G
    and lane tid % G; lane t stores rounds jj·G + t below k."""
    threads = p.rows_per_block * p.lanes
    reads = np.zeros((N, E), np.int64)
    stores = np.zeros((N, k), np.int64)
    per = p.vec * p.nv
    for bx in range(p.blocks):
        for tid in range(threads):
            r = (bx * threads + tid) // p.lanes
            if r >= N:
                continue
            t = tid % p.lanes
            for e in _lane_elements(E, p, t):
                reads[r, e] += 1
            for jj in range(per):
                if jj * p.lanes + t < k:
                    stores[r, jj * p.lanes + t] += 1
    return reads, stores


GATE_SHAPES = [(2048, 64, 6), (4, 64, 6), (4, 16, 2), (2048, 16, 2),
               (4, 8, 2), (4, 256, 6), (3, 256, 256), (5, 100, 7),
               (7, 6, 6), (1, 3, 2), (77, 4, 1), (33, 130, 9)]


@pytest.mark.parametrize("N,E,k", GATE_SHAPES)
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_gating_plan_covers_every_row_and_expert_once(N, E, k, aligned):
    for sms in (132, 2, 1):
        p = TG.plan(N, E, k, aligned, sms)
        reads, stores = _gating_cover(N, E, k, p)
        assert (reads == 1).all(), (sms, p)
        assert (stores == 1).all(), (sms, p)
        # the rounds a lane keeps fit the registers that hold its row
        assert k <= p.lanes * p.vec * p.nv


@pytest.mark.parametrize("E", [64, 16, 8, 4, 256, 128, 132, 100, 6, 3, 1])
def test_gating_lanes_and_vector_width_follow_e(E):
    """A lane per 16 bytes of the row, a power of two within [2, 32]; 16-
    byte accesses only where 4 divides E and the base is aligned."""
    p = TG.plan(2048, E, 1, True, 132)
    assert p.lanes == min(32, max(2, 1 << (-(-E // 4) - 1).bit_length()))
    assert p.vec == (4 if E % 4 == 0 else 1)
    assert E % p.vec == 0
    assert p.nv in (TG.VECTOR_NV if p.vec > 1 else TG.SCALAR_NV)
    q = TG.plan(2048, E, 1, False, 132)
    assert q.vec == 1 and q.lanes == p.lanes
    assert q.nv in TG.SCALAR_NV


@pytest.mark.parametrize("E,lanes", [(64, 16), (16, 4), (8, 2), (256, 32)])
def test_gating_serving_shapes_take_16_byte_loads(E, lanes):
    """moonshot's E 64 takes 16 lanes of 4 values, jamba's E 16 four, E 8
    two; past 128 experts each of 32 lanes reads two accesses."""
    p = TG.plan(4, E, 2, True, 132)
    assert (p.vec, p.lanes, p.nv) == (4, lanes, 2 if E > 128 else 1)


@pytest.mark.parametrize("N,E,rpb,blocks", [
    (2048, 64, 16, 128),     # moonshot's prefill: one wave on 132 SMs
    (2048, 16, 16, 128),     # jamba's prefill
    (4096, 64, 16, 256),
    (4, 64, 2, 2),           # a decode step: one warp a block
    (4, 16, 8, 1),
    (1, 256, 1, 1),
    (10 ** 6, 64, 16, 62500)])
def test_gating_rows_per_block_and_grid(N, E, rpb, blocks):
    p = TG.plan(N, E, 6, True, 132)
    assert (p.rows_per_block, p.blocks) == (rpb, blocks)
    threads = p.rows_per_block * p.lanes
    assert threads % 32 == 0 and threads <= TG.MAX_THREADS
    assert (p.blocks - 1) * p.rows_per_block < N <= p.blocks * \
        p.rows_per_block <= GRID_LIMIT * p.rows_per_block


def test_gating_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="k <= E"):
        TG.plan(4, 300, 2, True, 132)
    with pytest.raises(ValueError, match="k <= E"):
        TG.plan(4, 8, 9, True, 132)


def _gating_model(logits, k, p):
    """The kernel's arithmetic under plan ``p`` on one row: softmax as
    exp(v - m) / s in fp32, then k rounds in which each lane scans its own
    experts in ascending index (strict >, so the first of equal values
    stays) and a butterfly over the G lanes keeps the larger value, the
    lower index on a tie; the winner is masked by its owner."""
    E = logits.shape[0]
    v = logits.to(torch.float32)
    e = torch.exp(v - v.max())
    pr = (e / e.sum()).tolist()
    pr = [float(np.float32(x)) for x in pr]
    lanes = [_lane_elements(E, p, t) for t in range(p.lanes)]
    picked = []
    for _ in range(k):
        best = []
        for own in lanes:
            b, bi = -1e30, 2 ** 31 - 1
            for i in own:
                if pr[i] > b:
                    b, bi = pr[i], i
            best.append((b, bi))
        off = p.lanes // 2
        while off:
            nxt = []
            for t in range(p.lanes):
                (b, bi), (ob, oi) = best[t], best[t ^ off]
                nxt.append((ob, oi) if ob > b or (ob == b and oi < bi)
                           else (b, bi))
            best = nxt
            off //= 2
        assert len(set(best)) == 1         # every lane holds the winner
        pr[best[0][1]] = -1e30
        picked.append(best[0][1])
    return picked


@pytest.mark.parametrize("E,k", [(64, 6), (16, 2), (8, 2), (256, 8), (6, 6),
                                 (100, 5)])
@pytest.mark.parametrize("aligned", [True, False], ids=["vector", "scalar"])
def test_gating_tie_rule_under_the_lane_layout(E, k, aligned):
    """Rows with planted ties, within a lane, across lanes of a group and
    across groups of accesses, give the plain version's indices."""
    rng = np.random.default_rng(E * 31 + k)
    rows = []
    for pattern in range(6):
        x = rng.normal(size=E).astype(np.float32)
        hi = np.float32(4.0)
        if pattern == 0:                   # all equal: indices 0, 1, ...
            x[:] = 0
        elif pattern == 1:                 # two maxima in different lanes
            x[[E - 1, 0]] = hi
        elif pattern == 2:                 # inside one lane's access
            x[[1, 2, 3 % E]] = hi
        elif pattern == 3:                 # across lane groups
            x[[E // 2, E // 4, E - 2]] = hi
        elif pattern == 4:                 # ties below the top
            x[:] = -3
            x[[E // 3, E - 1]] = hi
        else:                              # every other expert tied
            x[::2] = hi
        rows.append(x)
    logits = torch.from_numpy(np.stack(rows))
    _, want = TG.topk_gating_ref(logits, k)
    p = TG.plan(len(rows), E, k, aligned, 132)
    got = [_gating_model(row, k, p) for row in logits]
    assert got == want.tolist()


# -- quorum_aggregate ----------------------------------------------------------------

def _rows_cover(K, B, Dk, C, p):
    """(times each row is merged, times each (slot, d) of a row is read,
    times each class is written) by the rows route's indexing under plan
    ``p``: block bx, warp w takes rows bx·rows + w, + warps, ... below
    min(B, (bx + 1)·rows); lane (g, t) reads chunk t + G·j of slot
    pass·S + g, elements 4q .. 4q + 3 below Dk; lane c < C writes class
    c."""
    G, S, J, P = QA.row_layout(K, Dk)
    assert G == p.lanes and P * J <= p.nch
    warps = p.threads // 32
    row_hits = np.zeros(B, np.int64)
    for bx in range(p.grid[0]):
        b_end = min(B, (bx + 1) * p.rows)
        for w in range(warps):
            for b in range(bx * p.rows + w, b_end, warps):
                row_hits[b] += 1
    reads = np.zeros((K, Dk), np.int64)
    Q = -(-Dk // 4)
    for i in range(p.nch):
        pas, j = divmod(i, J)
        if pas >= P:
            break
        for lane in range(32):
            g, t = divmod(lane, G)
            k, q = pas * S + g, t + G * j
            if k < K and q < Q:
                for d in range(4 * q, min(4 * q + 4, Dk)):
                    reads[k, d] += 1
    cols = np.bincount([lane for lane in range(32) if lane < C],
                       minlength=C)
    return row_hits, reads, cols


def _tiles_cover(B, C, p):
    """Times each output is written by the tiles route: block (bx, by),
    thread ty·bn + tx owns (bx·rows + ty, by·bn + tx)."""
    hits = np.zeros((B, C), np.int64)
    for bx in range(p.grid[0]):
        for by in range(p.grid[1]):
            for tid in range(p.threads):
                r = bx * p.rows + tid // p.lanes
                c = by * p.lanes + tid % p.lanes
                if r < B and c < C:
                    hits[r, c] += 1
    return hits


MERGE_SHAPES = [(8, 256, 32, 10), (6, 7, 43, 10), (8, 1000, 640, 100),
                (6, 1, 43, 100), (4, 1024, 16, 10), (4, 256, 64, 10),
                (2, 256, 128, 10), (5, 33, 52, 10), (8, 1, 32, 10),
                (3, 5, 1, 3), (32, 9, 8, 32), (6, 7, 640, 10)]


@pytest.mark.parametrize("K,B,Dk,C", MERGE_SHAPES)
@pytest.mark.parametrize("bb", [1, 2, 4, 8, 16, 32, 0, 2 ** 40])
def test_merge_plan_covers_every_row_slot_and_output_once(K, B, Dk, C, bb):
    p = QA.merge_plan(K, B, Dk, C, bb, B * Dk, Dk, 0)
    if p.route == "rows":
        row_hits, reads, cols = _rows_cover(K, B, Dk, C, p)
        assert (row_hits == 1).all(), p
        assert (reads == 1).all(), p
        assert (cols == 1).all(), p
        assert p.threads <= 256 and p.smem == QA.row_smem(K, Dk, C) <= QA.ROW_SMEM
        assert p.grid[1] == 1 and C <= p.cmax <= 32 and K <= 32
    else:
        assert (_tiles_cover(B, C, p) == 1).all(), p
        assert p.threads == p.rows * p.lanes <= QA.TILE_THREADS
        assert p.smem == p.rows * (QA.TILE_DEPTH + 1) * 4
    assert 1 <= p.rows and p.grid[0] <= GRID_LIMIT


@pytest.mark.parametrize("K,Dk,C,want", [
    (8, 32, 10, "rows"), (6, 43, 10, "rows"), (4, 64, 10, "rows"),
    (2, 128, 10, "rows"), (4, 256, 10, "rows"), (8, 256, 10, "tiles"),
    (8, 32, 100, "tiles"), (6, 640, 100, "tiles"), (33, 8, 10, "tiles"),
    (8, 32, 32, "rows"), (8, 32, 33, "tiles"), (4, 0, 10, "tiles")])
def test_merge_route_follows_the_shape(K, Dk, C, want):
    assert QA.route(K, Dk, C) == want


@pytest.mark.parametrize("Dk", [32, 43, 64, 52, 128, 16, 1])
def test_merge_vector_width_divides_what_it_reads(Dk):
    """Chunks read as one 16-byte access only where 4 divides Dk and both
    strides and the base is aligned to it; any of those off reads the
    chunk one element at a time."""
    K, B, C = 4, 256, 10
    p = QA.merge_plan(K, B, Dk, C, 1, B * Dk, Dk, 0)
    assert p.route == "rows" and p.vec == (4 if Dk % 4 == 0 else 1)
    for sk, sb in ((B * Dk, Dk), (Dk, K * Dk), (0, Dk), (B * Dk, 0)):
        p = QA.merge_plan(K, B, Dk, C, 1, sk, sb, 0)
        assert all(n % p.vec == 0 for n in (Dk, sk, sb))
    assert QA.merge_plan(K, B, Dk, C, 1, B * Dk, Dk, 4).vec == 1
    assert QA.merge_plan(K, B, Dk, C, 1, B * Dk + 1, Dk, 0).vec == 1
    assert QA.merge_plan(K, B, Dk, C, 1, B * Dk, Dk + 2, 0).vec == 1


def test_output_coded_view_takes_the_vector_route():
    """The output-coded path hands the merge its decoded (B, K, Dk) stack
    transposed, without a copy: at the fused shape that view still reads
    16 bytes at a time, one row a block over 256 blocks."""
    view = torch.empty((256, 4, 64)).transpose(0, 1)
    sk, sb, sd = QA.strides(view)
    assert (sk, sb, sd) == (64, 4 * 64, 1)
    p = QA.merge_plan(4, 256, 64, 10, 1, sk, sb, 0)
    assert (p.route, p.vec, p.lanes, p.grid) == ("rows", 4, 16, (256, 1))


@pytest.mark.parametrize("K,B,Dk,C", MERGE_SHAPES)
def test_merge_summation_order_does_not_depend_on_block_batch(K, B, Dk, C):
    """What fixes the order of each output's sum (the route, the lanes per
    slot and their chunks, the class bound; the tiles route's Dk slice) is
    the same for every candidate ``block_batch`` and for either vector
    width; only the rows a block owns change."""
    order = set()
    for bb in AT.CANDIDATES["quorum_aggregate"]["block_batch"]:
        for base in (0, 4):
            p = QA.merge_plan(K, B, Dk, C, bb, B * Dk, Dk, base)
            order.add((p.route, p.lanes if p.route == "rows" else 0,
                       QA.row_layout(K, Dk) if p.route == "rows" else 0))
            assert p.rows == max(1, min(bb, QA.MAX_ROWS if p.route == "rows"
                                        else QA.TILE_THREADS // p.lanes,
                                        max(B, 1) if p.route == "rows"
                                        else bb))
    assert len(order) == 1


def _rows_model(p32, w32, bias, mask, p):
    """The rows route's sum, written out with the plan's lanes: per slot,
    each lane's chunks in ascending d, a butterfly over the slot's G
    lanes, then acc += dot_k in ascending k and the bias last (fp32
    products and sums; the kernel fuses each product into its sum)."""
    K, B, Dk = p32.shape
    C = w32.shape[2]
    G, S, J, P = QA.row_layout(K, Dk)
    Q = -(-Dk // 4)
    out = torch.zeros((B, C))
    for b in range(B):
        acc = torch.zeros(C)
        for k in range(K):
            if mask[k] == 0:
                continue
            lanes = []
            for t in range(G):
                part = torch.zeros(C)
                for j in range(J):
                    q = t + G * j
                    for d in range(4 * q, min(4 * q + 4, Dk)) if q < Q else ():
                        part = part + p32[k, b, d] * w32[k, d]
                lanes.append(part)
            off = G // 2
            while off:
                lanes = [lanes[t] + lanes[t ^ off] for t in range(G)]
                off //= 2
            acc = acc + lanes[0]
        out[b] = acc + bias
    return out


@pytest.mark.parametrize("K,B,Dk,C", [(8, 5, 32, 10), (6, 3, 43, 10),
                                      (2, 2, 128, 10), (3, 4, 5, 7)])
def test_rows_route_model_matches_the_plain_version(K, B, Dk, C):
    """The rows route's lane layout, butterflies and ascending-k gather
    compute the merge: the model holds to the plain version within the
    kernels' 1e-5, dead slots included."""
    rng = np.random.default_rng(K * B + Dk)
    p = torch.from_numpy(rng.uniform(0, 1, (K, B, Dk)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(K, Dk, C)) / np.sqrt(K * Dk))
                         .astype(np.float32))
    b = torch.from_numpy(rng.normal(size=C).astype(np.float32))
    m = torch.from_numpy((np.arange(K) % 3 != 1).astype(np.int32))
    plan = QA.merge_plan(K, B, Dk, C, 1, B * Dk, Dk, 0)
    assert plan.route == "rows"
    np.testing.assert_allclose(_rows_model(p, w, b, m, plan),
                               QA.quorum_aggregate_ref(p, w, b, m),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bb", AT.CANDIDATES["quorum_aggregate"]["block_batch"])
def test_merge_block_rows_follow_the_tuner_axis(bb):
    """Every candidate of the tuner's ``block_batch`` axis is the output
    rows a block serves (clamped to B), and the grid covers B with them;
    at the serving shape the default spreads 256 rows over 256 blocks."""
    for B in (1, 7, 256, 1000):
        p = QA.merge_plan(8, B, 32, 10, bb, B * 32, 32, 0)
        assert p.rows == min(bb, B)
        assert (p.grid[0] - 1) * p.rows < B <= p.grid[0] * p.rows
    default = AT.resolve("quorum_aggregate", (8, 256, 32, 10), torch.float32)
    assert QA.merge_plan(8, 256, 32, 10, default["block_batch"]).grid[0] \
        >= 132
