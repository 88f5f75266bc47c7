"""The launch plan of the port's ``flash_attention_bwd`` and a model of its
tensor route's roundings.

The kernels run only on the card (``tests/test_torch_hopper.py`` and
``chip_smoke.py`` hold them to the plain version there). Here, on the CPU:
the route of :func:`repro_torch.kernels.flash_attention.bwd_plan` and the
slots its tensor-route kernels read (every tile planned once, the causal
skips exactly the tiles with no visible pair, element masks exactly where
a pair is not visible, keys past Sq planned so their gradients are zeroed,
heaviest tiles first, the table laid out as ``csrc/flash_attention_bwd.cu``
reads it), and a plain-torch model of the tensor route's arithmetic (bf16
operands, P and dS rounded to bf16 before their products, fp32 sums)
against the plain version at the training shapes' widths. No JAX: the
plain version is held to the JAX package by
``tests/test_torch_train_kernels.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as FA  # noqa: E402

BF = torch.bfloat16
BF16_TOL = dict(rtol=3e-2, atol=3e-2)        # chip_smoke.LM_KERNEL_TOL[bf16]
T = FA.BWD_TILE

# (B, KV, G, Sq, Skv, D): llama3.2-1b's and its students' widths at B 1,
# G 3 (no divisor of 64), ragged Sq and Skv both ways, one query or key,
SHAPES = [(1, 8, 4, 512, 512, 64), (1, 8, 2, 512, 512, 64),
          (2, 2, 3, 100, 100, 64), (1, 2, 4, 31, 65, 64),
          (1, 2, 1, 97, 33, 128), (1, 1, 1, 65, 96, 64),
          (1, 2, 4, 1, 40, 128), (1, 2, 1, 129, 1, 64),
          (1, 1, 2, 130, 190, 128),
          # qwen2-vl-7b's G 8 at D 128 (a 64-row tile holds 8 positions'
          # heads); whisper-medium's encoder over its 1500 frames (not a
          # multiple of 64) and its cross-attention, 64 decoder rows over
          # them
          (1, 4, 8, 512, 512, 128), (1, 16, 1, 1500, 1500, 64),
          (1, 16, 1, 64, 1500, 64)]


def _plan(shape, causal=True):
    return FA.bwd_plan(BF, *shape, causal)


def _visible(shape, causal):
    """(R, Skv) booleans: row r = i·G + g sees key j."""
    _, _, G, Sq, Skv, _ = shape
    i = np.arange(Sq * G)[:, None] // G
    j = np.arange(Skv)[None, :]
    return (j <= i) if causal else np.ones((Sq * G, Skv), bool)


def _pairs(shape, causal, r0, j0):
    """Whether each (row slot, key slot) pair of the 64 × 64 tile at
    (r0, j0) is a visible pair (slots past Sq·G or Skv are not)."""
    _, _, G, Sq, Skv, _ = shape
    r = r0 + np.arange(T)[:, None]
    j = j0 + np.arange(T)[None, :]
    ok = (r < Sq * G) & (j < Skv)
    return ok & ((j <= r // G) if causal else True)


# -- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", FA.HEAD_DIMS)
@pytest.mark.parametrize("shape", [(1, 1, 1, 1, 1), (4, 8, 4, 512, 512),
                                   (2, 3, 5, 77, 300), (1, 2, 2, 4096, 64)])
def test_route_follows_dtype_and_head_dim_alone(dtype, D, shape):
    plan = FA.bwd_plan(dtype, *shape, D, True)
    tensor = dtype == BF and D in FA.WGMMA_HEAD_DIMS
    assert plan.route == ("wgmma" if tensor else "cuda_cores")
    assert plan.launches == (2 if tensor else 3)
    assert plan.route == FA.bwd_route(dtype, D)
    assert plan.heads == shape[0] * shape[1]
    assert bool(plan.dq) == bool(plan.dkdv) == tensor


def test_plan_refuses_an_uninstantiated_head_dim():
    with pytest.raises(ValueError, match="head dim"):
        FA.bwd_plan(BF, 1, 1, 1, 8, 8, 80, True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_every_query_and_key_tile_planned_once(causal, shape):
    """A slot a tile: each of the dq launch's query tiles of 64 rows and
    the dkdv launch's key tiles of 64 keys once (each slot runs a block
    per (b, kv head))."""
    _, _, G, Sq, Skv, _ = shape
    plan = _plan(shape, causal)
    assert sorted(s[0] for s in plan.dq) == list(range(math.ceil(Sq * G
                                                                 / T)))
    assert sorted(s[0] for s in plan.dkdv) == list(range(math.ceil(Skv
                                                                   / T)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_key_walk_skips_exactly_the_tiles_with_no_visible_pair(shape,
                                                               causal):
    """Each query tile of the dq launch walks exactly the key tiles it has
    a visible pair in (so every visible pair is scored once a sweep), and
    masks element by element exactly those holding a pair it must not
    count: past Skv, or above the diagonal for a row of the tile."""
    _, _, G, Sq, Skv, _ = shape
    R = Sq * G
    vis = _visible(shape, causal)
    for qt, n, full in _plan(shape, causal).dq:
        r0 = qt * T
        rows = vis[r0:r0 + T]
        want = [t for t in range(math.ceil(Skv / T))
                if rows[:, t * T:(t + 1) * T].any()]
        assert list(range(n)) == want
        for t in range(n):
            real = _pairs(shape, causal, r0, t * T)[:R - r0]
            assert (t >= full) == (not real.all()), (qt, t)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_row_walk_skips_exactly_the_tiles_with_no_visible_pair(shape,
                                                               causal):
    """Each key tile of the dkdv launch walks exactly the 64-row tiles
    with a visible pair (so dK and dV sum every visible pair of every
    query head once), and masks element by element exactly those holding
    a slot past Sq·G or Skv or above the diagonal."""
    _, _, G, Sq, Skv, _ = shape
    vis = _visible(shape, causal)
    for kt, t0, n, lo, hi in _plan(shape, causal).dkdv:
        j0 = kt * T
        cols = vis[:, j0:j0 + T]
        want = [rt for rt in range(math.ceil(Sq * G / T))
                if cols[rt * T:(rt + 1) * T].any()]
        assert list(range(t0, t0 + n)) == want
        for rt in range(t0, t0 + n):
            masked = not lo <= rt < hi
            assert masked == (not _pairs(shape, causal, rt * T, j0).all())


@pytest.mark.parametrize("shape", [(1, 1, 1, 60, 200, 64),
                                   (1, 2, 4, 31, 300, 128),
                                   (2, 1, 2, 64, 256, 64)])
def test_keys_past_sq_are_planned_with_nothing_to_walk(shape):
    """Causal with Skv > Sq: the key tiles no query sees still get a
    slot, whose blocks walk no rows and write their dK and dV as zeros
    (the outputs come from ``torch.empty``)."""
    Sq = shape[3]
    causal = {s[0]: s[2] for s in _plan(shape, True).dkdv}
    full = {s[0]: s[2] for s in _plan(shape, False).dkdv}
    past = [t for t in causal if t * T >= Sq]
    assert past
    for t in past:
        assert causal[t] == 0 and full[t] > 0


@pytest.mark.parametrize("shape", SHAPES)
def test_heaviest_tiles_launch_first(shape):
    """Causal: the slots' work (tiles walked; the dq launch walks its key
    tiles twice) never grows along the launch order, so the light tiles
    fill the SMs that free up last."""
    plan = _plan(shape)
    dq = [2 * n for _, n, _ in plan.dq]
    dkdv = [n for _, _, n, _, _ in plan.dkdv]
    assert dq == sorted(dq, reverse=True)
    assert dkdv == sorted(dkdv, reverse=True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_slots_are_laid_out_as_the_kernels_read_them(shape, causal):
    """int32, the dq launch's slots of three then the dkdv launch's of
    five, as many of each as the C entry checks (ceil(Sq·G/64) and
    ceil(Skv/64))."""
    _, _, G, Sq, Skv, _ = shape
    plan = _plan(shape, causal)
    table = FA._slots(plan, torch.device("cpu"))
    assert table.dtype == torch.int32
    nq, nk = math.ceil(Sq * G / T), math.ceil(Skv / T)
    assert (len(plan.dq), len(plan.dkdv)) == (nq, nk)
    flat = table.tolist()
    assert flat[:3 * nq] == [n for s in plan.dq for n in s]
    assert flat[3 * nq:] == [n for s in plan.dkdv for n in s]


# -- the tensor route's roundings ---------------------------------------------

def _route_model(q, k, v, o, do, causal):
    """The tensor route's arithmetic in plain torch: bf16 operands, every
    product summed in fp32, the lse in the log2 domain, P = 2^(S·scale·
    log2e − lse), and P and dS rounded to bf16 before the products that
    take them (dV = Pᵀ·dO, dQ = dS·K, dK = dSᵀ·Q); the scale on the
    finished dQ and dK."""
    Sq, D = q.shape[-2:]
    Skv = k.shape[2]
    c = math.log2(math.e) / math.sqrt(D)
    qf, kf, vf, dof, of = (t.float() for t in (q, k, v, do, o))
    s = torch.einsum("bhgqd,bhsd->bhgqs", qf, kf)
    if causal:
        keep = (torch.arange(Skv)[None, :] <= torch.arange(Sq)[:, None])
        s = torch.where(keep, s, -1e30)
    m = s.amax(-1, keepdim=True)
    lse = m * c + torch.log2(torch.exp2(s * c - m * c).sum(-1, keepdim=True))
    p = torch.exp2(s * c - lse)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhgqd,bhsd->bhgqs", dof, vf) - delta)
    p16, ds16 = p.to(BF).float(), ds.to(BF).float()
    scale = 1 / math.sqrt(D)
    dq = torch.einsum("bhgqs,bhsd->bhgqd", ds16, kf) * scale
    dk = torch.einsum("bhgqs,bhgqd->bhsd", ds16, qf) * scale
    dv = torch.einsum("bhgqs,bhgqd->bhsd", p16, dof)
    return dq.to(BF), dk.to(BF), dv.to(BF)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 8, 4, 512, 512, 64),    # llama3.2-1b
                                   (1, 8, 2, 512, 512, 64),    # its student
                                   (1, 2, 3, 100, 160, 128),
                                   (1, 1, 8, 128, 128, 128),   # qwen2-vl's G
                                   (1, 2, 1, 64, 1500, 64)])   # whisper cross
def test_rounding_p_and_ds_to_bf16_stays_inside_the_bf16_bound(shape,
                                                               causal):
    B, KV, G, Sq, Skv, D = shape
    rng = np.random.default_rng(Sq + Skv + G)
    q, do = (torch.from_numpy(rng.standard_normal((B, KV, G, Sq, D))
                              .astype(np.float32)).to(BF) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, KV, Skv, D))
                             .astype(np.float32)).to(BF) for _ in range(2))
    o = FA.flash_attention_ref(q, k, v, causal=causal)
    want = FA.flash_attention_bwd_ref(q, k, v, o, do, causal)
    got = _route_model(q, k, v, o, do, causal)
    worst = 0.0
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a.float(), b.float(), **BF16_TOL)
        worst = max(worst, float((a.float() - b.float()).abs().max()))
    assert worst > 0        # the model does round: it is not the plain version
