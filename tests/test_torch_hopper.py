"""The port's CUDA kernels on the card, held to their plain PyTorch versions.

Every test here carries the ``hopper`` marker and skips unless a CUDA
device of capability (9, 0) is present. The file imports neither JAX nor
the JAX package, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m hopper tests/test_torch_hopper.py

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.assignment import StudentArch  # noqa: E402
from repro_torch.core.grouping import Device  # noqa: E402
from repro_torch.core.plan_ir import (PlanIR, device_matrix,  # noqa: E402
                                      eq1a_latency, student_matrix)
from repro_torch.core.simulator import FailureModel  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.runtime.engine import build_demo_server  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
pytestmark = pytest.mark.hopper


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs a Hopper (sm_90) device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(K, B, Dk, C, mask, int8, dev, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, (K, B, Dk)).astype(np.float32)
    b = rng.normal(size=C).astype(np.float32)
    if int8:
        w = rng.integers(-127, 128, (K, Dk, C)).astype(np.int8)
        s = (rng.uniform(0.5, 1.5, K) / (127 * np.sqrt(K * Dk))
             ).astype(np.float32)
    else:
        w = (rng.normal(size=(K, Dk, C)) / np.sqrt(K * Dk)).astype(np.float32)
        s = None
    t = [torch.from_numpy(a).to(dev)
         for a in (p, w, b, np.asarray(mask, np.int32))]
    return t + [None if s is None else torch.from_numpy(s).to(dev)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("K,B,Dk,C", [(8, 256, 32, 10), (6, 7, 43, 10),
                                      (8, 1000, 640, 100), (6, 1, 43, 100),
                                      (8, 1, 32, 10), (4, 256, 64, 10)])
@pytest.mark.parametrize("mask", ["ones", "mixed", "zeros"])
def test_kernel_matches_plain_version(hopper, int8, K, B, Dk, C, mask):
    m = {"ones": np.ones(K), "mixed": np.arange(K) % 3 != 1,
         "zeros": np.zeros(K)}[mask]
    args = _operands(K, B, Dk, C, m, int8, hopper, seed=B)
    before = ops.quorum_aggregate.launches
    out = ops.quorum_aggregate(*args)
    torch.cuda.synchronize()
    assert ops.quorum_aggregate.launches == before + 1
    ref = ops.quorum_aggregate_ref(*args)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)


def test_empty_batch_launches_nothing(hopper):
    before = ops.quorum_aggregate.launches
    out = ops.quorum_aggregate(*_operands(4, 0, 8, 5, [1] * 4, False,
                                          hopper))
    assert out.shape == (0, 5)
    assert ops.quorum_aggregate.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take(hopper):
    p, w, b, m, _ = _operands(2, 3, 4, 5, [1, 1], False, hopper)
    with pytest.raises(TypeError, match="int32"):
        ops.quorum_aggregate(p, w, b, m.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        ops.quorum_aggregate(p.transpose(1, 2).contiguous().transpose(1, 2),
                             w, b, m)
    with pytest.raises(ValueError, match="one device"):
        ops.quorum_aggregate(p, w.cpu(), b, m)


def _merge_views(p):
    """(name, view) pairs holding ``p``'s values: the output-coded path's
    transposed (B, K, Dk) stack, a base 4 bytes past 16 and a row stride
    that is not a multiple of 4 elements."""
    K, B, Dk = p.shape
    stack = p.transpose(0, 1).contiguous().transpose(0, 1)
    off = torch.empty(p.numel() + 1, device=p.device)[1:].view(K, B, Dk)
    off.copy_(p)
    wide = torch.empty((K, B, Dk + 1), device=p.device)[..., :Dk]
    wide.copy_(p)
    return [("transposed", stack), ("base+4", off), ("row stride", wide)]


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("K,B,Dk,C", [(8, 256, 32, 10), (6, 7, 43, 10),
                                      (4, 256, 64, 10), (8, 1, 32, 10),
                                      (8, 33, 640, 100)])
def test_quorum_aggregate_views_same_bits(hopper, int8, K, B, Dk, C):
    """Portions as views with unit stride along Dk are read in place, one
    launch each, with the contiguous call's bits."""
    args = _operands(K, B, Dk, C, np.arange(K) % 3 != 1, int8, hopper)
    base = ops.quorum_aggregate(*args)
    for name, view in _merge_views(args[0]):
        before = ops.quorum_aggregate.launches
        out = ops.quorum_aggregate(view, *args[1:])
        assert ops.quorum_aggregate.launches == before + 1
        assert _same_bits(out, base), name


def _toy_ir(M=8):
    devs = [Device("a", 1e7, 2e6, 500, 0.3), Device("b", 2e7, 2e6, 500, 0.3),
            Device("c", 1e7, 2e6, 500, 0.3), Device("d", 3e7, 2e6, 500, 0.3)]
    names, dcaps = device_matrix(devs)
    snames, scaps = student_matrix([StudentArch("s", 5e6, 0.6e6, 64, 0.15e6)])
    member = np.array([[1, 1, 0, 0], [0, 0, 1, 1]], bool)
    part = np.zeros((2, M), bool)
    part[0, :3] = True
    part[1, 3:] = True
    return PlanIR(names, dcaps, snames, scaps, member, part,
                  np.zeros(2, np.int64), np.arange(2, dtype=np.int64),
                  eq1a_latency(scaps, dcaps), np.zeros((M, M)), 1.0, 0.5)


@pytest.mark.parametrize("fastpath", [None, False], ids=["fused", "legacy"])
@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_demo_server_on_the_card_matches_the_cpu(hopper, fastpath, quantize):
    """One serve_batch = one kernel launch, and the card's logits match the
    same server on the CPU; quorum fields are equal."""
    build = dict(feat=8, hidden=16, n_classes=3, seed=0, fastpath=fastpath,
                 quantize=quantize,
                 failure=FailureModel(crash_prob=0.3, outages=True))
    gpu = build_demo_server(_toy_ir(), device=hopper, **build)
    cpu = build_demo_server(_toy_ir(), device="cpu", **build)
    rng = np.random.default_rng(1)
    xs = [rng.normal(size=(r, 8)).astype(np.float32) for r in (3, 5, 1)]
    for trial in range(4):
        before = ops.quorum_aggregate.launches
        rg = gpu.serve_batch(xs, rng=np.random.default_rng(trial))
        assert ops.quorum_aggregate.launches == before + 1
        rc = cpu.serve_batch(xs, rng=np.random.default_rng(trial))
        for a, b in zip(rg, rc):
            assert (a.arrived == b.arrived).all() and a.latency == b.latency
            np.testing.assert_allclose(a.block_until_ready().logits,
                                       b.logits, **TOL)


# -- coded_decode ------------------------------------------------------------------

def _cd_operands(B, R, K, F, mask, int8, dev, seed=0):
    rng = np.random.default_rng(seed)
    if int8:
        sh = rng.integers(-127, 128, (B, R, F)).astype(np.int8)
        s = (rng.uniform(0.5, 1.5, R) / 127).astype(np.float32)
    else:
        sh = rng.standard_normal((B, R, F)).astype(np.float32)
        s = None
    dec = rng.standard_normal((B, K, R)).astype(np.float32)
    m = {"ones": np.ones((B, R)), "zeros": np.zeros((B, R)),
         "mixed": rng.random((B, R)) > 0.3}[mask].astype(np.int32)
    t = [torch.from_numpy(a).to(dev) for a in (sh, dec, m)]
    return t + [None if s is None else torch.from_numpy(s).to(dev)]


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("B,R,K,F", [(256, 6, 4, 64), (7, 8, 5, 52),
                                     (1, 5, 3, 43), (1000, 12, 8, 640),
                                     (3, 20, 18, 5),
                                     # the compile-time R bound (16) and past
                                     (9, 16, 10, 64), (9, 17, 10, 64),
                                     (5, 33, 12, 48)])
@pytest.mark.parametrize("mask", ["ones", "mixed", "zeros"])
def test_coded_decode_matches_plain_version(hopper, int8, B, R, K, F, mask):
    args = _cd_operands(B, R, K, F, mask, int8, hopper, seed=B)
    before = ops.coded_decode.launches
    out = ops.coded_decode(*args)
    torch.cuda.synchronize()
    assert ops.coded_decode.launches == before + 1
    ref = ops.coded_decode_ref(*args)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("B,R,K,F", [(256, 6, 4, 64), (7, 8, 5, 52),
                                     (9, 17, 10, 64)])
def test_coded_decode_dead_shares_never_reach_the_sum(hopper, int8, B, R, K,
                                                      F):
    """NaN and Inf in the rows of dead shares: the output is finite and
    equals the plain version run on the same shares with those rows
    zeroed."""
    sh, dec, m, s = _cd_operands(B, R, K, F, "mixed", int8, hopper, seed=R)
    dead = (m == 0)[:, :, None].expand_as(sh)
    if int8:                       # int8 has no NaN: the largest magnitudes
        garbage = torch.full_like(sh, -128)
    else:
        garbage = torch.full_like(sh, float("nan"))
        garbage[..., ::2] = float("inf")
    out = ops.coded_decode(torch.where(dead, garbage, sh), dec, m, s)
    ref = ops.coded_decode_ref(torch.where(dead, torch.zeros_like(sh), sh),
                               dec, m, s)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("B,R,K,F", [(256, 6, 4, 64), (33, 12, 8, 640),
                                     (9, 17, 10, 64)])
def test_coded_decode_share_views_same_bits(hopper, int8, B, R, K, F):
    """Shares as the recovery path passes them (an (R, B, F) stack
    transposed: the vector route in place) and as views the scalar route
    takes (a base one element off; a row stride of F + 1) give the bits of
    the contiguous call."""
    sh, dec, m, s = _cd_operands(B, R, K, F, "mixed", int8, hopper, seed=F)
    base = ops.coded_decode(sh, dec, m, s)
    stack = sh.transpose(0, 1).contiguous()
    off = torch.empty(sh.numel() + 1, dtype=sh.dtype, device=hopper)
    off[1:].copy_(sh.reshape(-1))
    wide = torch.zeros((B, R, F + 1), dtype=sh.dtype, device=hopper)
    wide[..., :F] = sh
    views = {"stack": stack.transpose(0, 1),
             "base": off[1:].view(B, R, F), "stride": wide[..., :F]}
    for name, v in views.items():
        assert _same_bits(ops.coded_decode(v, dec, m, s), base), name


def test_coded_decode_empty_batch_launches_nothing(hopper):
    before = ops.coded_decode.launches
    out = ops.coded_decode(*_cd_operands(0, 6, 4, 64, "ones", False, hopper))
    assert out.shape == (0, 4, 64)
    assert ops.coded_decode.launches == before


def test_coded_decode_rejects_what_the_kernel_does_not_take(hopper):
    sh, dec, m, _ = _cd_operands(3, 6, 4, 8, "ones", False, hopper)
    with pytest.raises(ValueError, match="scales"):
        ops.coded_decode(sh.to(torch.int8), dec, m)
    with pytest.raises(TypeError, match="int32"):
        ops.coded_decode(sh, dec, m.to(torch.int64))
    with pytest.raises(ValueError, match="unit stride"):
        ops.coded_decode(sh.transpose(1, 2).contiguous().transpose(1, 2),
                         dec, m)
    with pytest.raises(ValueError, match="contiguous"):
        ops.coded_decode(sh, dec.transpose(0, 1).contiguous().transpose(0, 1),
                         m)
    with pytest.raises(ValueError, match="one device"):
        ops.coded_decode(sh, dec.cpu(), m)


def _coded_toy_ir():
    """tests/test_coding.py's fixture: four pair-replicated slots and two
    spares, coded (6,4) by the port's own planner pass."""
    from repro_torch.coding.planner import select_redundancy
    devs = [Device(f"d{i}", (1 + i % 3) * 1e7, 2e6, 500, 0.25)
            for i in range(10)]
    names, dcaps = device_matrix(devs)
    snames, scaps = student_matrix([StudentArch("s", 5e6, 0.6e6, 64, 0.15e6)])
    member = np.zeros((4, 10), bool)
    part = np.zeros((4, 8), bool)
    for k in range(4):
        member[k, 2 * k:2 * k + 2] = True
        part[k, 2 * k:2 * k + 2] = True
    ir = PlanIR(names, dcaps, snames, scaps, member, part,
                np.zeros(4, np.int64), np.arange(4, dtype=np.int64),
                eq1a_latency(scaps, dcaps), np.zeros((8, 8)), 1.0, 0.5)
    return select_redundancy(ir, code_k=4, parity=2)


@pytest.mark.parametrize("fastpath", [None, False], ids=["fused", "legacy"])
def test_coded_demo_server_on_the_card_matches_the_cpu(hopper, fastpath):
    """A systematic device down: each serve_batch decodes once and merges
    once on the card, and matches the same server on the CPU."""
    ir = _coded_toy_ir()
    build = dict(feat=8, hidden=16, n_classes=3, seed=0, fastpath=fastpath,
                 failure=FailureModel(forced_failures=[
                     ir.device_names[int(np.flatnonzero(ir.member[0])[0])]],
                     outages=False))
    gpu = build_demo_server(ir, device=hopper, **build)
    cpu = build_demo_server(ir, device="cpu", **build)
    rng = np.random.default_rng(1)
    xs = [rng.normal(size=(r, 8)).astype(np.float32) for r in (3, 5)]
    qa, cd = ops.quorum_aggregate.launches, ops.coded_decode.launches
    rg = gpu.serve_batch(xs, rng=np.random.default_rng(0))
    assert ops.quorum_aggregate.launches == qa + 1
    assert ops.coded_decode.launches == cd + 1
    rc = cpu.serve_batch(xs, rng=np.random.default_rng(0))
    for a, b in zip(rg, rc):
        assert a.arrived.all() and (a.arrived == b.arrived).all()
        np.testing.assert_array_equal(a.share_times, b.share_times)
        np.testing.assert_allclose(a.block_until_ready().logits, b.logits,
                                   **TOL)


# -- LM kernels: rmsnorm, flash_attention, decode_attention -------------------

LM_TOL = {torch.float32: dict(rtol=3e-5, atol=3e-5),
          torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
LM_DTYPES = [torch.float32, torch.bfloat16]


def _close(out, ref, dtype):
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **LM_TOL[dtype])


@pytest.mark.parametrize("dtype", LM_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,D", [(1, 128), (7, 2048), (2048, 2048),
                                    (4097, 6144), (5, 3072),
                                    # the paths' widths, and decode's 4 rows
                                    (2048, 768), (2048, 1536), (2048, 4096),
                                    (2048, 8192), (4, 2048),
                                    # ragged D: the scalar route
                                    (33, 100), (7, 1000), (2048, 2047)])
@pytest.mark.parametrize("scale_dtype", ["same", "fp32"])
def test_rmsnorm_matches_plain_version(hopper, dtype, rows, D, scale_dtype):
    g = torch.Generator(device=hopper).manual_seed(rows + D)
    x = torch.randn((rows, D), generator=g, device=hopper).to(dtype)
    s = torch.randn((D,), generator=g, device=hopper)
    s = s.to(dtype) if scale_dtype == "same" else s
    before = ops.rmsnorm.launches
    out = ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert ops.rmsnorm.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    _close(out, ops.rmsnorm_ref(x, s), dtype)


@pytest.mark.parametrize("dtype", LM_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,D", [(4, 2048), (2048, 768), (9, 8192)])
def test_rmsnorm_unaligned_base_matches_plain_version(hopper, dtype, rows,
                                                      D):
    """A contiguous view whose base is one element off 16 bytes takes the
    scalar route; so does an unaligned scale."""
    g = torch.Generator(device=hopper).manual_seed(D)
    buf = torch.randn((rows * D + 1,), generator=g, device=hopper).to(dtype)
    x = buf[1:].view(rows, D)
    sbuf = torch.randn((D + 1,), generator=g, device=hopper).to(dtype)
    for s in (sbuf[:D], sbuf[1:]):
        out = ops.rmsnorm(x, s)
        torch.cuda.synchronize()
        _close(out, ops.rmsnorm_ref(x, s), dtype)
    _close(ops.rmsnorm(x.clone(), sbuf[:D].clone()),
           ops.rmsnorm_ref(x, sbuf[:D]), dtype)


def _flash_operands(B, KV, G, S, D, dtype, strided, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    qm = torch.randn((B, S, KV, G, D), generator=g, device=dev).to(dtype)
    km = torch.randn((B, S, KV, D), generator=g, device=dev).to(dtype)
    vm = torch.randn((B, S, KV, D), generator=g, device=dev).to(dtype)
    q, k, v = qm.permute(0, 2, 3, 1, 4), km.permute(0, 2, 1, 3), \
        vm.permute(0, 2, 1, 3)
    if not strided:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v


@pytest.mark.parametrize("dtype", LM_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,KV,G,S,D", [(1, 1, 1, 128, 64), (2, 2, 4, 256, 64),
                                        (1, 4, 2, 128, 128), (1, 1, 4, 7, 64),
                                        (2, 8, 4, 509, 64), (1, 2, 3, 33, 96),
                                        (1, 1, 48, 40, 128), (1, 2, 2, 5, 32),
                                        # the tensor-core kernel's tile edges:
                                        # 64 keys a tile, 128 rows a block
                                        (1, 2, 1, 63, 64), (1, 1, 4, 64, 128),
                                        (2, 1, 2, 65, 64), (1, 2, 1, 127, 128),
                                        (1, 1, 1, 129, 64),
                                        # grok's G = 6, MQA at G = 48 past
                                        # one kv tile, and more than one
                                        # wave of blocks
                                        (1, 2, 6, 100, 128),
                                        (1, 1, 48, 130, 128),
                                        (8, 32, 1, 256, 64),
                                        # D 128 past the 3-stage K/V ring
                                        # (5 and 8 kv tiles), the latter
                                        # moonshot's serving shape
                                        (1, 2, 1, 300, 128),
                                        (4, 16, 1, 512, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("strided", [False, True], ids=["contig", "strided"])
def test_flash_attention_matches_plain_version(hopper, dtype, B, KV, G, S, D,
                                               causal, strided):
    q, k, v = _flash_operands(B, KV, G, S, D, dtype, strided, hopper, seed=S)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    _close(out, ops.flash_attention_ref(q, k, v, causal=causal), dtype)


def _decode_operands(B, KV, G, S, D, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, 1, KV * G, D), generator=g, device=dev).to(dtype)
    kc = torch.randn((B, S, KV, D), generator=g, device=dev).to(dtype)
    vc = torch.randn((B, S, KV, D), generator=g, device=dev).to(dtype)
    return (q.view(B, KV, G, D), kc.permute(0, 2, 1, 3),
            vc.permute(0, 2, 1, 3))


@pytest.mark.parametrize("dtype", LM_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,KV,G,D", [(4, 8, 4, 64), (2, 2, 4, 64),
                                      (1, 1, 8, 128), (1, 1, 48, 128),
                                      (2, 4, 1, 96), (1, 2, 2, 32)])
@pytest.mark.parametrize("S,length", [(1, 1), (256, 1), (256, 100),
                                      (256, 256), (544, 528), (544, 544),
                                      # fewer positions than splits
                                      (544, 2), (544, 3)])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
def test_decode_attention_matches_plain_version(hopper, dtype, B, KV, G, D, S,
                                                length, as_tensor):
    q, kc, vc = _decode_operands(B, KV, G, S, D, dtype, hopper, seed=S + G)
    n = (torch.tensor([length], dtype=torch.int32, device=hopper)
         if as_tensor else length)
    before = ops.decode_attention.launches
    out = ops.decode_attention(q, kc, vc, n)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    _close(out, ops.decode_attention_ref(q, kc, vc, length), dtype)


def test_decode_attention_never_reads_past_length(hopper):
    """NaN rows past ``length`` do not reach the output."""
    q, kc, vc = _decode_operands(1, 2, 4, 64, 64, torch.float32, hopper)
    kc[:, :, 40:] = float("nan")
    vc[:, :, 40:] = float("nan")
    out = ops.decode_attention(q, kc, vc, 40)
    assert torch.isfinite(out).all()
    _close(out, ops.decode_attention_ref(q, kc[:, :, :40], vc[:, :, :40], 40),
           torch.float32)


def test_decode_attention_splits_reset_their_counters(hopper):
    """Consecutive calls of other lengths on one set of ticket counters are
    each right: the last block of every group leaves its counter at 0. The
    serving shape splits into at least one block per SM."""
    from repro_torch.kernels import decode_attention as da
    B, KV, G, S, D = 4, 8, 4, 544, 64
    sms = torch.cuda.get_device_properties(hopper).multi_processor_count
    assert da.split_plan(B, KV, G, S, sms) * B * KV >= sms
    q, kc, vc = _decode_operands(B, KV, G, S, D, torch.bfloat16, hopper)
    for length in (528, 3, 544, 1, 100):
        out = ops.decode_attention(q, kc, vc, length)
        torch.cuda.synchronize()
        _close(out, ops.decode_attention_ref(q, kc, vc, length),
               torch.bfloat16)
        nsplit, _, _, (_, counters) = da._launch_plan(q.device.index, B, KV,
                                                      G, S, D)
        assert nsplit > 1 and int(counters.abs().sum()) == 0


@pytest.mark.parametrize("dtype", LM_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,KV,G,D,S", [(4, 4, 4, 64, 544),
                                        (4, 1, 48, 128, 272)],
                         ids=["llama-rank", "granite-block"])
@pytest.mark.parametrize("length", [0, 1, 137, 256, 272])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
def test_decode_attention_lse_matches_plain_version(hopper, dtype, B, KV, G,
                                                    D, S, length, as_tensor):
    """The log-sum-exp output at the tensor-parallel ranks' shapes
    (llama3.2-1b's 4 of 8 kv heads at model 2; granite-20b's 48 heads over
    its rank's block of 272 positions) against the plain version's: o and
    lse close, o = 0 and lse = −inf at length 0, a rerun bit-equal, and o
    without the lse the same bits as with it."""
    q, kc, vc = _decode_operands(B, KV, G, S, D, dtype, hopper, seed=length)
    n = (torch.tensor([length], dtype=torch.int32, device=hopper)
         if as_tensor else length)
    before = ops.decode_attention.launches
    o, lse = ops.decode_attention(q, kc, vc, n, return_lse=True)
    again = ops.decode_attention(q, kc, vc, n, return_lse=True)
    alone = ops.decode_attention(q, kc, vc, n)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 3
    assert lse.shape == (B, KV, G) and lse.dtype == torch.float32
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    assert torch.equal(o, alone)
    ro, rlse = ops.decode_attention_ref(q, kc, vc, length, return_lse=True)
    if length == 0:
        assert not o.any() and torch.isneginf(lse).all()
        assert not ro.any() and torch.isneginf(rlse).all()
        return
    _close(o, ro, dtype)
    np.testing.assert_allclose(lse.cpu().numpy(), rlse.cpu().numpy(),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", LM_DTYPES, ids=["fp32", "bf16"])
def test_attention_kernels_copy_views_they_cannot_address(hopper, dtype):
    """Views whose strides are odd (not 16-byte aligned) reach the kernels
    as contiguous copies and give the plain versions' answers."""
    g = torch.Generator(device=hopper).manual_seed(5)
    B, KV, G, S, D = 2, 2, 4, 70, 64
    wide = torch.randn((B, S, KV, D + 1), generator=g, device=hopper)
    k = wide.to(dtype)[..., :D].permute(0, 2, 1, 3)
    v = (wide.to(dtype)[..., 1:] * 0.5).permute(0, 2, 1, 3)
    q = torch.randn((B, S, KV, G, D + 1), generator=g, device=hopper).to(
        dtype)[..., :D].permute(0, 2, 3, 1, 4)
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    _close(out, ops.flash_attention_ref(q, k, v, causal=True), dtype)
    qd = q[:, :, :, 0].contiguous()
    out = ops.decode_attention(qd, k, v, 61)
    torch.cuda.synchronize()
    _close(out, ops.decode_attention_ref(qd, k, v, 61), dtype)


def test_lm_kernels_launch_nothing_for_no_rows(hopper):
    counts = (ops.rmsnorm.launches, ops.flash_attention.launches,
              ops.decode_attention.launches)
    assert ops.rmsnorm(torch.zeros((0, 64), device=hopper),
                       torch.ones(64, device=hopper)).shape == (0, 64)
    q, k, v = _flash_operands(0, 2, 2, 8, 64, torch.float32, False, hopper)
    assert ops.flash_attention(q, k, v).shape == (0, 2, 2, 8, 64)
    q, kc, vc = _decode_operands(0, 2, 2, 8, 64, torch.float32, hopper)
    assert ops.decode_attention(q, kc, vc, 3).shape == (0, 2, 2, 64)
    assert counts == (ops.rmsnorm.launches, ops.flash_attention.launches,
                      ops.decode_attention.launches)


def test_lm_wrappers_reject_what_the_kernels_do_not_take(hopper):
    x = torch.randn((4, 64), device=hopper)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rmsnorm(x.t(), torch.ones(4, device=hopper))
    with pytest.raises(ValueError, match="one device"):
        ops.rmsnorm(x, torch.ones(64))
    q, k, v = _flash_operands(1, 2, 2, 8, 48, torch.float32, False, hopper)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, k, v)
    q, k, v = _flash_operands(1, 2, 2, 8, 64, torch.float32, False, hopper)
    with pytest.raises(ValueError, match="unit stride"):
        ops.flash_attention(q.transpose(-1, -2).contiguous().transpose(-1, -2)
                            [..., :8, :], k[..., :8, :], v[..., :8, :])
    q, kc, vc = _decode_operands(1, 2, 2, 8, 64, torch.float32, hopper)
    with pytest.raises(TypeError, match="int32"):
        ops.decode_attention(q, kc, vc, torch.tensor([3], device=hopper))


def test_dense_lm_on_the_card_matches_the_cpu(hopper):
    """The tiny llama3.2-1b on the card and on the CPU from the same
    weights: greedy tokens equal, logits within 1e-4, and the kernels
    launched 2L+1 / L / L times per call."""
    from repro_torch.configs.archs import tiny_version
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.models import api
    from repro_torch.tree import tree_to
    cfg = tiny_version(get_config("llama3.2-1b"))
    params = api.init(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    cpu = greedy_decode(params, cfg, toks, 6, keep_logits=True)
    counts = (ops.rmsnorm.launches, ops.flash_attention.launches,
              ops.decode_attention.launches)
    gpu = greedy_decode(tree_to(params, hopper), cfg, toks.to(hopper), 6,
                        keep_logits=True)
    L = cfg.n_layers
    assert (ops.rmsnorm.launches - counts[0], ops.flash_attention.launches
            - counts[1], ops.decode_attention.launches - counts[2]) == \
        ((2 * L + 1) * 6, L, L * 5)
    np.testing.assert_array_equal(gpu.tokens, cpu.tokens)
    for a, b in zip(gpu.logits, cpu.logits):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


# -- SSM and MoE kernels: ssd_scan, topk_gating ---------------------------------

# the JAX package's own bound for its ssd_scan kernel in fp32
# (tests/test_kernels.py::test_ssd_scan): exp(cum_t - cum_s) of fp32
# cumulative sums that reach |cum| ~ 10^3 in a 256-step chunk carries ~1e-4
# of rounding that depends on the order of summation
SSD_TOL = dict(rtol=2e-3, atol=2e-3)


def _ssd_operands(Bsz, H, L, P, N, dtype, strided, dev, seed=0):
    """Scan operands as the model passes them (x a view of (B, L, H, P),
    B/C of (B, L, N) expanded over heads with stride 0) or as contiguous
    (B·H)-row copies. B and C are scaled to unit-variance scores C·B, as a
    normalised model's are: with unit-variance B and C the fp32 sums of
    N-term products lose more than 3e-5 relative even in the plain version
    (against fp64), so the kernel could not be held to the fp32 bound."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((Bsz, L, H, P), generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((Bsz, L, H), generator=g, device=dev))
    A = -torch.exp(torch.randn((H,), generator=g, device=dev))
    Bm, Cm = (torch.randn((Bsz, L, N), generator=g, device=dev)
              .div(N ** 0.5).to(dtype) for _ in "BC")
    views = (x.permute(0, 2, 1, 3), dt.permute(0, 2, 1), A.expand(Bsz, H),
             Bm[:, None].expand(Bsz, H, L, N), Cm[:, None].expand(Bsz, H, L, N))
    if strided:
        return views
    return tuple(t.reshape(Bsz * H, *t.shape[2:]).contiguous() for t in views)


@pytest.mark.parametrize("dtype", LM_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("P,N,Q", [(64, 128, 256), (64, 16, 256), (32, 16, 32),
                                   (32, 8, 32)])
@pytest.mark.parametrize("length", ["chunks", "4chunks", "16chunks", "short"])
@pytest.mark.parametrize("strided", [False, True], ids=["contig", "strided"])
def test_ssd_scan_matches_plain_version(hopper, dtype, P, N, Q, length,
                                        strided):
    """L a multiple of Q (2, 4 and 16 chunks: states passed across 1, 3
    and 15 boundaries), and L < chunk (one ragged chunk of Q = L rows); y
    in x's dtype and fp32, and the final state. bf16 takes the tensor-core
    kernel where P and N are multiples of 16 and the CUDA-core one at N 8;
    fp32 always the CUDA-core one."""
    assert ss.mma_takes(P, N) == (N % 16 == 0)
    L = {"chunks": 2 * Q, "4chunks": 4 * Q, "16chunks": 16 * Q,
         "short": Q // 2 + 4}[length]
    args = _ssd_operands(2, 3, L, P, N, dtype, strided, hopper, seed=P + N + L)
    before = ops.ssd_scan.launches
    y, h = ops.ssd_scan(*args, chunk=Q, return_state=True)
    y32 = ops.ssd_scan(*args, chunk=Q, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 2
    ry, rh = ops.ssd_scan_ref(*args, chunk=Q, return_state=True)
    assert y.dtype == dtype and y32.dtype == h.dtype == torch.float32
    tol = SSD_TOL if dtype == torch.float32 else LM_TOL[dtype]
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               ry.float().cpu().numpy(), **tol)
    # fp32 outputs of the same (rounded) inputs: the fp32 bound either way
    for out, ref in ((y32, ops.ssd_scan_ref(*args, chunk=Q,
                                            out_dtype=torch.float32)),
                     (h, rh)):
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                   **SSD_TOL)


# SMs the plan is told the card has, so that it picks each head group: with
# none every grid has blocks to spare, with a million none does
GROUP_SMS = {1: 10 ** 6, 4: 0}


@pytest.mark.parametrize("head_group", sorted(GROUP_SMS))
@pytest.mark.parametrize("P,N,Q,L", [(64, 128, 256, 512), (64, 16, 256, 1024),
                                     (32, 16, 32, 20), (16, 32, 48, 96),
                                     (48, 16, 64, 192)])
@pytest.mark.parametrize("out", ["bf16", "fp32"])
def test_ssd_scan_head_groups_match_plain_version(hopper, monkeypatch,
                                                  head_group, P, N, Q, L,
                                                  out):
    """The tensor-core kernel with each head group its plan takes over the
    model's views (four heads sharing B and C), P and N multiples of 16 at
    and off the serving shapes, ragged chunks (Q 48, 64-row tiles) and L <
    chunk."""
    monkeypatch.setattr(ss, "num_sms", lambda index: GROUP_SMS[head_group])
    assert ss.mma_plan(2, 4, L, P, N, min(Q, L), True,
                       GROUP_SMS[head_group]).head_group == head_group
    args = _ssd_operands(2, 4, L, P, N, torch.bfloat16, True, hopper,
                         seed=P + N + L + head_group)
    od = torch.bfloat16 if out == "bf16" else torch.float32
    before = ops.ssd_scan.launches
    y, h = ops.ssd_scan(*args, chunk=Q, return_state=True, out_dtype=od)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    ry, rh = ops.ssd_scan_ref(*args, chunk=Q, return_state=True,
                              out_dtype=torch.float32)
    tol = LM_TOL[torch.bfloat16] if out == "bf16" else SSD_TOL
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               ry.to(od).float().cpu().numpy(), **tol)
    np.testing.assert_allclose(h.cpu().numpy(), rh.cpu().numpy(), **SSD_TOL)


def test_ssd_scan_plans_after_copying_views_it_cannot_address(hopper,
                                                              monkeypatch):
    """B and C whose base is not 16-byte aligned are copied before the
    plan is made, so the copies (which no longer share one row over the
    heads) run in groups of 1 where the views would have run in fours."""
    monkeypatch.setattr(ss, "num_sms", lambda index: 0)
    assert ss.mma_plan(2, 4, 128, 32, 16, 32, True, 0).head_group == 4
    x, dt, A, Bm, Cm = _ssd_operands(2, 4, 128, 32, 16, torch.bfloat16,
                                     True, hopper, seed=11)
    flat = torch.empty(Bm[:, 0].numel() + 1, dtype=Bm.dtype, device=hopper)
    odd = flat[1:].view(Bm[:, 0].shape)
    odd.copy_(Bm[:, 0])
    Bo = odd[:, None].expand_as(Bm)
    assert Bo.data_ptr() % 16 and Bo.stride(1) == 0
    y, h = ops.ssd_scan(x, dt, A, Bo, Cm, chunk=32, return_state=True,
                        out_dtype=torch.float32)
    ry, rh = ops.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=32, return_state=True,
                              out_dtype=torch.float32)
    np.testing.assert_allclose(y.cpu().numpy(), ry.cpu().numpy(), **SSD_TOL)
    np.testing.assert_allclose(h.cpu().numpy(), rh.cpu().numpy(), **SSD_TOL)


def test_ssd_scan_leaves_its_counters_zero(hopper):
    """Launch (a)'s last block of each row resets that row's ticket
    counter: after calls of other lengths, batch sizes and outputs on the
    same counters, all are 0 and each call matches its plain version."""
    for Bsz, L, state in ((2, 512, True), (2, 1024, False), (2, 20, False),
                          (2, 256, True), (1, 512, False)):
        args = _ssd_operands(Bsz, 3, L, 64, 16, torch.bfloat16, True, hopper,
                             seed=L + Bsz)
        y = ops.ssd_scan(*args, chunk=256, return_state=state,
                         out_dtype=torch.float32)
        y = y[0] if state else y
        ry = ops.ssd_scan_ref(*args, chunk=256, out_dtype=torch.float32)
        np.testing.assert_allclose(y.cpu().numpy(), ry.cpu().numpy(),
                                   **SSD_TOL)
        counters = ss._counters(torch.cuda.current_device(), Bsz * 3)
        assert int(counters.abs().sum()) == 0


@pytest.mark.parametrize("N", [1, 4, 77, 2048, 4096])
@pytest.mark.parametrize("E,k", [(4, 1), (4, 2), (16, 2), (16, 6), (64, 6),
                                 (64, 8), (8, 8), (8, 2), (256, 6),
                                 (256, 256), (6, 6), (100, 6), (3, 2)])
def test_topk_gating_matches_plain_version(hopper, N, E, k):
    g = torch.Generator(device=hopper).manual_seed(N + E + k)
    logits = 3 * torch.randn((N, E), generator=g, device=hopper)
    before = ops.topk_gating.launches
    w, i = ops.topk_gating(logits, k)
    torch.cuda.synchronize()
    assert ops.topk_gating.launches == before + 1
    rw, ri = ops.topk_gating_ref(logits, k)
    assert i.dtype == torch.int32 and w.dtype == torch.float32
    assert torch.equal(i, ri)
    np.testing.assert_allclose(w.cpu().numpy(), rw.cpu().numpy(), **TOL)


def test_topk_gating_ties_and_zero_rows(hopper):
    logits = torch.zeros((3, 8), device=hopper)
    logits[1, [2, 5]] = 1.0
    w, i = ops.topk_gating(logits, 4)
    assert i.tolist() == [[0, 1, 2, 3], [2, 5, 0, 1], [0, 1, 2, 3]]
    before = ops.topk_gating.launches
    w, i = ops.topk_gating(torch.zeros((0, 8), device=hopper), 2)
    assert w.shape == i.shape == (0, 2)
    assert ops.topk_gating.launches == before


@pytest.mark.parametrize("E,k", [(64, 6), (16, 2), (8, 2), (256, 8),
                                 (100, 5)])
def test_topk_gating_ties_across_lane_groups(hopper, E, k):
    """Equal maxima planted in different lanes, in one lane's access and
    across groups of accesses go to the lowest index, as in the plain
    version; an unaligned base (the scalar route) routes the same."""
    N = 6
    logits = torch.randn((N, E), generator=torch.Generator(
        device=hopper).manual_seed(E), device=hopper)
    logits[0] = 0
    logits[1, [E - 1, 0]] = 4.0
    logits[2, [1, 2, 3 % E]] = 4.0
    logits[3, [E // 2, E // 4, E - 2]] = 4.0
    logits[4] = -3.0
    logits[4, [E // 3, E - 1]] = 4.0
    logits[5, ::2] = 4.0
    rw, ri = ops.topk_gating_ref(logits, k)
    off = torch.empty(N * E + 1, device=hopper)[1:].view(N, E)
    off.copy_(logits)
    for x in (logits, off):
        w, i = ops.topk_gating(x, k)
        torch.cuda.synchronize()
        assert torch.equal(i, ri)
        np.testing.assert_allclose(w.cpu().numpy(), rw.cpu().numpy(), **TOL)


def test_ssm_moe_wrappers_reject_what_the_kernels_do_not_take(hopper):
    x, dt, A, Bm, Cm = _ssd_operands(1, 2, 64, 64, 16, torch.float32, False,
                                     hopper)
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_scan(x, dt.double(), A, Bm, Cm)
    with pytest.raises(TypeError, match="one dtype"):
        ops.ssd_scan(x, dt, A, Bm.to(torch.bfloat16), Cm)
    with pytest.raises(ValueError, match="unit stride"):
        ops.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                     Bm, Cm)
    with pytest.raises(ValueError, match="power of two"):
        ops.ssd_scan(x[..., :48], dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=48)
    with pytest.raises(ValueError, match="contiguous"):
        ops.topk_gating(torch.randn((8, 4), device=hopper).t(), 2)
    with pytest.raises(ValueError, match="E <= 256"):
        ops.topk_gating(torch.randn((2, 300), device=hopper), 2)


@pytest.mark.parametrize("arch,launches", [
    # per greedy_decode(P, gen=6): rmsnorm, flash, decode, ssd_scan, gating
    ("mamba2-130m", lambda L: ((2 * L + 1) * 6, 0, 0, L, 0)),
    ("moonshot-v1-16b-a3b", lambda L: ((2 * L + 1) * 6, L, 5 * L, 0, 6 * L)),
    ("jamba-v0.1-52b", lambda L: (24 * 6, 1, 5, 7, 4 * 6))])
def test_ssm_moe_hybrid_lm_on_the_card_match_the_cpu(hopper, arch, launches):
    """The tiny model on the card and on the CPU from the same weights:
    greedy tokens equal, logits within 1e-4, and each kernel launched as
    often as the model's layers call it."""
    from repro_torch.configs.archs import tiny_version
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.models import api
    from repro_torch.tree import tree_to
    names = ("rmsnorm", "flash_attention", "decode_attention", "ssd_scan",
             "topk_gating")
    cfg = tiny_version(get_config(arch))
    params = api.init(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    cpu = greedy_decode(params, cfg, toks, 6, keep_logits=True)
    counts = [getattr(ops, n).launches for n in names]
    gpu = greedy_decode(tree_to(params, hopper), cfg, toks.to(hopper), 6,
                        keep_logits=True)
    assert tuple(getattr(ops, n).launches - c for n, c in
                 zip(names, counts)) == launches(cfg.n_layers)
    np.testing.assert_array_equal(gpu.tokens, cpu.tokens)
    for a, b in zip(gpu.logits, cpu.logits):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


# -- the measured-cost-model and autotune slice: dequant_matmul, coded_matmul,
# -- and the tiles of the tunable kernels

def _dq_operands(B, D, N, per_channel, dev, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D)).astype(np.float32)
    q = rng.integers(-127, 128, (D, N)).astype(np.int8)
    s = (rng.uniform(0.01, 0.1, (N,)) if per_channel
         else np.asarray(rng.uniform(0.01, 0.1))).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x, q, s)]


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("B,D,N,bb,bn", [
    (1, 8, 5, None, None), (7, 16, 11, None, None), (130, 8, 300, None, None),
    (7, 16, 13, 4, 8), (33, 8, 257, 32, 64), (1, 8, 1, 128, 256),
    (250, 32, 100, 128, 256), (5, 8, 6, 0, 0), (5, 8, 6, -5, 4),
    (5, 8, 6, 4096, 4096)])
def test_dequant_matmul_matches_plain_version(hopper, per_channel, B, D, N,
                                              bb, bn):
    args = _dq_operands(B, D, N, per_channel, hopper, seed=B + N)
    before = ops.dequant_matmul.launches
    out = ops.dequant_matmul(*args, block_batch=bb, block_n=bn)
    torch.cuda.synchronize()
    assert ops.dequant_matmul.launches == before + 1
    ref = ops.dequant_matmul_ref(*args)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL)


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("B,D,N", [(64, 2048, 1024), (2048, 2048, 1024)])
def test_dequant_matmul_wide_reduction_within_fp32_rounding(hopper,
                                                           per_channel, B,
                                                           D, N):
    """At D = 2048 the partial sums reach |y| ~ 10^2, and the kernel (d
    ascending) and cuBLAS (its own order, split over D at small B) round
    differently by ~1e-3 near y = 0. Both are held to the fp64 product
    within a random-walk model of fp32 accumulation: 8 · 2^-24 · √D ·
    max|y| (a wrong sum is off by O(|y|))."""
    x, q, s = _dq_operands(B, D, N, per_channel, hopper, seed=D + B)
    out = ops.dequant_matmul(x, q, s)
    exact = x.double() @ (q.double() * s.double())
    tol = 8 * 2.0 ** -24 * D ** 0.5 * exact.abs().max().item()
    for y in (out, ops.dequant_matmul_ref(x, q, s)):
        err = (y.double() - exact).abs().max().item()
        assert err <= tol, (err, tol)


def _fp64_walk(x, q, s, y):
    """y's largest distance from the fp64 product, and the fp32 random-walk
    bound 8 · 2^-24 · √D · max|y| it must stay in."""
    exact = x.double() @ (q.double() * s.double())
    return ((y.double() - exact).abs().max().item(),
            8 * 2.0 ** -24 * x.shape[1] ** 0.5 * exact.abs().max().item())


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("B,D,N", [(100, 72, 144), (65, 96, 272),
                                   (7, 100, 48), (300, 2052, 272),
                                   (130, 2048, 1040)])
def test_dequant_matmul_tensor_route_within_fp32_rounding(hopper,
                                                         per_channel, B, D,
                                                         N):
    """The tensor route at ragged B and N (against the 64-row, 128-column
    block) and D off a multiple of 16 or 64 (a zero-padded k-tile): the
    kernel and the plain version each within the walk bound of the fp64
    product."""
    from repro_torch.kernels import dequant_matmul as DQ
    assert DQ.route(B, D, N) == "tensor"
    x, q, s = _dq_operands(B, D, N, per_channel, hopper, seed=B + D)
    before = ops.dequant_matmul.launches
    out = ops.dequant_matmul(x, q, s)
    torch.cuda.synchronize()
    assert ops.dequant_matmul.launches == before + 1
    for y in (out, ops.dequant_matmul_ref(x, q, s)):
        err, tol = _fp64_walk(x, q, s, y)
        assert err <= tol, (err, tol)


@pytest.mark.parametrize("B,D,N", [(128, 64, 256), (128, 128, 256),
                                   (9, 16, 13)])
def test_dequant_matmul_non_finite_rows(hopper, B, D, N):
    """inf and NaN in x give inf and NaN where the plain product has them
    (the tensor route's split never makes NaN of inf - inf); the other rows
    stay within the route's bound."""
    x, q, s = _dq_operands(B, D, N, True, hopper, seed=D)
    q[2, 0] = 0                                       # inf * 0 is NaN
    x[3, 5], x[7, 9], x[1, 2] = float("inf"), float("nan"), -float("inf")
    out = ops.dequant_matmul(x, q, s)
    ref = ops.dequant_matmul_ref(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(out.isnan(), ref.isnan())
    assert torch.equal(out.isinf(), ref.isinf())
    assert torch.equal(out[out.isinf()], ref[ref.isinf()])
    rows = [r for r in range(B) if r not in (1, 3, 7)]
    if D > 64:
        err, tol = _fp64_walk(x[rows], q, s, out[rows])
        assert err <= tol, (err, tol)
    else:
        np.testing.assert_allclose(out[rows].cpu().numpy(),
                                   ref[rows].cpu().numpy(), **TOL)


@pytest.mark.parametrize("B,D,N", [(64, 64, 512), (65, 96, 272)])
def test_dequant_matmul_copies_unaligned_bases(hopper, B, D, N):
    """Operands whose base is off 16 bytes (views into larger buffers) are
    copied for the 16-byte loads, and the result is the aligned call's."""
    x, q, s = _dq_operands(B, D, N, True, hopper, seed=3)
    xb = torch.empty(B * D + 1, device=hopper)[1:].view(B, D).copy_(x)
    qb = torch.empty(D * N + 3, dtype=torch.int8,
                     device=hopper)[3:].view(D, N).copy_(q)
    assert xb.data_ptr() % 16 and qb.data_ptr() % 16
    assert _same_bits(ops.dequant_matmul(xb, qb, s),
                      ops.dequant_matmul(x, q, s))


def test_dequant_matmul_empty_batch_launches_nothing(hopper):
    before = ops.dequant_matmul.launches
    out = ops.dequant_matmul(*_dq_operands(0, 4, 3, False, hopper))
    assert out.shape == (0, 3)
    assert ops.dequant_matmul.launches == before


@pytest.mark.parametrize("B,D,w,n", [(9, 6, 5, 5), (256, 64, 43, 5),
                                     (256, 1024, 200, 8), (1, 3, 1, 3),
                                     (130, 17, 70, 4), (64, 128, 32, 4),
                                     (256, 64, 22, 5), (1000, 64, 128, 3)])
def test_coded_matmul_matches_plain_version(hopper, B, D, w, n):
    rng = np.random.default_rng(B + w)
    x = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)
                         ).to(hopper)
    sh = torch.from_numpy((rng.standard_normal((n, D, w)) / np.sqrt(D)
                           ).astype(np.float32)).to(hopper)
    before = ops.coded_matmul.launches
    out = ops.coded_matmul(x, sh)
    torch.cuda.synchronize()
    assert ops.coded_matmul.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(),
                               ops.coded_matmul_ref(x, sh).cpu().numpy(),
                               **TOL)


def test_coded_matmul_copies_unaligned_bases(hopper):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)
                         ).to(hopper)
    sh = torch.from_numpy(rng.standard_normal((4, 128, 32)).astype(
        np.float32)).to(hopper)
    xb = torch.empty(x.numel() + 1, device=hopper)[1:].view(64, 128).copy_(x)
    assert xb.data_ptr() % 16
    assert _same_bits(ops.coded_matmul(xb, sh), ops.coded_matmul(x, sh))


def test_coded_matmul_empty_batch_launches_nothing(hopper):
    before = ops.coded_matmul.launches
    out = ops.coded_matmul(torch.zeros((0, 4), device=hopper),
                           torch.zeros((3, 4, 2), device=hopper))
    assert out.shape == (3, 0, 2)
    assert ops.coded_matmul.launches == before


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("K,B,Dk,C", [(8, 256, 32, 10), (6, 7, 43, 100),
                                      (4, 1024, 16, 10)])
def test_quorum_aggregate_every_tile_same_bits(hopper, int8, K, B, Dk, C):
    from repro_torch.kernels import autotune as AT
    args = _operands(K, B, Dk, C, np.arange(K) % 3 != 1, int8, hopper)
    base = ops.quorum_aggregate(*args, block_batch=16)
    for c in AT._configs("quorum_aggregate"):
        assert _same_bits(ops.quorum_aggregate(*args, **c), base), c


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("B,R,K,F", [(256, 6, 4, 64), (7, 8, 5, 52),
                                     (1024, 6, 4, 16), (33, 12, 8, 640)])
def test_coded_decode_every_tile_same_bits(hopper, int8, B, R, K, F):
    from repro_torch.kernels import autotune as AT
    args = _cd_operands(B, R, K, F, "mixed", int8, hopper, seed=B)
    base = ops.coded_decode(*args, block_batch=1)
    for c in AT._configs("coded_decode"):
        assert _same_bits(ops.coded_decode(*args, **c), base), c


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("B,D,N", [(1024, 64, 256), (64, 64, 512),
                                   (37, 40, 300), (100, 72, 144),
                                   (300, 2052, 272)])
def test_dequant_matmul_every_tile_same_bits(hopper, per_channel, B, D, N):
    """Each distinct launch of the tile grid (``candidates``: the default
    first) gives the unpinned call's bits."""
    from repro_torch.kernels import dequant_matmul as DQ
    from repro_torch.kernels._layout import num_sms
    args = _dq_operands(B, D, N, per_channel, hopper, seed=N)
    base = ops.dequant_matmul(*args)
    tiles = DQ.candidates(B, D, N, num_sms(args[0].device.index))
    assert len(tiles) > 1
    for c in tiles:
        assert _same_bits(ops.dequant_matmul(*args, **c), base), c


def test_time_callable_times_the_card_not_the_launches(hopper):
    """On the card the microbench timer reads device time: a long product
    agrees with CUDA events around one call, and a small merge, whose wall
    time per call is mostly the host's launch work, reads less than that
    wall time."""
    import time

    from repro_torch.launch import microbench as MB
    a = torch.randn((4096, 4096), device=hopper)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a @ a
    start.record()
    a @ a
    end.record()
    end.synchronize()
    one = start.elapsed_time(end) * 1e-3
    assert 0.7 * one <= MB.time_callable(lambda: a @ a, repeats=5) <= \
        1.4 * one
    args = _operands(8, 256, 32, 10, np.ones(8, bool), False, hopper)
    t0 = time.perf_counter()
    for _ in range(50):
        ops.quorum_aggregate(*args)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 50
    assert 0 < MB.time_callable(lambda: ops.quorum_aggregate(*args),
                                repeats=50) < wall


# -- backward kernels: rmsnorm_bwd, flash_attention_bwd, and the guard --------

def _bwd_close(got, want, dtype):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(a, b, b.dtype if dtype is None else dtype)


def _rmsnorm_bwd_exact(x, s, up):
    """The plain backward on fp64 copies, rounded to the kernel's dtypes
    (dscale sums every row: two fp32 sums of thousands of rows in other
    orders differ by more than 3e-5 where the terms cancel)."""
    dx, ds = ops.rmsnorm_bwd_ref(x.double(), s.double(), up.double())
    return dx.to(x.dtype), ds.to(s.dtype)


@pytest.mark.parametrize("dtype", LM_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,D", [(1, 128), (7, 2048), (2048, 2048),
                                    (2048, 768), (2048, 1536), (2048, 4096),
                                    (2048, 8192), (4097, 6144), (4, 2048),
                                    # ragged D: the scalar route
                                    (33, 100), (7, 1000), (2048, 2047)])
@pytest.mark.parametrize("scale_dtype", ["same", "fp32"])
def test_rmsnorm_bwd_matches_plain_version(hopper, dtype, rows, D,
                                           scale_dtype):
    g = torch.Generator(device=hopper).manual_seed(rows + D)
    x = torch.randn((rows, D), generator=g, device=hopper).to(dtype)
    s = 1 + 0.1 * torch.randn((D,), generator=g, device=hopper)
    s = s.to(dtype) if scale_dtype == "same" else s
    up = torch.randn((rows, D), generator=g, device=hopper).to(dtype)
    before = ops.rmsnorm_bwd.launches
    got = ops.rmsnorm_bwd(x, s, up)
    torch.cuda.synchronize()
    assert ops.rmsnorm_bwd.launches == before + 1
    _bwd_close(got, _rmsnorm_bwd_exact(x, s, up), None)
    again = ops.rmsnorm_bwd(x, s, up)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", LM_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,D", [(4, 2048), (2048, 768), (9, 8192)])
def test_rmsnorm_bwd_unaligned_base_matches_plain_version(hopper, dtype, rows,
                                                          D):
    g = torch.Generator(device=hopper).manual_seed(D)
    buf = torch.randn((rows * D + 1,), generator=g, device=hopper).to(dtype)
    x = buf[1:].view(rows, D)
    s = (1 + 0.1 * torch.randn((D,), generator=g, device=hopper)).to(dtype)
    up = torch.randn((rows, D), generator=g, device=hopper).to(dtype)
    _bwd_close(ops.rmsnorm_bwd(x, s, up), _rmsnorm_bwd_exact(x, s, up),
               None)


def _bwd_flash_operands(B, KV, G, Sq, Skv, D, dtype, strided, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    qm = torch.randn((B, Sq, KV, G, D), generator=g, device=dev).to(dtype)
    km = torch.randn((B, Skv, KV, D), generator=g, device=dev).to(dtype)
    vm = torch.randn((B, Skv, KV, D), generator=g, device=dev).to(dtype)
    dm = torch.randn((B, Sq, KV, G, D), generator=g, device=dev).to(dtype)
    q, k, v, do = qm.permute(0, 2, 3, 1, 4), km.permute(0, 2, 1, 3), \
        vm.permute(0, 2, 1, 3), dm.permute(0, 2, 3, 1, 4)
    if not strided:
        q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    return q, k, v, do


FLASH_BWD_SHAPES = [(1, 1, 1, 64, 64, 64), (2, 2, 4, 100, 100, 64),
                    (1, 4, 2, 128, 128, 128), (1, 2, 3, 33, 33, 96),
                    (1, 2, 2, 5, 5, 32), (2, 8, 4, 512, 512, 64),
                    # Sq != Skv, tile edges (32 rows or keys a tile)
                    (1, 2, 4, 31, 65, 64), (1, 2, 1, 97, 33, 128),
                    (1, 1, 4, 1, 40, 32), (1, 2, 2, 129, 1, 96),
                    # the tensor route (bf16, D 64/128): the students' G 2,
                    # 64-row/key tile edges, keys past Sq, G 3
                    (1, 8, 2, 512, 512, 64), (2, 2, 2, 66, 130, 64),
                    (1, 1, 2, 63, 129, 128), (1, 2, 3, 130, 190, 64)]


@pytest.mark.parametrize("dtype", LM_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,KV,G,Sq,Skv,D", FLASH_BWD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("strided", [False, True], ids=["contig", "strided"])
def test_flash_attention_bwd_matches_plain_version(hopper, dtype, B, KV, G,
                                                   Sq, Skv, D, causal,
                                                   strided):
    q, k, v, do = _bwd_flash_operands(B, KV, G, Sq, Skv, D, dtype, strided,
                                      hopper, seed=Sq + Skv)
    o = ops.flash_attention_ref(q, k, v, causal=causal)
    before = ops.flash_attention_bwd.launches
    copies = ops.flash_attention_bwd.copies
    got = ops.flash_attention_bwd(q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    assert ops.flash_attention_bwd.launches == before + 1
    assert ops.flash_attention_bwd.copies == copies
    _bwd_close(got, ops.flash_attention_bwd_ref(q, k, v, o, do, causal),
               dtype)
    again = ops.flash_attention_bwd(q, k, v, o, do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,KV,G,Sq,Skv,D", [(2, 8, 4, 512, 512, 64),
                                            (1, 2, 3, 130, 190, 128)])
def test_flash_attention_bwd_cuda_core_route_at_tensor_shapes(hopper, B, KV,
                                                              G, Sq, Skv, D):
    """The CUDA-core kernels on bf16 at D 64 and 128 (the tensor route's
    yardstick that ``chip_smoke.py`` times) are within the bound and
    bit-equal on a rerun."""
    q, k, v, do = _bwd_flash_operands(B, KV, G, Sq, Skv, D, torch.bfloat16,
                                      True, hopper, seed=3)
    o = ops.flash_attention_ref(q, k, v, causal=True)
    got = FA._bwd(q, k, v, o, do, True, cuda_cores=True)
    torch.cuda.synchronize()
    _bwd_close(got, ops.flash_attention_bwd_ref(q, k, v, o, do, True),
               torch.bfloat16)
    again = FA._bwd(q, k, v, o, do, True, cuda_cores=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _autograd_scan(dtype, dev):
    """The model's scan (x a view of (B, L, H, P), B and C (B, L, N) shared
    by the heads, the state asked for and used) differentiated on the card
    (one ``ssd_scan_bwd``) and by autograd of the plain version."""
    x, dt, A, Bm, Cm = _ssd_operands(2, 4, 128, 32, 16, dtype, True, dev,
                                     seed=8)
    Bm, Cm = Bm[:, 0], Cm[:, 0]
    grads = []
    for scan in (ops.ssd_scan, ops.ssd_scan_ref):
        leaves = [t.detach().clone().requires_grad_() for t in
                  (x, dt, A, Bm, Cm)]
        count = ops.ssd_scan_bwd.launches
        y, h = scan(*leaves, chunk=32, return_state=True,
                    out_dtype=torch.float32)
        ((y ** 2).mean() + (h ** 2).mean()).backward()
        torch.cuda.synchronize()
        if scan is ops.ssd_scan:
            assert ops.ssd_scan_bwd.launches - count == 1
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.isfinite(a.float()).all() and a.abs().sum() > 0
        _scan_bwd_close(a, b)


def _autograd_gating(dev):
    """The router's weights, differentiated on the card (one
    ``topk_gating_bwd``) and by autograd of the plain version."""
    g = torch.Generator(device=dev).manual_seed(9)
    logits = 2 * torch.randn((300, 16), generator=g, device=dev)
    c = torch.randn((300, 2), generator=g, device=dev)
    grads = []
    for gate in (ops.topk_gating, ops.topk_gating_ref):
        leaf = logits.clone().requires_grad_()
        count = ops.topk_gating_bwd.launches
        w, _ = gate(leaf, 2)
        (w * c).sum().backward()
        torch.cuda.synchronize()
        if gate is ops.topk_gating:
            assert ops.topk_gating_bwd.launches - count == 1
        grads.append(leaf.grad)
    np.testing.assert_allclose(grads[0].cpu().numpy(), grads[1].cpu().numpy(),
                               **TOL)


@pytest.mark.parametrize("path", ["norm_attention", "ssd_scan",
                                  "topk_gating"])
@pytest.mark.parametrize("dtype", LM_DTYPES, ids=["fp32", "bf16"])
def test_autograd_through_the_kernels_matches_the_plain_versions(hopper,
                                                                 path,
                                                                 dtype):
    """A norm, attention and a norm again, differentiated on the card
    (both Functions, each kernel and its backward launched once) and
    through the plain versions by autograd; likewise the scan and the
    router (fp32 logits in both dtypes' cases)."""
    if path == "ssd_scan":
        return _autograd_scan(dtype, hopper)
    if path == "topk_gating":
        return _autograd_gating(hopper)
    B, KV, G, S, D = 2, 2, 2, 48, 64
    g = torch.Generator(device=hopper).manual_seed(5)
    x0 = torch.randn((B, S, KV * G * D), generator=g, device=hopper).to(dtype)
    s0 = (1 + 0.1 * torch.randn((KV * G * D,), generator=g,
                                device=hopper)).to(dtype)
    wk = torch.randn((KV * G * D, KV * D), generator=g,
                     device=hopper).to(dtype) * 0.05

    def run(norm, attn, x, s, w):
        h = norm(x, s)
        q = h.view(B, S, KV, G, D).permute(0, 2, 3, 1, 4)
        kv = (h @ w).view(B, S, KV, D).permute(0, 2, 1, 3)
        o = attn(q, kv, kv, causal=True)
        y = norm(o.permute(0, 3, 1, 2, 4).reshape(B, S, -1), s)
        return (y.float() ** 2).mean()

    grads = []
    for norm, attn in ((ops.rmsnorm, ops.flash_attention),
                       (ops.rmsnorm_ref, ops.flash_attention_ref)):
        leaves = [t.clone().requires_grad_() for t in (x0, s0, wk)]
        counts = (ops.rmsnorm_bwd.launches, ops.flash_attention_bwd.launches)
        run(norm, attn, *leaves).backward()
        torch.cuda.synchronize()
        if norm is ops.rmsnorm:
            assert (ops.rmsnorm_bwd.launches - counts[0],
                    ops.flash_attention_bwd.launches - counts[1]) == (2, 1)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.isfinite(a.float()).all() and a.abs().sum() > 0
        _close(a, b, dtype)


def _guarded_calls(dev):
    """One call of each serving-only kernel, which has no backward, on
    operands that need a gradient (the first float operand of each)."""
    r = lambda *s: torch.rand(s, device=dev)  # noqa: E731
    q, kc, vc = _decode_operands(1, 2, 2, 8, 64, torch.float32, dev)
    return {
        "decode_attention": lambda t: ops.decode_attention(t(q), kc, vc, 3),
        "quorum_aggregate": lambda t: ops.quorum_aggregate(
            t(r(2, 4, 8)), r(2, 8, 3), r(3),
            torch.ones(2, dtype=torch.int32, device=dev)),
        "coded_decode": lambda t: ops.coded_decode(
            t(r(4, 3, 8)), r(4, 2, 3),
            torch.ones((4, 3), dtype=torch.int32, device=dev)),
        "dequant_matmul": lambda t: ops.dequant_matmul(
            t(r(4, 8)), torch.ones((8, 5), dtype=torch.int8, device=dev),
            torch.tensor(0.1, device=dev)),
        "coded_matmul": lambda t: ops.coded_matmul(t(r(4, 8)), r(3, 8, 5)),
    }


@pytest.mark.parametrize("name", ["decode_attention", "quorum_aggregate",
                                  "coded_decode", "dequant_matmul",
                                  "coded_matmul"])
def test_wrappers_without_backward_raise_under_grad(hopper, name):
    """Grad mode on and an operand that needs a gradient: the wrapper
    raises, naming the missing backward; under no_grad, or on operands
    that need none, it launches."""
    call = _guarded_calls(hopper)[name]
    with pytest.raises(RuntimeError, match="no backward kernel"):
        call(lambda t: t.clone().requires_grad_())
    with torch.no_grad():
        call(lambda t: t.clone().requires_grad_())
    call(lambda t: t)
    torch.cuda.synchronize()


# -- SSM, MoE and hybrid training: ssd_scan_bwd, topk_gating_bwd

def _scan_bwd_close(got, want):
    """fp32 gradients within 2e-3 of the largest entry (the forward's bound:
    the kernel sums its fp32 products in other orders, its cumsum in fp64);
    bf16 ones (dx, dB, dC for bf16 operands) also within one bf16 rounding
    of each value (2^-7 relative), since the two round fp32 sums that may
    straddle a bf16 step."""
    assert got.shape == want.shape and got.dtype == want.dtype
    a, b = got.double().cpu(), want.double().cpu()
    assert torch.isfinite(a).all()
    ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    bound = 2e-3 * b.abs().max() + ulp * b.abs()
    worst = (a - b).abs() - bound
    assert float(worst.max()) <= 0, float(((a - b).abs()).max())


SCAN_BWD_SHAPES = [(4, 24, 512, 64, 128, 256),     # mamba2-130m's training
                   (4, 128, 512, 64, 16, 256),     # jamba's
                   (2, 8, 64, 32, 16, 32),         # the tiny configs'
                   (2, 3, 20, 32, 16, 32),         # L below the chunk
                   (1, 4, 96, 16, 32, 48),         # a ragged chunk count
                   (2, 2, 200, 32, 8, 100),
                   (1, 4, 96, 64, 16, 48)]         # ragged, tensor route


def _scan_bwd_operands(Bsz, H, L, P, N, dtype, layout, dev, seed):
    """The model's (B, H) views with B and C (B, L, N) shared ("shared"),
    the same views with B and C expanded over the heads with stride 0
    ("stride0"), or per-head B and C ("per_head")."""
    x, dt, A, Bm, Cm = _ssd_operands(Bsz, H, L, P, N, dtype, True, dev,
                                     seed=seed)
    if layout == "shared":
        Bm, Cm = Bm[:, 0], Cm[:, 0]
    elif layout == "per_head":
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        Bm, Cm = ((t.float() + 0.1 * torch.randn(t.shape, generator=g,
                                                 device=dev)).to(dtype)
                  for t in (Bm, Cm))
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("shape", SCAN_BWD_SHAPES)
@pytest.mark.parametrize("dtype", LM_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout", ["shared", "stride0", "per_head"])
@pytest.mark.parametrize("with_dh", [False, True], ids=["dh0", "dh"])
def test_ssd_scan_bwd_matches_plain_version(hopper, shape, dtype, layout,
                                            with_dh):
    """One launch sequence per call, every gradient in its operand's shape
    and dtype within its bound of the plain backward, a rerun bit-equal
    (no atomics). bf16 at the models' (P, N) takes the tensor route (the
    plan says so), with B and C shared, expanded with stride 0 or per
    head; fp32 and the other shapes the CUDA-core route."""
    Bsz, H, L, P, N, Q = shape
    route = ss.bwd_plan(dtype, Bsz, H, L, P, N, min(Q, L),
                        layout != "per_head", 132).route
    assert route == ("mma" if dtype == torch.bfloat16 and (P, N) in
                     ss.BWD_MMA_SHAPES else "cuda_cores")
    args = _scan_bwd_operands(Bsz, H, L, P, N, dtype, layout, hopper,
                              seed=sum(shape))
    g = torch.Generator(device=hopper).manual_seed(3)
    dy = torch.randn(args[0].shape, generator=g, device=hopper)
    dh = (torch.randn((Bsz, H, P, N), generator=g, device=hopper)
          if with_dh else None)
    before = ops.ssd_scan_bwd.launches
    got = ops.ssd_scan_bwd(*args, dy, dh, chunk=Q)
    again = ops.ssd_scan_bwd(*args, dy, dh, chunk=Q)
    torch.cuda.synchronize()
    assert ops.ssd_scan_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ops.ssd_scan_bwd_ref(*args, dy, dh, chunk=Q)
    for a, b, t in zip(got, want, args):
        assert a.shape == t.shape
        _scan_bwd_close(a, b)


@pytest.mark.parametrize("P,N,Q", [(64, 128, 256), (64, 16, 256),
                                   (32, 16, 32), (16, 32, 48), (4, 4, 1),
                                   (128, 64, 256), (8, 128, 512),
                                   (64, 16, 48), (32, 16, 20)])
def test_ssd_scan_bwd_plan_sizes_the_kernels_shared_memory(hopper, P, N, Q):
    """The plan's shared-memory bytes are the kernel's own count for the
    launches that use it: the CUDA-core route's states and chunk launches
    and, at the tensor route's (P, N), its states and tile launches; the
    workspace the plan allocates is the kernel's carve of it."""
    lib = ss._bwd_library()
    state, chunk = ss.bwd_smem_bytes(P, N, Q)
    assert lib.ssd_scan_bwd_smem_bytes(P, N, Q, 0) == state
    assert lib.ssd_scan_bwd_smem_bytes(P, N, Q, 1) == chunk
    routes = ["cuda_cores"]
    if (P, N) in ss.BWD_MMA_SHAPES:
        routes.append("mma")
        state, tiles = ss.bwd_smem_bytes(P, N, Q, "mma")
        assert lib.ssd_scan_bwd_smem_bytes(P, N, Q, 2) == state
        assert lib.ssd_scan_bwd_smem_bytes(P, N, Q, 3) == tiles
    for route in routes:
        for Bsz, H, L in ((1, 3, 2 * Q), (4, 24, 4 * Q)):
            assert lib.ssd_scan_bwd_ws_bytes(Bsz, H, L, P, N, Q,
                                             int(route == "mma")) == \
                ss.bwd_workspace_bytes(Bsz, H, L, P, N, Q, route)


@pytest.mark.parametrize("P,N", sorted(ss.BWD_MMA_SHAPES))
def test_ssd_scan_bwd_is_finite_at_chunk_256_near_softplus_zero(hopper, P,
                                                                N):
    """The reference's NaN (chunk 256, dt = softplus(0), A = -1): the
    tensor route takes no positive exponent, so every gradient is finite
    and within its bound of the plain backward, a rerun bit-equal."""
    args = list(_scan_bwd_operands(2, 4, 512, P, N, torch.bfloat16,
                                   "shared", hopper, seed=P + N))
    args[1] = torch.full_like(args[1], float(np.log(2.0)))
    args[2] = -torch.ones_like(args[2])
    g = torch.Generator(device=hopper).manual_seed(5)
    dy = torch.randn(args[0].shape, generator=g, device=hopper)
    got = ops.ssd_scan_bwd(*args, dy, chunk=256)
    again = ops.ssd_scan_bwd(*args, dy, chunk=256)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, b in zip(got, ops.ssd_scan_bwd_ref(*args, dy, chunk=256)):
        _scan_bwd_close(a, b)


def test_ssd_scan_bwd_rejects_what_the_kernel_does_not_take(hopper):
    x, dt, A, Bm, Cm = _ssd_operands(1, 2, 64, 48, 16, torch.float32, True,
                                     hopper)
    dy = torch.zeros(x.shape, device=hopper)
    with pytest.raises(ValueError, match="powers of two"):
        ops.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=32)
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_scan_bwd(x[..., :32], dt.double(), A, Bm, Cm, dy[..., :32],
                         chunk=32)


GATE_BWD_SHAPES = [(2048, 64, 6), (2048, 16, 2), (4, 64, 6), (4, 16, 2),
                   (77, 100, 5), (33, 256, 8), (9, 8, 8), (6, 3, 3),
                   (5, 256, 256)]


@pytest.mark.parametrize("N,E,k", GATE_BWD_SHAPES)
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_topk_gating_bwd_matches_plain_version(hopper, N, E, k, aligned):
    """Random rows, planted ties and near-zero weights (a routed expert far
    below the row's top), on the 16-byte and the scalar route (a base off
    16 bytes): within 1e-5 of the plain backward, a rerun bit-equal."""
    g = torch.Generator(device=hopper).manual_seed(N + E + k)
    logits = 2 * torch.randn((N, E), generator=g, device=hopper)
    logits[0] = 0.0
    if N > 2:
        logits[1, [E - 1, 0]] = 3.0
        logits[2] = -20.0
        logits[2, 0] = 20.0
    if not aligned:
        off = torch.empty(N * E + 1, device=hopper)[1:].view(N, E)
        off.copy_(logits)
        logits = off
    w, idx = ops.topk_gating(logits, k)
    dw = torch.randn((N, k), generator=g, device=hopper)
    before = ops.topk_gating_bwd.launches
    got = ops.topk_gating_bwd(logits, idx, w, dw)
    again = ops.topk_gating_bwd(logits, idx, w, dw)
    torch.cuda.synchronize()
    assert ops.topk_gating_bwd.launches == before + 2
    assert torch.equal(got, again)
    want = ops.topk_gating_bwd_ref(logits, idx, w, dw)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


def test_topk_gating_bwd_empty_batch_launches_nothing(hopper):
    z = torch.zeros((0, 8), device=hopper)
    before = ops.topk_gating_bwd.launches
    out = ops.topk_gating_bwd(z, torch.zeros((0, 2), dtype=torch.int32,
                                             device=hopper),
                              torch.zeros((0, 2), device=hopper),
                              torch.zeros((0, 2), device=hopper))
    assert out.shape == (0, 8) and ops.topk_gating_bwd.launches == before


def test_topk_gating_under_grad_at_the_tensor_parallel_ranks_shape(hopper):
    """The router of a moonshot-v1-16b-a3b rank in a tensor-parallel train
    step (every ``model`` rank routes all of its 4 x 512 rows over 64
    experts, top 6): ``topk_gating`` under grad gives weights with a
    ``grad_fn``; the forward and ``topk_gating_bwd`` each launch once a
    pass; the logits' gradient equals the plain backward's on the same
    routes within 1e-5 and autograd of the plain forward's, the indices
    equal; a rerun is bit-equal."""
    N, E, k = 2048, 64, 6
    g = torch.Generator(device=hopper).manual_seed(35)
    logits = 2 * torch.randn((N, E), generator=g, device=hopper)
    c = torch.randn((N, k), generator=g, device=hopper)
    runs = []
    for _ in range(2):
        leaf = logits.clone().requires_grad_()
        fwd, bwd = ops.topk_gating.launches, ops.topk_gating_bwd.launches
        w, idx = ops.topk_gating(leaf, k)
        assert w.grad_fn is not None and not idx.requires_grad
        (w * c).sum().backward()
        torch.cuda.synchronize()
        assert ops.topk_gating.launches == fwd + 1
        assert ops.topk_gating_bwd.launches == bwd + 1
        runs.append((w.detach(), idx, leaf.grad))
    (w, idx, grad), again = runs
    assert all(torch.equal(a, b) for a, b in zip(runs[0], again))
    want = ops.topk_gating_bwd_ref(logits, idx, w, c)
    np.testing.assert_allclose(grad.cpu().numpy(), want.cpu().numpy(), **TOL)
    leaf = logits.clone().requires_grad_()
    rw, ri = ops.topk_gating_ref(leaf, k)
    (rw * c).sum().backward()
    assert torch.equal(idx, ri)
    np.testing.assert_allclose(grad.cpu().numpy(), leaf.grad.cpu().numpy(),
                               **TOL)


@pytest.mark.parametrize("arch", ["mamba2-130m", "moonshot-v1-16b-a3b",
                                  "jamba-v0.1-52b"])
def test_ssm_moe_hybrid_train_step_on_the_card_matches_the_cpu(hopper, arch):
    """One tiny fp32 step's loss and every gradient leaf within 1e-3 of the
    CPU's, each backward kernel launched once per layer that has it."""
    from repro_torch.configs.archs import tiny_version
    from repro_torch.configs.base import get_config
    from repro_torch.launch import steps as ST
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves, tree_to
    cfg = tiny_version(get_config(arch))
    params = api.init(torch.Generator().manual_seed(5), cfg)
    toks = torch.randint(0, cfg.vocab, (4, 64),
                         generator=torch.Generator().manual_seed(6))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    cpu_loss, cpu_g = ST.loss_and_grads(params, cfg, batch)
    counts = (ops.ssd_scan_bwd.launches, ops.topk_gating_bwd.launches)
    loss, grads = ST.loss_and_grads(tree_to(params, hopper), cfg,
                                    tree_to(batch, hopper))
    mamba = {"ssm": cfg.n_layers, "moe": 0}.get(cfg.family, 7)
    moe = {"ssm": 0, "moe": cfg.n_layers}.get(cfg.family, 4)
    assert (ops.ssd_scan_bwd.launches - counts[0],
            ops.topk_gating_bwd.launches - counts[1]) == (mamba, moe)
    assert abs(float(loss) - float(cpu_loss)) <= 1e-3 * abs(float(cpu_loss))
    for a, b in zip(tree_leaves(grads), tree_leaves(cpu_g)):
        assert float(b.abs().sum()) > 0
        err = float((a.cpu() - b).abs().max()) / float(b.abs().max())
        assert err <= 1e-3


# -- the VLM and enc-dec slice: flash_attention and decode_attention at
# -- G 8, non-causal, Sq != Skv over 1500 keys, and a fixed cross length

# (B, KV, G, Sq, Skv, D, causal): qwen2-vl-7b (28 heads padded to 32 over 4
# kv heads), whisper-medium's encoder over its 1500 frames, its
# cross-attention (a 64-token prompt, and 512 training rows, over them)
# and its decoder; then the tiny configs' fp32 D 32 (G 16 and G 2)
VLM_ENCDEC_FLASH = [(2, 4, 8, 512, 512, 128, True),
                    (1, 16, 1, 1500, 1500, 64, False),
                    (2, 16, 1, 64, 1500, 64, False),
                    (2, 16, 1, 512, 512, 64, False),
                    (2, 16, 1, 512, 1500, 64, False),
                    (2, 2, 16, 12, 12, 32, True),
                    (2, 2, 2, 12, 20, 32, False)]


@pytest.mark.parametrize("dtype", LM_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,KV,G,Sq,Skv,D,causal", VLM_ENCDEC_FLASH)
def test_flash_attention_vlm_encdec_routes_match_plain_version(
        hopper, dtype, B, KV, G, Sq, Skv, D, causal):
    """Forward and backward against their plain versions on the views the
    models pass, one launch each, the backward bit-equal on a rerun."""
    q, k, v, do = _bwd_flash_operands(B, KV, G, Sq, Skv, D, dtype, True,
                                      hopper, seed=Sq + Skv + G)
    before = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    o = ops.flash_attention(q, k, v, causal=causal)
    got = ops.flash_attention_bwd(q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    assert (ops.flash_attention.launches - before[0],
            ops.flash_attention_bwd.launches - before[1]) == (1, 1)
    _close(o, ops.flash_attention_ref(q, k, v, causal=causal), dtype)
    _bwd_close(got, ops.flash_attention_bwd_ref(q, k, v, o, do, causal),
               dtype)
    again = ops.flash_attention_bwd(q, k, v, o, do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", LM_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,KV,G,S,D,length", [
    (4, 4, 8, 544, 128, 513), (4, 4, 8, 544, 128, 544),   # qwen2-vl's self
    (4, 16, 1, 1500, 64, 1500), (4, 16, 1, 96, 64, 65),   # whisper's caches
    (2, 2, 16, 21, 32, 13), (2, 2, 2, 20, 32, 20)])       # the tiny configs
def test_decode_attention_vlm_encdec_shapes_match_plain_version(
        hopper, dtype, B, KV, G, S, D, length):
    q, kc, vc = _decode_operands(B, KV, G, S, D, dtype, hopper, seed=S + G)
    before = ops.decode_attention.launches
    out = ops.decode_attention(q, kc, vc, length)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    _close(out, ops.decode_attention_ref(q, kc, vc, length), dtype)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-medium"])
def test_vlm_and_encdec_on_the_card_match_the_cpu(hopper, arch):
    """The tiny fp32 model on the card and on the CPU from the same
    weights and prompt: greedy tokens equal, logits within 1e-4, one train
    step's loss and gradients within 1e-3, and the kernels launched as the
    layers call them."""
    from repro_torch.configs.archs import tiny_version
    from repro_torch.configs.base import get_config
    from repro_torch.launch import steps as ST
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.models import api
    from repro_torch.tree import tree_leaves, tree_to
    names = ("rmsnorm", "flash_attention", "decode_attention",
             "rmsnorm_bwd", "flash_attention_bwd")
    cfg = tiny_version(get_config(arch))
    params = api.init(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=g)
    emb = torch.randn((2, 24 if cfg.family == "encdec" else 16, cfg.d_model),
                      generator=g) * 0.02
    cpu = greedy_decode(params, cfg, toks, 6, embeds=emb, keep_logits=True)
    counts = [getattr(ops, n).launches for n in names]
    gparams = tree_to(params, hopper)
    gpu = greedy_decode(gparams, cfg, toks.to(hopper), 6,
                        embeds=emb.to(hopper), keep_logits=True)
    L = cfg.n_layers
    want = ((0, 3 * L, 2 * L * 5, 0, 0) if cfg.family == "encdec"
            else ((2 * L + 1) * 6, L, L * 5, 0, 0))
    assert tuple(getattr(ops, n).launches - c for n, c in
                 zip(names, counts)) == want
    np.testing.assert_array_equal(gpu.tokens, cpu.tokens)
    for a, b in zip(gpu.logits, cpu.logits):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)
    batch = {"tokens": toks, "embeds": emb, "labels": torch.roll(toks, -1, 1)}
    cpu_loss, cpu_g = ST.loss_and_grads(params, cfg, batch)
    loss, grads = ST.loss_and_grads(gparams, cfg, tree_to(batch, hopper))
    assert abs(float(loss) - float(cpu_loss)) <= 1e-3 * abs(float(cpu_loss))
    for a, b in zip(tree_leaves(grads), tree_leaves(cpu_g)):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a.cpu() - b).abs().max()) / scale <= 1e-3
