"""The port's ``dequant_matmul`` and ``coded_matmul`` against the JAX
package's.

On the CPU each wrapper runs its plain version, held here to the JAX Pallas
kernel in interpret mode (as ``tests/test_fastpath.py`` and
``tests/test_coded_compute.py`` run them) within rtol/atol 1e-5. The CUDA
kernels themselves have no CPU mode: they are held to their plain versions
on the card by ``tests/test_torch_hopper.py`` and ``chip_smoke.py``. The
launch geometry the wrappers compute in Python (the clamped tiles) is
checked here.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.coding import codes as JC  # noqa: E402
from repro.coding.compute import reconstruct_from_shards  # noqa: E402
from repro.coding.compute import shard_linear_weights as jshard  # noqa: E402
from repro.kernels.coded_matmul import coded_matmul as jcm  # noqa: E402
from repro.kernels.dequant_matmul import dequant_matmul as jdq  # noqa: E402
from repro.optim.compression import quantize_weight  # noqa: E402
from repro_torch.coding import compute as TCOMP  # noqa: E402
from repro_torch.coding.codes import decode_matrix, make_generator  # noqa: E402
from repro_torch.kernels import autotune as AT  # noqa: E402
from repro_torch.kernels import dequant_matmul as DQ  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_table(monkeypatch):
    """The defaults only: no tuning table from the environment or disk."""
    monkeypatch.delenv("REPRO_TORCH_TUNING_TABLE", raising=False)
    saved = AT.active_table()
    AT.set_table(AT.TuningTable())
    yield
    AT.set_table(saved)


def _dq_operands(B, D, N, per_channel, seed):
    """x, q, scale as numpy, quantized by the JAX package's own helper."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D)).astype(np.float32)
    w = rng.normal(size=(D, N)).astype(np.float32)
    wq = quantize_weight(jnp.asarray(w), axis=1 if per_channel else None)
    return x, np.array(wq.q), np.array(wq.scale, np.float32)


def _port_dq(x, q, s, **blocks):
    return ops.dequant_matmul(torch.from_numpy(x), torch.from_numpy(q),
                              torch.from_numpy(s), **blocks)


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("B,D,N", [(1, 8, 5), (7, 16, 11), (130, 8, 300)])
def test_dequant_matmul_matches_jax_kernel(B, D, N, per_channel):
    x, q, s = _dq_operands(B, D, N, per_channel, seed=B * 7 + N)
    ref = jdq(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), interpret=True)
    out = _port_dq(x, q, s)
    assert out.shape == (B, N) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("B,D,N,bb,bn", [
    (7, 16, 13, 4, 8),         # both dims ragged vs the block
    (33, 8, 257, 32, 64),      # one full tile + a 1-wide remainder each way
    (1, 8, 1, 128, 256),       # blocks far larger than the problem
    (250, 32, 100, 128, 256),  # JAX defaults against a non-multiple shape
])
def test_dequant_matmul_ragged_grid_matches_jax(B, D, N, bb, bn):
    rng = np.random.default_rng(B * 1000 + N)
    x = rng.normal(size=(B, D)).astype(np.float32)
    q = rng.integers(-127, 128, (D, N)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, (N,)).astype(np.float32)
    ref = jdq(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
              block_batch=bb, block_n=bn, interpret=True)
    out = _port_dq(x, q, s, block_batch=bb, block_n=bn)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    tb, tn = DQ.tiles(B, N, bb, bn)
    assert 1 <= tb <= min(B, DQ.MAX_TILE) and 1 <= tn <= min(N, DQ.MAX_TILE)


@pytest.mark.parametrize("bb,bn", [(0, 0), (-5, 4), (4096, 4096)])
def test_dequant_matmul_degenerate_blocks_are_legal(bb, bn):
    """A zero, negative or oversized tile (a stale table entry) is clamped
    to a legal launch, and the result is the JAX kernel's."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 8)).astype(np.float32)
    q = rng.integers(-127, 128, (8, 6)).astype(np.int8)
    s = np.float32(0.05)
    ref = jdq(jnp.asarray(x), jnp.asarray(q), jnp.float32(s),
              block_batch=bb, block_n=bn, interpret=True)
    out = _port_dq(x, q, np.asarray(s), block_batch=bb, block_n=bn)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    tb, tn = DQ.tiles(5, 6, bb, bn)
    assert 1 <= tb <= 5 and 1 <= tn <= 6


def test_dequant_matmul_tiles_clamp():
    assert DQ.tiles(2048, 8192, 64, 128) == (64, 128)
    assert DQ.tiles(2048, 8192, 4096, 4096) == (128, 128)
    assert DQ.tiles(3, 2, 0, -1) == (1, 1)


def test_dequant_matmul_empty_batch():
    out = ops.dequant_matmul(torch.zeros((0, 4)),
                             torch.zeros((4, 3), dtype=torch.int8),
                             torch.tensor(0.1))
    ref = jdq(jnp.zeros((0, 4)), jnp.zeros((4, 3), jnp.int8),
              jnp.float32(0.1), interpret=True)
    assert tuple(out.shape) == ref.shape == (0, 3)


def test_dequant_matmul_rejects_bad_operands():
    x = torch.zeros((2, 4))
    with pytest.raises(TypeError, match="int8"):
        ops.dequant_matmul(x, torch.zeros((4, 3)), torch.tensor(0.1))
    with pytest.raises(ValueError, match="scale"):
        ops.dequant_matmul(x, torch.zeros((4, 3), dtype=torch.int8),
                           torch.ones(2))
    with pytest.raises(ValueError, match="expected"):
        ops.dequant_matmul(x, torch.zeros((5, 3), dtype=torch.int8),
                           torch.tensor(0.1))


def _shards(D, F, n, k, seed):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((D, F)).astype(np.float32)
    return rng, W, np.asarray(jshard(W, n, k), np.float32)


@pytest.mark.parametrize("B,D,F,n,k,bb", [
    (9, 6, 13, 5, 3, 4),       # tests/test_coded_compute.py's case
    (4, 6, 12, 3, 2, 128),
    (37, 16, 40, 8, 5, 16),    # ragged B vs the JAX block
    (256, 64, 128, 5, 3, 128),  # the compute-fused plan's (5, 3) slot
    (0, 6, 13, 5, 3, 128),     # empty batch
])
def test_coded_matmul_matches_jax_kernel(B, D, F, n, k, bb):
    rng, _, shards = _shards(D, F, n, k, seed=B + F)
    x = rng.standard_normal((B, D)).astype(np.float32)
    out = ops.coded_matmul(torch.from_numpy(x), torch.from_numpy(shards))
    assert tuple(out.shape) == (n, B, -(-F // k))
    if B:
        ref = jcm(jnp.asarray(x), jnp.asarray(shards), block_batch=bb,
                  interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("n,k", [(3, 2), (5, 3), (8, 5)])
@pytest.mark.parametrize("F", [12, 13])
def test_shards_equal_between_packages(n, k, F):
    """Both packages' ``shard_linear_weights`` give the same stack, so the
    kernel sees the same weights whichever package encoded them."""
    W = np.random.default_rng(n * 17 + F).standard_normal(
        (6, F)).astype(np.float32)
    np.testing.assert_array_equal(TCOMP.shard_linear_weights(W, n, k),
                                  jshard(W, n, k))


@pytest.mark.parametrize("n,k", [(5, 3), (8, 5)])
def test_compute_coding_round_trip_every_erasure(n, k):
    """shard_linear_weights → coded_matmul → coded_decode, for every
    pattern of n - k erased shards, against ``x @ W`` and against the JAX
    package's reference decode of the JAX kernel's partial products."""
    rng, W, shards = _shards(16, 40, n, k, seed=n)
    x = rng.standard_normal((11, 16)).astype(np.float32)
    B, w = x.shape[0], shards.shape[2]
    parts = ops.coded_matmul(torch.from_numpy(x), torch.from_numpy(shards))
    jparts = np.asarray(jcm(jnp.asarray(x), jnp.asarray(shards),
                            interpret=True))
    G = make_generator(n, k)
    np.testing.assert_array_equal(G, JC.make_generator(n, k))
    for dead in itertools.combinations(range(n), n - k):
        arrived = np.ones(n, bool)
        arrived[list(dead)] = False
        dec = np.broadcast_to(decode_matrix(G, arrived).astype(np.float32),
                              (B, k, n)).copy()
        mask = np.broadcast_to(arrived.astype(np.int32), (B, n)).copy()
        rec = ops.coded_decode(parts.transpose(0, 1).contiguous(),
                               torch.from_numpy(dec), torch.from_numpy(mask))
        y = rec.reshape(B, k * w)[:, :W.shape[1]].numpy()
        np.testing.assert_allclose(y, x @ W, rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(
            y, reconstruct_from_shards(jparts, G, arrived, W.shape[1]),
            rtol=5e-4, atol=5e-4)


def test_coded_matmul_rejects_bad_operands():
    with pytest.raises(ValueError, match="expected"):
        ops.coded_matmul(torch.zeros((2, 4)), torch.zeros((3, 5, 2)))
    with pytest.raises(TypeError, match="float32"):
        ops.coded_matmul(torch.zeros((2, 4), dtype=torch.float64),
                         torch.zeros((3, 4, 2)))
