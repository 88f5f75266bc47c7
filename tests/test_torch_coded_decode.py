"""The port's ``coded_decode`` against the JAX package's.

On the CPU the wrapper runs its plain version, held here to the JAX Pallas
kernel in interpret mode (as ``tests/test_kernels.py`` runs it) within
rtol/atol 1e-5. The CUDA kernel itself has no CPU mode: it is held to the
plain version on the card by ``tests/test_torch_hopper.py`` and
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.coded_decode import coded_decode as jcd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _operands(B, R, K, F, mask, int8, seed=0):
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
    return sh, dec, m, s


def _port(sh, dec, m, s, device="cpu"):
    t = [torch.from_numpy(a).to(device) for a in (sh, dec, m)]
    return ops.coded_decode(*t, None if s is None
                            else torch.from_numpy(s).to(device))


CASES = [  # B, R, K, F, JAX block_batch
    (5, 6, 4, 16, 128),
    (7, 8, 5, 52, 4),          # ragged B vs the block
    (1, 5, 3, 43, 128),
    (9, 6, 4, 64, 2),
    (0, 6, 4, 64, 128),        # empty batch
]


@pytest.mark.parametrize("mask", ["ones", "mixed", "zeros"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("B,R,K,F,bb", CASES)
def test_matches_jax_kernel(B, R, K, F, bb, int8, mask):
    sh, dec, m, s = _operands(B, R, K, F, mask, int8, seed=B + R)
    ref = jcd(jnp.asarray(sh), jnp.asarray(dec), jnp.asarray(m),
              None if s is None else jnp.asarray(s), block_batch=bb,
              interpret=True)
    out = _port(sh, dec, m, s)
    assert out.shape == (B, K, F) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_bool_mask_on_the_cpu_equals_int32():
    sh, dec, m, _ = _operands(4, 6, 4, 8, "mixed", False)
    a = _port(sh, dec, m, None)
    b = _port(sh, dec, m.astype(bool), None)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_int8_without_scales_raises():
    sh, dec, m, _ = _operands(2, 3, 2, 4, "ones", True)
    with pytest.raises(ValueError, match="scales"):
        _port(sh, dec, m, None)


def test_bad_operands_raise():
    sh, dec, m, _ = _operands(3, 4, 2, 5, "ones", False)
    with pytest.raises(ValueError, match="do not match"):
        _port(sh, dec[:, :, :3], m, None)
    with pytest.raises(ValueError, match="do not match"):
        _port(sh, dec, m[:2], None)
    with pytest.raises(TypeError, match="float32"):
        _port(sh.astype(np.float64), dec, m, None)
    with pytest.raises(TypeError, match="dec must be float32"):
        _port(sh, dec.astype(np.float64), m, None)
    with pytest.raises(ValueError, match=r"scales must be float32"):
        _port(sh, dec, m, np.ones(3, np.float32))
    with pytest.raises(ValueError, match="cuda or cpu"):
        _port(sh, dec, m, None, device="meta")


def test_cpu_path_launches_no_kernel():
    before = ops.coded_decode.launches
    _port(*_operands(3, 5, 3, 7, "mixed", False))
    assert ops.coded_decode.launches == before
