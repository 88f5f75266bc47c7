"""The split-KV plan of the port's ``decode_attention`` kernel and a
model of its split-and-merge rule, against the JAX package's kernel.

On the card ``csrc/decode_attention.cu`` gives each (b, kv head, chunk of
query heads) ``split_plan(...)`` blocks; block s reads the positions
``[s*per, min(length, (s+1)*per))`` with ``per = ceil(length / splits)``
and keeps an online-softmax state (m, l, acc) in fp32; the splits' states
are merged, skipping a split that saw no position (l = 0). The CUDA
kernel has no CPU mode, so this file holds a model of the kernel written
in plain torch: only the split ranges and that merge (how a block shares
its range among its warps is left out). The model is held to the JAX
Pallas kernel in interpret mode within the fp32 bound 3e-5, and the plan
to its bounds. The kernel itself is held to its plain version by the
``hopper`` tests of ``tests/test_torch_hopper.py`` on the card. The
wrappers' plain versions are not involved here.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _layout  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402

TOL = dict(rtol=3e-5, atol=3e-5)      # the JAX package's fp32 bound
NEG_INF = -1e30

# (B, KV, G, S, D) at serving widths, the cache's capacity S = 512 + 32
SERVING = {"llama3.2-1b": (4, 8, 4, 544, 64),
           "tinyllama-1.1b": (4, 4, 8, 544, 64),
           "moonshot-v1-16b-a3b": (4, 16, 1, 544, 128),
           "jamba-v0.1-52b": (4, 8, 4, 544, 128),
           "granite (MQA)": (4, 1, 48, 544, 128),
           "phi3-mini": (4, 32, 1, 544, 96),
           "qwen2-vl-7b": (4, 4, 8, 544, 128),
           # whisper-medium: the self cache (a 64-token prompt, 32 tokens)
           # and the cross cache of the encoder's 1500 frames
           "whisper-medium (self)": (4, 16, 1, 96, 64),
           "whisper-medium (cross)": (4, 16, 1, 1500, 64)}


def split_ranges(length: int, nsplit: int):
    """The positions each split reads: the kernel's rule."""
    per = -(-length // nsplit)
    return [(min(length, s * per), min(length, s * per + per))
            for s in range(nsplit)]


def partial_state(q, k, v, pos):
    """(m, l, acc) of q (G, D) over the cache rows ``pos``; l = 0 and
    m = -1e30 when ``pos`` is empty."""
    G, D = q.shape
    if len(pos) == 0:
        return (torch.full((G,), NEG_INF), torch.zeros(G),
                torch.zeros(G, D))
    s = q @ k[pos].T / math.sqrt(D)                  # (G, rows)
    m = s.max(-1).values
    p = torch.exp(s - m[:, None])
    return m, p.sum(-1), p @ v[pos]


def merge(states):
    """One state from several, the empty ones (l = 0) skipped."""
    live = [st for st in states if bool((st[1] > 0).all())]
    if not live:
        return states[0]
    mx = torch.stack([m for m, _, _ in live]).max(0).values
    l = sum(l * torch.exp(m - mx) for m, l, _ in live)
    acc = sum(a * torch.exp(m - mx)[:, None] for m, _, a in live)
    return mx, l, acc


def split_decode(q, k, v, length, nsplit):
    """o (B, KV, G, D) by the kernel's split-and-merge rule: one state per
    split range, the empty ones skipped in the merge."""
    B, KV, G, D = q.shape
    out = torch.zeros(B, KV, G, D)
    for b in range(B):
        for h in range(KV):
            splits = [partial_state(q[b, h], k[b, h], v[b, h],
                                    np.arange(lo, hi))
                      for lo, hi in split_ranges(length, nsplit)]
            _, l, acc = merge(splits)
            out[b, h] = acc / l.clamp_min(1e-20)[:, None]
    return out


def test_head_chunk_is_the_kernels_template_argument():
    assert [da.head_chunk(G) for G in (1, 2, 3, 4, 5, 6, 8, 48)] == \
        [1, 2, 4, 4, 8, 8, 8, 8]


@pytest.mark.parametrize("B,KV,G,S", [(1, 1, 1, 1), (1, 1, 1, 15),
                                      (1, 1, 48, 40), (4, 8, 4, 544),
                                      (64, 32, 1, 4096), (1, 1, 1, 32768),
                                      (4, 4, 8, 544), (4, 16, 1, 1500)])
@pytest.mark.parametrize("num_sms", [1, 8, 132])
def test_split_plan_bounds(B, KV, G, S, num_sms):
    """At least one split, never more splits than cache rows (nor than one
    per MIN_SPLIT_ROWS of them), nor than the kernel's merge takes."""
    n = da.split_plan(B, KV, G, S, num_sms)
    assert 1 <= n <= min(S, da.MAX_SPLITS)
    assert n == 1 or n <= S // da.MIN_SPLIT_ROWS


@pytest.mark.parametrize("arch", sorted(SERVING))
def test_split_plan_fills_the_h100_at_serving_shapes(arch):
    """With 132 SMs every serving shape gets at least one block per SM."""
    B, KV, G, S, _ = SERVING[arch]
    groups = B * KV * -(-G // da.head_chunk(G))
    assert da.split_plan(B, KV, G, S, 132) * groups >= 132


@pytest.mark.parametrize("length", [0, 1, 2, 3, 59, 528, 544])
@pytest.mark.parametrize("nsplit", [1, 3, 9, 34])
def test_split_ranges_read_every_position_once(length, nsplit):
    seen = np.concatenate([np.arange(lo, hi)
                           for lo, hi in split_ranges(length, nsplit)])
    np.testing.assert_array_equal(seen, np.arange(length))


@pytest.mark.parametrize("B,KV,G,S,D", [(4, 8, 4, 256, 64),
                                        (1, 1, 8, 256, 128),
                                        (2, 2, 1, 64, 32),
                                        (2, 4, 8, 128, 128)])   # qwen2-vl
@pytest.mark.parametrize("length", ["1", "2", "3", "100", "S"])
@pytest.mark.parametrize("num_sms", [8, 132])
def test_split_and_merge_matches_jax_kernel(B, KV, G, S, D, length, num_sms):
    """Lengths 1-3 leave splits past ``length`` empty; ``S`` fills the
    cache."""
    n = S if length == "S" else min(int(length), S)
    rng = np.random.default_rng(S + G + n)
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    k = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    nsplit = da.split_plan(B, KV, G, S, num_sms)
    out = split_decode(*(torch.from_numpy(a) for a in (q, k, v)), n, nsplit)
    kernel = jops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.int32(n),
                                   block_kv=min(128, S), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(kernel), **TOL)


@pytest.mark.parametrize("width,dtype,nbytes,copied", [
    (64, torch.bfloat16, 16, False), (65, torch.bfloat16, 16, True),
    (66, torch.bfloat16, 4, False), (65, torch.bfloat16, 4, True),
    (68, torch.float32, 16, False), (66, torch.float32, 16, True)])
def test_aligned_copies_only_views_the_kernels_cannot_address(
        width, dtype, nbytes, copied):
    """A cache view whose byte strides are multiples of ``nbytes`` goes to
    the kernels as it is; another becomes a contiguous copy of the same
    values. Axes of size 1 carry stride 0."""
    wide = torch.arange(2 * 5 * 3 * width, dtype=torch.float32).reshape(
        2, 5, 3, width).to(dtype)
    view = wide[..., :32].permute(0, 2, 1, 3)
    out = _layout.aligned(view, nbytes)
    assert (out is not view) == copied
    assert out.is_contiguous() or not copied
    torch.testing.assert_close(out, view, rtol=0, atol=0)
    assert _layout.strides(wide[:1, :, :1]) == (0, 3 * width, 0, 1)
