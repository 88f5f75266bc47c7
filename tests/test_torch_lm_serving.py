"""The port's dense LM serving path against the JAX package's models.

The tiny configs of the four dense archs (``tiny_version``: 2 layers,
d_model 128, 4 query heads over 2 kv heads — 1 for granite, i.e. MQA —
fp32) are built by the JAX package from a seed, and their weights carried
to the port by ``lm_params_from_jax``. The same numpy tokens then go
through both: forward, prefill (logits and cache), one decode step (logits
and the updated cache), and the greedy loop of ``launch/serve.py``. fp32
results agree within 1e-4 (the einsums and matmuls sum in other orders);
greedy tokens are equal. One bf16 case holds the logits within atol/rtol
5e-2: the JAX model rounds its scores and probabilities to bf16 where the
port's kernels keep fp32.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import tiny_version as j_tiny  # noqa: E402
from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs.archs import tiny_version  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.launch.serve import greedy_decode  # noqa: E402
from repro_torch.models import api  # noqa: E402

ARCHS = ["llama3.2-1b", "tinyllama-1.1b", "phi3-mini-3.8b", "granite-20b"]
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
B, P, GEN = 2, 12, 9                  # prompt P, then GEN - 1 = 8 decode steps


def _cfgs(arch, **kw):
    return j_tiny(j_get_config(arch)).with_(**kw), \
        tiny_version(get_config(arch)).with_(**kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@functools.cache
def _model(arch, dtype="float32"):
    """(JAX cfg, port cfg, JAX params, port params, prompt tokens)."""
    kw = {} if dtype == "float32" else dict(
        param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    jcfg = j_tiny(j_get_config(arch)).with_(**kw)
    tcfg = tiny_version(get_config(arch))
    if dtype != "float32":
        tcfg = tcfg.with_(param_dtype=torch.bfloat16,
                          compute_dtype=torch.bfloat16)
    jparams = japi.init(jax.random.key(0), jcfg)
    tparams = lm_params_from_jax(jax.device_get(jparams))
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (B, P)
                                             ).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, toks


@functools.cache
def _jax_fns(arch, dtype="float32"):
    jcfg = _model(arch, dtype)[0]
    return (jax.jit(lambda p, b: japi.forward(p, jcfg, b)),
            jax.jit(lambda p, b: japi.prefill(p, jcfg, b)),
            jax.jit(lambda p, b, c, i: japi.decode_step(p, jcfg, b, c, i)))


def _jax_generate(arch):
    """The JAX package's serve loop (``launch/serve.py:generate``) driven
    with the given params and prompt: prefill, splice into a P+GEN cache,
    argmax, GEN-1 decode steps at P+t."""
    jcfg, _, jparams, _, toks = _model(arch)
    _, prefill, decode = _jax_fns(arch)
    cache = japi.init_cache(jcfg, B, P + GEN)
    logits, pcache = prefill(jparams, {"tokens": jnp.asarray(toks)})
    cache = jax.tree.map(
        lambda d, s: jnp.pad(s, [(0, a - b) for a, b in zip(d.shape, s.shape)]),
        cache, pcache)
    cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out, steps = [np.asarray(cur)], [logits[:, -1]]
    for t in range(GEN - 1):
        logits, cache = decode(jparams, {"tokens": cur}, cache,
                               jnp.int32(P + t))
        cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out.append(np.asarray(cur))
        steps.append(logits[:, -1])
    return np.concatenate(out, axis=1), steps


def test_layers_match_jax():
    """The ported LM layers, including those the dense archs do not call
    (LayerNorm, GELU, tied-embedding logits), on the same numpy inputs."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 3, 32)).astype(np.float32)
    pos = np.arange(6)[None].repeat(2, 0) + 3
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    emb = {"embedding": rng.standard_normal((50, 32)).astype(np.float32)}
    jp, tp = ({k: f(v) for k, v in d.items()} for d, f in
              ((p, jnp.asarray), (p, torch.from_numpy)))
    je, te = {"embedding": jnp.asarray(emb["embedding"])}, \
        {"embedding": torch.from_numpy(emb["embedding"])}
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    pairs = [
        (JL.apply_rope(jx, jnp.asarray(pos), theta=5e5),
         TL.apply_rope(tx, torch.from_numpy(pos), theta=5e5)),
        (JL.rmsnorm_apply(jp, jx), TL.rmsnorm_apply(tp, tx)),
        (JL.layernorm_apply(jp, jx), TL.layernorm_apply(tp, tx)),
        (JL.gelu(jx), TL.gelu(tx)),
        (JL.swiglu(jx, jx[::-1]), TL.swiglu(tx, tx.flip(0))),
        (JL.embed_attend(je, jx), TL.embed_attend(te, tx)),
        (JL.embed_apply(je, jnp.asarray(pos)),
         TL.embed_apply(te, torch.from_numpy(pos))),
    ]
    for j, t in pairs:
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-20b"])
def test_loss_matches_jax(arch):
    jcfg, tcfg, jparams, tparams, toks = _model(arch)
    labels = np.roll(toks, -1, axis=1)
    ref = japi.loss(jparams, jcfg, {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(labels)},
                    train=False)
    out = api.loss(tparams, tcfg, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(out), float(ref), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    _, tcfg, jparams, tparams, toks = _model(arch)
    ref = _jax_fns(arch)[0](jparams, {"tokens": jnp.asarray(toks)})
    out = api.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    assert out.shape == (B, P, tcfg.vocab)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch):
    _, tcfg, jparams, tparams, toks = _model(arch)
    jl, jc = _jax_fns(arch)[1](jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = api.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (B, 1, tcfg.vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape == (
            tcfg.n_layers, B, P, tcfg.n_kv_heads, tcfg.head_dim)
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **TOL)


@pytest.mark.parametrize("index_kind", ["int", "tensor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_and_cache_match_jax(arch, index_kind):
    """One decode step at index P over a cache of random rows: the step
    writes row P, attends over rows 0..P and leaves the rest as they are."""
    jcfg, tcfg, jparams, tparams, toks = _model(arch)
    rng = np.random.default_rng(11)
    shape = (tcfg.n_layers, B, P + GEN, tcfg.n_kv_heads, tcfg.head_dim)
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in "kv")
    tok = rng.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
    jl, jcache = _jax_fns(arch)[2](jparams, {"tokens": jnp.asarray(tok)},
                                   {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                                   jnp.int32(P))
    index = P if index_kind == "int" else torch.tensor(P, dtype=torch.int32)
    tcache = {"k": torch.from_numpy(kc.copy()),
              "v": torch.from_numpy(vc.copy())}
    tl, out = api.decode_step(tparams, tcfg, {"tokens": torch.from_numpy(tok)},
                              tcache, index)
    assert out is tcache                       # updated in place
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_the_jax_serve_loop(arch):
    _, tcfg, _, tparams, toks = _model(arch)
    jtok, jsteps = _jax_generate(arch)
    res = greedy_decode(tparams, tcfg, torch.from_numpy(toks), GEN,
                        keep_logits=True)
    assert res.tokens.shape == (B, GEN)
    np.testing.assert_array_equal(res.tokens, jtok)
    for a, b in zip(res.logits, jsteps):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_bf16_logits_within_bound():
    """bf16 weights and compute in both packages (llama3.2-1b tiny)."""
    _, tcfg, jparams, tparams, toks = _model("llama3.2-1b", "bfloat16")
    assert tparams["embed"]["embedding"].dtype == torch.bfloat16
    ref = _jax_fns("llama3.2-1b", "bfloat16")[0](
        jparams, {"tokens": jnp.asarray(toks)})
    out = api.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), **BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_forward(arch):
    """The port's twin of tests/test_archs_smoke.py::test_prefill_matches_decode:
    token-by-token decode from an empty cache, and prefill of the first half
    then decode of the rest, both reproduce the full forward's logits."""
    _, tcfg, _, tparams, toks = _model(arch)
    t = torch.from_numpy(toks)
    full = api.forward(tparams, tcfg, {"tokens": t})
    cache = api.init_cache(tcfg, B, P, device="cpu")
    steps = [api.decode_step(tparams, tcfg, {"tokens": t[:, i:i + 1]}, cache,
                             i)[0] for i in range(P)]
    np.testing.assert_allclose(_np(torch.cat(steps, 1)), _np(full), **TOL)
    h = P // 2
    logits, pcache = api.prefill(tparams, tcfg, {"tokens": t[:, :h]})
    cache = api.init_cache(tcfg, B, P, device="cpu")
    for name in cache:
        cache[name][:, :, :h] = pcache[name]
    steps = [logits] + [api.decode_step(tparams, tcfg, {"tokens": t[:, i:i + 1]},
                                        cache, i)[0] for i in range(h, P)]
    np.testing.assert_allclose(_np(torch.cat(steps, 1)), _np(full[:, h - 1:]),
                               **TOL)


def test_generate_runs_on_the_cpu_when_asked():
    from repro_torch.launch.serve import generate
    res = generate("tinyllama-1.1b", prompt_len=8, gen=4, batch=2,
                   device="cpu", verbose=False)
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == np.int64
    assert res.prefill_ms > 0 and res.logits is None
