"""The port's SSM, MoE and hybrid LM serving against the JAX package's.

The tiny configs (``tiny_version``: d_model 128, fp32; mamba2-130m with 2
layers of 8 SSM heads of P = 32, N = 16; moonshot-v1-16b-a3b and
grok-1-314b with 2 layers of 4 experts, top-2; jamba-v0.1-52b as one full
8-layer period: attention at sub-layer 4, MoE at the odd sub-layers) are
built by the JAX package from a seed and their weights carried to the port
by ``lm_params_from_jax``. The same numpy tokens then go through both:
forward, prefill (logits and every cache leaf, conv windows and SSM states
included), one decode step (logits and the updated cache), and the greedy
loop of ``launch/serve.py``. fp32 results agree within 1e-4 (products and
scans sum in other orders); greedy tokens are equal; the MoE routing —
experts, capacity positions and dropped slots — is equal slot for slot.
A bf16 moonshot holds its logits within atol/rtol 5e-2, the dense bf16
bound of ``tests/test_torch_lm_serving.py``, in the batch rows whose
routing agrees with the JAX model's; a row that routes otherwise must be a
near tie of the router's probabilities.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as JT  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs.archs import tiny_version  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.launch.serve import generate, greedy_decode, splice  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.tree import stack_init, stack_trees, tree_leaves  # noqa: E402
from test_torch_lm_serving import (B, BF16_TOL, GEN, P, TOL, _jax_fns,  # noqa: E402
                                   _jax_generate, _model, _np)

ARCHS = ["mamba2-130m", "moonshot-v1-16b-a3b", "grok-1-314b",
         "jamba-v0.1-52b"]


def _close_trees(port, ref):
    assert sorted(port) == sorted(ref)
    for name in ref:
        assert tuple(port[name].shape) == ref[name].shape, name
        np.testing.assert_allclose(_np(port[name]), _np(ref[name]), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    _, tcfg, jparams, tparams, toks = _model(arch)
    ref = _jax_fns(arch)[0](jparams, {"tokens": jnp.asarray(toks)})
    out = api.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    assert out.shape == (B, P, tcfg.vocab)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch):
    jcfg, tcfg, jparams, tparams, toks = _model(arch)
    jl, jc = _jax_fns(arch)[1](jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = api.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _close_trees(tc, jc)
    shapes = jax.tree.map(lambda a: a.shape, japi.init_cache(jcfg, B, P + GEN))
    port = api.init_cache(tcfg, B, P + GEN, device="cpu")
    assert {k: tuple(v.shape) for k, v in port.items()} == shapes
    assert port.get("state", torch.zeros(0)).dtype == torch.float32


def _random_cache(jcfg, seed=11):
    """A cache of the serving shape filled with numpy noise (states
    included), for a decode step from an arbitrary point."""
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in japi.init_cache(jcfg, B, P + GEN).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_and_cache_match_jax(arch):
    jcfg, tcfg, jparams, tparams, toks = _model(arch)
    cache = _random_cache(jcfg)
    tok = np.random.default_rng(12).integers(0, jcfg.vocab, (B, 1)
                                             ).astype(np.int32)
    jl, jcache = _jax_fns(arch)[2](
        jparams, {"tokens": jnp.asarray(tok)},
        {k: jnp.asarray(v) for k, v in cache.items()}, jnp.int32(P))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tl, out = api.decode_step(tparams, tcfg, {"tokens": torch.from_numpy(tok)},
                              tcache, P)
    assert out is tcache                       # updated in place
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _close_trees(tcache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_the_jax_serve_loop(arch):
    _, tcfg, _, tparams, toks = _model(arch)
    jtok, jsteps = _jax_generate(arch)
    res = greedy_decode(tparams, tcfg, torch.from_numpy(toks), GEN,
                        keep_logits=True)
    np.testing.assert_array_equal(res.tokens, jtok)
    for a, b in zip(res.logits, jsteps):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def _jax_routes(jparams, jcfg, toks):
    """The JAX model's top-k experts (B·S, K) of every MoE layer of one
    forward, in layer order (recorded from ``_moe_route``)."""
    routes, route = [], JT._moe_route

    def recorded(router, cfg, x):
        out = route(router, cfg, x)
        jax.debug.callback(lambda e: routes.append(np.asarray(e)),
                           out[1].reshape(-1, cfg.top_k), ordered=True)
        return out
    JT._moe_route = recorded
    try:
        jax.block_until_ready(japi.forward(jparams, jcfg,
                                           {"tokens": jnp.asarray(toks)}))
    finally:
        JT._moe_route = route
    return routes


def test_bf16_moe_logits_within_bound(monkeypatch):
    """bf16 weights and compute in both packages (moonshot tiny); the fp32
    router and its gating stay fp32 in both. bf16 rounds at other places in
    the two packages, so a router row whose k-th and (k+1)-th experts are
    nearly tied may pick another expert: such a row must be a near tie
    (probabilities within 0.02), and the logits are held to the bound in
    the batch rows where no routing differs (a flip changes the expert
    output of its token, and through attention and the row's capacity
    positions the rest of its batch row)."""
    arch = "moonshot-v1-16b-a3b"
    jcfg, tcfg, jparams, tparams, toks = _model(arch, "bfloat16")
    assert tparams["layers"]["ffn"]["wi"].dtype == torch.bfloat16
    assert tparams["layers"]["ffn"]["router"]["kernel"].dtype == torch.float32
    ref = _jax_fns(arch, "bfloat16")[0](jparams, {"tokens": jnp.asarray(toks)})
    probs, idx, gate = [], [], T.ops.topk_gating

    def recorded(logits, k):
        probs.append(torch.softmax(logits, -1))
        w, i = gate(logits, k)
        idx.append(i)
        return w, i
    monkeypatch.setattr(T.ops, "topk_gating", recorded)
    out = api.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    assert out.dtype == torch.bfloat16
    jroutes = _jax_routes(jparams, jcfg, toks)
    assert len(jroutes) == len(idx) == tcfg.n_layers
    rows_ok = np.ones(B, bool)
    for p, i, j in zip(probs, idx, jroutes):
        differ = (i.numpy() != j).any(-1)
        top = p.sort(-1, descending=True).values[:, :tcfg.top_k + 1]
        gaps = (top[:, :-1] - top[:, 1:]).min(-1).values.numpy()
        assert (gaps[differ] < 0.02).all(), gaps[differ]
        rows_ok &= ~differ.reshape(B, P).any(-1)
    assert rows_ok.any()
    np.testing.assert_allclose(_np(out)[rows_ok], _np(ref)[rows_ok],
                               **BF16_TOL)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_moe_route_and_dispatch_equal_jax_slot_for_slot(capacity_factor):
    """Experts, capacity positions and kept slots are equal to the JAX
    router's (0.5 drops slots at capacity), and the MoE FFN output agrees."""
    jcfg, tcfg, jparams, tparams, _ = _model("moonshot-v1-16b-a3b")
    jcfg = jcfg.with_(capacity_factor=capacity_factor)
    tcfg = tcfg.with_(capacity_factor=capacity_factor)
    x = np.random.default_rng(3).standard_normal((3, 40, 128)).astype(
        np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["ffn"])
    tp = T.tree_map(lambda t: t[0], tparams["layers"]["ffn"])
    jw, je, jpos, jkeep, jC = JT._moe_route(jp["router"]["kernel"], jcfg,
                                            jnp.asarray(x))
    tw, te, tpos, tkeep, tC = T._moe_route(tp["router"]["kernel"], tcfg,
                                           torch.from_numpy(x))
    assert tC == jC
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert (not tkeep.all()) == (capacity_factor < 1)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        _np(T.moe_apply(tp, tcfg, torch.from_numpy(x))),
        _np(JT.moe_apply(jp, jcfg, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("arch", ["mamba2-130m", "moonshot-v1-16b-a3b",
                                  "jamba-v0.1-52b"])
def test_prefill_then_decode_equals_forward(arch):
    """Token-by-token decode from an empty cache, and a prefill of the
    first half then decode of the rest, reproduce the forward's logits
    (MoE with a capacity that drops nothing, as a one-token step never
    drops)."""
    _, tcfg, _, tparams, toks = _model(arch)
    if tcfg.n_experts:
        tcfg = tcfg.with_(capacity_factor=tcfg.n_experts / tcfg.top_k)
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
        splice(cache[name], pcache[name])
    steps = [logits] + [api.decode_step(tparams, tcfg,
                                        {"tokens": t[:, i:i + 1]}, cache,
                                        i)[0] for i in range(h, P)]
    np.testing.assert_allclose(_np(torch.cat(steps, 1)), _np(full[:, h - 1:]),
                               **TOL)


def test_splice_copies_whole_leaves_or_the_leading_corner():
    dst = torch.zeros(2, 3, 5, 4)
    src = torch.arange(2 * 3 * 2 * 4, dtype=torch.float32).view(2, 3, 2, 4)
    splice(dst, src)
    torch.testing.assert_close(dst[:, :, :2], src)
    assert not dst[:, :, 2:].any()
    same = torch.zeros(2, 3, 2, 4)
    splice(same, src)
    torch.testing.assert_close(same, src)


def test_hybrid_short_prompt_over_a_wide_batch_serves_like_jax():
    """Batch 4, prompt 2: the hybrid's conv and state leaves carry the batch
    on axis 2 and a 2-token prompt leaves a conv window shorter than k−1.
    A splice of axis 2 by the prompt length (the dense family's) breaks
    here; the shape-driven splice equals the JAX loop's zero padding."""
    from repro.configs.archs import tiny_version as j_tiny
    from repro.configs.base import get_config as j_get_config
    arch, Bw, Pw, gen = "jamba-v0.1-52b", 4, 2, 5
    jcfg = j_tiny(j_get_config(arch))
    jparams = japi.init(jax.random.key(1), jcfg)
    tparams = lm_params_from_jax(jax.device_get(jparams))
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (Bw, Pw)
                                             ).astype(np.int32)
    cache = japi.init_cache(jcfg, Bw, Pw + gen)
    logits, pcache = japi.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    assert pcache["conv"].shape[2:4] == (Bw, Pw) != cache["conv"].shape[2:4]
    cache = jax.tree.map(
        lambda d, s: jnp.pad(s, [(0, a - b) for a, b in zip(d.shape, s.shape)]),
        cache, pcache)
    cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [np.asarray(cur)]
    for t in range(gen - 1):
        logits, cache = japi.decode_step(jparams, jcfg, {"tokens": cur}, cache,
                                         jnp.int32(Pw + t))
        cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want.append(np.asarray(cur))
    res = greedy_decode(tparams, tiny_version(get_config(arch)),
                        torch.from_numpy(toks), gen)
    np.testing.assert_array_equal(res.tokens, np.concatenate(want, axis=1))


@pytest.mark.parametrize("arch", ["mamba2-130m", "moonshot-v1-16b-a3b",
                                  "jamba-v0.1-52b"])
def test_lm_params_from_jax_carries_the_trees_bit_for_bit(arch):
    """bf16 leaves bit for bit, the fp32 router, A_log, D and dt_bias as
    fp32, and the key structure (``periods``/``sub{i}``) as it is."""
    jcfg, tcfg, jparams, tparams, _ = _model(arch, "bfloat16")
    tree = jax.device_get(jparams)
    jl = jax.tree.leaves(tree)
    tl = tree_leaves(tparams)
    assert len(jl) == len(tl)
    for a, t in zip(jl, tl):
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape
        if a.dtype == np.float32:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), a)
        else:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16), a.view(np.uint16))
    fp32 = [t for t in tl if t.dtype == torch.float32]
    assert fp32, "the fp32 leaves (router, A_log, D, dt_bias) are kept"
    port_init = api.init(torch.Generator().manual_seed(0), tcfg)
    assert sorted(map(lambda t: (tuple(t.shape), t.dtype == torch.float32),
                      tree_leaves(port_init))) == sorted(
        map(lambda t: (tuple(t.shape), t.dtype == torch.float32), tl))


def test_stack_init_draws_what_stack_trees_draws():
    """The one-layer-at-a-time stack holds the same values, in the same
    generator order, as stacking all layers' trees at once."""
    cfg = tiny_version(get_config("moonshot-v1-16b-a3b"))
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    a = stack_init(3, lambda: T.block_init(g1, cfg))
    b = stack_trees([T.block_init(g2, cfg) for _ in range(3)])
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    one = stack_init(1, lambda: {"w": torch.ones(2)})
    assert one["w"].shape == (1, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_serves_the_family_on_the_cpu(arch):
    res = generate(arch, tiny=True, prompt_len=8, gen=4, batch=2,
                   device="cpu", verbose=False)
    assert res.tokens.shape == (2, 4) and res.prefill_ms > 0
