"""The port's VLM family (``qwen2-vl-7b``) against the JAX package's.

A tiny fp32 ``qwen2-vl-7b`` (``tiny_version``: 2 layers, d_model 128, 4
query heads padded to 32 over 2 kv heads, head_dim 32, M-RoPE sections
(4, 6, 6)), weights drawn by the JAX package and carried by
``lm_params_from_jax``. Precomputed patch embeddings replace the tokens,
and the positions are three distinct streams: a temporal stream held
fixed, height and width over a grid (with three equal streams M-RoPE is
plain RoPE and the sections go untested). Forward, prefill (logits and
cache) and 8 greedy decode steps within 1e-4 of ``repro.models.api``
(fp32; sums in other orders); the loss and every gradient leaf within
rtol 1e-4 / atol 1e-6 of ``jax.value_and_grad(repro.models.api.loss)``,
the padded heads' ``wo`` slices nonzero and ``embed``'s zero as there; two
``make_train_step`` steps within one step's learning rate of the
reference's (Adam's first steps move an entry by about the learning rate,
so one with a gradient near 0 may move either way); ``run`` lowers the
loss and a resume is bit-equal to the straight run.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import tiny_version as jtiny  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.archs import tiny_version  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.serve import generate, greedy_decode  # noqa: E402
from repro_torch.launch.train import embed_batch, run  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_train import _batches, _same  # noqa: E402

ARCH = "qwen2-vl-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
B, P, GEN = 2, 12, 9                  # prompt P, then GEN - 1 = 8 decode steps


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for PyTorch while these tests run: tier-1 runs
    six workers over the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def grid_positions(batch, seq, width=4, t=3):
    """(3, batch, seq) int32 streams: temporal ``t`` for every patch,
    height and width over a grid ``width`` patches wide (row ``b`` offset
    by ``b`` rows)."""
    i = np.arange(seq)[None] + width * np.arange(batch)[:, None]
    return np.stack([np.full((batch, seq), t), i // width, i % width]
                    ).astype(np.int32)


@functools.cache
def _model(seed=0):
    """(JAX cfg, port cfg, JAX params, port params, embeds, positions)."""
    jcfg, tcfg = jtiny(jget(ARCH)), tiny_version(get_config(ARCH))
    jp = japi.init(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(3 + seed)
    emb = (rng.standard_normal((B, P, jcfg.d_model)) * 0.02).astype(np.float32)
    return (jcfg, tcfg, jp, lm_params_from_jax(jax.device_get(jp)), emb,
            grid_positions(B, P))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def test_tiny_config_pads_four_heads_to_thirty_two():
    _, tcfg, jp, tp, _, _ = _model()
    assert (tcfg.n_heads, tcfg.heads_padded, tcfg.n_kv_heads) == (4, 32, 2)
    wo = tp["layers"]["attn"]["wo"]
    assert wo.shape == (2, 32, 32, 128)
    assert float(wo[:, 4:].abs().sum()) == 0 and float(wo[:, :4].abs().sum()) > 0
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    g = torch.Generator().manual_seed(0)
    own = api.init(g, tcfg)["layers"]["attn"]["wo"]
    assert own.shape == wo.shape and float(own[:, 4:].abs().sum()) == 0


@pytest.mark.parametrize("sections,hd", [((4, 6, 6), 32), ((16, 24, 24), 128)],
                         ids=["tiny", "published"])
def test_mrope_matches_jax_on_distinct_streams(sections, hd):
    rng = np.random.default_rng(hd)
    S = 24
    x = rng.standard_normal((2, S, 3, hd)).astype(np.float32)
    pos = grid_positions(2, S, width=6)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                          sections=sections, theta=1e4)
    got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                         sections=sections, theta=1e4)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    plain = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[1]))
    assert float((got - plain).abs().max()) > 0.1   # the streams differ
    with pytest.raises(ValueError, match="sum"):
        TL.mrope_table(torch.from_numpy(pos), hd + 2, sections=sections)


def test_rope_table_of_equal_streams_is_plain_rope():
    _, tcfg, *_ = _model()
    pos = T.default_positions(tcfg, 2, 7, offset=5)
    assert pos.shape == (3, 2, 7)
    cos, sin = T.rope_table(tcfg, pos)
    ref = TL.rope_table(pos[0], tcfg.head_dim, theta=tcfg.rope_theta)
    assert torch.equal(cos, ref[0]) and torch.equal(sin, ref[1])
    tpos = T.default_positions(tcfg, 2, 1, offset=torch.tensor([5]))
    assert torch.equal(tpos, T.default_positions(tcfg, 2, 1, offset=5))


def test_forward_with_embeddings_matches_jax():
    jcfg, tcfg, jp, tp, emb, pos = _model()
    want = japi.forward(jp, jcfg, {"embeds": jnp.asarray(emb),
                                   "positions": jnp.asarray(pos)})
    got = api.forward(tp, tcfg, {"embeds": torch.from_numpy(emb),
                                 "positions": torch.from_numpy(pos)})
    assert got.shape == (B, P, tcfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_dense_forward_takes_embeddings():
    """``embeds`` replace the token embedding in every transformer family,
    as in the reference (here a dense config)."""
    jcfg, tcfg = jtiny(jget("llama3.2-1b")), tiny_version(
        get_config("llama3.2-1b"))
    jp = japi.init(jax.random.key(1), jcfg)
    tp = lm_params_from_jax(jax.device_get(jp))
    emb = np.random.default_rng(1).standard_normal(
        (B, P, jcfg.d_model)).astype(np.float32)
    want = japi.forward(jp, jcfg, {"tokens": None, "embeds": jnp.asarray(emb)})
    got = api.forward(tp, tcfg, {"tokens": None,
                                 "embeds": torch.from_numpy(emb)})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _jax_serve(jcfg, jp, emb, pos):
    """The reference serve loop (``launch/serve.py:generate``) on the given
    params and prompt: prefill, the cache zero-padded to P + GEN, argmax,
    GEN - 1 decode steps at P + t."""
    prefill = jax.jit(lambda p, b: japi.prefill(p, jcfg, b))
    decode = jax.jit(lambda p, b, c, i: japi.decode_step(p, jcfg, b, c, i))
    logits, pcache = prefill(jp, {"embeds": jnp.asarray(emb),
                                  "positions": jnp.asarray(pos)})
    cache = jax.tree.map(
        lambda d, s: jnp.pad(s, [(0, a - b) for a, b in zip(d.shape, s.shape)]),
        japi.init_cache(jcfg, B, P + GEN), pcache)
    cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    toks, steps = [np.asarray(cur)], [logits[:, -1]]
    for t in range(GEN - 1):
        logits, cache = decode(jp, {"tokens": cur}, cache, jnp.int32(P + t))
        cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(cur))
        steps.append(logits[:, -1])
    return pcache, np.concatenate(toks, axis=1), steps


def test_prefill_and_decode_steps_match_jax():
    jcfg, tcfg, jp, tp, emb, pos = _model()
    jcache, jtok, jsteps = _jax_serve(jcfg, jp, emb, pos)
    _, tcache = api.prefill(tp, tcfg, {"embeds": torch.from_numpy(emb),
                                       "positions": torch.from_numpy(pos)})
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   **TOL)
    res = greedy_decode(tp, tcfg, None, GEN, embeds=torch.from_numpy(emb),
                        positions=torch.from_numpy(pos), keep_logits=True)
    np.testing.assert_array_equal(res.tokens, jtok)
    assert len(res.logits) == GEN
    for a, b in zip(res.logits, jsteps):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_decode_step_takes_a_tensor_index():
    _, tcfg, _, tp, emb, pos = _model()
    _, pcache = api.prefill(tp, tcfg, {"embeds": torch.from_numpy(emb),
                                       "positions": torch.from_numpy(pos)})
    tok = torch.tensor([[5], [9]])
    out = []
    for index in (P, torch.tensor(P, dtype=torch.int32)):
        cache = api.init_cache(tcfg, B, P + 1, device="cpu")
        for name in cache:
            cache[name][:, :, :P] = pcache[name]
        out.append(api.decode_step(tp, tcfg, {"tokens": tok}, cache, index)[0])
    assert torch.equal(out[0], out[1])


def test_loss_and_gradients_match_jax():
    """Every leaf, the padded heads' ``wo`` slices getting nonzero
    gradients (nothing masks them, in either package) and ``embed`` a zero
    one (the embeddings replace the tokens)."""
    jcfg, tcfg, jp, tp, emb, pos = _model()
    labels = np.random.default_rng(4).integers(0, jcfg.vocab, (B, P)
                                               ).astype(np.int32)
    jb = {"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos),
          "labels": jnp.asarray(labels)}
    tb = {"embeds": torch.from_numpy(emb), "positions": torch.from_numpy(pos),
          "labels": torch.from_numpy(labels)}
    jloss, jg = jax.value_and_grad(
        lambda p: japi.loss(p, jcfg, jb, train=True))(jp)
    tloss, tg = ST.loss_and_grads(tp, tcfg, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), **GRAD_TOL)
    jl, tl = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jl) == len(tl) == 11
    for a, b in zip(tl, jl):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)
    assert float(tg["embed"]["embedding"].abs().sum()) == 0
    assert float(np.abs(np.asarray(jg["embed"]["embedding"])).sum()) == 0
    pad = tg["layers"]["attn"]["wo"][:, 4:]
    assert float(pad.abs().max()) > 0.01


def test_train_steps_match_jax_make_train_step():
    jcfg, tcfg, jp, tp, _, _ = _model(1)
    tp = tree_map(torch.clone, tp)            # the step updates in place
    embed0 = tp["embed"]["embedding"].clone()
    jopt, topt = JA.AdamWConfig(warmup_steps=2), TA.AdamWConfig(
        warmup_steps=2)
    jstate = JST.TrainState(jp, JA.init(jopt, jp))
    tstate = ST.TrainState(tp, TA.init(topt, tp))
    jstep, tstep = JST.make_train_step(jcfg, jopt), \
        ST.make_train_step(tcfg, topt)
    rng = np.random.default_rng(8)
    for jb, tb in _batches(jcfg.vocab, 2, seed=1, batch=B, seq=P):
        emb = (rng.standard_normal((B, P, jcfg.d_model)) * 0.02
               ).astype(np.float32)
        jb = {"embeds": jnp.asarray(emb), "labels": jb["labels"]}
        tb = {"embeds": torch.from_numpy(emb), "labels": tb["labels"]}
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
        lr = float(jm["lr"])
        for a, b in zip(tree_leaves(tstate.params),
                        jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=2 * lr)
    # AdamW decays the untouched embedding table all the same
    assert not torch.equal(tstate.params["embed"]["embedding"], embed0)


def test_generate_serves_the_vlm():
    res = generate(ARCH, prompt_len=8, gen=4, batch=2, device="cpu",
                   verbose=False, keep_logits=True)
    assert res.tokens.shape == (2, 4)
    assert all(bool(torch.isfinite(x).all()) for x in res.logits)


def test_embed_batches_depend_on_seed_and_step_alone():
    tcfg = tiny_version(get_config(ARCH))
    cpu = torch.device("cpu")
    a = embed_batch(tcfg, 2, 8, 0, 3, cpu)
    assert a.shape == (2, 8, tcfg.d_model) and a.dtype == tcfg.compute_dtype
    assert torch.equal(a, embed_batch(tcfg, 2, 8, 0, 3, cpu))
    assert not torch.equal(a, embed_batch(tcfg, 2, 8, 0, 4, cpu))
    assert not torch.equal(a, embed_batch(tcfg, 2, 8, 1, 3, cpu))
    assert 0.01 < float(a.std()) < 0.03


def test_run_lowers_the_loss_and_resumes_bit_equal(tmp_path):
    """Six steps straight with checkpoints every 3, against the step-3
    checkpoint restored and stepped to 6 on the same token and embedding
    batches (the schedule of the six-step run)."""
    kw = dict(steps=6, batch=2, seq=16, lr=3e-3, verbose=False,
              device="cpu", seed=2)
    state, losses = run(ARCH, ckpt_dir=str(tmp_path), ckpt_every=3, **kw)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    tcfg = tiny_version(get_config(ARCH))
    opt = TA.AdamWConfig(lr=3e-3, total_steps=6, warmup_steps=1)
    resumed = CheckpointManager(str(tmp_path)).restore(3, state)
    step = ST.make_train_step(tcfg, opt)
    for i, (_, tb) in enumerate(_batches(tcfg.vocab, 6, seed=2, batch=2,
                                         seq=16)[3:]):
        tb["embeds"] = embed_batch(tcfg, 2, 16, 2, 3 + i, torch.device("cpu"))
        resumed, _ = step(resumed, tb)
    assert _same(resumed, state)
