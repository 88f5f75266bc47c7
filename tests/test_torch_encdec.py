"""The port's enc-dec family (``whisper-medium``) against the JAX package's.

A tiny fp32 ``whisper-medium`` (``tiny_version``: 2 encoder and 2 decoder
layers, d_model 128, 4 heads over 2 kv heads, head_dim 32, LayerNorm,
GELU, sinusoidal positions), weights drawn by the JAX package and carried
by ``lm_params_from_jax``. The encoder reads S_ENC = 20 frames and the
decoder S_DEC = 12 tokens, so cross-attention is Sq != Skv. Positions,
encoder, teacher-forced decoder and forward within 1e-4 of
``repro.models.encdec`` (fp32; sums in other orders); prefill (logits and
the four caches) and 8 greedy decode steps against the reference's
``encdec_decode_step`` given a cross cache of the encoder's length, and
against the teacher-forced forward; the loss and every gradient leaf
within rtol 1e-4 / atol 1e-6 of ``jax.value_and_grad(repro.models.api
.loss)``; two ``make_train_step`` steps within one step's learning rate
of the reference's; ``run`` lowers the loss, resumes from a checkpoint
bit-equal, and a JAX train state crosses by ``train_state_from_jax``.

One test records a quirk of the reference: its ``generate`` zero-pads the
cross cache to the decode length, and its unmasked cross-attention then
attends to the padding, so its decode logits differ from the exact ones;
the port's cross cache holds the encoder's rows alone.
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
from repro.models import encdec as JED  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.archs import tiny_version  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import (lm_params_from_jax,  # noqa: E402
                                 train_state_from_jax)
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.serve import generate, greedy_decode  # noqa: E402
from repro_torch.launch.train import embed_batch, run  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_train import _batches, _same  # noqa: E402

ARCH = "whisper-medium"
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
B, S_ENC, S_DEC, GEN = 2, 20, 12, 9   # GEN - 1 = 8 decode steps


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for PyTorch while these tests run: tier-1 runs
    six workers over the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _model(seed=0):
    """(JAX cfg, port cfg, JAX params, port params, frames, tokens)."""
    jcfg, tcfg = jtiny(jget(ARCH)), tiny_version(get_config(ARCH))
    jp = japi.init(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(5 + seed)
    frames = rng.standard_normal((B, S_ENC, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, (B, S_DEC)).astype(np.int32)
    return jcfg, tcfg, jp, lm_params_from_jax(jax.device_get(jp)), frames, \
        toks


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def test_tree_matches_the_reference():
    _, tcfg, jp, tp, _, _ = _model()
    assert sorted(tp) == sorted(jp) == ["dec_layers", "dec_norm", "embed",
                                        "enc_layers", "enc_norm", "lm_head"]
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    own = api.init(torch.Generator().manual_seed(0), tcfg)
    assert [t.shape for t in tree_leaves(own)] == \
        [tuple(b.shape) for b in jax.tree.leaves(jp)]


@pytest.mark.parametrize("offset", [0, 7, "tensor"])
def test_sincos_positions_match_jax(offset):
    want = JED.sincos_positions(5, 128, offset=7 if offset == "tensor"
                                else offset)
    off = torch.tensor([7]) if offset == "tensor" else offset
    got = ED.sincos_positions(5, 128, off)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_encode_decode_and_forward_match_jax():
    jcfg, tcfg, jp, tp, frames, toks = _model()
    jenc = JED.encode(jp, jcfg, jnp.asarray(frames))
    tenc = ED.encode(tp, tcfg, torch.from_numpy(frames))
    assert tenc.shape == (B, S_ENC, tcfg.d_model)
    np.testing.assert_allclose(_np(tenc), _np(jenc), **TOL)
    jdec = JED.decode_train(jp, jcfg, jnp.asarray(toks), jenc)
    tdec = ED.decode_train(tp, tcfg, torch.from_numpy(toks),
                           torch.from_numpy(np.array(jenc)))
    np.testing.assert_allclose(_np(tdec), _np(jdec), **TOL)
    want = japi.forward(jp, jcfg, {"tokens": jnp.asarray(toks),
                                   "embeds": jnp.asarray(frames)})
    got = api.forward(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                 "embeds": torch.from_numpy(frames)})
    assert got.shape == (B, S_DEC, tcfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _jax_decode(cross_rows):
    """The reference's prefill, then its ``encdec_decode_step`` for GEN - 1
    greedy steps over a self cache zero-padded to S_DEC + GEN and a cross
    cache of ``cross_rows`` rows (the prefill's S_ENC, or zero-padded to
    S_DEC + GEN as its ``generate`` splices it). Returns (prefill cache,
    tokens, each step's logits)."""
    jcfg, _, jp, _, frames, toks = _model()
    max_len = S_DEC + GEN
    logits, pc = jax.jit(lambda p, b: japi.prefill(p, jcfg, b))(
        jp, {"tokens": jnp.asarray(toks), "embeds": jnp.asarray(frames)})

    def pad(x, n):
        return jnp.pad(x, [(0, 0), (0, 0), (0, n - x.shape[2]), (0, 0),
                           (0, 0)])
    cache = {"k": pad(pc["k"], max_len), "v": pad(pc["v"], max_len),
             "ck": pad(pc["ck"], cross_rows), "cv": pad(pc["cv"], cross_rows)}
    step = jax.jit(lambda p, b, c, i: japi.decode_step(p, jcfg, b, c, i))
    cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out, steps = [np.asarray(cur)], [logits[:, -1]]
    for t in range(GEN - 1):
        logits, cache = step(jp, {"tokens": cur}, cache, jnp.int32(S_DEC + t))
        cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out.append(np.asarray(cur))
        steps.append(logits[:, -1])
    return pc, np.concatenate(out, axis=1), steps


def _port_decode():
    _, tcfg, _, tp, frames, toks = _model()
    return greedy_decode(tp, tcfg, torch.from_numpy(toks), GEN,
                         embeds=torch.from_numpy(frames), keep_logits=True)


def test_prefill_cache_matches_jax():
    _, tcfg, _, tp, frames, toks = _model()
    jc, _, _ = _jax_decode(S_ENC)
    logits, tc = api.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                        "embeds": torch.from_numpy(frames)})
    assert logits.shape == (B, 1, tcfg.vocab)
    assert tc["k"].shape == (2, B, S_DEC, 2, 32)
    assert tc["ck"].shape == (2, B, S_ENC, 2, 32)
    for name in ("k", "v", "ck", "cv"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **TOL)


def test_decode_steps_match_jax_with_an_exact_cross_cache():
    _, jtok, jsteps = _jax_decode(S_ENC)
    res = _port_decode()
    np.testing.assert_array_equal(res.tokens, jtok)
    for a, b in zip(res.logits, jsteps):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_decode_steps_equal_the_teacher_forced_forward():
    _, tcfg, _, tp, frames, toks = _model()
    res = _port_decode()
    seq = np.concatenate([toks, res.tokens[:, :-1]], axis=1)
    full = api.forward(tp, tcfg, {"tokens": torch.from_numpy(seq),
                                  "embeds": torch.from_numpy(frames)})
    for t, step in enumerate(res.logits):
        np.testing.assert_allclose(_np(step), _np(full[:, S_DEC - 1 + t]),
                                   **TOL)


def test_reference_generate_attends_to_its_zero_padded_cross_cache():
    """The reference's ``generate`` splices the cross cache into a
    S_DEC + GEN-row cache; its unmasked cross-attention then also reads
    the zero rows, and its decode logits move by far more than rounding.
    The port keeps the encoder's rows alone and equals the exact cache."""
    _, _, exact = _jax_decode(S_ENC)
    _, _, padded = _jax_decode(S_DEC + GEN)
    gap = max(float(np.abs(_np(a) - _np(b)).max())
              for a, b in zip(padded[1:], exact[1:]))
    assert gap > 1e-2
    res = _port_decode()
    for a, b in zip(res.logits[1:], exact[1:]):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_init_cache_sizes_the_cross_cache():
    tcfg = tiny_version(get_config(ARCH))
    c = api.init_cache(tcfg, 2, 30, enc_len=7, device="cpu")
    assert c["k"].shape[2] == 30 and c["ck"].shape[2] == 7
    assert api.init_cache(tcfg, 2, 30, device="cpu")["ck"].shape[2] == 30
    with pytest.raises(ValueError, match="enc_len"):
        api.init_cache(tiny_version(get_config("llama3.2-1b")), 2, 30,
                       enc_len=7, device="cpu")


def test_prefill_cross_matches_jax():
    jcfg, tcfg, jp, tp, frames, _ = _model()
    jenc = JED.encode(jp, jcfg, jnp.asarray(frames))
    jc = JED.encdec_prefill_cross(jp, jcfg, jenc,
                                  JED.encdec_init_cache(jcfg, B, S_ENC))
    tc = ED.encdec_prefill_cross(tp, tcfg, torch.from_numpy(np.array(jenc)),
                                 api.init_cache(tcfg, B, S_ENC, device="cpu"))
    for name in ("ck", "cv"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **TOL)


def test_loss_and_gradients_match_jax():
    jcfg, tcfg, jp, tp, frames, toks = _model()
    labels = np.random.default_rng(6).integers(0, jcfg.vocab, (B, S_DEC)
                                               ).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "embeds": jnp.asarray(frames),
          "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "embeds": torch.from_numpy(frames),
          "labels": torch.from_numpy(labels)}
    jloss, jg = jax.value_and_grad(
        lambda p: japi.loss(p, jcfg, jb, train=True))(jp)
    tloss, tg = ST.loss_and_grads(tp, tcfg, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), **GRAD_TOL)
    jl, tl = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jl) == len(tl) == 36
    for a, b in zip(tl, jl):
        assert a.shape == b.shape and float(a.abs().sum()) > 0
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_train_steps_match_jax_make_train_step():
    jcfg, tcfg, jp, tp, _, _ = _model(1)
    tp = tree_map(torch.clone, tp)            # the step updates in place
    jopt, topt = JA.AdamWConfig(warmup_steps=2), TA.AdamWConfig(
        warmup_steps=2)
    jstate = JST.TrainState(jp, JA.init(jopt, jp))
    tstate = ST.TrainState(tp, TA.init(topt, tp))
    jstep, tstep = JST.make_train_step(jcfg, jopt), \
        ST.make_train_step(tcfg, topt)
    rng = np.random.default_rng(9)
    for jb, tb in _batches(jcfg.vocab, 2, seed=1, batch=B, seq=S_DEC):
        frames = (rng.standard_normal((B, S_ENC, jcfg.d_model)) * 0.02
                  ).astype(np.float32)
        jb["embeds"], tb["embeds"] = jnp.asarray(frames), \
            torch.from_numpy(frames)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
        lr = float(jm["lr"])
        for a, b in zip(tree_leaves(tstate.params),
                        jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=2 * lr)


def test_generate_serves_the_encdec_with_other_encoder_lengths():
    for frames in (None, 24):
        res = generate(ARCH, prompt_len=8, gen=4, batch=2, device="cpu",
                       verbose=False, keep_logits=True, frames=frames)
        assert res.tokens.shape == (2, 4)
        assert all(bool(torch.isfinite(x).all()) for x in res.logits)


def _stepped(tcfg, state, total, first, n, seed):
    """``state`` stepped ``n`` times by ``make_train_step`` (the schedule
    of a ``total``-step run) on the token and embedding batches ``run``
    draws for global steps ``first`` … ``first + n - 1``."""
    step = ST.make_train_step(tcfg, TA.AdamWConfig(lr=3e-3, total_steps=total,
                                                   warmup_steps=1))
    batches = _batches(tcfg.vocab, first + n, seed=seed, batch=2, seq=16)
    for i, (_, tb) in enumerate(batches[first:]):
        tb["embeds"] = embed_batch(tcfg, 2, 16, seed, first + i,
                                   torch.device("cpu"))
        state, _ = step(state, tb)
    return state


def test_run_lowers_the_loss_and_resumes_bit_equal(tmp_path):
    """Six steps with checkpoints every 3: the step-3 checkpoint stepped to
    6 on the batches ``run`` draws is bit-equal to the run's state. And
    ``run`` resumed from a step-3 checkpoint for 2 more steps (its own
    schedule: a resumed run's ``total_steps`` is the call's) is bit-equal
    to the step function from that checkpoint on steps 3 and 4's
    batches."""
    tcfg = tiny_version(get_config(ARCH))
    kw = dict(batch=2, seq=16, lr=3e-3, verbose=False, device="cpu", seed=4)
    state, losses = run(ARCH, steps=6, ckpt_dir=str(tmp_path / "a"),
                        ckpt_every=3, **kw)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    start = CheckpointManager(str(tmp_path / "a")).restore(3, state)
    assert _same(_stepped(tcfg, start, 6, 3, 3, 4), state)

    d = str(tmp_path / "b")
    three, _ = run(ARCH, steps=3, ckpt_dir=d, ckpt_every=3, **kw)
    resumed, _ = run(ARCH, steps=2, ckpt_dir=d, ckpt_every=50, resume=True,
                     **kw)
    twin = CheckpointManager(d).restore(3, three)
    assert int(resumed.opt.step) == 5
    assert _same(resumed, _stepped(tcfg, twin, 2, 3, 2, 4))


def test_train_state_from_jax_round_trip():
    jcfg, tcfg, jp, _, _, _ = _model()
    jopt = JA.AdamWConfig()
    jstate = JST.TrainState(jp, JA.init(jopt, jp))
    tstate = train_state_from_jax(jax.device_get(jstate))
    assert int(tstate.opt.step) == 0
    for tree_t, tree_j in ((tstate.params, jstate.params),
                           (tstate.opt.master, jstate.opt.master),
                           (tstate.opt.m, jstate.opt.m)):
        tl, jl = tree_leaves(tree_t), jax.tree.leaves(tree_j)
        assert len(tl) == len(jl) == 36
        for a, b in zip(tl, jl):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    loss, _ = ST.loss_and_grads(
        tstate.params, tcfg,
        {"tokens": torch.zeros((1, 4), dtype=torch.long),
         "embeds": torch.zeros((1, 6, tcfg.d_model)),
         "labels": torch.zeros((1, 4), dtype=torch.long)})
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", ARCH])
def test_entry_points_run_on_the_card_unless_asked(arch, monkeypatch):
    """Without ``device="cpu"`` the two families' entry points go to the
    card, and with none present they raise rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_version(get_config(arch))
    for call in (lambda: generate(arch, verbose=False),
                 lambda: run(arch, steps=1, verbose=False),
                 lambda: api.init_cache(cfg, 1, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
