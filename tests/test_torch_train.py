"""The port's LM trainer against the JAX package's: the train step, the
driver and the checkpoints.

A tiny fp32 ``llama3.2-1b`` (2 layers, weights drawn by the JAX package
and carried by ``lm_params_from_jax``): one step's loss and gradients
within 1e-5 of ``jax.value_and_grad`` of ``repro.models.api.loss`` and the
state after ``repro.launch.steps.make_train_step`` within one step's
learning rate (Adam's first step is ``sign(g)·lr``: entries with |g| near
0 may take either sign); five steps' losses within a band. ``run`` lowers
the loss as ``tests/test_system.py`` asks of the reference and a rerun is
bit-equal. Checkpoints round-trip bit for bit, keep the last N, snapshot
at the call (the optimiser updates in place), resume bit-equal through the
step function, and cross between the packages: a JAX-written checkpoint
(fp32 and bf16) is restored by the port, a port-written fp32 one by the
JAX package (its ``restore`` cannot cast bf16 leaves written as 2-byte
voids, its own included).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt.checkpoint import CheckpointManager as JCM  # noqa: E402
from repro.configs.archs import tiny_version as jtiny  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.data.tokens import SyntheticTokens as JTokens  # noqa: E402
from repro.data.tokens import TokenTaskConfig as JTaskCfg  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.ckpt.checkpoint import (CheckpointManager,  # noqa: E402
                                         flatten_with_keys)
from repro_torch.configs.archs import tiny_version  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import (lm_params_from_jax,  # noqa: E402
                                 train_state_from_jax)
from repro_torch.data.tokens import SyntheticTokens  # noqa: E402
from repro_torch.data.tokens import TokenTaskConfig  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "llama3.2-1b"
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for PyTorch while these tests run: tier-1 runs
    six workers over the machine's cores, and the small CPU ops of eager
    training would otherwise spin against each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return jtiny(jget(ARCH)), tiny_version(get_config(ARCH))


def _batches(vocab, n, seed=0, batch=4, seq=32):
    data = JTokens(JTaskCfg(vocab=vocab, seq_len=seq, seed=seed))
    tdata = SyntheticTokens(TokenTaskConfig(vocab=vocab, seq_len=seq,
                                            seed=seed))
    out = []
    for (jt, jl), (tt, tl) in zip(data.epoch(batch, n), tdata.epoch(batch, n)):
        np.testing.assert_array_equal(jt, tt)
        np.testing.assert_array_equal(jl, tl)
        out.append(({"tokens": jnp.asarray(jt), "labels": jnp.asarray(jl)},
                    {"tokens": torch.from_numpy(tt),
                     "labels": torch.from_numpy(tl)}))
    return out


def _carried(seed=0):
    jcfg, tcfg = _cfgs()
    jp = japi.init(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp, lm_params_from_jax(jax.device_get(jp))


def test_synthetic_token_batches_equal_the_reference():
    _batches(512, 3, seed=4, batch=3, seq=17)


def test_one_step_loss_and_gradients_match_jax():
    jcfg, tcfg, jp, tp = _carried()
    (jb, tb), = _batches(jcfg.vocab, 1)
    jloss, jg = jax.value_and_grad(
        lambda p: japi.loss(p, jcfg, jb, train=True))(jp)
    before = [t.clone() for t in tree_leaves(tp)]
    tloss, tg = ST.loss_and_grads(tp, tcfg, tb)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(tp)))
    assert not any(t.requires_grad for t in tree_leaves(tp))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    jl, tl = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jl) == len(tl) == 11
    for a, b in zip(tl, jl):
        assert a.shape == b.shape and float(a.abs().sum()) > 0
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_train_step_matches_jax_make_train_step():
    jcfg, tcfg, jp, tp = _carried(1)
    jopt, topt = JA.AdamWConfig(warmup_steps=2), TA.AdamWConfig(
        warmup_steps=2)
    jstate = JST.TrainState(jp, JA.init(jopt, jp))
    tstate = ST.TrainState(tp, TA.init(topt, tp))
    jstep, tstep = JST.make_train_step(jcfg, jopt), \
        ST.make_train_step(tcfg, topt)
    for jb, tb in _batches(jcfg.vocab, 2, seed=1):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
        lr = float(jm["lr"])
        for a, b in zip(tree_leaves(tstate.params),
                        jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=2 * lr)
    assert int(tstate.opt.step) == int(jstate.opt.step) == 2


def test_five_steps_losses_in_a_band():
    jcfg, tcfg, jp, tp = _carried(2)
    jopt = JA.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=5)
    topt = TA.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=5)
    jstate = JST.TrainState(jp, JA.init(jopt, jp))
    tstate = ST.TrainState(tp, TA.init(topt, tp))
    jstep, tstep = JST.make_train_step(jcfg, jopt), \
        ST.make_train_step(tcfg, topt)
    jl, tl = [], []
    for jb, tb in _batches(jcfg.vocab, 5, seed=2):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]


def test_run_lowers_the_loss_and_reruns_bit_equal():
    state, losses = run("tinyllama-1.1b", tiny=True, steps=15, batch=4,
                        seq=64, verbose=False, device="cpu")
    assert losses[-1] < losses[0] - 0.3
    state2, losses2 = run("tinyllama-1.1b", tiny=True, steps=15, batch=4,
                          seq=64, verbose=False, device="cpu")
    assert losses == losses2
    assert _same(state, state2)


def test_run_with_compression_converges():
    _, losses = run("tinyllama-1.1b", tiny=True, steps=15, batch=4, seq=64,
                    compression="int8", verbose=False, device="cpu")
    assert losses[-1] < losses[0]


def test_run_checkpoints_and_resumes(tmp_path):
    """Saves every ``ckpt_every`` steps, the last step once; a resumed run
    starts from the latest checkpoint's step."""
    d = str(tmp_path)
    run("tinyllama-1.1b", steps=4, batch=2, seq=16, ckpt_dir=d,
        ckpt_every=2, verbose=False, device="cpu", seed=3)
    mgr = CheckpointManager(d)
    assert mgr.all_steps() == [2, 4]
    state, losses = run("tinyllama-1.1b", steps=3, batch=2, seq=16,
                        ckpt_dir=d, ckpt_every=2, resume=True,
                        verbose=False, device="cpu", seed=3)
    assert int(state.opt.step) == 7 and len(losses) == 3
    assert mgr.all_steps() == [4, 6, 7]


# -- checkpoints ---------------------------------------------------------------------

def _state(dtype=torch.bfloat16, seed=0):
    _, tcfg = _cfgs()
    from repro_torch.models import api
    p = api.init(torch.Generator().manual_seed(seed),
                 tcfg.with_(param_dtype=dtype))
    return ST.TrainState(p, TA.init(TA.AdamWConfig(), p))


def _leaves(tree):
    """Every tensor of a tree, ``TrainState``/``OptState`` fields too."""
    return [v for _, v in flatten_with_keys(tree)]


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_checkpoint_roundtrip_exact(tmp_path, dtype):
    st = _state(dtype)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, st)
    back = mgr.restore(1, st)
    assert _same(back, st) and int(back.opt.step) == 0
    assert isinstance(back, ST.TrainState)
    man = (tmp_path / "step_1" / "manifest.json").read_text()
    assert "\".params['embed']['embedding']\"" in man
    assert "\".opt.step\"" in man


def test_checkpoint_keep_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.arange(4.0)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4


def test_async_save_snapshots_before_in_place_updates(tmp_path):
    st = _state(torch.float32)
    want = [t.clone() for t in _leaves(st)]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, st, blocking=False)
    with torch.no_grad():                 # what apply_updates does
        for t in _leaves(st):
            t.add_(1)
    mgr.wait()
    back = mgr.restore(5, st)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(back), want))


def test_resume_is_bit_equal_through_the_step_function(tmp_path):
    """Four steps straight, against two, a checkpoint, a restore into a
    fresh state, and two more: the same bits (one config throughout)."""
    _, tcfg = _cfgs()
    opt = TA.AdamWConfig(warmup_steps=1, total_steps=4)
    step = ST.make_train_step(tcfg, opt)
    batches = [b for _, b in _batches(tcfg.vocab, 4, seed=3)]
    a = _state(torch.float32, seed=3)
    for b in batches:
        a, _ = step(a, b)
    c = _state(torch.float32, seed=3)
    mgr = CheckpointManager(str(tmp_path))
    for b in batches[:2]:
        c, _ = step(c, b)
    mgr.save(2, c)
    c = mgr.restore(2, _state(torch.float32, seed=9))
    assert int(c.opt.step) == 2
    for b in batches[2:]:
        c, _ = step(c, b)
    assert _same(a, c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_written_checkpoint_restores_in_the_port(tmp_path, dtype):
    jcfg, _ = _cfgs()
    jcfg = jcfg.with_(param_dtype=getattr(jnp, dtype))
    jp = japi.init(jax.random.key(4), jcfg)
    jstate = JST.TrainState(jp, JA.init(JA.AdamWConfig(), jp))
    jstate, _ = JST.make_train_step(jcfg)(
        jstate, _batches(jcfg.vocab, 1, seed=4)[0][0])
    JCM(str(tmp_path)).save(7, jstate)
    want = train_state_from_jax(jax.device_get(jstate))
    target = _state(getattr(torch, dtype), seed=8)
    back = CheckpointManager(str(tmp_path)).restore(None, target)
    assert _same(back, want) and int(back.opt.step) == 1


def test_port_written_checkpoint_restores_in_jax(tmp_path):
    jcfg, tcfg = _cfgs()
    st = _state(torch.float32, seed=5)
    st, _ = ST.make_train_step(tcfg)(st, _batches(tcfg.vocab, 1)[0][1])
    CheckpointManager(str(tmp_path)).save(3, st)
    jp = japi.init(jax.random.key(0), jcfg)
    target = jax.eval_shape(
        lambda: JST.TrainState(jp, JA.init(JA.AdamWConfig(), jp)))
    back = JCM(str(tmp_path)).restore(3, target)
    jl = jax.tree.leaves(back)
    tl = tree_leaves(st.params) + [st.opt.step] + tree_leaves(
        st.opt.master) + tree_leaves(st.opt.m) + tree_leaves(st.opt.v)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
