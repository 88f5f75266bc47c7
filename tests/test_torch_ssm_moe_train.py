"""The port's SSM, MoE and hybrid training against the JAX package's.

Tiny fp32 ``mamba2-130m`` (2 layers of 8 SSM heads, P 32, N 16, chunk 32),
``moonshot-v1-16b-a3b`` (2 layers of 4 experts, top-2) and
``jamba-v0.1-52b`` (one 8-layer period: attention, mamba, MoE), weights
drawn by the JAX package and carried by ``lm_params_from_jax``. One step's
loss and every gradient leaf against ``jax.value_and_grad`` of
``repro.models.api.loss``; two steps of ``make_train_step`` against the
reference's, the state held as ``tests/test_torch_train.py`` holds the
dense one (Adam's first steps move an entry by about the learning rate, so
one whose gradient is near 0 may move either way); ``run`` on the CPU
lowers the loss and reruns bit-equal. The tests run in fp32: in bf16 a
near tie of the router's probabilities can route a token to another
expert (ROADMAP Queue 3), which changes the loss by far more than rounding.
On the CPU the port's scan and gating run their plain versions, forward
and backward; the card's kernels are held to those by
``tests/test_torch_hopper.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import tiny_version as jtiny  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.configs.archs import tiny_version  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import (lm_params_from_jax,  # noqa: E402
                                 train_state_from_jax)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_train import _batches, _same  # noqa: E402

ARCHS = ["mamba2-130m", "moonshot-v1-16b-a3b", "jamba-v0.1-52b"]
# fp32, the scan's chunks and the products summed in other orders
TOL = dict(rtol=1e-4, atol=1e-5)
SEQ = 64                               # two of the tiny configs' 32-step chunks


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for PyTorch while these tests run: tier-1 runs
    six workers over the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carried(arch, seed=0):
    jcfg, tcfg = jtiny(jget(arch)), tiny_version(get_config(arch))
    jp = japi.init(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp, lm_params_from_jax(jax.device_get(jp))


def _kernel_calls():
    return (ops.ssd_scan_bwd.launches, ops.topk_gating_bwd.launches)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_loss_and_gradients_match_jax(arch):
    """Every leaf the reference differentiates (the stacked layers' included)
    gets the same gradient, nonzero; the carried params stay as they were."""
    jcfg, tcfg, jp, tp = _carried(arch)
    (jb, tb), = _batches(jcfg.vocab, 1, seq=SEQ)
    jloss, jg = jax.value_and_grad(
        lambda p: japi.loss(p, jcfg, jb, train=True))(jp)
    before = [t.clone() for t in tree_leaves(tp)]
    tloss, tg = ST.loss_and_grads(tp, tcfg, tb)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(tp)))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    jl, tl = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jl) == len(tl) == len(jax.tree.leaves(jp))
    for a, b in zip(tl, jl):
        assert a.shape == b.shape and float(a.abs().sum()) > 0
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_make_train_step(arch):
    jcfg, tcfg, jp, tp = _carried(arch, 1)
    jopt, topt = JA.AdamWConfig(warmup_steps=2), TA.AdamWConfig(
        warmup_steps=2)
    jstate = JST.TrainState(jp, JA.init(jopt, jp))
    tstate = ST.TrainState(tp, TA.init(topt, tp))
    jstep, tstep = JST.make_train_step(jcfg, jopt), \
        ST.make_train_step(tcfg, topt)
    for jb, tb in _batches(jcfg.vocab, 2, seed=1, seq=SEQ):
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
    carried = train_state_from_jax(jax.device_get(jstate))
    assert len(tree_leaves(carried.opt.master)) == len(
        tree_leaves(tstate.opt.master))


@pytest.mark.parametrize("arch", ARCHS)
def test_run_lowers_the_loss_and_reruns_bit_equal(arch):
    """``run`` on the CPU: the loss falls over 12 steps, the backward of each
    family's kernels ran (their CPU routes count no launch), and a rerun
    gives the same losses and state bit for bit."""
    calls = _kernel_calls()
    state, losses = run(arch, tiny=True, steps=12, batch=4, seq=SEQ,
                        lr=3e-3, verbose=False, device="cpu")
    assert _kernel_calls() == calls
    assert np.isfinite(losses).all() and losses[-1] < losses[0] - 0.1
    state2, losses2 = run(arch, tiny=True, steps=12, batch=4, seq=SEQ,
                          lr=3e-3, verbose=False, device="cpu")
    assert losses == losses2
    assert _same(state, state2)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_reaches_the_scan_and_the_router_through_autograd(arch):
    """The graph of the port's loss holds the two Functions where the family
    has the layers: the scan's in the ssm and hybrid families, the router's
    in the moe and hybrid ones."""
    _, tcfg, _, tp = _carried(arch)
    (_, tb), = _batches(tcfg.vocab, 1, seq=SEQ)
    from repro_torch.models import api
    from repro_torch.tree import trainable
    loss = api.loss(trainable(tp), tcfg, tb)
    seen, stack = set(), [loss.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack += [f for f, _ in fn.next_functions]
    names = {type(f).__name__ for f in seen}
    assert ("_SSDScanBackward" in names) == (tcfg.family in ("ssm",
                                                             "hybrid"))
    assert ("_TopkGatingBackward" in names) == (tcfg.family in ("moe",
                                                                "hybrid"))
