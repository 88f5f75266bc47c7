"""The dense family's train step on a mesh's ``model`` axis
(``launch.steps.mesh_step`` with ``model`` > 1) against the JAX package's
single-device ``make_train_step``, and its pieces: the collectives that
autograd sees (``parallel.tensor.copy_to_model`` / ``reduce_from_model``),
the vocabulary-parallel cross-entropy, the embedding's gradient, the
clip's norm over both axes, restoring a checkpoint onto such a mesh and
gathering the state back.

Tiny fp32 ``llama3.2-1b`` (2 layers, d 128, 4 query heads over 2 kv
heads: its kv heads split at ``model`` 2, ``wk``/``wv`` cut on their input
dimension at 4) on (1, 2), (1, 4) and (2, 2), and tiny ``granite-20b``
(MQA, one kv head: ``wk``/``wv`` cut on their input dimension) on (1, 2);
two steps of ``test_torch_mesh_train.OPT`` (eps 1e-4 and a clip that
acts) at batch 4 x 32. One spawn of gloo ranks
(``test_torch_mesh_train.run_ranks``) per world size carries every case
of its meshes ((1, 4) and (2, 2) share the four ranks); the ranks import
no JAX. The reference is JAX's single-device step under
``jax.jit`` on the weights ``convert.lm_params_from_jax`` carries, which
GSPMD promises its sharded step equals. Sharding changes the sums' order
only. Bounds, with the largest reading over the four runs beside each:

- losses and grad norms within 1e-5 relative (measured 1.1e-7);
- first-step gradients within 2e-5 of each leaf's largest |g| (1.6e-6);
- every leaf of the gathered state (params, master, m, v) within 1e-6
  elementwise (1.2e-7), of JAX's state and of the port's one process;
  the moments, whose entries are ~1e-5 (m) and ~1e-10 (v), also within
  the gradients' 2e-5 of each leaf's largest entry (1.9e-6): they carry
  the gradients' error, ~1e-6 of a leaf's largest;
- the leaves replicated on ``model`` bit-equal across its ranks;
- on a (1, 1) mesh, the step bit-equal to ``make_train_step``'s.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.ckpt.checkpoint import (CheckpointManager,  # noqa: E402
                                         flatten_with_keys)
from repro_torch.compat import DTensor, init_device_mesh  # noqa: E402
from repro_torch.configs.archs import tiny_version  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import tensor as TP  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

from test_torch_mesh_train import OPT, run_ranks, solo_group  # noqa: E402,F401

BATCH, SEQ, STEPS = 4, 32, 2
LOSS_TOL = 1e-5                 # relative, losses and grad norms
GRAD_TOL = 2e-5                 # of each leaf's largest |g|, step 1
PARAM_TOL = 1e-6                # elementwise, params and master
MOMENT_TOL = GRAD_TOL           # of each leaf's largest entry, m and v
RUNS = {(1, 2): ("llama3.2-1b", "granite-20b"), (1, 4): ("llama3.2-1b",),
        (2, 2): ("llama3.2-1b",)}


def _cfg(arch):
    return tiny_version(get_config(arch))


def _batches(cfg):
    rng = np.random.default_rng(7)
    return [{k: rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(STEPS)]


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _np(t):
    return t.detach().numpy().copy()


# -- the ranks (no JAX) ------------------------------------------------------

def _mesh(shape):
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def _train(cfg, mesh, params, batches, directory):
    """Two mesh steps from the whole ``params``: losses, grad norms, the
    first step's gradients (gathered), the gathered state after, the
    local blocks of the leaves replicated on ``model``, the mesh state's
    local blocks beside a restore of the one-process checkpoint in
    ``directory`` onto the mesh, and the paired leaves' keys."""
    plan = ST.mesh_plan(cfg, mesh)
    params = tree_map(torch.clone, params)      # not the parent's storage
    fresh = ST.TrainState(params, adamw.init(OPT, params))
    state = ST.mesh_state(fresh, plan)
    laid = {k: (type(v), _np(v.to_local() if isinstance(v, DTensor) else v))
            for k, v in flatten_with_keys(state)}
    back = CheckpointManager(directory).restore(
        0, fresh, ST.state_shardings(cfg, OPT, mesh))
    restored = {k: (type(v), _np(v.to_local() if isinstance(v, DTensor)
                                 else v))
                for k, v in flatten_with_keys(back)}
    step = ST.mesh_step(cfg, ShapeConfig("t", SEQ, BATCH, "train"), mesh,
                        OPT)
    _, g = ST.mesh_grads(cfg, plan, state.params,
                         _torch_batch(batches[0]))
    grads = [_np(t) for t in tree_leaves(ST.gather_params(g, plan))]
    losses, norms, replicated = [], [], []
    split = dict(zip((k for k, _ in flatten_with_keys(state.params)),
                     tree_leaves(plan.model.split)))
    for b in batches:
        state, m = step(state, _torch_batch(b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        replicated.append({k: _np(v.to_local()) for k, v in
                           flatten_with_keys(state.params) if not split[k]})
    whole = [(k, _np(v)) for k, v in ST.gathered(state, plan)]
    paired = [k for k, p in zip((k for k, _ in flatten_with_keys(
        state.params)), tree_leaves(plan.paired)) if p]
    return dict(losses=losses, norms=norms, grads=grads, state=whole,
                replicated=replicated, laid=laid, restored=restored,
                paired=paired)


def _collective_cases(mesh, world):
    """``copy_to_model``'s backward (the fp32 sum of the ranks' gradients,
    rounded once) and ``reduce_from_model``'s (the identity), fp32 and
    bf16, on values drawn from one seed for every rank."""
    group, m = mesh.get_group("model"), mesh.get_local_rank("model")
    g = torch.Generator().manual_seed(3)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((5, 6), generator=g).to(dtype).requires_grad_()
        w = (1 + torch.rand((world, 5, 6), generator=g)).to(dtype)
        (TP.copy_to_model(x, group) * w[m]).sum().backward()
        share = torch.randn((world, 5, 6), generator=g).to(dtype)
        s = share[m].clone().requires_grad_()
        c = torch.randn((5, 6), generator=g).to(dtype)
        y = TP.reduce_from_model(s, group, dtype)
        (y * c).sum().backward()
        out[str(dtype)] = dict(w=_np(w.float()), copy_grad=_np(x.grad.float()),
                               share=_np(share.float()), sum=_np(y.float()),
                               c=_np(c.float()), share_grad=_np(s.grad.float()),
                               grad_dtype=str(x.grad.dtype))
    return out


def _vocab_cases(cfg, mesh):
    """The vocabulary-parallel cross-entropy and its logits gradient, and
    the embedding table's gradient, on this rank's vocabulary block,
    beside the whole vocabulary's on the same draws."""
    lay = TP.layout(cfg, mesh, ST.specs_of(ST.param_specs(cfg, mesh,
                                                          kind="train")))
    v0, v1 = lay.vocab
    g = torch.Generator().manual_seed(4)
    edges = torch.tensor([0, v1 - v0 - 1, v1 - v0, cfg.vocab - 1])
    logits = torch.randn((3, 7, cfg.vocab), generator=g) * 3
    labels = torch.randint(0, cfg.vocab, (3, 7), generator=g)
    labels[0, :4] = edges
    block = logits[..., v0:v1].clone().requires_grad_()
    with TP.installed(lay):
        loss = T.softmax_xent(block, labels)
    loss.backward()
    whole = logits.clone().requires_grad_()
    ref = T.softmax_xent(whole, labels)
    ref.backward()
    table = torch.randn((cfg.vocab, cfg.d_model), generator=g)
    ids = torch.randint(0, cfg.vocab, (3, 9), generator=g)
    ids[0, :4] = edges
    up = torch.randn((3, 9, cfg.d_model), generator=g)
    mine = table[v0:v1].clone().requires_grad_()
    (TP.embed_lookup(mine, ids, lay) * up).sum().backward()
    full = table.clone().requires_grad_()
    (F.embedding(ids, full) * up).sum().backward()
    return dict(loss=loss.item(), ref=ref.item(),
                grad=_np(block.grad), ref_grad=_np(whole.grad[..., v0:v1]),
                table_grad=_np(mine.grad), ref_table=_np(full.grad[v0:v1]))


def _norm_case(cfg, mesh):
    """The clip's norm of a gradient-shaped tree cut to this rank's blocks
    on both axes (``model`` by the train specs, then ZeRO-1 on ``data``)
    beside the whole tree's."""
    plan = ST.mesh_plan(cfg, mesh)
    g = torch.Generator().manual_seed(5)
    whole = tree_map(lambda t: torch.randn(t.shape, generator=g),
                     ST.tensors_of(ST.param_specs(cfg, kind="train")))
    blocks = TP.shard_params(whole, cfg, mesh, "train")
    blocks = tree_map(lambda t, d: adamw.block(t, d, plan.zero1), blocks,
                      plan.zero1.dims)
    return float(adamw.global_norm(blocks, plan.zero1, plan.model)), float(
        adamw.global_norm(whole))


def _worker(rank, world, meshes, directory):
    """Every case of each mesh (shape → {arch: (params, batches)}) of this
    world size, by shape."""
    torch.manual_seed(0)
    out = {}
    for shape, runs in meshes.items():
        mesh = _mesh(shape)
        got = {arch: _train(_cfg(arch), mesh, params, batches,
                            f"{directory}/{arch}")
               for arch, (params, batches) in runs.items()}
        got["collectives"] = _collective_cases(mesh, shape[1])
        if shape == (1, 2):
            got["vocab"] = _vocab_cases(_cfg("llama3.2-1b"), mesh)
        if shape == (2, 2):
            got["norm"] = _norm_case(_cfg("llama3.2-1b"), mesh)
        out[shape] = got
    dist.barrier()
    return out


# -- the JAX reference and the one-process port ------------------------------

_CACHE = {}


def _reference(arch):
    """(carried port params, batches, the JAX run: losses, grad norms,
    first-step gradients, the state after as (key, array) pairs)."""
    if arch in _CACHE:
        return _CACHE[arch]
    import jax
    import jax.numpy as jnp
    from repro.configs.archs import tiny_version as j_tiny
    from repro.configs.base import get_config as j_get_config
    from repro.launch import steps as JST
    from repro.models import api as japi
    from repro.optim import adamw as jadamw
    from repro_torch.convert import lm_params_from_jax
    jcfg = j_tiny(j_get_config(arch))
    jparams = japi.init(jax.random.key(6), jcfg)
    params = lm_params_from_jax(jax.device_get(jparams))
    batches = _batches(jcfg)
    jopt = jadamw.AdamWConfig(**{f: getattr(OPT, f) for f in (
        "lr", "b1", "b2", "eps", "weight_decay", "grad_clip",
        "warmup_steps", "total_steps", "min_lr_ratio")})
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    grads = jax.jit(jax.grad(lambda p: japi.loss(p, jcfg, jb[0],
                                                 train=True)))(jparams)
    state = JST.TrainState(jparams, jadamw.init(jopt, jparams))
    step = jax.jit(JST.make_train_step(jcfg, jopt))
    losses, norms = [], []
    for b in jb:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    flat = [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in
            jax.tree_util.tree_leaves_with_path(state)]
    _CACHE[arch] = (params, batches, dict(
        losses=losses, norms=norms, state=flat,
        grads=[np.asarray(v) for v in jax.tree.leaves(grads)]))
    return _CACHE[arch]


@functools.lru_cache(maxsize=None)
def _one_process(arch):
    """The port's ``make_train_step`` on the same weights and batches: the
    state after, (key, array) pairs."""
    params, batches, _ = _reference(arch)
    cfg = _cfg(arch)
    state = ST.TrainState(tree_map(torch.clone, params),
                          adamw.init(OPT, params))
    step = ST.make_train_step(cfg, OPT)
    for b in batches:
        state, _ = step(state, _torch_batch(b))
    return [(k, _np(v)) for k, v in flatten_with_keys(state)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's rank results, one spawn per world size run once for the
    module; each arch's one-process state checkpointed first for the
    ranks' restore."""
    done = {}

    def get(shape):
        world = shape[0] * shape[1]
        if world not in done:
            tmp = tmp_path_factory.mktemp("tptrain")
            meshes = {}
            for mesh in (m for m in RUNS if m[0] * m[1] == world):
                meshes[mesh] = {}
                for arch in RUNS[mesh]:
                    params, batches, _ = _reference(arch)
                    CheckpointManager(str(tmp / arch)).save(
                        0, ST.TrainState(params, adamw.init(OPT, params)))
                    meshes[mesh][arch] = (params, batches)
            done[world] = run_ranks(_worker, world, tmp, meshes, str(tmp),
                                    timeout=120.0)
        return [r[shape] for r in done[world]]
    return get


CASES = [((1, 2), "llama3.2-1b"), ((1, 2), "granite-20b"),
         ((1, 4), "llama3.2-1b"), ((2, 2), "llama3.2-1b")]
IDS = ["llama-1x2", "granite-1x2", "llama-1x4", "llama-2x2"]


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_losses_and_grad_norms_equal_jax_single_device(shape, arch, runs):
    *_, ref = _reference(arch)
    assert ref["norms"][0] > OPT.grad_clip              # the clip acts
    for r in runs(shape):
        got = r[arch]
        for a, b in zip(got["losses"] + got["norms"],
                        ref["losses"] + ref["norms"]):
            assert _rel(a, b) <= LOSS_TOL, (a, b)


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_first_step_gradients_equal_jax(shape, arch, runs):
    """Every leaf's gradient, gathered from the ranks' blocks (a SwiGLU
    ``wi``'s halves joined), within 2e-5 of its largest |g|."""
    *_, ref = _reference(arch)
    for r in runs(shape):
        grads = r[arch]["grads"]
        assert len(grads) == len(ref["grads"])
        for a, b in zip(grads, ref["grads"]):
            scale = np.abs(b).max()
            assert a.shape == b.shape and scale > 0
            assert np.abs(a - b).max() <= GRAD_TOL * scale


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_gathered_state_equals_jax_and_the_one_process_port(shape, arch,
                                                           runs):
    """``gather_state`` after the steps: params and master within 1e-6
    elementwise, m and v within 1e-6 of each leaf's largest entry, of
    JAX's state and of the port's one process; the step counts 2."""
    *_, ref = _reference(arch)
    one = _one_process(arch)
    for r in runs(shape):
        got = r[arch]["state"]
        assert [k for k, _ in got] == [k for k, _ in ref["state"]]
        for want in (ref["state"], one):
            for (k, a), (_, b) in zip(got, want):
                assert a.shape == b.shape, k
                if k == ".opt.step":
                    assert int(a) == int(b) == STEPS
                    continue
                assert np.abs(a - b).max() <= PARAM_TOL, k
                if k.startswith((".opt.m", ".opt.v")):
                    assert np.abs(a - b).max() <= MOMENT_TOL * np.abs(
                        b).max(), k


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_replicated_leaves_bit_equal_across_model_ranks(shape, arch, runs):
    """The leaves replicated on ``model`` (the norm scales) hold the same
    bits on every rank of a data row after every step."""
    got = runs(shape)
    m = shape[1]
    for d in range(shape[0]):
        ranks = got[d * m:(d + 1) * m]
        for s in range(STEPS):
            first = ranks[0][arch]["replicated"][s]
            assert first                                # the norm scales
            for r in ranks[1:]:
                for k, v in r[arch]["replicated"][s].items():
                    assert np.array_equal(v, first[k]), (k, s)


@pytest.mark.parametrize("shape,arch", CASES, ids=IDS)
def test_restore_onto_the_mesh_gives_the_mesh_state_blocks(shape, arch,
                                                           runs):
    """A checkpoint of the one-process state restored with
    ``state_shardings`` gives every rank the blocks ``mesh_state`` gives
    it, bit for bit and of the same kind: a SwiGLU ``wi``'s gate_r ‖ up_r
    (params, master, m, v) a plain tensor, every other leaf a DTensor."""
    for r in runs(shape):
        got = r[arch]
        assert got["laid"].keys() == got["restored"].keys()
        for k, (kind, a) in got["laid"].items():
            kind2, b = got["restored"][k]
            assert kind is kind2 and np.array_equal(a, b), k
        plain = [k for k, (kind, _) in got["laid"].items()
                 if kind is not DTensor]
        assert got["paired"] == ["['layers']['ffn']['wi']['kernel']"]
        assert sorted(plain) == sorted(
            p + "['layers']['ffn']['wi']['kernel']"
            for p in (".params", ".opt.master", ".opt.m", ".opt.v"))


@pytest.mark.parametrize("shape", sorted(RUNS), ids=["1x2", "1x4", "2x2"])
def test_copy_and_reduce_backward(shape, runs):
    """``copy_to_model``'s gradient is the fp32 sum of the ranks'
    gradients rounded once to their dtype (bf16 included: at ``model`` 4
    the rounded-once sum differs from bf16 sums in turn), the same bits
    on every rank; ``reduce_from_model`` sums the shares in fp32, rounded
    once, and passes the gradient through unchanged."""
    m = shape[1]
    for r in runs(shape):
        for name, c in r["collectives"].items():
            dtype = getattr(torch, name.split(".")[1])
            assert c["grad_dtype"] == name
            want = torch.from_numpy(c["w"]).sum(0).to(dtype).float()
            ssum = torch.from_numpy(c["share"]).sum(0).to(dtype).float()
            if dtype == torch.float32:     # the ranks' sum in another order
                np.testing.assert_allclose(c["copy_grad"], want, rtol=1e-6)
                np.testing.assert_allclose(c["sum"], ssum, rtol=1e-6,
                                           atol=1e-6)
            else:                          # bf16 terms: their fp32 sum exact
                assert np.array_equal(c["copy_grad"], want.numpy())
                assert np.array_equal(c["sum"], ssum.numpy())
            assert np.array_equal(c["share_grad"], c["c"]), name
            if dtype == torch.bfloat16 and m == 4:
                w = torch.from_numpy(c["w"]).to(dtype)
                turn = w[0]
                for i in range(1, m):
                    turn = turn + w[i]
                assert not torch.equal(turn.float(), want)


def test_vocab_parallel_xent_and_embedding_gradient(runs):
    """At (1, 2): the cross-entropy of logits split on the vocabulary
    (labels at the shards' edges) equals the whole vocabulary's within
    1e-6, and each rank's block of its logits gradient the whole one's
    block within 1e-7; ``embed_lookup``'s table gradient equals the whole
    gather's, cut to the rank's rows, bit for bit."""
    for r in runs((1, 2)):
        v = r["vocab"]
        assert abs(v["loss"] - v["ref"]) <= 1e-6 * abs(v["ref"])
        assert np.abs(v["grad"] - v["ref_grad"]).max() <= 1e-7
        assert np.array_equal(v["table_grad"], v["ref_table"])


def test_clip_norm_over_both_axes_is_the_unsharded_norm(runs):
    for r in runs((2, 2)):
        got, want = r["norm"]
        assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-20b"])
def test_model_1_mesh_step_is_bit_equal_to_the_plain_step(arch, solo_group):
    """On a (1, 1) mesh the train step takes no tensor-parallel path (no
    layout, no model split in the clip): losses, grad norms and every
    leaf bit-equal to ``make_train_step``'s."""
    params, batches, _ = _reference(arch)
    cfg = _cfg(arch)
    mesh = M.make_mesh((1, 1), ("data", "model"), device="cpu")
    plan = ST.mesh_plan(cfg, mesh)
    assert plan.model is None and plan.layout is None
    fresh = lambda: ST.TrainState(  # noqa: E731
        tree_map(torch.clone, params), adamw.init(OPT, params))
    state = ST.mesh_state(fresh(), plan)
    step = ST.mesh_step(cfg, ShapeConfig("t", SEQ, BATCH, "train"), mesh,
                        OPT)
    ref, rstep = fresh(), ST.make_train_step(cfg, OPT)
    for b in batches:
        state, m = step(state, _torch_batch(b))
        ref, rm = rstep(ref, _torch_batch(b))
        assert torch.equal(m["loss"], rm["loss"])
        assert torch.equal(m["grad_norm"], rm["grad_norm"])
    for (k, a), (_, b) in zip(ST.gathered(state, plan),
                              flatten_with_keys(ref)):
        assert torch.equal(a, b), k
