"""The MoE family's train step on a mesh's ``model`` axis
(``launch.steps.mesh_step`` with ``model`` > 1) against the JAX package's
single-device ``make_train_step``, and each rank's gradient of one MoE
layer against the reference's own ``_moe_apply_shard_map`` differentiated
by ``jax.grad``.

Tiny fp32 ``moonshot-v1-16b-a3b`` (2 layers, d 128, top-2, ff 256) with 4
experts, which every ``model`` size here divides (expert-parallel), on
(1, 2), (1, 4) and (2, 2) (ZeRO-1 over ``data`` there), and with 3
(ff-sharded) on (1, 2) and (2, 2), where the expert matrices are also cut
on d over ``data``: leaves that their own spec splits on ``data`` (FSDP
leaves), gathered for the product by an all-gather whose backward
reduce-scatters their gradient, and whose ZeRO-1 block is that block, cut
once. Two steps of ``test_torch_mesh_train.OPT`` at batch 4 x 32. One
spawn of gloo ranks (``test_torch_mesh_train.run_ranks``) per world size
carries every case of its meshes; the ranks import no JAX. The reference
is JAX's single-device step under ``jax.jit`` on the weights
``convert.lm_params_from_jax`` carries; the layer's is the reference's
sharded MoE on four forced host devices (``tests/jax_moe_shard_map.py``,
in a process of its own). Sharding changes the sums' order only. Bounds,
with the largest reading over the five meshes beside each:

- losses and grad norms within 1e-5 relative (measured 1.9e-7);
- first-step gradients within 2e-5 of each leaf's largest |g| (1.5e-6);
- every leaf of the gathered state (params, master, m, v) within 1e-6
  elementwise (6.0e-8), of JAX's state and of the port's one process;
  the moments also within 2e-5 of each leaf's largest entry (2.1e-6);
- the router's first-step gradient and every leaf replicated on
  ``model`` bit-equal across the ``model`` ranks of a data row;
- each FSDP leaf's params, master and moments of the rank's
  ``local_shape`` of its spec (cut once, not twice);
- restore onto the mesh giving ``mesh_state``'s blocks, bit for bit;
- the collectives a step, by axis, as the path calls them;
- on a (1, 1) mesh, the step bit-equal to ``make_train_step``'s;
- each rank's gradient blocks of one MoE layer (router, ``wi``, ``wo``
  and its rows of ``x``; the router and an unsplit expert block summed
  over ``data``, as the train step sums them) within 2e-5 of each leaf's
  largest entry of the reference's (5.3e-7).
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.ckpt.checkpoint import (CheckpointManager,  # noqa: E402
                                         flatten_with_keys)
from repro_torch.compat import DTensor, init_device_mesh  # noqa: E402
from repro_torch.configs.archs import tiny_version  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import specs as SP  # noqa: E402
from repro_torch.parallel import tensor as TP  # noqa: E402
from repro_torch.parallel.sharding import P as Spec  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

from test_torch_mesh_train import OPT, run_ranks, solo_group  # noqa: E402,F401
from test_torch_tensor_parallel import _Rank  # noqa: E402

ARCH = "moonshot-v1-16b-a3b"
BATCH, SEQ, STEPS = 4, 32, 2
LOSS_TOL = 1e-5                 # relative, losses and grad norms
GRAD_TOL = 2e-5                 # of each leaf's largest |g|, step 1
PARAM_TOL = 1e-6                # elementwise, params and master
MOMENT_TOL = GRAD_TOL           # of each leaf's largest entry, m and v
LAYER_TOL = 2e-5                # of each leaf's largest |g|, one MoE layer
LAYER_B, LAYER_S = 4, 16        # the MoE layer's rows (global) and length
NAMES = ("data", "model")
FFN = "['layers']['ffn']"

CASES = [(4, (1, 2)), (4, (1, 4)), (4, (2, 2)), (3, (1, 2)), (3, (2, 2))]
IDS = [f"e{E}-{a}x{b}" for E, (a, b) in CASES]


def _cfg(E):
    return tiny_version(get_config(ARCH)).with_(n_experts=E)


def _batches(cfg):
    rng = np.random.default_rng(7)
    return [{k: rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(STEPS)]


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _np(t):
    return t.detach().numpy().copy()


def _local_np(t):
    return _np(t.to_local() if isinstance(t, DTensor) else t)


# -- the ranks (no JAX) ------------------------------------------------------

_COLLECTIVES = {"all_reduce": "all_reduce",
                "all_gather_into_tensor": "all_gather",
                "all_gather_single": "all_gather",
                "reduce_scatter_tensor": "reduce_scatter",
                "reduce_scatter_single": "reduce_scatter"}


def _counting(mesh, calls: list):
    """Wraps ``torch.distributed``'s collectives to record (collective,
    axis) in ``calls``. Returns the undo."""
    axes = {id(mesh.get_group(a)): a for a in NAMES}
    saved = {k: getattr(dist, k) for k in _COLLECTIVES if hasattr(dist, k)}

    def wrap(name, fn):
        def call(*args, group=None, **kw):
            calls.append((_COLLECTIVES[name], axes[id(group)]))
            return fn(*args, group=group, **kw)
        return call
    for k, fn in saved.items():
        setattr(dist, k, wrap(k, fn))

    def undo():
        for k, fn in saved.items():
            setattr(dist, k, fn)
    return undo


def _train(cfg, mesh, params, batches, directory):
    """Two mesh steps from the whole ``params``: losses, grad norms, the
    first step's gradients (gathered, and the router's local blocks), the
    gathered state after, the local blocks of the leaves replicated on
    ``model``, the FSDP leaves' shapes, the mesh state's local blocks
    beside a restore of the one-process checkpoint in ``directory``, and
    each step's collectives."""
    plan = ST.mesh_plan(cfg, mesh)
    params = tree_map(torch.clone, params)      # not the parent's storage
    fresh = ST.TrainState(params, adamw.init(OPT, params))
    state = ST.mesh_state(fresh, plan)
    keys = [k for k, _ in flatten_with_keys(state.params)]
    laid = {k: (type(v), _local_np(v)) for k, v in flatten_with_keys(state)}
    back = CheckpointManager(directory).restore(
        0, fresh, ST.state_shardings(cfg, OPT, mesh))
    restored = {k: (type(v), _local_np(v)) for k, v in
                flatten_with_keys(back)}
    held = dict(zip(keys, tree_leaves(plan.model.data)))
    fsdp = {}
    for k, p, mst, m, v in zip(keys, *(tree_leaves(x) for x in (
            state.params, *state.opt[1:]))):
        if held[k]:
            fsdp[k] = [tuple(local_t.shape) for local_t in (
                p.to_local(), mst.to_local(), m.to_local(), v.to_local())]
    step = ST.mesh_step(cfg, ShapeConfig("t", SEQ, BATCH, "train"), mesh,
                        OPT)
    _, g = ST.mesh_grads(cfg, plan, state.params,
                         _torch_batch(batches[0]))
    router = _np(g["layers"]["ffn"]["router"]["kernel"])
    grads = [_np(t) for t in tree_leaves(ST.gather_params(g, plan))]
    losses, norms, replicated, calls = [], [], [], []
    split = dict(zip(keys, tree_leaves(plan.model.split)))
    for b in batches:
        calls.append([])
        undo = _counting(mesh, calls[-1])
        try:
            state, m = step(state, _torch_batch(b))
        finally:
            undo()
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        replicated.append({k: _local_np(v) for k, v in
                           flatten_with_keys(state.params) if not split[k]})
    whole = [(k, _np(v)) for k, v in ST.gathered(state, plan)]
    return dict(losses=losses, norms=norms, grads=grads, router=router,
                state=whole, replicated=replicated, laid=laid,
                restored=restored, fsdp=fsdp, calls=calls)


def _layer(cfg, mesh, shape, params, x, dy):
    """Layer 0's MoE under the train layout on this rank's blocks (cut by
    ``shard_params``) and its data shard's rows of ``x``, differentiated
    on ``sum(y · dy)``: the gradient blocks of the router (as the rank
    holds it, then summed over ``data``), ``wi``, ``wo`` (summed over
    ``data`` where no spec cuts them there) and ``x``."""
    lay = TP.layout(cfg, mesh, ST.specs_of(ST.param_specs(cfg, mesh,
                                                          kind="train")))
    blocks = TP.shard_params(params, cfg, mesh, "train")
    ffn = tree_map(lambda t: t[0].clone().requires_grad_(),
                   blocks["layers"]["ffn"])
    rows = LAYER_B // shape[0]
    r0 = mesh.get_local_rank("data") * rows
    xr = torch.from_numpy(x[r0:r0 + rows]).requires_grad_()
    with TP.installed(lay):
        y = T.moe_apply(ffn, cfg, xr)
    (y * torch.from_numpy(dy[r0:r0 + rows])).sum().backward()
    out = {"router_local": _np(ffn["router"]["kernel"].grad), "x": _np(
        xr.grad)}
    for name, t in (("router", ffn["router"]["kernel"]), ("wi", ffn["wi"]),
                    ("wo", ffn["wo"])):
        g = t.grad.clone()
        if shape[0] > 1 and (name == "router" or lay.moe.data_size == 1):
            dist.all_reduce(g, group=mesh.get_group("data"))
        out[name] = _np(g)
    return out


def _worker(rank, world, meshes, layer, directory):
    """Every case of each mesh (shape → {E: (params, batches)}) of this
    world size, and its MoE layer's gradients (``layer``: E → (x, dy)), by
    shape."""
    torch.manual_seed(0)
    out = {}
    for shape, runs in meshes.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=NAMES)
        out[shape] = {E: dict(_train(_cfg(E), mesh, params, batches,
                                     f"{directory}/e{E}"),
                              layer=_layer(_cfg(E), mesh, shape, params,
                                           *layer[E]))
                      for E, (params, batches) in runs.items()}
    dist.barrier()
    return out


# -- the JAX references and the one-process port ------------------------------

_CACHE = {}


def _reference(E):
    """(carried port params, batches, the JAX run: losses, grad norms,
    first-step gradients, the state after as (key, array) pairs; the MoE
    layer's x and dy and layer 0's MoE params as numpy). The first-step
    gradients are read from the step's own first moment, m₁ = (1 − b1)·g
    clipped by min(1, clip / norm) (a few ulps of each entry: no second
    compilation of the loss's gradient)."""
    if E in _CACHE:
        return _CACHE[E]
    import jax
    import jax.numpy as jnp
    from repro.configs.archs import tiny_version as j_tiny
    from repro.configs.base import get_config as j_get_config
    from repro.launch import steps as JST
    from repro.models import api as japi
    from repro.optim import adamw as jadamw
    from repro_torch.convert import lm_params_from_jax
    jcfg = j_tiny(j_get_config(ARCH)).with_(n_experts=E)
    jparams = japi.init(jax.random.key(6), jcfg)
    params = lm_params_from_jax(jax.device_get(jparams))
    batches = _batches(jcfg)
    jopt = jadamw.AdamWConfig(**{f: getattr(OPT, f) for f in (
        "lr", "b1", "b2", "eps", "weight_decay", "grad_clip",
        "warmup_steps", "total_steps", "min_lr_ratio")})
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    state = JST.TrainState(jparams, jadamw.init(jopt, jparams))
    step = jax.jit(JST.make_train_step(jcfg, jopt))
    losses, norms, grads = [], [], None
    for b in jb:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if grads is None:       # step 1's gradient, from its first moment
            clip = min(1.0, OPT.grad_clip / norms[0])
            grads = jax.tree.map(lambda t: np.asarray(t) / (1 - OPT.b1)
                                 / clip, state.opt.m)
    flat = [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in
            jax.tree_util.tree_leaves_with_path(state)]
    rng = np.random.default_rng(11 + E)
    x, dy = (rng.standard_normal((LAYER_B, LAYER_S, jcfg.d_model)).astype(
        np.float32) for _ in range(2))
    jffn = jparams["layers"]["ffn"]
    layer = {"router": np.asarray(jffn["router"]["kernel"][0]),
             "wi": np.asarray(jffn["wi"][0]), "wo": np.asarray(jffn["wo"][0])}
    _CACHE[E] = (params, batches, dict(
        losses=losses, norms=norms, state=flat,
        grads=jax.tree.leaves(grads)),
        (x, dy), layer)
    return _CACHE[E]


@functools.lru_cache(maxsize=None)
def _one_process(E):
    """The port's ``make_train_step`` on the same weights and batches: the
    state after, (key, array) pairs."""
    params, batches, *_ = _reference(E)
    cfg = _cfg(E)
    state = ST.TrainState(tree_map(torch.clone, params),
                          adamw.init(OPT, params))
    step = ST.make_train_step(cfg, OPT)
    for b in batches:
        state, _ = step(state, _torch_batch(b))
    return [(k, _np(v)) for k, v in flatten_with_keys(state)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each (experts, mesh) case's rank results, one spawn per world size
    run once for the module; each expert count's one-process state
    checkpointed first for the ranks' restore."""
    done = {}

    def get(E, shape):
        world = shape[0] * shape[1]
        if world not in done:
            tmp = tmp_path_factory.mktemp("moetrain")
            meshes, layer = {}, {}
            for e, mesh in (c for c in CASES if c[1][0] * c[1][1] == world):
                params, batches, _, xdy, _ = _reference(e)
                if e not in layer:
                    CheckpointManager(str(tmp / f"e{e}")).save(
                        0, ST.TrainState(params, adamw.init(OPT, params)))
                    layer[e] = xdy
                meshes.setdefault(mesh, {})[e] = (params, batches)
            done[world] = run_ranks(_worker, world, tmp, meshes, layer,
                                    str(tmp), timeout=180.0)
        return [r[shape][E] for r in done[world]]
    return get


@pytest.fixture(scope="module")
def shard_map(tmp_path_factory):
    """The reference's ``_moe_apply_shard_map`` and its ``jax.grad`` on
    every case's mesh, layer and (x, dy), run once in its own process:
    the gradients by case, each leaf whole."""
    tmp = tmp_path_factory.mktemp("shard_map_grad")
    inp = {}
    for c, (E, shape) in enumerate(CASES):
        *_, (x, dy), layer = _reference(E)
        inp.update({f"{c}/E": np.int64(E), f"{c}/mesh": np.array(shape),
                    f"{c}/x/000": x, f"{c}/dy/000": dy,
                    **{f"{c}/{k}": v for k, v in layer.items()}})
    np.savez(tmp / "in.npz", **inp)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "..", "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "jax_moe_shard_map.py"),
         str(tmp / "in.npz"), str(tmp / "out.npz")], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = np.load(tmp / "out.npz")
    return {case: {k: got[f"{c}/g/000/{k}"] for k in ("router", "wi", "wo",
                                                      "x")}
            for c, case in enumerate(CASES)}


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("E,shape", CASES, ids=IDS)
def test_losses_and_grad_norms_equal_jax_single_device(E, shape, runs):
    *_, ref, _, _ = _reference(E)
    assert ref["norms"][0] > OPT.grad_clip              # the clip acts
    for r in runs(E, shape):
        for a, b in zip(r["losses"] + r["norms"],
                        ref["losses"] + ref["norms"]):
            assert _rel(a, b) <= LOSS_TOL, (a, b)


@pytest.mark.parametrize("E,shape", CASES, ids=IDS)
def test_first_step_gradients_equal_jax(E, shape, runs):
    """Every leaf's gradient, gathered from the ranks' blocks (an FSDP
    leaf's over both axes), within 2e-5 of its largest |g|."""
    *_, ref, _, _ = _reference(E)
    for r in runs(E, shape):
        assert len(r["grads"]) == len(ref["grads"])
        for a, b in zip(r["grads"], ref["grads"]):
            scale = np.abs(b).max()
            assert a.shape == b.shape and scale > 0
            assert np.abs(a - b).max() <= GRAD_TOL * scale


@pytest.mark.parametrize("E,shape", CASES, ids=IDS)
def test_gathered_state_equals_jax_and_the_one_process_port(E, shape, runs):
    """``gathered`` after the steps: params and master within 1e-6
    elementwise, m and v also within 2e-5 of each leaf's largest entry,
    of JAX's state and of the port's one process; the step counts 2."""
    *_, ref, _, _ = _reference(E)
    one = _one_process(E)
    for r in runs(E, shape):
        got = r["state"]
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


@pytest.mark.parametrize("E,shape", CASES, ids=IDS)
def test_router_gradient_and_replicated_leaves_bit_equal_across_model(
        E, shape, runs):
    """The router's first-step gradient (summed over ``model`` by its
    ``copy_to_model``, then averaged over ``data``) holds the same bits
    on every rank of a data row, and so does every leaf replicated on
    ``model`` (the router, the norm scales) after every step."""
    got = runs(E, shape)
    m = shape[1]
    for d in range(shape[0]):
        ranks = got[d * m:(d + 1) * m]
        first = ranks[0]
        assert np.abs(first["router"]).max() > 0
        for r in ranks[1:]:
            assert np.array_equal(r["router"], first["router"])
            for s in range(STEPS):
                want = first["replicated"][s]
                assert FFN + "['router']['kernel']" in want
                for k, v in r["replicated"][s].items():
                    assert np.array_equal(v, want[k]), (k, s)


@pytest.mark.parametrize("E,shape", CASES, ids=IDS)
def test_fsdp_leaves_are_cut_once(E, shape, runs):
    """The leaves that their own train spec cuts on ``data`` are the
    ff-sharded experts' ``wi`` and ``wo`` (d over ``data``), and only on a
    mesh whose data axis cuts them: there the params, master copy and
    moments are each the rank's ``local_shape`` of that spec (ZeRO-1 adds
    no second cut); elsewhere there are none."""
    cfg = _cfg(E)
    placed = ST.param_specs(cfg, _Rank(shape, NAMES, (0, 0)), kind="train")
    want = {}
    if E % shape[1]:
        for name in ("wi", "wo"):
            t, spec = placed["layers"]["ffn"][name]
            want[f"{FFN}['{name}']"] = SP.local_shape(
                tuple(t.shape), spec, _Rank(shape, NAMES, (0, 0)))
    for r in runs(E, shape):
        assert r["fsdp"].keys() == want.keys()
        for k, shapes in r["fsdp"].items():
            assert shapes == [want[k]] * 4, k
            assert want[k][3] == cfg.d_model // shape[0], k     # d


@pytest.mark.parametrize("E,shape", CASES, ids=IDS)
def test_restore_onto_the_mesh_gives_the_mesh_state_blocks(E, shape, runs):
    """A checkpoint of the one-process state restored with
    ``state_shardings`` gives every rank the blocks ``mesh_state`` gives
    it, bit for bit and of the same kind: every leaf a DTensor (an MoE's
    ``wi`` holds gate and up on an axis of its own: no paired halves)."""
    for r in runs(E, shape):
        assert r["laid"].keys() == r["restored"].keys()
        for k, (kind, a) in r["laid"].items():
            kind2, b = r["restored"][k]
            assert kind is kind2 is DTensor and np.array_equal(a, b), k


def _expected_calls(E, shape):
    """The collectives of one train step on a rank, (collective, axis) →
    count, as the path calls them. On ``model``: the embedding's sum; per
    layer attention's input copy and output sum (and, with ``wk``/``wv``
    cut on their input dimension, k and v summed and each copied back),
    the MoE's router and input copies and its output sum; the final copy,
    the loss's three sums and the clip's norm. On ``data`` (size > 1):
    ZeRO-1's reduce-scatter and gather of each leaf it cuts, an FSDP
    leaf's gather and reduce-scatter in every layer (none at the mean),
    the loss's mean and the clip's norm over the ZeRO-1 blocks and over
    the FSDP leaves."""
    d, m = shape
    cfg = _cfg(E)
    L = cfg.n_layers
    kv_input = cfg.n_kv_heads % m != 0
    calls = {("all_reduce", "model"): 6 + 5 * L + 3 * L * kv_input}
    if d > 1:
        plan = ST.mesh_plan(cfg, _Rank(shape, NAMES, (0, 0)))
        cut = sum(x is not None for x in tree_leaves(plan.zero1.dims))
        fsdp = sum(tree_leaves(plan.model.data))
        assert cut + fsdp == len(tree_leaves(plan.shapes))
        calls[("reduce_scatter", "data")] = cut + L * fsdp
        calls[("all_gather", "data")] = cut + L * fsdp
        calls[("all_reduce", "data")] = 2 + (fsdp > 0)
    return calls


@pytest.mark.parametrize("E,shape", CASES, ids=IDS)
def test_collectives_a_step(E, shape, runs):
    """Each step calls the collectives :func:`_expected_calls` counts, by
    axis, on every rank: no all_to_all, and nothing on ``data`` beyond
    the gradients' mean, the loss's, the clip's norm and an FSDP leaf's
    gather."""
    want = _expected_calls(E, shape)
    for r in runs(E, shape):
        for calls in r["calls"]:
            got = {}
            for c in calls:
                got[c] = got.get(c, 0) + 1
            assert got == want


@pytest.mark.parametrize("E,shape", CASES, ids=IDS)
def test_moe_layer_gradients_equal_the_reference_shard_map(E, shape, runs,
                                                           shard_map):
    """Each rank's gradient blocks of one MoE layer within 2e-5 of each
    leaf's largest entry of ``jax.grad`` through the reference's own
    ``_moe_apply_shard_map`` on the same mesh shape, cut to the rank's
    block as its train spec places the leaf (its rows of ``x``); the
    router's, as the rank holds it before the data sum, the same bits on
    every rank of a data row."""
    want = shard_map[(E, shape)]
    cfg = _cfg(E)
    placed = ST.param_specs(cfg, _Rank(shape, NAMES, (0, 0)), kind="train")
    specs = {k: Spec(*placed["layers"]["ffn"][k].spec[1:])
             for k in ("wi", "wo")}
    specs["router"] = Spec()
    rows = LAYER_B // shape[0]
    ranks = runs(E, shape)
    for i, r in enumerate(ranks):
        d, m = divmod(i, shape[1])
        rank = _Rank(shape, NAMES, (d, m))
        got = r["layer"]
        for k in ("router", "wi", "wo"):
            ref = TP.local_block(torch.from_numpy(want[k]), specs[k],
                                 rank).numpy()
            assert got[k].shape == ref.shape, k
            assert np.abs(got[k] - ref).max() <= LAYER_TOL * np.abs(
                want[k]).max(), k
        ref = want["x"][d * rows:(d + 1) * rows]
        assert np.abs(got["x"] - ref).max() <= LAYER_TOL * np.abs(
            want["x"]).max()
        assert np.array_equal(got["router_local"],
                              ranks[d * shape[1]]["layer"]["router_local"])


@pytest.mark.parametrize("E", [4, 3])
def test_model_1_mesh_step_is_bit_equal_to_the_plain_step(E, solo_group):
    """On a (1, 1) mesh the train step takes no tensor-parallel path (no
    layout, no model split in the clip): losses, grad norms and every
    leaf bit-equal to ``make_train_step``'s."""
    params, batches, *_ = _reference(E)
    cfg = _cfg(E)
    mesh = M.make_mesh((1, 1), NAMES, device="cpu")
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
