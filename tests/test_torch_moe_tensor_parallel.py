"""Tensor-parallel MoE serving on a mesh's ``model`` axis
(``models.transformer.moe_apply`` under a ``parallel.tensor`` layout,
through ``launch.steps.mesh_step`` and ``greedy_decode`` with a mesh)
against the JAX package: its single-device ``api.prefill`` /
``api.decode_step`` for the steps, and its own sharded MoE,
``_moe_apply_shard_map``, for each rank's MoE layer.

Tiny moonshot in fp32 (2 layers, d 128, 4 query heads over 2 kv heads,
top-2, ff 256) with 4 experts, which every ``model`` size here divides
(expert-parallel), and with 3 (ff-sharded; with d cut over ``data`` at
(2, 2): the prefill's weight gather and the 2-D decode). The ranks are
spawned gloo processes (``test_torch_mesh_train.run_ranks``), one set
per mesh for both expert counts, that import no JAX; this module imports JAX only
inside the functions that need it, and runs the reference's sharded MoE
in a process of its own on four forced host devices
(``tests/jax_moe_shard_map.py``). Sharding changes the sums' order
only: logits within 2e-5 of the single-device steps, each rank's MoE
layer within 1e-5 of the reference's sharded one (1.5e-6 measured
between that and the reference's dense path).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.compat import DTensor, abstract_mesh  # noqa: E402
from repro_torch.compat import init_device_mesh  # noqa: E402
from repro_torch.configs.archs import tiny_version  # noqa: E402
from repro_torch.configs.base import ShapeConfig, get_config  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.serve import greedy_decode  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.parallel import tensor as TP  # noqa: E402
from repro_torch.parallel.sharding import P as Spec  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

from test_torch_mesh_train import run_ranks  # noqa: E402
from test_torch_tensor_parallel import _Rank  # noqa: E402

ARCH = "moonshot-v1-16b-a3b"
TOL = 2e-5
LAYER_TOL = 1e-5
B, P, GEN = 2, 16, 5                 # prompt P, then GEN - 1 = 4 decode steps
CACHE_LEN = P + GEN - 1              # 20: splits over 2 and 4
LAYER_B = 4                          # the MoE layer's rows (global)
LAYER_S = (16, 1)                    # a prefill's length and a decode step's
NAMES = ("data", "model")

CASES = [(4, (1, 2)), (4, (1, 4)), (4, (2, 2)),
         (3, (1, 2)), (3, (1, 4)), (3, (2, 2))]
IDS = [f"e{E}-{a}x{b}" for E, (a, b) in CASES]


def _cfg(E):
    return tiny_version(get_config(ARCH)).with_(n_experts=E)


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)))


# -- the ranks (no JAX) ------------------------------------------------------

def _full(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).numpy().copy()


def _counting(mesh, calls: list):
    """Wraps ``TP.all_reduce``/``TP.all_gather`` to record (collective,
    axis) in ``calls``; any all_to_all raises. Returns the undo."""
    saved = {k: getattr(TP, k) for k in ("all_reduce", "all_gather")}
    saved_dist = {k: getattr(dist, k) for k in ("all_to_all",
                                                "all_to_all_single")}
    model = mesh.get_group("model")

    def wrap(name, fn):
        def call(t, group, *args, **kw):
            calls.append((name, "model" if group is model else "data"))
            return fn(t, group, *args, **kw)
        return call

    def refuse(*args, **kw):
        raise AssertionError("all_to_all on the MoE path")
    for k, fn in saved.items():
        setattr(TP, k, wrap(k, fn))
    for k in saved_dist:
        setattr(dist, k, refuse)

    def undo():
        for k, fn in saved.items():
            setattr(TP, k, fn)
        for k, fn in saved_dist.items():
            setattr(dist, k, fn)
    return undo


def _moe_worker(rank, world, shape, cases):
    """:func:`_moe_case` of each case (experts, params, prompt, forced
    tokens, layer inputs) on this rank of a ``shape`` mesh, by experts."""
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=NAMES)
    return {case[0]: _moe_case(mesh, shape, *case) for case in cases}


def _moe_case(mesh, shape, E, params, toks, jtoks, xs):
    """The mesh's greedy run (tokens), its prefill and teacher-forced
    serve steps' logits (gathered), and layer 0's MoE on this rank's data
    shard of each ``xs`` input (with the collectives it called, and
    whether whole expert weights were refused) with its blocks' shapes."""
    cfg = _cfg(E)
    dec = TP.shard_params(params, cfg, mesh, "decode")
    tokens = torch.from_numpy(toks)
    out = dict(greedy=greedy_decode(dec, cfg, tokens, GEN,
                                    mesh=mesh).tokens)
    prefill = ST.mesh_step(cfg, ShapeConfig("p", P, B, "prefill"), mesh,
                           cache_len=CACHE_LEN)
    serve = ST.mesh_step(cfg, ShapeConfig("d", CACHE_LEN, B, "decode"),
                         mesh)
    logits, cache = prefill(dec, {"tokens": tokens})
    out["logits"] = [_full(logits)]
    for t in range(GEN - 1):
        feed = {"tokens": torch.from_numpy(jtoks[:, t:t + 1])}
        logits, cache = serve(dec, cache, feed, P + t)
        out["logits"].append(_full(logits))
    lay = TP.layout(cfg, mesh, ST.specs_of(ST.param_specs(
        cfg, mesh, kind="prefill")))
    ffn = tree_map(lambda t: t[0], dec["layers"]["ffn"])
    whole = tree_map(lambda t: t[0], params["layers"]["ffn"])
    rows = LAYER_B // shape[0]
    r0 = mesh.get_local_rank("data") * rows
    out["layer"], out["calls"] = {}, {}
    for S, x in xs.items():
        part = torch.from_numpy(x[r0:r0 + rows])
        calls: list = []
        undo = _counting(mesh, calls)
        try:
            with TP.installed(lay), torch.no_grad():
                out["layer"][S] = T.moe_apply(ffn, cfg, part).numpy()
        finally:
            undo()
        out["calls"][S] = calls
    try:
        with TP.installed(lay), torch.no_grad():
            T.moe_apply(whole, cfg, torch.from_numpy(xs[1][r0:r0 + rows]))
        out["refused"] = False
    except ValueError:
        out["refused"] = True
    out["blocks"] = (tuple(ffn["wi"].shape), tuple(ffn["wo"].shape))
    return out


# -- the JAX references and the one-process port ------------------------------

_CACHE = {}


def _reference(E):
    """(port params, prompt, JAX tokens, JAX logits per step, the MoE
    layer's inputs by length, layer 0's MoE params as numpy)."""
    if E in _CACHE:
        return _CACHE[E]
    import jax
    import jax.numpy as jnp
    from repro.configs.archs import tiny_version as j_tiny
    from repro.configs.base import get_config as j_get_config
    from repro.models import api as japi
    from repro_torch.convert import lm_params_from_jax
    jcfg = j_tiny(j_get_config(ARCH)).with_(n_experts=E)
    jparams = japi.init(jax.random.key(3), jcfg)
    params = lm_params_from_jax(jax.device_get(jparams))
    rng = np.random.default_rng(5 + E)
    toks = rng.integers(0, jcfg.vocab, (B, P)).astype(np.int32)
    prefill = jax.jit(lambda p, b: japi.prefill(p, jcfg, b))
    decode = jax.jit(lambda p, b, c, i: japi.decode_step(p, jcfg, b, c, i))
    logits, pcache = prefill(jparams, {"tokens": jnp.asarray(toks)})
    cache = jax.tree.map(
        lambda d, s: jnp.pad(s, [(0, a - b) for a, b in zip(d.shape,
                                                             s.shape)]),
        japi.init_cache(jcfg, B, CACHE_LEN), pcache)
    cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out, steps = [np.asarray(cur)], [np.asarray(logits)]
    for t in range(GEN - 1):
        logits, cache = decode(jparams, {"tokens": cur}, cache,
                               jnp.int32(P + t))
        cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out.append(np.asarray(cur))
        steps.append(np.asarray(logits))
    xs = {S: rng.standard_normal((LAYER_B, S, jcfg.d_model)).astype(
        np.float32) for S in LAYER_S}
    jffn = jparams["layers"]["ffn"]
    layer = {"router": np.asarray(jffn["router"]["kernel"][0]),
             "wi": np.asarray(jffn["wi"][0]), "wo": np.asarray(jffn["wo"][0])}
    _CACHE[E] = (params, toks, np.concatenate(out, 1), steps, xs, layer)
    return _CACHE[E]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each (experts, mesh) case's rank results: one set of ranks per
    mesh runs both expert counts (a rank's start, ~6 s of one core, is
    most of its cost), once for the module."""
    done = {}

    def get(E, shape):
        if shape not in done:
            cases = []
            for e in sorted({e for e, s in CASES if s == shape}):
                params, toks, jtoks, _, xs, _ = _reference(e)
                cases.append((e, params, toks, jtoks, xs))
            done[shape] = run_ranks(
                _moe_worker, shape[0] * shape[1],
                tmp_path_factory.mktemp("moe"), shape, cases)
        return [r[E] for r in done[shape]]
    return get


@pytest.fixture(scope="module")
def shard_map(tmp_path_factory):
    """The reference's ``_moe_apply_shard_map`` on every case's mesh and
    inputs, run once in its own process: outputs by (E, mesh, S)."""
    tmp = tmp_path_factory.mktemp("shard_map")
    inp = {}
    for c, (E, shape) in enumerate(CASES):
        _, _, _, _, xs, layer = _reference(E)
        inp.update({f"{c}/E": np.int64(E), f"{c}/mesh": np.array(shape),
                    **{f"{c}/{k}": v for k, v in layer.items()},
                    **{f"{c}/x/{S:03d}": x for S, x in xs.items()}})
    np.savez(tmp / "in.npz", **inp)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "..", "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "jax_moe_shard_map.py"),
         str(tmp / "in.npz"), str(tmp / "out.npz")], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = np.load(tmp / "out.npz")
    return {(E, shape, S): got[f"{c}/y/{S:03d}"]
            for c, (E, shape) in enumerate(CASES) for S in LAYER_S}


@pytest.mark.parametrize("E,shape", CASES, ids=IDS)
def test_prefill_and_decode_logits_equal_jax_single_device(E, shape, runs):
    """Every rank's gathered logits, the prefill's and each (teacher-
    forced) decode step's, within 2e-5 of the JAX package's single-device
    steps on the same weights."""
    _, _, _, jsteps, _, _ = _reference(E)
    for r in runs(E, shape):
        errs = [_err(a, b) for a, b in zip(r["logits"], jsteps)]
        assert len(errs) == GEN and max(errs) <= TOL, errs


@pytest.mark.parametrize("E,shape", CASES, ids=IDS)
def test_greedy_tokens_equal_the_one_process_port(E, shape, runs):
    params, toks, jtoks, *_ = _reference(E)
    one = greedy_decode(params, _cfg(E), torch.from_numpy(toks), GEN)
    np.testing.assert_array_equal(one.tokens, jtoks)
    for r in runs(E, shape):
        np.testing.assert_array_equal(r["greedy"], one.tokens)


@pytest.mark.parametrize("S", LAYER_S, ids=["S16", "S1"])
@pytest.mark.parametrize("E,shape", CASES, ids=IDS)
def test_moe_layer_equals_the_reference_shard_map(E, shape, S, runs,
                                                  shard_map):
    """Each rank's MoE output, on its data shard's rows, within 1e-5 of
    the reference's own ``_moe_apply_shard_map`` on the same mesh shape;
    the ranks of one data shard agree bit for bit (one sum over
    ``model``), and whole expert weights on a rank are refused."""
    want = shard_map[(E, shape, S)]
    assert np.abs(want).max() > 0.1
    rows = LAYER_B // shape[0]
    ranks = runs(E, shape)
    for i, r in enumerate(ranks):
        d = i // shape[1]
        got = r["layer"][S]
        assert got.shape == (rows, S, _cfg(E).d_model)
        assert _err(got, want[d * rows:(d + 1) * rows]) <= LAYER_TOL
        assert np.array_equal(got, ranks[d * shape[1]]["layer"][S])
        assert r["refused"]


@pytest.mark.parametrize("E,shape", CASES, ids=IDS)
def test_moe_layer_calls_the_reference_collectives(E, shape, runs):
    """No all_to_all: expert-parallel and ff-sharded layers sum once over
    ``model``; with d over ``data`` a prefill gathers ``wi`` and ``wo``
    over ``data`` first, and a one-token step gathers the rows, sums gate
    and up over ``data`` (one call for both), sums over ``model`` and
    gathers the output's columns."""
    fsdp = E % shape[1] != 0 and shape[0] > 1
    want = {16: [("all_reduce", "model")], 1: [("all_reduce", "model")]}
    if fsdp:
        want = {16: [("all_gather", "data"), ("all_gather", "data"),
                     ("all_reduce", "model")],
                1: [("all_gather", "data"), ("all_reduce", "data"),
                    ("all_reduce", "model"), ("all_gather", "data")]}
    for r in runs(E, shape):
        assert r["calls"] == want


# -- the rank layout, in one process ------------------------------------------

def _params(cfg, seed=0):
    return api.init(torch.Generator().manual_seed(seed), cfg)


@pytest.mark.parametrize("E,shape", CASES, ids=IDS)
def test_layout_and_blocks_follow_the_expert_specs(E, shape):
    """Each rank's :class:`Experts` and its blocks as the sanitized specs
    place them: E/model consecutive experts where they divide the axis,
    else every expert at its ff block and, with ``data`` > 1, its d block.
    The MoE ``wi`` (E, 2, d, ff) keeps gate and up on their own axis: the
    ranks' ff blocks pair gate_r with up_r, and their partial expert
    outputs sum to the whole. ``fit`` keeps the blocks and cuts a whole
    tree to views of them."""
    cfg = _cfg(E)
    params = _params(cfg)
    placed = ST.param_specs(cfg, abstract_mesh(shape, NAMES), kind="decode")
    shapes, specs = ST.tensors_of(placed), ST.specs_of(placed)
    wi, wo = params["layers"]["ffn"]["wi"], params["layers"]["ffn"]["wo"]
    dd, m = shape
    d, ff = cfg.d_model, cfg.d_ff
    buf = torch.randn((2, E, 8, d), generator=torch.Generator()
                      .manual_seed(1))
    whole = T._expert_compute(buf, wi[0], wo[0])
    for dr in range(dd):
        parts = 0
        for r in range(m):
            mesh = _Rank(shape, NAMES, (dr, r))
            lay = TP.layout(cfg, mesh, specs)
            ex = lay.moe
            assert not lay.split_ffn and lay.split_heads and lay.split_vocab
            cut = TP.shard_params(params, cfg, mesh, "decode")
            got = cut["layers"]["ffn"]
            assert torch.equal(got["router"]["kernel"],
                               params["layers"]["ffn"]["router"]["kernel"])
            if E % m == 0:
                n = E // m
                assert ex.experts == (r * n, (r + 1) * n)
                assert ex.split_experts and ex.ff == (0, ff)
                assert ex.embed == (0, d) and ex.data_size == 1
                assert torch.equal(got["wi"], wi[:, r * n:(r + 1) * n])
                assert torch.equal(got["wo"], wo[:, r * n:(r + 1) * n])
            else:
                f, dl = ff // m, d // dd
                assert ex.experts == (0, E) and ex.ff == (r * f, (r + 1) * f)
                assert not ex.split_experts
                assert ex.embed == (dr * dl, (dr + 1) * dl)
                assert (ex.data_size, ex.data_index) == (
                    (dd, dr) if dd > 1 else (1, 0))
                fs, ds = slice(r * f, (r + 1) * f), slice(dr * dl,
                                                          (dr + 1) * dl)
                assert got["wi"].shape[2] == 2
                assert torch.equal(got["wi"], wi[..., ds, fs])
                assert torch.equal(got["wo"], wo[:, :, fs, ds])
                if dd == 1:
                    parts = parts + T._expert_compute(buf, got["wi"][0],
                                                      got["wo"][0])
            kept = TP.fit(cut, shapes, specs, cfg, mesh)["layers"]["ffn"]
            assert kept["wi"] is got["wi"] and kept["wo"] is got["wo"]
            view = TP.fit(params, shapes, specs, cfg, mesh)["layers"]["ffn"]
            assert torch.equal(view["wi"], got["wi"])
            assert view["wi"].data_ptr() != got["wi"].data_ptr()
        if E % m and dd == 1:
            torch.testing.assert_close(parts, whole, rtol=1e-5, atol=1e-5)


def _ffn_specs(specs, wi, wo):
    return dict(specs, layers=dict(specs["layers"], ffn=dict(
        specs["layers"]["ffn"], wi=wi, wo=wo)))


@pytest.mark.parametrize("wi,wo,error", [
    (Spec(None, "data"), Spec(None, "data"), NotImplementedError),
    (Spec(), Spec(), NotImplementedError),
    (Spec(None, None, None, "model", "data"),
     Spec(None, None, "data", "model"), NotImplementedError),
    (Spec(None, "model"), Spec(None, None, "model"), ValueError)],
    ids=["experts-on-data", "replicated", "d-on-model", "wi-wo-differ"])
def test_layout_refuses_expert_placements_it_does_not_execute(wi, wo, error):
    """The experts or their ff columns on ``model`` and d on ``data`` or
    whole: any other placement, or ``wi`` and ``wo`` cut differently,
    raises."""
    cfg = _cfg(4)
    specs = ST.specs_of(ST.param_specs(cfg, abstract_mesh((2, 2), NAMES),
                                       kind="prefill"))
    with pytest.raises(error):
        TP.layout(cfg, _Rank((2, 2), NAMES, (0, 1)),
                  _ffn_specs(specs, wi, wo))


def test_moe_steps_run_where_the_other_families_raise():
    """``mesh_plan`` lets the MoE's prefill, decode and train steps
    through at ``model`` > 1 (the train plan holds the leaves split on
    ``model`` and the rank's experts) and still refuses the hybrid's
    train step, whose mamba mixers it does not train, naming the dry
    run."""
    mesh = _Rank((1, 2), NAMES, (0, 1))
    plan = ST.mesh_plan(_cfg(4), mesh, zero1=False, kind="train")
    assert plan.model is not None and plan.model.size == 2
    assert plan.layout.moe.split_experts and plan.layout.moe.experts == (2, 4)
    with pytest.raises(NotImplementedError, match="dryrun"):
        ST.mesh_plan(tiny_version(get_config("jamba-v0.1-52b")), mesh,
                     zero1=False, kind="train")
    for kind in ("prefill", "decode"):
        plan = ST.mesh_plan(_cfg(4), mesh, zero1=False, kind=kind)
        assert (plan.index, plan.count, plan.groups) == (0, 1, ())
