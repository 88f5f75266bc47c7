"""The port's spec layer (``repro_torch.parallel.{sharding,specs}``,
``launch.steps``' spec functions) held leaf by leaf to the JAX package's
at the published widths, on abstract (1, 1), (16, 16) and (2, 16, 16)
meshes, for every family and step kind; and ``resolve_spec`` and friends
on the cases of ``tests/test_sharding.py``."""
import functools
import re

import jax
import jax.tree_util as jtu
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.compat import abstract_mesh as j_abstract_mesh
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import all_archs, applicable_shapes
from repro.configs.base import get_config as j_get_config
from repro.launch import steps as JST
from repro.models import api as JAPI
from repro.parallel import sharding as JSH
from repro.parallel import specs as JSP
from repro_torch.compat import abstract_mesh
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import steps as ST
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as SH
from repro_torch.parallel import specs as SP
from repro_torch.tree import tree_map_with_path

ARCHS = sorted(all_archs())
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
KINDS = ("train", "prefill", "decode")


@functools.cache
def _jax_shapes(arch):
    cfg = j_get_config(arch)
    return jax.eval_shape(lambda: JAPI.init(jax.random.key(0), cfg))


@functools.cache
def _port_shapes(arch):
    return api.init_meta(get_config(arch))


def _jflat(tree):
    return {JSP._path_str(p): tuple(s) for p, s in jtu.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))}


def _tflat(shapes, specs):
    out = {}
    tree_map_with_path(
        lambda p, _, s: out.__setitem__("/".join(map(str, p)), tuple(s)),
        shapes, specs)
    return out


def _meshes(name):
    shape, axes = MESHES[name]
    return j_abstract_mesh(shape, axes), abstract_mesh(shape, axes)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_zero1_and_sanitized_specs_match_jax(arch, mesh):
    jm, tm = _meshes(mesh)
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    js_shapes, ts_shapes = _jax_shapes(arch), _port_shapes(arch)
    for kind in KINDS:
        jraw = JSP.param_specs(js_shapes, jm, cfg=jcfg, kind=kind)
        traw = SP.param_specs(ts_shapes, tm, cfg=tcfg, kind=kind)
        assert _tflat(ts_shapes, traw) == _jflat(jraw), kind
        js = JSP.sanitize_tree(jraw, js_shapes, jm)
        ts = SP.sanitize_tree(traw, ts_shapes, tm)
        assert _tflat(ts_shapes, ts) == _jflat(js), kind
        jz = JSP.zero1_specs(js, js_shapes, jm)
        tz = SP.zero1_specs(ts, ts_shapes, tm)
        assert _tflat(ts_shapes, tz) == _jflat(jz), kind


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_batch_and_cache_specs_match_jax(arch, mesh):
    jm, tm = _meshes(mesh)
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for name in applicable_shapes(jcfg):
        jshape, tshape = J_SHAPES[name], SHAPES[name]
        jrules = JST.make_rules(jcfg, jshape, jm)
        trules = ST.make_rules(tcfg, tshape, tm)
        assert trules == jrules, name
        jb = JST.batch_specs(jcfg, jshape, jm)
        tb = ST.batch_specs(tcfg, tshape, tm)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert tuple(tb[k].tensor.shape) == tuple(jb[k].shape), (name, k)
            assert tuple(tb[k].spec) == tuple(jb[k].sharding.spec), (name, k)
        if jshape.kind != "decode":
            continue
        seq_sh = jshape.global_batch < (16 if mesh == "16x16" else
                                        32 if mesh == "2x16x16" else 1)
        jcache = jax.eval_shape(lambda: JAPI.init_cache(
            jcfg, jshape.global_batch, jshape.seq_len))
        tcache = api.init_cache(tcfg, tshape.global_batch, tshape.seq_len,
                                device="meta")
        with JSH.axis_rules(jrules, jm):
            jc = JSP.cache_specs(jcache, jm, seq_sharded=seq_sh)
        with SH.axis_rules(trules, tm):
            tc = SP.cache_specs(tcache, tm, seq_sharded=seq_sh)
        assert _tflat(tcache, tc) == _jflat(jc), name
        placed = ST.cache_specs(tcfg, tshape, tm)
        assert _tflat(tcache, ST.specs_of(placed)) == _jflat(jax.tree.map(
            lambda s: s.sharding.spec, JST.cache_specs(jcfg, jshape, jm))), \
            name


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m",
                                  "moonshot-v1-16b-a3b"])
def test_state_and_input_specs_carry_zero1_specs(arch):
    """state_specs: params by their sanitized specs, master/m/v by the
    ZeRO-1 upgrade, as the reference's TrainState of ShapeDtypeStructs."""
    _, tm = _meshes("16x16")
    jm, _ = _meshes("16x16")
    cfg, jcfg = get_config(arch), j_get_config(arch)
    st = ST.state_specs(cfg, adamw.AdamWConfig(), tm)
    shapes = ST.tensors_of(st.params)
    js = JSP.sanitize_tree(JSP.param_specs(_jax_shapes(arch), jm, cfg=jcfg,
                                           kind="train"), _jax_shapes(arch),
                           jm)
    assert _tflat(shapes, ST.specs_of(st.params)) == _jflat(js)
    jz = _jflat(JSP.zero1_specs(js, _jax_shapes(arch), jm))
    for tree in (st.opt.master, st.opt.m, st.opt.v):
        assert _tflat(shapes, ST.specs_of(tree)) == jz
    assert tuple(st.opt.step.spec) == ()
    args = ST.input_specs(cfg, SHAPES["decode_32k"], tm)
    assert len(args) == 4 and tuple(args[3].tensor.shape) == ()


# -- the cases of tests/test_sharding.py ---------------------------------------

def _mesh11():
    return abstract_mesh((1, 1), ("data", "model"))


def test_resolve_spec_drops_missing_axes():
    spec = SH.resolve_spec(("batch", "seq", "heads"), mesh=_mesh11())
    # "pod" missing from mesh → dropped from the batch tuple
    assert spec == ("data", None, "model")
    jspec = JSH.resolve_spec(("batch", "seq", "heads"),
                             mesh=j_abstract_mesh((1, 1), ("data", "model")))
    assert tuple(jspec) == tuple(spec)


@pytest.mark.parametrize("logical", [
    ("batch", "seq", "embed"), ("embed", "vocab"), ("stack", "embed", "mlp"),
    ("expert", None, "embed", "mlp"), ("batch", "seq_shard", "kv_heads"),
    ("heads", "kv_heads"), ("vocab",), (None, None)])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resolve_spec_matches_jax(logical, mesh):
    jm, tm = _meshes(mesh)
    assert tuple(SH.resolve_spec(logical, mesh=tm)) == tuple(
        JSH.resolve_spec(logical, mesh=jm))
    rules = dict(SH.DEFAULT_RULES, batch=None, seq_shard="data")
    assert tuple(SH.resolve_spec(logical, rules, tm)) == tuple(
        JSH.resolve_spec(logical, rules, jm))


def test_sanitize_drops_nondivisible():
    assert SP.sanitize_spec(SH.P(None, "model"), (8, 7), _mesh11()) == \
        (None, "model")          # axis size 1 divides everything
    m = abstract_mesh((2, 4), ("data", "model"))
    jm = j_abstract_mesh((2, 4), ("data", "model"))
    for spec, shape in [(("data", "model"), (8, 7)),
                        ((("data", "model"), None), (4, 3)),
                        ((("data", "model"),), (6,)), (("model",), (12,))]:
        assert tuple(SP.sanitize_spec(SH.P(*spec), shape, m)) == tuple(
            JSP.sanitize_spec(JP(*spec), shape, jm))


def test_param_specs_rank_consistency():
    from repro_torch.configs.archs import tiny_version
    mesh = _mesh11()
    for arch in ["tinyllama-1.1b", "mamba2-130m", "jamba-v0.1-52b",
                 "whisper-medium", "moonshot-v1-16b-a3b"]:
        shapes = api.init_meta(tiny_version(get_config(arch)))
        specs = SP.param_specs(shapes, mesh,
                               cfg=tiny_version(get_config(arch)),
                               kind="train")
        tree_map_with_path(
            lambda p, t, s: None if len(s) <= t.dim() else pytest.fail(
                f"{p}: {s} for {tuple(t.shape)}"), shapes, specs)


def test_zero1_no_duplicate_axes():
    out = SP.zero1_specs(SH.P("data", None),
                         torch.empty((16, 32), device="meta"), _mesh11(),
                         axis="data")
    used = [a for a in out if a is not None]
    assert len(used) == len(set(used))


def test_attention_kv_fallbacks():
    """kv_heads % model != 0 must not shard wk/wv by head (grok's 8 kv
    heads on a 16-wide model axis)."""
    cfg = get_config("grok-1-314b").with_(n_layers=2)
    shapes = api.init_meta(cfg)
    mesh = abstract_mesh((16, 16), ("data", "model"))
    for kind in ("train", "decode"):
        specs = SP.param_specs(shapes, mesh, cfg=cfg, kind=kind)
        seen = []

        def check(path, t, s):
            if re.search(r"(wk|wv)$", "/".join(map(str, path))):
                seen.append(path)
                dims = list(s)
                assert len(dims) < 2 or dims[-2] != "model"
        tree_map_with_path(check, shapes, specs)
        assert seen


def test_make_rules_seq_shard_for_long_context():
    cfg = get_config("mamba2-130m")
    mesh = abstract_mesh((1, 4, 1), ("pod", "data", "model"))
    rules = ST.make_rules(cfg, SHAPES["long_500k"], mesh)
    assert rules["batch"] is None           # batch 1 can't fill DP
    assert rules["seq_shard"] == "data"     # SP takes the axis instead


def test_constrain_is_a_no_op_off_a_mesh():
    x = torch.ones(2, 3)
    assert SH.constrain(x, ("batch", "embed")) is x
    with SH.axis_rules(SH.DEFAULT_RULES, _mesh11()):
        assert SH.constrain(x, ("batch", "embed")) is x   # a local tensor


def test_placements_follow_the_spec():
    from repro_torch.compat import Replicate, Shard
    tm = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert SH.placements(tm, (("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert SH.placements(tm, ()) == [Replicate()] * 3
