"""The GPipe pipeline (``repro_torch.parallel.pipeline``) and the
expert-parallel MoE (``repro_torch.models.transformer.moe_apply`` under a
mesh with ``model`` > 1) on CPU process groups, against direct application
and the JAX package.

Multi-process cases run two gloo processes through
``test_torch_mesh_train.run_ranks`` (each joined with its own 60 s limit,
killed on expiry, and the test then fails).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import tiny_version as j_tiny
from repro.configs.base import get_config as j_get_config
from repro.models import api as JAPI
from repro.models import transformer as JT
from repro.parallel import pipeline as JPP
from repro_torch.compat import distribute_tensor, init_device_mesh, local
from repro_torch.configs.archs import tiny_version
from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.parallel import pipeline as PP
from repro_torch.parallel.sharding import (DEFAULT_RULES, axis_rules,
                                           placements)
from repro_torch.parallel.specs import param_specs, sanitize_tree
from repro_torch.tree import tree_map
from test_torch_mesh_train import run_ranks, solo_group  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _stage_params(S, dim=8, hidden=16):
    """The JAX package's stage MLP (S stages) as numpy."""
    p = JPP.stage_mlp_init(jax.random.key(0), S, dim, hidden)
    return {k: np.array(v) for k, v in p.items()}


def _x(B=8, dim=8):
    return np.array(jax.random.normal(jax.random.key(1), (B, dim)))


def _direct(params, x):
    """Stage after stage, in torch, on the carried weights."""
    y = torch.from_numpy(x)
    for s in range(params["w1"].shape[0]):
        y = PP.stage_mlp_apply({k: torch.from_numpy(v[s])
                                for k, v in params.items()}, y)
    return y.numpy()


def test_jax_pipeline_single_axis_equals_direct():
    """The reference on a 1-wide stage axis (tests/test_system.py), and
    its direct application equal to the port's on the same weights."""
    params = _stage_params(1)
    x = _x(4)
    mesh = jax.make_mesh((1,), ("stage",))
    out = JPP.pipeline_apply(JPP.stage_mlp_apply,
                             jax.tree.map(jnp.asarray, params),
                             jnp.asarray(x), mesh=mesh, n_microbatches=2)
    expected = JPP.stage_mlp_apply(
        {k: jnp.asarray(v[0]) for k, v in params.items()}, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(out), np.asarray(expected), **TOL)
    np.testing.assert_allclose(_direct(params, x), np.asarray(expected),
                               **TOL)


@pytest.mark.parametrize("M_", [1, 2])
def test_port_pipeline_one_stage_is_direct(M_, solo_group):  # noqa: F811
    params, x = _stage_params(1), _x(4)
    mesh = M.make_mesh((1,), ("stage",), device="cpu")
    out = PP.pipeline_apply(PP.stage_mlp_apply,
                            {k: torch.from_numpy(v) for k, v in
                             params.items()}, torch.from_numpy(x), mesh=mesh,
                            n_microbatches=M_)
    np.testing.assert_allclose(out.numpy(), _direct(params, x), **TOL)


def _pipeline_worker(rank, world, params, x, n_micro):
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
    out = PP.pipeline_apply(PP.stage_mlp_apply,
                            {k: torch.from_numpy(v) for k, v in
                             params.items()}, torch.from_numpy(x), mesh=mesh,
                            n_microbatches=n_micro)
    return out.numpy()


@pytest.mark.parametrize("n_micro", [2, 4])
def test_port_pipeline_two_stages_equals_direct(n_micro, tmp_path):
    """S = 2 over two processes, M = 2 and 4 microbatches: every rank
    returns the last stage's outputs, equal to the two stages applied in
    turn (and to the JAX stage MLP applied so)."""
    params, x = _stage_params(2), _x(8)
    got = run_ranks(_pipeline_worker, 2, tmp_path, params, x, n_micro)
    want = _direct(params, x)
    jx = jnp.asarray(x)
    for s in range(2):
        jx = JPP.stage_mlp_apply({k: jnp.asarray(v[s])
                                  for k, v in params.items()}, jx)
    for out in got:
        np.testing.assert_allclose(out, want, **TOL)
        np.testing.assert_allclose(out, np.asarray(jx), **TOL)


# -- expert-parallel MoE -----------------------------------------------------------

def _moe_inputs():
    """Tiny moonshot's first MoE layer (fp32, JAX init carried) and an
    input of 4 rows."""
    jcfg = j_tiny(j_get_config("moonshot-v1-16b-a3b"))
    jparams = JAPI.init(jax.random.key(4), jcfg)
    jffn = jax.tree.map(lambda t: t[0], jparams["layers"]["ffn"])
    x = np.array(jax.random.normal(jax.random.key(5),
                                     (4, 32, jcfg.d_model)))
    ffn = lm_params_from_jax(jax.device_get(jffn))
    return jcfg, jffn, ffn, x


def _moe_worker(rank, world, ffn, x):
    """Places the experts by ``param_specs`` (expert dim on ``model``),
    runs the expert-parallel MoE on this rank's rows, and returns the
    output, the local expert counts of wi/wo, and whether whole
    (unplaced) expert weights were refused."""
    cfg = tiny_version(get_config("moonshot-v1-16b-a3b"))
    mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data",
                                                                "model"))
    specs = sanitize_tree(param_specs({"ffn": ffn}, mesh, cfg, "train"),
                          {"ffn": ffn}, mesh)["ffn"]
    placed = tree_map(lambda t, s: distribute_tensor(t, mesh,
                                                     placements(mesh, s)),
                      ffn, specs)
    rows = x.shape[0] // world
    part = torch.from_numpy(x[rank * rows:(rank + 1) * rows])
    with axis_rules(DEFAULT_RULES, mesh), torch.no_grad():
        assert T._expert_mesh() is mesh
        out = T.moe_apply(placed, cfg, part)
        try:
            T.moe_apply(ffn, cfg, part)
            refused = False
        except ValueError:
            refused = True
    counts = (local(placed["wi"]).shape[0], local(placed["wo"]).shape[0])
    return out.numpy(), counts, tuple(specs["wi"]), refused


def test_expert_parallel_moe_equals_single_device(tmp_path):
    """model = 2 with the experts placed by ``param_specs``: each rank
    holds two experts of four (its local block), routes its rows, and its
    experts run on it for both ranks' tokens (all_to_all there and back);
    the output equals the port's single-device MoE and the JAX
    reference's, within 1e-5. Whole expert weights on a rank are refused."""
    jcfg, jffn, ffn, x = _moe_inputs()
    cfg = tiny_version(get_config("moonshot-v1-16b-a3b"))
    assert cfg.n_experts % 2 == 0
    ranks = run_ranks(_moe_worker, 2, tmp_path, ffn, x)
    for _, counts, wi_spec, refused in ranks:
        assert counts == (cfg.n_experts // 2,) * 2
        assert wi_spec[0] == "model"
        assert refused
    got = np.concatenate([r[0] for r in ranks])
    with torch.no_grad():
        single = T.moe_apply(ffn, cfg, torch.from_numpy(x)).numpy()
    ref = np.asarray(JT.moe_apply(jffn, jcfg, jnp.asarray(x)))
    np.testing.assert_allclose(got, single, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.abs(single).max() > 0.1


def test_moe_takes_the_single_device_path_off_a_mesh():
    cfg = tiny_version(get_config("moonshot-v1-16b-a3b"))
    assert T._expert_mesh() is None
    with axis_rules(DEFAULT_RULES, None):
        assert T._expert_mesh() is None
    assert cfg.n_experts > 1
