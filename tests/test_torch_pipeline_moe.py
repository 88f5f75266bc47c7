"""The GPipe pipeline (``repro_torch.parallel.pipeline``) and the
expert-parallel MoE (``repro_torch.models.transformer.moe_apply`` under a
tensor-parallel layout with ``model`` > 1) on CPU process groups, against
direct application and the JAX package.

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
from repro_torch.compat import init_device_mesh
from repro_torch.configs.archs import tiny_version
from repro_torch.configs.base import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.parallel import pipeline as PP
from repro_torch.parallel import tensor as TP
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
    """Tiny moonshot (fp32, JAX init carried), its first MoE layer in JAX
    and an input of 4 rows."""
    jcfg = j_tiny(j_get_config("moonshot-v1-16b-a3b"))
    jparams = JAPI.init(jax.random.key(4), jcfg)
    jffn = jax.tree.map(lambda t: t[0], jparams["layers"]["ffn"])
    x = np.array(jax.random.normal(jax.random.key(5),
                                     (4, 32, jcfg.d_model)))
    params = lm_params_from_jax(jax.device_get(jparams))
    return jcfg, jffn, params, x


def _moe_worker(rank, world, params, x):
    """Cuts the params to this rank's blocks (``shard_params``: E/model
    experts), makes its layout current and runs the first layer's MoE on
    every row, as the reference's ``shard_map`` gives each ``model`` rank
    all of its data shard's rows. Returns the output, the local expert
    counts of wi/wo, wi's spec, and whether whole expert weights were
    refused."""
    cfg = tiny_version(get_config("moonshot-v1-16b-a3b"))
    mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data",
                                                                "model"))
    specs = ST.specs_of(ST.param_specs(cfg, mesh, kind="prefill"))
    first = lambda t: t[0]  # noqa: E731
    ffn = tree_map(first, TP.shard_params(params, cfg, mesh,
                                          "prefill")["layers"]["ffn"])
    with TP.installed(TP.layout(cfg, mesh, specs)), torch.no_grad():
        out = T.moe_apply(ffn, cfg, torch.from_numpy(x))
        try:
            T.moe_apply(tree_map(first, params["layers"]["ffn"]), cfg,
                        torch.from_numpy(x))
            refused = False
        except ValueError:
            refused = True
    counts = (ffn["wi"].shape[0], ffn["wo"].shape[0])
    return out.numpy(), counts, tuple(specs["layers"]["ffn"]["wi"]), refused


def test_expert_parallel_moe_equals_single_device(tmp_path):
    """model = 2 with the experts placed by ``param_specs``: each rank
    holds two experts of four (its block) and every row; it dispatches
    only the slots routed to its experts and the ranks' partial outputs
    are summed (no all_to_all). Every rank's output equals the port's
    single-device MoE and the JAX reference's, within 1e-5. Whole expert
    weights on a rank are refused."""
    jcfg, jffn, params, x = _moe_inputs()
    cfg = tiny_version(get_config("moonshot-v1-16b-a3b"))
    assert cfg.n_experts % 2 == 0
    ranks = run_ranks(_moe_worker, 2, tmp_path, params, x)
    with torch.no_grad():
        single = T.moe_apply(tree_map(lambda t: t[0],
                                      params["layers"]["ffn"]), cfg,
                             torch.from_numpy(x)).numpy()
    ref = np.asarray(JT.moe_apply(jffn, jcfg, jnp.asarray(x)))
    for got, counts, wi_spec, refused in ranks:
        assert counts == (cfg.n_experts // 2,) * 2
        assert wi_spec[1] == "model"
        assert refused
        np.testing.assert_allclose(got, single, **TOL)
        np.testing.assert_allclose(got, ref, **TOL)
    assert np.abs(single).max() > 0.1


def test_moe_takes_the_single_device_path_off_a_mesh():
    """No layout is current off a mesh step: the MoE is the reference's
    single-device path, within 1e-5 of its ``_moe_apply_dense``."""
    jcfg, jffn, params, x = _moe_inputs()
    cfg = tiny_version(get_config("moonshot-v1-16b-a3b"))
    assert TP.current() is None and cfg.n_experts > 1
    with torch.no_grad():
        got = T.moe_apply(tree_map(lambda t: t[0], params["layers"]["ffn"]),
                          cfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(JT._moe_apply_dense(jffn, jcfg, jnp.asarray(x))),
        **TOL)
