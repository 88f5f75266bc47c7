"""The PyTorch port stands alone: its numpy modules are faithful copies of
the JAX package's, and neither the package nor ``chip_smoke.py`` imports
JAX or anything of ``repro``."""
import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import planner as JPL  # noqa: E402
from repro.core import simulator as JSIM  # noqa: E402
from repro_torch.core import planner as TPL  # noqa: E402
from repro_torch.core import simulator as TSIM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(path, name):
    """Import a repository script by path (neither it nor ``benchmarks``
    is a package on ``sys.path``)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


common = _load("benchmarks/common.py", "_bench_common")
COPIED = ["obs/stats.py", "core/grouping.py", "core/assignment.py",
          "core/ncut.py", "core/hwspec.py", "coding/codes.py",
          "coding/spec.py", "coding/compute.py", "coding/planner.py",
          "core/plan_ir.py", "core/planner.py", "core/simulator.py",
          "runtime/clock.py", "runtime/failures.py", "runtime/controller.py",
          "core/failout.py", "core/scenarios.py", "obs/trace.py",
          "obs/metrics.py", "obs/report.py", "obs/__init__.py",
          "runtime/fleet.py", "data/images.py", "data/tokens.py"]
IMPORT = re.compile(r"^(\s*(?:from|import) )repro\.", re.M)


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_is_verbatim(module):
    """Each copy is its original with ``repro.`` → ``repro_torch.`` in the
    import lines, and nothing else changed."""
    original = (ROOT / "src" / "repro" / module).read_text()
    copy = (ROOT / "src" / "repro_torch" / module).read_text()
    assert copy == IMPORT.sub(r"\1repro_torch.", original)


@pytest.mark.parametrize("kw", [{}, {"mem_range": (1e6, 4e6)},
                                {"success_prob": 0.7}])
def test_same_fleet_same_plan(kw):
    """The slice's plans: the same fleet and affinity graph give the same
    PlanIR arrays in both packages."""
    jf = JSIM.make_fleet(8, seed=1, **kw)
    tf = TSIM.make_fleet(8, seed=1, **kw)
    assert [dataclasses.astuple(d) for d in jf] == \
        [dataclasses.astuple(d) for d in tf]
    A = common.affinity_graph(64)
    jir = JPL.tune_d_th_ir(jf, A, common.paper_students(), p_th=0.25)
    tir = TPL.tune_d_th_ir(tf, A, common.paper_students(), p_th=0.25)
    for f in dataclasses.fields(jir):
        a, b = getattr(jir, f.name), getattr(tir, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("failure", [
    dict(outages=True), dict(crash_prob=0.2, outages=True),
    dict(crash_prob=0.3, outages=False),
    dict(forced_failures=["d1", "d4"], crash_prob=0.1, outages=True)])
def test_same_failure_draws_and_reductions(failure):
    A = common.affinity_graph(64)
    ja = JSIM.plan_arrays(JPL.tune_d_th_ir(
        JSIM.make_fleet(8, seed=1, mem_range=(1e6, 4e6)), A,
        common.paper_students(), p_th=0.25))
    ta = TSIM.plan_arrays(TPL.tune_d_th_ir(
        TSIM.make_fleet(8, seed=1, mem_range=(1e6, 4e6)), A,
        common.paper_students(), p_th=0.25))
    for f in dataclasses.fields(ja):
        a, b = getattr(ja, f.name), getattr(ta, f.name)
        if f.name == "slot_cols":
            assert len(a) == len(b)
            for ca, cb in zip(a, b):
                np.testing.assert_array_equal(ca, cb)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    jalive, _ = JSIM.FailureModel(**failure).sample(
        np.random.default_rng(7), ja, 50)
    talive, _ = TSIM.FailureModel(**failure).sample(
        np.random.default_rng(7), ta, 50)
    np.testing.assert_array_equal(jalive, talive)
    for deadline in (float("inf"), 1.5):
        for a, b in zip(JSIM.reduce_trials(ja, jalive, None, deadline),
                        TSIM.reduce_trials(ta, talive, None, deadline)):
            np.testing.assert_array_equal(a, b)


def test_chip_smoke_fleet_definitions_match_benchmarks():
    chip_smoke = _load("chip_smoke.py", "_chip_smoke")
    for M in (16, 256):
        np.testing.assert_array_equal(chip_smoke.affinity_graph(M),
                                      common.affinity_graph(M))
    assert [dataclasses.astuple(s) for s in chip_smoke.paper_students()] == \
        [dataclasses.astuple(s) for s in common.paper_students()]


def test_port_imports_neither_jax_nor_repro():
    """Importing every module of the port, and chip_smoke.py, in a fresh
    interpreter loads no ``jax`` and no ``repro`` module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["models.ssm", "models.hybrid",
                                    "kernels.ssd_scan", "kernels.topk_gating"])
def test_new_lm_modules_import_neither_jax_nor_repro(module):
    """Each module of the SSM, MoE and hybrid slice, imported alone in a
    fresh interpreter, loads no ``jax`` and no ``repro`` module."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('repro_torch.{module}')\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


MEASURED_PATH = ["kernels.dequant_matmul", "kernels.coded_matmul",
                 "kernels.autotune", "launch.microbench"]


@pytest.mark.parametrize("module", MEASURED_PATH)
def test_measured_path_modules_import_neither_jax_nor_repro(module):
    """Each module of the measured-cost-model and autotune slice, imported
    alone in a fresh interpreter, loads no ``jax`` and no ``repro``
    module."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('repro_torch.{module}')\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


OFFLINE_SLICE = ["core.failout", "core.scenarios", "core.distill",
                 "core.activation_graph", "core.pipeline", "obs",
                 "obs.trace", "obs.metrics", "obs.report", "runtime.fleet",
                 "data.images", "convert"]


@pytest.mark.parametrize("module", OFFLINE_SLICE)
def test_offline_slice_modules_import_neither_jax_nor_repro(module):
    """Each module of the offline-phase, fleet and observability slice,
    imported alone in a fresh interpreter, loads no ``jax`` and no
    ``repro`` module (``data/`` has no ``__init__.py``, as in the JAX
    package, so the package walk above does not reach ``data.images``)."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('repro_torch.{module}')\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


TRAIN_SLICE = ["optim.adamw", "optim.compression", "launch.steps",
               "launch.train", "ckpt.checkpoint", "core.lm_students",
               "data.tokens"]


@pytest.mark.parametrize("module", TRAIN_SLICE)
def test_train_slice_modules_import_neither_jax_nor_repro(module):
    """Each module of the LM-training slice, imported alone in a fresh
    interpreter, loads no ``jax`` and no ``repro`` module."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('repro_torch.{module}')\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


MESH_SLICE = ["compat", "launch.mesh", "parallel.sharding",
              "parallel.specs", "parallel.pipeline", "launch.roofline",
              "launch.dryrun", "parallel.tensor"]


@pytest.mark.parametrize("module", MESH_SLICE)
def test_mesh_slice_modules_import_neither_jax_nor_repro(module):
    """Each module of the multi-device slice, imported alone in a fresh
    interpreter, loads no ``jax`` and no ``repro`` module."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('repro_torch.{module}')\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_source_walk_covers_the_measured_path_modules():
    walked = {p.relative_to(ROOT / "src" / "repro_torch").with_suffix("")
              .as_posix().replace("/", ".")
              for p in (ROOT / "src" / "repro_torch").rglob("*.py")}
    assert set(MEASURED_PATH) <= walked


def test_port_sources_name_no_jax_or_repro_import():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "tools").glob("*.py"))
    bad = re.compile(r"^\s*(import (jax|repro)\b|from (jax|repro)(\.|\s))",
                     re.M)
    offenders = [str(f) for f in files if bad.search(f.read_text())]
    assert not offenders, offenders


@pytest.mark.parametrize("plan", ["coded(6,4)", "mixed", "adaptive"])
def test_coded_runtime_equals_jax_exactly(plan):
    """The port's CodedRuntime (copied but for ``enc_device``) gives the
    JAX package's encode matrix and decode weights exactly, over every
    share-arrival pattern of the plan's shares."""
    from repro.coding.runtime import CodedRuntime as JRT
    from repro_torch.coding.runtime import CodedRuntime as TRT
    from test_torch_coded_serving import PLANS
    jir, tir = PLANS[plan]()
    jrt, trt = JRT(jir), TRT(tir)
    np.testing.assert_array_equal(jrt.enc, trt.enc)
    np.testing.assert_array_equal(jrt.coded_slots, trt.coded_slots)
    R = jrt.n_shares
    patterns = ((np.arange(2 ** R)[:, None] >> np.arange(R)) & 1).astype(bool)
    jd, td = jrt.decode_weights(patterns), trt.decode_weights(patterns)
    assert jd.dtype == td.dtype == np.float32
    np.testing.assert_array_equal(jd, td)
    enc = trt.enc_device(torch.device("cpu"))
    assert enc.dtype == torch.float32 and enc is trt.enc_device(
        torch.device("cpu"))
    np.testing.assert_array_equal(enc.numpy(), jrt.enc)


def _config_fields(cfg):
    """A config's fields, dtypes by name (``torch.bfloat16`` and
    ``jnp.bfloat16`` both as "bfloat16")."""
    import jax.numpy as jnp
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name.endswith("_dtype"):
            v = (str(v).removeprefix("torch.") if isinstance(v, torch.dtype)
                 else jnp.dtype(v).name)
        out[f.name] = v
    return out


@pytest.mark.parametrize("tiny", [False, True], ids=["published", "tiny"])
def test_config_registry_equals_the_jax_registry(tiny):
    """Every registered config (and its ``tiny_version``) equals the JAX
    package's field by field, dtypes compared by name."""
    from repro.configs.archs import tiny_version as jtiny
    from repro.configs.base import all_archs as jall
    from repro_torch.configs.archs import tiny_version as ttiny
    from repro_torch.configs.base import all_archs as tall
    jr, tr = jall(), tall()
    assert sorted(jr) == sorted(tr) and len(tr) == 10
    for name in jr:
        j, t = (jtiny(jr[name]), ttiny(tr[name])) if tiny else \
            (jr[name], tr[name])
        assert _config_fields(j) == _config_fields(t), name
    assert tr["llama3.2-1b"].param_dtype is torch.bfloat16
    assert ttiny(tr["llama3.2-1b"]).compute_dtype is torch.float32


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lm_params_from_jax_keeps_shapes_and_values_exactly(dtype):
    import jax
    import jax.numpy as jnp
    from repro.configs.archs import tiny_version as jtiny
    from repro.configs.base import get_config as jget
    from repro.models import api as japi
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.tree import tree_leaves
    jd = getattr(jnp, dtype)
    cfg = jtiny(jget("llama3.2-1b")).with_(param_dtype=jd, compute_dtype=jd)
    tree = jax.device_get(japi.init(jax.random.key(0), cfg))
    port = lm_params_from_jax(tree)
    jl, tl = jax.tree.leaves(tree), tree_leaves(port)
    assert len(jl) == len(tl) == 11
    for a, t in zip(jl, tl):
        assert tuple(t.shape) == a.shape
        assert t.dtype == getattr(torch, dtype)
        bits = np.uint16 if dtype == "bfloat16" else np.uint32
        np.testing.assert_array_equal(
            t.view(torch.int16 if dtype == "bfloat16" else torch.int32
                   ).numpy().view(bits), np.asarray(a).view(bits))
    assert port["layers"]["attn"]["wq"].shape == (2, 128, 4, 32)
