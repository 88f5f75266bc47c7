"""The port's dry run (``repro_torch.launch.dryrun``): every family's tiny
cells give the reference's record keys; the production meshes give a
per-chip model whose parameter bytes follow the spec trees; ``--fake-group``
builds the (16, 16) and (2, 16, 16) meshes and placements in one process."""
import json

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import (ShapeConfig, all_archs,
                                      applicable_shapes, get_config)
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline as RL
from repro_torch.models import api
from repro_torch.parallel import specs as SP
from repro_torch.compat import abstract_mesh
from repro_torch.tree import tree_leaves

# the record's keys in the reference (src/repro/launch/dryrun.py:119-131)
REFERENCE_KEYS = {"arch", "shape", "mesh", "tiny", "n_devices", "kind",
                  "params", "active_params", "lower_s", "compile_s",
                  "memory_analysis", "roofline", "model_flops_per_chip",
                  "useful_ratio", "ok"}
ROOFLINE_KEYS = {"flops", "bytes", "collective_bytes", "collective_counts",
                 "xla_flops", "xla_bytes", "bytes_bf16", "memory_bf16_s",
                 "compute_s", "memory_s", "collective_s", "dominant",
                 "n_devices", "hw_spec"}


@pytest.mark.parametrize("arch", sorted(all_archs()))
def test_tiny_cells_give_the_reference_record(arch):
    for shape in applicable_shapes(get_config(arch)):
        rec = DR.run_cell(arch, shape, False, tiny=True, verbose=False)
        assert REFERENCE_KEYS <= set(rec), shape
        assert set(rec["roofline"]) == ROOFLINE_KEYS
        assert rec["ok"] and rec["mesh"] == "host1" and rec["n_devices"] == 1
        assert rec["roofline"]["flops"] > 0 and rec["roofline"]["bytes"] > 0
        assert rec["roofline"]["collective_bytes"] == 0      # one chip
        assert rec["roofline"]["hw_spec"] == RL.H100_SXM.name
        json.dumps(rec)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_cell_models_per_chip_bytes(multi_pod):
    rec = DR.run_cell("llama3.2-1b", "train_4k", multi_pod, verbose=False)
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    n = 512 if multi_pod else 256
    assert rec["n_devices"] == n
    mesh = abstract_mesh(*(((2, 16, 16), ("pod", "data", "model"))
                           if multi_pod else ((16, 16), ("data", "model"))))
    cfg = get_config("llama3.2-1b")
    params = api.init_meta(cfg)
    specs = SP.sanitize_tree(SP.param_specs(params, mesh, cfg=cfg,
                                            kind="train"), params, mesh)
    want = sum(torch.Size(SP.local_shape(t.shape, s, mesh)).numel()
               * t.element_size() for t, s in zip(tree_leaves(params),
                                                  tree_leaves(specs)))
    mem = rec["memory_analysis"]
    assert mem["param_bytes"] == want
    assert 0 < mem["opt_bytes"] < 12 * api.param_count(params) / 16
    counts = rec["roofline"]["collective_counts"]
    assert {"reduce-scatter", "all-gather", "all-reduce"} <= set(counts)
    assert rec["roofline"]["collective_bytes"] > 0
    assert 0 < rec["useful_ratio"] < 2


def test_one_chip_cell_at_a_measured_shape():
    shape = ShapeConfig("train_4k", 512, 4, "train")
    rec = DR.run_cell("mamba2-130m", "train_4k", False, mesh=(1, 1),
                      shape=shape, verbose=False)
    assert rec["n_devices"] == 1 and rec["mesh"] == "1x1"
    assert rec["roofline"]["collective_bytes"] == 0
    assert rec["bound_s"] > 0 and rec["batch"] == 4 and rec["seq_len"] == 512


@pytest.mark.parametrize("multi_pod", [False, True])
def test_fake_group_builds_the_production_mesh(multi_pod, tmp_path):
    assert not dist.is_initialized()
    out = tmp_path / "dryrun.json"
    argv = ["--arch", "mamba2-130m", "--shape", "decode_32k", "--fake-group",
            "--out", str(out)] + (["--multi-pod", "--single-pod"]
                                  if multi_pod else [])
    assert DR.main(argv) == 0
    assert not dist.is_initialized()
    recs = json.loads(out.read_text())
    for rec in recs.values():
        assert rec["ok"]
        assert rec["fake_group_leaves"] == len(tree_leaves(api.init_meta(
            get_config("mamba2-130m"))))
    assert {r["mesh"] for r in recs.values()} == (
        {"16x16", "2x16x16"} if multi_pod else {"16x16"})


def test_out_keeps_a_cut_cell_apart_from_the_production_one(tmp_path,
                                                            capsys):
    """One ``--out`` holds a one-chip cut run and the production run of
    the same cell as two records, in either order; only a rerun of the
    same arguments is skipped as cached."""
    out = tmp_path / "dryrun.json"
    base = ["--arch", "mamba2-130m", "--shape", "decode_32k", "--out",
            str(out)]
    cut = base + ["--chips", "1", "--batch", "2", "--seq", "64",
                  "--layers", "2"]
    assert DR.main(cut) == 0
    assert DR.main(base) == 0
    recs = json.loads(out.read_text())
    assert sorted((r["mesh"], r["batch"], r["seq_len"])
                  for r in recs.values()) == [("16x16", 128, 32768),
                                              ("1x1", 2, 64)]
    capsys.readouterr()
    assert DR.main(cut) == 0
    assert "skip cached" in capsys.readouterr().out
    assert json.loads(out.read_text()) == recs
