"""Dry run: every (arch × shape × mesh) cell counted per chip, with no chip.

The counterpart of the JAX package's ``launch/dryrun.py``. The reference
lowers and compiles each cell's step for a 256- or 512-chip mesh and reads
per-chip FLOPs, bytes and collectives from the compiled HLO; torch has no
such compiler, so on a production mesh this dry run is a MODEL, built from
the spec trees and from the step counted on ``meta`` tensors
(:func:`repro_torch.launch.roofline.analyze`):

  - per-chip parameter, optimiser and cache bytes are exact from the
    sanitized spec trees: each leaf's bytes over the product of its
    sharded axes (the optimiser state by its ZeRO-1 specs);
  - per-chip FLOPs and bytes are the step counted at the per-chip batch
    (the global batch over the data axes), with the products (and
    kernels) that read a weight or cache leaf sharded on ``model``, and
    the casts of such weights, counted at 1 / ``model``
    (``roofline._CountMode``); every other op counts whole on each chip,
    the weight gradients' products among them, so with ``model`` > 1 the
    per-chip count is high; a train step's optimiser update is counted on
    the per-chip blocks of its ZeRO-1 state;
  - collective bytes are the data-parallel gradient collectives (a
    reduce-scatter of each ZeRO-1 leaf's gradient and an all-gather of its
    bf16 param on ``data``, an all-reduce of every other leaf's; one more
    all-reduce on ``pod`` where there is one), plus two all-reduces of the
    (B, S, d) activations per layer and direction on ``model``, each by
    the reference's ring factors;
  - ``useful_ratio`` = ``model_flops`` per chip over the counted FLOPs, as
    in the reference.

On one chip (``mesh=(1, 1)``) nothing is modelled but the bound: the count
is the step the card runs. ``--fake-group`` runs the same cell after
building the production ``DeviceMesh`` on a one-process ``fake`` process
group of 256 or 512 ranks and placing every parameter leaf on it as a
DTensor (local ``meta`` blocks): the mesh and the placements build at that
size. Records go to ``--out`` when given; nothing is written by default.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod --fake-group --out /tmp/dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m --shape train_4k --chips 1 --batch 4 --seq 512
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.compat import (AbstractMesh, DTensor, axis_names,
                                init_device_mesh, mesh_shape)
from repro_torch.configs.archs import tiny_version
from repro_torch.configs.base import (SHAPES, ShapeConfig, all_archs,
                                      applicable_shapes, get_config)
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.parallel import specs as SP
from repro_torch.parallel.sharding import axes_of, axis_rules, placements
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

# --tiny mode: same shape *kinds* at smoke scale on one process
TINY_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 256, 8, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 512, 4, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 512, 8, "decode"),
    "long_500k": ShapeConfig("long_500k", 2048, 1, "decode"),
}


def active_param_fraction_tree(cfg):
    """(total, active) params for MODEL_FLOPS: the embedding table is a
    gather (no product), MoE expert weights count top_k/E."""
    total, active = 0, 0

    def visit(path, leaf):
        nonlocal total, active
        p = SP._path_str(path)
        n = leaf.numel()
        total += n
        if "embed/embedding" in p:
            return
        if cfg.n_experts and ("ffn/wi" in p or "ffn/wo" in p) \
                and leaf.dim() == 3:
            active += n * cfg.top_k / cfg.n_experts
        else:
            active += n

    tree_map_with_path(visit, api.init_meta(cfg))
    return total, active


def _bytes(t: torch.Tensor, spec, mesh) -> int:
    return (torch.Size(SP.local_shape(t.shape, spec, mesh)).numel()
            * t.element_size())


def _model_axes(spec) -> bool:
    return any("model" in axes_of(e) for e in spec)


def _sharded(tree, specs) -> list:
    """The leaves of ``tree`` whose spec shards them on ``model``."""
    return [t for t, s in zip(tree_leaves(tree), tree_leaves(specs))
            if _model_axes(s)]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _layers(cfg) -> int:
    return (cfg.n_enc_layers + cfg.n_dec_layers if cfg.family == "encdec"
            else cfg.n_layers)


def _collectives(cfg, shape, mesh, pspecs, ospecs, params, local_b,
                 seq) -> Dict[str, float]:
    """Per-chip wire bytes by kind (see the module docstring)."""
    sizes = mesh_shape(mesh)
    data, pod, m = sizes.get("data", 1), sizes.get("pod", 1), \
        sizes.get("model", 1)
    wire: Dict[str, float] = {}
    counts: Dict[str, int] = {}

    def add(kind, size, group, n=1):
        if group > 1 and size:
            wire[kind] = wire.get(kind, 0.0) + n * RL.wire_bytes(kind, size,
                                                                 group)
            counts[kind] = counts.get(kind, 0) + n

    if shape.kind == "train":
        for t, ps, os_ in zip(tree_leaves(params), tree_leaves(pspecs),
                              tree_leaves(ospecs)):
            local = _bytes(t, ps, mesh)
            if "data" in [a for e in os_ for a in axes_of(e)] and \
                    "data" not in [a for e in ps for a in axes_of(e)]:
                block = _bytes(t, os_, mesh)
                add("reduce-scatter", block, data)
                add("all-gather", local, data)
                add("all-reduce", block, pod)
            else:
                add("all-reduce", local, data * pod)
    act = local_b * seq * cfg.d_model * torch.finfo(cfg.compute_dtype).bits \
        // 8
    directions = 2 if shape.kind == "train" else 1
    add("all-reduce", act, m, n=2 * _layers(cfg) * directions)
    return wire, counts


def _count_step(cfg, shape, mesh, local_b, seq, pspecs, params):
    """The step at the per-chip batch on meta tensors, model-sharded
    weights (and cache leaves) at 1/model; a train step's optimiser on
    its ZeRO-1 blocks. Returns (FLOPs, bytes, cache bytes) per chip."""
    m = mesh_shape(mesh).get("model", 1)
    sharded = _sharded(params, pspecs)
    local = ShapeConfig(shape.name, seq, local_b, shape.kind)
    batch = ST.tensors_of(ST.batch_specs(cfg, local, None))
    fn = ST.step_fn_for(cfg, local)
    if shape.kind == "train":
        grads = RL.analyze(lambda: ST.loss_and_grads(params, cfg, batch),
                           sharded=sharded, model=m)
        ospecs = SP.zero1_specs(pspecs, params, mesh, axis="data")
        blocks = tree_map(lambda t, s: _meta(SP.local_shape(t.shape, s, mesh),
                                             t.dtype), params, ospecs)
        opt = adamw.init(adamw.AdamWConfig(), blocks)
        update = RL.analyze(adamw.apply_updates, adamw.AdamWConfig(), blocks,
                            blocks, opt)
        return (grads.flops + update.flops,
                grads.bytes_accessed + update.bytes_accessed, 0)
    if shape.kind == "prefill":
        r = RL.analyze(fn, params, batch, sharded=sharded, model=m)
        return r.flops, r.bytes_accessed, 0
    cache = api.init_cache(cfg, local_b, seq, device="meta")
    cspecs = SP.cache_specs(cache, mesh, seq_sharded=False)
    cache_bytes = sum(_bytes(t, s, mesh) for t, s in zip(
        tree_leaves(cache), tree_leaves(cspecs)))
    r = RL.analyze(fn, params, cache, batch, seq - 1,
                   sharded=sharded + _sharded(cache, cspecs), model=m)
    return r.flops, r.bytes_accessed, cache_bytes


def _fake_placements(mesh_abs: AbstractMesh, params, pspecs) -> int:
    """Build the production mesh on a one-process ``fake`` group and place
    every parameter leaf on it (a DTensor over its local meta block).
    Returns the number of leaves placed."""
    from repro_torch.compat import fake_store
    names = axis_names(mesh_abs)
    shape = tuple(mesh_shape(mesh_abs).values())
    dist.init_process_group("fake", store=fake_store(), rank=0,
                            world_size=mesh_abs.size)
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        placed = tree_map(lambda t, s: DTensor.from_local(
            _meta(SP.local_shape(t.shape, s, mesh_abs), t.dtype), mesh,
            placements(mesh, s), shape=t.shape, stride=t.stride(),
            run_check=False), params, pspecs)
        for a in names:
            mesh.get_group(a)
        return len(tree_leaves(placed))
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             verbose: bool = True, tiny: bool = False,
             mesh: Optional[Sequence[int]] = None,
             shape: Optional[ShapeConfig] = None,
             fake_group: bool = False,
             layers: Optional[int] = None) -> Dict[str, Any]:
    """One cell's record (the reference's keys). ``mesh`` (data, model),
    ``shape`` and ``layers`` override the production mesh, the named
    shape and the depth (a one-chip cell at a measured step's batch,
    length and depth cut)."""
    cfg = get_config(arch)
    if layers:
        cfg = cfg.with_(n_layers=layers)
    if tiny:
        cfg = tiny_version(cfg)
        shape = shape or TINY_SHAPES[shape_name]
        mesh_abs = AbstractMesh(mesh or (1, 1), ("data", "model"))
        tag = f"host{mesh_abs.size}"
    else:
        shape = shape or SHAPES[shape_name]
        mesh_abs = AbstractMesh(mesh, ("data", "model")) if mesh else \
            make_production_mesh(multi_pod=multi_pod)
        tag = "x".join(str(n) for n in mesh_shape(mesh_abs).values())
    sizes = mesh_shape(mesh_abs)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    n_dev = mesh_abs.size
    rules = ST.make_rules(cfg, shape, mesh_abs)
    t0 = time.time()
    with axis_rules(rules, mesh_abs):
        params = api.init_meta(cfg)
        kind = shape.kind
        pspecs = SP.sanitize_tree(SP.param_specs(params, mesh_abs, cfg=cfg,
                                                 kind=kind), params, mesh_abs)
        ospecs = SP.zero1_specs(pspecs, params, mesh_abs, axis="data")
        placed = _fake_placements(mesh_abs, params, pspecs) if fake_group \
            else None
        seq_sh = kind == "decode" and shape.global_batch < dp
        local_b = max(1, shape.global_batch // dp)
        seq = shape.seq_len // sizes.get("data", 1) if seq_sh \
            else shape.seq_len
        t_lower = time.time() - t0
        flops, nbytes, cache_bytes = _count_step(cfg, shape, mesh_abs,
                                                 local_b, seq, pspecs,
                                                 params)
        wire, counts = _collectives(cfg, shape, mesh_abs, pspecs, ospecs,
                                    params, local_b,
                                    1 if kind == "decode" else seq)
    t_compile = time.time() - t0 - t_lower
    roof = RL.Roofline(flops, nbytes, sum(wire.values()), counts, n_dev,
                       0.0, 0.0, nbytes, RL.H100_SXM)
    param_bytes = sum(_bytes(t, s, mesh_abs) for t, s in zip(
        tree_leaves(params), tree_leaves(pspecs)))
    opt_bytes = 3 * sum(_bytes(t.float(), s, mesh_abs) for t, s in zip(
        tree_leaves(params), tree_leaves(ospecs))) if kind == "train" else 0
    mem_d = {"argument_size_in_bytes": param_bytes + opt_bytes + cache_bytes,
             "output_size_in_bytes": None, "temp_size_in_bytes": None,
             "generated_code_size_in_bytes": None,
             "param_bytes": param_bytes, "opt_bytes": opt_bytes,
             "cache_bytes": cache_bytes}

    total_p, active_p = active_param_fraction_tree(cfg)
    tokens = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    mf = RL.model_flops(total_p, int(active_p), tokens,
                        "train" if kind == "train" else "fwd")
    mf_per_chip = mf / n_dev
    rec = {
        "arch": arch, "shape": shape_name, "mesh": tag, "tiny": tiny,
        "n_devices": n_dev, "kind": kind,
        "params": total_p, "active_params": active_p,
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "memory_analysis": mem_d,
        "roofline": roof.to_dict(),
        "model_flops_per_chip": mf_per_chip,
        "useful_ratio": (mf_per_chip / roof.flops) if roof.flops else None,
        "bound_s": roof.bound_s, "batch": shape.global_batch,
        "seq_len": shape.seq_len, "fake_group_leaves": placed,
        "ok": True,
    }
    if verbose:
        print(f"[{arch} × {shape_name} × {tag}] flops/chip={roof.flops:.3e} "
              f"bytes/chip={roof.bytes_accessed:.3e} "
              f"coll/chip={roof.collective_bytes:.3e}")
        print(f"  per-chip bytes: params {param_bytes:.3e} opt "
              f"{opt_bytes:.3e} cache {cache_bytes:.3e}")
        print(f"  terms: compute={roof.compute_s*1e3:.3f}ms "
              f"memory={roof.memory_s*1e3:.3f}ms "
              f"collective={roof.collective_s*1e3:.3f}ms "
              f"dominant={roof.dominant} useful_ratio="
              f"{rec['useful_ratio'] and round(rec['useful_ratio'], 3)}")
        print(f"  collectives: {roof.collective_counts}")
    return rec


def _load(path):
    if path is not None and path.exists():
        return json.loads(path.read_text())
    return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--tiny", action="store_true",
                    help="smoke scale: tiny configs/shapes on one process")
    ap.add_argument("--fake-group", action="store_true",
                    help="also build the production mesh and placements on "
                         "a one-process fake group")
    ap.add_argument("--out", type=str, default=None,
                    help="JSON file for the records (none written without)")
    ap.add_argument("--chips", type=int, default=None,
                    help="a (chips, 1) data-parallel mesh in place of the "
                         "production one")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch in place of the shape's")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length in place of the shape's")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this depth")
    args = ap.parse_args(argv)

    out_path = pathlib.Path(args.out) if args.out else None
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
    results = _load(out_path)

    meshes = []
    if args.single_pod or not args.multi_pod:
        meshes.append(False)
    if args.multi_pod or (not args.single_pod and args.all):
        meshes.append(True)

    cells = []
    if args.all:
        for name, cfg in all_archs().items():
            for sh in applicable_shapes(cfg):
                cells.append((name, sh))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all required"
        cells.append((args.arch, args.shape))

    failures = []
    for arch, sh in cells:
        for mp in meshes:
            mesh_tag = "tiny" if args.tiny else ("multi" if mp else "single")
            key = "|".join([arch, sh, mesh_tag] + [
                f"{k}={v}" for k, v in (("chips", args.chips),
                                        ("batch", args.batch),
                                        ("seq", args.seq),
                                        ("layers", args.layers)) if v])
            if key in results and results[key].get("ok") and not args.force:
                print(f"skip cached {key}")
                continue
            base = (TINY_SHAPES if args.tiny else SHAPES)[sh]
            shape = None
            if args.batch or args.seq:
                shape = ShapeConfig(sh, args.seq or base.seq_len,
                                    args.batch or base.global_batch,
                                    base.kind)
            try:
                rec = run_cell(arch, sh, mp, tiny=args.tiny,
                               fake_group=args.fake_group,
                               mesh=(args.chips, 1) if args.chips else None,
                               shape=shape, layers=args.layers)
            except Exception as e:
                traceback.print_exc()
                rec = {"arch": arch, "shape": sh,
                       "mesh": "tiny" if args.tiny
                       else "2x16x16" if mp else "16x16",
                       "ok": False, "error": f"{type(e).__name__}: {e}"}
                failures.append(key)
            results[key] = rec
            if out_path is not None:
                out_path.write_text(json.dumps(results, indent=1))
    print(f"\n{len(cells)*len(meshes)} cells, {len(failures)} failures")
    for f in failures:
        print("  FAIL", f)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
