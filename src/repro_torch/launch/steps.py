"""Step functions (train / prefill / serve) that the trainer and the
server share.

The torch twin of the JAX package's ``launch/steps.py`` on one card. The
train step differentiates ``api.loss`` with ``loss.backward()`` for every
family (on the card through the hand-written ``rmsnorm``,
``flash_attention``, ``ssd_scan`` and ``topk_gating`` kernels, as the
family has the layers, and their backward kernels), then hands the
gradients to :func:`repro_torch.optim.adamw.apply_updates`, which updates
the state in place. A leaf the loss does not reach gets a zero gradient,
as ``jax.grad`` gives it: the VLM's ``embed`` table when ``embeds``
replace the tokens (AdamW still decays it). The params a caller holds
never need a gradient: each step differentiates detached leaves that
share their storage.

The reference's spec functions (``make_rules``, ``batch_specs``,
``cache_specs``, ``param_specs``, ``state_specs``, ``input_specs``) return
``meta`` tensors paired with their specs (:class:`Placed`) where it
returns ``ShapeDtypeStruct``s with shardings. :func:`mesh_step` stands
where ``jit_step`` does: the train, prefill or serve step of a
``DeviceMesh`` with data axes (``data``, and ``pod`` if present) and a
``model`` axis. Each rank takes its rows of the global batch; the forward
and backward run on its local tensors through the hand-written kernels
(a wrapper never sees a DTensor); the gradients are reduce-scattered to
the ZeRO-1 blocks (``zero1=True``) or all-reduced, to their mean over the
data ranks.

With ``model`` > 1 the prefill and serve steps of every LM family
(dense, MoE, SSM, hybrid, VLM, enc-dec), and the dense and MoE
families' train steps, run tensor-parallel
(``repro_torch.parallel.tensor``): each rank holds its blocks of the
params as ``param_specs(cfg, mesh, kind=...)`` place them
(``tensor.shard_params``) and of the cache as ``cache_specs`` place it,
and computes its heads (a VLM's padded heads among them, in the
reference's grouped-major order), FFN columns (an MoE's experts or their
ff columns, as the reference's ``_moe_apply_shard_map`` splits them), SSM
heads or head channels (as the decode cache's ``state`` spec places them)
and vocabulary columns, summing over the ``model`` ranks where the
reference's GSPMD or ``psum`` would. An enc-dec's encoder, self- and
cross-attention share one head layout; its cross cache holds exactly the
encoder's rows (``enc_len``), placed by the KV rule: the rank's kv heads,
or its block of the rows, merged over the ranks by log-sum-exp. The
logits come back sharded on the vocabulary. A dense or MoE train step
differentiates that split (the sums autograd sees,
``tensor.reduce_from_model`` / ``copy_to_model``, the gather over
``data`` of an MoE's ff-sharded experts, ``tensor.all_gather``, and the
vocabulary-parallel cross-entropy): each rank's gradients are its blocks,
averaged over the data ranks alone (an expert matrix cut on d over
``data`` by its own spec is already summed over them by its gather's
backward, and is its own ZeRO-1 block), and the clip's norm is summed
over both axes. What a mesh with ``model`` > 1 does not execute, the
dry run (``repro_torch.launch.dryrun``) models: the other families'
train steps (the JAX package's tests only compile one).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.compat import (AbstractMesh, DTensor, DeviceMesh,
                                axis_names, local, mesh_shape,
                                reduce_scatter_single)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.parallel import specs as SP
from repro_torch.parallel import tensor as TP
from repro_torch.parallel.sharding import (DEFAULT_RULES, NamedSharding,
                                           PartitionSpec, axes_of,
                                           placements, resolve_spec)
from repro_torch.tree import trainable, tree_map, tree_map_with_path


class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState


def loss_and_grads(params: Any, cfg: ModelConfig, batch: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Any]:
    """``api.loss`` and its gradient tree (a leaf that the loss does not
    reach gets zeros, as ``jax.grad`` gives). ``params`` is left as it
    is: the graph is built over detached leaves sharing its storage."""
    leaves = trainable(params)
    loss = api.loss(leaves, cfg, batch)
    loss.backward()
    grads = tree_map(lambda t: t.grad if t.grad is not None
                     else torch.zeros_like(t), leaves)
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[adamw.AdamWConfig] = None):
    """``train_step(state, batch) -> (state, metrics)``: the state is
    updated in place and returned; metrics ``loss``, ``grad_norm``,
    ``lr`` are 0-d tensors on the device."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(state: TrainState, batch: Dict[str, Any]):
        loss, grads = loss_and_grads(state.params, cfg, batch)
        new_params, new_opt, metrics = adamw.apply_updates(
            opt_cfg, state.params, grads, state.opt)
        metrics["loss"] = loss
        return TrainState(new_params, new_opt), metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params, batch):
        return api.prefill(params, cfg, batch)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    @torch.no_grad()
    def serve_step(params, cache, batch, index):
        logits, new_cache = api.decode_step(params, cfg, batch, cache, index)
        return logits, new_cache
    return serve_step


def step_fn_for(cfg: ModelConfig, shape: ShapeConfig,
                opt_cfg: Optional[adamw.AdamWConfig] = None):
    if shape.kind == "train":
        return make_train_step(cfg, opt_cfg)
    if shape.kind == "prefill":
        return make_prefill_step(cfg)
    return make_serve_step(cfg)


# ---------------------------------------------------------------------------
# logical-axis rules and spec trees per shape
# ---------------------------------------------------------------------------

class Placed(NamedTuple):
    """A ``meta`` tensor (shape and dtype) and its spec on the mesh (None
    off a mesh): the reference's ``ShapeDtypeStruct`` with a sharding."""
    tensor: torch.Tensor
    spec: Optional[PartitionSpec]


def _map_placed(fn, tree: Any) -> Any:
    """``fn`` on every :class:`Placed` of a tree, into the state's
    NamedTuples too (which the port's trees keep as leaves)."""
    if isinstance(tree, Placed):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_placed(fn, x) for x in tree))
    return tree_map(lambda x: _map_placed(fn, x), tree)


def tensors_of(tree: Any) -> Any:
    """The meta tensors of a tree of :class:`Placed`."""
    return _map_placed(lambda x: x.tensor, tree)


def specs_of(tree: Any) -> Any:
    """The specs of a tree of :class:`Placed`."""
    return _map_placed(lambda x: x.spec, tree)


def _dp(mesh) -> int:
    sizes = mesh_shape(mesh)
    return sizes.get("data", 1) * sizes.get("pod", 1)


def make_rules(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, Any]:
    rules = dict(DEFAULT_RULES)
    if shape.kind == "decode" and shape.global_batch < _dp(mesh):
        # long-context / tiny-batch decode: batch can't fill the DP axes.
        # Reuse the data axis for sequence (cache) sharding (SP).
        rules["batch"] = None
        rules["seq_shard"] = "data"
    return rules


def _seq_sharded(shape: ShapeConfig, mesh) -> bool:
    return shape.kind == "decode" and shape.global_batch < _dp(mesh)


def _placed(shape, dtype, mesh, axes) -> Placed:
    spec = None
    if mesh is not None:
        spec = SP.sanitize_spec(resolve_spec(axes, mesh=mesh), shape, mesh)
    return Placed(torch.empty(shape, dtype=dtype, device="meta"), spec)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                mesh=None) -> Dict[str, Placed]:
    """Meta stand-ins, with their specs, for the data batch of one step."""
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, Placed] = {}
    if shape.kind in ("train", "prefill"):
        if cfg.embed_inputs:
            out["embeds"] = _placed((B, S, cfg.d_model), cfg.compute_dtype,
                                    mesh, ("batch", "seq", "embed"))
            if cfg.family == "encdec":  # decoder tokens alongside enc frames
                out["tokens"] = _placed((B, S), torch.int32, mesh,
                                        ("batch", "seq"))
            if cfg.pos == "mrope":
                out["positions"] = _placed((3, B, S), torch.int32, mesh,
                                           (None, "batch", "seq"))
        else:
            out["tokens"] = _placed((B, S), torch.int32, mesh,
                                    ("batch", "seq"))
        if shape.kind == "train":
            out["labels"] = _placed((B, S), torch.int32, mesh,
                                    ("batch", "seq"))
    else:  # decode: one new token
        out["tokens"] = _placed((B, 1), torch.int32, mesh, ("batch", None))
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *,
                enc_len: Optional[int] = None) -> Any:
    """The decode cache of ``shape`` as meta tensors with their specs; an
    enc-dec's cross cache ``ck``/``cv`` of ``enc_len`` rows (the
    encoder's length; the decode length, the reference's layout, when not
    given), placed by the KV rule as ``k``/``v`` are."""
    cache = api.init_cache(cfg, shape.global_batch, shape.seq_len,
                           enc_len=enc_len, device="meta")
    if mesh is None:
        return tree_map(lambda t: Placed(t, None), cache)
    spec_tree = SP.cache_specs(cache, mesh,
                               seq_sharded=_seq_sharded(shape, mesh))
    return tree_map(Placed, cache, spec_tree)


def param_specs(cfg: ModelConfig, mesh=None, seed: int = 0,
                kind: Optional[str] = None) -> Any:
    """The params as meta tensors with their sanitized specs (``seed`` is
    the reference's; a meta draw has no values)."""
    shapes = api.init_meta(cfg)
    if mesh is None:
        return tree_map(lambda t: Placed(t, None), shapes)
    spec_tree = SP.sanitize_tree(
        SP.param_specs(shapes, mesh, cfg=cfg, kind=kind), shapes, mesh)
    return tree_map(Placed, shapes, spec_tree)


def state_specs(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                mesh=None, *, zero1: bool = True) -> TrainState:
    """The train state as meta tensors with their specs: the params'
    own, the master copy's and moments' ZeRO-1 ones (``zero1``)."""
    p = param_specs(cfg, mesh, kind="train")
    shapes = tensors_of(p)
    opt = adamw.init(opt_cfg, shapes)
    if mesh is None:
        ospecs = tree_map(lambda _: None, shapes)
    else:
        ospecs = specs_of(p)
        if zero1:
            ospecs = SP.zero1_specs(ospecs, shapes, mesh, axis="data")
    return TrainState(p, adamw.OptState(
        Placed(opt.step, None if mesh is None else PartitionSpec()),
        tree_map(Placed, opt.master, ospecs), tree_map(Placed, opt.m, ospecs),
        tree_map(Placed, opt.v, ospecs)))


def state_shardings(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    mesh: DeviceMesh, *, zero1: bool = True) -> TrainState:
    """:func:`state_specs` as ``NamedSharding``s on ``mesh``: the
    ``shardings`` that restore a checkpoint onto the mesh for
    :func:`mesh_step` (``CheckpointManager.restore``), giving every rank
    the blocks :func:`mesh_state` gives it: a leaf a rank holds as two cut
    halves (:func:`paired_leaves`) is marked ``paired``."""
    placed = state_specs(cfg, opt_cfg, mesh, zero1=zero1)
    paired = paired_leaves(cfg, placed.params, mesh)
    mark = lambda tree: tree_map(  # noqa: E731
        lambda x, p: NamedSharding(mesh, x.spec, p), tree, paired)
    return TrainState(mark(placed.params), adamw.OptState(
        NamedSharding(mesh, placed.opt.step.spec),
        *(mark(x) for x in placed.opt[1:])))


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                opt_cfg: Optional[adamw.AdamWConfig] = None) -> Tuple:
    """Every input of the step of ``shape.kind``, as :class:`Placed`."""
    if shape.kind == "train":
        opt_cfg = opt_cfg or adamw.AdamWConfig()
        return (state_specs(cfg, opt_cfg, mesh), batch_specs(cfg, shape, mesh))
    if shape.kind == "prefill":
        return (param_specs(cfg, mesh, kind="prefill"),
                batch_specs(cfg, shape, mesh))
    index = Placed(torch.empty((), dtype=torch.int32, device="meta"),
                   None if mesh is None else PartitionSpec())
    return (param_specs(cfg, mesh, kind="decode"),
            cache_specs(cfg, shape, mesh), batch_specs(cfg, shape, mesh),
            index)


# ---------------------------------------------------------------------------
# steps on a DeviceMesh (data parallel, ZeRO-1)
# ---------------------------------------------------------------------------

class MeshPlan(NamedTuple):
    """What a step needs of its mesh: the groups of its data axes of size
    > 1, this rank's index among all data ranks and their number, and the
    ZeRO-1 layout (None without). A train step with ``model`` > 1 also
    has the config, the whole params as ``meta`` tensors (``shapes``),
    their sanitized train specs (``specs``) and the master copy's and
    moments' (``opt_specs``: ``zero1_specs`` of them where ZeRO-1 is on), the leaves split on ``model``
    (``model``), those a rank holds as two cut halves (``paired``, a
    SwiGLU ``wi``: :func:`paired_leaves`) and the rank's
    :class:`~repro_torch.parallel.tensor.Layout`; all None on one
    ``model`` rank."""
    mesh: Any
    groups: Tuple
    index: int
    count: int
    zero1: Optional[adamw.Zero1]
    cfg: Optional[ModelConfig] = None
    shapes: Any = None
    specs: Any = None
    opt_specs: Any = None
    model: Optional[adamw.ModelSplit] = None
    paired: Any = None
    layout: Optional[TP.Layout] = None


def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))


def mesh_plan(cfg: ModelConfig, mesh: DeviceMesh, *,
              zero1: bool = True, kind: str = "train") -> MeshPlan:
    """The data axes of ``mesh`` and, with ``zero1``, each leaf's ZeRO-1
    dimension (from ``zero1_specs`` of the sanitized train specs), for a
    step of ``kind``. With ``model`` > 1 every family's prefill and decode
    steps execute, and the dense and MoE families' train steps (the plan
    then holds the train specs, the leaves split on ``model``, those whose
    own spec also cuts them on ``data`` (an MoE's ff-sharded expert
    matrices, d over ``data``: no ZeRO-1 dimension, their block is cut
    once) and the rank's layout); another family's train step raises
    ``NotImplementedError``."""
    sizes = mesh_shape(mesh)
    split = sizes.get("model", 1) > 1 and kind == "train"
    if split and cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"a train step of the {cfg.family} family on a mesh with model "
            f"> 1 is modelled by repro_torch.launch.dryrun, not executed: "
            f"tensor parallelism trains the dense and MoE families only")
    axes = _data_axes(mesh)
    index = 0
    for a in axes:
        index = index * sizes[a] + mesh.get_local_rank(a)
    groups = tuple(mesh.get_group(a) for a in axes if sizes[a] > 1)
    z = None
    p = param_specs(cfg, mesh, kind="train")
    pspecs = ospecs = specs_of(p)
    held = tree_map(lambda s: split and any(
        "data" in axes_of(e) for e in s), pspecs)
    if zero1 and "data" in sizes:
        ospecs = SP.zero1_specs(pspecs, tensors_of(p), mesh, axis="data")
        dims = tree_map(lambda s, h: None if h else next(
            (d for d, e in enumerate(s) if e == "data"), None), ospecs, held)
        z = adamw.Zero1(dims, mesh.get_local_rank("data"), sizes["data"],
                        mesh.get_group("data"))
    plan = MeshPlan(mesh, groups, index, _dp(mesh), z)
    if not split:
        return plan
    data = sizes.get("data", 1)
    model = adamw.ModelSplit(
        tree_map(lambda s: any("model" in axes_of(e) for e in s), pspecs),
        mesh.get_group("model"), sizes["model"], held,
        mesh.get_group("data") if data > 1 else None, data)
    return plan._replace(cfg=cfg, shapes=tensors_of(p), specs=pspecs,
                         opt_specs=ospecs,
                         model=model, paired=paired_leaves(cfg, p, mesh),
                         layout=TP.layout(cfg, mesh, pspecs))


def paired_leaves(cfg: ModelConfig, placed: Any, mesh) -> Any:
    """The params' tree (``placed``: :func:`param_specs` on ``mesh``):
    True for each leaf a rank holds as two cut halves, a SwiGLU ``wi``
    whose last dimension the spec splits over ranks
    (``tensor.local_block``), which no DTensor placement describes."""
    sizes = mesh_shape(mesh)

    def one(path, x):
        last = x.spec[x.tensor.dim() - 1] \
            if len(x.spec) == x.tensor.dim() else None
        return TP.halves("/".join(map(str, path)),
                         cfg.act == "swiglu") and any(
            sizes[a] > 1 for a in axes_of(last))
    return tree_map_with_path(one, placed)


def _dtensor(mesh: DeviceMesh, t: torch.Tensor, spec=(), full=None
             ) -> DTensor:
    """``t``, this rank's block of ``full`` (``t`` itself by default),
    as a DTensor placed by ``spec``."""
    full = t if full is None else full
    return DTensor.from_local(t, mesh, placements(mesh, spec),
                              shape=full.shape, stride=full.stride(),
                              run_check=False)


def mesh_state(state: TrainState, plan: MeshPlan) -> TrainState:
    """A whole train state (every rank holds the same) laid onto the mesh:
    the params replicated, the master copy and moments cut to this rank's
    ZeRO-1 blocks (sharded on ``data``), all as DTensors. With ``model`` >
    1 (:func:`_split_state`) the params are this rank's blocks of the
    train specs, and the master copy and moments those blocks cut further
    to the ZeRO-1 blocks. Save :func:`gather_state` of a mesh state."""
    if plan.model is not None:
        return _split_state(state, plan)
    mesh, z = plan.mesh, plan.zero1
    opt = state.opt if z is None else adamw.shard_state(state.opt, z)
    dims = z.dims if z is not None else tree_map(lambda _: None,
                                                 state.params)

    def place(t, full, dim):
        spec = [None] * t.dim()
        if dim is not None:
            spec[dim] = "data"
        return _dtensor(mesh, t, spec, full)

    lay = lambda tree: tree_map(place, tree, state.params, dims)  # noqa: E731
    return TrainState(tree_map(lambda t: _dtensor(mesh, t), state.params),
                      adamw.OptState(_dtensor(mesh, opt.step),
                                     lay(opt.master), lay(opt.m), lay(opt.v)))


def _split_state(state: TrainState, plan: MeshPlan) -> TrainState:
    """:func:`mesh_state` with ``model`` > 1. Each leaf of ``state`` may be
    whole or already this rank's ``model`` block (a fresh state made from
    ``tensor.shard_params``' blocks, so that no rank holds a whole state):
    a whole leaf is cut to compact copies. A block that a DTensor
    placement describes is a DTensor of the global shape; the others (a
    SwiGLU ``wi``'s gate_r ‖ up_r) stay the rank's plain tensors, as
    ``_conv_leaf`` leaves a mamba window."""
    mesh, cfg, z, shapes = plan.mesh, plan.cfg, plan.zero1, plan.shapes

    def blocks(tree):
        got = TP.fit(tree, shapes, plan.specs, cfg, mesh)
        return tree_map(lambda t, b: b if b is t else b.clone(
            memory_format=torch.contiguous_format), tree, got)
    params = blocks(state.params)
    opt = adamw.OptState(state.opt.step, blocks(state.opt.master),
                         blocks(state.opt.m), blocks(state.opt.v))
    if z is not None:
        opt = adamw.shard_state(opt, z)
    paired = plan.paired

    def place(specs):
        return lambda tree: tree_map(
            lambda t, full, spec, pair: t if pair else _dtensor(
                mesh, t, spec, full), tree, shapes, specs, paired)
    lay = place(plan.opt_specs)
    return TrainState(place(plan.specs)(params), adamw.OptState(
        _dtensor(mesh, opt.step), lay(opt.master), lay(opt.m), lay(opt.v)))


def _joins(state: TrainState, plan: MeshPlan) -> TrainState:
    """``state``'s structure with each leaf a callable giving the whole
    leaf (its blocks gathered)."""
    if plan.model is None:
        def whole(t):
            return lambda: t.full_tensor() if isinstance(t, DTensor) else t
        return TrainState(tree_map(whole, state.params), adamw.OptState(
            whole(state.opt.step), *(tree_map(whole, x)
                                     for x in state.opt[1:])))
    paired = plan.paired

    def join(tree, specs):
        return tree_map(lambda t, s, p: lambda: TP.gather_block(
            local(t), s, plan.mesh, p), tree, specs, paired)
    step = local(state.opt.step)
    return TrainState(join(state.params, plan.specs), adamw.OptState(
        lambda: step, *(join(x, plan.opt_specs) for x in state.opt[1:])))


def gather_state(state: TrainState, plan: MeshPlan) -> TrainState:
    """The whole train state of a mesh state (:func:`mesh_state`), on
    every rank, in the reference's layout: each leaf's blocks gathered
    over the axes that split it (a SwiGLU ``wi``'s halves joined as gate
    ‖ up; the ZeRO-1 blocks over ``data``). What the tests compare and
    what a checkpoint saves. :func:`gathered` gives it a leaf at a time."""
    fns = _joins(state, plan)
    return TrainState(tree_map(lambda f: f(), fns.params), adamw.OptState(
        fns.opt.step(), *(tree_map(lambda f: f(), x) for x in fns.opt[1:])))


def gathered(state: TrainState, plan: MeshPlan, only=None):
    """(key, whole leaf) of :func:`gather_state`, one leaf at a time in the
    checkpoint's key order (``ckpt.checkpoint.flatten_with_keys``): only
    one whole leaf is held at once. ``only``, a predicate on the keys,
    skips the other leaves (every rank must pass the same)."""
    from repro_torch.ckpt.checkpoint import flatten_with_keys
    for key, fn in flatten_with_keys(_joins(state, plan)):
        if only is None or only(key):
            yield key, fn()


def gather_params(tree: Any, plan: MeshPlan) -> Any:
    """A params-shaped tree of this rank's ``model`` blocks (its params or
    gradients) whole again, on every rank (the params' train specs)."""
    if plan.model is None:
        return tree_map(local, tree)
    return tree_map(lambda t, s, p: TP.gather_block(local(t), s, plan.mesh,
                                                    p),
                    tree, plan.specs, plan.paired)


def local_rows(batch: Dict[str, Any], plan: MeshPlan) -> Dict[str, Any]:
    """This rank's rows of a global batch (M-RoPE positions keep their
    leading stream axis)."""
    def rows(k, t):
        ax = 1 if k == "positions" and t.dim() == 3 else 0
        n = t.shape[ax] // plan.count
        if n * plan.count != t.shape[ax]:
            raise ValueError(f"batch {k} of {t.shape[ax]} rows does not "
                             f"split over {plan.count} data ranks")
        return t.narrow(ax, plan.index * n, n)
    return {k: rows(k, v) for k, v in batch.items()}


def _mean(t: torch.Tensor, plan: MeshPlan, held: bool = False
          ) -> torch.Tensor:
    """Sum over the data ranks, divided by their number (in place).
    ``held``: ``t`` is the gradient of a leaf whose spec cuts it on
    ``data``, already summed over that axis (the backward of its
    gather): summed over the other data axes alone."""
    skip = plan.model.data_group if held else None
    for g in plan.groups:
        if g is not skip:
            dist.all_reduce(t, group=g)
    return t.div_(plan.count)


def _held(plan: MeshPlan, tree: Any) -> Any:
    """``tree``'s structure, True for each leaf that its own spec cuts on
    ``data`` (:class:`~repro_torch.optim.adamw.ModelSplit`'s ``data``)."""
    if plan.model is None:
        return tree_map(lambda _: False, tree)
    return plan.model.data


def _rank_grads(cfg: ModelConfig, plan: MeshPlan, params: Any,
                batch: Dict[str, Any]) -> Tuple[Any, torch.Tensor, Any]:
    """This rank's params of a mesh state (with ``model`` > 1 its blocks:
    a whole leaf raises, the update in place would miss the rest) and its
    loss and gradients on its rows of ``batch`` under the plan's layout."""
    params = tree_map(local, params)
    if plan.model is not None:
        def check(path, t, whole, spec):
            want = SP.local_shape(tuple(whole.shape), spec, plan.mesh)
            if tuple(t.shape) != want:
                raise ValueError(
                    f"{'/'.join(map(str, path))} of shape {tuple(t.shape)}: "
                    f"a train step on model > 1 takes this rank's block "
                    f"{want}; lay the state out with launch.steps.mesh_state")
        tree_map_with_path(check, params, plan.shapes, plan.specs)
    with TP.installed(plan.layout):
        return (params, *loss_and_grads(params, cfg,
                                        local_rows(batch, plan)))


def mesh_grads(cfg: ModelConfig, plan: MeshPlan, params: Any,
               batch: Dict[str, Any]) -> Tuple[torch.Tensor, Any]:
    """The loss and gradients that :func:`mesh_step`'s train step takes
    from a global ``batch``, averaged over the data ranks: this rank's
    ``model`` blocks of them (and ``data`` blocks, where a leaf's spec
    cuts it there; whole leaves with :func:`gather_params`), before the
    clip and without ZeRO-1's cut. ``params`` are the mesh state's."""
    _, loss, grads = _rank_grads(cfg, plan, params, batch)
    with torch.no_grad():
        return _mean(loss.clone(), plan), tree_map(
            lambda g, h: _mean(g, plan, h), grads, _held(plan, grads))


def _grad_block(g: torch.Tensor, dim: Optional[int], held: bool,
                plan: MeshPlan) -> torch.Tensor:
    """The mean gradient over the data ranks: this rank's ZeRO-1 block of
    it where the leaf is sharded (reduce-scattered on ``data``); where
    its own spec cuts it on ``data`` (``held``), the block it already is,
    summed over ``data`` by its gather's backward: divided, not reduced
    again."""
    z = plan.zero1
    if held or dim is None or z.size == 1:
        return _mean(g, plan, held)
    moved = g.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // z.size, *moved.shape[1:]),
                      dtype=g.dtype, device=g.device)
    reduce_scatter_single(out, moved, group=z.group)
    for grp in plan.groups:
        if grp is not z.group:
            dist.all_reduce(out, group=grp)
    return out.div_(plan.count).movedim(0, dim)


def _global(t: torch.Tensor, plan: MeshPlan, full: Tuple[int, ...]
            ) -> torch.Tensor:
    """A ``meta`` stand-in of the global tensor whose local block is ``t``
    (its batch rows over the data ranks, ``full`` elsewhere)."""
    return torch.empty((t.shape[0] * plan.count, *full), dtype=t.dtype,
                       device="meta")


def mesh_step(cfg: ModelConfig, shape: ShapeConfig, mesh: DeviceMesh,
              opt_cfg: Optional[adamw.AdamWConfig] = None, *,
              zero1: bool = True, cache_len: Optional[int] = None,
              enc_len: Optional[int] = None):
    """The step of ``shape.kind`` on ``mesh`` (``jit_step``'s twin):

    - train ``(state, batch) -> (state, metrics)``: ``state`` from
      :func:`mesh_state` (updated in place), ``batch`` global (each rank
      takes its rows); with ``model`` > 1 the dense and MoE families, on
      the rank's blocks under its layout (:func:`mesh_grads`' gradients,
      the ZeRO-1 blocks reduce-scattered over ``data``; a leaf its spec
      cuts on ``data`` is its own block, divided, not reduced again);
    - prefill ``(params, batch) -> (logits, cache)``, serve ``(params,
      cache, batch, index) -> (logits, cache)``: params as
      ``param_specs(cfg, mesh, kind=...)`` place them, as DTensors or this
      rank's blocks (``parallel.tensor.shard_params``), or whole tensors
      (cut to views of this rank's blocks); a prefill also takes the
      decode layout (an MQA's whole ``wk``/``wv``, of which it reads its
      input-dim block). Logits come back as DTensors, the batch on the
      data axes and, with ``model`` > 1, the vocabulary on ``model``. The
      prefill's cache is the serving cache of ``cache_len`` positions (the
      prompt's by default) holding the prompt, placed as
      :func:`cache_specs` of a decode shape of that length places it:
      each rank's block, its kv heads or its block of positions, its SSM
      heads or head channels, is spliced on the rank (an SSM ``conv``
      window split over ``model`` is this rank's plain tensor:
      :func:`_conv_leaf`). A serve step takes such a cache (DTensors or
      this rank's blocks) and updates it in place. An enc-dec's cross
      cache holds the encoder's rows: the prefill's as its encoder gave
      them, the serve step's ``enc_len`` of them (the decode length, the
      reference's layout, when not given); each rank its kv heads or its
      block of the rows, as :func:`cache_specs` places them.
    """
    plan = mesh_plan(cfg, mesh, zero1=zero1 and shape.kind == "train",
                     kind=shape.kind)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    axes = _data_axes(mesh)
    rows = axes if len(axes) > 1 else axes[0] if axes else None

    def train_step(state: TrainState, batch: Dict[str, Any]):
        params, loss, grads = _rank_grads(cfg, plan, state.params, batch)
        with torch.no_grad():
            dims = plan.zero1.dims if plan.zero1 is not None else \
                tree_map(lambda _: None, grads)
            grads = tree_map(lambda g, d, h: _grad_block(g, d, h, plan),
                             grads, dims, _held(plan, grads))
            opt = adamw.OptState(*(tree_map(local, x) for x in state.opt))
            _, new_opt, metrics = adamw.apply_updates(
                opt_cfg, params, grads, opt, zero1=plan.zero1,
                model=plan.model)
            opt.step.copy_(new_opt.step)
            metrics["loss"] = _mean(loss.clone(), plan)
        return state, metrics

    if shape.kind == "train":
        return train_step
    split = mesh_shape(mesh).get("model", 1) > 1
    pplaced = param_specs(cfg, mesh, kind=shape.kind)
    pshapes, pspecs = tensors_of(pplaced), specs_of(pplaced)

    def local_params(params):
        return TP.fit(tree_map(local, params), pshapes, pspecs, cfg, mesh)

    def logits_of(logits, lay):
        spec = [rows, None, "model" if lay is not None and lay.split_vocab
                else None]
        return _dtensor(mesh, logits, spec, _global(
            logits, plan, (logits.shape[1], cfg.vocab)))

    if shape.kind == "prefill":
        lay = TP.layout(cfg, mesh, pspecs) if split else None

        @torch.no_grad()
        def prefill_step(params, batch):
            with TP.installed(lay):
                logits, cache = api.prefill(local_params(params), cfg,
                                            local_rows(batch, plan))
            if lay is None and cache_len is None:
                return logits_of(logits, lay), mesh_cache(cache, mesh)
            B = logits.shape[0] * plan.count
            length = cache_len or (cache["k"].shape[2] if "k" in cache
                                   else shape.seq_len)
            return logits_of(logits, lay), _serving_cache(
                cfg, cache, mesh, B, length)
        return prefill_step

    cplaced = cache_specs(cfg, shape, mesh, enc_len=enc_len)
    cshapes, cspecs = tensors_of(cplaced), specs_of(cplaced)
    if "conv" in cspecs:
        cspecs["conv"] = _conv_spec(cspecs["state"], cshapes["state"].dim(),
                                    cshapes["conv"].dim())
    lay = None
    if split:
        cross = cshapes["ck"].shape[2] if "ck" in cshapes else 0
        lay = TP.layout(cfg, mesh, pspecs, cspecs.get("k"), shape.seq_len,
                        cspecs.get("ck"), cross)

    @torch.no_grad()
    def serve_step(params, cache, batch, index):
        local_cache = TP.fit(tree_map(local, cache), cshapes, cspecs, cfg,
                             mesh, in_place=True)
        with TP.installed(lay):
            logits, _ = api.decode_step(local_params(params), cfg,
                                        local_rows(batch, plan),
                                        local_cache, index)
        return logits_of(logits, lay), cache
    return serve_step


def _conv_spec(state_spec, state_ndim: int, conv_ndim: int
               ) -> PartitionSpec:
    """The spec a serving cache's ``conv`` window (…, B, k − 1, CH) is laid
    out by: its batch rows as the ``state`` leaf's (…, B, H, P, N) of
    ``state_ndim`` dimensions placed by ``state_spec``, and nothing on
    ``model``, whose channels :func:`_conv_leaf`
    sets. ``cache_specs``' own ``conv`` entry is not a layout of the
    window: the reference tests ``name.endswith(("k", "v", ...))`` before
    its ``conv`` rule, "conv" ends in "v", so it places the window by the
    KV rule (its leading axis on the batch axes, its batch where a KV
    cache's sequence goes), and the port mirrors it leaf for leaf."""
    batch = state_spec[state_ndim - 4] \
        if state_ndim - 4 < len(state_spec) else None
    return PartitionSpec(*([None] * (conv_ndim - 3) + [batch]))


def _conv_leaf(mesh: DeviceMesh, t: torch.Tensor, spec,
               ssm: Optional[TP.SSM], full=None):
    """A rank's ``conv`` window (its rows, every position of the window)
    as a serving cache holds it. Where the mixer is split its channels are
    [x_r | B | C] (``TP.SSM.conv_cols``; cut here from a window of every
    channel): x sharded over ``model`` and B, C replicated, which no
    placement of a DTensor describes, so the block stays this rank's plain
    tensor. A whole mixer's window is every channel on every rank: a
    DTensor placed by :func:`_conv_spec`'s ``spec``, replicated on
    ``model``, of the global shape ``full`` (inferred from the placement
    where not given)."""
    if ssm is not None and ssm.split:
        if t.shape[-1] == ssm.n_heads * ssm.P + 2 * ssm.N:
            t = t.index_select(-1, ssm.conv_cols().to(t.device))
        return t
    if full is None:
        return DTensor.from_local(t, mesh, placements(mesh, spec),
                                  run_check=False)
    return _dtensor(mesh, t, spec, full)


def _serving_cache(cfg: ModelConfig, cache: Any, mesh: DeviceMesh,
                   batch: int, length: int) -> Any:
    """The prompt's cache (this rank's rows and, with ``model`` > 1, its
    blocks as the prefill computed them) laid into this rank's block of a
    decode cache of ``length`` positions placed by :func:`cache_specs` of
    a decode shape (B = ``batch``), for any family:

    - ``k``/``v`` (L, B_r, P, KV or this rank's KV, hd): zeros past the
      prompt, and only the rank's positions where the sequence is sharded;
    - an enc-dec's ``ck``/``cv`` (L, B_r, S_enc, ...): the encoder's rows,
      never padded or cut to ``length``: the rank's kv heads as the
      prefill computed them, or its block of the rows;
    - ``state``: the rank's SSM heads or head channels, as the spec places
      them;
    - ``conv``: the rank's window over [x_r | B | C] (:func:`_conv_leaf`
      says how it is placed), spliced into the leading rows of k − 1 where
      the prompt is shorter, as the reference's ``splice`` does.

    A leaf that already is its block is placed as it is."""
    enc_len = cache["ck"].shape[2] if "ck" in cache else None
    placed = cache_specs(cfg, ShapeConfig("serve", length, batch, "decode"),
                         mesh, enc_len=enc_len)
    ssm = TP.ssm_of(cfg, mesh)
    out = {}
    for name, t in cache.items():
        full, spec = placed[name]
        if name == "conv":
            k = full.shape[-2]
            if t.shape[-2] != k:
                dst = t.new_zeros((*t.shape[:-2], k, t.shape[-1]))
                dst[..., :t.shape[-2], :] = t
                t = dst
            st = placed["state"]
            out[name] = _conv_leaf(mesh, t, _conv_spec(
                st.spec, st.tensor.dim(), full.dim()), ssm, full)
            continue
        want = SP.local_shape(tuple(full.shape), spec, mesh)
        if tuple(t.shape) != want and name in ("k", "v", "ck", "cv"):
            seq = spec[2] if len(spec) > 2 else None
            s0, _ = TP.block(full.shape[2], seq, mesh)
            dst = t.new_zeros(want)
            n = max(0, min(want[2], t.shape[2] - s0))
            dst[:, :, :n] = t[:, :, s0:s0 + n]
            t = dst
        out[name] = _dtensor(mesh, t, spec, full)
    return out


def mesh_cache(cache: Any, mesh: DeviceMesh) -> Any:
    """A cache of this rank's rows (whole on the ``model`` axis) as
    DTensors of this rank's blocks, placed by
    :func:`repro_torch.parallel.specs.cache_specs` (the batch on the data
    axes, and the kv heads or the sequence, the SSM heads or head
    channels on ``model``; an enc-dec's cross cache by the same KV rule
    over its own rows, the encoder's): a serving cache for
    :func:`mesh_step`'s serve step (given the same ``enc_len``). The specs
    are read on a mesh of the same axes with the data axes at size 1 (the
    rows given are already this rank's) and ``model`` at its size; a leaf sharded on ``model`` is cut to this rank's block (a
    copy). An SSM ``conv`` window is cut to the rank's [x_r | B | C] (a
    plain tensor where the mixer is split: :func:`_conv_leaf`)."""
    names = axis_names(mesh)
    sizes = mesh_shape(mesh)
    specs = SP.cache_specs(cache, AbstractMesh(
        [sizes[a] if a == "model" else 1 for a in names], names))
    ssm = TP.ssm_for(*cache["state"].shape[-3:], mesh) \
        if "state" in cache else None

    def place(name, t, spec):
        if name == "conv":
            return _conv_leaf(mesh, t, _conv_spec(
                specs["state"], cache["state"].dim(), t.dim()), ssm)
        for dim, entry in enumerate(spec):
            if "model" in axes_of(entry) and sizes["model"] > 1:
                lo, hi = TP.block(t.shape[dim], "model", mesh)
                t = t.narrow(dim, lo, hi - lo).clone()
        return DTensor.from_local(t, mesh, placements(mesh, spec),
                                  run_check=False)
    return {name: place(name, t, specs[name]) for name, t in cache.items()}
