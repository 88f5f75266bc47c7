"""Parameter / cache / optimiser spec trees.

The counterpart of the JAX package's ``parallel/specs.py``, on the port's
trees (nested dicts of tensors; ``meta`` tensors from
``api.init(meta_generator(), cfg)`` stand where the reference takes
``eval_shape``'d params) and on abstract or real meshes. Path-based
logical-axis rules: every parameter path maps to a tuple of logical axis
names, resolved against the mesh by
:func:`repro_torch.parallel.sharding.resolve_spec` (axes absent from the
mesh degrade to replication, so the same rules serve one device and
512-chip pods). The trees are driven by the tensor (shape) tree: a spec is
a leaf wherever it is passed beside one.
"""
from __future__ import annotations

import re
from typing import Any, Optional, Sequence, Tuple

from repro_torch.compat import axis_names, mesh_shape
from repro_torch.parallel.sharding import (DEFAULT_RULES, NamedSharding,
                                           P, PartitionSpec, _state,
                                           resolve_spec)
from repro_torch.tree import tree_map, tree_map_with_path

# (path regex, logical axes for the *trailing* dims of the array)
PARAM_RULES = [
    (r"embed/embedding$", ("vocab", "embed")),
    (r"lm_head/kernel$", ("embed", "vocab")),
    (r"ffn/wi$", ("expert", None, "embed", "mlp")),    # MoE (E, 2, d, ff)
    (r"ffn/wo$", ("expert", "mlp", "embed")),
    (r"ffn/wi/kernel$", ("embed", "mlp")),             # dense FFN
    (r"ffn/wo/kernel$", ("mlp", "embed")),
    (r"ffn/wi/bias$", ("mlp",)),
    (r"ffn/wo/bias$", ("embed",)),
    (r"wq$", ("embed", "heads", None)),                # 3-D head-structured
    (r"(wk|wv)$", ("embed", "kv_heads", None)),
    (r"wo$", ("heads", None, "embed")),
    (r"router/kernel$", ("embed", None)),
    (r"in_proj/kernel$", ("embed", "ssm_inner")),
    (r"out_proj/kernel$", ("ssm_inner", "embed")),
    (r"conv_w$", (None, "conv_ch")),
    (r"conv_b$", ("conv_ch",)),
    (r"(A_log|D|dt_bias)$", (None,)),
    (r"out_norm/scale$", (None,)),
    (r".*norm.*/(scale|bias)$", (None,)),
    (r".*", (None,)),  # fallback: replicate
]

_STACK_KEYS = ("layers", "periods", "enc_layers", "dec_layers")


def _path_str(path: Sequence) -> str:
    return "/".join(str(p) for p in path)


def logical_axes_for(path_str: str, ndim: int) -> Tuple[Optional[str], ...]:
    stacked = any(k in path_str.split("/") for k in _STACK_KEYS)
    for pat, axes in PARAM_RULES:
        if re.search(pat, path_str):
            axes = tuple(axes)
            if stacked and len(axes) < ndim:
                axes = ("stack",) * (ndim - len(axes)) + axes
            if len(axes) != ndim:  # rank mismatch (e.g. fallback on 2-D) → replicate
                axes = (None,) * ndim
            return axes
    return (None,) * ndim


def param_specs(params_shape: Any, mesh=None, cfg: Any = None,
                kind: Optional[str] = None) -> Any:
    """Spec tree for a params (or meta params) tree.

    With `cfg` + `kind`, applies arch-aware fallbacks when the primary
    sharding would not divide evenly:
      - GQA with kv_heads % model != 0:
          train/prefill → input-dim-shard wk/wv ('model' on d, psum after);
          decode        → replicate wk/wv (matches the seq-sharded cache).
      - MoE with n_experts % model != 0 → shard the expert FFN dim instead
        (tensor-parallel experts: every chip holds all experts, ff/TP each).
    """
    sizes = mesh_shape(mesh) if mesh is not None else {}
    model_sz = sizes.get("model", 1)

    def spec_for(path, leaf):
        ps = _path_str(path)
        shape = tuple(leaf.shape)
        axes = logical_axes_for(ps, len(shape))
        spec = resolve_spec(axes, mesh=mesh)
        if cfg is None or mesh is None or model_sz == 1:
            return spec
        if re.search(r"(wk|wv)$", ps) and cfg.n_kv_heads % model_sz != 0:
            d, kvh, hd = shape[-3:]
            pre = (None,) * (len(shape) - 3)
            if kind == "decode":
                return P(*pre)
            if d % model_sz == 0:
                return P(*pre, "model", None, None)
            return P(*pre)
        if cfg.n_experts and cfg.n_experts % model_sz != 0 and len(shape) >= 3:
            # experts can't shard on `model`: 2-D-shard each expert matrix
            # instead — d over `data` (FSDP-style re-gather), ff over `model`.
            data_ok = ("data" in axis_names(mesh)
                       and cfg.d_model % sizes["data"] == 0)
            if re.search(r"ffn/wi$", ps):  # (…, E, 2, d, ff)
                return P(*(None,) * (len(shape) - 2),
                         "data" if data_ok else None, "model")
            if re.search(r"ffn/wo$", ps):  # (…, E, ff, d)
                return P(*(None,) * (len(shape) - 2), "model",
                         "data" if data_ok else None)
        return spec

    return tree_map_with_path(spec_for, params_shape)


def shardings_from_specs(shape_tree: Any, spec_tree: Any, mesh) -> Any:
    """:class:`NamedSharding` leaves on ``mesh`` for ``spec_tree`` (driven
    by ``shape_tree``, whose structure it has)."""
    return tree_map(lambda _, s: NamedSharding(mesh, s), shape_tree,
                    spec_tree)


def zero1_specs(spec_tree: Any, shape_tree: Any, mesh,
                axis: str = "data") -> Any:
    """ZeRO-1: additionally shard optimizer-state tensors along `axis` on the
    first dimension that is currently unsharded and divisible by the axis size.
    """
    if axis not in axis_names(mesh):
        return spec_tree
    size = mesh_shape(mesh)[axis]

    def upgrade(sds, spec: PartitionSpec) -> PartitionSpec:
        dims = list(spec) + [None] * (len(sds.shape) - len(spec))
        used = set()
        for d in dims:
            if d is None:
                continue
            used.update((d,) if isinstance(d, str) else d)
        if axis in used:
            return spec
        for i, (cur, dim) in enumerate(zip(dims, sds.shape)):
            if cur is None and dim % size == 0 and dim >= size:
                dims[i] = axis
                return P(*dims)
        return spec

    return tree_map(upgrade, shape_tree, spec_tree)


# ---------------------------------------------------------------------------
# divisibility sanitization
# ---------------------------------------------------------------------------

def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def sanitize_spec(spec: PartitionSpec, shape: Sequence[int],
                  mesh) -> PartitionSpec:
    """Drop (or shrink) sharded axes that do not divide their dim: a
    placed input must divide evenly."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axes in zip(shape, dims):
        if axes is None:
            out.append(None)
            continue
        cand = axes if isinstance(axes, tuple) else (axes,)
        picked = None
        # try full tuple, then suffixes (drop leading axes), then single axes
        trials = [cand] + [cand[i:] for i in range(1, len(cand))] + \
                 [(a,) for a in cand]
        for t in trials:
            if t and dim % _axis_size(mesh, t) == 0:
                picked = t if len(t) > 1 else t[0]
                break
        out.append(picked)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def sanitize_tree(spec_tree: Any, shape_tree: Any, mesh) -> Any:
    return tree_map(lambda sds, s: sanitize_spec(s, tuple(sds.shape), mesh),
                    shape_tree, spec_tree)


def local_shape(shape: Sequence[int], spec: Sequence, mesh
                ) -> Tuple[int, ...]:
    """One rank's block of a ``shape`` placed by a sanitized ``spec``."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(n // _axis_size(mesh, a) for n, a in zip(shape, dims))


# ---------------------------------------------------------------------------
# cache specs (decode KV / SSM state)
# ---------------------------------------------------------------------------

def cache_specs(cache_shape: Any, mesh, *, seq_sharded: bool = False) -> Any:
    """Spec tree for a decode cache, divisibility-aware.

    seq_sharded=True (long-context, tiny batch): shard the KV sequence dim on
    the data axis (sequence parallelism) instead of batch.
    For the head dims, prefer kv_heads on `model`; if the arch's KV head count
    doesn't divide the axis (MQA/GQA), fall back to sharding head_dim.
    """
    def spec_for(path, leaf):
        name = _path_str(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        if mesh is None:
            return P()
        names = axis_names(mesh)
        batch_ax = None if seq_sharded else "batch"
        if name.endswith(("k", "v", "ck", "cv")):
            # KV heads shard on `model` when they divide; otherwise shard the
            # *sequence* dim on `model` (flash-decoding style context
            # parallelism).
            kv_dim = shape[-2]
            kv_sz = _axis_size(mesh, resolve_spec(("kv_heads",),
                                                  mesh=mesh)[0] or ())
            seq_axes = []
            if seq_sharded:
                seq_axes.append("seq_shard")
            kv_ok = kv_sz > 1 and kv_dim % kv_sz == 0
            if not kv_ok:
                seq_axes.append("seq_model_shard")
            base = [batch_ax, tuple(seq_axes) if seq_axes else None,
                    "kv_heads" if kv_ok else None, None]
        elif name.endswith("conv"):
            base = [batch_ax, None, "conv_ch"]
        elif name.endswith("state"):
            h_dim, p_dim = shape[-3], shape[-2]
            h_sz = _axis_size(mesh, resolve_spec(("ssm_inner",),
                                                 mesh=mesh)[0] or ())
            if h_sz > 1 and h_dim % h_sz != 0 and p_dim % h_sz == 0:
                base = [batch_ax, None, "head_dim_shard", None]
            else:
                base = [batch_ax, "ssm_inner", None, None]
        else:
            base = [None] * nd
        base = [None] * (nd - len(base)) + list(base[:nd])
        rules = dict(_state().rules or DEFAULT_RULES)
        rules.update({"head_dim_shard": "model", "seq_model_shard": "model"})

        def expand(ax):
            out = []
            for a in ax:
                r = rules.get(a)
                if r is None:
                    continue
                out.extend((r,) if isinstance(r, str) else r)
            return tuple(a for a in out if a in names) or None

        # resolve tuple entries manually, single names by the rules
        resolved = []
        used = set()
        for ax in base:
            if isinstance(ax, tuple):
                axes = expand(ax)
                if axes:
                    axes = tuple(a for a in axes if a not in used)
                    used.update(axes)
                resolved.append(axes if axes else None)
            elif ax is None:
                resolved.append(None)
            else:
                r = rules.get(ax)
                if isinstance(r, tuple):
                    r = tuple(a for a in r if a in names and a not in used)
                    r = r if r else None
                elif isinstance(r, str):
                    r = r if (r in names and r not in used) else None
                if r is not None:
                    used.update((r,) if isinstance(r, str) else r)
                resolved.append(r)
        return sanitize_spec(P(*resolved), shape, mesh)

    return tree_map_with_path(spec_for, cache_shape)
