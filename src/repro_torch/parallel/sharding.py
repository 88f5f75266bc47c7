"""Logical-axis sharding: t5x-style logical → mesh axis rules.

The counterpart of the JAX package's ``parallel/sharding.py``. Model code
may annotate activations with *logical* axis names
(``constrain(x, ("batch", "seq", "embed"))``); the launcher installs a rule
set mapping logical names to mesh axes; outside a mesh context every
annotation is a no-op, so the same model code runs on one device (the
port's models call none, as the JAX package's models call none on the
paths the port runs).

A spec (:class:`PartitionSpec`, ``P``) is a tuple with one entry per
tensor dimension: ``None``, a mesh axis name, or a tuple of names, equal
element for element to the JAX ``PartitionSpec`` of the same rules.
:func:`placements` turns a spec into DTensor placements on a
``DeviceMesh`` (``Shard(d)`` or ``Replicate()`` per mesh dimension).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.compat import DeviceMesh, Replicate, Shard, axis_names

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Mesh axes per tensor dimension, trailing ``None``s trimmed. A leaf
    of the port's trees (``_fields``, as a NamedTuple is one)."""

    _fields = ()

    def __new__(cls, *entries: MeshAxes) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# Default rules for the production mesh (data, model[, pod]).
# "batch" spans the pure-DP axes; "expert"/"heads"/"mlp"/"vocab" use TP axis.
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_shard": "data",      # sequence parallelism for long-context decode
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert_cap": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "conv_ch": "model",
    "stack": None,            # scan-over-layers leading axis
}

_local = threading.local()


def _state():
    if not hasattr(_local, "rules"):
        _local.rules = None
        _local.mesh = None
    return _local


@contextlib.contextmanager
def axis_rules(rules: Dict[str, MeshAxes], mesh=None):
    """Install ``rules`` (and ``mesh``) for the enclosed code."""
    st = _state()
    prev = (st.rules, st.mesh)
    st.rules, st.mesh = rules, mesh
    try:
        yield
    finally:
        st.rules, st.mesh = prev


def current_mesh():
    """The mesh :func:`axis_rules` installed, else None (torch has no
    ambient mesh context)."""
    return _state().mesh


def resolve_spec(logical: Sequence[Optional[str]],
                 rules: Optional[Dict[str, MeshAxes]] = None,
                 mesh=None) -> PartitionSpec:
    """Map logical axis names to a spec valid for ``mesh``."""
    st = _state()
    rules = rules if rules is not None else (st.rules or DEFAULT_RULES)
    mesh = mesh if mesh is not None else current_mesh()
    mesh_axes = set(axis_names(mesh)) if mesh is not None else None
    out, used = [], set()
    for name in logical:
        axes = rules.get(name) if name else None
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        # drop axes missing from the mesh (e.g. "pod" on single-pod) or reused
        axes = tuple(a for a in axes
                     if (mesh_axes is None or a in mesh_axes) and a not in used)
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    # trim trailing Nones for cleanliness
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def axes_of(entry: MeshAxes) -> Tuple[str, ...]:
    """A spec entry's mesh axes as a tuple (empty for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh: DeviceMesh, spec: Sequence[MeshAxes]) -> List:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension that shards tensor dimension ``d``, ``Replicate()`` on
    the others. A dimension over several axes is split by them in the
    spec's order, major first (the mesh's order, as JAX splits it)."""
    names = axis_names(mesh)
    out: List = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for a in axes_of(entry):
            out[names.index(a)] = Shard(d)
    return out


def constrain(x, logical: Sequence[Optional[str]]):
    """The reference's sharding constraint on an activation: a no-op here,
    on a mesh too. Each rank computes on its local tensors, which already
    are its part of the layout (the port's models call none, as the
    reference's models call none on the paths the port runs)."""
    return x


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``
    (a leaf of the port's trees). ``paired``: the leaf's last dimension
    holds two halves, each cut by its entry (a SwiGLU ``wi``'s gate_r ‖
    up_r, ``parallel.tensor.local_block``), which no placement describes:
    a restore keeps that block as the rank's plain tensor."""

    mesh: object
    spec: PartitionSpec
    paired: bool = False

    @property
    def placements(self) -> List:
        return placements(self.mesh, self.spec)


def named_sharding(mesh, *logical: Optional[str]) -> NamedSharding:
    return NamedSharding(mesh, resolve_spec(logical, mesh=mesh))
