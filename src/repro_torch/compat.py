"""torch version-compat helpers for the multi-device tooling.

The card's torch (2.11) and a newer CPU torch differ in where the
distributed tensor API lives and in the names of two collectives; these
helpers absorb the moves, as the JAX package's ``compat.py`` absorbs
``shard_map``'s and ``AbstractMesh``'s:

  - ``DeviceMesh``/``init_device_mesh``: ``torch.distributed.device_mesh``;
  - ``DTensor``, ``Shard``, ``Replicate``, ``Partial``,
    ``distribute_tensor``: public ``torch.distributed.tensor`` where it
    exists, else the older private ``torch.distributed._tensor``;
  - :func:`all_gather_single` / :func:`reduce_scatter_single`: the newer
    names of ``all_gather_into_tensor`` / ``reduce_scatter_tensor``.

:class:`AbstractMesh` is a mesh of shape and axis names with no devices and
no process group, which the spec functions accept wherever the JAX package
takes a ``jax.sharding.AbstractMesh`` (the production (16, 16) and (2, 16,
16) meshes of the dry run). :func:`mesh_shape` reads the axis sizes of
either kind of mesh.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

try:
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
except ImportError:                       # torch before the public module
    from torch.distributed._tensor import (DTensor, Replicate, Shard,
                                           distribute_tensor)
    from torch.distributed._tensor.placement_types import (
        _Partial as Partial)

__all__ = ["AbstractMesh", "DTensor", "DeviceMesh", "Partial", "Replicate",
           "Shard", "abstract_mesh", "all_gather_single", "axis_names",
           "distribute_tensor", "fake_store", "init_device_mesh", "local",
           "mesh_shape", "reduce_scatter_single"]


class AbstractMesh:
    """A device-free mesh: ``shape`` maps each axis name to its size, in
    order, as ``jax.sharding.AbstractMesh.shape`` does."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for axes {axis_names}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(n) for n in shape)))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"AbstractMesh({axes})"


def abstract_mesh(shape: Sequence[int], axis_names: Sequence[str]
                  ) -> AbstractMesh:
    """The counterpart of the JAX package's ``compat.abstract_mesh``."""
    return AbstractMesh(shape, axis_names)


def axis_names(mesh) -> Tuple[str, ...]:
    """A mesh's axis names, abstract or a ``DeviceMesh``."""
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names or ())
    return tuple(mesh.axis_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name → size, in the mesh's order, for either kind of mesh."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(axis_names(mesh), mesh.shape))
    return dict(mesh.shape)


def local(t):
    """This rank's block of ``t``: ``to_local()`` of a DTensor, else ``t``
    (already a local block)."""
    return t.to_local() if isinstance(t, DTensor) else t


def all_gather_single(output, input, group=None):
    """Gather every rank's ``input`` into ``output`` along dim 0."""
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    return fn(output, input, group=group)


def reduce_scatter_single(output, input, group=None):
    """Sum ``input`` over the ranks and keep this rank's dim-0 block."""
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    return fn(output, input, group=group)


def fake_store():
    """The store of a one-process ``fake`` process group, whose
    collectives do nothing: a ``DeviceMesh`` of any size builds on it
    (the dry run's production meshes)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()
