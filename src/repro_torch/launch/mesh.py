"""Mesh construction.

FUNCTIONS, not module-level constants: importing this module touches no
device and no process group, as in the JAX package's ``launch/mesh.py``.
:func:`make_production_mesh` is abstract (shape and axis names only: the
dry run's 256- and 512-chip meshes); :func:`make_mesh` and
:func:`make_host_mesh` return a ``DeviceMesh`` over the running process
group, which :func:`init_group` starts (one process) where none runs, or
which several processes join with :func:`join_group`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.compat import AbstractMesh, DeviceMesh, init_device_mesh
from repro_torch.device import DeviceLike, resolve_device


def init_group(device: DeviceLike = None) -> None:
    """Start a one-process group where none runs: NCCL on ``cuda`` (the
    default), gloo on ``cpu``, on an in-memory ``HashStore`` (no TCP
    rendezvous). A running group is left as it is. Several processes
    start theirs themselves (``init_process_group`` with a ``FileStore``
    or an address, their world size and rank)."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def join_group(store: str, rank: int, world: int,
               device: DeviceLike = None) -> torch.device:
    """Join a ``world``-process group as ``rank`` through a ``FileStore``
    at the path ``store`` (no TCP rendezvous) and return this rank's
    device. On ``cuda`` (the default) rank r takes card r modulo the
    host's cards, over NCCL where every rank has a card of its own and
    over gloo where ranks share one (NCCL refuses two ranks of one group
    on one device; gloo copies CUDA tensors through host memory for each
    collective). On ``cpu``, gloo."""
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", rank % cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if cards >= world else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    return dev


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh, (16, 16) or (2, 16, 16), with no devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device: DeviceLike = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the process group (started by
    :func:`init_group` on ``device`` where none runs), whose size it must
    equal."""
    dev = resolve_device(device)
    init_group(dev)
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(model: Optional[int] = None, *,
                   device: DeviceLike = None) -> DeviceMesh:
    """(ranks / model, model) over ("data", "model"): every rank of the
    group (the CPU tests' meshes)."""
    dev = resolve_device(device)
    init_group(dev)
    n = dist.get_world_size()
    model = model or 1
    if n % model:
        raise ValueError(f"model={model} does not divide {n} ranks")
    return make_mesh((n // model, model), ("data", "model"), device=dev)
