"""Fault-tolerant checkpointing, in the JAX package's on-disk format.

The torch twin of ``repro/ckpt/checkpoint.py``:
  - every leaf saved as a raw .npy under step_N.tmp/, manifest.json holds
    each leaf's ``key``/``file``/``shape``/``dtype`` and a content
    checksum (sha256 of each leaf's first 4096 bytes, in flatten order),
  - atomic commit: step_N.tmp → step_N rename after the manifest is
    written; a crash mid-save never corrupts the latest checkpoint,
  - keep-last-N garbage collection,
  - async save (a background thread) so the train loop does not stall.

Each leaf's ``key`` is the string ``jax.tree_util.keystr`` gives for the
same tree (``['embed']['embedding']``, ``.params[...]``,
``.opt.master[...]``, ``.opt.step``), leaves in JAX's flatten order (dict
keys sorted, NamedTuple fields in order), so either package restores the
other's checkpoint by key. bf16 leaves are written as their 16 raw bits
in a 2-byte void dtype (``'V2'``), manifest dtype ``"bfloat16"`` — what
``np.save`` writes for an ``ml_dtypes`` bfloat16 array — and read back as
``uint16`` bits viewed as ``torch.bfloat16``; numpy needs no
``ml_dtypes``. (The JAX package's ``restore`` cannot cast such a void
array back to bfloat16, so bf16 checkpoints cross from the JAX package to
the port, and fp32 ones both ways.)

:meth:`CheckpointManager.save` copies every leaf to host numpy before it
returns, also with ``blocking=False``: the port's optimiser updates in
place, and the snapshot must be the state at the call. A DTensor leaf
(a mesh step's state) is gathered whole first, on every rank, and only
rank 0 of a running process group writes: the file holds whole arrays
whatever the mesh. :meth:`restore` places leaves on one ``device``, or,
given ``shardings`` (``NamedSharding`` leaves), onto a mesh as DTensors
of those placements: the elastic restart of the reference, a checkpoint
saved at one data-parallel width restored at another, or onto a
``model`` > 1 mesh as ``launch.steps.mesh_state`` lays a state out (a
SwiGLU ``wi``'s halves cut each, a plain tensor). A mesh state with
``model`` > 1 is saved through ``launch.steps.gather_state``.
:func:`snapshot` is that host copy alone, and :func:`from_snapshot`
restores from it as :meth:`restore` does from disk (same keys, casts and
placements), with no file between.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.compat import DTensor, distribute_tensor
from repro_torch.device import DeviceLike
from repro_torch.parallel import tensor as TP


def flatten_with_keys(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in JAX's flatten order, keys as ``keystr``."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_keys(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in flatten_with_keys(getattr(tree, f),
                                            f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten_with_keys(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(tree: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    """``tree``'s structure with each leaf replaced by ``leaves[key]``."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves,
                                       f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return leaves[prefix]


def _to_host(x: Any) -> np.ndarray:
    """A leaf as a numpy array it owns (one copy, also of a CPU tensor):
    bf16 as its bits in ``'V2'``."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.array(x, copy=True)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype.kind == "V" else str(arr.dtype)


def _from_host(arr: np.ndarray, dtype_name: str, device: torch.device
               ) -> torch.Tensor:
    if dtype_name == "bfloat16":             # 2-byte void or uint16 bits
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, *, blocking: bool = True) -> None:
        """Snapshot ``tree`` to host memory now, then write it (in a
        background thread unless ``blocking``)."""
        host = list(snapshot(tree).items())
        if dist.is_initialized() and dist.get_rank() != 0:
            return                     # rank 0 writes the gathered state
        if blocking:
            self._write(step, host)
        else:
            self.wait()
            t = threading.Thread(target=self._write, args=(step, host),
                                 daemon=True)
            t.start()
            self._pending = t

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, host: List[Tuple[str, np.ndarray]]) -> None:
        with self._lock:
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest: Dict[str, Any] = {"step": step, "paths": []}
            digest = hashlib.sha256()
            for i, (key, arr) in enumerate(host):
                fname = f"arr_{i}.npy"
                np.save(tmp / fname, arr)
                digest.update(arr.tobytes()[:4096])
                manifest["paths"].append({
                    "key": key,
                    "file": fname,
                    "shape": list(arr.shape),
                    "dtype": _dtype_name(arr),
                })
            manifest["checksum"] = digest.hexdigest()
            with open(tmp / "manifest.json", "w") as f:
                json.dump(manifest, f)
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)          # atomic commit
            self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int], target: Any,
                shardings: Any = None, *, device: DeviceLike = None) -> Any:
        """Restore into the structure of ``target`` (a tree of tensors, or
        of anything with ``.shape`` and ``.dtype``): each leaf by its key,
        its shape checked, cast to the target's dtype, on ``device`` (by
        default each target leaf's own device, else the CPU). With
        ``shardings`` (a tree of ``NamedSharding`` on a ``DeviceMesh``, of
        ``target``'s structure) each leaf becomes a DTensor of its
        placements on that mesh: every rank reads the whole array and
        keeps its block."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_key = {e["key"]: e for e in manifest["paths"]}

        def read(key: str) -> Tuple[np.ndarray, str]:
            if key not in by_key:
                raise KeyError(f"checkpoint missing leaf {key}")
            return np.load(d / by_key[key]["file"]), by_key[key]["dtype"]

        return _rebuild(target, read, shardings, device)


def snapshot(tree: Any) -> Dict[str, np.ndarray]:
    """What :meth:`CheckpointManager.save` writes, held in host memory:
    each leaf of ``tree`` by its key, a DTensor leaf gathered whole, bf16
    as its bits."""
    return {k: _to_host(v) for k, v in flatten_with_keys(tree)}


def from_snapshot(host: Dict[str, np.ndarray], target: Any,
                  shardings: Any = None, *, device: DeviceLike = None) -> Any:
    """:meth:`CheckpointManager.restore` from a :func:`snapshot` in
    memory: the same keys, shape checks, casts and placements."""
    def read(key: str) -> Tuple[np.ndarray, str]:
        if key not in host:
            raise KeyError(f"snapshot missing leaf {key}")
        return host[key], _dtype_name(host[key])

    return _rebuild(target, read, shardings, device)


def _rebuild(target: Any, read, shardings: Any, device: DeviceLike) -> Any:
    """``target``'s structure from ``read(key)`` → (host array, dtype
    name), each leaf on ``device`` (else the target leaf's own device),
    or placed by ``shardings``."""
    leaves = {}
    for key, tgt in flatten_with_keys(target):
        arr, dtype_name = read(key)
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(tgt.shape)}")
        dev = torch.device(device) if device is not None else getattr(
            tgt, "device", torch.device("cpu"))
        t = _from_host(arr, dtype_name, dev)
        leaves[key] = t.to(tgt.dtype) if isinstance(
            tgt.dtype, torch.dtype) else t
    if shardings is None:
        return _unflatten(target, leaves)
    by_leaf = dict(flatten_with_keys(shardings))
    return _unflatten(target, {k: _place(t, by_leaf[k])
                               for k, t in leaves.items()})


def _place(t: torch.Tensor, sharding) -> Any:
    """``t`` as a DTensor of ``sharding``'s placements on its mesh (on
    the mesh's device: the current CUDA device, or the CPU); a ``paired``
    leaf (a SwiGLU ``wi`` split on ``model``) as this rank's plain block
    gate_r ‖ up_r, as ``launch.steps.mesh_state`` lays it out."""
    mesh = sharding.mesh
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    if getattr(sharding, "paired", False):
        return TP.local_block(t.to(dev), sharding.spec, mesh, paired=True)
    return distribute_tensor(t.to(dev), mesh, sharding.placements)
