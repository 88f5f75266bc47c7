"""Parameters from the JAX package into the port's trees.

``params_from_jax`` takes a parameter tree of numpy arrays (what
``jax.device_get`` returns for the JAX package's student params) and gives
the port's dict of CPU tensors: 4-D conv kernels go from HWIO to OIHW,
an absent ``expand`` conv (``None`` in the JAX tree) is left out, and
everything else — dense kernels, BN ``scale``/``bias``/``mean``/``var`` —
carries across as it is. ``fc_from_jax`` converts the FC head (or the
per-slot FC slices) without any permutation. ``lm_params_from_jax``
converts an LM parameter tree of any ported family leaf by leaf, with no
permutation: the dense and MoE ``layers`` and the SSM ``layers`` stacked on
axis 0, the hybrid's stacked ``periods`` with their ``sub{i}`` dicts; bf16
leaves bit for bit, fp32 ones (the MoE router, the SSM ``A_log``, ``D``
and ``dt_bias``) as they are. With converted weights both packages compute
the same function.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree: Any) -> Any:
    """A JAX student parameter tree (numpy leaves) → the port's tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if v is None:
                continue
            if k == "kernel" and np.ndim(v) == 4:          # HWIO → OIHW
                out[k] = _tensor(np.transpose(np.asarray(v), (3, 2, 0, 1)))
            else:
                out[k] = params_from_jax(v)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v) for v in tree)
    return _tensor(tree)


def fc_from_jax(tree: Any) -> Any:
    """The FC head ``{"kernel", "bias"}`` or an FC slice array, as tensors."""
    if isinstance(tree, dict):
        return {k: fc_from_jax(v) for k, v in tree.items()}
    return _tensor(tree)


def _lm_tensor(a) -> torch.Tensor:
    """One leaf: bf16 arrays (``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses) go through their uint16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16), copy=True)
                                ).view(torch.bfloat16)
    return _tensor(a)


def lm_params_from_jax(tree: Any) -> Any:
    """A JAX LM parameter tree (numpy leaves) → the port's tree: the same
    keys and shapes, every leaf as it is (no HWIO→OIHW rule)."""
    if isinstance(tree, dict):
        return {k: lm_params_from_jax(v) for k, v in tree.items()}
    return _lm_tensor(tree)
