"""Coded-redundancy subsystem of the port: erasure-coded distributed
inference (numpy copies of the JAX package's modules, plus the serving
glue).

Layers:
  - :mod:`repro_torch.coding.codes`   — systematic MDS generators,
    encode/decode numpy reference, Poisson-binomial reliability DP;
  - :mod:`repro_torch.coding.spec`    — :class:`CodingSpec`, the
    array-backed per-plan coding layout a
    :class:`~repro_torch.core.plan_ir.PlanIR` carries;
  - :mod:`repro_torch.coding.compute` — :class:`ComputeCodingSpec` /
    :class:`ComputeRuntime`, intermediate-COMPUTATION coding: a slot's
    matmul is split into k weight shards + parity shards and served from
    the first k arrivals;
  - :mod:`repro_torch.coding.planner` — ``select_redundancy``, the
    mode-selection pass picking replication vs output-coding vs
    compute-coding per group;
  - :mod:`repro_torch.coding.runtime` — ``CodedRuntime``, the serving-side
    encode matrix + memoized per-arrival-pattern decode weights.

``planner``/``runtime`` import the core plan IR, which itself imports
``spec`` — they are loaded lazily here so the package stays importable
from inside :mod:`repro_torch.core.plan_ir`.
"""
from repro_torch.coding.codes import (MDSCode, arrival_shortfall_prob,
                                      cauchy_generator, decode_matrix,
                                      decode_outputs, encode_outputs,
                                      make_generator, vandermonde_generator)
from repro_torch.coding.compute import (ComputeCodingSpec, ComputeRuntime,
                                        reconstruct_from_shards,
                                        shard_linear_weights)
from repro_torch.coding.spec import CodingSpec

_LAZY = {
    "select_redundancy": "repro_torch.coding.planner",
    "deployed_compute": "repro_torch.coding.planner",
    "CodedRuntime": "repro_torch.coding.runtime",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)


__all__ = [
    "MDSCode", "CodingSpec", "ComputeCodingSpec", "ComputeRuntime",
    "arrival_shortfall_prob", "cauchy_generator", "decode_matrix",
    "decode_outputs", "encode_outputs", "make_generator",
    "reconstruct_from_shards", "shard_linear_weights",
    "vandermonde_generator", "select_redundancy", "deployed_compute",
    "CodedRuntime",
]
