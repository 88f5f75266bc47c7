"""GPipe-style pipeline parallelism over the ranks of a mesh axis.

The counterpart of the JAX package's ``parallel/pipeline.py`` (there
``shard_map`` + ``ppermute``). Stages are the ranks of a ``stage`` axis of
a ``DeviceMesh``; microbatches stream through with the classic (S + M − 1)
-tick schedule. Each rank applies only its stage's parameters; activations
hop stage → stage by ``send``/``recv`` (one ``batch_isend_irecv`` a tick).
As in the reference every stage computes at every tick (on its buffer
while the pipe fills or drains), the last stage collects the outputs, and
they are broadcast back so every rank returns them. S = 1 is direct
application. An optional parallelism mode, tested on CPU process groups.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.compat import mesh_shape
from repro_torch.tree import tree_map


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, *, mesh,
                   axis: str = "stage", n_microbatches: int = None
                   ) -> torch.Tensor:
    """Run ``x`` through S = mesh size on ``axis`` pipeline stages.

    stage_params: tree with leading stage dim S (a rank reads only its
    own stage).
    x: (B, ...) global batch, the same on every rank, divided into M
    microbatches. Returns stage S-1's outputs in the original batch order,
    on every rank."""
    S = mesh_shape(mesh)[axis]
    M = n_microbatches or S
    B = x.shape[0]
    assert B % M == 0, (B, M)
    mb = B // M
    sid = mesh.get_local_rank(axis) if S > 1 else 0

    params = tree_map(lambda t: t[sid], stage_params)
    if S == 1:
        return stage_fn(params, x)
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(sid + 1) % S], ranks[(sid - 1) % S]
    xs = x.reshape(M, mb, *x.shape[1:])
    buf = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    for t in range(M + S - 1):
        # stage 0 feeds microbatch t (its buffer once drained)
        inp = xs[t] if sid == 0 and t < M else buf
        y = stage_fn(params, inp)
        # shift activations to the next stage
        buf = torch.empty_like(y)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, y.contiguous(), nxt, group),
            dist.P2POp(dist.irecv, buf, prv, group)])
        for r in reqs:
            r.wait()
        # last stage emits: output for microbatch t - (S - 1)
        out_idx = t - (S - 1)
        if sid == S - 1 and 0 <= out_idx < M:
            outs[out_idx] = y
    # only the LAST stage's collected outs are real; broadcast them back
    dist.broadcast(outs, src=ranks[S - 1], group=group)
    return outs.reshape(B, *x.shape[1:])


def stage_mlp_init(gen: torch.Generator, S: int, dim: int, hidden: int):
    """Tiny S-stage MLP for tests/demos, drawn from ``gen`` on its device."""
    dev = gen.device
    return {"w1": torch.randn((S, dim, hidden), generator=gen, device=dev)
            / math.sqrt(dim),
            "w2": torch.randn((S, hidden, dim), generator=gen, device=dev)
            / math.sqrt(hidden)}


def stage_mlp_apply(params, x):
    return torch.tanh(x @ params["w1"]) @ params["w2"] + x
