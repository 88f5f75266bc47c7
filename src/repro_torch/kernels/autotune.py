"""Block-size autotuner for the port's serving kernels.

The tunable kernels (``quorum_aggregate``, ``coded_decode``,
``dequant_matmul``) take a tile size; the right one depends on the deployed
shapes (portion width, batch bucket, share count) and on the card. This
module searches the tile space with the microbench's timer (device time
on the card) and keeps the winners in a shape-keyed tuning table that the
kernels' wrappers consult on every call.

Table contract
--------------
A table is a flat JSON object mapping ``"<kernel>|<d0>x<d1>x…|<dtype>"``
keys to block-parameter dicts, e.g.::

    {"dequant_matmul|256x64x512|int8": {"block_batch": 32, "block_n": 64},
     "quorum_aggregate|4x256x16x10|float32": {"block_batch": 32}}

The keys are the JAX package's (``repro.kernels.autotune``) for the same
shape and dtype; the values are the CUDA kernels' own tiles:

- ``quorum_aggregate`` ``block_batch``: output rows per block (one row a
  block by default on the rows route, so a serving batch spreads over the
  SMs; 256 threads of ``block_batch × bn`` on the tiles route, bn = 16
  classes for C ≤ 16, else 32; see :func:`defaults`);
- ``coded_decode`` ``block_batch``: batch rows per block;
- ``dequant_matmul`` ``block_batch`` × ``block_n``: the output tile on the
  CUDA-core route; on the tensor route ``block_batch`` alone, 64 or 128
  rows (one or two warpgroups) by 128 columns (``dequant_matmul.plan``).
  On a miss the wrapper takes ``dequant_matmul.default_tile``, which
  fills the card's SMs.

The shape component is the kernel's problem shape (see the ``key_*``
helpers). Lookup is exact-match: an unknown shape falls back to the
defaults, and a tile changes which block owns an output, never the order
of its sum, so a stale or missing table never changes numerics, only
speed.

The in-process table is loaded once from ``REPRO_TORCH_TUNING_TABLE`` (env
var) or ``tuning_table.json`` beside this module if present, so a TPU
table (``REPRO_TUNING_TABLE``) never reaches a CUDA kernel; ``set_table`` /
``reset`` override it for tests and benchmarks.

Search discipline
-----------------
The default tile is always a candidate, and a non-default winner is
recorded only when it beats the default by a hysteresis margin (5%), so
timing noise cannot regress a shape below the default.
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels._layout import num_sms

# the defaults the wrappers apply on a table miss: one output row a block
# for the merge's rows route (256 blocks for a batch of 256 on 132 SMs;
# :func:`defaults` gives its tiles route 256 threads, 16 rows of 16 classes
# or 8 of 32), two rows per block for the decode (a warp of 16-byte
# accesses at the fused output-coded F 64, 128 blocks for a batch of 256),
# dequant_matmul's largest tile (two warpgroups on the tensor route, 256
# threads of 8 x 8 outputs on the CUDA-core one), and the baselines the
# hysteresis margin protects
DEFAULTS: Dict[str, Dict[str, int]] = {
    "quorum_aggregate": {"block_batch": 1},
    "coded_decode": {"block_batch": 2},
    "dequant_matmul": {"block_batch": 128, "block_n": 128},
}

# candidate grids (the default is always a member)
CANDIDATES: Dict[str, Dict[str, Tuple[int, ...]]] = {
    "quorum_aggregate": {"block_batch": (1, 2, 4, 8, 16, 32)},
    "coded_decode": {"block_batch": (1, 2, 4, 8, 16)},
    "dequant_matmul": {"block_batch": (16, 32, 64, 128),
                       "block_n": (16, 32, 64, 128)},
}

# a non-default config must win by this factor to be recorded
HYSTERESIS = 1.05

_DEFAULT_PATH = pathlib.Path(__file__).with_name("tuning_table.json")


def _dtype_name(dtype) -> str:
    """numpy's name of a numpy or torch dtype (``torch.int8`` → "int8")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def table_key(kernel: str, shape: Sequence[int], dtype) -> str:
    """The flat-JSON key: ``kernel|d0xd1x…|dtype``."""
    dims = "x".join(str(int(d)) for d in shape)
    return f"{kernel}|{dims}|{_dtype_name(dtype)}"


class TuningTable:
    """Shape-keyed block-size table with JSON persistence."""

    def __init__(self, entries: Optional[Dict[str, Dict[str, int]]] = None):
        self.entries: Dict[str, Dict[str, int]] = dict(entries or {})

    def get(self, kernel: str, shape: Sequence[int], dtype
            ) -> Optional[Dict[str, int]]:
        return self.entries.get(table_key(kernel, shape, dtype))

    def put(self, kernel: str, shape: Sequence[int], dtype,
            blocks: Dict[str, int]) -> None:
        self.entries[table_key(kernel, shape, dtype)] = \
            {k: int(v) for k, v in blocks.items()}

    def save(self, path) -> None:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.entries, indent=1, sort_keys=True))

    @classmethod
    def load(cls, path) -> "TuningTable":
        return cls(json.loads(pathlib.Path(path).read_text()))

    def __len__(self) -> int:
        return len(self.entries)


_table: Optional[TuningTable] = None


def active_table() -> TuningTable:
    """The process-wide table the wrappers consult:
    ``REPRO_TORCH_TUNING_TABLE`` when set, else ``tuning_table.json``
    beside this module, else empty."""
    global _table
    if _table is None:
        path = os.environ.get("REPRO_TORCH_TUNING_TABLE") or _DEFAULT_PATH
        try:
            _table = TuningTable.load(path)
        except (OSError, ValueError):
            _table = TuningTable()
    return _table


def set_table(table: Optional[TuningTable]) -> None:
    """Install (or with ``None`` drop back to lazy-load) the active table."""
    global _table
    _table = table


def reset() -> None:
    """Forget the cached table so the next lookup reloads from disk/env."""
    set_table(None)


def defaults(kernel: str, shape: Sequence[int]) -> Dict[str, int]:
    """The tile a call at ``shape`` (the ``key_*`` shape) takes on a table
    miss: ``DEFAULTS``, except that a merge whose shape takes the tiles
    route keeps a 256-thread block: 16 rows of 16 classes, or 8 rows where
    C > 16 classes make a tile 32 wide."""
    blocks = dict(DEFAULTS[kernel])
    if kernel == "quorum_aggregate":
        from repro_torch.kernels.quorum_aggregate import route
        K, _, Dk, C = shape
        if route(K, Dk, C) == "tiles":
            blocks["block_batch"] = 16 if C <= 16 else 8
    return blocks


def resolve(kernel: str, shape: Sequence[int], dtype,
            overrides: Optional[Dict[str, Optional[int]]] = None,
            default: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """The block sizes a call should use: caller overrides (non-``None``
    values) beat the tuning table, which beats ``default`` (the built-in
    :func:`defaults` unless given). An empty table is not searched."""
    blocks = dict(default) if default else defaults(kernel, shape)
    table = active_table()
    tuned = table.get(kernel, shape, dtype) if len(table) else None
    if tuned:
        blocks.update({k: v for k, v in tuned.items() if k in blocks})
    if overrides:
        blocks.update({k: int(v) for k, v in overrides.items()
                       if v is not None and k in blocks})
    return blocks


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def _configs(kernel: str, default: Optional[Dict[str, int]] = None
             ) -> Tuple[Dict[str, int], ...]:
    """Cartesian candidate grid, default config (``DEFAULTS`` unless given)
    first."""
    grids = CANDIDATES[kernel]
    names = sorted(grids)
    out = [dict(default or DEFAULTS[kernel])]
    stack = [{}]
    for n in names:
        stack = [dict(c, **{n: v}) for c in stack for v in grids[n]]
    for c in stack:
        if c != out[0]:
            out.append(c)
    return tuple(out)


def tune_call(kernel: str, make_call: Callable[[Dict[str, int]], Callable],
              *, repeats: int = 5, default: Optional[Dict[str, int]] = None,
              configs: Optional[Sequence[Dict[str, int]]] = None
              ) -> Tuple[Dict[str, int], Dict[str, float]]:
    """Time ``make_call(blocks)()`` for every candidate config
    (``_configs(kernel, default)`` unless given, the default first) and
    pick the winner under the hysteresis rule: the default (``DEFAULTS``
    unless given) keeps its seat unless a challenger is >5% faster.
    Returns ``(blocks, {config_key: seconds})``."""
    from repro_torch.launch.microbench import time_callable
    default = dict(configs[0] if configs else default or DEFAULTS[kernel])
    timings: Dict[str, float] = {}
    best_blocks, best_t, default_t = None, np.inf, np.inf
    for blocks in configs or _configs(kernel, default):
        fn = make_call(blocks)
        t = time_callable(fn, repeats=repeats)
        key = ",".join(f"{k}={v}" for k, v in sorted(blocks.items()))
        timings[key] = t
        if blocks == default:
            default_t = t
        if t < best_t:
            best_blocks, best_t = blocks, t
    if best_blocks != default and best_t * HYSTERESIS > default_t:
        best_blocks = default
    return best_blocks, timings


# per-kernel problem-shape keys (what the wrappers key their lookups on)

def key_quorum_aggregate(portions, weights) -> Tuple[Tuple[int, ...], object]:
    """(K, B, Dk, C) + weights dtype."""
    K, B, Dk = portions.shape
    return (K, B, Dk, int(weights.shape[-1])), weights.dtype


def key_coded_decode(shares, dec) -> Tuple[Tuple[int, ...], object]:
    """(B, R, K, F) + shares dtype."""
    B, R, F = shares.shape
    return (B, R, int(dec.shape[1]), F), shares.dtype


def key_dequant_matmul(x, q) -> Tuple[Tuple[int, ...], object]:
    """(B, D, N) + weight dtype."""
    B, D = x.shape
    return (B, D, int(q.shape[-1])), q.dtype


def tune_quorum_aggregate(table: TuningTable, portions, weights, bias, mask,
                          scales=None, *, repeats: int = 5
                          ) -> Dict[str, float]:
    """Search block_batch for one quorum-aggregate shape; record the winner."""
    from repro_torch.kernels import ops as K
    shape, dtype = key_quorum_aggregate(portions, weights)

    def make(blocks):
        return lambda: K.quorum_aggregate(
            portions, weights, bias, mask, scales,
            block_batch=blocks["block_batch"])
    blocks, timings = tune_call("quorum_aggregate", make, repeats=repeats,
                                default=defaults("quorum_aggregate", shape))
    table.put("quorum_aggregate", shape, dtype, blocks)
    return timings


def tune_coded_decode(table: TuningTable, shares, dec, mask, scales=None, *,
                      repeats: int = 5) -> Dict[str, float]:
    """Search block_batch for one coded-decode shape; record the winner."""
    from repro_torch.kernels import ops as K
    shape, dtype = key_coded_decode(shares, dec)

    def make(blocks):
        return lambda: K.coded_decode(shares, dec, mask, scales,
                                      block_batch=blocks["block_batch"])
    blocks, timings = tune_call("coded_decode", make, repeats=repeats)
    table.put("coded_decode", shape, dtype, blocks)
    return timings


def tune_dequant_matmul(table: TuningTable, x, q, scale, *,
                        repeats: int = 5) -> Dict[str, float]:
    """Search (block_batch, block_n) for one dequant-matmul shape: each
    distinct launch of the grid once (``dequant_matmul.candidates``; a CPU
    tensor takes the plain version whatever the tile, so one SM there)."""
    from repro_torch.kernels import dequant_matmul as DQ
    from repro_torch.kernels import ops as K
    shape, dtype = key_dequant_matmul(x, q)
    sms = num_sms(x.device.index) if x.device.type == "cuda" else 1

    def make(blocks):
        return lambda: K.dequant_matmul(x, q, scale,
                                        block_batch=blocks["block_batch"],
                                        block_n=blocks["block_n"])
    blocks, timings = tune_call("dequant_matmul", make, repeats=repeats,
                                configs=DQ.candidates(*shape, sms))
    table.put("dequant_matmul", shape, dtype, blocks)
    return timings
