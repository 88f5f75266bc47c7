"""Coded intermediate computation: MDS-sharded linear layers (Hadidi-style).

Output coding (`spec.py` / `runtime.py`) protects the *outputs* of whole
student forwards: parity devices run extra full portions and a decode
recovers erased outputs.  This module codes the *computation itself*.  A
portion's final linear layer ``y = x @ W`` (``W`` is ``(D, F)``) is split
along the output features into ``k`` blocks of width ``w = ceil(F / k)``
(zero-padded to ``k * w``), and ``r = n - k`` parity shards hold
pre-encoded weights ``W~_j = sum_i G[k + j, i] * W_i`` built from the same
systematic MDS generators as output coding (`codes.make_generator`).  Each
of the ``n`` devices computes one shard product ``x @ W_i`` — ``1/k`` of
the FLOPs and output bytes of the full layer — and ANY ``k`` arrivals
reconstruct ``y`` exactly via `codes.decode_matrix`.  Stragglers become
erasures mid-network: serving completes on the first ``k`` share arrivals
and cancels the rest, so latency is the k-th order statistic of shard
arrivals instead of a max (or a min over full replicas).

Eq. 1a bookkeeping: both the FLOP and the transmit term scale by ``1/k``
(modulo the zero-pad remainder), so a shard's latency on device ``c`` is
``latency_nd[stu, c] / k``; deployed compute for a coded slot is ``n/k``
of one replica, versus ``g`` for g-way replication.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.coding.codes import (arrival_shortfall_prob, decode_matrix,
                                make_generator)

__all__ = [
    "ComputeCodingSpec",
    "ComputeRuntime",
    "shard_linear_weights",
    "reconstruct_from_shards",
]


def shard_linear_weights(W: np.ndarray, n: int, k: int,
                         construction: str = "vandermonde") -> np.ndarray:
    """Encode a linear layer's weights into ``n`` compute shards.

    ``W`` is the ``(D, F)`` weight of ``y = x @ W``.  The output features
    are zero-padded to ``k * w`` with ``w = ceil(F / k)`` and split into
    ``k`` column blocks ``W_0 .. W_{k-1}``; shard ``j >= k`` holds the
    pre-encoded parity ``W~_j = sum_i G[j, i] * W_i``.  Returns the
    ``(n, D, w)`` stack in generator-row order (systematic first), ready
    for `kernels.ops.coded_matmul`.
    """
    W = np.asarray(W)
    if W.ndim != 2:
        raise ValueError(f"W must be 2-D, got shape {W.shape}")
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got (n, k) = ({n}, {k})")
    D, F = W.shape
    w = -(-F // k)
    pad = np.zeros((D, k * w - F), W.dtype)
    blocks = np.concatenate([W, pad], axis=1).reshape(D, k, w)
    G = make_generator(n, k, construction)
    # systematic rows of G are exactly I, so shards[:k] are the raw blocks
    shards = np.einsum("nk,dkw->ndw", G.astype(W.dtype, copy=False), blocks)
    shards[:k] = np.moveaxis(blocks, 1, 0)
    return shards


def reconstruct_from_shards(partials: np.ndarray, G: np.ndarray,
                            arrived: np.ndarray, out_dim: int) -> np.ndarray:
    """Reference decode: rebuild ``y = x @ W`` from any ``k`` shard products.

    ``partials`` is the ``(n, B, w)`` stack of per-shard outputs (rows for
    un-arrived shards are ignored), ``G`` the ``(n, k)`` generator and
    ``arrived`` an ``(n,)`` bool mask with at least ``k`` True entries.
    Returns the exact ``(B, out_dim)`` layer output (numpy, fp64 decode).
    """
    n, k = G.shape
    D = decode_matrix(G, np.asarray(arrived, bool))            # (k, n)
    blocks = np.einsum("kn,nbw->bkw", D, np.asarray(partials, np.float64))
    return blocks.reshape(partials.shape[1], k * partials.shape[2])[:, :out_dim]


@dataclasses.dataclass(frozen=True)
class ComputeCodingSpec:
    """Placement of compute shards for intermediate-computation coding.

    Each entry ``q`` codes one slot ``slots[q]`` as an ``(n_q, k_q)``
    systematic MDS code over its own matmul: ``shard_member[q]`` lists, in
    generator-row order (systematic shards first), the device column that
    holds each shard, with ``-1`` for a shard that currently has no
    placement (e.g. after a permanent device loss, before the controller
    re-encodes it onto a spare).  Exactly one shard per device; a slot's
    `PlanIR.member` row is exactly its set of placed shard devices.  A
    plan carries either this spec or an output-`CodingSpec`, never both.
    """

    slots: np.ndarray                       # (Q,) coded slot ids, ascending
    k: np.ndarray                           # (Q,) decode threshold per slot
    shard_member: Tuple[np.ndarray, ...]    # per slot: (n_q,) device cols
    construction: str = "vandermonde"

    def __post_init__(self):
        slots = np.ascontiguousarray(np.asarray(self.slots, np.int64))
        ks = np.ascontiguousarray(np.asarray(self.k, np.int64))
        mem = tuple(np.ascontiguousarray(np.asarray(m, np.int64))
                    for m in self.shard_member)
        for a in (slots, ks) + mem:
            a.setflags(write=False)
        object.__setattr__(self, "slots", slots)
        object.__setattr__(self, "k", ks)
        object.__setattr__(self, "shard_member", mem)

    @property
    def Q(self) -> int:
        """Number of compute-coded slots."""
        return int(self.slots.shape[0])

    @property
    def n_shards(self) -> int:
        """Total shard count across all coded slots."""
        return int(sum(len(m) for m in self.shard_member))

    def entry_of(self, slot: int) -> int:
        """Index of ``slot`` in `slots`, or ``-1`` if it is not coded."""
        hit = np.flatnonzero(self.slots == slot)
        return int(hit[0]) if hit.size else -1

    def code_nk(self, q: int) -> Tuple[int, int]:
        """The ``(n, k)`` parameters of entry ``q``."""
        return len(self.shard_member[q]), int(self.k[q])

    def generator(self, q: int) -> np.ndarray:
        """The ``(n, k)`` systematic generator matrix for entry ``q``."""
        n, k = self.code_nk(q)
        return make_generator(n, k, self.construction)

    def mode(self, slot: int) -> Optional[str]:
        """Redundancy-mode string for ``slot`` (None if not compute-coded)."""
        q = self.entry_of(slot)
        if q < 0:
            return None
        n, k = self.code_nk(q)
        return f"coded_compute({n},{k})"

    def modes(self) -> Dict[int, str]:
        """Map of coded slot id to its ``coded_compute(n,k)`` mode string."""
        return {int(s): self.mode(int(s)) for s in self.slots}

    def slot_shortfall(self, q: int, p_out: np.ndarray) -> float:
        """P(fewer than k shards of entry ``q`` arrive) — coded Eq. 1f."""
        mem = self.shard_member[q]
        placed = mem[mem >= 0]
        k = int(self.k[q])
        if placed.size < k:
            return 1.0
        return arrival_shortfall_prob(1.0 - np.asarray(p_out, float)[placed], k)

    def with_(self, **kw) -> "ComputeCodingSpec":
        """Functional update, mirroring `PlanIR.with_`."""
        return dataclasses.replace(self, **kw)

    def drop_device(self, col: int) -> "ComputeCodingSpec":
        """Forget device column ``col`` (columns above shift down by one)."""
        mem = tuple(np.where(m == col, -1, m - (m > col).astype(np.int64))
                    for m in self.shard_member)
        return self.with_(shard_member=mem)

    def validate(self, member: np.ndarray) -> None:
        """Check internal consistency against a plan's member matrix."""
        D = member.shape[1]
        if len(self.shard_member) != self.Q or len(self.k) != self.Q:
            raise ValueError("compute coding: ragged spec arrays")
        for q in range(self.Q):
            s = int(self.slots[q])
            if not 0 <= s < member.shape[0]:
                raise ValueError(f"compute coding: slot {s} out of range")
            n, k = self.code_nk(q)
            if not 1 <= k <= n:
                raise ValueError(
                    f"compute coding: slot {s} has invalid (n, k) = ({n}, {k})")
            mem = self.shard_member[q]
            placed = mem[mem >= 0]
            if placed.size != np.unique(placed).size:
                raise ValueError(
                    f"compute coding: slot {s} places two shards on one device")
            if placed.size and (placed.min() < 0 or placed.max() >= D):
                raise ValueError(f"compute coding: slot {s} device out of range")
            row = np.flatnonzero(member[s])
            if not np.array_equal(np.sort(placed), row):
                raise ValueError(
                    f"compute coding: slot {s} member row disagrees with shards")
        if np.any(np.diff(self.slots) <= 0):
            raise ValueError("compute coding: slots must be strictly ascending")


@dataclasses.dataclass(frozen=True)
class _Entry:
    """Per-slot decode context resolved against a plan's share layout."""

    slot: int
    k: int
    n: int
    G: np.ndarray           # (n, k) generator
    ids: np.ndarray         # (n,) global share ids in `share_t` columns


class ComputeRuntime:
    """Decode-side helper for a compute-coded plan (mirrors `CodedRuntime`).

    Resolves each coded slot's shard share ids against `PlanIR.to_arrays`
    ordering (shards are appended after the K slot shares and P parity
    shares, in entry order) and turns per-trial share *times* into
    cancel-on-first-k decode weights: the decode uses exactly the k
    earliest arrivals — later shards are treated as cancelled — with ties
    broken toward systematic shards so an all-alive trial decodes through
    the identity (bit-exact passthrough).
    """

    def __init__(self, ir):
        cc = ir.compute_coding
        if cc is None:
            raise ValueError("plan has no compute-coding spec")
        self.ir = ir
        self.spec = cc
        base = ir.K + (ir.coding.P if ir.coding is not None else 0)
        self.entries: List[_Entry] = []
        off = 0
        for q in range(cc.Q):
            n, k = cc.code_nk(q)
            self.entries.append(_Entry(
                slot=int(cc.slots[q]), k=k, n=n, G=cc.generator(q),
                ids=np.arange(base + off, base + off + n)))
            off += n
        self.coded_slots = np.asarray(cc.slots, np.int64)
        self._pinv: Dict[Tuple[int, bytes], np.ndarray] = {}

    def _chosen(self, e: _Entry, share_t: np.ndarray) -> np.ndarray:
        """First-k-by-arrival shard mask, (T, n) bool, ties to low index."""
        times = share_t[:, e.ids]                       # (T, n)
        order = np.argsort(times, axis=1, kind="stable")
        chosen = np.zeros_like(times, dtype=bool)
        np.put_along_axis(chosen, order[:, :e.k], True, axis=1)
        # rows with fewer than k finite arrivals are unrecoverable: no decode
        chosen &= np.isfinite(times)
        short = chosen.sum(axis=1) < e.k
        chosen[short] = False
        return chosen

    def needs_decode(self, share_t: np.ndarray) -> bool:
        """True unless every trial's first-k set is exactly the systematic set.

        When False the plain (uncoded) forward already produces every coded
        slot's output bit-exactly, so serving can skip the decode kernel.
        """
        for e in self.entries:
            chosen = self._chosen(e, share_t)
            if not chosen[:, :e.k].all() or chosen[:, e.k:].any():
                return True
        return False

    def decode_weights(self, share_t: np.ndarray
                       ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Per-entry cancel-on-first-k decode weights from share times.

        Returns ``(dec, mask)`` lists aligned with `entries`: ``dec[q]`` is
        ``(T, k, n)`` float32 decode weights built from each trial's k
        earliest shard arrivals (all-zero for unrecoverable trials, matching
        the simulator's slot-failed verdict) and ``mask[q]`` the ``(T, n)``
        bool mask of the shards actually consumed.
        """
        decs: List[np.ndarray] = []
        masks: List[np.ndarray] = []
        for qi, e in enumerate(self.entries):
            chosen = self._chosen(e, share_t)
            T = chosen.shape[0]
            dec = np.zeros((T, e.k, e.n), np.float32)
            for t in range(T):
                row = chosen[t]
                if not row.any():
                    continue
                key = (qi, row.tobytes())
                D = self._pinv.get(key)
                if D is None:
                    D = decode_matrix(e.G, row).astype(np.float32)
                    self._pinv[key] = D
                dec[t] = D
            decs.append(dec)
            masks.append(chosen)
        return decs, masks
