"""Serving-side glue for coded plans: encode matrix + decode weights.

:class:`CodedRuntime` is what
:class:`~repro_torch.runtime.serving.QuorumServer` builds (and caches per
plan) when its IR carries a coding spec:

  - ``enc`` (P, K): the stacked parity rows of every group's systematic MDS
    generator, embedded on the global slot axis — one einsum turns the
    (K, B, F) portion tensor into the (P, B, F) parity-share tensor inside
    the compiled serving step (the emulation of the parity devices' coded
    networks, same spirit as the paper's §V central emulation);
  - :meth:`decode_weights`: per-request (K, K + P) decode operators from the
    share-arrival mask — identity passthrough for arrived systematic shares
    (bit-exact with uncoded serving), pseudo-inverse rows of the arrived
    generator for erased-but-recoverable slots, zero rows for unrecoverable
    ones. Pseudo-inverses are memoized per (group, arrival-pattern): a K-slot
    group has at most 2^n patterns, and real failure traces revisit a
    handful, so steady-state serving does no linear algebra at all.

The weights feed the hand-written CUDA kernel behind
:func:`repro_torch.kernels.ops.coded_decode`, in the fused step and in the
legacy loop alike. This module is the JAX package's ``coding/runtime.py``
with one change: :meth:`CodedRuntime.enc_device` gives a ``torch`` tensor
on the server's device, cached per device; ``enc`` and the decode weights
stay numpy and equal the JAX package's arrays exactly.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.coding.codes import decode_matrix
from repro_torch.core.plan_ir import PlanIR


class CodedRuntime:
    """Serving-side companion of an output-coded plan: caches per-group
    encoders and memoizes decode matrices keyed by the arrival pattern."""

    def __init__(self, ir: PlanIR):
        spec = ir.coding
        if spec is None or not spec.n_groups:
            raise ValueError("CodedRuntime needs a plan with coded groups")
        self.ir = ir
        self.spec = spec
        self.K = ir.K
        self.P = spec.P
        self.n_shares = self.K + self.P
        # systematic shares belonging to coded groups: a missing share of a
        # plain replicate slot needs only the cheap masked merge, so the
        # serving path consults this to decide whether decode is required
        self.coded_slots = np.flatnonzero(spec.group_of >= 0)
        enc = np.zeros((self.P, self.K), np.float32)
        self._groups = []
        for c in range(spec.n_groups):
            slots = spec.group_slots(c)
            shares = spec.group_shares(c)
            n, k = spec.code_nk(c)
            G = spec.generator(c)
            for i, p in enumerate(spec.group_parities(c)):
                enc[p, slots] = G[k + i].astype(np.float32)
            self._groups.append((slots, shares, k, G))
        self.enc = enc
        self.enc.setflags(write=False)
        self._pinv_cache: Dict[Tuple[int, bytes], np.ndarray] = {}
        self._enc_dev: Dict[torch.device, torch.Tensor] = {}

    def enc_device(self, device: torch.device) -> torch.Tensor:
        """The (P, K) parity-encode matrix as a float32 tensor on
        ``device``, uploaded once per plan and device (the serving step's
        parity einsum reads it on every decode)."""
        t = self._enc_dev.get(device)
        if t is None:
            t = torch.tensor(self.enc, device=device)
            self._enc_dev[device] = t
        return t

    def _group_pinv(self, c: int, arrived: np.ndarray) -> np.ndarray:
        """(k, n) decode operator for group ``c``'s arrival pattern
        (memoized — the expensive pseudo-inverse runs once per pattern)."""
        key = (c, arrived.tobytes())
        X = self._pinv_cache.get(key)
        if X is None:
            X = decode_matrix(self._groups[c][3], arrived).astype(np.float32)
            self._pinv_cache[key] = X
        return X

    def decode_weights(self, share_arrived: np.ndarray) -> np.ndarray:
        """Per-request decode operators (T, K, K + P) from the (T, K + P)
        share-arrival mask. Row semantics per slot: identity on its own
        share when it arrived (exact passthrough — replicate slots and the
        failure-free path reduce to plain masking), the memoized
        pseudo-inverse row over its group's arrived shares when erased but
        recoverable, all-zero when unrecoverable (the merge then sees a
        zero portion, the replicate degraded-mode semantics)."""
        share_arrived = np.asarray(share_arrived, bool)
        T = share_arrived.shape[0]
        D = np.zeros((T, self.K, self.n_shares), np.float32)
        idx = np.arange(self.K)
        D[:, idx, idx] = share_arrived[:, :self.K]
        for c, (slots, shares, k, _G) in enumerate(self._groups):
            arr = share_arrived[:, shares]                  # (T, n)
            sys_ok = arr[:, :k]
            need = np.flatnonzero(~sys_ok.all(axis=1)
                                  & (arr.sum(axis=1) >= k))
            for t in need:
                X = self._group_pinv(c, arr[t])
                missing = np.flatnonzero(~sys_ok[t])
                cols = np.flatnonzero(arr[t])
                D[t, slots[missing][:, None], shares[cols][None, :]] = \
                    X[missing[:, None], cols[None, :]]
            # slots whose own share arrived keep the exact identity row set
            # above; X's identity rows for them are numerically equal, so
            # either choice serves the same logits
        return D
