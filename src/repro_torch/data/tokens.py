"""Synthetic token stream for LM training (offline container).

Deterministic Zipfian unigram + order-2 Markov structure so the LM loss has
real signal; host-sharded: each data-parallel host generates only its shard
(seeded by (seed, step, host_id)) — no cross-host data motion at scale.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenTaskConfig:
    vocab: int = 32000
    seq_len: int = 512
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticTokens:
    def __init__(self, cfg: TokenTaskConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # order-2 structure: next ≈ f(prev) + noise
        self._mix = rng.integers(1, cfg.vocab, size=1024).astype(np.int64)

    def batch(self, batch_size: int, step: int, host_id: int = 0,
              n_hosts: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, host_id))
        local = batch_size // n_hosts if n_hosts > 1 else batch_size
        z = rng.zipf(cfg.zipf_a, size=(local, cfg.seq_len + 1))
        toks = np.minimum(z, cfg.vocab - 1).astype(np.int64)
        # inject Markov structure: half the positions follow the mix table
        follow = rng.random((local, cfg.seq_len)) < 0.5
        nxt = self._mix[toks[:, :-1] % len(self._mix)] % cfg.vocab
        toks[:, 1:] = np.where(follow, nxt, toks[:, 1:])
        return toks[:, :-1], toks[:, 1:]

    def epoch(self, batch_size: int, steps: int, start: int = 0
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for s in range(start, start + steps):
            yield self.batch(batch_size, s)
