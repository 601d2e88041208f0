"""Deterministic synthetic LM token pipeline of the PyTorch port (a copy of
``repro.data.tokens``; numpy only).

Sequences follow a learnable affine-chain structure: with probability
``p_struct`` the next token is ``(a·prev + b) mod vocab``, else uniform
random. A model that learns the chain reaches xent ≈ -(p·log p) ·…· well
below log(vocab), so training-loss *decrease* is a meaningful signal.

Deterministic per (seed, step, dp_rank): seekable for checkpoint/restart —
restoring step k reproduces exactly the batch stream a non-failed run would
have seen (fault-tolerance requirement).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenPipeline"]


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    p_struct: float = 0.8
    a: int = 7
    b: int = 3

    def batch(self, step: int, dp_rank: int = 0, dp_size: int = 1) -> dict:
        """Batch shard for one data-parallel rank at one step (numpy)."""
        assert self.global_batch % dp_size == 0
        local = self.global_batch // dp_size
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, dp_rank])
        )
        toks = np.empty((local, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, local)
        structured = rng.random((local, self.seq_len)) < self.p_struct
        noise = rng.integers(0, self.vocab, (local, self.seq_len))
        for t in range(self.seq_len):
            chain = (self.a * toks[:, t] + self.b) % self.vocab
            toks[:, t + 1] = np.where(structured[:, t], chain, noise[:, t])
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
