"""Deterministic token batches for LM training: synthetic, or read from a store.

The port's copy of ``repro.data.tokens`` (importing that module runs
``repro/data/__init__.py``, which imports JAX), over the port's own
``data/store.py``. Every batch is a function of (seed, step, host slice)
alone, through numpy's counter-based generator, so a restarted worker
replays exactly the batch it crashed on (the fault supervisor's contract)
and each host draws only its slice of the global batch. The batches are
numpy int32 arrays, bitwise the reference's for the same arguments.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.data.store import ArrayStore


class SyntheticTokens:
    """Zipf-ish random tokens, deterministic in (seed, step, host_slice)."""

    def __init__(
        self,
        vocab: int,
        global_batch: int,
        seq_len: int,
        *,
        seed: int = 0,
        host_slice: Tuple[int, int] = (0, 1),  # (host_index, host_count)
    ):
        hi, hn = host_slice
        if global_batch % hn:
            raise ValueError(f"global batch {global_batch} does not split over {hn} hosts")
        self.vocab = vocab
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        self.local_batch = global_batch // hn
        self.host_index = hi

    def batch(self, step: int) -> dict:
        """-> {"tokens": [local_b, s], "targets": [local_b, s]} (int32)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, self.host_index]))
        # a zipf-like marginal, so that losses resemble text statistics
        u = rng.random((self.local_batch, self.seq_len + 1))
        toks = np.minimum((self.vocab * u ** 2.2).astype(np.int64), self.vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class StoreTokens:
    """Packed-token reader over a chunked ArrayStore (one document row per
    chunk): each batch row a random window of seq_len + 1 tokens of a
    random row, drawn from (seed, step)."""

    def __init__(self, root: str, seq_len: int, local_batch: int, *, seed: int = 0):
        self.store = ArrayStore.open(root)
        self.seq_len = seq_len
        self.local_batch = local_batch
        self.n_rows, self.row_len = self.store.shape[0], self.store.shape[1]
        if self.row_len < seq_len + 1:
            raise ValueError(f"rows of {self.row_len} tokens hold no window of {seq_len + 1}")
        self.seed = seed

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        rows = rng.integers(0, self.n_rows, size=self.local_batch)
        offs = rng.integers(0, self.row_len - self.seq_len - 1 + 1, size=self.local_batch)
        out = np.empty((self.local_batch, self.seq_len + 1), np.int32)
        for i, (r, o) in enumerate(zip(rows, offs)):
            out[i] = self.store.read_slice(
                (slice(int(r), int(r) + 1), slice(int(o), int(o) + self.seq_len + 1)))[0]
        return {"tokens": out[:, :-1], "targets": out[:, 1:]}
