"""Deterministic, resumable data pipeline.

The training runtime's speculative rollback (§III.C analogue) depends on
one property: a task's progress log — ``(shard, offset, seed)`` — must be
sufficient to regenerate EXACTLY the batches the failed attempt would have
consumed. The pipeline is therefore stateless-functional: batch ``i`` of
shard ``s`` is a pure function of ``(seed, s, i)``; no iterator state
exists that cannot be reconstructed from the three integers.

The synthetic corpus is a Zipf-ish token stream with enough structure
(document boundaries, skewed unigram distribution) to give language-model
training a non-trivial loss curve without any external data dependency.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataState:
    """Complete pipeline state — the rollback log payload."""

    seed: int
    shard_id: int
    n_shards: int
    offset: int  # batches already consumed by this shard

    def advance(self, n: int = 1) -> "DataState":
        return dataclasses.replace(self, offset=self.offset + n)


class TokenDataset:
    """Pure-function batch source: ``batch(shard, index) -> tokens``."""

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0,
                 doc_len: int = 512):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.seed = seed
        self.doc_len = doc_len
        # Skewed unigram distribution (Zipf-ish) shared by all shards.
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks
        self._probs = probs / probs.sum()

    def batch(self, shard_id: int, index: int, batch_size: int
              ) -> np.ndarray:
        """(batch_size, seq_len+1) int32 — callers split into inputs/labels.

        Deterministic in (seed, shard_id, index); different shards and
        indices are independent streams.
        """
        ss = np.random.SeedSequence(
            entropy=self.seed, spawn_key=(shard_id, index))
        rng = np.random.default_rng(ss)
        toks = rng.choice(self.vocab_size, p=self._probs,
                          size=(batch_size, self.seq_len + 1))
        # Document boundaries: BOS token (0) every ~doc_len positions.
        pos = rng.integers(0, self.doc_len, size=(batch_size, 1))
        grid = (np.arange(self.seq_len + 1)[None, :] + pos) % self.doc_len
        toks = np.where(grid == 0, 0, toks)
        return toks.astype(np.int32)


class ShardedTokenPipeline:
    """Per-host view of the global stream; resumable via ``DataState``."""

    def __init__(self, dataset: TokenDataset, state: DataState,
                 batch_size: int):
        self.dataset = dataset
        self.state = state
        self.batch_size = batch_size

    @classmethod
    def fresh(cls, dataset: TokenDataset, shard_id: int, n_shards: int,
              batch_size: int) -> "ShardedTokenPipeline":
        return cls(dataset,
                   DataState(dataset.seed, shard_id, n_shards, 0),
                   batch_size)

    @classmethod
    def from_state(cls, dataset: TokenDataset, state: DataState,
                   batch_size: int) -> "ShardedTokenPipeline":
        return cls(dataset, state, batch_size)

    def peek(self, ahead: int = 0) -> Dict[str, np.ndarray]:
        toks = self.dataset.batch(self.state.shard_id,
                                  self.state.offset + ahead,
                                  self.batch_size)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def next(self) -> Dict[str, np.ndarray]:
        out = self.peek()
        self.state = self.state.advance()
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()


def global_batch_specs(global_batch: int, n_hosts: int) -> Tuple[int, int]:
    """(per-host batch, n_shards); global batch must split evenly."""
    assert global_batch % n_hosts == 0, (global_batch, n_hosts)
    return global_batch // n_hosts, n_hosts
