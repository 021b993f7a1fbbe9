"""Deterministic, resumable, shardable synthetic data pipeline.

Stands in for C4/WikiText in the offline container: a Zipf-marginal bigram
language ("synthetic C4") so that small models actually learn structure and
perplexity deltas are meaningful. Every batch is a pure function of
(seed, step, host) — resuming from a checkpointed step reproduces the exact
stream (fault-tolerance requirement), and each data-parallel host draws a
disjoint slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticCorpus:
    """Bigram LM with Zipfian successor weights."""
    vocab_size: int
    seed: int = 0
    branching: int = 24

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        V, K = self.vocab_size, min(self.branching, self.vocab_size)
        self.successors = np.stack(
            [rng.choice(V, K, replace=False) for _ in range(V)])
        w = 1.0 / np.arange(1, K + 1) ** 1.2
        self.weights = w / w.sum()

    def sample(self, rng: np.random.RandomState, length: int) -> np.ndarray:
        out = np.empty(length, np.int32)
        tok = rng.randint(self.vocab_size)
        for i in range(length):
            out[i] = tok
            tok = self.successors[tok][
                rng.choice(len(self.weights), p=self.weights)]
        return out


@dataclasses.dataclass
class Pipeline:
    corpus: SyntheticCorpus
    batch: int                      # per-host batch
    seq_len: int
    seed: int = 0
    host: int = 0
    n_hosts: int = 1

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for `step`, deterministic and host-disjoint."""
        toks = np.empty((self.batch, self.seq_len + 1), np.int32)
        for b in range(self.batch):
            rng = np.random.RandomState(
                ((self.seed * 1_000_003 + step) * 65_537
                 + self.host * self.batch + b) % (2 ** 32))
            toks[b] = self.corpus.sample(rng, self.seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.get_batch(step)
            step += 1

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        """Resume mid-stream (checkpoint restart)."""
        while True:
            yield self.get_batch(step)
            step += 1


def calibration_batches(corpus: SyntheticCorpus, n: int, seq_len: int,
                        seed: int = 777):
    """Held-out calibration samples (the paper's C4 draw)."""
    out = []
    for i in range(n):
        rng = np.random.RandomState(seed + i)
        t = corpus.sample(rng, seq_len + 1)
        out.append({"tokens": t[None, :-1], "labels": t[None, 1:]})
    return out
