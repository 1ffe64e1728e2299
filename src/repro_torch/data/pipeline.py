"""Data pipeline: deterministic synthetic LM stream + sharded loading.

The port's copy of the JAX package's ``data/pipeline.py``, numpy only: it
yields the same numpy batches, bit for bit, and the train step moves them
to the device.

The synthetic corpus is a mixture of Zipf-distributed unigrams and short
copy/induction motifs, so a ~100M model trained a few hundred steps shows a
real, monotone loss drop (the end-to-end example's acceptance criterion) —
white noise would pin the loss at log(V).

``ShardedLoader`` yields per-host shards of the global batch: each data-
parallel group reads only its slice, keyed by (step, shard) so every host is
deterministic and independent — no coordinator, in keeping with the paper's
decentralized setting.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    motif_len: int = 16
    n_motifs: int = 64
    zipf_a: float = 1.2

    def __post_init__(self) -> None:
        rng = np.random.default_rng(1234)
        self.motifs = rng.integers(
            0, self.vocab, size=(self.n_motifs, self.motif_len))
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = 1.0 / np.power(ranks, self.zipf_a)
        self.unigram = p / p.sum()

    def sample(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        toks = rng.choice(self.vocab, size=(batch, self.seq_len),
                          p=self.unigram)
        # plant repeated motifs (learnable structure: induction)
        n_plant = self.seq_len // (4 * self.motif_len)
        for b in range(batch):
            ids = rng.integers(0, self.n_motifs, size=n_plant)
            starts = rng.integers(
                0, max(self.seq_len - self.motif_len, 1), size=n_plant)
            for mid, st in zip(ids, starts):
                toks[b, st:st + self.motif_len] = self.motifs[mid]
        return toks.astype(np.int32)


@dataclass
class ShardedLoader:
    """Deterministic per-shard batches of {tokens, labels}."""

    source: SyntheticLM
    global_batch: int
    n_shards: int = 1
    shard: int = 0
    seed: int = 0

    @property
    def shard_batch(self) -> int:
        assert self.global_batch % self.n_shards == 0
        return self.global_batch // self.n_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        # independently seeded per (seed, step, shard): any host can compute
        # its slice with no coordination
        h = hashlib.sha256(
            f"{self.seed}/{step}/{self.shard}".encode()).digest()
        rng = np.random.default_rng(int.from_bytes(h[:8], "big"))
        toks = self.source.sample(rng, self.shard_batch)
        labels = np.concatenate(
            [toks[:, 1:], np.full((toks.shape[0], 1), -1, np.int32)], axis=1)
        return {"tokens": toks, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch_iterator(vocab: int, seq_len: int, global_batch: int,
                        n_shards: int = 1, shard: int = 0,
                        seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    src = SyntheticLM(vocab=vocab, seq_len=seq_len)
    return iter(ShardedLoader(src, global_batch, n_shards, shard, seed))
