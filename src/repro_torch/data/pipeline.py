"""Token data pipeline: deterministic synthetic LM streams with host-side
sharding and background prefetch.

Port of `repro/data/pipeline.py`, in numpy as there, so the same seed gives
the same tokens bit for bit; `launch.train` moves each batch to the
device.

Real deployments plug a tokenized corpus in by replacing `SyntheticLM` with a
reader exposing the same `__iter__ -> {"tokens": (B, S) int32}` protocol; the
sharding/prefetch layers are source-agnostic.  The synthetic stream is a
mixture of Zipf-distributed unigrams and deterministic n-gram motifs so that a
trained model exhibits a falling loss (useful for end-to-end training checks).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    """Deterministic synthetic token stream."""
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    n_motifs: int = 64
    motif_len: int = 8

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # Zipf unigram table
        ranks = np.arange(1, self.vocab_size + 1)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._motifs = rng.integers(0, self.vocab_size,
                                    size=(self.n_motifs, self.motif_len))
        self._step = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + 1)
        while True:
            toks = rng.choice(self.vocab_size, p=self._probs,
                              size=(self.batch, self.seq_len)).astype(np.int32)
            # overwrite random spans with motifs (learnable structure)
            n_spans = max(self.seq_len // (4 * self.motif_len), 1)
            for b in range(self.batch):
                starts = rng.integers(0, self.seq_len - self.motif_len,
                                      size=n_spans)
                picks = rng.integers(0, self.n_motifs, size=n_spans)
                for st, pk in zip(starts, picks):
                    toks[b, st: st + self.motif_len] = self._motifs[pk]
            yield {"tokens": toks}


def shard_for_host(batch: Dict[str, np.ndarray], host_index: int,
                   host_count: int) -> Dict[str, np.ndarray]:
    """Slice the global batch to this host's shard (multi-host data loading)."""
    def sl(x):
        per = x.shape[0] // host_count
        return x[host_index * per: (host_index + 1) * per]
    return {k: sl(v) for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch with a bounded queue."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._done:
                return
            yield item


def make_pipeline(vocab_size: int, batch: int, seq_len: int, seed: int = 0,
                  host_index: int = 0, host_count: int = 1,
                  prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    src = SyntheticLM(vocab_size=vocab_size, batch=batch, seq_len=seq_len,
                      seed=seed)
    it = (shard_for_host(b, host_index, host_count) for b in src)
    return iter(Prefetcher(it, depth=prefetch)) if prefetch else it
