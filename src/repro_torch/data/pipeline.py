"""Deterministic, restartable, sharded data pipeline: a copy of the JAX
package's ``data/pipeline.py`` (numpy only), so that both packages give
the same batches, byte for byte, for the same ``DataConfig``.

Design for scale: each data-parallel rank owns a disjoint shard of an
infinite synthetic token stream (or a memory-mapped token file).  The
iterator state is two integers (epoch seed, step) — checkpointing the
pipeline is exact and O(1), and restart resumes bit-identically.  A
background prefetch thread keeps ``prefetch`` batches ready.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_shards: int = 1
    shard_id: int = 0
    seed: int = 0
    kind: str = "synthetic"     # synthetic | memmap
    path: str = ""              # for memmap
    prefetch: int = 2


class TokenStream:
    """Zipfian synthetic documents packed into fixed-length sequences.
    Deterministic in (seed, shard, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.kind == "memmap":
            self._data = np.memmap(cfg.path, dtype=np.uint16, mode="r")
        else:
            self._data = None
        # zipf-ish rank probabilities over the vocab (heavy head, long tail)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._p = p / p.sum()

    @property
    def per_shard_batch(self) -> int:
        assert self.cfg.global_batch % self.cfg.n_shards == 0
        return self.cfg.global_batch // self.cfg.n_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The batch for a given global step — pure function of (cfg, step)."""
        b, s = self.per_shard_batch, self.cfg.seq_len
        if self._data is not None:
            n = len(self._data) - (s + 1)
            rng = np.random.RandomState((self.cfg.seed, self.cfg.shard_id, step))
            starts = rng.randint(0, n, size=b)
            toks = np.stack([self._data[st : st + s + 1] for st in starts]).astype(np.int32)
        else:
            rng = np.random.RandomState((self.cfg.seed, self.cfg.shard_id, step) )
            toks = rng.choice(self.cfg.vocab, size=(b, s + 1), p=self._p).astype(np.int32)
        return {"tokens": toks[:, :s], "labels": toks[:, 1 : s + 1]}


@dataclasses.dataclass
class PipelineState:
    step: int = 0

    def to_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    @staticmethod
    def from_dict(d) -> "PipelineState":
        return PipelineState(step=int(d["step"]))


class DataPipeline:
    """Prefetching iterator with checkpointable state."""

    def __init__(self, cfg: DataConfig, state: Optional[PipelineState] = None):
        self.cfg = cfg
        self.stream = TokenStream(cfg)
        self.state = state or PipelineState()
        self._q: "queue.Queue" = queue.Queue(maxsize=max(cfg.prefetch, 1))
        self._stop = threading.Event()
        self._next_to_produce = self.state.step
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        while not self._stop.is_set():
            step = self._next_to_produce
            batch = self.stream.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            self._next_to_produce += 1

    def next(self) -> Dict[str, np.ndarray]:
        while True:
            step, batch = self._q.get()
            if step == self.state.step:  # drop stale batches after restore
                self.state.step += 1
                return batch
            if step > self.state.step:
                # producer ran ahead of a restored state: restart producer
                self._restart_producer()

    def _restart_producer(self):
        self._stop.set()
        self._thread.join(timeout=2)
        self._q = queue.Queue(maxsize=max(self.cfg.prefetch, 1))
        self._stop = threading.Event()
        self._next_to_produce = self.state.step
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def restore(self, state: PipelineState):
        self.state = PipelineState(step=state.step)
        self._restart_producer()

    def close(self):
        self._stop.set()


def build_token_file(path: str, n_tokens: int, vocab: int, seed: int = 0) -> None:
    """Utility: write a synthetic binary token file for the memmap path."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    data = rng.choice(vocab, size=n_tokens, p=p).astype(np.uint16)
    data.tofile(path)
