"""Deterministic, shard-aware data pipeline with background prefetch (the
port's own copy of the reference's ``data/pipeline.py``: host numpy, the
same batches bit for bit).

Synthetic LM token streams (the paper needs no real corpus) generated
deterministically from (seed, shard, step): every host produces exactly its
own shard of the global batch, so the pipeline is elastic — restarting with a
different host count replays the same global stream as long as
(global_batch, seq_len, seed) are unchanged. A background thread keeps a
bounded prefetch queue ahead of the training loop (host-side overlap).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-ish synthetic stream: makes loss curves non-trivial
    structure: float = 0.7  # P(next token derived from current), else uniform


class SyntheticTokens:
    """Deterministic per-(step, shard) batch generator."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        out_tok = np.empty((self.local_batch, cfg.seq_len), np.int32)
        # labels in a local array: the reference keeps them on the instance,
        # which two threads calling batch_at at once would share
        out_lbl = np.empty((self.local_batch, cfg.seq_len), np.int32)
        for i in range(self.local_batch):
            global_row = self.shard * self.local_batch + i
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, global_row])
            )
            toks = np.empty(cfg.seq_len + 1, np.uint64)
            toks[0] = rng.integers(0, cfg.vocab_size)
            structured = rng.random(cfg.seq_len) < cfg.structure
            jumps = rng.integers(0, cfg.vocab_size, cfg.seq_len).astype(np.uint64)
            mul = np.uint64(6364136223846793005)
            add = np.uint64(1442695040888963407)
            vocab = np.uint64(cfg.vocab_size)
            with np.errstate(over="ignore"):
                for t in range(cfg.seq_len):
                    if structured[t]:
                        toks[t + 1] = (toks[t] * mul + add) % vocab
                    else:
                        toks[t + 1] = jumps[t]
            out_tok[i] = toks[:-1]
            out_lbl[i] = toks[1:]
        return {"tokens": out_tok, "labels": out_lbl}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchIterator:
    """Bounded background prefetch (host-side compute/IO overlap)."""

    def __init__(self, source: SyntheticTokens, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, batch = self.q.get()
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
