"""Synthetic deterministic data pipeline (a copy of ``repro.train.data``,
without its unused ``jax`` import).

Counter-based PRNG (threefry on (epoch, step)) => any batch is
reconstructable from its step index alone: restarts and elastic rescales
re-produce the exact token stream with zero coordination state.  A small
host-side prefetch queue hides generation latency.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    embeddings_dim: int = 0   # >0 => emit stub frontend embeddings


def synth_batch(cfg: DataConfig, step: int) -> dict:
    """Deterministic batch for a global step (Zipf-ish token marginals)."""
    rng = np.random.default_rng(np.uint64(cfg.seed * 1_000_003 + step))
    # Zipf-like distribution capped to the vocab (realistic marginals)
    z = rng.zipf(1.3, size=(cfg.batch, cfg.seq_len + 1)).astype(np.int64)
    tokens = (z % cfg.vocab).astype(np.int32)
    out = {
        "tokens": tokens[:, :-1],
        "labels": tokens[:, 1:].astype(np.int32),
    }
    if cfg.embeddings_dim > 0:
        out["embeddings"] = rng.standard_normal(
            (cfg.batch, cfg.seq_len, cfg.embeddings_dim), dtype=np.float32)
        del out["tokens"]
    return out


class Prefetcher:
    """Background thread generating batches ahead of the consumer."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2):
        self.cfg = cfg
        self._q: "queue.Queue[dict]" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = synth_batch(self.cfg, step)
            try:
                self._q.put(batch, timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
